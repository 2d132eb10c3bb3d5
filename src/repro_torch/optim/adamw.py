"""AdamW with a configurable moment dtype (f32 by default, bf16 for the
>= 100 B archs) and decoupled weight decay, plus a cosine LR schedule.

Port of ``repro.optim.adamw``.  The update runs as the hand-written
kernels of ``kernels/adamw.py`` (``csrc/adamw.cu``: one pass a parameter
over the whole tree; their plain PyTorch version on the CPU), where the
reference leaves its ``jnp`` update to XLA's fusion under ``jax.jit``.  It
is not ``torch.optim.AdamW``, which keeps its moments in the parameter's
dtype and has no global-norm clip.  The trees are dicts keyed by parameter
name (``model.named_parameters()``).

As in the reference: the gradients are clipped to a global norm of
``grad_clip`` (the norm over every gradient, here summed in f64 and
rounded to f32), the update is computed in f32 and cast back to each
parameter's and moment's dtype, and the bias corrections use ``count``
after the step, computed on the host in f32 as the reference's
(:func:`hyper_values`).  lr and the bias corrections reach the kernels
through a (3,) f32 device buffer (:func:`adamw_apply`), so that a step
captured as a CUDA graph (``train.graphs``) reads each step's values.  Unlike the reference's pure
transform, :func:`adamw_update` writes the parameters and the moments
**in place** (at full width the f32 moments are 25.7 GB), and returns the
state with the new count.

Which parameters decay is the caller's ``decayed`` mapping: the reference
decays a leaf with ``p.ndim >= 2``, on leaves stacked over periods, so a
per-layer norm scale (P, d) or bias is decayed and only the final norm is
not; the port's per-layer tensors have one axis fewer, so the trainer
passes ``models.convert.decayed(model)``, which decides by the reference
leaf's rank.
"""

from __future__ import annotations

import math
from typing import Dict, Mapping, NamedTuple, Optional

import numpy as np
import torch

from ..kernels import adamw as adamw_kernels
from ..models.layers import _dtype

Tree = Dict[str, torch.Tensor]


class OptState(NamedTuple):
    mu: Tree
    nu: Tree
    count: int


def adamw_init(params: Mapping[str, torch.Tensor],
               dtype: str = "float32") -> OptState:
    """Zero moments of ``params``' shapes, in ``dtype``, on their devices."""
    dt = _dtype(dtype)
    zeros = lambda p: torch.zeros(p.shape, dtype=dt, device=p.device)
    return OptState(mu={n: zeros(p) for n, p in params.items()},
                    nu={n: zeros(p) for n, p in params.items()}, count=0)


def _f32(x: np.floating) -> float:
    return float(np.float32(x))


def hyper_values(count: int, lr: float, b1: float = 0.9,
                 b2: float = 0.95) -> list:
    """[lr, bc1, bc2] of the step that makes the count ``count``: what
    :func:`adamw_apply` reads from its device buffer.  The bias corrections
    ``1 - b ** count`` in f32, as the reference's (``b **
    count.astype(f32)``)."""
    f = np.float32
    return [lr, _f32(f(1) - f(b1) ** f(count)),
            _f32(f(1) - f(b2) ** f(count))]


@torch.no_grad()
def adamw_apply(grads: Mapping[str, Optional[torch.Tensor]], opt: OptState,
                params: Mapping[str, torch.Tensor], hyper: torch.Tensor,
                b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                weight_decay: float = 0.1, grad_clip: float = 1.0, *,
                decayed: Mapping[str, bool]) -> torch.Tensor:
    """One step over every parameter, in place, with lr and the bias
    corrections read from ``hyper`` ((3,) f32 on the parameters' device:
    :func:`hyper_values`): ``kernels.adamw.adamw_step`` over the tree in
    ``params``' order (the kernels on the card, the plain version on the
    CPU).  A missing or None gradient is a zero gradient.  Returns the f32
    global norm before clipping, a 0-d tensor."""
    names = list(params)
    return adamw_kernels.adamw_step(
        [params[n] for n in names], [grads.get(n) for n in names],
        [opt.mu[n] for n in names], [opt.nu[n] for n in names],
        [decayed[n] for n in names], hyper, b1=b1, b2=b2, eps=eps,
        weight_decay=weight_decay, grad_clip=grad_clip)


@torch.no_grad()
def adamw_update(grads: Mapping[str, Optional[torch.Tensor]], opt: OptState,
                 params: Mapping[str, torch.Tensor], lr: float,
                 b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1, grad_clip: float = 1.0, *,
                 decayed: Mapping[str, bool]):
    """One step over every parameter, in place; ``decayed[name]`` says
    whether it decays.  Returns (the state with the new count,
    {"grad_norm": the f32 global norm before clipping, a 0-d tensor})."""
    count = opt.count + 1
    dev = next(iter(params.values())).device
    hyper = torch.tensor(hyper_values(count, lr, b1, b2), dtype=torch.float32,
                         device=dev)
    gnorm = adamw_apply(grads, opt, params, hyper, b1, b2, eps, weight_decay,
                        grad_clip, decayed=decayed)
    return OptState(opt.mu, opt.nu, count), {"grad_norm": gnorm}


def cosine_schedule(step: int, *, peak_lr: float = 3e-4, warmup: int = 100,
                    total: int = 10_000, floor: float = 0.1) -> float:
    """Linear warm-up to ``peak_lr``, then a cosine down to ``floor`` x
    ``peak_lr`` at ``total``; computed in f32 as the reference's."""
    f = np.float32
    if step < warmup:
        return _f32(f(peak_lr) * f(step + 1) / f(warmup))
    frac = min(max(f(step - warmup) / f(max(total - warmup, 1)), f(0)), f(1))
    cos = f(peak_lr) * (f(floor) + (f(1) - f(floor)) * f(0.5)
                        * (f(1) + np.cos(f(math.pi) * frac)))
    return _f32(cos)
