"""AdamW with a configurable moment dtype (f32 by default, bf16 for the
>= 100 B archs) and decoupled weight decay, plus a cosine LR schedule.

Port of ``repro.optim.adamw``, in plain PyTorch operations (the reference's
is no Pallas kernel either).  It is not ``torch.optim.AdamW``, which keeps
its moments in the parameter's dtype and has no global-norm clip.  The
trees are dicts keyed by parameter name (``model.named_parameters()``).

As in the reference: the gradients are clipped to a global norm of
``grad_clip`` (the norm summed over every gradient in f32), the update is
computed in f32 and cast back to each parameter's and moment's dtype, and
the bias corrections use ``count`` after the step.  Unlike the reference's
pure transform, :func:`adamw_update` writes the parameters and the moments
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
from typing import Dict, Mapping, NamedTuple

import numpy as np
import torch

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


@torch.no_grad()
def adamw_update(grads: Mapping[str, torch.Tensor], opt: OptState,
                 params: Mapping[str, torch.Tensor], lr: float,
                 b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1, grad_clip: float = 1.0, *,
                 decayed: Mapping[str, bool]):
    """One step over every parameter, in place; ``decayed[name]`` says
    whether it decays.  Returns (the state with the new count,
    {"grad_norm": the f32 global norm before clipping, a 0-d tensor})."""
    count = opt.count + 1
    gnorm = torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32)))
                           for g in grads.values()))
    scale = torch.clamp(grad_clip / torch.clamp(gnorm, min=1e-9), max=1.0)
    # 1 - b ** count in f32, as the reference's (b ** count.astype(f32))
    bc1 = _f32(np.float32(1) - np.float32(b1) ** np.float32(count))
    bc2 = _f32(np.float32(1) - np.float32(b2) ** np.float32(count))
    for name, p in params.items():
        m, v = opt.mu[name], opt.nu[name]
        g32 = grads[name].to(torch.float32, copy=True).mul_(scale)
        m32 = m.to(torch.float32).mul_(b1).add_(g32, alpha=1 - b1)
        v32 = v.to(torch.float32).mul_(b2).add_(
            g32.mul_(g32), alpha=1 - b2)
        del g32
        upd = torch.div(m32, bc1).div_(
            torch.div(v32, bc2).sqrt_().add_(eps))
        wd = weight_decay if decayed[name] else 0.0
        p32 = p.to(torch.float32)
        if wd:
            upd.add_(p32, alpha=wd)
        if p32 is p:
            p.sub_(upd, alpha=lr)
        else:
            p.copy_(p32.sub_(upd, alpha=lr))
        if m32 is not m:
            m.copy_(m32)
        if v32 is not v:
            v.copy_(v32)
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
