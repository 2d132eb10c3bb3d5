"""AdamW over a model's whole parameter tree on Hopper, one pass a
parameter.

:func:`adamw_step` launches the hand-written kernels of ``csrc/adamw.cu``
on CUDA tensors and runs its plain PyTorch version (:func:`adamw_step_ref`)
on CPU tensors.  A CUDA tensor never falls back to the plain version: the
kernels launch or the wrapper raises.

It replaces no ``pallas_call``: the JAX package's ``adamw_update``
(``src/repro/optim/adamw.py``) is plain ``jnp``, fused by XLA under the
train step's ``jax.jit``; the port's step would otherwise run it as some
twenty PyTorch passes a parameter.  The arithmetic is the reference's:
the global gradient norm over every gradient, ``scale = min(1, clip /
max(gnorm, 1e-9))``, then per element in f32

    g32 = g scale;  m' = b1 m + (1 - b1) g32;  v' = b2 v + (1 - b2) g32 g32
    p'  = p - lr (m' / bc1 / (sqrt(v' / bc2) + eps) + wd p)

each result rounded to its tensor's type and written **in place**.  The
step's ``lr`` and the bias corrections ``bc1 = 1 - b1^count`` and ``bc2 =
1 - b2^count`` are read from ``hyper``, a (3,) f32 tensor on the tensors'
device, so that a step captured as a CUDA graph reads new values at every
replay; ``scale`` never leaves the device.  A gradient of ``None`` (a
parameter the loss does not reach) is a zero gradient; nothing is
allocated for it.  The norm is summed in f64 (the kernels: each thread,
then shuffles and the blocks' partials in a fixed order, no atomics; the
plain version: ``torch.sum`` of f64 squares) and rounded to f32 once, so
the two agree to f64 rounding and the kernels' is bit-equal from run to
run.  Every per-element operation is one rounding in both (the kernels use
round-to-nearest intrinsics, nothing contracted into an FMA), in the same
order, so the kernels and the plain version give the same bits wherever
their norms agree.

(parameter, moment) dtypes, tensor by tensor (a tree may mix them, as
falcon-mamba's f32 ``A_log`` and ``D`` beside its bf16 weights): (f32,
f32), (f32, bf16), (bf16, f32) and (bf16, bf16); a gradient has its
parameter's dtype and shape.  On the card
every tensor is contiguous and 16-byte aligned (a gradient that is not is
copied first; a parameter or moment that is not is refused, as the update
writes it in place).

``LAUNCHES["adamw"]`` counts the wrapper's calls that launch the kernels,
one a call (the table's fill launches, the norm, its finalize and the
update: ``KERNELS``).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from . import _build, _tensors

LAUNCHES = {"adamw": 0}
# csrc/adamw.cu's kernels, in launch order (the fill once a FILL tensors)
KERNELS = ("adamw_fill_kernel", "adamw_norm_kernel", "adamw_finalize_kernel",
           "adamw_update_kernel")
# the (parameter, moment) dtypes the kernels take, tensor by tensor
PAIRS = ((torch.float32, torch.float32), (torch.float32, torch.bfloat16),
         (torch.bfloat16, torch.float32), (torch.bfloat16, torch.bfloat16))
# csrc/adamw.cu's entry flags
_DECAY, _P_BF16, _M_BF16 = 1, 2, 4


def global_norm_ref(grads: Sequence[Optional[torch.Tensor]]) -> torch.Tensor:
    """sqrt of the sum of every gradient's squares, summed in f64 and
    rounded to f32 once: a 0-d f32 tensor."""
    dev = next(g.device for g in grads if g is not None)
    total = torch.zeros((), dtype=torch.float64, device=dev)
    for g in grads:
        if g is not None:
            total = total + torch.sum(torch.square(g.to(torch.float64)))
    return torch.sqrt(total).to(torch.float32)


def clip_scale_ref(gnorm: torch.Tensor, grad_clip: float) -> torch.Tensor:
    """min(1, clip / max(gnorm, 1e-9)) in f32 (a true division)."""
    r = torch.full_like(gnorm, grad_clip) / torch.clamp(gnorm, min=1e-9)
    return torch.clamp(r, max=1.0)


def update_ref(p, g, m, v, scale, lr, bc1, bc2, *, b1, b2, eps, wd):
    """One tensor's update in f32, each operation rounded once, in the
    kernels' order: (p', m', v') in f32, not written back.  ``scale``,
    ``lr``, ``bc1`` and ``bc2`` are 0-d f32 tensors; ``g`` None is zero."""
    f32 = torch.float32
    g32 = (g.to(f32) if g is not None
           else torch.zeros((), dtype=f32, device=p.device)) * scale
    m32 = m.to(f32) * b1 + g32 * (1 - b1)
    v32 = v.to(f32) * b2 + (g32 * g32) * (1 - b2)
    # the f32 root correctly rounded, as the kernels' __fsqrt_rn (torch's
    # f32 sqrt on the CPU can be one ulp off; the f64 root rounded once is
    # not)
    root = torch.sqrt((v32 / bc2).to(torch.float64)).to(f32)
    u = (m32 / bc1) / (root + eps)
    p32 = p.to(f32)
    if wd:
        u = u + p32 * wd
    return p32 - lr * u, m32, v32


@torch.no_grad()
def adamw_step_ref(params, grads, mus, nus, decayed, hyper, *, b1=0.9,
                   b2=0.95, eps=1e-8, weight_decay=0.1, grad_clip=1.0):
    """The plain version of :func:`adamw_step`: the same arguments, the
    same in-place writes, the norm (a 0-d f32 tensor) returned."""
    gnorm = global_norm_ref(grads)
    scale = clip_scale_ref(gnorm, grad_clip)
    lr, bc1, bc2 = hyper[0], hyper[1], hyper[2]
    for p, g, m, v, dec in zip(params, grads, mus, nus, decayed):
        p32, m32, v32 = update_ref(p, g, m, v, scale, lr, bc1, bc2, b1=b1,
                                   b2=b2, eps=eps,
                                   wd=weight_decay if dec else 0.0)
        p.copy_(p32)
        m.copy_(m32)
        v.copy_(v32)
    return gnorm


def _check(params, grads, mus, nus, decayed, hyper):
    name = "adamw_step"
    n = len(params)
    if not n or any(len(x) != n for x in (grads, mus, nus, decayed)):
        raise ValueError(f"{name}: params, grads, mus, nus and decayed must "
                         f"be non-empty and of one length")
    dev = params[0].device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {dev}")
    if hyper.dtype != torch.float32 or tuple(hyper.shape) != (3,) or \
            hyper.device != dev:
        raise ValueError(f"{name}: hyper must be a (3,) f32 tensor (lr, bc1, "
                         f"bc2) on {dev}, got {hyper.dtype} "
                         f"{tuple(hyper.shape)} on {hyper.device}")
    for i, (p, g, m, v) in enumerate(zip(params, grads, mus, nus)):
        if (p.dtype, m.dtype) not in PAIRS or v.dtype != m.dtype:
            raise TypeError(f"{name}: tensor {i}: (parameter, moments) "
                            f"dtypes must be one of {list(PAIRS)}, got "
                            f"{p.dtype}, {m.dtype}, {v.dtype}")
        if m.shape != p.shape or v.shape != p.shape or (
                g is not None and (g.shape != p.shape or g.dtype != p.dtype)):
            raise ValueError(f"{name}: tensor {i}: shapes or gradient dtype "
                             f"disagree: p {tuple(p.shape)} {p.dtype}, m "
                             f"{tuple(m.shape)}, v {tuple(v.shape)}, g "
                             f"{None if g is None else (tuple(g.shape), g.dtype)}")
        if any(t.device != dev for t in (p, m, v) + (() if g is None else (g,))):
            raise ValueError(f"{name}: every tensor must be on {dev}")


def _aligned(t: torch.Tensor) -> bool:
    return t.is_contiguous() and t.data_ptr() % 16 == 0


def adamw_step(params: Sequence[torch.Tensor],
               grads: Sequence[Optional[torch.Tensor]],
               mus: Sequence[torch.Tensor], nus: Sequence[torch.Tensor],
               decayed: Sequence[bool], hyper: torch.Tensor, *,
               b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
               weight_decay: float = 0.1,
               grad_clip: float = 1.0) -> torch.Tensor:
    """AdamW over the tree (lists in one order), in place; returns the
    global gradient norm before clipping, a 0-d f32 tensor (on the card a
    view of the kernels' output).  See the module docstring."""
    params, grads, mus, nus = (list(x) for x in (params, grads, mus, nus))
    decayed = [bool(d) for d in decayed]
    _check(params, grads, mus, nus, decayed, hyper)
    if params[0].device.type == "cpu":
        return adamw_step_ref(params, grads, mus, nus, decayed, hyper, b1=b1,
                              b2=b2, eps=eps, weight_decay=weight_decay,
                              grad_clip=grad_clip)
    dev = params[0].device
    rows = []
    for i, (p, g, m, v, dec) in enumerate(zip(params, grads, mus, nus,
                                              decayed)):
        if not all(_aligned(t) for t in (p, m, v)):
            raise ValueError(f"adamw_step: tensor {i}: the parameter and its "
                             f"moments must be contiguous and 16-byte "
                             f"aligned (they are written in place)")
        if p.numel() == 0:
            continue
        if g is not None and not _aligned(g):
            g = g.clone(memory_format=torch.contiguous_format)
            grads[i] = g                    # alive until the launch is queued
        flags = (_DECAY * dec + _P_BF16 * (p.dtype == torch.bfloat16)
                 + _M_BF16 * (m.dtype == torch.bfloat16))
        rows.append((g.data_ptr() if g is not None else 0, p.data_ptr(),
                     m.data_ptr(), v.data_ptr(), p.numel(), flags))
    if not rows:
        return torch.zeros((), dtype=torch.float32, device=dev)
    entries = np.ascontiguousarray(np.array(rows, dtype=np.int64))
    lib = _build.load()
    work = torch.empty((lib.adamw_workspace_bytes(len(rows)),),
                       dtype=torch.uint8, device=dev)
    stats = torch.empty((2,), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = lib.adamw_step(entries.ctypes.data, len(rows), work.data_ptr(),
                 stats.data_ptr(), hyper.data_ptr(), b1, 1 - b1, b2, 1 - b2,
                 eps, weight_decay, grad_clip, _tensors.stream(dev))
    _build.check(lib, "adamw_step", err)
    LAUNCHES["adamw"] += 1
    return stats[0]
