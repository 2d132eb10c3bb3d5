"""The blockwise-int8 round trip with error feedback over a whole gradient
tree on Hopper, one pass.

:func:`compress_int8_` launches the hand-written kernels of
``csrc/compress.cu`` on CUDA tensors and runs its plain PyTorch version
(:func:`compress_int8_ref_`) on CPU tensors.  A CUDA tensor never falls
back to the plain version: the kernels launch or the wrapper raises.

It replaces no ``pallas_call``: the JAX package's compressor
(``src/repro/distributed/compression.py``) is plain ``jnp``, fused by XLA
under the accumulated step's ``jax.jit``.  For each tensor ``g`` of the
tree (and its residual ``e``, where residuals are given), its flat view cut
into blocks of ``block`` elements (the last one padded with zeros; a block
never crosses tensors), in f32:

    t = g + e;  s = absmax(t) / 127 (1 where absmax is 0)
    c = clip(rint(t / s), -127, 127) s   -> written over g
    e' = t - c                          -> written over e

which is ``distributed.compression.compress_with_feedback`` with the int8
spec, in place.  Without residuals ``t = g``: the accumulated step's zero
residual, which it discards (``src/repro/distributed/overlap.py:173-176``).
The plain version is the composition of the reference's functions, whose
ports live here, below the distributed layer that re-exports them
(:func:`quantize_blockwise`, then :func:`dequantize_blockwise`); the
kernels round each operation once, in its order, so the two are
bit-equal.

Non-finite values.  A block holding a NaN: the reference's ``jnp.max``
keeps it, so its scale is 1, and so are the kernels' (their max keeps a
NaN too) and the plain version's (``torch.amax``); the NaN element itself
comes out NaN from the kernels, while the reference and the plain version
cast it to int8, which is undefined (it is where the two may differ).  A
block holding an Inf has scale Inf, and every element comes out NaN (0 x
Inf) in all three.

What the kernels take: f32 tensors (gradients and residuals of equal
shapes), contiguous (they are written in place), one device, ``block`` from
16 to 1,024.  Anything else raises.  ``LAUNCHES["compress"]`` counts the
wrapper's calls that launch the kernels, one a call (the table's fills,
``compress_fill_kernel``, then the pass, ``compress_int8_kernel``).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from . import _build, _tensors

LAUNCHES = {"compress": 0}
# csrc/compress.cu's compress_int8_kernel<VEC, PER> instantiations (VEC
# elements a piece, PER pieces a lane): the entry picks the smallest PER
# that holds the block at its VEC
INSTANCES = ((4, 1), (4, 2), (4, 4), (4, 8),
             (1, 1), (1, 2), (1, 4), (1, 8), (1, 16), (1, 32))
MIN_BLOCK, MAX_BLOCK = 16, 1024


def quantize_blockwise(x: torch.Tensor, block: int = 256
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-block int8 quantization of a flat view of ``x``:
    ``scale = absmax / 127`` (1 where absmax is 0), ``q = clip(round(x /
    scale), -127, 127)``, rounded half to even.

    Returns (q int8 [n_blocks, block], scales f32 [n_blocks]), as the
    reference's arrays."""
    flat = x.to(torch.float32).reshape(-1)
    n = flat.shape[0]
    n_blocks = -(-n // block)
    flat = F.pad(flat, (0, n_blocks * block - n))
    blocks = flat.reshape(n_blocks, block)
    absmax = torch.amax(torch.abs(blocks), dim=1)
    # a tensor divisor: PyTorch on CUDA divides by a host scalar as a
    # product with its reciprocal, which is not the reference's division
    scale = torch.where(absmax > 0, absmax / torch.full_like(absmax, 127.0),
                        torch.ones_like(absmax))
    q = torch.clamp(torch.round(blocks / scale[:, None]), -127, 127)
    return q.to(torch.int8), scale


def dequantize_blockwise(q: torch.Tensor, scale: torch.Tensor, shape,
                         dtype=torch.float32) -> torch.Tensor:
    n = 1
    for d in shape:
        n *= d
    x = (q.to(torch.float32) * scale[:, None]).reshape(-1)[:n]
    return x.reshape(shape).to(dtype)


@torch.no_grad()
def compress_int8_ref_(grads: Sequence[torch.Tensor],
                       residuals: Optional[Sequence[torch.Tensor]] = None,
                       block: int = 256) -> None:
    """The plain version of :func:`compress_int8_`: the same arguments, the
    same in-place writes, through :func:`quantize_blockwise` and
    :func:`dequantize_blockwise`."""
    for i, g in enumerate(grads):
        e = None if residuals is None else residuals[i]
        t = g if e is None else g + e
        q, s = quantize_blockwise(t, block)
        c = dequantize_blockwise(q, s, tuple(t.shape))
        if e is not None:
            e.copy_(t - c)
        g.copy_(c)


def _check(grads, residuals, block) -> None:
    name = "compress_int8_"
    if not grads:
        raise ValueError(f"{name}: no tensors")
    if residuals is not None and len(residuals) != len(grads):
        raise ValueError(f"{name}: {len(residuals)} residuals for "
                         f"{len(grads)} tensors")
    if not isinstance(block, int) or not MIN_BLOCK <= block <= MAX_BLOCK:
        raise ValueError(f"{name}: block must be an int from {MIN_BLOCK} to "
                         f"{MAX_BLOCK}, got {block!r}")
    dev = grads[0].device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {dev}")
    for i, g in enumerate(grads):
        pair = (g,) if residuals is None else (g, residuals[i])
        for t in pair:
            if t.dtype != torch.float32:
                raise TypeError(f"{name}: tensor {i}: f32 only, got "
                                f"{t.dtype}")
            if t.device != dev:
                raise ValueError(f"{name}: every tensor must be on {dev}")
            if not t.is_contiguous():
                raise ValueError(f"{name}: tensor {i} must be contiguous (it "
                                 f"is written in place)")
        if residuals is not None and residuals[i].shape != g.shape:
            raise ValueError(f"{name}: tensor {i}: residual "
                             f"{tuple(residuals[i].shape)} against "
                             f"{tuple(g.shape)}")


def compress_int8_(grads: Sequence[torch.Tensor],
                   residuals: Optional[Sequence[torch.Tensor]] = None, *,
                   block: int = 256) -> None:
    """The int8 round trip of every tensor of ``grads`` in place, with error
    feedback into ``residuals`` where they are given.  See the module
    docstring."""
    grads = list(grads)
    residuals = None if residuals is None else list(residuals)
    _check(grads, residuals, block)
    dev = grads[0].device
    if dev.type == "cpu":
        compress_int8_ref_(grads, residuals, block)
        return
    rows = []
    for i, g in enumerate(grads):
        if g.numel():
            rows.append((g.data_ptr(), 0 if residuals is None
                         else residuals[i].data_ptr(), g.numel()))
    if not rows:
        return
    vec = 4 if block % 4 == 0 and all(
        p % 16 == 0 for r in rows for p in r[:2]) else 1
    entries = np.ascontiguousarray(np.array(rows, dtype=np.int64))
    lib = _build.load()
    work = torch.empty((lib.compress_workspace_bytes(len(rows)),),
                       dtype=torch.uint8, device=dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    with torch.cuda.device(dev):
        err = lib.compress_int8(entries.ctypes.data, len(rows), block, vec,
                                work.data_ptr(), sms, _tensors.stream(dev))
    _build.check(lib, "compress_int8_", err)
    LAUNCHES["compress"] += 1
