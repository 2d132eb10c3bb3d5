"""Plain PyTorch oracles for the crossbar kernels.

Port of the crossbar part of ``repro.kernels.ref``: the same functions, with
torch tensors on any device.  The quantizers give int8 codes and f32 scales
identical to the JAX oracles and to the numpy twins in
``core.compute_plane`` (same f32 division, round-half-to-even, clip).
"""

from __future__ import annotations

import torch


def quantize_crossbar(w: torch.Tensor, bits: int = 8):
    """Symmetric per-row quantization: the 'analog programming' model."""
    w = w.to(torch.float32)
    qmax = 2.0 ** (bits - 1) - 1
    scale = w.abs().amax(dim=1).clamp_min(1e-12) / qmax
    wq = torch.clamp(torch.round(w / scale[:, None]), -qmax, qmax)
    return wq.to(torch.int8), scale


def quantize_vec(x: torch.Tensor, bits: int = 8):
    """Per-row symmetric activation quantization (the DAC model)."""
    x = x.to(torch.float32)
    qmax = 2.0 ** (bits - 1) - 1
    scale = x.abs().amax(dim=-1).clamp_min(1e-12) / qmax
    xq = torch.clamp(torch.round(x / scale[..., None]), -qmax, qmax)
    return xq.to(torch.int8), scale


def crossbar_mxv_ref(x: torch.Tensor, wq: torch.Tensor,
                     scale: torch.Tensor) -> torch.Tensor:
    """``(x @ wq^T) * scale`` in f32.  On a CUDA tensor the caller keeps
    ``torch.backends.cuda.matmul.allow_tf32`` False, or the product runs in
    TF32 (about three decimal digits)."""
    return (x.to(torch.float32) @ wq.to(torch.float32).T) * scale[None, :]


def crossbar_mxv_int8_ref(xq: torch.Tensor, xs: torch.Tensor,
                          wq: torch.Tensor, ws: torch.Tensor) -> torch.Tensor:
    """``(acc * xs[:, None]) * ws[None, :]`` with ``acc = xq @ wq^T``.

    The integer product is taken in float64, which is exact here (|acc| <=
    127^2 * N, far below 2^53) and, unlike an int32 matmul, runs on CUDA
    tensors too."""
    acc = xq.to(torch.float64) @ wq.to(torch.float64).T
    return acc.to(torch.float32) * xs[:, None] * ws[None, :]
