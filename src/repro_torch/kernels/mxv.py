"""Crossbar MxV: the CM core's analog matrix-vector unit, on Hopper.

``crossbar_mxv`` and ``crossbar_mxv_int8`` launch the hand-written CUDA
kernels of ``csrc/mxv.cu`` (port of the two Pallas kernels of
``repro.kernels.mxv``) on CUDA tensors, and run their plain PyTorch versions
(:func:`crossbar_mxv_plain`, :func:`crossbar_mxv_int8_plain`) on CPU
tensors.  A CUDA tensor never falls back to the plain version: the kernel
launches or the wrapper raises.

Unlike the JAX wrappers, these take any shape as it is: the kernels mask
their ragged edges, and CUDA has no retracing to bound, so there is no
zero-padding and no power-of-two batch bucketing.

``LAUNCHES`` counts kernel launches per kernel name (plain-version calls
are not counted); :func:`reset_launches` zeroes it.
"""

from __future__ import annotations

import torch

from . import _build
from .ref import crossbar_mxv_int8_ref, crossbar_mxv_ref

LAUNCHES = {"crossbar_mxv": 0, "crossbar_mxv_int8": 0}
_INT_MAX = 2 ** 31 - 1


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def crossbar_mxv_plain(x: torch.Tensor, wq: torch.Tensor,
                       scale: torch.Tensor) -> torch.Tensor:
    """The plain version of :func:`crossbar_mxv` (output in x's dtype)."""
    return crossbar_mxv_ref(x, wq, scale).to(x.dtype)


crossbar_mxv_int8_plain = crossbar_mxv_int8_ref


def _check_common(name, x, wq, row_scales, dtypes):
    if x.dim() != 2 or wq.dim() != 2:
        raise ValueError(f"{name}: x and wq must be 2-D, got {tuple(x.shape)}"
                         f" and {tuple(wq.shape)}")
    if x.dtype not in dtypes:
        raise TypeError(f"{name}: x must be one of {dtypes}, got {x.dtype}")
    if wq.dtype != torch.int8:
        raise TypeError(f"{name}: wq must be int8, got {wq.dtype}")
    b, n = x.shape
    m, n2 = wq.shape
    if n != n2:
        raise ValueError(f"{name}: x has {n} columns, wq {n2}")
    for label, t, size in row_scales:
        if t.dtype != torch.float32 or tuple(t.shape) != (size,):
            raise ValueError(f"{name}: {label} must be float32 of shape "
                             f"({size},), got {t.dtype} {tuple(t.shape)}")
    tensors = [x, wq] + [t for _, t, _ in row_scales]
    if any(t.device != x.device for t in tensors):
        raise ValueError(f"{name}: all operands must be on one device, got "
                         f"{[str(t.device) for t in tensors]}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {x.device}")
    if max(b * n, m * n, b * m) > _INT_MAX:
        raise ValueError(f"{name}: shape {(b, n, m)} exceeds int32 indexing")
    return b, n, m


def _check_resident(name, tensors):
    # the crossbar operands are programmed once and reused: a strided one is
    # a caller bug, not something to copy on every call
    for label, t in tensors:
        if not t.is_contiguous():
            raise ValueError(f"{name}: {label} must be contiguous")


def crossbar_mxv(x: torch.Tensor, wq: torch.Tensor,
                 scale: torch.Tensor) -> torch.Tensor:
    """``y = (x @ wq^T) * scale``.  x (B, N) f32 or bf16; wq (M, N) int8;
    scale (M,) f32 -> y (B, M) in x's dtype, f32 accumulation.

    x may be strided (it is made contiguous); wq and scale must be
    contiguous."""
    b, n, m = _check_common("crossbar_mxv", x, wq, [("scale", scale, wq.shape[0])],
                            (torch.float32, torch.bfloat16))
    _check_resident("crossbar_mxv", [("wq", wq), ("scale", scale)])
    if x.device.type == "cpu":
        return crossbar_mxv_plain(x, wq, scale)
    x = x.contiguous()
    y = torch.empty((b, m), dtype=x.dtype, device=x.device)
    if b == 0 or m == 0:
        return y
    lib = _build.load()
    fn = lib.crossbar_mxv_f32 if x.dtype == torch.float32 \
        else lib.crossbar_mxv_bf16
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), wq.data_ptr(), scale.data_ptr(), y.data_ptr(),
                 b, n, m, stream)
    _build.check(lib, "crossbar_mxv", err)
    LAUNCHES["crossbar_mxv"] += 1
    return y


def crossbar_mxv_int8(xq: torch.Tensor, xs: torch.Tensor, wq: torch.Tensor,
                      ws: torch.Tensor) -> torch.Tensor:
    """Fully-int8 (DAC) path: ``acc = xq @ wq^T`` exactly in int32, then
    ``y = (acc * xs[:, None]) * ws[None, :]``.  xq (B, N) int8; xs (B,) f32;
    wq (M, N) int8; ws (M,) f32 -> y (B, M) f32.

    xq and xs may be strided (they are made contiguous); wq and ws must be
    contiguous."""
    b, n, m = _check_common("crossbar_mxv_int8", xq, wq,
                            [("xs", xs, xq.shape[0]), ("ws", ws, wq.shape[0])],
                            (torch.int8,))
    _check_resident("crossbar_mxv_int8", [("wq", wq), ("ws", ws)])
    if xq.device.type == "cpu":
        return crossbar_mxv_int8_plain(xq, xs, wq, ws)
    xq, xs = xq.contiguous(), xs.contiguous()
    y = torch.empty((b, m), dtype=torch.float32, device=xq.device)
    if b == 0 or m == 0:
        return y
    lib = _build.load()
    with torch.cuda.device(xq.device):
        stream = torch.cuda.current_stream(xq.device).cuda_stream
        err = lib.crossbar_mxv_int8(xq.data_ptr(), xs.data_ptr(),
                                    wq.data_ptr(), ws.data_ptr(),
                                    y.data_ptr(), b, n, m, stream)
    _build.check(lib, "crossbar_mxv_int8", err)
    LAUNCHES["crossbar_mxv_int8"] += 1
    return y
