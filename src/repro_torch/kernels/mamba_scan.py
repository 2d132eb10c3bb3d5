"""Selective scan (Mamba-1) on Hopper.

``selective_scan`` launches the hand-written CUDA kernel of
``csrc/mamba_scan.cu`` (port of the Pallas kernel
``repro.kernels.mamba_scan.selective_scan``) on CUDA tensors, and runs its
plain PyTorch version (the sequential oracle ``ref.selective_scan_ref``) on
CPU tensors.  A CUDA tensor never falls back to the
plain version: the kernel launches or the wrapper raises.

The signature is the reference's: u/dt (B, L, D), a (D, N), b/c (B, L, N),
d_skip (D,).  The result is what the Pallas wrapper returns for an f32
``d_skip``: y (B, L, D) in f32, the scan plus ``d_skip * u``.  The Pallas
kernel rounds the scan to u's dtype before the skip term is added; this one
keeps it in f32, as the model's ``mamba`` does before it casts.
``return_state=True`` also returns the final state hT (B, D, N) in f32, which
prefill hands to decode.  ``b`` and ``c`` are read through any strides (the
model passes column slices of one projection); u and dt through their batch
and time strides, with a contiguous last dimension (else they are copied).
No block-size arguments and no divisibility rule on L.

``LAUNCHES`` counts kernel launches (plain-version calls are not counted);
:func:`reset_launches` zeroes it.
"""

from __future__ import annotations

import torch

from . import _build, _tensors
from .ref import selective_scan_ref

LAUNCHES = {"selective_scan": 0}
MAX_STATE = 16          # the kernel keeps N <= 16 state values in registers


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _check(u, dt, a, b, c, d_skip):
    name = "selective_scan"
    if u.dim() != 3 or a.dim() != 2 or b.dim() != 3 or d_skip.dim() != 1:
        raise ValueError(f"{name}: expected u/dt (B, L, D), a (D, N), b/c "
                         f"(B, L, N), d_skip (D,); got u {tuple(u.shape)}, a "
                         f"{tuple(a.shape)}, b {tuple(b.shape)}, d_skip "
                         f"{tuple(d_skip.shape)}")
    bsz, l, d = u.shape
    n = a.shape[1]
    if tuple(dt.shape) != (bsz, l, d) or tuple(a.shape) != (d, n) \
            or tuple(b.shape) != (bsz, l, n) \
            or tuple(c.shape) != (bsz, l, n) or tuple(d_skip.shape) != (d,):
        raise ValueError(f"{name}: shapes disagree: u {tuple(u.shape)}, dt "
                         f"{tuple(dt.shape)}, a {tuple(a.shape)}, b "
                         f"{tuple(b.shape)}, c {tuple(c.shape)}, d_skip "
                         f"{tuple(d_skip.shape)}")
    if u.dtype not in _tensors.FLOAT_DTYPES or any(
            t.dtype != u.dtype for t in (dt, b, c)):
        raise TypeError(f"{name}: u, dt, b, c must share one of "
                        f"{_tensors.FLOAT_DTYPES}, got {u.dtype}, {dt.dtype}, "
                        f"{b.dtype}, {c.dtype}")
    if not (a.is_floating_point() and d_skip.is_floating_point()):
        raise TypeError(f"{name}: a and d_skip must be floating point")
    if any(t.device != u.device for t in (dt, a, b, c, d_skip)):
        raise ValueError(f"{name}: all operands must be on one device")
    if u.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {u.device}")
    return bsz, l, d, n


def selective_scan(u: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                   b: torch.Tensor, c: torch.Tensor, d_skip: torch.Tensor,
                   return_state: bool = False):
    """y (B, L, D) f32 [, hT (B, D, N) f32]; see the module docstring."""
    bsz, l, d, n = _check(u, dt, a, b, c, d_skip)
    if u.device.type == "cpu":
        return selective_scan_ref(u, dt, a, b, c, d_skip, return_state)
    if not 1 <= n <= MAX_STATE:
        raise ValueError(f"selective_scan: the CUDA kernel takes a state of "
                         f"1 to {MAX_STATE}, got N={n}")
    if bsz > 65535:
        raise ValueError(f"selective_scan: the CUDA kernel takes at most "
                         f"65535 sequences, got B={bsz}")
    u, dt = (t if t.stride(-1) == 1 else t.contiguous() for t in (u, dt))
    a32 = a.to(torch.float32).contiguous()
    dsk = d_skip.to(torch.float32).contiguous()
    y = torch.empty((bsz, l, d), dtype=torch.float32, device=u.device)
    h = torch.zeros((bsz, d, n), dtype=torch.float32, device=u.device)
    if bsz and l and d:
        lib = _build.load()
        fn = lib.selective_scan_f32 if u.dtype == torch.float32 \
            else lib.selective_scan_bf16
        st = _tensors.strides((u, (0, 1)), (dt, (0, 1)), (b, (0, 1, 2)),
                              (c, (0, 1, 2)))
        with torch.cuda.device(u.device):
            err = fn(u.data_ptr(), dt.data_ptr(), a32.data_ptr(),
                     b.data_ptr(), c.data_ptr(), dsk.data_ptr(),
                     y.data_ptr(), h.data_ptr(), bsz, l, d, n, st,
                     _tensors.stream(u.device))
        _build.check(lib, "selective_scan", err)
        LAUNCHES["selective_scan"] += 1
    return (y, h) if return_state else y
