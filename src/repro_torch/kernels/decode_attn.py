"""Flash decode: one query token per sequence over its KV cache, on Hopper.

``flash_decode`` launches the hand-written CUDA kernel of
``csrc/decode_attn.cu`` (port of the Pallas kernel
``repro.kernels.decode_attn.flash_decode``) on CUDA tensors, and runs its
plain PyTorch version (:func:`flash_decode_plain`, the oracle
``ref.decode_ref``) on CPU tensors.  A CUDA tensor never falls back to the
plain version: the kernel launches or the wrapper raises.

The signature is the reference's, q (B, Hq, D) and k/v (B, Hkv, S, D), but
k and v are read through their strides: the model passes its (B, S, Hkv, D)
cache as ``transpose(1, 2)`` views, without a copy.  ``length`` is a scalar
(every row, as in the reference) or a (B,) integer tensor (one per row);
positions ``>= length`` are masked, and the kernel reads only the positions
below it.  ``length == 0`` gives zeros from the kernel and an average of V
over all positions from the plain version; the model never passes it.

``LAUNCHES`` counts kernel launches (plain-version calls are not counted);
:func:`reset_launches` zeroes it.
"""

from __future__ import annotations

import torch

from . import _build, _tensors
from .ref import decode_ref

LAUNCHES = {"flash_decode": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def flash_decode_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       length) -> torch.Tensor:
    """The plain version of :func:`flash_decode`."""
    return decode_ref(q, k, v, length)


def check_decode(name, q, k, v, kv_dtypes):
    """Shapes, types and devices of a decode call -> (B, Hq, Hkv, S, D)."""
    if q.dim() != 3 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"{name}: q must be 3-D and k, v 4-D, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if q.dtype not in _tensors.FLOAT_DTYPES:
        raise TypeError(f"{name}: q must be one of {_tensors.FLOAT_DTYPES}, "
                        f"got {q.dtype}")
    if k.dtype not in kv_dtypes or v.dtype != k.dtype:
        raise TypeError(f"{name}: k and v must share one of {kv_dtypes}, got "
                        f"{k.dtype}, {v.dtype}")
    b, hq, d = q.shape
    bk, hkv, s, dk = k.shape
    if (bk, dk) != (b, d) or tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"{name}: q {tuple(q.shape)} and k/v "
                         f"{tuple(k.shape)}/{tuple(v.shape)} disagree")
    if hkv == 0 or hq % hkv:
        raise ValueError(f"{name}: Hq={hq} is not a multiple of Hkv={hkv}")
    if k.device != q.device or v.device != q.device:
        raise ValueError(f"{name}: q, k, v must be on one device")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {q.device}")
    return b, hq, hkv, s, d


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 length) -> torch.Tensor:
    """q (B, Hq, D); k/v (B, Hkv, S, D), f32 or bf16 like q; length a scalar
    or (B,) -> (B, Hq, D) in q's dtype."""
    b, hq, hkv, s, d = check_decode("flash_decode", q, k, v, (q.dtype,))
    lengths = _tensors.row_lengths("flash_decode", length, b, q.device)
    if q.device.type == "cpu":
        return flash_decode_plain(q, k, v, lengths)
    _tensors.check_cuda_head_dim("flash_decode", d)
    q = _tensors.aligned(q.contiguous(), 4)
    k, v = _tensors.aligned(k, 4), _tensors.aligned(v, 4)
    out = torch.empty((b, hq, d), dtype=q.dtype, device=q.device)
    if b == 0 or hq == 0:
        return out
    lib = _build.load()
    fn = lib.flash_decode_f32 if q.dtype == torch.float32 \
        else lib.flash_decode_bf16
    # the last three (scale) strides are not read by the float kernel
    st = _tensors.strides((q, (0, 1)), (k, (0, 1, 2)), (v, (0, 1, 2)),
                          (out, (0, 1)), (k, (0, 1, 2)))
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 lengths.data_ptr(), b, hq, hkv, s, d, 1.0 / (d ** 0.5), st,
                 _tensors.stream(q.device))
    _build.check(lib, "flash_decode", err)
    LAUNCHES["flash_decode"] += 1
    return out
