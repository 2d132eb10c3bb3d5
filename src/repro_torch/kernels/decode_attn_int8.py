"""Flash decode over an int8 KV cache, on Hopper.

``flash_decode_int8`` launches the hand-written split-KV kernels of
``csrc/decode_attn.cu`` (port of the Pallas kernel
``repro.kernels.decode_attn_int8.flash_decode_int8``) on CUDA tensors, and
runs its plain PyTorch version (:func:`flash_decode_int8_plain`, the oracle
``ref.decode_int8_ref``: dequantize, then exact decode attention) on CPU
tensors.  A CUDA tensor never falls back to the plain version.

k8/v8 are int8 (B, Hkv, S, D) and their scales f32 (B, Hkv, S, 1), one per
(position, head): the layout of ``models.layers.kv_quantize`` seen through
``transpose(1, 2)`` views of the model's (B, S, Hkv, ·) cache, read through
strides without a copy.  The kernels apply each position's scales after
the load (to its dot product and to its softmax weight) and accumulate in
f32, so the cache's bytes are half a bf16 cache's.  ``length`` is a scalar
or a (B,) integer tensor, as for ``decode_attn.flash_decode``, with the
same split, merge and launch plan (``decode_attn.decode_plan``); a row with
``length <= 0`` gets the mean of the dequantized V over all S positions.

Over a part of an int8 cache (serving under a mesh):
:func:`flash_decode_int8_partial` is ``decode_attn.flash_decode_partial``
over a window of codes and scales; :func:`decode_scores_int8` and
:func:`decode_apply_int8` are ``decode_attn.decode_scores`` and
``decode_apply`` over a slice of the codes, the whole head's scales (which
every rank of the slice holds) applied to each position's partial dot
product and to its P.

``LAUNCHES`` counts wrapper calls that launch the kernels, one per call
(not direct calls of :func:`launch`); :func:`reset_launches` zeroes it.
"""

from __future__ import annotations

import torch

from . import _build, _tensors
from . import decode_attn
from .decode_attn import check_decode, decode_plan, workspace_for
from .ref import (decode_apply_ref, decode_int8_partial_ref, decode_int8_ref,
                  decode_scores_ref)

LAUNCHES = {"flash_decode_int8": 0, "flash_decode_int8_partial": 0,
            "decode_scores_int8": 0, "decode_apply_int8": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def flash_decode_int8_plain(q: torch.Tensor, k8: torch.Tensor,
                            k_scale: torch.Tensor, v8: torch.Tensor,
                            v_scale: torch.Tensor, length) -> torch.Tensor:
    """The plain version of :func:`flash_decode_int8`."""
    return decode_int8_ref(q, k8, k_scale, v8, v_scale, length)


def check_scales(name, q, scales, b, hkv, s):
    for label, sc in scales:
        if sc.dtype != torch.float32 or tuple(sc.shape) != (b, hkv, s, 1):
            raise ValueError(f"{name}: {label} must be float32 of shape "
                             f"{(b, hkv, s, 1)}, got {sc.dtype} "
                             f"{tuple(sc.shape)}")
        if sc.device != q.device:
            raise ValueError(f"{name}: {label} is on {sc.device}, q on "
                             f"{q.device}")


def flash_decode_int8(q: torch.Tensor, k8: torch.Tensor,
                      k_scale: torch.Tensor, v8: torch.Tensor,
                      v_scale: torch.Tensor, length) -> torch.Tensor:
    """q (B, Hq, D) f32/bf16; k8/v8 (B, Hkv, S, D) int8; k_scale/v_scale
    (B, Hkv, S, 1) f32; length a scalar or (B,) -> (B, Hq, D) in q's
    dtype."""
    name = "flash_decode_int8"
    b, hq, hkv, s, d = check_decode(name, q, k8, v8, (torch.int8,))
    check_scales(name, q, (("k_scale", k_scale), ("v_scale", v_scale)), b,
                 hkv, s)
    lengths = _tensors.row_lengths(name, length, b, q.device)
    if q.device.type == "cpu":
        return flash_decode_int8_plain(q, k8, k_scale, v8, v_scale, lengths)
    _tensors.check_no_grad(name, q, k_scale, v_scale)
    out = launch(q, k8, k_scale, v8, v_scale, lengths)
    LAUNCHES[name] += 1
    return out


def flash_decode_int8_partial(q: torch.Tensor, k8: torch.Tensor,
                              k_scale: torch.Tensor, v8: torch.Tensor,
                              v_scale: torch.Tensor, length, w0: int = 0):
    """``decode_attn.flash_decode_partial`` over an int8 window (codes
    (B, Hkv, W, D), scales (B, Hkv, W, 1)) -> (o f32, lse f32)."""
    name = "flash_decode_int8_partial"
    b, hq, hkv, s, d = check_decode(name, q, k8, v8, (torch.int8,))
    check_scales(name, q, (("k_scale", k_scale), ("v_scale", v_scale)), b,
                 hkv, s)
    w0 = decode_attn.check_window(name, w0)
    lengths = _tensors.row_lengths(name, length, b, q.device)
    if q.device.type == "cpu":
        return decode_int8_partial_ref(q, k8, k_scale, v8, v_scale, lengths,
                                       w0)
    _tensors.check_no_grad(name, q, k_scale, v_scale)
    out = launch(q, k8, k_scale, v8, v_scale, lengths, w0=w0)
    LAUNCHES[name] += 1
    return out


def decode_scores_int8(q: torch.Tensor, k8: torch.Tensor,
                       k_scale: torch.Tensor, length, w0: int,
                       sm_scale: float) -> torch.Tensor:
    """``decode_attn.decode_scores`` over a slice of int8 codes (B, Hkv, W,
    D') with the whole head's scales (B, Hkv, W, 1)."""
    name = "decode_scores_int8"
    b, hq, hkv, w, dp = decode_attn.check_slice(name, q, k8)
    if q.dtype not in _tensors.FLOAT_DTYPES or k8.dtype != torch.int8:
        raise TypeError(f"{name}: q must be f32 or bf16 and k int8, got "
                        f"{q.dtype}, {k8.dtype}")
    check_scales(name, q, (("k_scale", k_scale),), b, hkv, w)
    w0 = decode_attn.check_window(name, w0)
    lengths = _tensors.row_lengths(name, length, b, q.device)
    if q.device.type == "cpu":
        return decode_scores_ref(q, k8, lengths, w0, sm_scale, k_scale)
    _tensors.check_no_grad(name, q, k_scale)
    out = decode_attn.launch_scores(q, k8, k_scale, lengths, w0, sm_scale)
    LAUNCHES[name] += 1
    return out


def decode_apply_int8(scores: torch.Tensor, v8: torch.Tensor,
                      v_scale: torch.Tensor, length, w0: int = 0):
    """``decode_attn.decode_apply`` over a slice of int8 codes with the
    whole head's scales -> (o f32, lse f32)."""
    name = "decode_apply_int8"
    b, hq, w = decode_attn.check_apply(name, scores, v8)
    if v8.dtype != torch.int8:
        raise TypeError(f"{name}: v must be int8, got {v8.dtype}")
    check_scales(name, scores, (("v_scale", v_scale),), b, v8.shape[1], w)
    w0 = decode_attn.check_window(name, w0)
    lengths = _tensors.row_lengths(name, length, b, v8.device)
    if v8.device.type == "cpu":
        return decode_apply_ref(scores, v8, lengths, w0, v_scale)
    _tensors.check_no_grad(name, scores, v_scale)
    out = decode_attn.launch_apply(scores, v8, v_scale, lengths, w0)
    LAUNCHES[name] += 1
    return out


def launch(q: torch.Tensor, k8: torch.Tensor, k_scale: torch.Tensor,
           v8: torch.Tensor, v_scale: torch.Tensor, lengths: torch.Tensor,
           workspace: torch.Tensor | None = None, w0: int | None = None):
    """The kernels on CUDA operands that :func:`flash_decode_int8` has
    checked, as ``decode_attn.launch`` (``w0``: its partial mode); not
    counted in ``LAUNCHES``."""
    name = "flash_decode_int8"
    b, hq, d = q.shape
    hkv, s = k8.shape[1:3]
    _tensors.check_cuda_head_dim(name, d)
    plan = decode_plan(b, hq, hkv, s, d)
    q = _tensors.aligned(q.contiguous(), 4)
    k8, v8 = _tensors.aligned(k8, 16), _tensors.aligned(v8, 16)
    if k_scale.stride() != v_scale.stride():
        # the kernel reads both scales through one set of strides
        k_scale, v_scale = k_scale.contiguous(), v_scale.contiguous()
    partial = w0 is not None
    out, lse = decode_attn._outputs(q, partial)
    if b == 0 or hq == 0:
        return (out, lse) if partial else out
    ws = workspace_for(plan, q.device, workspace)
    lib = _build.load()
    fn = lib.flash_decode_int8_f32 if q.dtype == torch.float32 \
        else lib.flash_decode_int8_bf16
    st = _tensors.strides((q, (0, 1)), (k8, (0, 1, 2)), (v8, (0, 1, 2)),
                          (out, (0, 1)), (k_scale, (0, 1, 2)))
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k8.data_ptr(), k_scale.data_ptr(),
                 v8.data_ptr(), v_scale.data_ptr(), out.data_ptr(),
                 decode_attn._ptr(lse), lengths.data_ptr(), ws.data_ptr(), b,
                 hq, hkv, s, d, w0 or 0, 1.0 / (d ** 0.5), st,
                 _tensors.stream(q.device))
    _build.check(lib, name, err)
    return (out, lse) if partial else out
