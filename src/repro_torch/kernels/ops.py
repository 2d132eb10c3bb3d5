"""Entry points for the port's kernels, each with an explicit ``use_kernel``.

Port of ``repro.kernels.ops``.  ``use_kernel=True`` (the default here, where
the reference defaults the attention ops to its oracle) calls the kernel's
wrapper, which launches the CUDA kernel on CUDA tensors and runs the plain
PyTorch version on CPU tensors; ``use_kernel=False`` calls the plain version
(the oracle of :mod:`.ref`) on any device.  That is an explicit choice of
the caller, never a fallback.  ``mamba_scan`` returns what the model needs,
the f32 output and, for prefill, the final state, where the reference's
returns the output alone.
"""

from __future__ import annotations

from . import ref
from .conv2d import crossbar_conv2d
from .decode_attn import (decode_apply, decode_merge, decode_scores,
                          flash_decode, flash_decode_partial)
from .decode_attn_int8 import (decode_apply_int8, decode_scores_int8,
                               flash_decode_int8, flash_decode_int8_partial)
from .flash_attn import flash_attention
from .mamba_scan import selective_scan
from .mxv import crossbar_mxv, crossbar_mxv_int8

quantize_crossbar = ref.quantize_crossbar
quantize_vec = ref.quantize_vec


def mxv(x, wq, scale, use_kernel: bool = True):
    if use_kernel:
        return crossbar_mxv(x, wq, scale)
    return ref.crossbar_mxv_ref(x, wq, scale)


def mxv_int8(xq, xs, wq, ws, use_kernel: bool = True):
    if use_kernel:
        return crossbar_mxv_int8(xq, xs, wq, ws)
    return ref.crossbar_mxv_int8_ref(xq, xs, wq, ws)


def conv2d(x, wq, scale, stride=1, pad=0, fh=3, fw=3,
           use_kernel: bool = True):
    if use_kernel:
        return crossbar_conv2d(x, wq, scale, stride=stride, pad=pad, fh=fh,
                               fw=fw)
    return ref.crossbar_conv2d_ref(x, wq, scale, stride, pad, fh, fw)


SCORES_ON_THE_CARD = (
    "runs on the plain attention path only (the dry run's): the flash "
    "kernels keep their scores in f32 registers, and the port has no score "
    "collective for the knob to halve")


def attention(q, k, v, causal: bool = True, use_kernel: bool = True,
              q_stride: int = 1, scores_dtype: str = "float32"):
    """Flash attention, or its plain version.  ``scores_dtype`` other than
    f32 (the reference's knob) is the plain version's alone: the wrapper
    runs it on CPU and fake tensors and raises on the card
    (:data:`SCORES_ON_THE_CARD`); ``use_kernel=False`` takes it anywhere."""
    if use_kernel:
        if scores_dtype == "float32":
            return flash_attention(q, k, v, causal=causal, q_stride=q_stride)
        if q.is_cuda:
            raise NotImplementedError(
                f"scores_dtype={scores_dtype!r} {SCORES_ON_THE_CARD}")
    return ref.attention_ref(q, k, v, causal=causal, q_stride=q_stride,
                             scores_dtype=scores_dtype)


def decode_attention(q, k, v, length, use_kernel: bool = True):
    if use_kernel:
        return flash_decode(q, k, v, length)
    return ref.decode_ref(q, k, v, length)


def mamba_scan(u, dt, a, b, c, d_skip, use_kernel: bool = True,
               return_state: bool = True):
    """y (B, L, D) f32 (scan + ``d_skip * u``) and, with ``return_state``,
    hT (B, D, N) f32.  Without it the kernel's call is differentiable
    (training asks for y alone)."""
    if use_kernel:
        return selective_scan(u, dt, a, b, c, d_skip,
                              return_state=return_state)
    return ref.selective_scan_ref(u, dt, a, b, c, d_skip,
                                  return_state=return_state)


def decode_attention_int8(q, k8, k_scale, v8, v_scale, length,
                          use_kernel: bool = True):
    if use_kernel:
        return flash_decode_int8(q, k8, k_scale, v8, v_scale, length)
    return ref.decode_int8_ref(q, k8, k_scale, v8, v_scale, length)


def decode_attention_partial(q, k, v, length, w0: int = 0,
                             use_kernel: bool = True, k_scale=None,
                             v_scale=None):
    """(o f32, lse f32) of the decode over a window of the cache (an int8
    one with ``k_scale``/``v_scale``): the split-KV kernels' partial mode,
    or its plain version."""
    if k_scale is not None:
        if use_kernel:
            return flash_decode_int8_partial(q, k, k_scale, v, v_scale,
                                             length, w0)
        return ref.decode_int8_partial_ref(q, k, k_scale, v, v_scale, length,
                                           w0)
    if use_kernel:
        return flash_decode_partial(q, k, v, length, w0)
    return ref.decode_partial_ref(q, k, v, length, w0)


def decode_attention_merge(o, lse, use_kernel: bool = True):
    """The merge of partials over disjoint windows (stacked on dim 0)."""
    if use_kernel:
        return decode_merge(o, lse)
    return ref.decode_merge_ref(o, lse)


def decode_attention_scores(q, k, length, w0: int, sm_scale: float,
                            use_kernel: bool = True, k_scale=None):
    """The partial scores over a slice of the head dim (an int8 slice with
    the whole head's ``k_scale``)."""
    if use_kernel:
        if k_scale is not None:
            return decode_scores_int8(q, k, k_scale, length, w0, sm_scale)
        return decode_scores(q, k, length, w0, sm_scale)
    return ref.decode_scores_ref(q, k, length, w0, sm_scale, k_scale)


def decode_attention_apply(scores, v, length, w0: int = 0,
                           use_kernel: bool = True, v_scale=None):
    """(o f32, lse f32): the softmax of the summed scores and P.V over a
    slice of the head dim (an int8 slice with the whole head's
    ``v_scale``)."""
    if use_kernel:
        if v_scale is not None:
            return decode_apply_int8(scores, v, v_scale, length, w0)
        return decode_apply(scores, v, length, w0)
    return ref.decode_apply_ref(scores, v, length, w0, v_scale)
