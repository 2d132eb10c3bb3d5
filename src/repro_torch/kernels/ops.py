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
from .decode_attn import flash_decode
from .decode_attn_int8 import flash_decode_int8
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


def attention(q, k, v, causal: bool = True, use_kernel: bool = True):
    if use_kernel:
        return flash_attention(q, k, v, causal=causal)
    return ref.attention_ref(q, k, v, causal=causal)


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
