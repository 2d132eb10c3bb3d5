"""Listing-1 convolution (paper Listing 1, one CM core) on Hopper.

``crossbar_conv2d`` launches the hand-written CUDA kernel of
``csrc/conv2d.cu`` (port of the Pallas kernel
``repro.kernels.conv2d.crossbar_conv2d``) on CUDA tensors, and runs its
plain PyTorch version (:func:`crossbar_conv2d_plain`, the oracle
``ref.crossbar_conv2d_ref``) on CPU tensors.  A CUDA tensor never falls
back to the plain version: the kernel launches or the wrapper raises.

The signature and layouts are the reference's: x (C, H, W), the crossbar
wq (FL, C*FH*FW) with k over (c, fh, fw), one scale per filter, and the
result (FL, OH, OW) f32.  The kernel pads by masked loads, so there is no
padded copy of x.  Its launch geometry, the column tile, K split and
channel chunk, is chosen here by :func:`conv_plan`.

``LAUNCHES`` counts kernel launches (plain-version calls are not counted);
:func:`reset_launches` zeroes it.
"""

from __future__ import annotations

import dataclasses

import torch

from . import _build
from .ref import crossbar_conv2d_ref

LAUNCHES = {"crossbar_conv2d": 0}
_INT_MAX = 2 ** 31 - 1
_GRID_MAX = 65535
# csrc/conv2d.cu's threads per block, filters per block, shared-memory
# budget and widest column tile; the H100's SM count, which the grid
# should reach
THREADS, TF, SMEM_BYTES, MAX_TJ, SMS = 256, 4, 48 * 1024, 32, 132

crossbar_conv2d_plain = crossbar_conv2d_ref


def reset_launches() -> None:
    LAUNCHES["crossbar_conv2d"] = 0


def _out_size(n: int, pad: int, f: int, stride: int) -> int:
    return (n + 2 * pad - f) // stride + 1


@dataclasses.dataclass(frozen=True)
class ConvPlan:
    """How ``csrc/conv2d.cu`` cuts one conv: a block owns output row
    ``blockIdx.x``, ``tj`` columns and ``TF`` filters; its ``THREADS``
    threads are ``tj`` columns x ``ks`` parts of K (channel c goes to part
    c % ks); channels are staged ``cc`` at a time in ``smem_bytes`` of
    shared memory."""
    tj: int
    ks: int
    cc: int
    grid: tuple[int, int, int]
    smem_bytes: int


def conv_plan(c: int, fl: int, fh: int, fw: int, stride: int, oh: int,
              ow: int) -> ConvPlan:
    """The launch geometry of ``crossbar_conv2d`` for a (C, ., .) input,
    FL filters of FH x FW and an (OH, OW) output.  The column tile starts
    at the least power of two >= OW (at most 32) and is halved, doubling the
    K split, while the grid has fewer blocks than the card has SMs and the
    K split stays below twice the channels (most parts own a channel).
    Raises ValueError where one channel's input rows and weights do not fit
    the shared memory."""
    tj = min(MAX_TJ, 1 << (ow - 1).bit_length())

    def blocks(t):
        return oh * -(-ow // t) * -(-fl // TF)
    while tj > 1 and blocks(tj) < SMS and THREADS // (tj // 2) < 2 * c:
        tj //= 2
    per_channel = 4 * fh * ((tj - 1) * stride + fw + fw * TF)
    room = SMEM_BYTES - 4 * THREADS * TF          # after the reduction buffer
    if per_channel > room:
        raise ValueError(f"crossbar_conv2d: one channel's {fh} input rows "
                         f"and weights ({per_channel} bytes) do not fit the "
                         f"kernel's {room} bytes of shared memory")
    cc = min(c, room // per_channel)
    return ConvPlan(tj=tj, ks=THREADS // tj, cc=cc,
                    grid=(oh, -(-ow // tj), -(-fl // TF)),
                    smem_bytes=4 * THREADS * TF + cc * per_channel)


def _check(x, wq, scale, stride, pad, fh, fw):
    name = "crossbar_conv2d"
    if x.dim() != 3 or wq.dim() != 2:
        raise ValueError(f"{name}: x must be (C, H, W) and wq (FL, K), got "
                         f"{tuple(x.shape)} and {tuple(wq.shape)}")
    if x.dtype != torch.float32:
        raise TypeError(f"{name}: x must be float32, got {x.dtype}")
    if wq.dtype not in (torch.int8, torch.float32):
        raise TypeError(f"{name}: wq must be int8 or float32, got {wq.dtype}")
    for label, v, least in (("stride", stride, 1), ("pad", pad, 0),
                            ("fh", fh, 1), ("fw", fw, 1)):
        if int(v) != v or v < least:
            raise ValueError(f"{name}: {label} must be an integer >= {least},"
                             f" got {v}")
    stride, pad, fh, fw = int(stride), int(pad), int(fh), int(fw)
    c, h, w = x.shape
    fl, k = wq.shape
    if c < 1 or k != c * fh * fw:
        raise ValueError(f"{name}: wq has {k} columns, C*FH*FW = "
                         f"{c}*{fh}*{fw} = {c * fh * fw}")
    if scale.dtype != torch.float32 or tuple(scale.shape) != (fl,):
        raise ValueError(f"{name}: scale must be float32 of shape ({fl},), "
                         f"got {scale.dtype} {tuple(scale.shape)}")
    oh, ow = _out_size(h, pad, fh, stride), _out_size(w, pad, fw, stride)
    if oh < 1 or ow < 1:
        raise ValueError(f"{name}: a {fh}x{fw} window does not fit the "
                         f"{h}x{w} input padded by {pad}")
    tensors = (x, wq, scale)
    if any(t.device != x.device for t in tensors):
        raise ValueError(f"{name}: all operands must be on one device, got "
                         f"{[str(t.device) for t in tensors]}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {x.device}")
    # the crossbar is programmed once and reused: a strided one is a caller
    # bug, not something to copy on every call
    for label, t in (("wq", wq), ("scale", scale)):
        if not t.is_contiguous():
            raise ValueError(f"{name}: {label} must be contiguous")
    if max(x.numel(), wq.numel(), fl * oh * ow) > _INT_MAX:
        raise ValueError(f"{name}: shape exceeds int32 indexing")
    plan = conv_plan(c, fl, fh, fw, stride, oh, ow)
    if plan.grid[0] > _INT_MAX or max(plan.grid[1:]) > _GRID_MAX:
        raise ValueError(f"{name}: output ({fl}, {oh}, {ow}) exceeds the "
                         f"kernel's grid")
    return c, h, w, fl, oh, ow, (stride, pad, fh, fw), plan


def crossbar_conv2d(x: torch.Tensor, wq: torch.Tensor, scale: torch.Tensor,
                    stride: int = 1, pad: int = 0, fh: int = 3,
                    fw: int = 3) -> torch.Tensor:
    """``y[f, i, j] = scale[f] * sum_k patch(i, j)[k] * wq[f, k]``.  x (C, H,
    W) f32; wq (FL, C*FH*FW) int8 or f32; scale (FL,) f32 -> y (FL, OH, OW)
    f32, f32 accumulation.

    x may be strided (it is made contiguous); wq and scale must be
    contiguous."""
    c, h, w, fl, oh, ow, (stride, pad, fh, fw), plan = _check(
        x, wq, scale, stride, pad, fh, fw)
    if x.device.type == "cpu":
        return crossbar_conv2d_plain(x, wq, scale, stride, pad, fh, fw)
    x = x.contiguous()
    y = torch.empty((fl, oh, ow), dtype=torch.float32, device=x.device)
    if fl == 0:
        return y
    lib = _build.load()
    fn = lib.crossbar_conv2d_i8 if wq.dtype == torch.int8 \
        else lib.crossbar_conv2d_f32
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), wq.data_ptr(), scale.data_ptr(), y.data_ptr(),
                 c, h, w, fl, fh, fw, stride, pad, oh, ow, plan.tj, plan.cc,
                 stream)
    _build.check(lib, "crossbar_conv2d", err)
    LAUNCHES["crossbar_conv2d"] += 1
    return y
