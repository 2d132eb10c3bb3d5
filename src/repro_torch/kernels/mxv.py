"""Crossbar MxV: the CM core's analog matrix-vector unit, on Hopper.

``crossbar_mxv`` and ``crossbar_mxv_int8`` launch the hand-written CUDA
kernels of ``csrc/mxv.cu`` (port of the two Pallas kernels of
``repro.kernels.mxv``) on CUDA tensors, and run their plain PyTorch versions
(:func:`crossbar_mxv_plain`, :func:`crossbar_mxv_int8_plain`) on CPU
tensors.  A CUDA tensor never falls back to the plain version: the kernel
launches or the wrapper raises.

Unlike the JAX wrappers, these take any shape as it is: the kernels mask
their ragged edges, and CUDA has no retracing to bound, so there is no
zero-padding and no power-of-two batch bucketing.  The launch geometry
comes from :func:`mxv_plan`, from the shapes alone.

``LAUNCHES`` counts kernel launches per kernel name (plain-version calls
are not counted); :func:`reset_launches` zeroes it.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from . import _build, _tensors
from .ref import crossbar_mxv_int8_ref, crossbar_mxv_ref

LAUNCHES = {"crossbar_mxv": 0, "crossbar_mxv_int8": 0}
_INT_MAX = 2 ** 31 - 1
# csrc/mxv.cu's most warps a float block and its most parts of k (4 parts
# of 64 columns beat 8 of 32 at the main path's N = 252, PERF.md), and the
# threads of an int8 block; the plan's shared-memory budget (the C entry
# raises a kernel's limit above 48 KB); the H100's SM count, which the grid
# should reach
WARPS, KS, MMA_THREADS, SMEM_BYTES, SMS = 8, 4, 128, 96 * 1024, 132
# mma.sync m16n8k32: a tile of 16 batch rows x 8 crossbar rows, 32 of k
MMA_M, MMA_N, MMA_K = 16, 8, 32


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def crossbar_mxv_plain(x: torch.Tensor, wq: torch.Tensor,
                       scale: torch.Tensor) -> torch.Tensor:
    """The plain version of :func:`crossbar_mxv` (output in x's dtype)."""
    return crossbar_mxv_ref(x, wq, scale).to(x.dtype)


crossbar_mxv_int8_plain = crossbar_mxv_int8_ref


@dataclasses.dataclass(frozen=True)
class MxvPlan:
    """How ``csrc/mxv.cu`` cuts one call.  Block ``i`` of ``grid[0] *
    grid[1]`` owns output columns ``(i % grid[1]) * mt`` onwards and batch
    rows ``(i // grid[1]) * rows`` onwards, with ``threads`` threads.  It
    stages k ``chunk`` columns at a time in ``smem_bytes`` of shared memory:
    its ``mt`` crossbar rows at ``wstride`` bytes a row and its x rows at
    ``xstride``; ``wraw`` and ``xraw`` (0 for none) are where the block's
    rows land as one contiguous region when they are not aligned (the
    kernel reads 4-byte aligned crossbar rows there, and unpacks the rest
    into the padded rows).  Float
    kernel: a warp is ``mt`` columns by ``32 // mt`` rows, the block ``ks``
    parts of k of ``kc`` columns each by ``rows // (32 // mt)`` row groups.
    Int8 kernel: ``mt`` = 8, ``rows // 16`` warps of 16 rows each take all
    of k (``ks`` = 1).  ``args`` is the plan as the C entry points take
    it."""
    mt: int
    rows: int
    ks: int
    kc: int
    chunk: int
    wstride: int
    xstride: int
    smem_bytes: int
    grid: tuple[int, int]
    threads: int
    wraw: int
    xraw: int
    args: ctypes.Array = dataclasses.field(compare=False, repr=False)


def _odd16(nbytes: int) -> int:
    """``nbytes`` rounded up to an odd number of 16-byte units: rows at that
    stride put the 8 lanes of a 16-byte shared load's phase on 8 different
    bank groups."""
    return 16 * (-(-nbytes // 16) | 1)


def _raw(nbytes: int) -> int:
    """Bytes for a region of ``nbytes`` copied as the 16-byte units that
    hold it (up to 15 more on either side), in 16-byte units."""
    return -(-(nbytes + 32) // 16) * 16


def _make(mt, rows, ks, kc, wstride, xstride, smem, grid, threads, wraw,
          xraw):
    vals = (mt, rows, ks, kc, ks * kc, wstride, xstride, smem, grid[1],
            grid[0] * grid[1], threads, wraw, xraw)
    if max(vals) > _INT_MAX:
        raise ValueError(f"crossbar_mxv: launch plan {vals} exceeds int32")
    return MxvPlan(mt, rows, ks, kc, ks * kc, wstride, xstride, smem, grid,
                   threads, wraw, xraw, (ctypes.c_int * len(vals))(*vals))


def _float_plan(b, n, m, elem):
    mt = min(32, max(4, 1 << (min(m, 32) - 1).bit_length()))
    rw = 32 // mt                              # rows a warp
    n16 = -(-n // 16) * 16

    def blocks(rg):
        return -(-b // (rg * rw)) * -(-m // mt)
    # every part at least 16 columns, at most KS parts; then as few rows a
    # block as it takes to reach the card's SMs (or as many blocks as
    # there are warp tiles), and no more row groups than B fills; then k
    # parts traded for rows while the grid stays that large
    ks = min(KS, 1 << ((n16 // 16).bit_length() - 1))
    rg = WARPS // ks
    want = min(SMS, blocks(1))
    while rg > 1 and (blocks(rg) < want or rg // 2 * rw >= b):
        rg //= 2
    while ks > 1 and blocks(2 * rg) >= SMS:
        ks, rg = ks // 2, rg * 2
    return _float_layout(b, n, m, elem, mt, rg, ks)


def _float_layout(b, n, m, elem, mt, rg, ks):
    """The float kernel's plan for the lane layout ``_float_plan`` chose:
    ``mt`` columns a tile (32 // mt rows a warp), ``rg`` row groups and
    ``ks`` parts of k a block; the largest chunk of k that fits
    ``SMEM_BYTES``."""
    rows, threads = rg * 32 // mt, 32 * rg * ks
    n16 = -(-n // 16) * 16

    def layout(kc):
        cols = min(ks * kc, n16)
        wstride, xstride = _odd16(cols), _odd16(cols * elem)
        total = mt * wstride + rows * xstride + (4 * threads if ks > 1 else 0)
        wraw = xraw = 0
        # one chunk: crossbar rows not 16-byte aligned, x rows not 4-byte
        # aligned go as one region each
        if ks * kc >= n and n % 16:
            wraw, total = total, total + _raw(mt * n)
        if ks * kc >= n and n * elem % 4:
            xraw, total = total, total + _raw(rows * n * elem)
        return wstride, xstride, total, wraw, xraw
    kc = -(-n16 // (16 * ks)) * 16
    while layout(kc)[2] > SMEM_BYTES and kc > 16:
        kc -= 16
    wstride, xstride, total, wraw, xraw = layout(kc)
    return _make(mt, rows, ks, kc, wstride, xstride, total,
                 (-(-b // rows), -(-m // mt)), threads, wraw, xraw)


def _int8_plan(b, n, m):
    row_tiles, tiles = -(-b // MMA_M), -(-m // MMA_N)
    # as many 16-row warps a block as keep the grid at the card's SMs (or
    # at the number of tiles)
    wpb = min(MMA_THREADS // 32, 1 << (row_tiles.bit_length() - 1))
    want = min(SMS, row_tiles * tiles)
    while wpb > 1 and -(-row_tiles // wpb) * tiles < want:
        wpb //= 2
    rows = MMA_M * wpb

    def layout(chunk):
        # a row stride of 16 mod 32 bytes: the mma fragments' 32-bit loads
        # (8 rows x 4 words) hit 32 different banks
        stride = chunk + 16
        total = (rows + MMA_N) * stride
        wraw = xraw = 0
        if chunk >= n and n % 4:   # one chunk: unaligned rows as a region
            xraw, total = total, total + _raw(rows * n)
            wraw, total = total, total + _raw(MMA_N * n)
        return stride, total, wraw, xraw
    chunk = -(-n // MMA_K) * MMA_K
    while layout(chunk)[1] > SMEM_BYTES and chunk > MMA_K:
        chunk -= MMA_K
    stride, total, wraw, xraw = layout(chunk)
    return _make(MMA_N, rows, 1, chunk, stride, stride, total,
                 (-(-row_tiles // wpb), tiles), MMA_THREADS, wraw, xraw)


@functools.lru_cache(maxsize=256)
def mxv_plan(b: int, n: int, m: int, dtype: torch.dtype = torch.float32
             ) -> MxvPlan:
    """The launch plan of ``crossbar_mxv`` (x of ``dtype`` float32 or
    bfloat16) or, for ``dtype`` int8, of ``crossbar_mxv_int8``, for x
    (B, N) and a crossbar (M, N).  Shapes only: no tensor is read.  Float:
    the column tile is the power of two >= min(M, 32), at least 4, with
    32 / tile rows a warp; a block of at most 8 warps splits k into at most
    4 parts of at least 16 columns, has as few row groups as it takes for
    the grid to reach 132 blocks (or every warp tile) and no more than B
    fills, and trades k parts for row groups while the grid keeps >= 132
    blocks.  Int8: 16 x 8 tiles, 1, 2 or 4 tiles of rows a block, as many
    as keep the grid at 132 blocks (or at every tile).  k is staged in
    chunks that fit ``SMEM_BYTES``; where one chunk takes all of k, rows
    that are not aligned (float: crossbar rows not 16-byte aligned, x rows
    not 4-byte aligned; int8: N not a multiple of 4) get room to land as
    one region.
    Raises ValueError for an empty shape.  Cached: the simulator calls it
    with a few shapes over and over."""
    if min(b, n, m) < 1:
        raise ValueError(f"crossbar_mxv: no plan for an empty shape (B, N, "
                         f"M) = {(b, n, m)}")
    if dtype == torch.int8:
        return _int8_plan(b, n, m)
    return _float_plan(b, n, m, torch.empty((), dtype=dtype).element_size())


def _launch(name, device, fn, *args):
    """``fn(*args, stream)`` on ``device``'s current stream, entering the
    device only where it is not the current one; raises on a CUDA error."""
    if device.index == torch.cuda.current_device():
        err = fn(*args, _tensors.stream(device))
    else:
        with torch.cuda.device(device):
            err = fn(*args, _tensors.stream(device))
    if err:
        _build.check(_build.load(), name, err)
    LAUNCHES[name] += 1


def _check_common(name, x, wq, row_scales, dtypes):
    """(B, N, M) and the device of the operands, or raise on what the
    kernels do not take.  Each property is read once: the wrappers' host
    time is the most a small call costs."""
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
    device = x.device
    for label, t, size in row_scales:
        if t.dtype != torch.float32 or t.shape != (size,):
            raise ValueError(f"{name}: {label} must be float32 of shape "
                             f"({size},), got {t.dtype} {tuple(t.shape)}")
        if t.device != device:
            raise ValueError(f"{name}: {label} is on {t.device}, x on "
                             f"{device}: all operands must be on one device")
    if wq.device != device:
        raise ValueError(f"{name}: wq is on {wq.device}, x on {device}: all "
                         f"operands must be on one device")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {device}")
    if max(b * n, m * n, b * m) > _INT_MAX:
        raise ValueError(f"{name}: shape {(b, n, m)} exceeds int32 indexing")
    return b, n, m, device


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
    b, n, m, device = _check_common(
        "crossbar_mxv", x, wq, [("scale", scale, wq.shape[0])],
        (torch.float32, torch.bfloat16))
    _check_resident("crossbar_mxv", [("wq", wq), ("scale", scale)])
    if device.type == "cpu":
        return crossbar_mxv_plain(x, wq, scale)
    _tensors.check_no_grad("crossbar_mxv", x, wq, scale)
    x = x.contiguous()
    y = x.new_empty((b, m))
    if b == 0 or m == 0:
        return y
    lib = _build.load()
    f32 = x.dtype == torch.float32
    _launch("crossbar_mxv", device,
            lib.crossbar_mxv_f32 if f32 else lib.crossbar_mxv_bf16,
            x.data_ptr(), wq.data_ptr(), scale.data_ptr(), y.data_ptr(), b,
            n, m, mxv_plan(b, n, m, x.dtype).args)
    return y


def crossbar_mxv_int8(xq: torch.Tensor, xs: torch.Tensor, wq: torch.Tensor,
                      ws: torch.Tensor) -> torch.Tensor:
    """Fully-int8 (DAC) path: ``acc = xq @ wq^T`` exactly in int32, then
    ``y = (acc * xs[:, None]) * ws[None, :]``.  xq (B, N) int8; xs (B,) f32;
    wq (M, N) int8; ws (M,) f32 -> y (B, M) f32.

    xq and xs may be strided (they are made contiguous); wq and ws must be
    contiguous."""
    b, n, m, device = _check_common(
        "crossbar_mxv_int8", xq, wq,
        [("xs", xs, xq.shape[0]), ("ws", ws, wq.shape[0])], (torch.int8,))
    _check_resident("crossbar_mxv_int8", [("wq", wq), ("ws", ws)])
    if device.type == "cpu":
        return crossbar_mxv_int8_plain(xq, xs, wq, ws)
    _tensors.check_no_grad("crossbar_mxv_int8", xs, ws)
    xq, xs = xq.contiguous(), xs.contiguous()
    y = xs.new_empty((b, m))
    if b == 0 or m == 0:
        return y
    _launch("crossbar_mxv_int8", device, _build.load().crossbar_mxv_int8,
            xq.data_ptr(), xs.data_ptr(), wq.data_ptr(), ws.data_ptr(),
            y.data_ptr(), b, n, m, mxv_plan(b, n, m, torch.int8).args)
    return y
