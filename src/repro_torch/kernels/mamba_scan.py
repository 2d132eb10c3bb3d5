"""Selective scan (Mamba-1) on Hopper.

``selective_scan`` launches the hand-written CUDA kernel of
``csrc/mamba_scan.cu`` (port of the Pallas kernel
``repro.kernels.mamba_scan.selective_scan``) on CUDA tensors, and runs its
plain PyTorch version (the sequential oracle ``ref.selective_scan_ref``) on
CPU tensors.  A CUDA tensor never falls back to the
plain version: the kernel launches or the wrapper raises.

The signature is the reference's: u/dt (B, L, D), a (D, N), b/c (B, L, N),
d_skip (D,), for any state size N >= 1.  The result is what the Pallas
wrapper returns for an f32 ``d_skip``: y (B, L, D) in f32, the scan plus
``d_skip * u``.  The Pallas kernel rounds the scan to u's dtype before the
skip term is added; this one keeps it in f32, as the model's ``mamba``
does before it casts.  ``return_state=True`` also returns the final state
hT (B, D, N) in f32, which prefill hands to decode.  ``b`` and ``c`` are
read through any strides (the model passes column slices of one
projection); u and dt through their batch and time strides, with a
contiguous last dimension (else they are copied), in 16-byte loads where
the pointers and strides allow.  No block-size arguments and no
divisibility rule on L or D.

:func:`scan_plan` cuts one call from the shapes alone (the host reads no
tensor value): how many of a channel's states a lane carries and how many
lanes share a channel.  The kernel source's header says why.

**Training.**  Where autograd records the call (grad mode on and an input
requires grad), :func:`selective_scan` goes through :class:`SelectiveScan`:
its forward is the same kernel, and its backward
(:func:`selective_scan_bwd`) three kernels of ``csrc/mamba_scan_bwd.cu``:
a forward walk that stores the state at the start of every chunk of
``BWD_CHUNK`` steps, the reverse walk (each chunk's states recomputed from
its start into shared memory, then ``g_t = dy_t C_t + a_{t+1} g_{t+1}``
walked back, du and ddt summed over the state, dA per sequence, dB and dC
per block of ``BWD_CHANNELS`` channels), and a reduction of the partial
sums in a fixed order.  No atomics, so a backward is bit-equal from run to
run.  The JAX package has no such kernel: it differentiates its plain
chunked scan.  On CPU tensors the Function runs the plain versions
``ref.selective_scan_ref`` / ``ref.selective_scan_bwd_ref`` (f64 for f64
inputs, for ``gradcheck``).  Training never asks for the final state:
``return_state=True`` raises where autograd records the call.  Otherwise
the call goes straight to the forward kernel, as in serving and in a CUDA
graph's capture.

``LAUNCHES`` counts wrapper calls that launch the kernels, one per call:
``selective_scan`` for the forward, ``selective_scan_bwd`` for the
backward's three kernels (plain-version calls are not counted);
:func:`reset_launches` zeroes them.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from . import _build, _tensors
from .ref import selective_scan_bwd_ref, selective_scan_ref

LAUNCHES = {"selective_scan": 0, "selective_scan_bwd": 0}
# csrc/mamba_scan.cu: threads per block and state columns a group
THREADS, GROUP = 128, 16
SMS = 132                   # an H100 SXM's SMs
TARGET_WARPS = SMS * 8      # working warps that fill the card
WIDE_BLOCKS = SMS * 4       # resident blocks of 4 or 8 lanes a channel
_GRID_MAX = 65535
# csrc/mamba_scan_bwd.cu: steps a chunk (a state stored at each chunk's
# start) and channels a block (a partial sum of dB and dC per block)
BWD_CHUNK, BWD_CHANNELS = 16, 32


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


@dataclasses.dataclass(frozen=True)
class ScanPlan:
    """How ``csrc/mamba_scan.cu`` cuts one call.  A channel's state runs
    in ``groups`` groups of ``GROUP`` columns, one after another; within a
    group each of ``lanes`` lanes carries ``states`` columns.  Block ``(x,
    y)`` of ``grid``, ``THREADS`` threads, takes channels ``channels x``
    onwards of sequence ``y`` and walks all L steps, staged ``tile`` steps
    a round.  ``vec`` is the elements of one 16-byte load of u and dt;
    ``working_warps`` the warps that hold a channel."""
    states: int
    lanes: int
    channels: int
    groups: int
    tile: int
    grid: tuple[int, int]
    vec: int
    working_warps: int


@functools.lru_cache(maxsize=64)
def scan_plan(b: int, l: int, d: int, n: int, dtype: torch.dtype
              ) -> ScanPlan:
    """The launch plan for u/dt (B, L, D) of ``dtype`` and a state of N.
    Shapes only: no tensor is read.  S = 8 states a lane, halved down to
    2, doubling the lanes of a channel, while the warps that hold a
    channel fall short of ``TARGET_WARPS`` and the wider grid has at most
    ``WIDE_BLOCKS`` blocks (the kernel's launch bound at 4 and 8 lanes
    keeps that many resident).  Raises ValueError for an empty shape or a
    grid past the card's.  Cached: a model calls it with the same shapes
    in every layer."""
    if min(b, l, d, n) < 1:
        raise ValueError(f"selective_scan: no plan for an empty shape (B, "
                         f"L, D, N) = {(b, l, d, n)}")
    if b > _GRID_MAX:
        raise ValueError(f"selective_scan: B={b} exceeds the kernel's grid")

    def warps(g):
        return b * -(-d * g // 32)

    def blocks(g):
        return b * -(-d * g // THREADS)

    states, lanes = 8, GROUP // 8
    while states > 2 and warps(lanes) < TARGET_WARPS \
            and blocks(2 * lanes) <= WIDE_BLOCKS:
        states, lanes = states // 2, lanes * 2
    elem = torch.empty((), dtype=dtype).element_size()
    return ScanPlan(
        states=states, lanes=lanes, channels=THREADS // lanes,
        groups=-(-n // GROUP), tile=(8 if elem == 2 else 4) * lanes,
        grid=(blocks(lanes) // b, b), vec=16 // elem,
        working_warps=warps(lanes))


def _check(u, dt, a, b, c, d_skip, train=False):
    """The operands' sizes; ``train`` (the autograd path) also takes f64 on
    the CPU, for ``gradcheck``."""
    name = "selective_scan"
    dtypes = _tensors.FLOAT_DTYPES + (
        (torch.float64,) if train and u.device.type == "cpu" else ())
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
    if u.dtype not in dtypes or any(
            t.dtype != u.dtype for t in (dt, b, c)):
        raise TypeError(f"{name}: u, dt, b, c must share one of "
                        f"{dtypes}, got {u.dtype}, {dt.dtype}, "
                        f"{b.dtype}, {c.dtype}")
    if not (a.is_floating_point() and d_skip.is_floating_point()):
        raise TypeError(f"{name}: a and d_skip must be floating point")
    if any(t.device != u.device for t in (dt, a, b, c, d_skip)):
        raise ValueError(f"{name}: all operands must be on one device")
    if u.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {u.device}")
    return bsz, l, d, n


def _aligned(vec: int, *tensors) -> bool:
    """Each tensor's data pointer on 16 bytes and its batch and time
    strides multiples of ``vec`` elements: its rows take 16-byte copies."""
    return all(t.data_ptr() % 16 == 0 and t.stride(0) % vec == 0
               and t.stride(1) % vec == 0 for t in tensors)


def selective_scan(u: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                   b: torch.Tensor, c: torch.Tensor, d_skip: torch.Tensor,
                   return_state: bool = False):
    """y (B, L, D) f32 [, hT (B, D, N) f32]; see the module docstring.
    Differentiable where autograd records it (:class:`SelectiveScan`),
    without ``return_state``."""
    if _tensors.grad_needed(u, dt, a, b, c, d_skip):
        _check(u, dt, a, b, c, d_skip, train=True)
        if return_state:
            raise ValueError("selective_scan: return_state=True has no "
                             "backward (no gradient into hT); training asks "
                             "for y alone")
        return SelectiveScan.apply(u, dt, a, b, c, d_skip)
    _check(u, dt, a, b, c, d_skip)
    if u.device.type == "cpu":
        return selective_scan_ref(u, dt, a, b, c, d_skip, return_state)
    y, h = _forward(u, dt, a, b, c, d_skip)
    return (y, h) if return_state else y


def _forward(u, dt, a, b, c, d_skip):
    """The forward kernel on checked CUDA operands: (y, hT)."""
    bsz, l, d = u.shape
    n = a.shape[1]
    y = torch.empty((bsz, l, d), dtype=torch.float32, device=u.device)
    if not (bsz and l and d):
        return y, torch.zeros((bsz, d, n), dtype=torch.float32,
                              device=u.device)
    plan = scan_plan(bsz, l, d, n, u.dtype)
    u, dt = (t if t.stride(-1) == 1 else t.contiguous() for t in (u, dt))
    a32 = a.to(torch.float32).contiguous()
    dsk = d_skip.to(torch.float32).contiguous()
    h = torch.empty((bsz, d, n), dtype=torch.float32, device=u.device)
    vec = _aligned(plan.vec, u, dt) | 2 * (
        _aligned(plan.vec, b, c) and b.stride(2) == c.stride(2) == 1)
    lib = _build.load()
    fn = lib.selective_scan_f32 if u.dtype == torch.float32 \
        else lib.selective_scan_bf16
    st = _tensors.strides((u, (0, 1)), (dt, (0, 1)), (b, (0, 1, 2)),
                          (c, (0, 1, 2)))
    with torch.cuda.device(u.device):
        err = fn(u.data_ptr(), dt.data_ptr(), a32.data_ptr(), b.data_ptr(),
                 c.data_ptr(), dsk.data_ptr(), y.data_ptr(), h.data_ptr(),
                 bsz, l, d, n, plan.states, plan.lanes, plan.tile, vec, st,
                 _tensors.stream(u.device))
    _build.check(lib, "selective_scan", err)
    LAUNCHES["selective_scan"] += 1
    return y, h


def selective_scan_bwd(u: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                       b: torch.Tensor, c: torch.Tensor, d_skip: torch.Tensor,
                       dy: torch.Tensor):
    """(du, ddt, da, db, dc, dd): the gradients of :func:`selective_scan`'s
    y at ``dy`` (B, L, D), the gradient of the f32 y.  The three backward
    kernels on CUDA tensors, ``ref.selective_scan_bwd_ref`` on CPU tensors.
    du, ddt, db, dc come in u's dtype and shape (contiguous), da (D, N) and
    dd (D,) in f32 (f64 for f64 inputs on the CPU)."""
    bsz, l, d, n = _check(u, dt, a, b, c, d_skip, train=True)
    if tuple(dy.shape) != (bsz, l, d) or not dy.is_floating_point() \
            or dy.device != u.device:
        raise ValueError(f"selective_scan_bwd: dy must be a float tensor of "
                         f"shape {(bsz, l, d)} on {u.device}, got {dy.dtype} "
                         f"{tuple(dy.shape)} on {dy.device}")
    if u.device.type == "cpu":
        return selective_scan_bwd_ref(u, dt, a, b, c, d_skip, dy)
    if bsz > _GRID_MAX:
        raise ValueError(f"selective_scan_bwd: B={bsz} exceeds the kernels' "
                         f"grid")
    f32 = dict(dtype=torch.float32, device=u.device)
    du, ddt = (torch.empty((bsz, l, d), dtype=u.dtype, device=u.device)
               for _ in range(2))
    db, dc = (torch.empty((bsz, l, n), dtype=u.dtype, device=u.device)
              for _ in range(2))
    da, dd = torch.zeros((d, n), **f32), torch.zeros((d,), **f32)
    if not (bsz and l and d):
        return du.zero_(), ddt.zero_(), da, db.zero_(), dc.zero_(), dd
    u, dt = (t if t.stride(-1) == 1 else t.contiguous() for t in (u, dt))
    a32 = a.to(torch.float32).contiguous()
    dsk = d_skip.to(torch.float32).contiguous()
    dy32 = dy.to(torch.float32).contiguous()
    chunks = -(-l // BWD_CHUNK)
    blocks = -(-d // BWD_CHANNELS)
    # workspaces: the states at the chunks' starts (chunk 0's is zero),
    # du and ddt summed over the state groups before the last (N > 16),
    # the blocks' partial dB and dC, each sequence's dA and dD
    bounds = torch.empty((bsz, max(chunks - 1, 1), d, n), **f32)
    acc = torch.empty((2, bsz, l, d) if n > GROUP else (1,), **f32)
    pbc = torch.empty((2, bsz, blocks, l, n), **f32)
    pa = torch.empty((bsz, d, n), **f32)
    pd = torch.empty((bsz, d), **f32)
    lib = _build.load()
    fn = lib.selective_scan_bwd_f32 if u.dtype == torch.float32 \
        else lib.selective_scan_bwd_bf16
    st = _tensors.strides((u, (0, 1)), (dt, (0, 1)), (b, (0, 1, 2)),
                          (c, (0, 1, 2)))
    with torch.cuda.device(u.device):
        err = fn(u.data_ptr(), dt.data_ptr(), a32.data_ptr(), b.data_ptr(),
                 c.data_ptr(), dsk.data_ptr(), dy32.data_ptr(),
                 du.data_ptr(), ddt.data_ptr(), da.data_ptr(), db.data_ptr(),
                 dc.data_ptr(), dd.data_ptr(), bounds.data_ptr(),
                 acc.data_ptr(), pbc.data_ptr(), pa.data_ptr(),
                 pd.data_ptr(), bsz, l, d, n, st, _tensors.stream(u.device))
    _build.check(lib, "selective_scan_bwd", err)
    LAUNCHES["selective_scan_bwd"] += 1
    return du, ddt, da, db, dc, dd


class SelectiveScan(torch.autograd.Function):
    """The selective scan with a backward: the forward kernel, the backward
    kernels (the plain versions on CPU tensors).  It saves the inputs; the
    backward recomputes the states from them."""

    @staticmethod
    def forward(ctx, u, dt, a, b, c, d_skip):
        if u.device.type == "cpu":
            y = selective_scan_ref(u, dt, a, b, c, d_skip)
        else:
            y = _forward(u, dt, a, b, c, d_skip)[0]
        ctx.save_for_backward(u, dt, a, b, c, d_skip)
        return y

    @staticmethod
    def backward(ctx, dy):
        u, dt, a, b, c, d_skip = ctx.saved_tensors
        du, ddt, da, db, dc, dd = selective_scan_bwd(u, dt, a, b, c, d_skip,
                                                     dy)
        return du, ddt, da.to(a.dtype), db, dc, dd.to(d_skip.dtype)
