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

``LAUNCHES`` counts wrapper calls that launch the kernel, one per call
(plain-version calls are not counted); :func:`reset_launches` zeroes it.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from . import _build, _tensors
from .ref import selective_scan_ref

LAUNCHES = {"selective_scan": 0}
# csrc/mamba_scan.cu: threads per block and state columns a group
THREADS, GROUP = 128, 16
SMS = 132                   # an H100 SXM's SMs
TARGET_WARPS = SMS * 8      # working warps that fill the card
WIDE_BLOCKS = SMS * 4       # resident blocks of 4 or 8 lanes a channel
_GRID_MAX = 65535


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


def _aligned(vec: int, *tensors) -> bool:
    """Each tensor's data pointer on 16 bytes and its batch and time
    strides multiples of ``vec`` elements: its rows take 16-byte copies."""
    return all(t.data_ptr() % 16 == 0 and t.stride(0) % vec == 0
               and t.stride(1) % vec == 0 for t in tensors)


def selective_scan(u: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                   b: torch.Tensor, c: torch.Tensor, d_skip: torch.Tensor,
                   return_state: bool = False):
    """y (B, L, D) f32 [, hT (B, D, N) f32]; see the module docstring."""
    bsz, l, d, n = _check(u, dt, a, b, c, d_skip)
    if u.device.type == "cpu":
        return selective_scan_ref(u, dt, a, b, c, d_skip, return_state)
    _tensors.check_no_grad("selective_scan", u, dt, a, b, c, d_skip)
    y = torch.empty((bsz, l, d), dtype=torch.float32, device=u.device)
    if not (bsz and l and d):
        h = torch.zeros((bsz, d, n), dtype=torch.float32, device=u.device)
        return (y, h) if return_state else y
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
    return (y, h) if return_state else y
