"""Flash decode: one query token per sequence over its KV cache, on Hopper.

``flash_decode`` launches the hand-written split-KV kernels of
``csrc/decode_attn.cu`` (port of the Pallas kernel
``repro.kernels.decode_attn.flash_decode``) on CUDA tensors, and runs its
plain PyTorch version (:func:`flash_decode_plain`, the oracle
``ref.decode_ref``) on CPU tensors.  A CUDA tensor never falls back to the
plain version: the kernels launch or the wrapper raises.

The signature is the reference's, q (B, Hq, D) and k/v (B, Hkv, S, D), but
k and v are read through their strides: the model passes its (B, S, Hkv, D)
cache as ``transpose(1, 2)`` views, without a copy.  ``length`` is a scalar
(every row, as in the reference) or a (B,) integer tensor (one per row);
positions ``>= length`` are masked, and the kernels read only the positions
below it.  A row with ``length <= 0`` has every position masked and gets
the mean of V over all S positions, as the Pallas kernel (which masks with
the finite -1e30) and the plain version give; ``length > S`` reads all S.

On the card one call is two launches: ``decode_split_kernel`` computes a
partial softmax state per chunk of 64 positions into an f32 workspace, and
``decode_merge_kernel`` combines a row's partials.  :func:`decode_plan`
gives the chunk, the grids and the workspace from the shapes alone: the
lengths stay on the device and are never read by the host.

``LAUNCHES`` counts wrapper calls that launch the kernels, one per call
(plain-version calls and direct calls of :func:`launch`, which takes a
caller's workspace, are not counted); :func:`reset_launches` zeroes it.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from . import _build, _tensors
from .ref import decode_ref

LAUNCHES = {"flash_decode": 0}
# csrc/decode_attn.cu's positions per split block, query heads per split
# block and (row, query head) pairs per merge block
CHUNK, MAXG, MERGE_ROWS = 64, 8, 4
_GRID_MAX = 65535


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def flash_decode_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       length) -> torch.Tensor:
    """The plain version of :func:`flash_decode`."""
    return decode_ref(q, k, v, length)


@dataclasses.dataclass(frozen=True)
class DecodePlan:
    """How ``csrc/decode_attn.cu`` cuts one decode call.  Split block
    ``(x, y, z)`` of ``split_grid`` takes positions ``[chunk z, chunk (z +
    1))`` (the chunk is the slowest dimension: working blocks are scheduled
    first) of row ``y // groups``, KV head ``x`` and query heads ``MAXG (y
    % groups)`` onwards (at most ``MAXG``, within the KV head's G), and
    writes one (acc[D], m, l) per head into the f32 ``workspace``, shape
    (B, Hq, n_chunks, D + 4); merge block ``x`` of ``merge_grid`` combines
    rows ``MERGE_ROWS x`` onwards of the (B * Hq) (row, query head)
    pairs."""
    chunk: int
    n_chunks: int
    groups: int
    split_grid: tuple[int, int, int]
    merge_grid: tuple[int]
    workspace: tuple[int, int, int, int]


@functools.lru_cache(maxsize=64)
def decode_plan(b: int, hq: int, hkv: int, s: int, d: int) -> DecodePlan:
    """The launch plan of the decode kernels (float or int8 cache) for q
    (B, Hq, D) over a k/v cache (B, Hkv, S, D).  It depends on the shapes
    only: the lengths are not an argument, so the host never reads them.  A
    block whose chunk starts at or past its row's length exits at once; the
    rest do the work.  Raises ValueError where the grid exceeds the
    card's.  Cached: a model calls it with the same shapes at every decode
    step of every layer."""
    groups = -(-(hq // hkv) // MAXG)
    n_chunks = -(-s // CHUNK)
    if b * groups > _GRID_MAX or n_chunks > _GRID_MAX:
        raise ValueError(f"flash_decode: B={b} x {groups} head groups or "
                         f"S={s} exceeds the kernel's grid")
    return DecodePlan(chunk=CHUNK, n_chunks=n_chunks, groups=groups,
                      split_grid=(hkv, b * groups, n_chunks),
                      merge_grid=(-(-b * hq // MERGE_ROWS),),
                      workspace=(b, hq, n_chunks, d + 4))


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
    if s == 0:
        raise ValueError(f"{name}: no cache positions (S == 0)")
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
    out = launch(q, k, v, lengths)
    LAUNCHES["flash_decode"] += 1
    return out


def launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           lengths: torch.Tensor, workspace: torch.Tensor | None = None
           ) -> torch.Tensor:
    """The kernels on CUDA operands that :func:`flash_decode` has checked,
    with (B,) int32 ``lengths``; not counted in ``LAUNCHES``.  The f32
    workspace of the plan's shape is allocated here unless given: a caller
    that fills it first sees which partials the split kernel wrote."""
    b, hq, d = q.shape
    hkv, s = k.shape[1:3]
    _tensors.check_cuda_head_dim("flash_decode", d)
    plan = decode_plan(b, hq, hkv, s, d)
    q = _tensors.aligned(q.contiguous(), 4)
    k, v = (_tensors.aligned(t, 16 // t.element_size()) for t in (k, v))
    out = torch.empty((b, hq, d), dtype=q.dtype, device=q.device)
    if b == 0 or hq == 0:
        return out
    ws = workspace_for(plan, q.device, workspace)
    lib = _build.load()
    fn = lib.flash_decode_f32 if q.dtype == torch.float32 \
        else lib.flash_decode_bf16
    # the last three (scale) strides are not read by the float kernel
    st = _tensors.strides((q, (0, 1)), (k, (0, 1, 2)), (v, (0, 1, 2)),
                          (out, (0, 1)), (k, (0, 1, 2)))
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 lengths.data_ptr(), ws.data_ptr(), b, hq, hkv, s, d,
                 1.0 / (d ** 0.5), st, _tensors.stream(q.device))
    _build.check(lib, "flash_decode", err)
    return out


def written_blocks(plan: DecodePlan, workspace: torch.Tensor) -> int:
    """The split blocks that wrote their partials into ``workspace``, which
    held NaN before the call: a block writes m (slot D) for each of its
    query heads, and a block that exits past its row's length writes
    nothing."""
    b, hq, nc, _ = plan.workspace
    hkv = plan.split_grid[0]
    g = hq // hkv
    wrote = ~torch.isnan(workspace[..., -4]).view(b, hkv, g, nc)
    return sum(int(wrote[:, :, h:h + MAXG].any(2).sum())
               for h in range(0, g, MAXG))


def workspace_for(plan: DecodePlan, device: torch.device,
                  given: torch.Tensor | None = None) -> torch.Tensor:
    """The f32 workspace of ``plan``: ``given`` once checked, else a new
    (uninitialised) one."""
    if given is None:
        return torch.empty(plan.workspace, dtype=torch.float32,
                           device=device)
    if (given.dtype != torch.float32 or tuple(given.shape) != plan.workspace
            or not given.is_contiguous() or given.device != device):
        raise ValueError(f"flash_decode: the workspace must be a contiguous "
                         f"float32 {plan.workspace} on {device}, got "
                         f"{given.dtype} {tuple(given.shape)} on "
                         f"{given.device}")
    return given
