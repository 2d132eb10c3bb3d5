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

**A part of the cache** (serving under a mesh, ``models.layers.
attention_decode``).  :func:`flash_decode_partial` is the same two
launches over a rank's window of a cache split over positions (``w0``:
the window's first position in the whole cache; the lengths are the whole
rows'): it returns o in f32 and each row's log-sum-exp, o = 0 and lse =
-inf where the window lies wholly past the row's length (a row with
``length <= 0`` takes every window's positions with equal scores).
:func:`decode_merge` merges such partials of disjoint windows through the
same merge kernel.  :func:`decode_scores` and :func:`decode_apply` run the
decode over a slice of the head dimension: the partial scores over the
slice (the caller sums them over the ranks), then the softmax and P.V over
the slice (``decode_scores_kernel``; ``decode_apply_kernel`` and the
merge).  Plain versions: ``ref.decode_partial_ref``, ``decode_merge_ref``,
``decode_scores_ref``, ``decode_apply_ref``.

``LAUNCHES`` counts wrapper calls that launch the kernels, one per call
(plain-version calls and direct calls of :func:`launch`, which takes a
caller's workspace, are not counted); :func:`reset_launches` zeroes it.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from . import _build, _tensors
from .ref import (decode_apply_ref, decode_merge_ref, decode_partial_ref,
                  decode_ref, decode_scores_ref)

LAUNCHES = {"flash_decode": 0, "flash_decode_partial": 0, "decode_merge": 0,
            "decode_scores": 0, "decode_apply": 0}
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
    _tensors.check_no_grad("flash_decode", q, k, v)
    out = launch(q, k, v, lengths)
    LAUNCHES["flash_decode"] += 1
    return out


def launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           lengths: torch.Tensor, workspace: torch.Tensor | None = None,
           w0: int | None = None):
    """The kernels on CUDA operands that :func:`flash_decode` has checked,
    with (B,) int32 ``lengths``; not counted in ``LAUNCHES``.  The f32
    workspace of the plan's shape is allocated here unless given: a caller
    that fills it first sees which partials the split kernel wrote.  With
    ``w0`` (an int), the partial mode: (o f32, lse f32) over the window
    that k/v hold, from position ``w0`` of the whole cache."""
    b, hq, d = q.shape
    hkv, s = k.shape[1:3]
    _tensors.check_cuda_head_dim("flash_decode", d)
    plan = decode_plan(b, hq, hkv, s, d)
    q = _tensors.aligned(q.contiguous(), 4)
    k, v = (_tensors.aligned(t, 16 // t.element_size()) for t in (k, v))
    partial = w0 is not None
    out, lse = _outputs(q, partial)
    if b == 0 or hq == 0:
        return (out, lse) if partial else out
    ws = workspace_for(plan, q.device, workspace)
    lib = _build.load()
    fn = lib.flash_decode_f32 if q.dtype == torch.float32 \
        else lib.flash_decode_bf16
    # the last three (scale) strides are not read by the float kernel
    st = _tensors.strides((q, (0, 1)), (k, (0, 1, 2)), (v, (0, 1, 2)),
                          (out, (0, 1)), (k, (0, 1, 2)))
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 _ptr(lse), lengths.data_ptr(), ws.data_ptr(), b, hq, hkv, s,
                 d, w0 or 0, 1.0 / (d ** 0.5), st,
                 _tensors.stream(q.device))
    _build.check(lib, "flash_decode", err)
    return (out, lse) if partial else out


def _outputs(q: torch.Tensor, partial: bool):
    """(out, lse) of a decode call: out (B, Hq, D) in q's dtype, or in f32
    with lse (B, Hq) f32 in the partial mode (lse None otherwise)."""
    b, hq, d = q.shape
    if not partial:
        return torch.empty((b, hq, d), dtype=q.dtype, device=q.device), None
    return (torch.empty((b, hq, d), dtype=torch.float32, device=q.device),
            torch.empty((b, hq), dtype=torch.float32, device=q.device))


def _ptr(t) -> int | None:
    return None if t is None else t.data_ptr()


def check_window(name: str, w0) -> int:
    """A window's first position as an int >= 0."""
    if isinstance(w0, bool) or not isinstance(w0, int) or w0 < 0:
        raise ValueError(f"{name}: w0 must be an int >= 0, got {w0!r}")
    return w0


def flash_decode_partial(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         length, w0: int = 0):
    """q (B, Hq, D); k/v (B, Hkv, W, D) a window of the cache from its
    position ``w0``; length a scalar or (B,), the whole rows' -> (o (B, Hq,
    D) f32, lse (B, Hq) f32)."""
    name = "flash_decode_partial"
    b, hq, hkv, s, d = check_decode(name, q, k, v, (q.dtype,))
    w0 = check_window(name, w0)
    lengths = _tensors.row_lengths(name, length, b, q.device)
    if q.device.type == "cpu":
        return decode_partial_ref(q, k, v, lengths, w0)
    _tensors.check_no_grad(name, q, k, v)
    out = launch(q, k, v, lengths, w0=w0)
    LAUNCHES[name] += 1
    return out


def decode_merge(o: torch.Tensor, lse: torch.Tensor) -> torch.Tensor:
    """n partials of disjoint windows, o (n, B, H, D) f32 and lse (n, B, H)
    f32 (:func:`flash_decode_partial`'s, stacked), contiguous on the card
    -> their merge (B, H, D) f32, by the merge kernel, which reads them
    where they lie."""
    name = "decode_merge"
    if o.dim() != 4 or tuple(lse.shape) != tuple(o.shape[:3]):
        raise ValueError(f"{name}: o must be (n, B, H, D) and lse (n, B, H), "
                         f"got {tuple(o.shape)}, {tuple(lse.shape)}")
    if o.dtype != torch.float32 or lse.dtype != torch.float32:
        raise TypeError(f"{name}: o and lse must be float32, got {o.dtype}, "
                        f"{lse.dtype}")
    if o.device.type == "cpu":
        return decode_merge_ref(o, lse)
    _tensors.check_no_grad(name, o, lse)
    n, b, h, d = o.shape
    if d % 4:
        raise ValueError(f"{name}: the CUDA kernel takes D a multiple of 4, "
                         f"got {d}")
    if not (o.is_contiguous() and lse.is_contiguous()):
        raise ValueError(f"{name}: the CUDA kernel reads o and lse "
                         f"contiguous")
    out = torch.empty((b, h, d), dtype=torch.float32, device=o.device)
    if b * h == 0:
        return out
    lib = _build.load()
    with torch.cuda.device(o.device):
        err = lib.decode_merge_parts(o.data_ptr(), lse.data_ptr(),
                                     out.data_ptr(), None, b, h, n, d,
                                     _tensors.stream(o.device))
    _build.check(lib, name, err)
    LAUNCHES[name] += 1
    return out


def check_slice(name, q, k, scores=None):
    """Shapes of a decode over a slice of the head dim -> (B, Hq, Hkv, W,
    D')."""
    if q.dim() != 3 or k.dim() != 4:
        raise ValueError(f"{name}: q must be 3-D and k 4-D, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}")
    b, hq, dp = q.shape
    bk, hkv, w, dk = k.shape
    if (bk, dk) != (b, dp) or hkv == 0 or hq % hkv or w == 0:
        raise ValueError(f"{name}: q {tuple(q.shape)} and the cache slice "
                         f"{tuple(k.shape)} disagree")
    if k.device != q.device:
        raise ValueError(f"{name}: q and the cache are on two devices")
    return b, hq, hkv, w, dp


def slice_launchable(name: str, dp: int, kv_dtype: torch.dtype) -> None:
    """Raise unless the slice kernels take ``dp`` elements of ``kv_dtype``:
    whole 16-byte loads, a multiple of 4, at most 256."""
    epc = 16 // torch.empty((), dtype=kv_dtype).element_size()
    if dp % epc or dp % 4 or dp > 256:
        raise ValueError(f"{name}: the CUDA kernel takes slices of whole "
                         f"16-byte loads, a multiple of 4 and at most 256 "
                         f"elements; got {dp} of {kv_dtype}")


def decode_scores(q: torch.Tensor, k: torch.Tensor, length, w0: int,
                  sm_scale: float) -> torch.Tensor:
    """q (B, Hq, D') and k (B, Hkv, W, D') the rank's slice of the head dim
    (k a window from position ``w0`` of the cache) -> the partial scores
    (B, Hq, W) f32 over the slice, times ``sm_scale``; 0 past the rows'
    lengths and in rows of ``length <= 0``."""
    name = "decode_scores"
    b, hq, hkv, w, dp = check_slice(name, q, k)
    if q.dtype not in _tensors.FLOAT_DTYPES or k.dtype != q.dtype:
        raise TypeError(f"{name}: q and k must share f32 or bf16, got "
                        f"{q.dtype}, {k.dtype}")
    w0 = check_window(name, w0)
    lengths = _tensors.row_lengths(name, length, b, q.device)
    if q.device.type == "cpu":
        return decode_scores_ref(q, k, lengths, w0, sm_scale)
    _tensors.check_no_grad(name, q, k)
    out = launch_scores(q, k, None, lengths, w0, sm_scale)
    LAUNCHES[name] += 1
    return out


def launch_scores(q, k, k_scale, lengths, w0: int, sm_scale: float):
    """``decode_scores_kernel`` on checked CUDA operands (an int8 ``k``
    with its ``k_scale``); not counted."""
    b, hq, dp = q.shape
    hkv, w = k.shape[1:3]
    slice_launchable("decode_scores", dp, k.dtype)
    q = _tensors.aligned(q.contiguous(), 4)
    k = _tensors.aligned(k, 16 // k.element_size())
    out = torch.empty((b, hq, w), dtype=torch.float32, device=q.device)
    if b * hq == 0:
        return out
    quant = k_scale is not None
    lib = _build.load()
    fn = getattr(lib, "decode_scores_" + ("int8_" if quant else "")
                 + ("f32" if q.dtype == torch.float32 else "bf16"))
    sc = k_scale if quant else k
    st = _tensors.strides((q, (0, 1)), (k, (0, 1, 2)), (sc, (0, 1, 2)))
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), _ptr(k_scale), out.data_ptr(),
                 lengths.data_ptr(), b, hq, hkv, w, dp, w0, sm_scale, st,
                 _tensors.stream(q.device))
    _build.check(lib, "decode_scores", err)
    return out


def decode_apply(scores: torch.Tensor, v: torch.Tensor, length,
                 w0: int = 0):
    """``scores`` (B, Hq, W) f32 summed over the slices (the window from
    position ``w0``), v (B, Hkv, W, D') the rank's slice -> (o (B, Hq, D')
    f32, lse (B, Hq) f32): the softmax over the row's positions and P.V
    over the slice."""
    name = "decode_apply"
    b, hq, w = check_apply(name, scores, v)
    if v.dtype not in _tensors.FLOAT_DTYPES:
        raise TypeError(f"{name}: v must be f32 or bf16, got {v.dtype}")
    w0 = check_window(name, w0)
    lengths = _tensors.row_lengths(name, length, b, v.device)
    if v.device.type == "cpu":
        return decode_apply_ref(scores, v, lengths, w0)
    _tensors.check_no_grad(name, scores, v)
    out = launch_apply(scores, v, None, lengths, w0)
    LAUNCHES[name] += 1
    return out


def check_apply(name, scores, v):
    if scores.dim() != 3 or v.dim() != 4:
        raise ValueError(f"{name}: scores must be 3-D and v 4-D, got "
                         f"{tuple(scores.shape)}, {tuple(v.shape)}")
    b, hq, w = scores.shape
    if (v.shape[0], v.shape[2]) != (b, w) or v.shape[1] == 0 or \
            hq % v.shape[1]:
        raise ValueError(f"{name}: scores {tuple(scores.shape)} and the "
                         f"cache slice {tuple(v.shape)} disagree")
    if scores.dtype != torch.float32:
        raise TypeError(f"{name}: scores must be float32, got "
                        f"{scores.dtype}")
    if scores.device != v.device:
        raise ValueError(f"{name}: scores and the cache are on two devices")
    return b, hq, w


def launch_apply(scores, v, v_scale, lengths, w0: int):
    """``decode_apply_kernel`` and the merge on checked CUDA operands (an
    int8 ``v`` with its ``v_scale``); not counted."""
    b, hq, w = scores.shape
    hkv, dp = v.shape[1], v.shape[3]
    slice_launchable("decode_apply", dp, v.dtype)
    scores = scores.contiguous()
    v = _tensors.aligned(v, 16 // v.element_size())
    out = torch.empty((b, hq, dp), dtype=torch.float32, device=v.device)
    lse = torch.empty((b, hq), dtype=torch.float32, device=v.device)
    if b * hq == 0:
        return out, lse
    ws = torch.empty((b, hq, -(-w // CHUNK), dp + 4), dtype=torch.float32,
                     device=v.device)
    quant = v_scale is not None
    lib = _build.load()
    fn = getattr(lib, "decode_apply_" + (
        "int8" if quant else "f32" if v.dtype == torch.float32 else "bf16"))
    sc = v_scale if quant else v
    st = _tensors.strides((out, (0, 1)), (v, (0, 1, 2)), (sc, (0, 1, 2)))
    with torch.cuda.device(v.device):
        err = fn(scores.data_ptr(), v.data_ptr(), _ptr(v_scale),
                 out.data_ptr(), lse.data_ptr(), lengths.data_ptr(),
                 ws.data_ptr(), b, hq, hkv, w, dp, w0, st,
                 _tensors.stream(v.device))
    _build.check(lib, "decode_apply", err)
    return out, lse


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
