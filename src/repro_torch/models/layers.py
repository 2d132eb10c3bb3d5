"""Model building blocks, in PyTorch: norms, RoPE and M-RoPE, GQA
attention through the port's flash kernels, cached decode over a float or
int8 KV cache, cross-attention over an encoder's K/V, SwiGLU/GeGLU MLPs,
capacity-based top-k MoE, and the Mamba-1 block with its selective scan
through the port's scan kernel.

Port of ``repro.models.layers``.  Functions keep the
reference's names and ``(cfg, p, x, ...) -> y`` form, with ``p`` a mapping
of tensors (an ``nn.ParameterDict`` of :class:`models.lm.LM`).  They round
to the compute dtype where the reference does: norms and RoPE compute in f32
and cast back, attention keeps f32 scores, softmax and accumulator and casts
its output to the input's dtype (``scores_dtype="bfloat16"``: the
reference's casts, on the plain path only, ``kernels.ops.attention``).

**Context parallelism** (``cfg.attn_shard == "seq"``) over the "model"
dimension of an ambient mesh (:func:`ambient_mesh`, as the reference's
``with mesh:``; without one, or with a "model" size of 1, every path is the
one-card path).  Where the reference states a layout with sharding
constraints and GSPMD moves the data, each rank's part is written out here
(:class:`SeqParallel`), with the collectives of ``distributed.comm``:

- ``seq_residual``: the residual is blocked over the mm model ranks (rank g
  holds rows ``[g S/mm, (g+1) S/mm)``); norms, projections, MLP and MoE are
  local; K and V are all-gathered, queries stay local; a Mamba mixer
  gathers the sequence, scans it whole and keeps its own rows;
- without it the residual is replicated: a rank computes its queries'
  attention and the outputs are all-gathered;
- ``causal_bound``: the striped assignment (rank g computes query rows g,
  g + mm, ..., moved there and back by an all-to-all under the blocked
  residual) through the flash kernel's ``q_stride``; else blocked rows.

The flash kernel's bottom-right causal alignment gives the reference's
``qpos >= kpos`` with the keys cut at the rank's last row.  Every
collective is differentiable (``distributed.comm``: each one's backward is
its adjoint), and so is the striped flash call (``FlashAttention`` with
``q_stride``), so a loss under CP has a backward: each rank's loss, the
same on every rank, scaled by 1 / (the mesh's ranks), and every
parameter's gradient summed over the mesh, give the reference's gradient
(``train.loop.step_body``).  Where the mesh's "data" dimension is above
1 the MoE aux loss takes its means over every data rank's groups as well,
as the reference's over the global batch (:func:`aux_groups`).  The
reference's ``_constrain``, ``_rope_hd_pin``, ``_attn_constraints``, ``constrain_residual`` and
``_constrain_moe_groups`` pin layouts only and have no counterpart;
``_chunked_attention`` only bounds memory, and the kernel computes the
whole causal attention in one call.

**The decode cache is updated in place.**  ``attention_decode`` writes the
new K/V (or int8 codes and scales) at position ``length`` of the cache
tensors it is given, where the reference blends a one-hot over the whole
cache and returns new arrays.  The two agree bit for bit: the blend computes
``c * 1 + 0 * k`` and ``c * 0 + 1 * k``, both exact.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
from typing import Any, List, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F
from torch._guards import active_fake_mode

from ..configs.base import ArchConfig, SSMSpec
from ..kernels import ops

Params = Mapping[str, torch.Tensor]


# ------------------------------------------------------------------- helpers
def _dtype(name: str) -> torch.dtype:
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


def dense_init(gen: torch.Generator, shape, in_axis: int = 0,
               dtype=torch.float32) -> torch.Tensor:
    fan_in = shape[in_axis]
    return (torch.randn(shape, generator=gen, device=gen.device)
            / math.sqrt(fan_in)).to(dtype)


# --------------------------------------------------------------------- norms
def rmsnorm(x, scale, eps: float = 1e-6):
    x32 = x.to(torch.float32)
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * scale.to(torch.float32)
            ).to(x.dtype)


def layernorm(x, scale, bias, eps: float = 1e-5):
    x32 = x.to(torch.float32)
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.var(x32, dim=-1, keepdim=True, correction=0)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * scale.to(torch.float32) + bias.to(torch.float32)
            ).to(x.dtype)


def apply_norm(cfg: ArchConfig, p: Params, x):
    if cfg.norm == "layernorm":
        return layernorm(x, p["scale"], p["bias"])
    return rmsnorm(x, p["scale"])


def init_norm(cfg: ArchConfig, d: int, device) -> dict:
    dt = _dtype(cfg.param_dtype)
    p = {"scale": torch.ones((d,), dtype=dt, device=device)}
    if cfg.norm == "layernorm":
        p["bias"] = torch.zeros((d,), dtype=dt, device=device)
    return p


# ---------------------------------------------------------------------- RoPE
def rope_freqs(hd: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                         device=device) / hd))


def apply_rope(x, pos, theta: float):
    """x (..., S, H, D) rotated by position ``pos`` (..., S)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                 # (D/2,)
    ang = pos[..., None].to(torch.float32) * freqs          # (..., S, D/2)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def _mrope_bands(sections, n: int):
    """How many of the ``n`` frequency bands each position stream drives,
    in order, as the reference's ``jnp.repeat(arange(3), sections,
    total_repeat_length=n)`` gives them: stream i starts at the sum of the
    sections before it (cut at ``n``) and runs to the next stream's start,
    the last one to ``n``."""
    starts = [0]
    for c in sections[:-1]:
        starts.append(starts[-1] + int(c))
    ends = [min(s, n) for s in starts[1:]] + [n]
    return [e - min(s, n) for s, e in zip(starts, ends)]


def apply_mrope(x, pos3, theta: float, sections):
    """Qwen2-VL M-RoPE: the rotary frequency bands split across the (t, h,
    w) position streams.  ``pos3`` is (3, ..., S); ``sections`` gives each
    stream's number of bands (:func:`_mrope_bands`).  The bands' positions
    are put together by slices, with no index tensor, so the step copies
    nothing from the host and can be captured."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                 # (D/2,)
    pos3 = pos3.to(torch.float32)
    pos = torch.cat([pos3[i][..., None].expand(*pos3.shape[1:], c)
                     for i, c in enumerate(_mrope_bands(sections, hd // 2))
                     if c], dim=-1)                         # (..., S, D/2)
    ang = pos * freqs
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def positional_rotate(cfg: ArchConfig, x, pos):
    """RoPE, or M-RoPE where ``cfg.mrope_sections`` is set.  pos: (B, S),
    or (3, B, S) for M-RoPE; a (B, S) position drives all three streams
    (text only: t = h = w)."""
    if cfg.mrope_sections is not None:
        if pos.dim() == 2:
            pos = pos[None].expand((3,) + tuple(pos.shape))
        return apply_mrope(x, pos, cfg.rope_theta, cfg.mrope_sections)
    return apply_rope(x, pos, cfg.rope_theta)


# ------------------------------------------------------ context parallelism
_MESH = None                  # the ambient mesh (ambient_mesh)


@contextlib.contextmanager
def ambient_mesh(mesh):
    """Within, the model reads ``mesh`` (a ``DeviceMesh`` with named
    dimensions) as the reference reads the mesh of ``with mesh:``: its
    "model" dimension carries context parallelism."""
    global _MESH
    prev, _MESH = _MESH, mesh
    try:
        yield mesh
    finally:
        _MESH = prev


def _ambient_mesh():
    """The ambient mesh, or None."""
    return _MESH


def _mesh_axis(name: str) -> int:
    """The ambient mesh's size along ``name``; 1 without a mesh or such a
    dimension."""
    mesh = _ambient_mesh()
    names = tuple(getattr(mesh, "mesh_dim_names", None) or ())
    if name not in names:
        return 1
    return int(mesh.shape[names.index(name)])


@dataclasses.dataclass(frozen=True)
class SeqParallel:
    """Context parallelism of a sequence of ``s`` over ``mm`` model ranks;
    this is rank ``rank`` of ``group``.  ``residual``: the residual is
    blocked (``cfg.seq_residual``); ``striped``: attention takes the
    striped rows (``cfg.causal_bound``)."""

    mm: int
    rank: int
    group: Any
    s: int
    residual: bool
    striped: bool

    @property
    def sl(self) -> int:
        """Rows a rank holds."""
        return self.s // self.mm

    def block(self, x, dim: int = 1):
        """This rank's block of rows ``[rank sl, (rank + 1) sl)``."""
        return x.narrow(dim, self.rank * self.sl, self.sl)

    def gather(self, x, dim: int = 1):
        """Every rank's block along ``dim``, in rank order."""
        from ..distributed import comm
        return comm.all_gather(x, self.group, dim)

    def rows(self, device=None) -> torch.Tensor:
        """The global rows whose queries this rank computes: its block, or
        its stripe ``rank, rank + mm, ...``."""
        if self.striped:
            return torch.arange(self.rank, self.s, self.mm, device=device)
        return torch.arange(self.rank * self.sl, (self.rank + 1) * self.sl,
                            device=device)

    def n_keys(self) -> int:
        """Keys the rank's last query row sees: up to its position."""
        if self.striped:
            return self.rank + (self.sl - 1) * self.mm + 1
        return (self.rank + 1) * self.sl

    def _stripe_plan(self, device) -> Tuple[torch.Tensor, List[int],
                                            List[int]]:
        """The all-to-all from blocked rows to stripes: this block's rows
        ordered by the rank whose stripe each is (:func:`_stripe_order`),
        the rows sent to each rank, the rows received from each."""
        mm, sl = self.mm, self.sl
        send = [_stripe_count(self.rank * sl, sl, mm, r) for r in range(mm)]
        recv = [_stripe_count(r * sl, sl, mm, self.rank) for r in range(mm)]
        return _stripe_order(mm, sl, self.rank, device,
                             active_fake_mode()), send, recv

    def to_stripes(self, x):
        """(B, sl, ...) blocked rows -> (B, sl, ...) this rank's stripe, in
        ascending position, by one all-to-all."""
        from ..distributed import comm
        order, send, recv = self._stripe_plan(x.device)
        rows = x.transpose(0, 1)[order]
        got = comm.all_to_all(rows, send, recv, self.group)
        return got.transpose(0, 1)

    def from_stripes(self, x):
        """The inverse of :meth:`to_stripes`."""
        from ..distributed import comm
        order, send, recv = self._stripe_plan(x.device)
        got = comm.all_to_all(x.transpose(0, 1).contiguous(), recv, send,
                              self.group)
        out = torch.empty_like(got)
        out[order] = got
        return out.transpose(0, 1)


def _stripe_count(start: int, sl: int, mm: int, r: int) -> int:
    """Rows j in [0, sl) with (start + j) % mm == r."""
    first = (r - start) % mm
    return 0 if first >= sl else (sl - 1 - first) // mm + 1


@functools.lru_cache(maxsize=64)
def _stripe_order(mm: int, sl: int, rank: int, device,
                  fake_mode=None) -> torch.Tensor:
    """Rank ``rank``'s block rows grouped by destination stripe, in
    ascending order within each: made once a shape and device (no sort, no
    copy from the host at each call), and once a fake-tensor mode
    (``fake_mode``, a key only: a trace's tensor is of its own mode)."""
    start = rank * sl
    order = [j for r in range(mm) for j in range((r - start) % mm, sl, mm)]
    return torch.tensor(order, dtype=torch.int64, device=device)


def seq_parallel(cfg: ArchConfig, s: int) -> Optional[SeqParallel]:
    """Context parallelism for a sequence of ``s`` under the ambient mesh, as
    the reference decides it: ``attn_shard == "seq"``, a "model" size mm
    above 1 that divides S, S > 1; else None (the one-card path)."""
    mm = _mesh_axis("model")
    if cfg.attn_shard != "seq" or mm <= 1 or s % mm or s <= 1:
        return None
    mesh = _ambient_mesh()
    return SeqParallel(mm=mm, rank=mesh.get_local_rank("model"),
                       group=mesh.get_group("model"), s=s,
                       residual=cfg.seq_residual, striped=cfg.causal_bound)


def aux_groups(cp: Optional[SeqParallel]) -> Tuple:
    """The groups over which a MoE layer's aux-loss means are all-reduced,
    beyond its own dispatch groups, so that they are the reference's means
    over every group of the global batch: the model group under a blocked
    residual (each model rank holds its sequence block's groups), and the
    "data" group where it is above 1 (a train step splits the batch over
    it, ``train.loop``; where every data rank holds the whole batch, the
    mean of equal values is the value and the gradients are unchanged),
    and so the "pod" group where it is above 1 (the train step splits the
    batch over pod x data; a pipeline's stages run under their pod's
    sub-mesh, ``launch.pipeline_prefill``)."""
    groups = []
    if cp is not None and cp.residual:
        groups.append(cp.group)
    for axis in ("data", "pod"):
        if _mesh_axis(axis) > 1:
            groups.append(_ambient_mesh().get_group(axis))
    return tuple(groups)


# ------------------------------------------------------- tensor parallelism
def _spec(t) -> Tuple:
    """The spec of the rank's part a parameter holds (``placement``, set
    by ``models.build_model`` under a mesh); () for a whole tensor."""
    place = getattr(t, "placement", None)
    return place.spec if place is not None else ()


def _split_over(t, axis: str, dim: int) -> bool:
    """Whether ``t``'s dimension ``dim`` is split over mesh ``axis``."""
    spec = _spec(t)
    if dim < 0:
        dim += t.dim()
    entry = spec[dim] if dim < len(spec) else None
    return entry is not None and axis in (
        entry if isinstance(entry, tuple) else (entry,))


def _mesh_or_raise():
    mesh = _ambient_mesh()
    if mesh is None:
        raise RuntimeError("a model built under a mesh runs under it "
                           "(layers.ambient_mesh)")
    return mesh


def _model_group(t, dim: int):
    """The "model" group where ``t``'s dimension ``dim`` is split over it
    (tensor parallelism), else None."""
    if not _split_over(t, "model", dim):
        return None
    return _mesh_or_raise().get_group("model")


def use(t):
    """A parameter as a layer reads it: where FSDP splits a dimension over
    "data", all-gathered over it first (differentiable: the gradient comes
    back by the reduce-scatter, summed over the data ranks)."""
    spec = _spec(t)
    for d, entry in enumerate(spec):
        axes = entry if isinstance(entry, tuple) else (entry,)
        if "data" in axes:
            from ..distributed import comm
            t = comm.all_gather(t, _mesh_or_raise().get_group("data"), d)
    return t


def whole_over_model(t, dim: int):
    """``t`` (as :func:`use` gives it) all-gathered over "model" along
    ``dim`` where it is split there (a head split mid-head), else ``t``."""
    group = _model_group(t, dim)
    if group is None:
        return t
    from ..distributed import comm
    return comm.all_gather(use(t), group, dim)


def reduce_model(y, group):
    """``y`` summed over ``group`` (a row-parallel product's partial sums;
    differentiable), or ``y`` where ``group`` is None."""
    if group is None:
        return y
    from ..distributed import comm
    return comm.all_reduce(y, group)


def _model_place() -> Tuple[int, int]:
    mesh = _mesh_or_raise()
    return _mesh_axis("model"), int(mesh.get_local_rank("model"))


@dataclasses.dataclass
class _Heads:
    """How a rank runs attention on its shards (:func:`_head_plan`): the
    projections it multiplies by, its ``hq`` query heads, the kv heads it
    keeps of its K/V (``kv``: a [lo, hi) range, None for all), the columns
    of o that its ``wo`` rows take (``o_cols``, None for all) and the group
    the output is summed over (None: the output is whole).  ``gather``:
    per projection (q, k, v), the group its product is all-gathered over
    along the columns (the rank holds a column block of the weight and
    every head is wanted), or None."""

    wq: Any
    wk: Any
    wv: Any
    wo: Any
    bias: Optional[Tuple[Any, Any, Any]]
    hq: int
    kv: Optional[Tuple[int, int]]
    o_cols: Optional[Tuple[int, int]]
    group: Any
    gather: Tuple[Any, Any, Any] = (None, None, None)


def _head_plan(cfg: ArchConfig, p: Params, every_head: bool = False,
               gather_products: bool = False) -> _Heads:
    """Tensor parallelism of an attention layer: its query heads local
    (Hq/mm a rank) where the model ranks split the heads and each rank's
    query heads share their kv heads whole (Hkv divides over them, or one
    kv head serves all of a rank's); else, or with ``every_head`` (a
    serving cache that does not split its KV heads over "model",
    :func:`cache_every_head`), every head computed on every rank from the
    whole projections (gathered over "model" where the spec splits them
    mid-head, as the reference pins such heads replicated).  ``wo`` is
    row-parallel wherever the spec splits it, the output then summed over
    "model".  Unsplit parameters: the one-card plan.  With
    ``gather_products`` (a decode step: one token a row) every head is
    made from the rank's column blocks of the projections, their products
    all-gathered over "model", instead of the weights."""
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    bias = ("bq", "bk", "bv") if "bq" in p else None
    group = _model_group(p["wo"], 0)
    if group is None and not any(_split_over(p[n], "model", -1)
                                 for n in ("wq", "wk", "wv")):
        return _Heads(use(p["wq"]), use(p["wk"]), use(p["wv"]),
                      use(p["wo"]),
                      tuple(p[n] for n in bias) if bias else None, hq,
                      None, None, None)
    mm, r = _model_place()
    hq_l, g = hq // mm, hq // hkv
    gather = (None, None, None)
    local = (not every_head and _split_over(p["wq"], "model", 1)
             and hq % mm == 0 and (hkv % mm == 0 or g % hq_l == 0))
    if local:
        wq, bq = use(p["wq"]), p["bq"] if bias else None
        if hkv % mm == 0 and _split_over(p["wk"], "model", 1):
            kv = None
            wk, wv = use(p["wk"]), use(p["wv"])
            bk, bv = (p["bk"], p["bv"]) if bias else (None, None)
        else:
            kv = (r * hq_l // g, ((r + 1) * hq_l - 1) // g + 1)
            wk, wv = (whole_over_model(p[n], 1) for n in ("wk", "wv"))
            bk, bv = (whole_over_model(p[n], 0) for n in ("bk", "bv")) \
                if bias else (None, None)
        o_cols = None
    else:
        hq_l, kv = hq, None
        names = ("wq", "wk", "wv")
        if gather_products:
            wq, wk, wv = (use(p[n]) for n in names)
            gather = tuple(_model_group(p[n], 1) for n in names)
        else:
            wq, wk, wv = (whole_over_model(p[n], 1) for n in names)
        bq, bk, bv = (whole_over_model(p[n], 0) for n in bias) if bias \
            else (None, None, None)
        n = hq * hd // mm
        o_cols = (r * n, (r + 1) * n) if group is not None else None
    return _Heads(wq, wk, wv, use(p["wo"]), (bq, bk, bv) if bias else None,
                  hq_l, kv, o_cols, group, gather)


def cache_every_head(cfg: ArchConfig) -> bool:
    """Whether a serving cache under the ambient mesh keeps every KV head
    on every rank of a "model" dimension above 1
    (``sharding.rules.cache_specs``: "model" does not divide the heads, and
    the rank holds a slice of the head dim or the whole head)."""
    mm = _mesh_axis("model")
    return mm > 1 and cfg.n_kv_heads % mm != 0


@dataclasses.dataclass(frozen=True)
class CachePart:
    """What a rank holds of a serving cache under the ambient mesh
    (``models.lm.serve_part``: ``sharding.rules.cache_placements``, the
    axes of size 1 dropped).

    ``places``: the cache's tree of placements; ``shapes``: the tree of the
    rank's leaf shapes.  ``rows``: (first row, rows) of the batch where the
    batch axes split it (``row_entry``: the spec entry), else None.
    ``window``: (first position, positions) of an attention cache split
    over "data" (the batch did not split), else None.  ``heads``: (first,
    end) of the KV heads where "model" splits them, else None: every rank
    then computes every head (:func:`_head_plan`'s ``every_head``).
    ``dims``: (first, end) of the head dim where "model" splits it, else
    None."""

    places: Any
    shapes: Any
    row_entry: Any
    rows: Optional[Tuple[int, int]]
    window: Optional[Tuple[int, int]]
    heads: Optional[Tuple[int, int]]
    dims: Optional[Tuple[int, int]]

    def my_rows(self, t, dim: int = 0):
        """This rank's rows of a whole batch ``t`` along ``dim``."""
        if self.rows is None:
            return t
        return t.narrow(dim, self.rows[0], self.rows[1])

    def all_rows(self, t, dim: int = 0):
        """Every rank's rows of ``t`` along ``dim``, in batch order (a
        collective over the batch axes)."""
        if self.rows is None:
            return t
        from ..sharding.rules import Placement, unshard
        spec = (None,) * dim + (self.row_entry,)
        return unshard(t, Placement(spec), _mesh_or_raise())


# ----------------------------------------------------------------- attention
def init_attention(cfg: ArchConfig, gen: torch.Generator,
                   cross: bool = False) -> dict:
    d, hd = cfg.d_model, cfg.hd
    hq, hkv = cfg.n_heads, cfg.n_kv_heads
    dt = _dtype(cfg.param_dtype)
    dev = gen.device
    p = {
        "wq": dense_init(gen, (d, hq * hd), 0, dt),
        "wk": dense_init(gen, (d, hkv * hd), 0, dt),
        "wv": dense_init(gen, (d, hkv * hd), 0, dt),
        "wo": dense_init(gen, (hq * hd, d), 0, dt),
    }
    if cfg.qkv_bias and not cross:                      # as the reference
        p["bq"] = torch.zeros((hq * hd,), dtype=dt, device=dev)
        p["bk"] = torch.zeros((hkv * hd,), dtype=dt, device=dev)
        p["bv"] = torch.zeros((hkv * hd,), dtype=dt, device=dev)
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((hd,), dtype=dt, device=dev)
        p["k_norm"] = torch.ones((hd,), dtype=dt, device=dev)
    return p


def _project_qkv(cfg: ArchConfig, p: Params, xq, xkv, plan: _Heads):
    """q (B, Sq, H, D), k and v (B, Skv, Hkv, D): the heads of ``plan``
    (:func:`_head_plan`: all of them on unsplit parameters)."""
    b, sq, _ = xq.shape
    skv = xkv.shape[1]
    hd = cfg.hd
    q, k, v = (_gathered(t, g) for t, g in zip(
        (xq @ plan.wq, xkv @ plan.wk, xkv @ plan.wv), plan.gather))
    if plan.bias is not None:
        q, k, v = q + plan.bias[0], k + plan.bias[1], v + plan.bias[2]
    q = q.reshape(b, sq, plan.hq, hd)
    k = k.reshape(b, skv, -1, hd)
    v = v.reshape(b, skv, -1, hd)
    if plan.kv is not None:
        k = k[:, :, plan.kv[0]:plan.kv[1]]
        v = v[:, :, plan.kv[0]:plan.kv[1]]
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"])
        k = rmsnorm(k, p["k_norm"])
    return q, k, v


def _gathered(t, group):
    """A column-parallel product all-gathered over ``group`` along its
    columns (:attr:`_Heads.gather`), or ``t``."""
    if group is None:
        return t
    from ..distributed import comm
    return comm.all_gather(t, group, -1)


def _scores_kw(cfg: ArchConfig) -> dict:
    """``ops.attention``'s ``scores_dtype`` where the config moves it off
    f32 (the plain path's knob), else nothing."""
    if cfg.scores_dtype == "float32":
        return {}
    return {"scores_dtype": cfg.scores_dtype}


def attention(cfg: ArchConfig, p: Params, x, pos, causal: bool = True,
              kv_out: bool = False, use_kernel: bool = True,
              cp: Optional[SeqParallel] = None):
    """Causal GQA self-attention over the whole sequence, one
    ``ops.attention`` call (the flash kernel on the card).

    The causal mask is that of query i over keys 0..i: ``pos`` is the
    prefill's ``arange(S)`` for every row, as in the reference's callers.
    With ``cp`` (causal only) the rank computes its queries' rows
    (:func:`_seq_parallel_attention`).  On a rank's shards (a model built
    under a mesh) the rank computes its heads (:func:`_head_plan`) and the
    output is summed over "model"; with ``kv_out`` (a prefill's cache)
    and a cache that keeps every KV head on every model rank
    (:func:`cache_every_head`), every head (``_head_plan``'s
    ``every_head``), so that the K/V returned are whole.
    """
    if cp is not None and causal:
        return _seq_parallel_attention(cfg, p, x, pos, kv_out, use_kernel,
                                       cp)
    b, s, _ = x.shape
    # a prefill's K/V for a cache that keeps every KV head on every model
    # rank: every head on every rank
    plan = _head_plan(cfg, p, every_head=kv_out and cache_every_head(cfg))
    q, k, v = _project_qkv(cfg, p, x, x, plan)
    q = positional_rotate(cfg, q, pos)
    k = positional_rotate(cfg, k, pos)
    # (B, S, H, D) tensors seen as (B, H, S, D): the kernel reads strides
    o = ops.attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                      causal=causal, use_kernel=use_kernel,
                      **_scores_kw(cfg))
    o = o.transpose(1, 2).reshape(b, s, plan.hq * cfg.hd)
    if plan.o_cols is not None:
        o = o[..., plan.o_cols[0]:plan.o_cols[1]]
    y = reduce_model(o @ plan.wo, plan.group)
    if kv_out:
        return y, (k, v)
    return y


def _seq_parallel_attention(cfg: ArchConfig, p: Params, x, pos, kv_out,
                            use_kernel, cp: SeqParallel):
    """Context-parallel attention, this rank's part.  With ``cp.residual``,
    x (B, S/mm, d) is the rank's block and ``pos`` its positions: K and V
    are all-gathered, the queries stay local (moved to the rank's stripe and
    back when striped) and y is the block's.  Without it, x (B, S, d) is
    replicated: the rank computes its rows' queries over the whole K and V
    and the outputs are all-gathered into y (B, S, d).  Either way a row
    sees the keys up to its position, from one flash call over the keys up
    to the rank's last row (``q_stride`` mm for stripes).  The K/V returned
    for the cache are the whole sequence's."""
    b = x.shape[0]
    hq, hd = cfg.n_heads, cfg.hd
    if cp.residual:
        q, k, v = _project_qkv(cfg, p, x, x, _head_plan(cfg, p))
        q = positional_rotate(cfg, q, pos)
        k = positional_rotate(cfg, k, pos)
        k, v = cp.gather(torch.stack([k, v]), dim=2)   # (B, S, Hkv, D)
        if cp.striped:
            q = cp.to_stripes(q)
    else:
        rows = cp.rows(x.device)
        q, k, v = _project_qkv(cfg, p, x.index_select(1, rows), x,
                               _head_plan(cfg, p))
        q = positional_rotate(cfg, q, pos.index_select(-1, rows))
        k = positional_rotate(cfg, k, pos)
    n = cp.n_keys()
    o = ops.attention(q.transpose(1, 2), k[:, :n].transpose(1, 2),
                      v[:, :n].transpose(1, 2), causal=True,
                      use_kernel=use_kernel,
                      q_stride=cp.mm if cp.striped else 1,
                      **_scores_kw(cfg)).transpose(1, 2)
    if cp.residual and cp.striped:
        o = cp.from_stripes(o)
    y = o.reshape(b, cp.sl, hq * hd) @ p["wo"]
    if not cp.residual:
        y = cp.gather(y)                               # rank-major rows
        if cp.striped:                                 # to positions
            y = y.reshape(b, cp.mm, cp.sl, -1).transpose(1, 2).reshape(
                b, cp.s, -1)
    if kv_out:
        return y, (k, v)
    return y


def cross_kv(cfg: ArchConfig, p: Params, enc_out):
    """The encoder's K/V of a cross-attention block: enc_out (B, S_enc, d)
    -> (k, v), each (B, S_enc, Hkv, D), no RoPE."""
    b, se, _ = enc_out.shape
    hkv, hd = cfg.n_kv_heads, cfg.hd
    k = (enc_out @ p["wk"]).reshape(b, se, hkv, hd)
    v = (enc_out @ p["wv"]).reshape(b, se, hkv, hd)
    if cfg.qk_norm:
        k = rmsnorm(k, p["k_norm"])
    return k, v


def cross_attention(cfg: ArchConfig, p: Params, x, kv,
                    use_kernel: bool = True):
    """Decoder cross-attention over the encoder's K/V ``kv`` (each (B,
    S_enc, Hkv, D)), every position seen, no RoPE, scale 1/sqrt(D).  x (B,
    Sq, d) -> (B, Sq, d).  Sq > 1 (prefill) is one non-causal
    ``ops.attention`` call (flash attention with Sk = S_enc); Sq = 1 (a
    decode step) is one ``ops.decode_attention`` call with every row's
    length S_enc (the split-KV decode)."""
    b, s, _ = x.shape
    hq, hd = cfg.n_heads, cfg.hd
    q = (x @ p["wq"]).reshape(b, s, hq, hd)
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"])
    k, v = kv
    if s == 1:
        # the lengths made on the device (a fill), not copied from the host
        length = torch.full((b,), k.shape[1], dtype=torch.int32,
                            device=x.device)
        o = ops.decode_attention(q.reshape(b, hq, hd), k.transpose(1, 2),
                                 v.transpose(1, 2), length,
                                 use_kernel=use_kernel)
    else:
        o = ops.attention(q.transpose(1, 2), k.transpose(1, 2),
                          v.transpose(1, 2), causal=False,
                          use_kernel=use_kernel).transpose(1, 2)
    return o.reshape(b, s, hq * hd).to(x.dtype) @ p["wo"]


# ------------------------------------------------------ int8 KV quantization
def kv_quantize(x):
    """(..., Hkv, D) -> (int8 same shape, f32 scale (..., Hkv, 1)).

    Symmetric per-(position, head) scaling, as the reference's."""
    x32 = x.to(torch.float32)
    absmax = torch.amax(torch.abs(x32), dim=-1, keepdim=True)
    scale = torch.where(absmax > 0, absmax / 127.0,
                        torch.ones_like(absmax))
    q = torch.clamp(torch.round(x32 / scale), -127, 127)
    return q.to(torch.int8), scale


def kv_dequantize(q, scale, dtype):
    return (q.to(torch.float32) * scale).to(dtype)


def _write_at(cache, new, length):
    """``cache[b, length[b]] = new[b]`` in place, for each row b whose
    ``length[b]`` is inside the cache; a row at or past the end (or, for a
    rank's window of the positions, before its start) keeps its cache, as
    the reference's one-hot blend drops such a write."""
    b, s = cache.shape[:2]
    rows = torch.arange(b, device=cache.device)
    at = length.clamp(0, s - 1).to(torch.int64)
    inside = ((length >= 0) & (length < s)).reshape(
        b, *([1] * (new.dim() - 1)))
    cache[rows, at] = torch.where(inside, new.to(cache.dtype),
                                  cache[rows, at])


def attention_decode(cfg: ArchConfig, p: Params, x, cache_k, cache_v,
                     length, k_scale=None, v_scale=None,
                     use_kernel: bool = True,
                     part: Optional[CachePart] = None):
    """One-token decode: x (B, 1, d); cache (B, S, Hkv, D); length (B,).

    Writes the new K/V at ``length`` **in place** (the int8 codes and
    scales when ``cfg.kv_dtype == "int8"``) and attends over positions
    ``< length + 1``.  Returns y (B, 1, d).

    Under a mesh (``part``: the rank's part of the cache, rows B/dd where
    the batch axes split the batch) one of three layouts, as
    ``sharding.rules.cache_specs`` lays the cache out:

    - the KV heads over "model": the rank's heads (``_head_plan``), the
      decode kernels at its shapes, ``wo`` row-parallel;
    - the head dim over "model" (D/mm a rank): every head on every rank;
      the rank's partial scores over its slice (``decode_scores``) summed
      over "model", the softmax and P.V over its slice of V
      (``decode_apply``); o all-gathered over "model" along the head dim
      before ``wo``'s rows take their columns;
    - the positions over "data" (the batch did not split): the new token is
      written by the data rank whose window holds ``length``; each rank
      attends its window (the split-KV kernels' partial mode, or
      ``decode_apply`` after the summed scores) and the (o, lse) pairs are
      all-gathered over "data" and merged (``decode_merge``).
    """
    b = x.shape[0]
    hd = cfg.hd
    every = part is not None and part.heads is None
    plan = _head_plan(cfg, p, every_head=every, gather_products=every)
    q, k, v = _project_qkv(cfg, p, x, x, plan)          # (B,1,H,D)
    pos = length[:, None]                               # (B,1)
    q = positional_rotate(cfg, q, pos)
    k = positional_rotate(cfg, k, pos)
    kl = length + 1
    w0 = part.window[0] if part is not None and part.window else 0
    at = length - w0 if w0 else length
    d0, d1 = part.dims if part is not None and part.dims else (0, hd)
    quant = cfg.kv_dtype == "int8"
    if quant:
        # the codes of the whole head's scale, then the rank's slice
        k8, ks = kv_quantize(k)
        v8, vs = kv_quantize(v)
        _write_at(cache_k, k8[:, 0, :, d0:d1], at)
        _write_at(cache_v, v8[:, 0, :, d0:d1], at)
        _write_at(k_scale, ks[:, 0], at)
        _write_at(v_scale, vs[:, 0], at)
        scales = dict(k_scale=k_scale.transpose(1, 2),
                      v_scale=v_scale.transpose(1, 2))
    else:
        _write_at(cache_k, k[:, 0, :, d0:d1], at)
        _write_at(cache_v, v[:, 0, :, d0:d1], at)
        scales = {}
    qh = q.reshape(b, plan.hq, hd)
    kc, vc = cache_k.transpose(1, 2), cache_v.transpose(1, 2)
    if part is None or (part.window is None and part.dims is None):
        if quant:
            o = ops.decode_attention_int8(qh, kc, scales["k_scale"], vc,
                                          scales["v_scale"], kl,
                                          use_kernel=use_kernel)
        else:
            o = ops.decode_attention(qh, kc, vc, kl, use_kernel=use_kernel)
    elif part.dims is not None:
        sc = ops.decode_attention_scores(
            qh[..., d0:d1], kc, kl, w0, 1.0 / (hd ** 0.5),
            use_kernel=use_kernel, k_scale=scales.get("k_scale"))
        o, lse = ops.decode_attention_apply(_whole_scores(sc), vc, kl, w0,
                                            use_kernel=use_kernel,
                                            v_scale=scales.get("v_scale"))
        if part.window is not None:
            o = _merge_windows(o, lse, use_kernel)
        o = _whole_heads(o)                             # (B, Hq, D)
    else:
        o, lse = ops.decode_attention_partial(qh, kc, vc, kl, w0,
                                              use_kernel=use_kernel,
                                              **scales)
        o = _merge_windows(o, lse, use_kernel)
    o = o.reshape(b, 1, plan.hq * hd).to(x.dtype)
    if plan.o_cols is not None:
        o = o[..., plan.o_cols[0]:plan.o_cols[1]]
    return reduce_model(o @ plan.wo, plan.group)


def _whole_scores(sc):
    """The partial scores over each model rank's slice of the head dim,
    summed over "model": the whole heads' scores (f32)."""
    return reduce_model(sc, _mesh_or_raise().get_group("model"))


def _whole_heads(o):
    """o over each model rank's slice of the head dim (B, Hq, D/mm), all
    gathered over "model" along it: (B, Hq, D), whose columns the rank's
    rows of ``wo`` then take."""
    from ..distributed import comm
    return comm.all_gather(o, _mesh_or_raise().get_group("model"), -1)


def _merge_windows(o, lse, use_kernel: bool):
    """Every data rank's partial (o, lse) over its window of the positions,
    all-gathered over "data" and merged (``ops.decode_attention_merge``)."""
    from ..distributed import comm
    group = _mesh_or_raise().get_group("data")
    return ops.decode_attention_merge(comm.all_gather(o[None], group, 0),
                                      comm.all_gather(lse[None], group, 0),
                                      use_kernel=use_kernel)


# ---------------------------------------------------------------------- MLPs
def init_mlp(cfg: ArchConfig, gen: torch.Generator,
             d_ff: Optional[int] = None) -> dict:
    d, ff = cfg.d_model, d_ff or cfg.d_ff
    dt = _dtype(cfg.param_dtype)
    return {"gate": dense_init(gen, (d, ff), 0, dt),
            "up": dense_init(gen, (d, ff), 0, dt),
            "down": dense_init(gen, (ff, d), 0, dt)}


def _act(name: str):
    # jax.nn.gelu's default is the tanh approximation
    if name == "gelu":
        return lambda t: F.gelu(t, approximate="tanh")
    return F.silu


def mlp(cfg: ArchConfig, p: Params, x):
    """SwiGLU (silu) or GeGLU (gelu) gated MLP; on a rank's shards
    ``gate``/``up`` column-parallel, ``down`` row-parallel and the output
    summed over "model"."""
    return reduce_model(*_mlp_part(cfg, p, x))


def _mlp_part(cfg: ArchConfig, p: Params, x):
    """(the MLP's output, or the rank's part of it, the group to sum the
    parts over or None)."""
    a = _act(cfg.mlp_act)
    y = (a(x @ use(p["gate"])) * (x @ use(p["up"]))) @ use(p["down"])
    return y, _model_group(p["down"], 0)


# ----------------------------------------------------------------------- MoE
def init_moe(cfg: ArchConfig, gen: torch.Generator) -> dict:
    m = cfg.moe
    d, dt = cfg.d_model, _dtype(cfg.param_dtype)
    p = {
        "router": dense_init(gen, (d, m.n_experts), 0, torch.float32),
        "w_gate": dense_init(gen, (m.n_experts, d, m.d_ff), 1, dt),
        "w_up": dense_init(gen, (m.n_experts, d, m.d_ff), 1, dt),
        "w_down": dense_init(gen, (m.n_experts, m.d_ff, d), 1, dt),
    }
    if m.n_shared:
        p["shared"] = init_mlp(cfg, gen, m.shared_d_ff)
        p["shared_gate"] = dense_init(gen, (d, 1), 0, torch.float32)
    return p


def moe_capacity(cfg: ArchConfig, t: int) -> int:
    """Tokens each expert takes per dispatch group of ``t`` tokens."""
    m = cfg.moe
    k = m.top_k
    return max(1, min(t * k, int(math.ceil(t * k / m.n_experts
                                           * m.capacity_factor))))


def moe(cfg: ArchConfig, p: Params, x, *, capacity: Optional[int] = None,
        aux_groups=()):
    """Capacity-based top-k MoE with scatter dispatch / gather combine.

    ``x`` is (G, T, d): G dispatch groups (capacity is budgeted per group),
    T tokens per group.  Returns (y (G, T, d), the load-balancing aux loss).
    With ``aux_groups`` (:func:`aux_groups`: every rank of each holds as
    many dispatch groups) the aux loss is that of every rank's groups
    together: the router-probability and dispatch means all-reduced over
    each group in turn (differentiable: the all-reduce's backward is one).
    Each (token, k) slot keeps its place in its expert's queue up to the
    capacity; the rest go to a sentinel row and add nothing.  The dispatch
    scatter (``index_add_``) adds one non-zero row to each buffer row it
    fills, so its result does not depend on the order of the adds.  Ties
    among the router's probabilities may be broken otherwise than by
    ``jax.lax.top_k``; with float logits they do not occur.

    On a rank's shards (a model built under a mesh): where the model ranks
    split the experts (expert parallelism), every rank routes every token
    alike (the router and the tokens are replicated) and fills and
    computes only its experts' slots; else each expert's ``d_ff`` is split;
    either way the output is summed over "model".  The aux loss is every
    rank's.

    Differentiable, and bit-stable from run to run on the card: the k
    copies of a token are an expanded copy, whose backward sums the k
    copies by a reduction (no atomics);
    the dispatch's backward gathers (``index_select``); the combine's
    backward (``index_put_`` with accumulate) adds one row into each filled
    slot, and into the sentinel only rows the mask has zeroed.  The aux
    loss's gradient flows through ``probs``, not the one-hot, as in the
    reference.
    """
    m = cfg.moe
    g_, t, d = x.shape
    e, k = m.n_experts, m.top_k
    c = moe_capacity(cfg, t) if capacity is None else capacity

    logits = x.to(torch.float32) @ use(p["router"])     # (G, T, E)
    probs = torch.softmax(logits, dim=-1)
    w, idx = torch.topk(probs, k, dim=-1)               # (G, T, K)
    w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)

    # position of each (token, k) slot within its expert queue, per group
    onehot = F.one_hot(idx, e)                          # (G, T, K, E) int64
    oh_flat = onehot.reshape(g_, t * k, e)
    pos = torch.cumsum(oh_flat, dim=1) - oh_flat        # (G, T*K, E)
    pos_tk = torch.sum(pos * oh_flat, dim=-1)           # (G, T*K)
    e_tk = idx.reshape(g_, t * k)
    keep = pos_tk < c
    # expert parallelism: this rank's experts [e0, e0 + el) only
    group = _model_group(p["w_gate"], 0)
    el, e0 = e, 0
    if group is not None:
        mm, r = _model_place()
        el, e0 = e // mm, r * (e // mm)
        keep = keep & (e_tk >= e0) & (e_tk < e0 + el)
    else:
        group = _model_group(p["w_down"], 1)            # d_ff split
    slot = torch.where(keep, (e_tk - e0) * c + pos_tk,
                       torch.full_like(e_tk, el * c))   # sentinel row

    # each token's k copies, (G, T*K, d): an expanded copy, whose backward
    # sums the k copies by a reduction, no atomics (repeat_interleave's
    # would index_add_ them with float atomics on the card, in an order
    # that changes run to run)
    x_rep = x[:, :, None].expand(g_, t, k, d).reshape(g_, t * k, d)
    rows = el * c + 1
    base = torch.arange(g_, device=x.device)[:, None] * rows
    buf = torch.zeros((g_ * rows, d), dtype=x.dtype, device=x.device)
    buf.index_add_(0, (slot + base).reshape(-1),
                   (x_rep * keep[..., None].to(x.dtype)).reshape(-1, d))
    xe = buf.reshape(g_, rows, d)[:, :el * c].reshape(g_, el, c, d)

    a = _act(cfg.mlp_act)
    h = a(torch.einsum("gecd,edf->gecf", xe, use(p["w_gate"]))) * \
        torch.einsum("gecd,edf->gecf", xe, use(p["w_up"]))
    ye = torch.einsum("gecf,efd->gecd", h, use(p["w_down"]))  # (G, E, C, d)

    flat = torch.cat([ye.reshape(g_, el * c, d),
                      torch.zeros((g_, 1, d), dtype=ye.dtype,
                                  device=ye.device)], dim=1)
    y_tk = flat[torch.arange(g_, device=x.device)[:, None], slot]
    y_tk = y_tk * (w.reshape(g_, t * k, 1) * keep[..., None]).to(y_tk.dtype)
    y = y_tk.reshape(g_, t, k, d).sum(dim=2)

    if m.n_shared:
        gate = torch.sigmoid(x.to(torch.float32) @ use(p["shared_gate"]))
        ys, sgroup = _mlp_part(cfg, p["shared"], x)
        ys = ys * gate.to(x.dtype)
        if sgroup is not None and group is not None:
            y = y + ys                   # both parts: one sum over "model"
        else:
            y = reduce_model(y, group) + reduce_model(ys, sgroup)
            group = None
    y = reduce_model(y, group)

    # load-balancing auxiliary loss (Switch-style)
    me = probs.mean(dim=(0, 1))                         # (E,)
    ce = onehot.to(torch.float32).mean(dim=(0, 1, 2)) * e
    if aux_groups:                   # the means over every rank's groups
        from ..distributed import comm
        both, n = torch.stack([me, ce]), 1
        for group in aux_groups:
            both, n = comm.all_reduce(both, group), n * comm.size(group)
        me, ce = both / n
    aux = torch.sum(me * ce)
    return y, aux


# ------------------------------------------------------------------- Mamba-1
def _ssm(cfg: ArchConfig) -> SSMSpec:
    return cfg.ssm or SSMSpec()


def init_mamba(cfg: ArchConfig, gen: torch.Generator) -> dict:
    s = _ssm(cfg)
    d = cfg.d_model
    din = s.expand * d
    dtr = s.dt_rank or -(-d // 16)
    dt = _dtype(cfg.param_dtype)
    dev = gen.device
    a = torch.arange(1, s.state + 1, dtype=torch.float32,
                     device=dev).repeat(din, 1)
    dt_b = torch.log(torch.expm1(torch.full((din,), 0.01,
                                            dtype=torch.float32,
                                            device=dev)))
    return {
        "in_proj": dense_init(gen, (d, 2 * din), 0, dt),
        "conv_w": (torch.randn((din, s.conv), generator=gen, device=dev)
                   / math.sqrt(s.conv)).to(dt),
        "conv_b": torch.zeros((din,), dtype=dt, device=dev),
        "x_proj": dense_init(gen, (din, dtr + 2 * s.state), 0, dt),
        "dt_w": dense_init(gen, (dtr, din), 0, dt),
        "dt_b": dt_b,
        "A_log": torch.log(a),
        "D": torch.ones((din,), dtype=torch.float32, device=dev),
        "out_proj": dense_init(gen, (din, d), 0, dt),
    }


def _ssm_scan_chunked(u, dt, a, bm, cm, chunk: int):
    """h_t = exp(dt_t A) h_{t-1} + (dt_t u_t) B_t ;  y_t = (h_t C_t).sum(N).

    The plain scan of the model (``use_kernel=False``): within chunks of
    ``chunk`` steps an inclusive scan of the reference's ``combine`` in
    log2(chunk) doubling steps, chunks one after another, so the
    (B, chunk, D, N) intermediates stay bounded.  As in the reference, an L
    that ``chunk`` does not divide is one chunk.  Returns (y (B, L, D) f32,
    hT (B, D, N) f32).
    """
    b, l, d = u.shape
    n = a.shape[1]
    chunk = min(chunk, l)
    if l % chunk:
        chunk = l
    a = a.to(torch.float32)
    h = torch.zeros((b, d, n), dtype=torch.float32, device=u.device)
    ys = []
    for i in range(0, l, chunk):
        u_, dt_, b_, c_ = (t[:, i:i + chunk].to(torch.float32)
                           for t in (u, dt, bm, cm))
        acum = torch.exp(dt_[..., None] * a[None, None])      # (B, C, D, N)
        bcum = (dt_ * u_)[..., None] * b_[:, :, None, :]      # (B, C, D, N)
        off = 1
        while off < acum.shape[1]:
            # combine((a1, b1), (a2, b2)) = (a1 a2, b1 a2 + b2), earlier first
            a1, b1 = acum[:, :-off], bcum[:, :-off]
            a2, b2 = acum[:, off:], bcum[:, off:]
            acum = torch.cat([acum[:, :off], a1 * a2], dim=1)
            bcum = torch.cat([bcum[:, :off], b1 * a2 + b2], dim=1)
            del a1, b1, a2, b2
            off *= 2
        hs = acum * h[:, None] + bcum                       # (B, C, D, N)
        del acum, bcum
        ys.append(torch.einsum("bcdn,bcn->bcd", hs, c_))
        h = hs[:, -1].clone()
        del hs
    return torch.cat(ys, dim=1), h


def _causal_conv1d(x, w, b):
    """Depthwise causal conv: x (B, L, D), w (D, K) -> (B, L, D), the
    reference's sum of K shifted products (no cuDNN, which would run f32 in
    TF32)."""
    k = w.shape[1]
    xp = F.pad(x, (0, 0, k - 1, 0))
    y = xp[:, 0:x.shape[1], :] * w[:, 0][None, None, :]
    for i in range(1, k):
        y = y + xp[:, i:i + x.shape[1], :] * w[:, i][None, None, :]
    return y + b[None, None, :]


def _mamba_proj(cfg: ArchConfig, p: Params, xa, dtype):
    """xa -> (dt, B, C, A) as the reference derives them."""
    s = _ssm(cfg)
    dtr = p["dt_w"].shape[0]
    # row-parallel on a rank's channels: summed over "model"
    proj = reduce_model(xa @ use(p["x_proj"]), _model_group(p["x_proj"], 0))
    dt_raw = proj[..., :dtr]
    bm = proj[..., dtr:dtr + s.state]
    cm = proj[..., dtr + s.state:]
    dt = F.softplus(dt_raw @ use(p["dt_w"]) + p["dt_b"].to(dtype))
    a = -torch.exp(p["A_log"])                          # (Din, N)
    return dt, bm, cm, a


def mamba(cfg: ArchConfig, p: Params, x, return_state: bool = False,
          use_kernel: bool = True, cp: Optional[SeqParallel] = None):
    """Mamba-1 block.  x (B, S, d) -> (B, S, d).

    ``use_kernel`` runs the scan through ``ops.mamba_scan`` (the scan kernel
    on the card; where autograd records it, ``SelectiveScan`` with its
    backward kernels), else through the plain chunked scan (under autograd
    in training).  With
    ``return_state`` also returns (conv_state (B, K-1, Din), ssm_state
    (B, Din, N) f32) for decode handoff.  The conv state is the last K-1
    inputs of the conv, zeros before the first token (where the reference
    slices fewer than K-1 rows for a prompt shorter than K-1, which its
    decode cannot take).

    Under a blocked residual (``cp.residual``) x is the rank's block: the
    block gathers the sequence, scans it whole and keeps its own rows (the
    states returned are the whole sequence's).  On a rank's shards (a model
    built under a mesh) the rank holds Din/mm channels (``in_proj`` as
    ``[xin_r | z_r]``, ``sharding.rules`` layout (a)): the conv, dt and the
    scan run on them, ``x_proj`` and ``out_proj`` are row-parallel, their
    products summed over "model".
    """
    if cp is not None and cp.residual:
        out = mamba(cfg, p, cp.gather(x), return_state, use_kernel)
        if return_state:
            return cp.block(out[0]), out[1]
        return cp.block(out)
    s = _ssm(cfg)
    xz = x @ use(p["in_proj"])
    xin, z = torch.chunk(xz, 2, dim=-1)                 # (B, S, Din)
    xc = _causal_conv1d(xin, p["conv_w"], p["conv_b"])
    xa = F.silu(xc)
    dt, bm, cm, a = _mamba_proj(cfg, p, xa, x.dtype)
    if use_kernel:
        out = ops.mamba_scan(xa, dt, a, bm, cm, p["D"],
                             return_state=return_state)
        y, hT = out if return_state else (out, None)
    else:
        y, hT = _ssm_scan_chunked(xa, dt, a, bm, cm, cfg.ssm_chunk)
        y = y + p["D"][None, None] * xa.to(torch.float32)
    y = y.to(x.dtype) * F.silu(z)
    out = reduce_model(y @ use(p["out_proj"]), _model_group(p["out_proj"], 0))
    if return_state:
        k1 = s.conv - 1
        conv_state = F.pad(xin, (0, 0, k1, 0))[:, xin.shape[1]:]
        return out, (conv_state, hT)
    return out


def mamba_decode(cfg: ArchConfig, p: Params, x, conv_state, ssm_state):
    """One-token decode.  x (B, 1, d); conv_state (B, K-1, Din);
    ssm_state (B, Din, N) f32.  Returns (y (B, 1, d), new conv state, new
    ssm state), as the reference; plain torch (no kernel here, as in the
    reference).  On a rank's shards, as :func:`mamba`: the rank's Din/mm
    channels (its states are theirs), ``x_proj`` and ``out_proj``
    row-parallel, summed over "model"."""
    s = _ssm(cfg)
    xz = x[:, 0] @ use(p["in_proj"])
    xin, z = torch.chunk(xz, 2, dim=-1)                 # (B, Din)
    window = torch.cat([conv_state, xin[:, None]], dim=1)   # (B, K, Din)
    xc = torch.einsum("bkd,dk->bd", window, p["conv_w"]) + p["conv_b"]
    xa = F.silu(xc)
    dt, bm, cm, a = _mamba_proj(cfg, p, xa, x.dtype)
    da = torch.exp(dt[..., None].to(torch.float32) * a[None])  # (B, Din, N)
    db = (dt * xa)[..., None].to(torch.float32) * \
        bm[:, None, :].to(torch.float32)
    h = ssm_state * da + db
    y = torch.sum(h * cm[:, None, :].to(torch.float32), dim=-1)
    y = y + p["D"][None] * xa.to(torch.float32)
    y = y.to(x.dtype) * F.silu(z)
    out = reduce_model(y @ use(p["out_proj"]),
                       _model_group(p["out_proj"], 0))[:, None]
    new_conv = window[:, 1:] if s.conv > 1 else conv_state
    return out, new_conv, h
