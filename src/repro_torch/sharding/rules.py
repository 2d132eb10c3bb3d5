"""Sharding rules: parameter name -> PartitionSpec over the production mesh.

Port of ``repro.sharding.rules``.  Mesh axes: ``("data", "model")``
single-pod, ``("pod", "data", "model")`` multi-pod.  Conventions:

  * batch shards over ("pod","data"); vocab / heads / d_ff / experts /
    mamba-inner over "model";
  * FSDP archs (jamba-398B, qwen3-moe-235B) additionally shard the d_model
    axis of weights over "data" (ZeRO-3 style) so params fit HBM;
  * optimizer moments are ZeRO-1 sharded over "data" for non-FSDP archs;
  * every rule checks divisibility and falls back to replication.

A spec is the reference's ``PartitionSpec`` as a tuple, one entry a
dimension: None, an axis name, or a tuple of axis names (the batch's
``("pod", "data")``).  A mesh is a ``torch.distributed`` ``DeviceMesh`` or
a ``{axis: size}`` mapping.  :func:`placements` gives a spec's DTensor
placements on a ``DeviceMesh``.

The port keeps its parameters per layer (``models.lm.LM``,
``models.encdec.EncDec``), where the reference stacks them over periods (or
layers), so a port parameter's spec is the reference's spec of its stacked
leaf (``models/convert.py::reference_layout``) with the stacked axis
dropped: the rules run on the stacked shape, as the reference's do, and the
first entry goes.  Shapes at full size come from :func:`abstract_model`,
the port's model built under ``FakeTensorMode`` (no storage is allocated).
Decode caches are stacked in the port as in the reference, so their specs
are the reference's as they are.

**A rank's shards** (the sharded train step, ``train.loop``).  A model
built under an ambient mesh (``models.build_model``) holds, for each
parameter, the part :func:`shard` cuts from the whole tensor for the
rank's place on the mesh (:func:`port_layout`: :func:`param_specs` with
the axes of size 1 dropped; under ``attn_shard="seq"`` every parameter is
replicated, as context parallelism has them), and :func:`unshard` makes
the whole tensor again from every rank's part (a collective).  Two layouts
differ from the flat spec's, each rank holding as many elements:

(a) **Mamba's ``in_proj``** (d, 2 Din), spec (., "model"): the flat split
    would give model rank 0 of 2 all of ``xin`` and rank 1 all of ``z``,
    and the layer splits ``xz`` in halves; here each half is split over
    the model ranks and rank r holds its Din/mm channels of both halves,
    ``[xin_r | z_r]`` (:attr:`Placement.halves`).
(b) **ZeRO-1 on a stacked axis.**  The reference puts "data" on the
    periods axis of a moment where the period count divides over "data";
    the port's moments are per layer, so layer l's moments live whole (in
    their model-sharded form) on data rank ``l dd // P`` and nowhere else
    (:attr:`Placement.owner`): the contiguous block of periods that
    ``NamedSharding`` gives each data rank.  A moment whose "data" lies on
    another axis (the vocab tables, the final norm, a stack the data axis
    does not divide) keeps 1/dd of its elements on each data rank, as the
    flat spec cuts them.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from ..configs.base import ArchConfig

Spec = Tuple[Any, ...]


def mesh_sizes(mesh) -> Dict[str, int]:
    """``{axis: size}`` of a ``DeviceMesh`` or a mapping."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def mesh_axis_size(mesh, name: str) -> int:
    return mesh_sizes(mesh).get(name, 1)


def batch_axes(mesh) -> Tuple[str, ...]:
    return ("pod", "data") if "pod" in mesh_sizes(mesh) else ("data",)


def _batch_entry(mesh) -> Any:
    """The batch axes as one spec entry: a lone axis by its name, as
    ``PartitionSpec`` normalises ``("data",)``."""
    axes = batch_axes(mesh)
    return axes[0] if len(axes) == 1 else axes


def placements(spec: Spec, mesh) -> List[Any]:
    """The DTensor placements of ``spec`` on ``mesh`` (a ``DeviceMesh``), one
    a mesh dimension: ``Shard(d)`` where the axis shards tensor dimension
    ``d``, else ``Replicate()``.  An entry ``("pod", "data")`` shards its
    dimension over both mesh dimensions, pod-major, as the reference's
    ``NamedSharding`` does; the axes must come in the mesh's order."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh.mesh_dim_names)
    out: List[Any] = [Replicate() for _ in names]
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: axes {axes} out of the mesh's "
                             f"order {tuple(names)}")
        for i in idx:
            out[i] = Shard(d)
    return out


def _div(n: int, k: int) -> bool:
    return k > 0 and n % k == 0


# ----------------------------------------------------------------- parameters
def _param_rule(cfg: ArchConfig, path: str, shape: Tuple[int, ...],
                mesh) -> Spec:
    m = mesh_axis_size(mesh, "model")
    dsz = mesh_axis_size(mesh, "data")
    fsdp = "data" if cfg.fsdp else None

    def ax(dim: int, name: Optional[str]) -> Optional[str]:
        if name is None:
            return None
        size = m if name == "model" else dsz
        return name if _div(shape[dim], size * 1) else None

    def spec(*names) -> Spec:
        # Trim/extend to leaf rank; a leading stacked axis gets None.
        extra = len(shape) - len(names)
        names = (None,) * extra + tuple(names)
        return tuple(ax(i, n) for i, n in enumerate(names))

    leaf = path.split("/")[-1]
    parent = path.split("/")[-2] if "/" in path else ""

    if leaf in ("embed", "lm_head"):
        return spec("model", fsdp)
    if parent in ("attn", "cross"):
        if leaf == "wq" or leaf == "wk" or leaf == "wv":
            return spec(fsdp, "model")
        if leaf == "wo":
            return spec("model", fsdp)
        if leaf in ("bq", "bk", "bv"):
            return spec("model")
        return spec(None)                                # q_norm / k_norm
    if parent in ("mlp", "shared"):
        if leaf in ("gate", "up"):
            return spec(fsdp, "model")
        if leaf == "down":
            return spec("model", fsdp)
    if parent == "moe":
        e = cfg.moe.n_experts if cfg.moe else 0
        ep = _div(e, m)                                  # expert parallelism
        # seq mode: tokens (dispatch groups) carry the model-axis
        # parallelism, so non-EP expert weights must not shard a
        # contraction dim over "model" — replicate over model, FSDP over
        # data if configured.
        seq_repl = cfg.attn_shard == "seq" and not ep
        if leaf == "router":
            return spec(None, None)
        if leaf in ("w_gate", "w_up"):
            if ep:
                return spec("model", fsdp, None)
            return spec(None, fsdp, None) if seq_repl else \
                spec(None, fsdp, "model")
        if leaf == "w_down":
            if ep:
                return spec("model", None, fsdp)
            return spec(None, None, fsdp) if seq_repl else \
                spec(None, "model", fsdp)
        if leaf == "shared_gate":
            return spec(None, None)
    if parent == "mamba":
        if leaf == "in_proj":
            return spec(fsdp, "model")
        if leaf == "out_proj":
            return spec("model", fsdp)
        if leaf in ("conv_w", "x_proj", "A_log"):
            return spec("model", None)
        if leaf == "dt_w":
            return spec(None, "model")
        if leaf in ("conv_b", "dt_b", "D"):
            return spec("model")
    # norms, biases, anything else: replicated (stacked axis still None)
    return (None,) * len(shape)


def abstract_model(cfg: ArchConfig):
    """``cfg``'s model with every parameter a FakeTensor of its full shape
    and dtype: shapes at full size, no storage."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from ..models import build_model
    with FakeTensorMode():
        return build_model(cfg, "cpu", shard=False)


def stacked_leaves(model) -> Dict[str, Tuple[str, Tuple[int, ...], bool]]:
    """For each parameter of ``model``: its reference leaf's path (``"/"``
    joined, as the reference's rules see it), the leaf's shape (stacked
    over periods or layers where the parameter is one of a stack), and
    whether it is stacked."""
    from ..models.convert import reference_layout
    params = dict(model.named_parameters())
    layout = reference_layout(model)
    count: Dict[Tuple, int] = {}
    for path, per in layout.values():
        if per is not None:
            count[path] = count.get(path, 0) + 1
    out = {}
    for name, (path, per) in layout.items():
        shape = tuple(params[name].shape)
        if per is not None:
            shape = (count[path],) + shape
        out[name] = ("/".join(str(p) for p in path), shape, per is not None)
    return out


def param_specs(cfg: ArchConfig, model, mesh) -> Dict[str, Spec]:
    """``{parameter name: spec}`` of ``model``'s parameters (a model on any
    device, or :func:`abstract_model`)."""
    return {name: _param_rule(cfg, path, shape, mesh)[1 if stacked else 0:]
            for name, (path, shape, stacked) in stacked_leaves(model).items()}


# ------------------------------------------------------------------ optimizer
def _opt_rule(cfg: ArchConfig, spec: Spec, shape: Tuple[int, ...],
              mesh) -> Spec:
    if cfg.fsdp:
        return spec
    dsz = mesh_axis_size(mesh, "data")
    names = list(spec) + [None] * (len(shape) - len(spec))
    if "data" in names:
        return tuple(names)
    for i, n in enumerate(names):
        if n is None and _div(shape[i], dsz) and shape[i] >= dsz:
            names[i] = "data"
            break
    return tuple(names)


def opt_specs(cfg: ArchConfig, pspecs: Mapping[str, Spec], model,
              mesh) -> Dict[str, Spec]:
    """ZeRO-1: moments take the param spec + shard the first free axis over
    'data' (on the reference's stacked leaf).  FSDP params are already
    data-sharded; keep their spec."""
    out = {}
    for name, (path, shape, stacked) in stacked_leaves(model).items():
        full = ((None,) + tuple(pspecs[name])) if stacked else \
            tuple(pspecs[name])
        out[name] = _opt_rule(cfg, full, shape, mesh)[1 if stacked else 0:]
    return out


# -------------------------------------------------------------------- batches
def batch_specs(cfg: ArchConfig, batch: Mapping[str, Any],
                mesh) -> Dict[str, Spec]:
    """Shard the leading batch axis over ("pod","data") when divisible."""
    baxes = batch_axes(mesh)
    bsize = int(np.prod([mesh_axis_size(mesh, a) for a in baxes]))
    out = {}
    for k, leaf in batch.items():
        shape = tuple(leaf.shape)
        if not shape:
            out[k] = ()
            continue
        first = _batch_entry(mesh) if _div(shape[0], bsize) else None
        out[k] = (first,) + (None,) * (len(shape) - 1)
    return out


# --------------------------------------------------------------------- caches
def _cache_rule(leafname: str, shape: Sequence[int], mesh) -> Spec:
    m = mesh_axis_size(mesh, "model")
    baxes = batch_axes(mesh)
    bsize = int(np.prod([mesh_axis_size(mesh, a) for a in baxes]))
    dsz = mesh_axis_size(mesh, "data")
    bentry = _batch_entry(mesh)
    if leafname == "length":
        return (bentry if _div(shape[0], bsize) else None,)
    if leafname in ("k", "v", "xk", "xv", "k_scale", "v_scale"):
        stacked, b, s, hkv, hd = shape
        bspec = bentry if _div(b, bsize) else None
        sspec = None if bspec else ("data" if _div(s, dsz) else None)
        if _div(hkv, m):
            hspec, dspec = "model", None
        elif _div(hd, m):
            hspec, dspec = None, "model"
        else:
            hspec = dspec = None
        return (None, bspec, sspec, hspec, dspec)
    if leafname == "conv":                           # (P, B, K-1, Din)
        bspec = bentry if _div(shape[1], bsize) else None
        return (None, bspec, None, "model" if _div(shape[3], m) else None)
    if leafname == "ssm":                            # (P, B, Din, N)
        bspec = bentry if _div(shape[1], bsize) else None
        return (None, bspec, "model" if _div(shape[2], m) else None, None)
    return (None,) * len(shape)


def cache_specs(cfg: ArchConfig, cache: Any, mesh) -> Any:
    """Decode-cache sharding, a tree of specs of the cache's structure.

    KV caches (P, B, S, Hkv, hd): batch over ("pod","data") when divisible
    — otherwise (long_500k, B=1) the *sequence* axis shards over "data"
    (sequence-parallel cache).  Hkv over "model" when divisible, else hd."""
    def walk(node, key):
        if isinstance(node, Mapping):
            return {k: walk(v, k) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [walk(v, key) for v in node]
        return _cache_rule(str(key), tuple(node.shape), mesh)
    return walk(cache, "")


def _tree_map(fn, node, key=""):
    """``fn(leaf key, leaf)`` over a cache tree of dicts and lists."""
    if isinstance(node, Mapping):
        return {k: _tree_map(fn, v, k) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return [_tree_map(fn, v, key) for v in node]
    return fn(str(key), node)


def _tree_zip(fn, a, b):
    """``fn(x, y)`` over two trees of one structure (``a``'s)."""
    if isinstance(a, Mapping):
        return {k: _tree_zip(fn, v, b[k]) for k, v in a.items()}
    if isinstance(a, (list, tuple)):
        return [_tree_zip(fn, x, y) for x, y in zip(a, b)]
    return fn(a, b)


def cache_placements(cfg: ArchConfig, cache: Any, mesh) -> Any:
    """A tree of :class:`Placement`, the structure of ``cache`` (a whole
    cache, or a tree of its leaves' shapes' tensors on any device):
    :func:`cache_specs` with the axes of size 1 dropped.  Every case of the
    rule holds: the batch over the batch axes where they divide it, else
    the positions over "data" where it divides them; the KV heads over
    "model" where it divides them, else the head dim, else neither (the
    cache whole over "model"); Mamba's channels over "model"."""
    sizes = mesh_sizes(mesh)
    return _tree_map(lambda key, t: Placement(drop_unit_axes(
        _cache_rule(key, tuple(t.shape), mesh), sizes)), cache)


def local_shape(shape: Sequence[int], place: Placement,
                sizes: Mapping[str, int]) -> Tuple[int, ...]:
    """The shape of a rank's part of a whole tensor of ``shape``."""
    out = list(shape)
    for d, entry in enumerate(place.spec):
        for a in _axes(entry):
            if out[d] % sizes[a]:
                raise ValueError(f"dim {d} of {tuple(shape)} does not "
                                 f"split over {a}")
            out[d] //= sizes[a]
    return tuple(out)


def cache_shard(cache: Any, places: Any, coords: Mapping[str, int],
                sizes: Mapping[str, int]) -> Any:
    """The rank's part of each leaf of a whole cache (:func:`shard`, views),
    by the placements of :func:`cache_placements`."""
    return _tree_zip(lambda t, place: shard(t, place, coords, sizes), cache,
                     places)


def cache_unshard(cache: Any, places: Any, mesh) -> Any:
    """The whole cache from every rank's part (:func:`unshard`: a
    collective every rank of the mesh calls)."""
    return _tree_zip(lambda t, place: unshard(t, place, mesh), cache, places)


# ------------------------------------------------------------ a rank's shards
def _axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def drop_unit_axes(spec: Spec, sizes: Mapping[str, int]) -> Spec:
    """``spec`` without the axes of size 1 on the mesh (a split over one
    rank is no split)."""
    out = []
    for entry in spec:
        axes = tuple(a for a in _axes(entry) if sizes.get(a, 1) > 1)
        out.append(None if not axes else axes[0] if len(axes) == 1
                   else axes)
    return tuple(out)


def spec_axes(spec: Spec) -> Tuple[str, ...]:
    """The mesh axes ``spec`` splits a tensor over."""
    return tuple(a for entry in spec for a in _axes(entry))


def replicated_axes(spec: Spec, sizes: Mapping[str, int]) -> Tuple[str, ...]:
    """The mesh axes above size 1 that ``spec`` does not split over: every
    rank along them holds the same elements."""
    used = spec_axes(spec)
    return tuple(a for a, n in sizes.items() if n > 1 and a not in used)


def _part(entry, coords: Mapping[str, int],
          sizes: Mapping[str, int]) -> Tuple[int, int]:
    """(index, count) of this rank's part along a dimension whose entry is
    ``entry``: axes combined in their order, the first major."""
    i, n = 0, 1
    for a in _axes(entry):
        i, n = i * sizes[a] + coords[a], n * sizes[a]
    return i, n


@dataclasses.dataclass(frozen=True)
class Placement:
    """How a rank holds a tensor: ``spec`` over the tensor's own
    dimensions; ``halves``: the dimension split over "model" is Mamba's
    ``in_proj`` pair of halves, each split (layout (a) of the module
    docstring); ``owner``: a moment held whole on that data rank only
    (layout (b)), else None."""

    spec: Spec
    halves: bool = False
    owner: Optional[int] = None


def shard(t, place: Placement, coords: Mapping[str, int],
          sizes: Mapping[str, int]):
    """The part of the whole tensor ``t`` that the rank at ``coords`` (axis
    -> index) holds under ``place`` (a view where one narrow gives it)."""
    for d, entry in enumerate(place.spec):
        if entry is None:
            continue
        i, n = _part(entry, coords, sizes)
        halves = place.halves and "model" in _axes(entry)
        if t.shape[d] % (n * (2 if halves else 1)):
            raise ValueError(f"dim {d} of {tuple(t.shape)} does not split "
                             f"over {n} ranks ({place})")
        if halves:
            k = t.shape[d] // (2 * n)
            half = t.shape[d] // 2
            t = torch.cat([t.narrow(d, i * k, k),
                           t.narrow(d, half + i * k, k)], dim=d)
        else:
            k = t.shape[d] // n
            t = t.narrow(d, i * k, k)
    return t


def unshard(t, place: Placement, mesh):
    """The whole tensor from every rank's part ``t`` under ``place``: an
    all-gather over each axis the spec splits, last axis first
    (``distributed.comm``, differentiable).  Every rank of those groups
    calls it."""
    from ..distributed import comm
    for d, entry in enumerate(place.spec):
        for a in reversed(_axes(entry)):
            g = mesh.get_group(a)
            n = comm.size(g)
            t = comm.all_gather(t, g, d)
            if place.halves and a == "model":
                shape = t.shape
                k = shape[d] // (2 * n)
                t = t.reshape(*shape[:d], n, 2, k, *shape[d + 1:]) \
                    .transpose(d, d + 1).reshape(shape)
    return t


def mesh_coords(mesh) -> Dict[str, int]:
    """``{axis: this rank's index}`` on a ``DeviceMesh``."""
    return {a: int(mesh.get_local_rank(a)) for a in mesh.mesh_dim_names}


def _halves(path: str) -> bool:
    return path.endswith("mamba/in_proj")


def port_layout(cfg: ArchConfig, model, mesh
                ) -> Tuple[Dict[str, Placement], Dict[str, Placement]]:
    """({parameter name: its placement}, {parameter name: its moments'
    placement}) of ``model`` (any device, or :func:`abstract_model`) on
    ``mesh``: :func:`param_specs` and :func:`opt_specs` with the axes of
    size 1 dropped, layouts (a) and (b) of the module docstring.  Under
    ``attn_shard="seq"`` the parameters are replicated (context
    parallelism's layout), and so are an enc-dec's; ZeRO-1 still cuts their
    moments over "data"."""
    sizes = mesh_sizes(mesh)
    leaves = stacked_leaves(model)
    if cfg.attn_shard == "seq" or cfg.is_encdec:
        full = {name: (None,) * len(shape)
                for name, (_, shape, _) in leaves.items()}
    else:
        full = {name: _param_rule(cfg, path, shape, mesh)
                for name, (path, shape, _) in leaves.items()}
    dd = sizes.get("data", 1)
    params, moments = {}, {}
    layout = None
    for name, (path, shape, stacked) in leaves.items():
        half = _halves(path)
        pspec = drop_unit_axes(full[name], sizes)
        ospec = drop_unit_axes(_opt_rule(cfg, pspec, shape, mesh), sizes)
        owner = None
        if stacked and ospec[0] == "data":
            if layout is None:
                from ..models.convert import reference_layout
                layout = reference_layout(model)
            owner = layout[name][1] * dd // shape[0]
        cut = 1 if stacked else 0
        params[name] = Placement(pspec[cut:], half)
        moments[name] = Placement(ospec[cut:], half, owner)
    return params, moments


class ModelShards:
    """A model's layout on a mesh, as built under it
    (``models.build_model``): ``params`` and ``moments`` as
    :func:`port_layout` gives them, this rank's ``coords`` and the mesh's
    ``sizes``.  ``split``: some parameter is split (else only the moments
    are, by ZeRO-1)."""

    def __init__(self, mesh, params: Mapping[str, Placement],
                 moments: Mapping[str, Placement]):
        self.mesh = mesh
        self.params, self.moments = dict(params), dict(moments)
        self.coords, self.sizes = mesh_coords(mesh), mesh_sizes(mesh)
        self.split = any(spec_axes(p.spec) for p in self.params.values())

    def cut(self, name: str, t):
        """Parameter ``name``'s part of its whole tensor ``t``: a copy of
        its own, so the whole can be freed."""
        place = self.params[name]
        if not spec_axes(place.spec):
            return t
        return shard(t, place, self.coords, self.sizes).clone(
            memory_format=torch.contiguous_format)

    def whole(self, name: str, t):
        """The whole tensor of parameter ``name`` (or of a tensor laid out
        as it: its gradient) from every rank's part ``t`` (a
        collective)."""
        return unshard(t, self.params[name], self.mesh)

    def owns(self, name: str) -> bool:
        """Whether this rank holds parameter ``name``'s moments."""
        owner = self.moments[name].owner
        return owner is None or owner == self.coords.get("data", 0)

    def moment_shape(self, name: str, shape) -> Tuple[int, ...]:
        """The shape of parameter ``name``'s moments on this rank, from its
        parameter's (a rank's) ``shape``: each dimension the moments split
        over "data" and the parameter does not, divided (0 elements where
        another data rank owns them)."""
        if not self.owns(name):
            return (0,)
        out = list(shape)
        pspec = self.params[name].spec
        for d, entry in enumerate(self.moments[name].spec):
            extra = [a for a in _axes(entry) if a not in _axes(pspec[d])]
            for a in extra:
                out[d] //= self.sizes[a]
        return tuple(out)

    def moment_dim(self, name: str) -> Optional[int]:
        """The dimension the moments of ``name`` split over "data" where
        the parameter does not (ZeRO-1 on a dimension of its own), else
        None."""
        pspec = self.params[name].spec
        for d, entry in enumerate(self.moments[name].spec):
            if "data" in _axes(entry) and "data" not in _axes(pspec[d]):
                return d
        return None

    def counted(self, name: str) -> bool:
        """Whether this rank's moments of ``name`` count in the global
        norm: the elements it updates are no other rank's (every axis they
        are replicated over, this rank at index 0 of it)."""
        place = self.moments[name]
        rep = replicated_axes(place.spec, self.sizes)
        if place.owner is not None:
            rep = tuple(a for a in rep if a != "data")
        return all(self.coords[a] == 0 for a in rep)
