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
first entry goes.  That entry is None, except where ZeRO-1 puts "data" on
the stacked axis of a moment (the period count divisible by the data
axis): there the port's moment keeps the rest of the spec, replicated over
"data".  Shapes at full size come from :func:`abstract_model`, the port's
model built under ``FakeTensorMode`` (no storage is allocated).  Decode
caches are stacked in the port as in the reference, so their specs are the
reference's as they are.
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

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
        return build_model(cfg, "cpu")


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
