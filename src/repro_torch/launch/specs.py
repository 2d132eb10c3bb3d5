"""One rank's program for every (arch x shape x step), on fake tensors.

Port of ``repro.launch.specs``.  The reference builds ``ShapeDtypeStruct``
trees and ``NamedSharding``s and lets XLA's SPMD partitioner lower the
step for every device; PyTorch has no such compiler, and the port writes
each rank's program out with ``torch.distributed`` calls
(``train.loop``, ``models.layers``).  So a cell here is **one rank's**
program: the model built under ``FakeTensorMode`` (shapes and dtypes, no
storage) inside ``models.layers.ambient_mesh(mesh)``, which holds that
rank's shards as ``sharding.rules`` lays them out (``models.build_model``),
and the function a user calls on it.  ``launch.dryrun`` runs it on those
fake tensors over a ``fake`` process group.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Optional, Tuple, Union

import torch

from ..configs.base import SHAPES, ArchConfig, ShapeSpec, get_arch
from ..configs import archs  # noqa: F401  (registers every arch)


class CellSpec(NamedTuple):
    """One rank's program of an (arch x shape) cell: ``fn(*args)`` on fake
    tensors made in ``mode`` (run it there, under
    ``layers.ambient_mesh(mesh)``); ``placements``: the rank's parameters'
    and moments' layouts (``sharding.rules.Placement`` by name) and the
    batch's specs, and for a serving cell the cache's placements
    (``sharding.rules.cache_placements``, a tree) and the logits' spec (the
    reference's ``logit_sh``), None on one rank; ``kind``: "train",
    "prefill" or "decode"."""
    fn: Any
    args: Tuple
    placements: Optional[Dict[str, Any]]
    kind: str
    mode: Any
    mesh: Any
    cfg: ArchConfig
    shape: ShapeSpec


SERVING_ON_A_MESH = ("serving an enc-dec, or attn_shard='seq', over a mesh "
                     "of more than one rank is not ported (their parameters "
                     "stay whole there): ROADMAP Queue 1 item 10(k)")


def batch_fake(cfg: ArchConfig, shape: ShapeSpec) -> Dict[str, torch.Tensor]:
    """The global batch of a cell (call in a ``FakeTensorMode``): the
    reference's ``batch_sds``, token ids and labels int64 as the port's
    ``train.loop.to_device`` gives them."""
    b, s = shape.global_batch, shape.seq_len
    cdt = getattr(torch, cfg.compute_dtype)
    batch: Dict[str, torch.Tensor] = {}
    if cfg.embed_inputs:
        batch["embeds"] = torch.empty((b, s, cfg.d_model), dtype=cdt)
        if cfg.is_encdec:
            batch["tokens"] = torch.empty((b, s), dtype=torch.int64)
    else:
        batch["tokens"] = torch.empty((b, s), dtype=torch.int64)
    batch["labels"] = torch.empty((b, s), dtype=torch.int64)
    return batch


def cell_config(arch: Union[str, ArchConfig],
                overrides: Optional[Dict] = None) -> ArchConfig:
    """``arch``'s config (a registered name, or a config as it is) with
    ``overrides`` (the reference's: ``n_layers``, ``encoder_layers``, any
    knob; ``static_unroll`` is accepted and has nothing to unroll in the
    port)."""
    cfg = arch if isinstance(arch, ArchConfig) else get_arch(arch)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    return cfg


def make_cell(arch: Union[str, ArchConfig], shape_name: Union[str, ShapeSpec],
              mesh, overrides: Optional[Dict] = None) -> CellSpec:
    """The rank's program of ``arch`` (:func:`cell_config`) at
    ``shape_name`` (a ``SHAPES`` key or a ``ShapeSpec``) on ``mesh`` (a
    ``DeviceMesh``, or None for one rank): ``train.loop.make_train_step``
    over the rank's shards and moments (ZeRO-1) and the global batch, or
    ``models.prefill`` / ``models.decode_step`` on the rank's shards, the
    global batch and, for decode, the rank's part of the cache
    (``models.init_cache``, laid out by ``cache_specs``).  Serving an
    enc-dec or ``attn_shard="seq"`` on more than one rank raises (item
    10(k)), and so does the accumulated step there (item 10(f))."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from .. import models
    from ..distributed.overlap import wants_accum
    from ..models import layers as L
    from ..optim import adamw_init
    from ..sharding.rules import batch_specs
    from ..train.loop import TrainState, make_train_step

    cfg = cell_config(arch, overrides)
    shape = SHAPES[shape_name] if isinstance(shape_name, str) else shape_name
    ranks = 1 if mesh is None else int(mesh.size())
    if shape.kind != "train" and ranks > 1 and (
            cfg.is_encdec or cfg.attn_shard == "seq"):
        raise NotImplementedError(f"{cfg.name} x {shape.name}: "
                                  f"{SERVING_ON_A_MESH}")
    if shape.kind == "train" and wants_accum(cfg) and ranks > 1:
        raise NotImplementedError(
            f"{cfg.name}: the accumulated step (grad_accum={cfg.grad_accum}, "
            f"grad_compression={cfg.grad_compression!r}) across the ranks of "
            f"a mesh is not ported yet (ROADMAP Queue 1 item 10(f))")
    mode = FakeTensorMode()
    with mode, L.ambient_mesh(mesh):
        model = models.build_model(cfg, "cpu", seed=0)
        place = None
        if model.shards is not None:
            place = {"params": model.shards.params,
                     "moments": model.shards.moments}
        if shape.kind == "train":
            model.requires_grad_(True)
            opt = adamw_init(dict(model.named_parameters()), cfg.adam_dtype,
                             model.shards)
            batch = batch_fake(cfg, shape)
            if place is not None:
                place["batch"] = batch_specs(cfg, batch, mesh)
            return CellSpec(make_train_step(model),
                            (TrainState(model, opt, 0), batch), place,
                            "train", mode, mesh, cfg, shape)
        b, s = shape.global_batch, shape.seq_len
        if place is not None:
            place["cache"] = models.lm.serve_part(cfg, b, s, mesh).places
            place["logits"] = logit_spec(cfg, b, mesh)
        if shape.kind == "prefill":
            batch = batch_fake(cfg, shape)
            batch.pop("labels")
            fn = lambda m, bt: models.prefill(cfg, m, bt, s)
            return CellSpec(fn, (model, batch), place, "prefill", mode, mesh,
                            cfg, shape)
        # decode: one new token against a seq_len-deep cache
        cache = models.init_cache(cfg, model, b, s, s if cfg.is_encdec else 0)
        if cfg.embed_inputs and not cfg.is_encdec:
            tok = torch.empty((b, cfg.d_model),
                              dtype=getattr(torch, cfg.compute_dtype))
        else:
            tok = torch.empty((b,), dtype=torch.int64)
        fn = lambda m, c, t: models.decode_step(cfg, m, c, t)
        return CellSpec(fn, (model, cache, tok), place, "decode", mode, mesh,
                        cfg, shape)


def logit_spec(cfg: ArchConfig, batch: int, mesh) -> Tuple:
    """The reference's ``logit_sh`` of a serving cell on ``mesh``, the axes
    of size 1 dropped: the rows over the batch axes where they divide
    ``batch``, the vocabulary over "model" where it divides V."""
    from ..sharding import rules
    sizes = rules.mesh_sizes(mesh)
    axes = rules.batch_axes(mesh)
    bsize = 1
    for a in axes:
        bsize *= sizes.get(a, 1)
    spec = (axes if batch % bsize == 0 else None,
            "model" if cfg.vocab_size % sizes.get("model", 1) == 0 else None)
    return rules.drop_unit_axes(spec, sizes)


def model_flops(cfg: ArchConfig, shape: ShapeSpec) -> float:
    """MODEL_FLOPS = 6*N*D (dense) / 6*N_active*D (MoE), D = tokens/step."""
    n = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens                  # forward only
    return 2.0 * n * shape.global_batch          # decode: 1 token/seq
