"""Elastic scaling: re-plan the mesh when the world grows or shrinks.

Port of ``repro.distributed.elastic``.  Failure model: a training fleet
loses a host/pod (512 -> 448 chips) or gains one back.  Checkpoints are
sharding-agnostic (checkpoint/ckpt.py), so elasticity is a *planning*
problem:

  1. ``plan_mesh`` picks the best (pod, data, model) shape for the surviving
     device count under the architecture's divisibility constraints (model
     axis must divide flattened head and ff dims; batch axis should divide
     the global batch).  Devices that do not fit the factorization are left
     idle (reported in the plan) — correctness first, then utilization.
  2. ``rescale_tree`` places a host tree on the new mesh as DTensors, each
     rank holding the slice that the reference's ``NamedSharding`` gives its
     device (reshard-on-load).

The planner is pure Python, copied (``ElasticPlan``, ``plan_mesh``,
``degrade_sequence``); the mesh is a ``torch.distributed`` ``DeviceMesh``
with the plan's axis names, over the default process group's first
``n_used`` ranks.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..configs.base import ArchConfig


@dataclasses.dataclass(frozen=True)
class ElasticPlan:
    mesh_shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]
    n_used: int
    n_idle: int
    model_axis: int
    data_axis: int
    n_pods: int

    @property
    def utilization(self) -> float:
        return self.n_used / (self.n_used + self.n_idle)


def _model_axis_candidates(cfg: ArchConfig, limit: int) -> List[int]:
    """Model-axis sizes that evenly shard this architecture, descending.

    The flattened q-heads dim (n_heads*hd), kv dim (n_kv_heads*hd), d_ff and
    vocab must all divide; MoE prefers expert-count divisibility.
    """
    dims = [cfg.d_ff or cfg.d_model, cfg.vocab_size]
    if cfg.n_heads:                       # attn-free archs have no heads dim
        dims.append(cfg.n_heads * cfg.hd)
    if cfg.moe is not None:
        dims.append(cfg.moe.n_experts * max(cfg.moe.d_ff, 1))
    if cfg.ssm is not None:
        dims.append(cfg.ssm.expand * cfg.d_model)
    out = []
    for m in range(limit, 0, -1):
        if all(d % m == 0 for d in dims if d):
            out.append(m)
    return out


def plan_mesh(n_devices: int, cfg: ArchConfig, *,
              global_batch: Optional[int] = None,
              prefer_model: int = 16,
              pod_size: int = 256) -> ElasticPlan:
    """Choose (pod, data, model) for ``n_devices`` surviving chips.

    Strategy: keep the model axis as close to ``prefer_model`` as the arch
    allows; then fill pods of ``pod_size``; leftovers become a ragged final
    pod folded into the data axis; devices beyond the best factorization
    stay idle.  Never returns a zero-sized axis.
    """
    assert n_devices >= 1
    cands = _model_axis_candidates(cfg, min(prefer_model, n_devices))
    best: Optional[ElasticPlan] = None
    for m in cands or [1]:
        usable = (n_devices // m) * m
        if usable == 0:
            continue
        d_total = usable // m                       # total data-parallel ways
        if global_batch is not None:
            # shrink until the batch divides (data axis must divide batch)
            while d_total > 1 and global_batch % d_total != 0:
                d_total -= 1
            usable = d_total * m
        n_pods = max(1, usable // (pod_size))
        if usable % pod_size != 0:
            n_pods = 1                              # ragged -> single flat pod
        d_per_pod = d_total // n_pods
        if d_per_pod * n_pods != d_total:
            n_pods, d_per_pod = 1, d_total
        plan = ElasticPlan(
            mesh_shape=((n_pods, d_per_pod, m) if n_pods > 1
                        else (d_per_pod, m)),
            axis_names=(("pod", "data", "model") if n_pods > 1
                        else ("data", "model")),
            n_used=usable, n_idle=n_devices - usable,
            model_axis=m, data_axis=d_per_pod, n_pods=n_pods)
        score = (plan.n_used, -abs(m - prefer_model))
        if best is None or score > (best.n_used,
                                    -abs(best.model_axis - prefer_model)):
            best = plan
    assert best is not None
    return best


def make_mesh(shape: Sequence[int], axis_names: Sequence[str],
              device_type: str = "cuda"):
    """A ``DeviceMesh`` of ``shape`` named ``axis_names``:
    ``init_device_mesh`` where the default group's world is the mesh's size,
    else a mesh over its first ranks (the others hold no part of it).  The
    default process group must be initialised."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
    shape, axis_names = tuple(shape), tuple(axis_names)
    n = math.prod(shape)
    world = dist.get_world_size()
    if world == n:
        return init_device_mesh(device_type, shape, mesh_dim_names=axis_names)
    if world < n:
        raise ValueError(f"a {shape} mesh uses {n} ranks, the world has "
                         f"{world}")
    ranks = torch.arange(n).reshape(shape)
    return DeviceMesh(device_type, ranks, mesh_dim_names=axis_names)


def make_mesh_from_plan(plan: ElasticPlan, device_type: str = "cuda"):
    """A ``DeviceMesh`` of ``plan.mesh_shape`` named ``plan.axis_names``
    (:func:`make_mesh`; the plan's idle ranks hold no part of it)."""
    return make_mesh(plan.mesh_shape, plan.axis_names, device_type)


def rescale_tree(host_tree: Dict[str, Any], spec_tree: Dict[str, Any],
                 mesh) -> Dict[str, Any]:
    """Each leaf of ``host_tree`` (numpy or tensor, every rank holding the
    whole) as a DTensor on ``mesh`` under its spec in ``spec_tree`` (the
    sharding rules' tuples of axis names against the NEW mesh:
    ``sharding.rules``): each rank keeps the slice the reference's
    ``NamedSharding(mesh, spec)`` gives its device.  This is the elastic
    reshard-on-load step — the checkpoint never knew the old mesh."""
    from torch.distributed.tensor import distribute_tensor

    from ..sharding.rules import placements
    out = {}
    for k, spec in spec_tree.items():
        x = host_tree[k]
        t = x if isinstance(x, torch.Tensor) else torch.from_numpy(
            np.ascontiguousarray(x))
        out[k] = distribute_tensor(t.to(mesh.device_type), mesh,
                                   placements(spec, mesh))
    return out


def degrade_sequence(n_start: int, failures: Sequence[int]) -> List[int]:
    """World sizes after successive failure events (for tests/benchmarks)."""
    out, n = [], n_start
    for f in failures:
        n = max(1, n - f)
        out.append(n)
    return out
