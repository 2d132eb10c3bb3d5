"""The port's sharding rules (``repro_torch.sharding``) against the JAX
package's ``repro.sharding.rules``, on the CPU, with no devices.

For every architecture in ``archs.ALL`` on both production meshes
(``AbstractMesh((16, 16), ("data", "model"))`` and its pod form (2, 16,
16), in jax 0.9's signature; ``tests/test_sharding.py`` uses the older one,
which is why that test fails here):

* every parameter's spec and every moment's (ZeRO-1) spec equal to the
  reference's spec of the parameter's leaf with the stacked axis dropped
  (the port keeps per-layer tensors where the reference stacks them over
  periods: ``models/convert.py::reference_layout``), at full size: the
  reference's shapes from ``jax.eval_shape`` of its init, the port's from
  ``sharding.abstract_model`` (its model under ``FakeTensorMode``);
* the decode caches' specs (stacked in both packages) equal, for every
  shape of ``shapes_for(cfg)``, and the batches' specs;
* the reference's own cases: the big weights shard over "model", ZeRO-1
  moments pick up "data", the 500k cache shards its sequence;
* a spec's DTensor placements.
"""

from __future__ import annotations

import types

import jax
import pytest
import torch
from jax.sharding import AbstractMesh
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import Replicate, Shard

from repro import sharding as rsh
from repro.configs import archs
from repro.configs.base import SHAPES, get_arch as jget_arch, shapes_for
from repro.models import build_model as jbuild
from repro_torch import models as tmodels
from repro_torch import sharding as tsh
from repro_torch.configs.base import get_arch
from repro_torch.models.convert import reference_layout

MESHES = {
    "single": (AbstractMesh((16, 16), ("data", "model")),
               {"data": 16, "model": 16}),
    "multi": (AbstractMesh((2, 16, 16), ("pod", "data", "model")),
              {"pod": 2, "data": 16, "model": 16}),
}
_REF, _PORT = {}, {}


def _ref(arch):
    """The reference's model and its abstract parameters at full size."""
    if arch not in _REF:
        m = jbuild(jget_arch(arch))
        _REF[arch] = (m, jax.eval_shape(lambda: m.init(jax.random.key(0))))
    return _REF[arch]


def _port(arch):
    if arch not in _PORT:
        _PORT[arch] = tsh.abstract_model(get_arch(arch))
    return _PORT[arch]


def _leaf(tree, path):
    for key in path:
        tree = tree[key]
    return tree


def _dropped(model, ref_specs):
    """{port parameter: the reference's spec of its leaf, the stacked axis
    dropped}."""
    return {name: tuple(_leaf(ref_specs, path))[0 if per is None else 1:]
            for name, (path, per) in reference_layout(model).items()}


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", archs.ALL)
def test_param_and_opt_specs_are_the_references(arch, mesh_name):
    jmesh, sizes = MESHES[mesh_name]
    cfg, jcfg = get_arch(arch), jget_arch(arch)
    _, psds = _ref(arch)
    model = _port(arch)
    pspecs = rsh.param_specs(jcfg, psds, jmesh)
    mspecs = rsh.opt_specs(jcfg, pspecs, psds, jmesh)
    got_p = tsh.param_specs(cfg, model, sizes)
    got_m = tsh.opt_specs(cfg, got_p, model, sizes)
    assert got_p == _dropped(model, pspecs)
    assert got_m == _dropped(model, mspecs)
    # each spec fits its tensor: sharded dims divisible by the axes
    params = dict(model.named_parameters())
    for specs in (got_p, got_m):
        for name, spec in specs.items():
            shape = params[name].shape
            assert len(spec) == len(shape), name
            for d, entry in enumerate(spec):
                axes = entry if isinstance(entry, tuple) else (entry,)
                n = 1
                for a in axes:
                    n *= sizes.get(a, 1) if a else 1
                assert shape[d] % n == 0, (name, spec)


def _port_cache(arch, b, s):
    cfg = get_arch(arch)
    with FakeTensorMode():
        return tmodels.init_cache(cfg, _port(arch), b, s, s)


def _spec_tree(specs):
    """A reference spec tree as plain tuples, lists and dicts."""
    if isinstance(specs, dict):
        return {k: _spec_tree(v) for k, v in specs.items()}
    if isinstance(specs, list):
        return [_spec_tree(v) for v in specs]
    return tuple(specs)


@pytest.mark.parametrize("arch", archs.ALL)
def test_cache_and_batch_specs_are_the_references(arch):
    cfg, jcfg = get_arch(arch), jget_arch(arch)
    jm, _ = _ref(arch)
    for mesh_name, (jmesh, sizes) in MESHES.items():
        for shape_name in shapes_for(jcfg):
            shape = SHAPES[shape_name]
            b, s = shape.global_batch, shape.seq_len
            csds = jax.eval_shape(lambda: jm.init_cache(b, s, s))
            want = jax.tree.map(tuple, rsh.cache_specs(jcfg, csds, jmesh),
                                is_leaf=lambda x: isinstance(
                                    x, jax.sharding.PartitionSpec))
            got = tsh.cache_specs(cfg, _port_cache(arch, b, s), sizes)
            assert got == _spec_tree(want), (mesh_name, shape_name)
            fields = {"tokens": (b, s), "labels": (b, s)}
            if cfg.embed_inputs:
                fields["embeds"] = (b, s, cfg.d_model)
            jb = {k: jax.ShapeDtypeStruct(v, jax.numpy.float32)
                  for k, v in fields.items()}
            tb = {k: torch.empty(v, device="meta") for k, v in fields.items()}
            want_b = {k: tuple(v) for k, v in
                      rsh.batch_specs(jcfg, jb, jmesh).items()}
            assert tsh.batch_specs(cfg, tb, sizes) == want_b


@pytest.mark.parametrize("case", ["model_axis_used", "zero1_data_axis",
                                  "long500k_sequence"])
def test_reference_cases(case):
    sizes = MESHES["single"][1]
    if case == "long500k_sequence":
        arch = "jamba-1.5-large-398b"
        specs = tsh.cache_specs(get_arch(arch),
                                _port_cache(arch, 1, 524_288), sizes)
        kv = [v for entry in specs["layers"] for v in entry.values()
              if len(v) == 5]
        assert kv and all(v[2] == "data" for v in kv), kv
        return
    cfg = get_arch("qwen2-7b")
    model = _port("qwen2-7b")
    pspecs = tsh.param_specs(cfg, model, sizes)
    if case == "model_axis_used":
        assert "model" in pspecs["embed"]
        mlp = [s for k, s in pspecs.items() if ".mlp." in k]
        assert mlp and all("model" in s for s in mlp)
    else:
        assert not cfg.fsdp
        mspecs = tsh.opt_specs(cfg, pspecs, model, sizes)
        n_data = sum("data" in s for s in mspecs.values())
        assert n_data > len(mspecs) * 0.5, (n_data, len(mspecs))


def test_placements_of_a_spec():
    mesh = types.SimpleNamespace(mesh_dim_names=("pod", "data", "model"))
    assert tsh.placements((("pod", "data"), None, "model"), mesh) == [
        Shard(0), Shard(0), Shard(2)]
    assert tsh.placements((None, None), mesh) == [Replicate()] * 3
    assert tsh.placements(("model", "data"), mesh) == [
        Replicate(), Shard(1), Shard(0)]
    with pytest.raises(ValueError, match="order"):
        tsh.placements((("data", "pod"),), mesh)
