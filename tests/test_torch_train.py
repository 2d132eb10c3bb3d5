"""The port's training path against the JAX package's, on the CPU.

Weights come from the reference's own init (``jax.random.key(0)``), carried
across by ``repro_torch.models.convert``; data from the same seed through
both packages' ``SyntheticLMData`` (byte-equal).  Held here:

- ``models.loss`` and every gradient against ``jax.value_and_grad`` of the
  reference's ``Model.loss`` on the smoke configs (f32) of every family:
  llama3.2-3b, qwen2-vl-7b, falcon-mamba-7b, qwen2-moe-a2.7b (aux loss
  included), jamba-1.5-large-398b and seamless-m4t-large-v2, at 1e-5 x
  max(1, max|g|): the two sum the same f32 products in other orders.  The
  port's attention goes through ``FlashAttention`` (its CPU forward and
  backward are the plain ``attention_lse_ref`` / ``attention_bwd_ref``),
  its scan through ``SelectiveScan`` (``selective_scan_ref`` /
  ``selective_scan_bwd_ref``), and, with ``use_kernel=False``, through
  autograd of ``attention_ref`` and of the plain chunked scan;
- a MoE layer's forward recomputed under ``torch.utils.checkpoint`` routing
  every token as the first forward did;
- ``adamw_update`` and ``cosine_schedule`` against the reference's, the
  decay of per-layer norms and biases (stacked leaves of rank >= 2 in the
  reference) and not of the final norm, leaf by leaf for the Mamba, MoE,
  hybrid and enc-dec families too;
- a 20-step ``Trainer`` history (batch 8, seq 32, ``peak_lr=1e-2``) within
  rtol 1e-4 of the reference ``Trainer``'s; a kill at step 12 resumed from
  the step-10 checkpoint bit-identical to the uninterrupted run (llama3.2-3b
  and jamba-1.5-large-398b, whose smoke config keeps bf16 moments);
  checkpoints kept K and written atomically; a reference checkpoint
  resumed by the port, and a port checkpoint resumed by the reference, each
  continuing the other's loss curve; a bf16 leaf through the ``|V2``
  bytes (the other families' histories and checkpoints:
  ``tests/test_torch_train_families.py``);
- ``python -m repro_torch.launch.train --reduced --device cpu`` with
  ``jax``, ``repro`` and ``ml_dtypes`` blocked, on a dense, the hybrid and
  the enc-dec config.
"""

from __future__ import annotations

import dataclasses
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import restore_checkpoint as jrestore
from repro.checkpoint import save_checkpoint as jsave
from repro.configs.base import smoke_config as jsmoke
from repro.data import SyntheticLMData as JData
from repro.models import build_model as jbuild
from repro.optim import adamw_init as jadamw_init
from repro.optim import adamw_update as jadamw_update
from repro.optim import cosine_schedule as jcosine
from repro.train import TrainState as JTrainState
from repro.train import Trainer as JTrainer
from repro_torch import models
from repro_torch.checkpoint import (latest_checkpoint, restore_checkpoint,
                                    save_checkpoint)
from repro_torch.configs.base import smoke_config as tsmoke
from repro_torch.data import SyntheticLMData
from repro_torch.models import convert
from repro_torch.models.convert import (decayed, params_from_reference,
                                        tree_from_reference,
                                        tree_to_reference)
from repro_torch.optim import adamw_init, adamw_update, cosine_schedule
from repro_torch.train import TrainState, Trainer
from repro_torch.train.loop import to_device

REPO = pathlib.Path(__file__).resolve().parents[1]
ARCH = "llama3.2-3b"
_CACHE = {}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These tests' tensors are far below torch's parallel grain size.
    With several test workers sharing a few cores, torch's idle OpenMP
    threads spinning between ops slowed them tens of times, and the other
    workers with them; one thread runs them faster even alone."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ref_params(name, **over):
    """The reference's init of a smoke config, as numpy, and the port's
    model holding it (trainable, on the CPU)."""
    key = (name, tuple(sorted(over.items())))
    if key not in _CACHE:
        jcfg = dataclasses.replace(jsmoke(name), **over)
        params = jbuild(jcfg).init(jax.random.key(0))
        _CACHE[key] = jax.tree.map(np.asarray, params)
    tree = _CACHE[key]
    tcfg = dataclasses.replace(tsmoke(name), **over)
    return tree, params_from_reference(tree, tcfg, "cpu").requires_grad_(True)


def _batch(cfg, b=2, s=32, seed=3):
    data = SyntheticLMData(cfg.vocab_size, b, s, seed,
                           embed_dim=cfg.d_model if cfg.embed_inputs else 0,
                           encdec=cfg.is_encdec)
    return data.next()


def _close_tree(got, want, tol=1e-5):
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=tol * max(1.0, np.abs(b).max()))


@pytest.mark.parametrize("name,use_kernel", [
    (ARCH, True), (ARCH, False), ("qwen2-vl-7b", True),
    ("falcon-mamba-7b", True), ("falcon-mamba-7b", False),
    ("qwen2-moe-a2.7b", True), ("jamba-1.5-large-398b", True),
    ("seamless-m4t-large-v2", True)])
def test_lm_loss_and_grads_match_reference(name, use_kernel):
    tree, model = _ref_params(name)
    cfg = model.cfg
    batch = _batch(cfg)
    jm = jbuild(jsmoke(name))
    (jloss, jmet), jgrads = jax.value_and_grad(
        lambda p: jm.loss(p, {k: jnp.asarray(v) for k, v in batch.items()}),
        has_aux=True)(jax.tree.map(jnp.asarray, tree))
    loss, met = models.loss(cfg, model, to_device(batch, "cpu"), use_kernel)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(met["ce"].item(), float(jmet["ce"]),
                               rtol=1e-5)
    np.testing.assert_allclose(met["aux"].item(), float(jmet["aux"]),
                               rtol=1e-5, atol=1e-7)
    grads = {n: p.grad for n, p in model.named_parameters()}
    assert all(g is not None for n, g in grads.items() if n != "embed")
    if cfg.embed_inputs and not cfg.is_encdec:  # the embedding is not reached
        assert grads["embed"] is None
        grads["embed"] = torch.zeros_like(model.embed)
    _close_tree(tree_to_reference(model, grads), jgrads)


def test_flash_attention_runs_the_function_under_autograd():
    """The loss goes through ``FlashAttention`` (the Function's backward)
    where autograd records it, and straight to the forward elsewhere."""
    from repro_torch.kernels import flash_attn
    _, model = _ref_params(ARCH)
    batch = to_device(_batch(model.cfg), "cpu")
    seen = []
    real = flash_attn.flash_attention_bwd

    def spy(*a, **kw):
        seen.append(a[0].shape)
        return real(*a, **kw)
    flash_attn.flash_attention_bwd = spy
    try:
        loss, _ = models.loss(model.cfg, model, batch)
        loss.backward()
        with torch.no_grad():
            models.loss(model.cfg, model, batch)
    finally:
        flash_attn.flash_attention_bwd = real
    assert len(seen) == model.cfg.n_layers


def test_moe_recomputed_under_checkpoint_routes_as_the_first_forward():
    """qwen2-moe's smoke model under remat: each period's forward runs once
    in the loss and once more in the backward (the last period first);
    every MoE layer's top-k experts are the same both times."""
    _, model = _ref_params("qwen2-moe-a2.7b")
    cfg = model.cfg
    assert cfg.remat
    batch = to_device(_batch(cfg), "cpu")
    seen = []
    real = torch.topk

    def spy(*a, **kw):
        out = real(*a, **kw)
        seen.append(out.indices.clone())
        return out
    torch.topk = spy
    try:
        loss, _ = models.loss(cfg, model, batch)
        first = len(seen)
        loss.backward()
    finally:
        torch.topk = real
    assert first == cfg.n_layers and len(seen) == 2 * cfg.n_layers
    recomputed = seen[first:][::-1]          # one MoE layer a period
    for a, b in zip(seen[:first], recomputed):
        assert torch.equal(a, b)


def test_adamw_and_schedule_match_reference():
    """qwen2-7b's smoke config has qkv biases: per-layer norm scales and
    biases are decayed (stacked leaves of rank 2), the final norm is not."""
    tree, model = _ref_params("qwen2-7b")
    dec = decayed(model)
    assert dec["layers.0.norm1.scale"] and dec["layers.1.attn.bq"]
    assert dec["embed"] and dec["layers.0.attn.wq"]
    assert not dec["final_norm.scale"]
    rng = np.random.default_rng(5)
    jgrads = jax.tree.map(
        lambda a: rng.normal(size=a.shape).astype(np.float32) * 0.1, tree)
    jgrads["final_norm"]["scale"][:] = 0.0
    for layer in jgrads["positions"][0].values():   # norms decay on their own
        if "scale" in layer:
            layer["scale"][:] = 0.0
    jparams = jax.tree.map(jnp.asarray, tree)
    jopt = jadamw_init(jparams)
    params = dict(model.named_parameters())
    opt = adamw_init(params)
    for step in range(3):
        lr = float(jcosine(jnp.int32(step), peak_lr=1e-2, warmup=2,
                           total=10))
        assert cosine_schedule(step, peak_lr=1e-2, warmup=2,
                               total=10) == pytest.approx(lr, rel=1e-6)
        grads = tree_from_reference(model, jgrads)
        opt, met = adamw_update(grads, opt, params, lr, decayed=dec)
        jparams, jopt, jmet = jadamw_update(
            jax.tree.map(jnp.asarray, jgrads), jopt, jparams, lr)
        np.testing.assert_allclose(met["grad_norm"].item(),
                                   float(jmet["grad_norm"]), rtol=1e-5)
    assert opt.count == int(jopt.count) == 3
    _close_tree(tree_to_reference(model, params), jparams, 1e-6)
    _close_tree(tree_to_reference(model, opt.mu), jopt.mu, 1e-6)
    _close_tree(tree_to_reference(model, opt.nu), jopt.nu, 1e-6)
    before = np.ones(model.cfg.d_model, np.float32)
    assert np.array_equal(params["final_norm.scale"].detach().numpy(),
                          before)                        # no decay, no grad
    assert not np.array_equal(params["layers.0.norm1.scale"].detach()
                              .numpy(), before)          # decayed
    for step in (0, 1, 99, 100, 101, 5000, 9999, 10000, 20000):
        assert cosine_schedule(step, peak_lr=3e-4) == pytest.approx(
            float(jcosine(jnp.int32(step), peak_lr=3e-4)), rel=1e-6)


@pytest.mark.parametrize("name", ["falcon-mamba-7b", "qwen2-moe-a2.7b",
                                  "jamba-1.5-large-398b",
                                  "seamless-m4t-large-v2"])
def test_decay_follows_the_reference_leaves(name):
    """AdamW decays exactly the leaves the reference's decays: ``p.ndim >=
    2`` on its stacked leaves, so every per-layer Mamba, MoE, encoder and
    decoder leaf (``A_log``, ``D``, ``dt_b``, ``conv_b``, the router, the
    experts, norms) and not the final norms."""
    tree, model = _ref_params(name)
    dec = decayed(model)
    layout = convert.reference_layout(model)
    for pname in dec:
        leaf = tree
        for key in layout[pname][0]:
            leaf = leaf[key]
        assert dec[pname] == (np.ndim(leaf) >= 2), pname
    assert not dec["final_norm.scale"]
    assert all(dec[n] for n in dec if n.startswith(("layers.", "encoder.",
                                                     "decoder.")))


@pytest.mark.parametrize("embed_dim,encdec", [(0, False), (64, False),
                                              (64, True)])
def test_synthetic_data_is_byte_equal(embed_dim, encdec):
    a = JData(256, 4, 16, seed=7, embed_dim=embed_dim, encdec=encdec)
    b = SyntheticLMData(256, 4, 16, seed=7, embed_dim=embed_dim,
                        encdec=encdec)
    for _ in range(3):
        x, y = a.next(), b.next()
        assert list(x) == list(y)
        for k in x:
            assert x[k].dtype == y[k].dtype and x[k].tobytes() == \
                y[k].tobytes()
    assert a.state_dict() == b.state_dict()


def _trainer(tmp=None, cls=Trainer, name=ARCH, over=(), **kw):
    """A smoke-config trainer of the port (on the CPU) or, with ``cls``, of
    the reference; ``over`` replaces config fields on both."""
    if cls is Trainer:
        kw["device"] = "cpu"
        cfg = tsmoke(name)
    else:
        cfg = jsmoke(name)
    cfg = dataclasses.replace(cfg, **dict(over))
    return cls(cfg=cfg, batch=8, seq_len=32,
               ckpt_dir=str(tmp) if tmp else None, ckpt_every=5,
               peak_lr=1e-2, **kw)


def _from_reference_init(tr, name=ARCH, over=()):
    """The port trainer's state on the reference's init (seed 0)."""
    _, model = _ref_params(name, **dict(over))
    return TrainState(model, adamw_init(dict(model.named_parameters()),
                                        model.cfg.adam_dtype), 0)


@pytest.fixture(scope="module")
def reference_history():
    tr = _trainer(cls=JTrainer)
    tr.run(20)
    return tr.history


def test_trainer_history_matches_reference(reference_history):
    tr = _trainer()
    tr.run(20, state=_from_reference_init(tr))
    np.testing.assert_allclose(tr.history, reference_history, rtol=1e-4)
    assert tr.history[-1] < tr.history[0]


@pytest.mark.parametrize("name", [ARCH, "jamba-1.5-large-398b"])
def test_kill_and_resume_is_bit_identical(tmp_path, name):
    """jamba's smoke config keeps bf16 moments: they cross the checkpoint
    as bits."""
    tr_a = _trainer(tmp_path / "a", name=name)
    tr_a.run(20)
    tr_b = _trainer(tmp_path / "b", name=name)
    with pytest.raises(RuntimeError, match="injected failure"):
        tr_b.run(20, die_at=12)
    tr_b2 = _trainer(tmp_path / "b", name=name)
    state = tr_b2.resume_or_init()
    assert int(state.step) == 10 and tr_b2.data.step == 10
    tr_b2.run(10, state=state)
    assert tr_b2.history == tr_a.history[10:20]


def test_checkpoint_keep_k_and_atomicity(tmp_path):
    tr = _trainer(tmp_path / "k")
    tr.run(20)                                       # ckpts at 5, ..., 20
    assert sorted(os.listdir(tmp_path / "k")) == [
        "step_10.npz", "step_15.npz", "step_20.npz"]
    tr2 = _trainer(tmp_path / "t")
    state = tr2.init_state()
    save_checkpoint(str(tmp_path / "t"), 5, state, keep=3)
    (tmp_path / "t" / "step_99.tmp").write_bytes(b"garbage")  # torn write
    path = latest_checkpoint(str(tmp_path / "t"))
    assert path.endswith("step_5.npz")
    want = {n: p.detach().clone() for n, p in state.model.named_parameters()}
    with torch.no_grad():
        for p in state.model.parameters():
            p.add_(1.0)
    restored, extra = restore_checkpoint(path, state)
    assert extra is None and restored.step == 0
    for n, p in restored.model.named_parameters():
        assert torch.equal(p, want[n]), n


def test_reference_checkpoint_resumes_in_the_port(tmp_path,
                                                  reference_history):
    jtr = _trainer(tmp_path, cls=JTrainer)
    jtr.run(10)                                      # ckpts at 5 and 10
    tr = _trainer(tmp_path)
    state = tr.resume_or_init()
    assert state.step == 10 and state.opt.count == 10
    assert tr.data.step == 10
    tr.run(10, state=state)
    np.testing.assert_allclose(tr.history, reference_history[10:20],
                               rtol=1e-4)


def test_port_checkpoint_resumes_in_the_reference(tmp_path,
                                                  reference_history):
    tr = _trainer(tmp_path)
    tr.run(10, state=_from_reference_init(tr))
    np.testing.assert_allclose(tr.history, reference_history[:10],
                               rtol=1e-4)
    jtr = _trainer(tmp_path, cls=JTrainer)
    restored, extra = jrestore(latest_checkpoint(str(tmp_path)),
                               jtr.init_state())
    assert extra == {"data": {"step": 10, "seed": 0}}
    assert int(restored.opt.count) == 10
    _close_tree(restored.params, tree_to_reference(
        tr.model, dict(tr.model.named_parameters())), 0.0)
    state = jtr.resume_or_init()
    assert int(state.step) == 10 and jtr.data.step == 10
    jtr.run(10, state=state)
    np.testing.assert_allclose(jtr.history, reference_history[10:20],
                               rtol=1e-4)


def test_bf16_leaves_cross_as_v2_bytes(tmp_path):
    """A bf16 state is written as the reference writes it (``|V2`` records
    of the bf16 bits, the same keys in the same order, byte-equal arrays)
    and read back bit for bit."""
    over = dict(param_dtype="bfloat16", compute_dtype="bfloat16")
    tree, model = _ref_params(ARCH, **over)
    opt = adamw_init(dict(model.named_parameters()))
    state = TrainState(model, opt, 3)
    save_checkpoint(str(tmp_path / "port"), 3, state)
    jparams = jax.tree.map(jnp.asarray, tree)
    jsave(str(tmp_path / "ref"), 3, JTrainState(
        jparams, jadamw_init(jparams), jnp.int32(3)))
    got = np.load(tmp_path / "port" / "step_3.npz")
    want = np.load(tmp_path / "ref" / "step_3.npz")
    assert list(got.keys()) == list(want.keys())
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == \
            want[k].shape and got[k].tobytes() == want[k].tobytes(), k
    assert got["params/embed"].dtype.str == "|V2"
    want_params = {n: p.detach().clone() for n, p in model.named_parameters()}
    with torch.no_grad():
        for p in model.parameters():
            p.zero_()
    restored, _ = restore_checkpoint(str(tmp_path / "ref" / "step_3.npz"),
                                     state)
    assert restored.step == 3
    for n, p in model.named_parameters():
        assert p.dtype == torch.bfloat16 and torch.equal(p, want_params[n])


_BLOCKED = """
import sys
sys.modules["jax"] = None
sys.modules["repro"] = None
sys.modules["ml_dtypes"] = None
import runpy
sys.argv = ["repro_torch.launch.train"] + sys.argv[1:]
try:
    runpy.run_module("repro_torch.launch.train", run_name="__main__")
finally:
    assert not any(m == "jax" or m.startswith(("jax.", "repro."))
                   for m in sys.modules if sys.modules[m] is not None)
"""


@pytest.mark.parametrize("name", [ARCH, "jamba-1.5-large-398b",
                                  "seamless-m4t-large-v2"])
def test_launch_train_runs_with_jax_and_repro_blocked(tmp_path, name):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    res = subprocess.run(
        [sys.executable, "-c", _BLOCKED, "--arch", name, "--reduced",
         "--device", "cpu", "--steps", "6", "--batch", "2", "--seq-len",
         "16", "--ckpt-dir", str(tmp_path), "--ckpt-every", "3"],
        env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert res.stdout.startswith(f"training {name} (")
    assert "steps=6 loss " in res.stdout
    assert sorted(os.listdir(tmp_path)) == ["step_3.npz", "step_6.npz"]
