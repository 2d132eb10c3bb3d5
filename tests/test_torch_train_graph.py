"""The port's compiled train step (``repro_torch.train.graphs``), AdamW's
kernels (``repro_torch.kernels.adamw``) and ``remat_policy="dots"``.

On the CPU (smoke configs; the reference's init carried across by
``repro_torch.models.convert``):

* AdamW over the smoke models' whole trees against the reference's
  ``adamw_update``, 3 steps of fixed random gradients (each from the
  reference's state after the step before), with one tensor's
  gradient missing (a zero gradient, nothing allocated), for each
  (parameter, moment) dtype pair the kernels take and a tree that mixes
  them: the plain version with
  its 0-d tensor hyperparameters (the wrapper on CPU tensors), and the
  kernels' arithmetic emulated in torch (their norm: f64 sums of each chunk
  of ``CHUNK`` elements into the partial of block chunk % ``NORM_BLOCKS``,
  the partials summed in order; then the plain version's per-element
  operations, which are the kernels' own, one rounding each, in the same
  order).  Held: the norm within 1e-7 relative of the exact (f64) sum of
  the same squares (one rounding to f32) and within 1e-5 of the
  reference's (its f32 sums are off the exact one by up to 1.5e-6 on
  these trees); the moments within 1e-6 x max(1, max|m|); the parameters
  within one ulp of their dtype at the update's operands, max(max|p|,
  max|lr (u + wd p)|) over the tensor (XLA rounds ``p - lr (u + wd p)``
  otherwise in a few elements, and an update that nearly cancels a
  parameter leaves that rounding in a small result);
* ``Trainer(compile=True, device="cpu")`` raises, ``"auto"`` is eager, and
  its history matches the reference ``Trainer``'s as
  ``test_torch_train.py::test_trainer_history_matches_reference`` holds it;
* the trainer's graph path with ``TrainGraph`` replaced by an eager
  emulation of a replay on static buffers (a static batch, ``hyper`` and
  outputs that every replay overwrites): bit-equal to the eager run over 4
  steps (2 warm-up steps, a capture, replays), and across a kill and
  resume (the graph captured again for the resumed model);
* ``remat_policy="dots"``: the step-0 loss and every gradient against the
  reference's with ``dots``, at ``test_lm_loss_and_grads_match_reference``'s
  1e-5 x max(1, max|g|), and bit-equal to the port's full remat; its
  backward runs the aten ``mm``/``addmm`` calls of the step without remat
  (the periods' weight products saved, not recomputed), fewer than full
  remat's, and full remat's other operations (the rest recomputed).

On the card (marked ``cuda``; JAX is imported only inside the CPU tests'
helpers, so they run on a machine without it: ``python -m pytest -q -m cuda
tests/test_torch_train_graph.py``): the kernels against the plain version
for every dtype pair and a tree that mixes them, ragged numel, a zero
gradient and a misaligned one;
the captured step against the eager step, bit-equal, at smoke width for
the dense, MoE, Mamba, hybrid and enc-dec families.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import models
from repro_torch.configs.base import smoke_config as tsmoke
from repro_torch.kernels import adamw as kadamw
from repro_torch.models import lm
from repro_torch.optim import adamw_init
from repro_torch.optim.adamw import hyper_values
from repro_torch.train import Trainer
from repro_torch.train import graphs as train_graphs
from repro_torch.train import loop as train_loop
from repro_torch.train.loop import to_device

ARCH = "llama3.2-3b"
BF16 = dict(param_dtype="bfloat16", compute_dtype="bfloat16")
# (arch, config overrides): the (parameter, moment) pairs (f32, f32),
# (bf16, f32), (f32, bf16) (jamba's smoke config keeps bf16 moments) and
# (bf16, bf16), and a tree that mixes them (falcon-mamba keeps A_log and D
# in f32 beside bf16 weights)
PAIRS = [(ARCH, {}), (ARCH, BF16), ("jamba-1.5-large-398b", {}),
         ("jamba-1.5-large-398b", BF16), ("falcon-mamba-7b", BF16)]
# the tensor whose gradient is missing in the AdamW cases
NO_GRAD = "layers.0.norm2.scale"
# the kernels' chunk and norm blocks (csrc/adamw.cu)
CHUNK, NORM_BLOCKS = 8192, 1024


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ref_params(name, **over):
    from test_torch_train import _ref_params as ref_params
    return ref_params(name, **over)


def _grads(model, norm=0.5, seed=5):
    """Random gradients in each parameter's dtype, one missing, of global
    norm about ``norm``."""
    rng = np.random.default_rng(seed)
    raw = {n: rng.normal(size=tuple(p.shape)).astype(np.float32)
           for n, p in model.named_parameters()}
    k = norm / np.sqrt(sum(np.sum(np.square(g, dtype=np.float64))
                           for g in raw.values()))
    return {n: None if n == NO_GRAD else
            torch.from_numpy(g * np.float32(k)).to(p.dtype)
            for (n, g), p in zip(raw.items(), model.parameters())}


def _emulated_norm(grads):
    """The kernels' norm: each chunk's f64 sum of squares into its block's
    partial, the partials summed in order, the root rounded to f32."""
    partials = torch.zeros(NORM_BLOCKS, dtype=torch.float64)
    chunk = 0
    for g in grads:
        if g is None:
            continue
        flat = g.reshape(-1).to(torch.float64)
        for c0 in range(0, flat.numel(), CHUNK):
            partials[chunk % NORM_BLOCKS] += torch.sum(
                torch.square(flat[c0:c0 + CHUNK]))
            chunk += 1
    total = torch.zeros((), dtype=torch.float64)
    for x in partials:
        total = total + x
    return torch.sqrt(total).to(torch.float32)


def _emulated_step(params, grads, mus, nus, decayed, hyper, **kw):
    gnorm = _emulated_norm(grads)
    scale = kadamw.clip_scale_ref(gnorm, 1.0)
    for p, g, m, v, dec in zip(params, grads, mus, nus, decayed):
        p32, m32, v32 = kadamw.update_ref(
            p, g, m, v, scale, hyper[0], hyper[1], hyper[2], b1=0.9, b2=0.95,
            eps=1e-8, wd=0.1 if dec else 0.0)
        with torch.no_grad():
            p.copy_(p32)
            m.copy_(m32)
            v.copy_(v32)
    return gnorm


def _ulp(x: float, dtype) -> float:
    """One ulp of ``dtype`` at |x|."""
    a = np.float32(abs(x))
    if dtype == torch.float32:
        return float(np.spacing(a))
    return 2.0 ** (np.floor(np.log2(max(a, 2.0**-126))) - 7)


def _f32_leaves(tree):
    import jax
    return [np.asarray(x).astype(np.float32) for x in jax.tree.leaves(tree)]


@pytest.mark.parametrize("how", ["plain", "emulated"])
@pytest.mark.parametrize("name,over", PAIRS)
def test_adamw_matches_reference(name, over, how):
    import jax
    import jax.numpy as jnp

    from repro.optim import adamw_init as jadamw_init
    from repro.optim import adamw_update as jadamw_update
    from repro_torch.models.convert import (decayed, tree_from_reference,
                                            tree_to_reference)
    tree, model = _ref_params(name, **over)
    cfg = model.cfg
    params = dict(model.named_parameters())
    opt = adamw_init(params, cfg.adam_dtype)
    assert all((p.dtype, opt.mu[n].dtype) in kadamw.PAIRS
               for n, p in params.items())
    grads = _grads(model)
    f32 = lambda t: t.detach().float().numpy()
    jgrads = tree_to_reference(model, {
        n: torch.zeros_like(p, dtype=torch.float32) if grads[n] is None
        else grads[n].float() for n, p in params.items()}, f32)
    jparams = jax.tree.map(jnp.asarray, tree)
    jgrads = jax.tree.map(lambda g, p: jnp.asarray(g).astype(p.dtype),
                          jgrads, jparams)
    jopt = jadamw_init(jparams, cfg.adam_dtype)
    dec = decayed(model)
    names = list(params)
    step = kadamw.adamw_step if how == "plain" else _emulated_step
    for count in range(1, 4):                   # each step from one state
        for mine, ref in ((params, jparams), (opt.mu, jopt.mu),
                          (opt.nu, jopt.nu)):
            with torch.no_grad():
                for n, t in tree_from_reference(model, jax.tree.map(
                        np.asarray, ref)).items():
                    mine[n].copy_(t)
        lr = 1e-2 * count / 3
        p_before = _f32_leaves(jparams)
        exact = np.sqrt(sum(np.sum(np.square(g.double().numpy()))
                            for g in grads.values() if g is not None))
        before = kadamw.LAUNCHES["adamw"]
        gnorm = step([params[n] for n in names], [grads[n] for n in names],
                     [opt.mu[n] for n in names], [opt.nu[n] for n in names],
                     [dec[n] for n in names],
                     torch.tensor(hyper_values(count, lr)))
        assert kadamw.LAUNCHES["adamw"] == before      # plain: no launch
        jparams, jopt, jmet = jadamw_update(jgrads, jopt, jparams, lr)
        want = float(jmet["grad_norm"])
        assert abs(gnorm.item() - exact) <= 1e-7 * exact
        assert abs(gnorm.item() - want) <= 1e-5 * want, (gnorm.item(), want)
        got_p = _f32_leaves(tree_to_reference(model, params, f32))
        dts = [torch.float32 if np.asarray(x).dtype == np.float32
               else torch.bfloat16 for x in jax.tree.leaves(jparams)]
        for got, want, p0, dt in zip(got_p, _f32_leaves(jparams), p_before,
                                     dts):
            assert got.shape == want.shape
            tol = _ulp(max(np.abs(p0).max(), np.abs(p0 - want).max()), dt)
            assert np.abs(got - want).max() <= tol, (
                count, np.abs(got - want).max(), tol)
        for mine, ref in ((opt.mu, jopt.mu), (opt.nu, jopt.nu)):
            for got, want in zip(_f32_leaves(tree_to_reference(model, mine,
                                                               f32)),
                                 _f32_leaves(ref)):
                np.testing.assert_allclose(
                    got, want, rtol=0,
                    atol=1e-6 * max(1.0, np.abs(want).max()))
    # the tensor without a gradient moved by its decay alone: m, v stay 0
    assert not opt.mu[NO_GRAD].any() and not opt.nu[NO_GRAD].any()


def test_plain_version_refuses_what_the_kernels_refuse():
    p = torch.zeros(4)
    hyper = torch.tensor(hyper_values(1, 1e-3))
    with pytest.raises(TypeError, match="dtypes"):
        kadamw.adamw_step([p], [None], [torch.zeros(4, dtype=torch.float16)],
                          [torch.zeros(4, dtype=torch.float16)], [True],
                          hyper)
    with pytest.raises(ValueError, match="shapes"):
        kadamw.adamw_step([p], [torch.zeros(5)], [torch.zeros(4)],
                          [torch.zeros(4)], [True], hyper)
    with pytest.raises(ValueError, match="hyper"):
        kadamw.adamw_step([p], [None], [torch.zeros(4)], [torch.zeros(4)],
                          [True], hyper[:2])
    with pytest.raises(ValueError, match="one length"):
        kadamw.adamw_step([p], [], [torch.zeros(4)], [torch.zeros(4)],
                          [True], hyper)


# ------------------------------------------------------------ the trainer
def _trainer(name=ARCH, tmp=None, **kw):
    return Trainer(cfg=tsmoke(name), batch=8, seq_len=32, peak_lr=1e-2,
                   device="cpu", ckpt_dir=str(tmp) if tmp else None,
                   ckpt_every=2, **kw)


def test_compile_true_raises_and_auto_is_eager_on_the_cpu():
    with pytest.raises(ValueError, match="compile=True needs a CUDA"):
        _trainer(compile=True)
    with pytest.raises(ValueError, match="compile must be"):
        _trainer(compile="yes")
    with pytest.raises(ValueError, match="needs a CUDA device"):
        tr = _trainer(compile=False)
        state = tr.init_state()
        train_graphs.TrainGraph(state.model, state.opt.mu, None, {})
    tr = _trainer()
    assert tr.compiled is False
    tr.run(3)
    assert tr.graph is None and tr.replayed == [False] * 3


def test_auto_trainer_history_matches_reference():
    """The CPU ``Trainer`` with ``compile="auto"`` (eager) against the JAX
    ``Trainer``, as ``test_trainer_history_matches_reference`` holds it."""
    from test_torch_train import JTrainer, _from_reference_init
    from test_torch_train import _trainer as both_trainer
    jtr = both_trainer(cls=JTrainer)
    jtr.run(20)
    tr = both_trainer(compile="auto")
    tr.run(20, state=_from_reference_init(tr))
    np.testing.assert_allclose(tr.history, jtr.history, rtol=1e-4)


class _EmulatedGraph:
    """``TrainGraph``'s interface on the CPU: static batch, ``hyper`` and
    output buffers, and a replay that runs the step's body on them and
    overwrites the outputs in place."""

    made = []

    def __init__(self, model, opt_mu, body, batch):
        self.model, self.opt_mu, self.body = model, opt_mu, body
        self.batch = {k: torch.zeros_like(v) for k, v in batch.items()}
        self.hyper = torch.full((3,), float("nan"))
        self.metrics = None
        self.launches, self.peak_bytes, self.capture_ms = {}, 0, 0.0
        self.replays = 0
        _EmulatedGraph.made.append(self)

    def owns(self, model, opt_mu):
        return self.model is model and self.opt_mu is opt_mu

    def replay(self, batch, hyper):
        for k, v in batch.items():
            self.batch[k].copy_(v)
        self.hyper.copy_(torch.tensor(hyper, dtype=torch.float32))
        out = self.body(self.batch, self.hyper)
        if self.metrics is None:
            self.metrics = {k: v.clone() for k, v in out.items()}
        else:
            for k, v in out.items():
                self.metrics[k].copy_(v)
        self.replays += 1
        return self.metrics


@pytest.fixture
def emulated_graphs(monkeypatch):
    monkeypatch.setattr(train_loop, "resolve_compile",
                        lambda c, d: c is not False)
    monkeypatch.setattr(train_graphs, "TrainGraph", _EmulatedGraph)
    monkeypatch.setattr(train_graphs, "on_capture_stream",
                        lambda dev: contextlib.nullcontext())
    _EmulatedGraph.made.clear()
    return _EmulatedGraph.made


def _params(model):
    return {n: p.detach().clone() for n, p in model.named_parameters()}


@pytest.mark.parametrize("name", [ARCH, "qwen2-vl-7b"])
def test_graph_path_is_bit_equal_to_eager(emulated_graphs, name):
    """4 steps: 2 eager on the capture stream, a capture, replays; the
    VLM's input embedding gets no gradient (a zero gradient)."""
    eager = _trainer(name, compile=False)
    eager.run(4)
    tr = _trainer(name)
    assert tr.compiled
    state = tr.run(4)
    assert tr.replayed == [False, False, True, True]
    assert tr.history == eager.history
    assert len(emulated_graphs) == 1 and emulated_graphs[0].replays == 2
    assert emulated_graphs[0].owns(state.model, state.opt.mu)
    want = _params(eager.model)
    for n, p in _params(state.model).items():
        assert torch.equal(p, want[n]), n
    assert state.step == 4 and state.opt.count == 4
    tr.run(2, state=state)                 # the same graph, replayed on
    assert len(emulated_graphs) == 1 and tr.replayed[-2:] == [True, True]


def test_graph_path_kill_and_resume_is_bit_identical(emulated_graphs,
                                                     tmp_path):
    """Killed at step 5, resumed from its step-4 checkpoint: the resumed
    model is new, so two more warm-up steps and a new capture; the losses
    equal the uninterrupted eager run's bit for bit."""
    eager = _trainer(compile=False)
    eager.run(8)
    tr = _trainer(tmp=tmp_path)
    with pytest.raises(RuntimeError, match="injected failure"):
        tr.run(8, die_at=5)
    assert tr.history == eager.history[:5]
    tr2 = _trainer(tmp=tmp_path)
    state = tr2.resume_or_init()
    assert state.step == 4 and tr2.graph is None
    tr2.run(4, state=state)
    assert tr2.replayed == [False, False, True, True]
    assert tr2.history == eager.history[4:8]
    assert len(emulated_graphs) == 2
    assert emulated_graphs[1].owns(tr2.model, state.opt.mu)


# ---------------------------------------------------------- remat "dots"
class _OpCounter(TorchDispatchMode):
    """The aten operations run inside the block, counted by overload."""

    def __init__(self):
        super().__init__()
        self.counts = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.counts[func] += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("name", [ARCH, "qwen2-moe-a2.7b",
                                  "jamba-1.5-large-398b"])
def test_dots_remat_matches_reference_and_full_remat(name):
    import jax
    import jax.numpy as jnp

    from repro.configs.base import smoke_config as jsmoke
    from repro.models import build_model as jbuild
    from repro_torch.models.convert import tree_to_reference
    from test_torch_train import _batch, _close_tree
    tree, _ = _ref_params(name)
    jm = jbuild(dataclasses.replace(jsmoke(name), remat_policy="dots"))
    batch = _batch(tsmoke(name))
    (jloss, _), jgrads = jax.value_and_grad(
        lambda p: jm.loss(p, {k: jnp.asarray(v) for k, v in batch.items()}),
        has_aux=True)(jax.tree.map(jnp.asarray, tree))
    got, mm, other = {}, {}, {}
    for policy, remat in (("dots", True), ("full", True), ("none", False)):
        _, model = _ref_params(name)
        model.cfg = dataclasses.replace(model.cfg, remat_policy=policy,
                                        remat=remat)
        for p in model.parameters():
            p.grad = None
        loss, _ = models.loss(model.cfg, model, to_device(batch, "cpu"))
        with _OpCounter() as ops:
            loss.backward()
        mm[policy] = sum(ops.counts[op] for op in lm._DOTS_SAVED)
        other[policy] = sum(ops.counts.values()) - mm[policy]
        got[policy] = (loss.item(), {n: p.grad.clone() for n, p in
                                     model.named_parameters()})
    # "dots" saved the periods' weight products (the backward runs only
    # their gradients' products, as without remat) and recomputed the rest
    # (as full remat)
    assert mm["dots"] == mm["none"] < mm["full"], mm
    assert other["dots"] == other["full"] > other["none"], other
    assert got["dots"][0] == got["full"][0]
    for n, g in got["dots"][1].items():
        assert torch.equal(g, got["full"][1][n]), n
    np.testing.assert_allclose(got["dots"][0], float(jloss), rtol=1e-5)
    _close_tree(tree_to_reference(model, got["dots"][1]), jgrads)


# ------------------------------------------------------------------ the card
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the AdamW kernels and a CUDA "
                    "graph have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


# (parameter, moment) dtypes of each tensor of a tree: every pair the
# kernels take, and a tree that mixes them
DTYPE_TREES = [[pair] for pair in kadamw.PAIRS] + [list(kadamw.PAIRS)]
# ragged sizes: below a vector, a vector, a chunk and a bit, several chunks
SIZES = [(3,), (8,), (8193,), (5, 7), (3, 8192 + 17), (64, 1000), (1,)]


def _card_tree(dev, pairs, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    ps, gs, ms, vs = [], [], [], []
    for i, shape in enumerate(SIZES):
        pdt, mdt = pairs[i % len(pairs)]
        ps.append(torch.randn(shape, generator=gen, device=dev).to(pdt))
        gs.append(None if i == 1 else
                  (torch.randn(shape, generator=gen, device=dev) * 3).to(pdt))
        ms.append((torch.randn(shape, generator=gen, device=dev) * 0.1).to(mdt))
        vs.append(torch.rand(shape, generator=gen, device=dev).to(mdt) * 0.01)
    # a gradient off 16-byte alignment: the wrapper copies it
    big = torch.randn(SIZES[2][0] + 1, generator=gen, device=dev).to(
        ps[2].dtype)
    gs[2] = big[1:]
    return ps, gs, ms, vs, [i % 3 != 0 for i in range(len(SIZES))]


@pytest.mark.cuda
@pytest.mark.parametrize("pairs", DTYPE_TREES)
def test_kernels_equal_the_plain_version_on_the_card(cuda_device, pairs):
    ps, gs, ms, vs, dec = _card_tree(cuda_device, pairs)
    hyper = torch.tensor(hyper_values(3, 2e-3), device=cuda_device)
    want = [[t.clone() for t in ts] for ts in (ps, ms, vs)]
    before = kadamw.LAUNCHES["adamw"]
    got_norm = kadamw.adamw_step(ps, gs, ms, vs, dec, hyper)
    assert kadamw.LAUNCHES["adamw"] == before + 1
    want_norm = kadamw.adamw_step_ref(want[0], gs, want[1], want[2], dec,
                                      hyper)
    torch.cuda.synchronize()
    assert abs(got_norm.item() - want_norm.item()) <= 1e-6 * want_norm.item()
    for got, exp in zip(ps + ms + vs, want[0] + want[1] + want[2]):
        assert torch.equal(got, exp)
    # the norm clips (scale < 1) and the run is bit-equal from run to run
    assert got_norm.item() > 1.0
    again = [[t.clone() for t in ts] for ts in (ps, ms, vs)]
    n1 = kadamw.adamw_step(ps, gs, ms, vs, dec, hyper)
    n2 = kadamw.adamw_step(*again[:1], gs, *again[1:], dec, hyper)
    assert torch.equal(n1, n2)
    for a, b in zip(ps + ms + vs, again[0] + again[1] + again[2]):
        assert torch.equal(a, b)


# (arch, config overrides): head_dim 32 where the smoke config's (16) is
# not one the attention kernels are built for
H32 = {"head_dim": 32}
TRAIN_CASES = [("llama3.2-3b", H32), ("llama3.2-3b", {**H32, **BF16}),
               ("qwen2-moe-a2.7b", H32), ("falcon-mamba-7b", {}),
               ("jamba-1.5-large-398b", H32),
               ("seamless-m4t-large-v2", H32)]


@pytest.mark.cuda
@pytest.mark.parametrize("name,over", TRAIN_CASES)
def test_captured_step_equals_eager_on_the_card(cuda_device, name, over):
    from repro_torch import kernels
    cfg = dataclasses.replace(tsmoke(name), **over)
    runs = {}
    for compile in (False, True):
        tr = Trainer(cfg=cfg, batch=4, seq_len=64, peak_lr=1e-2,
                     device=cuda_device, compile=compile)
        kernels.add_launches({})
        start = kernels.launch_counts()
        state = tr.run(6)
        counts = {k: v - start[k] for k, v in kernels.launch_counts().items()}
        runs[compile] = (tr.history, _params(state.model),
                         [m.clone() for m in state.opt.mu.values()],
                         counts, tr.replayed)
    eager, captured = runs[False], runs[True]
    assert captured[4] == [False, False, True, True, True, True]
    assert captured[0] == eager[0]
    for n, p in captured[1].items():
        assert torch.equal(p, eager[1][n]), n
    for a, b in zip(captured[2], eager[2]):
        assert torch.equal(a, b)
    assert captured[3] == eager[3] and eager[3]["adamw"] == 6
