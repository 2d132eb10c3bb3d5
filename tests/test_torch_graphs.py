"""The port's compiled serving step (``repro_torch.serve.graphs``) and what
it needs of the model.

On the CPU (smoke configs, f32):

* ``lm.decode_step`` advances ``cache["length"]`` in place (the same tensor
  object, the same storage) and its logits still equal the JAX reference's
  over several steps, at the tolerance of ``tests/test_torch_lm.py`` (rtol
  = atol = 1e-4), for the dense model with a float and an int8 KV cache,
  falcon-mamba, qwen2-moe and jamba;
* ``lm.prefill(cache=...)`` into a dirty cache that ``lm.reset_cache``
  has reset gives the fresh prefill's logits and cache bit for bit;
* ``ServeEngine``/``ContinuousBatcher`` with ``compile=True`` raise on the
  CPU and ``compile="auto"`` runs eagerly there; their graph path, with
  the graph's replay emulated by the eager step on its static buffers,
  gives the eager path's tokens;
* the launch bookkeeping: what a capture counts is taken out of the
  counters and added back once per replay.

On the card (marked ``cuda``; they import no JAX, so they run on a machine
without it: ``python -m pytest -q -m cuda tests/test_torch_graphs.py``):
the captured step against the eager one at small size, for the dense model
in f32 and bf16, the int8 KV cache, Mamba, MoE and the hybrid: greedy
tokens equal, logits bit-equal at every step, ``LAUNCHES`` of a graph
generate equal to the eager one's; the batcher with graphs equal to the
eager batcher request by request, and a request alone equal to it
co-scheduled.  JAX is imported inside the helpers that use it.
"""

from __future__ import annotations

import dataclasses
import types

import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.configs.base import smoke_config as tsmoke
from repro_torch.kernels import decode_attn, mamba_scan
from repro_torch.models import build_model, lm
from repro_torch.serve import ContinuousBatcher, Request, ServeEngine
from repro_torch.serve import engine as engine_mod
from repro_torch.serve import graphs
from repro_torch.serve import scheduler as scheduler_mod

TOL = dict(rtol=1e-4, atol=1e-4)
# (arch, kv_dtype): the dense model with both caches, Mamba, MoE, hybrid
CASES = [("llama3.2-3b", "compute"), ("llama3.2-3b", "int8"),
         ("falcon-mamba-7b", "compute"), ("qwen2-moe-a2.7b", "compute"),
         ("jamba-1.5-large-398b", "compute")]
_CACHE = {}


def _pair(name, kv):
    """(JAX model, JAX params, port model on the CPU) from the reference's
    init, carried across through numpy."""
    import jax

    from repro.configs.base import smoke_config as jsmoke
    from repro.models import build_model as jbuild
    from repro_torch.models.convert import params_from_reference
    key = (name, kv)
    if key not in _CACHE:
        jm = jbuild(dataclasses.replace(jsmoke(name), kv_dtype=kv))
        params = jm.init(jax.random.key(0))
        tm = params_from_reference(
            jax.tree.map(np.asarray, params),
            dataclasses.replace(tsmoke(name), kv_dtype=kv), "cpu")
        _CACHE[key] = (jm, params, tm)
    return _CACHE[key]


def _prompts(vocab, b=2, s=9, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)


@pytest.mark.parametrize("name,kv", CASES)
def test_decode_step_advances_length_in_place(name, kv):
    import jax
    jm, params, tm = _pair(name, kv)
    toks = _prompts(jm.cfg.vocab_size)
    jl, jc = jax.jit(lambda p, t: jm.prefill(p, {"tokens": t}, 24))(
        params, toks)
    tl, tc = tm.prefill(torch.as_tensor(toks, dtype=torch.int64), 24)
    length = tc["length"]
    ptr = length.data_ptr()
    jdec = jax.jit(jm.decode_step)
    tok = np.asarray(jl).argmax(-1).astype(np.int32)
    for j in range(4):
        jl, jc = jdec(params, jc, tok)
        tl, out = tm.decode_step(tc, torch.as_tensor(tok, dtype=torch.int64))
        assert out is tc and out["length"] is length
        assert length.data_ptr() == ptr
        assert length.tolist() == [toks.shape[1] + j + 1] * 2
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        assert (tl.numpy().argmax(-1) == np.asarray(jl).argmax(-1)).all()
        tok = np.asarray(jl).argmax(-1).astype(np.int32)
    assert np.asarray(jc["length"]).tolist() == length.tolist()


def _dirty(cache, seed):
    gen = torch.Generator().manual_seed(seed)
    for entry in cache["layers"]:
        for leaf in entry.values():
            leaf.copy_((torch.randn(leaf.shape, generator=gen) * 50).to(
                leaf.dtype))
    cache["length"].fill_(7)


@pytest.mark.parametrize("name,kv", CASES)
def test_prefill_into_a_reset_cache_equals_a_fresh_one(name, kv):
    tm = _pair(name, kv)[2]
    toks = torch.as_tensor(_prompts(tm.cfg.vocab_size), dtype=torch.int64)
    want_logits, want = tm.prefill(toks, 24)
    cache = tm.init_cache(2, 24)
    _dirty(cache, 3)
    lm.reset_cache(cache)
    fresh = tm.init_cache(2, 24)
    for got_e, want_e in zip(cache["layers"], fresh["layers"]):
        for n in want_e:
            assert torch.equal(got_e[n], want_e[n]), n
    assert cache["length"].tolist() == [0, 0]
    logits, out = tm.prefill(toks, 24, cache=cache)
    assert out is cache
    assert torch.equal(logits, want_logits)
    assert torch.equal(cache["length"], want["length"])
    for got_e, want_e in zip(cache["layers"], want["layers"]):
        assert set(got_e) == set(want_e)
        for n in want_e:
            assert torch.equal(got_e[n], want_e[n]), n
    # and the decode steps that follow
    tok = logits.argmax(-1)
    for _ in range(2):
        a, _ = tm.decode_step(cache, tok)
        b, _ = tm.decode_step(want, tok)
        assert torch.equal(a, b)
        tok = a.argmax(-1)


def test_prefill_refuses_a_cache_of_another_shape():
    tm = _pair("llama3.2-3b", "compute")[2]
    toks = torch.as_tensor(_prompts(tm.cfg.vocab_size), dtype=torch.int64)
    for cache in (tm.init_cache(3, 24), tm.init_cache(2, 32),
                  lm.init_cache(dataclasses.replace(tm.cfg, kv_dtype="int8"),
                                2, 24, "cpu")):
        with pytest.raises(ValueError, match="not one of 2 rows of 24"):
            tm.prefill(toks, 24, cache=cache)


def test_compile_true_raises_and_auto_is_eager_on_the_cpu():
    tm = _pair("llama3.2-3b", "compute")[2]
    with pytest.raises(ValueError, match="compile=True needs a CUDA"):
        ServeEngine(tm.cfg, max_len=32, params=tm, device="cpu",
                    compile=True)
    with pytest.raises(ValueError, match="compile=True needs a CUDA"):
        ContinuousBatcher(tm.cfg, n_slots=2, max_len=32, params=tm,
                          device="cpu", compile=True)
    with pytest.raises(ValueError, match="compile must be"):
        ServeEngine(tm.cfg, max_len=32, params=tm, device="cpu",
                    compile="yes")
    with pytest.raises(ValueError, match="needs a CUDA device"):
        graphs.DecodeGraph(tm.cfg, tm, 2, 32)
    prompts = _prompts(tm.cfg.vocab_size)
    auto = ServeEngine(tm.cfg, max_len=32, params=tm, device="cpu")
    eager = ServeEngine(tm.cfg, max_len=32, params=tm, device="cpu",
                        compile=False)
    np.testing.assert_array_equal(auto.generate(prompts, 5),
                                  eager.generate(prompts, 5))
    assert auto.graphs == {}
    cb = ContinuousBatcher(tm.cfg, n_slots=2, max_len=32, params=tm,
                           device="cpu")
    assert cb.graph is None


def test_launch_bookkeeping_moves_a_capture_to_each_replay():
    """``launches_apart`` takes what a block counts out of the counters;
    ``add_launches`` puts a recorded change back, once per replay."""
    kernels.add_launches({})
    start = kernels.launch_counts()
    setup, per_replay = {}, {}
    with kernels.launches_apart(setup):
        decode_attn.LAUNCHES["flash_decode"] += 6        # a warm-up
    with kernels.launches_apart(per_replay):
        decode_attn.LAUNCHES["flash_decode"] += 3        # the capture
        mamba_scan.LAUNCHES["selective_scan"] += 0
    assert kernels.launch_counts() == start
    assert per_replay["flash_decode"] == 3 and setup["flash_decode"] == 6
    assert set(per_replay) == set(start)
    assert sum(per_replay.values()) == 3
    for _ in range(4):
        kernels.add_launches(per_replay)
    now = kernels.launch_counts()
    assert now["flash_decode"] == start["flash_decode"] + 12
    assert {k: v for k, v in now.items() if k != "flash_decode"} == \
        {k: v for k, v in start.items() if k != "flash_decode"}
    # a block that raises still restores the counters
    with pytest.raises(KeyError):
        with kernels.launches_apart({}):
            decode_attn.LAUNCHES["flash_decode"] += 1
            raise KeyError("x")
    assert kernels.launch_counts() == now
    decode_attn.LAUNCHES["flash_decode"] = start["flash_decode"]


class _Emulated:
    """The graphs' interface on the CPU: an own cache (dirtied, then reset
    as after a capture), static token and logits buffers, and a replay that
    runs the eager step on them, overwriting the logits in place."""

    made = []

    def _setup(self, cfg, model, batch, max_len, use_kernel, tokens_shape):
        self.cfg, self.model, self.use_kernel = cfg, model, use_kernel
        self.max_len = max_len
        self.cache = lm.init_cache(cfg, batch, max_len, model.device)
        _dirty(self.cache, 4)
        lm.reset_cache(self.cache)
        self.tokens = torch.zeros(tokens_shape, dtype=torch.int64)
        self.logits = torch.full((batch, cfg.vocab_size), float("nan"))
        self.replays = 0
        _Emulated.made.append(self)

    def replay(self, tokens):
        self.tokens.copy_(tokens)
        self.logits.copy_(self._step())
        self.replays += 1
        return self.logits


class _EmulatedDecode(_Emulated):
    def __init__(self, cfg, model, batch, max_len, use_kernel=True):
        self._setup(cfg, model, batch, max_len, use_kernel, (batch,))
        pool = object()
        self.graph = types.SimpleNamespace(pool=lambda: pool)

    def _step(self):
        return lm.decode_step(self.cfg, self.model, self.cache, self.tokens,
                              self.use_kernel)[0]


class _EmulatedPrefill(_Emulated):
    def __init__(self, cfg, model, batch, seq, max_len, use_kernel=True,
                 cache=None, pool=None):
        self._setup(cfg, model, batch, max_len, use_kernel, (batch, seq))
        if cache is not None:
            self.cache = cache
        self.pool = pool

    def _step(self):
        lm.reset_cache(self.cache)
        return lm.prefill(self.cfg, self.model, self.tokens, self.max_len,
                          self.use_kernel, cache=self.cache)[0]


def test_engine_and_batcher_drive_the_graphs_through_their_buffers(
        monkeypatch):
    """The graph path of both engines (static caches reset and filled in
    place by prefill, tokens copied in, logits read from the buffer the
    next replay overwrites; the batcher's bucket prefills up to
    ``PREFILL_GRAPH_MAX_BUCKET`` replayed over one shared cache and the
    decode graph's pool, larger ones eager) gives the eager path's
    tokens."""
    tm = _pair("llama3.2-3b", "compute")[2]
    prompts = _prompts(tm.cfg.vocab_size, b=3)
    rng = np.random.default_rng(2)
    reqs = [rng.integers(0, tm.cfg.vocab_size, (int(n),)).astype(np.int32)
            for n in (3, 11, 20, 40, 8, 5)]       # buckets 16, 16, 32, 64..

    def generate():
        eng = ServeEngine(tm.cfg, max_len=48, params=tm, device="cpu")
        first = eng.generate(prompts, 6)
        for graph in eng.graphs.values():    # what a request leaves behind
            _dirty(graph.cache, 5)
        return eng, [first, eng.generate(prompts[:, :5], 4)]

    def serve():
        cb = ContinuousBatcher(tm.cfg, n_slots=2, max_len=72, params=tm,
                               device="cpu")
        rs = [Request(rid=i, prompt=p, max_new=4) for i, p in enumerate(reqs)]
        for r in rs:
            cb.submit(r)
        cb.run_until_drained()
        return cb, [r.out for r in rs]

    _, want_gen = generate()                 # eager: "auto" on the CPU
    _, want_serve = serve()
    for mod in (engine_mod, scheduler_mod):
        monkeypatch.setattr(mod, "DecodeGraph", _EmulatedDecode)
        monkeypatch.setattr(mod, "resolve_compile", lambda c, d: True)
    monkeypatch.setattr(scheduler_mod, "PrefillGraph", _EmulatedPrefill)
    monkeypatch.setattr(scheduler_mod, "PREFILL_GRAPH_MAX_BUCKET", 32)
    _Emulated.made.clear()
    eng, got_gen = generate()
    assert list(eng.graphs) == [3] and _Emulated.made == [eng.graphs[3]]
    assert eng.graphs[3].replays == 6 + 4
    for got, want in zip(got_gen, want_gen):
        np.testing.assert_array_equal(got, want)
    cb, got_serve = serve()
    assert cb.cache is cb.graph.cache
    assert cb.graph.replays == cb.stats["steps"]
    assert list(cb.prefill_graphs) == [16, 32]
    assert cb.prefill_graphs[16].replays == 4         # bucket 64 eager
    assert cb.prefill_graphs[32].replays == 1
    for g in cb.prefill_graphs.values():
        assert g.cache is cb.prefill_graphs[16].cache
        assert g.pool is cb.graph.graph.pool()
    assert got_serve == want_serve


# ------------------------------------------------------------------ the card
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: a CUDA graph has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


# (arch, kv_dtype, config overrides): head_dim 32 where the smoke config's
# (16) is not one the attention kernels are built for
H32 = {"head_dim": 32}
CUDA_CASES = [
    ("llama3.2-3b", "compute", H32),
    ("llama3.2-3b", "compute", {**H32, "param_dtype": "bfloat16",
                                "compute_dtype": "bfloat16"}),
    ("llama3.2-3b", "int8", H32),
    ("falcon-mamba-7b", "compute", {}),
    ("qwen2-moe-a2.7b", "compute", H32),
    ("jamba-1.5-large-398b", "compute", H32),
    ("jamba-1.5-large-398b", "int8", H32),
]


def _card_model(dev, name, kv, over):
    cfg = dataclasses.replace(tsmoke(name), kv_dtype=kv, **over)
    return build_model(cfg, dev, seed=3)


@pytest.mark.cuda
@pytest.mark.parametrize("name,kv,over", CUDA_CASES)
def test_graph_equals_eager_on_the_card(cuda_device, name, kv, over):
    model = _card_model(cuda_device, name, kv, over)
    cfg = model.cfg
    prompts = _prompts(cfg.vocab_size, b=3)
    toks = torch.as_tensor(prompts, dtype=torch.int64, device=cuda_device)
    with torch.no_grad():
        want, cache = lm.prefill(cfg, model, toks, 48)
        want = [want]
        for _ in range(6):
            logits, cache = lm.decode_step(cfg, model, cache,
                                           want[-1].argmax(-1))
            want.append(logits)
        before = kernels.launch_counts()
        graph = graphs.DecodeGraph(cfg, model, 3, 48)
        assert kernels.launch_counts() == before
        assert graph.cache["length"].tolist() == [0, 0, 0]
        lm.reset_cache(graph.cache)
        got, _ = lm.prefill(cfg, model, toks, 48, cache=graph.cache)
        got = [got]
        for j in range(6):
            got.append(graph.replay(want[j].argmax(-1)).clone())
    for j, (g, w) in enumerate(zip(got, want)):
        assert torch.equal(g, w), (j, (g - w).abs().max().item())
    n_attn = sum(s["mixer"] == "attn" for s in lm.period_structure(cfg)) * \
        lm.n_periods(cfg)
    dec = "flash_decode_int8" if kv == "int8" else "flash_decode"
    assert graph.launches[dec] == n_attn
    assert graph.setup_launches[dec] == n_attn * (graphs.WARMUP_STEPS + 1)
    counts, out = [], []
    for compile in (True, False):
        eng = ServeEngine(cfg, max_len=48, params=model, compile=compile)
        before = kernels.launch_counts()
        out.append(eng.generate(prompts, 8))
        after = kernels.launch_counts()
        counts.append({k: after[k] - before[k] for k in after})
    np.testing.assert_array_equal(out[0], out[1])
    assert counts[0] == counts[1]
    assert counts[0][dec] == n_attn * 8


@pytest.mark.cuda
@pytest.mark.parametrize("name,over", [("llama3.2-3b", H32),
                                       ("falcon-mamba-7b", {})])
def test_batcher_graph_equals_eager_and_solo_on_the_card(cuda_device, name,
                                                         over):
    model = _card_model(cuda_device, name, "compute", over)
    cfg = model.cfg
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, cfg.vocab_size, (int(n),)).astype(np.int32)
               for n in (3, 12, 20, 7, 30)]

    def run(n_slots, compile, which):
        cb = ContinuousBatcher(cfg, n_slots=n_slots, max_len=64,
                               params=model, compile=compile)
        assert (cb.graph is not None) == compile
        rs = [Request(rid=i, prompt=prompts[i], max_new=6) for i in which]
        for r in rs:
            cb.submit(r)
        before = kernels.launch_counts()
        cb.run_until_drained()
        after = kernels.launch_counts()
        return [r.out for r in rs], {k: after[k] - before[k] for k in after}

    co_graph, n_graph = run(3, True, range(5))
    co_eager, n_eager = run(3, False, range(5))
    assert co_graph == co_eager
    assert n_graph == n_eager
    for i in range(5):
        assert run(1, True, [i])[0] == [co_graph[i]]


@pytest.mark.cuda
def test_prefill_graph_equals_eager_prefill_on_the_card(cuda_device):
    model = _card_model(cuda_device, "jamba-1.5-large-398b", "compute", H32)
    cfg = model.cfg
    before = kernels.launch_counts()
    graph = graphs.PrefillGraph(cfg, model, 1, 16, 64)
    # a second bucket over the first one's cache and memory pool
    wide = graphs.PrefillGraph(cfg, model, 1, 32, 64, cache=graph.cache,
                               pool=graph.graph.pool())
    assert kernels.launch_counts() == before
    assert graph.launches["selective_scan"] == 7
    assert graph.launches["flash_attention"] == 1
    assert wide.cache is graph.cache
    for seed in (1, 2):
        for g, seq in ((wide, 32), (graph, 16)):
            toks = torch.as_tensor(_prompts(cfg.vocab_size, 1, seq, seed),
                                   dtype=torch.int64, device=cuda_device)
            with torch.no_grad():
                want, cache = lm.prefill(cfg, model, toks, 64)
            got = g.replay(toks)
            assert torch.equal(got, want)
            for got_e, want_e in zip(g.cache["layers"], cache["layers"]):
                for n in want_e:
                    assert torch.equal(got_e[n], want_e[n]), n
            assert torch.equal(g.cache["length"], cache["length"])
