"""The port's LM serving against the JAX package's, on the same weights.

``repro_torch.serve.ServeEngine.generate`` gives the reference engine's
greedy tokens; ``ContinuousBatcher`` keeps the reference's determinism
invariant (a request's tokens are the same alone or co-scheduled) and gives
the reference batcher's tokens on the same requests.  Smoke config, f32,
CPU.  ``python -m repro_torch.launch.serve --device cpu`` runs.
"""

from __future__ import annotations

import dataclasses
import os
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest

from repro.configs.base import smoke_config as jsmoke
from repro.serve.engine import ServeEngine as JEngine
from repro.serve.scheduler import ContinuousBatcher as JBatcher
from repro.serve.scheduler import Request as JRequest
from repro_torch.configs.base import smoke_config as tsmoke
from repro_torch.models.convert import params_from_reference
from repro_torch.serve import ContinuousBatcher, Request, ServeEngine

REPO = pathlib.Path(__file__).resolve().parent.parent
_CACHE = {}


def _pair(kv="compute"):
    """(JAX engine, port model) sharing the reference's init."""
    if kv not in _CACHE:
        jcfg = dataclasses.replace(jsmoke("llama3.2-3b"), kv_dtype=kv)
        tcfg = dataclasses.replace(tsmoke("llama3.2-3b"), kv_dtype=kv)
        jeng = JEngine(jcfg, max_len=64)
        tm = params_from_reference(jax.tree.map(np.asarray, jeng.params),
                                   tcfg, "cpu")
        _CACHE[kv] = (jeng, tm)
    return _CACHE[kv]


def _requests(cls, n, seed, vocab, max_new=5):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        sp = int(rng.integers(3, 12))
        prompt = rng.integers(0, vocab, (sp,)).astype(np.int32)
        out.append(cls(rid=i, prompt=prompt, max_new=max_new))
    return out


@pytest.mark.parametrize("kv", ["compute", "int8"])
def test_generate_tokens_equal_reference(kv):
    jeng, tm = _pair(kv)
    prompts = np.random.default_rng(0).integers(
        0, tm.cfg.vocab_size, (3, 10)).astype(np.int32)
    teng = ServeEngine(tm.cfg, max_len=64, params=tm, device="cpu")
    want = jeng.generate(prompts, 6)
    got = teng.generate(prompts, 6)
    assert got.dtype == np.int32 and got.shape == (3, 6)
    np.testing.assert_array_equal(got, want)
    eos = int(want[1, 2])
    np.testing.assert_array_equal(teng.generate(prompts, 6, eos=eos),
                                  jeng.generate(prompts, 6, eos=eos))


def test_continuous_matches_solo_and_reference():
    jeng, tm = _pair()
    reqs = _requests(Request, 5, 1, tm.cfg.vocab_size)
    solo = []
    for r in reqs:
        rq = Request(rid=r.rid, prompt=r.prompt, max_new=r.max_new)
        cb = ContinuousBatcher(tm.cfg, n_slots=1, max_len=64, params=tm,
                               device="cpu")
        cb.submit(rq)
        cb.run_until_drained()
        solo.append(rq.out)
    co = [Request(rid=r.rid, prompt=r.prompt, max_new=r.max_new)
          for r in reqs]
    cb = ContinuousBatcher(tm.cfg, n_slots=3, max_len=64, params=tm,
                           device="cpu")
    for rq in co:
        cb.submit(rq)
    cb.run_until_drained()
    jco = _requests(JRequest, 5, 1, tm.cfg.vocab_size)
    jcb = JBatcher(jeng.cfg, n_slots=3, max_len=64, params=jeng.params)
    for rq in jco:
        jcb.submit(rq)
    jcb.run_until_drained()
    for rq, want, jrq in zip(co, solo, jco):
        assert rq.done and len(rq.out) == rq.max_new
        assert rq.out == want, (rq.rid, rq.out, want)
        assert rq.out == jrq.out, (rq.rid, rq.out, jrq.out)
    assert cb.stats == jcb.stats


def test_slot_reuse_and_eos():
    jeng, tm = _pair()
    reqs = _requests(Request, 7, 2, tm.cfg.vocab_size)
    cb = ContinuousBatcher(tm.cfg, n_slots=2, max_len=64, params=tm,
                           device="cpu")
    for r in reqs:
        cb.submit(r)
    cb.run_until_drained()
    assert all(r.done for r in reqs)
    assert cb.stats["prefills"] == 7 and cb.utilization > 0.5
    eos = reqs[0].out[0]
    r1 = Request(rid=9, prompt=reqs[0].prompt, max_new=4)
    cb = ContinuousBatcher(tm.cfg, n_slots=1, max_len=64, params=tm,
                           eos=eos, device="cpu")
    cb.submit(r1)
    cb.run_until_drained()
    assert r1.out == [eos] and r1.done


def test_launch_serve_runs_on_cpu():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "llama3.2-3b", "--reduced", "--device", "cpu", "--batch", "2",
         "--prompt-len", "8", "--gen-tokens", "4"],
        env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("llama3.2-3b: prefill ")
    assert "tok/s (batch=2, prompt=8)" in res.stdout
