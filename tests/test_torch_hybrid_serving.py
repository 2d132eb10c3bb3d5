"""The port's serving of the Mamba, MoE and hybrid models against the JAX
package's, on the same weights (smoke configs, f32, CPU).

``ServeEngine.generate`` gives the reference engine's greedy tokens for
falcon-mamba-7b, qwen2-moe-a2.7b and jamba-1.5-large-398b, and
``ContinuousBatcher`` the reference batcher's tokens on the same traffic.
Both batchers prefill a prompt padded with token 0 to its length bucket; for
attention the length mask hides the padding, but the Mamba conv and SSM
states are taken after it (the reference's behaviour, mirrored).  A
request's tokens are still the same alone or co-scheduled on falcon-mamba,
since the bucket depends only on the prompt's length.  That invariant cannot
hold for an MoE model, in the reference either: decode routes all slots'
tokens as one group, whose expert capacity couples the rows.
``python -m repro_torch.launch.serve --arch falcon-mamba-7b --reduced
--device cpu`` runs.
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


def _pair(name, kv="compute"):
    """(JAX engine, port model) sharing the reference's init."""
    key = (name, kv)
    if key not in _CACHE:
        jcfg = dataclasses.replace(jsmoke(name), kv_dtype=kv)
        tcfg = dataclasses.replace(tsmoke(name), kv_dtype=kv)
        jeng = JEngine(jcfg, max_len=64)
        tm = params_from_reference(jax.tree.map(np.asarray, jeng.params),
                                   tcfg, "cpu")
        _CACHE[key] = (jeng, tm)
    return _CACHE[key]


def _requests(cls, n, seed, vocab, max_new=5):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        sp = int(rng.integers(3, 12))          # bucket 16: always padded
        prompt = rng.integers(0, vocab, (sp,)).astype(np.int32)
        out.append(cls(rid=i, prompt=prompt, max_new=max_new))
    return out


@pytest.mark.parametrize("name,kv", [("falcon-mamba-7b", "compute"),
                                     ("qwen2-moe-a2.7b", "compute"),
                                     ("jamba-1.5-large-398b", "int8")])
def test_generate_tokens_equal_reference(name, kv):
    jeng, tm = _pair(name, kv)
    prompts = np.random.default_rng(0).integers(
        0, tm.cfg.vocab_size, (3, 10)).astype(np.int32)
    teng = ServeEngine(tm.cfg, max_len=64, params=tm, device="cpu")
    want = jeng.generate(prompts, 6)
    got = teng.generate(prompts, 6)
    assert got.dtype == np.int32 and got.shape == (3, 6)
    np.testing.assert_array_equal(got, want)


def _batched(cls, batcher, n, seed, vocab):
    reqs = _requests(cls, n, seed, vocab)
    for r in reqs:
        batcher.submit(r)
    batcher.run_until_drained()
    return reqs


@pytest.mark.parametrize("name,kv", [("falcon-mamba-7b", "compute"),
                                     ("jamba-1.5-large-398b", "compute"),
                                     ("jamba-1.5-large-398b", "int8"),
                                     ("qwen2-moe-a2.7b", "compute")])
def test_continuous_batcher_matches_reference(name, kv):
    jeng, tm = _pair(name, kv)
    vocab = tm.cfg.vocab_size
    cb = ContinuousBatcher(tm.cfg, n_slots=3, max_len=64, params=tm,
                           device="cpu")
    co = _batched(Request, cb, 5, 1, vocab)
    jcb = JBatcher(jeng.cfg, n_slots=3, max_len=64, params=jeng.params)
    jco = _batched(JRequest, jcb, 5, 1, vocab)
    for rq, jrq in zip(co, jco):
        assert rq.done and len(rq.out) == rq.max_new
        assert rq.out == jrq.out, (rq.rid, rq.out, jrq.out)
    assert cb.stats == jcb.stats


def test_mamba_continuous_matches_solo():
    _, tm = _pair("falcon-mamba-7b")
    vocab = tm.cfg.vocab_size
    solo = []
    for r in _requests(Request, 5, 2, vocab):
        cb = ContinuousBatcher(tm.cfg, n_slots=1, max_len=64, params=tm,
                               device="cpu")
        cb.submit(r)
        cb.run_until_drained()
        solo.append(r.out)
    cb = ContinuousBatcher(tm.cfg, n_slots=3, max_len=64, params=tm,
                           device="cpu")
    co = _batched(Request, cb, 5, 2, vocab)
    assert [r.out for r in co] == solo


def test_launch_serve_runs_falcon_mamba_on_cpu():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "falcon-mamba-7b", "--reduced", "--device", "cpu", "--batch", "2",
         "--prompt-len", "8", "--gen-tokens", "4"],
        env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("falcon-mamba-7b: prefill ")
    assert "tok/s (batch=2, prompt=8)" in res.stdout
