"""The split-KV flash decode of the port, on the CPU, against the JAX
package's Pallas kernels (interpret mode).

On the card ``flash_decode`` and ``flash_decode_int8`` are two kernels
(``csrc/decode_attn.cu``): a split kernel writes one partial softmax state
(acc, m, l) per chunk of positions, and a merge kernel combines a row's
partials by the log-sum-exp rule.  A CUDA kernel cannot run here, so these
tests hold what surrounds it and its arithmetic:

- the launch plan (``decode_attn.decode_plan``, Python): every position
  below S in exactly one chunk, every query head in one block of each
  chunk, a workspace that holds every partial, enough working blocks for
  the card's 132 SMs at llama3.2-3b's decode, and no lengths read;
- the split-and-merge arithmetic emulated in plain torch (f32) from the
  plan, against the Pallas ``flash_decode`` at 2e-3 (the tolerance of
  ``tests/test_kernels.py``) and ``flash_decode_int8`` at 2e-5, per row
  against one JAX call per row (the JAX kernel takes a scalar length),
  with lengths 0 and past S among them;
- the wrappers on CPU tensors at ``length = 0`` (every position masked:
  the mean of V over all S), and causal ``flash_attention`` with Sq > Sk
  (rows before the first key: the mean of V over all Sk), against the
  Pallas kernels.
"""

from __future__ import annotations

import ast
import inspect
import math
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.kernels.decode_attn import flash_decode as pallas_decode
from repro.kernels.decode_attn_int8 import flash_decode_int8 as pallas_int8
from repro.kernels.flash_attn import flash_attention as pallas_flash
from repro_torch.configs.base import all_archs, get_arch
from repro_torch.kernels import (_build, _tensors, decode_attn,
                                 decode_attn_int8, flash_attn)

KERNELS = pathlib.Path(decode_attn.__file__).resolve().parent
SMS = 132                       # the H100's streaming multiprocessors


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _quant(x):
    am = np.abs(x).max(axis=-1, keepdims=True)
    sc = np.where(am > 0, am / 127.0, 1.0).astype(np.float32)
    return np.clip(np.round(x / sc), -127, 127).astype(np.int8), sc


# ------------------------------------------------------------------- plan
def _check_plan(b, hq, hkv, s, d):
    """Walk the kernels' block indexing under the plan: each position of
    each (row, query head) in exactly one working block's chunk, its
    partial inside the workspace, each (row, query head) merged once."""
    plan = decode_attn.decode_plan(b, hq, hkv, s, d)
    g = hq // hkv
    nx, ny, nz = plan.split_grid
    assert plan.chunk == decode_attn.CHUNK and nz == plan.n_chunks
    assert nx == hkv and ny == b * plan.groups
    assert nz <= 65535 and ny <= 65535
    # positions: chunk z covers [chunk z, chunk (z + 1)) clipped to S
    covered = np.zeros(s, np.int64)
    for z in range(nz):
        covered[z * plan.chunk:min(s, (z + 1) * plan.chunk)] += 1
    assert (covered == 1).all()
    assert (nz - 1) * plan.chunk < s      # no chunk lies wholly past S
    # query heads: block (x, y) takes heads x G + MAXG (y % groups) + i
    heads = np.zeros((b, hq), np.int64)
    for x in range(nx):
        for y in range(ny):
            row, g0 = y // plan.groups, (y % plan.groups) * decode_attn.MAXG
            for i in range(min(decode_attn.MAXG, g - g0)):
                heads[row, x * g + g0 + i] += 1
    assert (heads == 1).all()
    # the workspace: (B, Hq, chunks, D + 4) f32, acc in [0, D), m and l at
    # D and D + 1; rows of a multiple of 16 bytes (float4 stores)
    assert plan.workspace == (b, hq, nz, d + 4)
    assert (d + 4) * 4 % 16 == 0
    # merge: warp w of block x takes (row, head) MERGE_ROWS x + w
    rows = plan.merge_grid[0] * decode_attn.MERGE_ROWS
    assert rows >= b * hq > rows - decode_attn.MERGE_ROWS
    return plan


def _working_blocks(plan, lengths, s):
    """Split blocks that do not exit at once: those whose chunk starts
    below their row's length (all S for a length <= 0)."""
    nx, _, nz = plan.split_grid
    n = 0
    for length in lengths:
        L = s if length <= 0 else min(length, s)
        n += sum(z * plan.chunk < L for z in range(nz)) * nx * plan.groups
    return n


ZOO = sorted({(get_arch(a).n_heads, get_arch(a).n_kv_heads, get_arch(a).hd)
              for a in all_archs() if get_arch(a).n_heads})


@pytest.mark.parametrize("hq,hkv,d", ZOO)
@pytest.mark.parametrize("b,s", [(1, 1), (8, 63), (8, 64), (1, 65),
                                 (8, 2048), (3, 4097)])
def test_decode_plan_covers_the_zoos_decode_shapes(hq, hkv, d, b, s):
    _check_plan(b, hq, hkv, s, d)


def test_decode_plan_fills_the_card_at_llamas_decode():
    """llama3.2-3b's decode in ``chip_smoke.py``: B 8, Hq 24, Hkv 8, D 128,
    a 2048-position cache, lengths 529: 9 chunks x 8 KV heads x 8 rows =
    576 blocks do work, against 64 for one block per (KV head, row)."""
    cfg = get_arch("llama3.2-3b")
    plan = _check_plan(8, cfg.n_heads, cfg.n_kv_heads, 2048, cfg.hd)
    assert plan.split_grid == (8, 8, 32)
    assert _working_blocks(plan, [529] * 8, 2048) == 576 >= SMS


@settings(max_examples=60, deadline=None)
@given(b=st.integers(1, 40), hkv=st.integers(1, 16), g=st.integers(1, 20),
       s=st.integers(1, 3000), d=st.sampled_from(_tensors.HEAD_DIMS))
def test_decode_plan_covers_random_shapes(b, hkv, g, s, d):
    _check_plan(b, g * hkv, hkv, s, d)


@pytest.mark.parametrize("b,hq,hkv,s,d,lengths", [
    (8, 24, 8, 2048, 128, [529] * 8),          # llama's decode: 576
    (3, 32, 2, 100, 64, [5, 100, 1000]),       # G = 16: two head groups
    (2, 16, 16, 300, 128, [0, 300]),           # G = 1, a length-0 row
    (2, 28, 4, 300, 128, [-2, 64])])           # G = 7
def test_written_blocks_counts_the_working_blocks(b, hq, hkv, s, d, lengths):
    """``written_blocks`` (what ``chip_smoke.py`` reads from a workspace
    filled with NaN before a call on the card) on a workspace written as
    the split kernel writes it: m for each query head of each block whose
    chunk starts below its row's length."""
    plan = decode_attn.decode_plan(b, hq, hkv, s, d)
    ws = torch.full(plan.workspace, float("nan"))
    for row, length in enumerate(lengths):
        L = s if length <= 0 else min(length, s)
        ws[row, :, :-(-L // plan.chunk), d] = 0.0
    assert decode_attn.written_blocks(plan, ws) == \
        _working_blocks(plan, lengths, s)


def test_workspace_for_refuses_a_wrong_workspace():
    plan = decode_attn.decode_plan(2, 8, 2, 100, 64)
    cpu = torch.device("cpu")
    assert tuple(decode_attn.workspace_for(plan, cpu).shape) == \
        plan.workspace
    good = torch.zeros(plan.workspace)
    assert decode_attn.workspace_for(plan, cpu, good) is good
    for bad in (torch.zeros(plan.workspace, dtype=torch.float64),
                torch.zeros(plan.workspace[:-1] + (8,)),
                torch.zeros(plan.workspace[::-1]).permute(3, 2, 1, 0)):
        with pytest.raises(ValueError, match="workspace"):
            decode_attn.workspace_for(plan, cpu, bad)


def test_decode_plan_raises_past_the_grid():
    with pytest.raises(ValueError, match="grid"):
        decode_attn.decode_plan(70000, 8, 8, 64, 128)
    with pytest.raises(ValueError, match="grid"):
        decode_attn.decode_plan(1, 8, 8, 64 * 65536 + 1, 128)


def _calls(fn):
    """Names of the attributes ``fn``'s body calls (``x.item()`` ->
    ``item``)."""
    tree = ast.parse(inspect.getsource(fn).lstrip())
    return {n.func.attr for n in ast.walk(tree)
            if isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)}


def test_decode_path_never_reads_lengths_on_the_host():
    """The plan takes no lengths, and neither the wrappers nor the helper
    that puts the lengths on the device reads a tensor back to the host
    (no ``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()`` or
    synchronise): the decode step can be captured in a CUDA graph."""
    params = list(inspect.signature(decode_attn.decode_plan).parameters)
    assert params == ["b", "hq", "hkv", "s", "d"]
    host_reads = {"item", "tolist", "cpu", "numpy", "synchronize"}
    for fn in (decode_attn.decode_plan, decode_attn.flash_decode,
               decode_attn.launch, decode_attn_int8.flash_decode_int8,
               decode_attn_int8.launch, _tensors.row_lengths):
        assert not _calls(fn) & host_reads, fn.__name__


def test_decode_kernels_are_one_template_with_two_launches():
    """The four C entry points share one split template and one merge
    kernel (the old one-block-per-row ``decode_kernel`` is gone), and each
    takes the workspace, the lse of the partial mode and the window's first
    position; the chunk is the source's constant, the plan's."""
    src = (KERNELS / "csrc" / "decode_attn.cu").read_text()
    assert "decode_split_kernel" in src and "decode_merge_kernel" in src
    assert "decode_kernel<" not in src and " decode_kernel(" not in src
    assert f"constexpr int CHUNK = {decode_attn.CHUNK};" in src
    assert f"constexpr int MAXG = {decode_attn.MAXG};" in src
    assert f"constexpr int NW = {decode_attn.MERGE_ROWS};" in src
    for name in ("flash_decode_f32", "flash_decode_bf16"):
        assert len(_build.SIGNATURES[name]) == 16
    for name in ("flash_decode_int8_f32", "flash_decode_int8_bf16"):
        assert len(_build.SIGNATURES[name]) == 18


# ------------------------------------------------- split-and-merge emulation
def _split_merge(q, k, v, lengths, k_scale=None, v_scale=None):
    """The decode kernels' arithmetic in plain torch, f32, cut as
    ``decode_plan`` cuts it: per chunk of a row that starts below its
    length, the partial (acc, m, l) of each query head into the workspace
    (an int8 cache's K scale on the dot product, its V scale on P), then
    the merge of the row's ceil(L / chunk) partials by the log-sum-exp
    rule with the 1e-30 floor.  A length <= 0 gives every position one
    equal score."""
    b, hq, d = q.shape
    _, hkv, s, _ = k.shape
    g = hq // hkv
    plan = decode_attn.decode_plan(b, hq, hkv, s, d)
    ws = torch.full(plan.workspace, float("nan"))
    out = torch.empty((b, hq, d))
    for row in range(b):
        n = int(lengths[row])
        L = s if n <= 0 else min(n, s)
        nc = -(-L // plan.chunk)
        for c in range(nc):
            c0 = c * plan.chunk
            pos = slice(c0, min(c0 + plan.chunk, L))
            kk = k[row, :, pos].float().repeat_interleave(g, 0)
            vv = v[row, :, pos].float().repeat_interleave(g, 0)
            dots = torch.einsum("hd,hkd->hk", q[row].float(), kk)
            if k_scale is not None:
                dots = dots * k_scale[row, :, pos, 0].repeat_interleave(g, 0)
            sc = torch.zeros_like(dots) if n <= 0 else dots / math.sqrt(d)
            m = sc.amax(-1)
            p = torch.exp(sc - m[:, None])
            pv = p if v_scale is None else \
                p * v_scale[row, :, pos, 0].repeat_interleave(g, 0)
            ws[row, :, c, :d] = torch.einsum("hk,hkd->hd", pv, vv)
            ws[row, :, c, d] = m
            ws[row, :, c, d + 1] = p.sum(-1)
        part = ws[row, :, :nc]
        mx = part[:, :, d].amax(-1, keepdim=True)
        f = torch.exp(part[:, :, d] - mx)
        lsum = (part[:, :, d + 1] * f).sum(-1, keepdim=True)
        out[row] = (part[:, :, :d] * f[..., None]).sum(1) / \
            lsum.clamp_min(1e-30)
    assert not torch.isnan(out).any()
    return out.to(q.dtype)


# lengths: 0, 1, chunk - 1, chunk, chunk + 1, S - 1, S and past S
LENGTHS = [0, 1, 63, 64, 65, 255, 256, 300]


@pytest.mark.parametrize("quant", [False, True])
def test_split_merge_matches_pallas_per_row(quant):
    """At llama3.2-3b's heads (24 query, 8 KV, head dim 128) and a
    256-position cache, each row of the emulated split-and-merge equals the
    Pallas kernel run on that row alone with its scalar length: 2e-3 for
    the float cache, 2e-5 for the int8 one (the tolerances of
    ``tests/test_kernels.py``)."""
    rng = np.random.default_rng(17 + quant)
    b, hq, hkv, s, d = len(LENGTHS), 24, 8, 256, 128
    q = rng.normal(size=(b, hq, d)).astype(np.float32)
    k = rng.normal(size=(b, hkv, s, d)).astype(np.float32) * 2
    v = rng.normal(size=(b, hkv, s, d)).astype(np.float32)
    if quant:
        (k8, ks), (v8, vs) = _quant(k), _quant(v)
        got = _split_merge(_t(q), _t(k8), _t(v8), LENGTHS, _t(ks), _t(vs))
        rows = [pallas_int8(*(jnp.asarray(x[i:i + 1])
                              for x in (q, k8, ks, v8, vs)), n, bk=128)
                for i, n in enumerate(LENGTHS)]
        tol = 2e-5
    else:
        got = _split_merge(_t(q), _t(k), _t(v), LENGTHS)
        rows = [pallas_decode(q[i:i + 1], k[i:i + 1], v[i:i + 1], n, bk=128)
                for i, n in enumerate(LENGTHS)]
        tol = 2e-3
    _close(got, np.concatenate([np.asarray(r) for r in rows]), tol)


def test_split_merge_matches_the_plain_version_in_the_models_layout():
    """The emulation over the model's (B, S, Hkv, D) cache seen through
    transposed views, G = 16 (two head groups a block), D = 64 and a
    ragged last chunk, against the port's plain version."""
    rng = np.random.default_rng(3)
    b, hq, hkv, s, d = 4, 32, 2, 150, 64
    lengths = torch.tensor([150, 0, 70, 1000], dtype=torch.int32)
    q = _t(rng.normal(size=(b, hq, d)).astype(np.float32))
    k, v = (_t(rng.normal(size=(b, s, hkv, d)).astype(np.float32))
            .transpose(1, 2) for _ in range(2))
    _close(_split_merge(q, k, v, lengths),
           decode_attn.flash_decode_plain(q, k, v, lengths), 2e-5)


# ------------------------------------------------- the repaired results
def test_flash_decode_at_length_zero_matches_pallas():
    """Every position masked: the mean of V over all S positions (the
    Pallas kernel masks with the finite -1e30), for both wrappers."""
    rng = np.random.default_rng(5)
    b, hq, hkv, s, d = 2, 8, 2, 256, 64
    q = rng.normal(size=(b, hq, d)).astype(np.float32)
    k = rng.normal(size=(b, hkv, s, d)).astype(np.float32)
    v = rng.normal(size=(b, hkv, s, d)).astype(np.float32)
    want = np.asarray(pallas_decode(q, k, v, 0, bk=128))
    mean_v = np.repeat(v.mean(axis=2), hq // hkv, axis=1)
    _close(want, mean_v, 1e-5)
    _close(decode_attn.flash_decode(_t(q), _t(k), _t(v), 0), want, 2e-3)
    zeros = torch.zeros(b, dtype=torch.int32)
    _close(decode_attn.flash_decode(_t(q), _t(k), _t(v), zeros), want, 2e-3)
    (k8, ks), (v8, vs) = _quant(k), _quant(v)
    want8 = pallas_int8(*(jnp.asarray(x) for x in (q, k8, ks, v8, vs)), 0,
                        bk=128)
    got8 = decode_attn_int8.flash_decode_int8(
        *(_t(x) for x in (q, k8, ks, v8, vs)), zeros)
    _close(got8, want8, 2e-5)


@pytest.mark.parametrize("b,hq,hkv,sq,sk,d,bq,bk", [
    (1, 4, 2, 64, 32, 32, 64, 32),        # rows 0-31 before the first key
    (2, 4, 1, 64, 1, 32, 64, 1),          # one key: 63 rows before it
    (1, 8, 2, 128, 64, 64, 64, 64),       # two query blocks of the kernel
])
def test_flash_attention_causal_sq_past_sk_matches_pallas(b, hq, hkv, sq, sk,
                                                          d, bq, bk):
    """Causal attention with more queries than keys: query i sits at
    i + Sk - Sq, and a row before the first key gets the mean of V over
    all Sk keys, as the Pallas kernel gives (f32, 2e-3)."""
    rng = np.random.default_rng(sq + sk)
    q = rng.normal(size=(b, hq, sq, d)).astype(np.float32)
    k = rng.normal(size=(b, hkv, sk, d)).astype(np.float32)
    v = rng.normal(size=(b, hkv, sk, d)).astype(np.float32)
    want = np.asarray(pallas_flash(q, k, v, causal=True, bq=bq, bk=bk))
    got = flash_attn.flash_attention(_t(q), _t(k), _t(v), causal=True)
    _close(got, want, 2e-3)
    first = sq - sk                       # the first row that sees a key
    mean_v = np.repeat(v.mean(axis=2, keepdims=True), hq // hkv, axis=1)
    _close(want[:, :, :first], np.broadcast_to(
        mean_v, (b, hq, first, d)), 1e-5)


def test_host_cost_script_loads_another_checkout_beside_this_one():
    """``launch.decode_host_cost --other SRC`` imports another checkout's
    decode wrappers into the same process under another package name;
    here this checkout's own ``src``, whose wrappers must then give the
    same result as this process's on CPU tensors."""
    from repro_torch.launch import decode_host_cost
    src = pathlib.Path(decode_attn.__file__).resolve().parents[2]
    dec, dec8 = decode_host_cost._other(str(src))
    assert dec.__name__ == "other_repro_torch.kernels.decode_attn"
    assert dec8.__name__ == "other_repro_torch.kernels.decode_attn_int8"
    assert dec is not decode_attn
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.standard_normal(sh, dtype=np.float32))
               for sh in ((2, 4, 32), (2, 2, 40, 32), (2, 2, 40, 32)))
    lengths = torch.tensor([0, 17], dtype=torch.int32)
    assert torch.equal(dec.flash_decode(q, k, v, lengths),
                       decode_attn.flash_decode(q, k, v, lengths))
