"""The selective scan's decomposition on Hopper, on the CPU, against the JAX
package's Pallas kernel (interpret mode) and the model's chunked scan.

On the card ``selective_scan`` is one kernel (``csrc/mamba_scan.cu``): a
channel's state runs in groups of 16 columns (missing columns zero),
spread over the lanes of a warp, and every block walks all L steps.  A
CUDA kernel cannot run here, so these tests hold what surrounds it and
its arithmetic:

- the launch plan (``mamba_scan.scan_plan``, Python, from shapes alone):
  every channel in one block, every state column in one lane of one
  group, shared memory, and at least 132 x 8 working warps, all resident
  at once, at falcon-mamba-7b's prefill (B = 8 x 512) and at the
  batcher's B = 1 for L in 16 .. 1024;
- the kernel's state groups and the order of its sums emulated in plain
  torch (f32), against the Pallas ``selective_scan`` at its 2e-3 (the
  tolerance of ``tests/test_kernels.py``) and against the model's
  ``_ssm_scan_chunked`` (JAX and port) at 1e-5, y and hT: ragged L,
  L = 1, B = 1 over many steps, N = 4, 16, 17 and 32, strided B and C;
- the wrapper on CPU tensors at N = 17 and 32 against the Pallas kernel.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import repro.models.layers as JL
from repro.kernels.mamba_scan import selective_scan as pallas_scan
from repro_torch.kernels import mamba_scan
from repro_torch.models import layers as TL

LOG2E = 1.4426950408889634
DIN, N16 = 8192, 16               # falcon-mamba-7b's Din and state


def _t(x):
    return torch.from_numpy(np.array(x))


def _inputs(b, l, d, n, seed):
    rng = np.random.default_rng(seed)
    u = rng.normal(size=(b, l, d)).astype(np.float32) * 0.5
    dt = np.abs(rng.normal(size=(b, l, d))).astype(np.float32) * 0.1
    a = -np.abs(rng.normal(size=(d, n))).astype(np.float32)
    bb = rng.normal(size=(b, l, n)).astype(np.float32)
    cc = rng.normal(size=(b, l, n)).astype(np.float32)
    dsk = rng.normal(size=(d,)).astype(np.float32)
    return u, dt, a, bb, cc, dsk


def _strided(bb, cc, seed):
    """B and C as column slices of one (B, L, 5 + 2N) projection."""
    rng = np.random.default_rng(seed)
    n = bb.shape[-1]
    proj = _t(np.concatenate([rng.normal(size=bb.shape[:2] + (5,))
                              .astype(np.float32), bb, cc], axis=-1))
    bs, cs = proj[..., 5:5 + n], proj[..., 5 + n:]
    assert not bs.is_contiguous() and not cs.is_contiguous()
    return bs, cs


# ------------------------------------------------------------------- plan
def _smem(plan, dtype):
    """csrc ``Tiles``: per (step, channel) {dt, u} and y in f32 and two
    stages of raw u and dt; per (step, column) B and C in f32 and two raw
    stages."""
    e = dtype.itemsize
    return plan.tile * ((12 + 4 * e) * plan.channels
                        + (8 + 4 * e) * mamba_scan.GROUP)


def _resident_blocks(plan, dtype):
    """Blocks an SM holds: the launch bound's (csrc ``min_blocks``: 8, or
    4 from 4 lanes a channel on), fewer where shared memory (228 KB an SM,
    1 KB of it reserved per block) runs out first."""
    return min(4 if plan.lanes >= 4 else 8,
               228 * 1024 // (_smem(plan, dtype) + 1024))


def _check_plan(b, l, d, n, dtype=torch.bfloat16):
    """Walk the kernel's indexing under the plan: each channel in one
    block, each state column in one (group, lane, state) slot; the shared
    memory and the grid within the kernel's limits; a grid of 4 or 8
    lanes a channel resident at once."""
    plan = mamba_scan.scan_plan(b, l, d, n, dtype)
    s, g = plan.states, plan.lanes
    gw = mamba_scan.GROUP
    # the (S, G) pairs csrc/mamba_scan.cu instantiates
    assert (s, g) in {(8, 2), (4, 4), (2, 8)} and s * g == gw
    assert plan.channels * g == mamba_scan.THREADS
    assert plan.groups == -(-n // gw)
    # state columns: group q, lane j, state i takes column q GW + j S + i
    cols = np.zeros(plan.groups * gw, np.int64)
    for q in range(plan.groups):
        for j in range(g):
            cols[q * gw + j * s:q * gw + (j + 1) * s] += 1
    assert (cols == 1).all() and len(cols) >= n
    # channels: block x takes [channels x, channels (x + 1))
    gx, gy = plan.grid
    assert gy == b <= 65535
    assert (gx - 1) * plan.channels < d <= gx * plan.channels
    assert plan.tile == (8 if dtype.itemsize == 2 else 4) * g
    assert _smem(plan, dtype) <= 48 * 1024
    assert plan.vec * dtype.itemsize == 16
    assert plan.working_warps == b * -(-d * g // 32)
    if g >= 4:      # widened: the grid is resident at once
        assert gx * b <= mamba_scan.SMS * _resident_blocks(plan, dtype)
    return plan


@pytest.mark.parametrize("b,l", [(8, 512)] + [(1, l) for l in (
    16, 17, 64, 100, 128, 255, 512, 1000, 1024)])
def test_scan_plan_fills_the_card_at_falcon_mambas_prefill(b, l):
    """falcon-mamba-7b (Din 8192, N 16): at B = 8 x 512 and at the
    batcher's B = 1 for every bucket, at least 132 x 8 warps hold a
    channel, and every block is resident at once (the kernel's launch
    bound, within shared memory, on 132 SMs): no second wave and no tail.
    B = 8 carries 8 states a lane on 2 lanes, B = 1 2 states on 8 lanes,
    each (b, t, d, n) one exponential."""
    plan = _check_plan(b, l, DIN, N16)
    assert plan.working_warps >= mamba_scan.TARGET_WARPS == 132 * 8
    blocks = plan.grid[0] * plan.grid[1]
    assert blocks <= mamba_scan.SMS * _resident_blocks(plan, torch.bfloat16)
    assert (plan.states, plan.lanes) == ((8, 2) if b == 8 else (2, 8))


def test_scan_plan_widens_a_channel_only_while_the_grid_stays_resident():
    """jamba-1.5-large (Din 16384) at B = 1 stops at 4 lanes: 8 would need
    1,024 blocks, past the 528 that 4 an SM hold.  A narrow or a large
    batch keeps 8 states a lane where wider lanes add no resident warp."""
    assert _check_plan(1, 512, 16384, 16).lanes == 4
    assert _check_plan(1, 512, 16384, 16).working_warps == 2048
    assert _check_plan(1, 64, 1024, 16).lanes == 8
    assert _check_plan(1000, 4, 8, 4, torch.float32).lanes == 2
    assert _check_plan(64, 512, 8192, 16).lanes == 2
    assert _check_plan(2, 200, 2000, 17).groups == 2


@settings(max_examples=80, deadline=None)
@given(b=st.integers(1, 70), l=st.integers(1, 3000),
       d=st.integers(1, 9000), n=st.integers(1, 70),
       dtype=st.sampled_from([torch.float32, torch.bfloat16]))
def test_scan_plan_covers_random_shapes(b, l, d, n, dtype):
    _check_plan(b, l, d, n, dtype)


def test_scan_plan_reads_shapes_only_and_is_cached():
    """The plan is a function of five plain values: no tensor goes in, so
    the host never reads one (a CUDA graph can capture the call); a second
    call with the same shapes is a cache hit."""
    mamba_scan.scan_plan.cache_clear()
    p1 = mamba_scan.scan_plan(8, 512, DIN, N16, torch.bfloat16)
    hits = mamba_scan.scan_plan.cache_info().hits
    p2 = mamba_scan.scan_plan(8, 512, DIN, N16, torch.bfloat16)
    assert p2 is p1 and mamba_scan.scan_plan.cache_info().hits == hits + 1
    with pytest.raises(ValueError, match="empty"):
        mamba_scan.scan_plan(1, 0, DIN, N16, torch.bfloat16)
    with pytest.raises(ValueError, match="grid"):
        mamba_scan.scan_plan(65536, 4, 8, 4, torch.float32)


# -------------------------------------------------------------- emulation
def emulate(u, dt, a, b, c, d_skip, plan):
    """The kernel's arithmetic in plain f32 torch, cut as ``plan`` cuts
    it: per group of ``GROUP`` columns (the missing ones zero), the states
    walk all L steps from zero with decay 2^(dt A log2 e); y is group 0's
    sum plus d_skip u, then each later group's sum added; hT the groups'
    states side by side."""
    u, dt, b, c = (t.to(torch.float32) for t in (u, dt, b, c))
    bsz, l, d = u.shape
    n = a.shape[1]
    gw = mamba_scan.GROUP
    a2 = a.to(torch.float32) * LOG2E
    dtu = dt * u
    y, ht = None, torch.empty((bsz, d, n))
    for q in range(plan.groups):
        cols = slice(q * gw, min(n, (q + 1) * gw))
        a2g, bg, cg = a2[:, cols], b[..., cols], c[..., cols]
        h = torch.zeros((bsz, d, a2g.shape[1]))
        yg = torch.empty((bsz, l, d))
        for t in range(l):
            h = h * torch.exp2(dt[:, t, :, None] * a2g) + \
                dtu[:, t, :, None] * bg[:, t, None, :]
            yg[:, t] = (h * cg[:, t, None, :]).sum(-1)
        ht[..., cols] = h
        y = yg + d_skip[None, None] * u if q == 0 else y + yg
    return y, ht


# (B, L, D, N, strided B/C)
CASES = [
    (1, 200, 32, 16, False),    # B = 1 over 200 steps
    (1, 155, 24, 4, True),      # N = 4: 12 of a group's columns zero
    (2, 1, 16, 16, False),      # L = 1
    (1, 150, 16, 17, False),    # N = 17: groups of 16 and 1
    (1, 130, 8, 32, True),      # N = 32: two groups
    (3, 64, 40, 4, False),      # D not a block's width
    (2, 19, 8, 16, True),       # L not a round's steps
    (1, 33, 12, 17, True),      # N = 17, strided
]


def _case(b, l, d, n, strided, seed):
    u, dt, a, bb, cc, dsk = _inputs(b, l, d, n, seed)
    plan = mamba_scan.scan_plan(b, l, d, n, torch.float32)
    tb, tc = _strided(bb, cc, seed) if strided else (_t(bb), _t(cc))
    got = emulate(_t(u), _t(dt), _t(a), tb, tc, _t(dsk), plan)
    return (u, dt, a, bb, cc, dsk), plan, got


@pytest.mark.parametrize("b,l,d,n,strided", CASES)
def test_emulated_kernels_match_pallas(b, l, d, n, strided):
    args, plan, (y, _) = _case(b, l, d, n, strided, seed=l + n)
    want = np.asarray(pallas_scan(*args, bd=d, bl=l))
    assert y.dtype == torch.float32 and tuple(y.shape) == want.shape
    np.testing.assert_allclose(y.numpy(), want, rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("b,l,d,n,strided", CASES)
def test_emulated_kernels_match_the_chunked_scan(b, l, d, n, strided):
    """y and hT of the emulation against the model's ``_ssm_scan_chunked``
    (the reference's combine in doubling steps) at 1e-5: both sum the same
    f32 terms, in other orders.  hT also against the port's chunked scan
    (its y goes through a CPU einsum, whose rounding order is the BLAS
    library's)."""
    args, plan, (y, h) = _case(b, l, d, n, strided, seed=l + n)
    u, dt, a, bb, cc, dsk = args
    jy, jh = JL._ssm_scan_chunked(*(jnp.asarray(x) for x in args[:5]), 8)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy) + dsk * u,
                               rtol=1e-5, atol=1e-5)
    _, th = TL._ssm_scan_chunked(*map(_t, args[:5]), 8)
    np.testing.assert_allclose(h.numpy(), th.numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n", [17, 32])
def test_cpu_wrapper_takes_large_states(n):
    """The wrapper on CPU tensors (its plain version) at N > 16, against
    the Pallas kernel, which takes any N; the card's kernel runs such a
    state in groups (``test_emulated_kernels_*``)."""
    u, dt, a, bb, cc, dsk = args = _inputs(2, 48, 16, n, seed=n)
    want = np.asarray(pallas_scan(*args, bd=16, bl=16))
    before = dict(mamba_scan.LAUNCHES)
    y, h = mamba_scan.selective_scan(*map(_t, args), return_state=True)
    assert mamba_scan.LAUNCHES == before
    assert tuple(h.shape) == (2, 16, n) and h.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), want, rtol=2e-3, atol=2e-3)


def test_scan_times_loads_another_checkout_beside_this_one():
    """``launch.scan_times --other SRC`` imports another checkout's scan
    wrapper into the same process under another package name; here this
    checkout's own ``src``, whose wrapper must then give this process's
    result on CPU tensors.  Its inputs put B and C in one projection."""
    import pathlib

    from repro_torch.launch import scan_times
    from repro_torch.launch._checkout import load_other
    src = pathlib.Path(mamba_scan.__file__).resolve().parents[2]
    other, = load_other(str(src), "kernels.mamba_scan")
    assert other.__name__ == "other_repro_torch.kernels.mamba_scan"
    assert other is not mamba_scan
    gen = torch.Generator().manual_seed(0)
    args = scan_times.scan_inputs(gen, 1, 9, 16, 4, torch.device("cpu"))
    assert not args[3].is_contiguous() and args[3].dtype == torch.bfloat16
    for got, want in zip(other.selective_scan(*args, return_state=True),
                         mamba_scan.selective_scan(*args, return_state=True)):
        assert torch.equal(got, want)
