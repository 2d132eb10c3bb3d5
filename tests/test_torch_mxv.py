"""The port's crossbar MxV (``repro_torch.kernels``) against the JAX package.

On the CPU the wrappers run their plain PyTorch versions; the same numpy
inputs go through the JAX Pallas kernels in interpret mode.  Float path:
rtol = atol = 1e-5 (f32 sums in different orders), the bound of
``tests/test_kernels.py``.  Int8 path: 1e-6 (an exact integer sum, then the
same two f32 multiplies).  The quantizers must give int8 codes and f32
scales identical to both numpy twins and both JAX oracles, since every
plane consumes those codes.  The kernels' launch plan (``mxv.mxv_plan``)
is checked to store every output once within its shared memory and to
reach the card's SMs, and the float kernel's summation order, emulated in
float32 numpy, is held to the Pallas kernel at 1e-5.
``test_torch_kernels_cuda.py`` holds the CUDA kernels against the plain
versions on a card.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.core.compute_plane import quantize_matrix, quantize_rows
from repro.kernels import mxv as jmxv
from repro.kernels import ref as jref
from repro_torch.kernels import mxv, ref

SHAPES = [(1, 9, 4), (7, 36, 8), (64, 252, 28), (5, 200, 10), (3, 130, 129)]


def _inputs(b, n, m, seed):
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(m, n)).astype(np.float32)
    x = rng.normal(size=(b, n)).astype(np.float32)
    wq, ws = quantize_matrix(w)
    return x, wq, ws


@pytest.mark.parametrize("b,n,m", SHAPES)
def test_crossbar_mxv_matches_pallas(b, n, m):
    x, wq, ws = _inputs(b, n, m, seed=b * 1000 + n)
    want = np.asarray(jmxv.crossbar_mxv_padded(x, wq, ws, interpret=True))
    before = dict(mxv.LAUNCHES)
    got = mxv.crossbar_mxv(torch.from_numpy(x), torch.from_numpy(wq),
                           torch.from_numpy(ws))
    assert mxv.LAUNCHES == before           # the CPU runs no kernel
    assert got.dtype == torch.float32 and tuple(got.shape) == (b, m)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("b,n,m", SHAPES)
def test_crossbar_mxv_int8_matches_pallas(b, n, m):
    x, wq, ws = _inputs(b, n, m, seed=b * 1000 + n + 1)
    xq, xs = quantize_rows(x)
    want = np.asarray(jmxv.crossbar_mxv_int8_padded(xq, xs, wq, ws,
                                                    interpret=True))
    got = mxv.crossbar_mxv_int8(*(torch.from_numpy(a)
                                  for a in (xq, xs, wq, ws)))
    assert got.dtype == torch.float32 and tuple(got.shape) == (b, m)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("b,n,m", SHAPES)
def test_plain_versions_match_jax_oracles(b, n, m):
    x, wq, ws = _inputs(b, n, m, seed=7 + n)
    xq, xs = quantize_rows(x)
    t = [torch.from_numpy(a) for a in (x, wq, ws, xq, xs)]
    np.testing.assert_allclose(
        ref.crossbar_mxv_ref(t[0], t[1], t[2]).numpy(),
        np.asarray(jref.crossbar_mxv_ref(x, wq, ws)), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(
        ref.crossbar_mxv_int8_ref(t[3], t[4], t[1], t[2]).numpy(),
        np.asarray(jref.crossbar_mxv_int8_ref(xq, xs, wq, ws)))


@pytest.mark.parametrize("shape,scale", [((4, 9), 1.0), ((28, 252), 0.2),
                                         ((10, 200), 30.0), ((3, 1), 1e-3),
                                         ((5, 64), 0.0)])
def test_quantizers_identical_four_ways(shape, scale):
    rng = np.random.default_rng(shape[1])
    a = (rng.normal(size=shape) * scale).astype(np.float32)
    if shape[1] >= 3:
        # row 0 has scale exactly 1.0, so 2.5 and -3.5 are exact ties:
        # round-half-to-even must give 2 and -4 in every implementation
        a[0, :3] = (127.0, 2.5, -3.5)
    ta = torch.from_numpy(a)
    for torch_q, numpy_q, jax_q in (
            (ref.quantize_crossbar, quantize_matrix, jref.quantize_crossbar),
            (ref.quantize_vec, quantize_rows, jref.quantize_vec)):
        tq, ts = torch_q(ta)
        nq, ns = numpy_q(a)
        jq, js = (np.asarray(v) for v in jax_q(a))
        assert tq.dtype == torch.int8 and ts.dtype == torch.float32
        for q, s in ((nq, ns), (jq, js)):
            np.testing.assert_array_equal(tq.numpy(), q)
            np.testing.assert_array_equal(ts.numpy(), s)


def test_strided_and_bf16_inputs():
    x, wq, ws = _inputs(6, 40, 12, seed=3)
    tw, ts = torch.from_numpy(wq), torch.from_numpy(ws)
    xt = torch.from_numpy(np.ascontiguousarray(x.T)).T     # strided view
    assert not xt.is_contiguous()
    np.testing.assert_array_equal(
        mxv.crossbar_mxv(xt, tw, ts).numpy(),
        mxv.crossbar_mxv(torch.from_numpy(x), tw, ts).numpy())
    yb = mxv.crossbar_mxv(torch.from_numpy(x).to(torch.bfloat16), tw, ts)
    assert yb.dtype == torch.bfloat16
    want = np.asarray(jref.crossbar_mxv_ref(x, wq, ws))
    np.testing.assert_allclose(yb.float().numpy(), want, rtol=5e-2,
                               atol=5e-2 * max(1.0, np.abs(want).max()))


def test_wrappers_reject_what_the_kernels_do_not_take():
    x, wq, ws = (torch.from_numpy(a) for a in _inputs(2, 8, 4, seed=0))
    with pytest.raises(TypeError):
        mxv.crossbar_mxv(x.double(), wq, ws)
    with pytest.raises(TypeError):
        mxv.crossbar_mxv(x, wq.float(), ws)
    with pytest.raises(ValueError):
        mxv.crossbar_mxv(x[:, :7], wq, ws)
    with pytest.raises(ValueError):
        mxv.crossbar_mxv(x, wq, ws[:3])
    with pytest.raises(ValueError):
        mxv.crossbar_mxv(x, wq.T.contiguous().T, ws)   # strided crossbar
    with pytest.raises(TypeError):
        mxv.crossbar_mxv_int8(x, ws[:2], wq, ws)
    xq, xs = ref.quantize_vec(x)
    with pytest.raises(ValueError):
        mxv.crossbar_mxv_int8(xq, xs[:1], wq, ws)
    assert tuple(mxv.crossbar_mxv(x[:0], wq, ws).shape) == (0, 4)


# ------------------------------------------------------------ launch plan
# the CM paths' shapes (main: 28x252 at B = 1, 7, 196, 256; DAC: lenet-28's
# three), then edges: N of 1 and 3, M of 1, 5, 33, 129 and 300, a full
# 256x256 crossbar, and N of 3000 and 5000, which take several chunks of k
PLAN_SHAPES = [(256, 252, 28), (1, 252, 28), (7, 252, 28), (196, 252, 28),
               (121, 36, 8), (676, 9, 4), (1, 200, 10), (100, 9, 4),
               (144, 36, 8), (1, 1, 5), (3, 3, 33), (17, 130, 129),
               (1024, 256, 256), (4, 300, 300), (4, 64, 1), (64, 3000, 28),
               (4, 5000, 3)]
DTYPES = [torch.float32, torch.bfloat16, torch.int8]


def _plan_outputs(plan, b, m, int8):
    """How often the kernel stores each output (B, M) under ``plan``: the
    index arithmetic of ``csrc/mxv.cu``, over every block, warp and lane."""
    blocks = np.arange(plan.grid[0] * plan.grid[1])
    m0 = (blocks % plan.grid[1]) * plan.mt
    b0 = (blocks // plan.grid[1]) * plan.rows
    warp, lane = np.divmod(np.arange(plan.threads), 32)
    if int8:
        # mma warps (the first rows // 16) store rows g and g + 8, columns
        # 2t and 2t + 1 of their 16 x 8 tile
        g, t = lane >> 2, lane & 3
        keep = warp * 16 < plan.rows
        rows = np.concatenate([warp * 16 + g, warp * 16 + g + 8] * 2)
        cols = np.concatenate([2 * t, 2 * t, 2 * t + 1, 2 * t + 1])
        keep = np.concatenate([keep] * 4)
    else:
        # part-0 warps store; lane = row in the warp x column in the tile
        ks = plan.ks
        part, grp = warp % ks, warp // ks
        rows = grp * (32 // plan.mt) + lane // plan.mt
        cols = lane % plan.mt
        keep = part == 0
    rows, cols = rows[keep], cols[keep]
    bb = (b0[:, None] + rows[None, :]).ravel()
    mm = (m0[:, None] + cols[None, :]).ravel()
    ok = (bb < b) & (mm < m)
    count = np.zeros((b, m), np.int64)
    np.add.at(count, (bb[ok], mm[ok]), 1)
    return count


def _check_plan(b, n, m, dtype):
    plan = mxv.mxv_plan(b, n, m, dtype)
    int8 = dtype == torch.int8
    # every output stored exactly once
    assert (_plan_outputs(plan, b, m, int8) == 1).all(), plan
    # the C entry's arguments are the plan's fields
    assert list(plan.args) == [
        plan.mt, plan.rows, plan.ks, plan.kc, plan.chunk, plan.wstride,
        plan.xstride, plan.smem_bytes, plan.grid[1],
        plan.grid[0] * plan.grid[1], plan.threads, plan.wraw, plan.xraw]
    # shared memory in budget and large enough for what a chunk stages
    assert plan.smem_bytes <= mxv.SMEM_BYTES
    unit = mxv.MMA_K if int8 else 16
    assert plan.chunk % unit == 0 and plan.chunk == plan.ks * plan.kc
    cols = min(plan.chunk, -(-n // unit) * unit)
    elem = 1 if int8 else torch.empty((), dtype=dtype).element_size()
    assert plan.wstride >= cols and plan.xstride >= cols * elem
    if int8:
        assert plan.mt == mxv.MMA_N and plan.ks == 1
        assert plan.threads == mxv.MMA_THREADS
        assert plan.rows in (16, 32, 64)
        # a row stride of 16 mod 32 bytes: the fragments' loads are
        # conflict-free
        assert plan.wstride == plan.xstride and plan.wstride % 32 == 16
        rows_end = (plan.rows + mxv.MMA_N) * plan.wstride
        raws = [("x", plan.xraw, plan.rows * n, n % 4),
                ("w", plan.wraw, 8 * n, n % 4)]
        tiles = -(-b // mxv.MMA_M) * -(-m // mxv.MMA_N)
    else:
        assert plan.mt == min(32, max(4, 1 << (min(m, 32) - 1).bit_length()))
        assert plan.threads <= 32 * mxv.WARPS and plan.threads % 32 == 0
        assert plan.rows * plan.ks * plan.mt == plan.threads
        assert plan.kc % 16 == 0 and plan.ks & (plan.ks - 1) == 0
        # strides of an odd number of 16-byte units
        assert plan.wstride % 32 == 16 and plan.xstride % 32 == 16
        red = 4 * plan.threads if plan.ks > 1 else 0
        rows_end = plan.mt * plan.wstride + plan.rows * plan.xstride + red
        raws = [("w", plan.wraw, plan.mt * n, n % 16),
                ("x", plan.xraw, plan.rows * n * elem, n * elem % 4)]
        # no more parts of k than N has 16-column units, at most 4; no more
        # row groups than B fills
        assert plan.ks <= min(mxv.KS, max(1, -(-n // 16)))
        assert plan.rows == 32 // plan.mt or plan.rows // 2 < b
        tiles = -(-b // (32 // plan.mt)) * -(-m // plan.mt)
    # where one chunk takes all of k, unaligned rows go as one region: room
    # for it (up to 15 bytes more on either side, and the last row's reads
    # past N) after the rows, one area after the other, 16-byte aligned
    end = rows_end
    for label, off, nbytes, unaligned in raws:
        if plan.chunk >= n and unaligned:
            assert off == end and off % 16 == 0, (label, plan)
            end = off + -(-(nbytes + 32) // 16) * 16
        else:
            assert off == 0, (label, plan)
    assert plan.smem_bytes == end
    # the grid reaches the card's SMs wherever there are that many tiles
    assert plan.grid[0] * plan.grid[1] >= min(mxv.SMS, tiles), plan
    return plan


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("b,n,m", PLAN_SHAPES)
def test_mxv_plan_covers_every_output_once(b, n, m, dtype):
    _check_plan(b, n, m, dtype)


def test_mxv_plan_at_the_paths_shapes():
    """The CM main path's (256, 252, 28): 32-column tiles (4 of 32 lanes
    idle at M = 28), k over 4 warps of 64 columns, one chunk, 256 blocks,
    the crossbar slice as one region (252-byte rows); at M = 4 and 8 (the
    DAC's lenet) no lane idles; the DAC's three shapes on the int8 kernel:
    8, 43 and 2 blocks of 16 x 8 tiles, N = 9 as one region."""
    p = mxv.mxv_plan(256, 252, 28)
    assert (p.mt, p.rows, p.ks, p.kc, p.chunk, p.grid, p.threads) == \
        (32, 1, 4, 64, 256, (256, 1), 128)
    assert p.wraw and not p.xraw
    assert not mxv.mxv_plan(256, 256, 28).wraw
    assert mxv.mxv_plan(1, 252, 28).rows == 1
    for m, mt in ((4, 4), (8, 8), (10, 16), (28, 32), (129, 32)):
        assert mxv.mxv_plan(100, 36, m).mt == mt
    for (b, n, m), grid in (((121, 36, 8), (8, 1)), ((676, 9, 4), (43, 1)),
                            ((1, 200, 10), (1, 2))):
        p = mxv.mxv_plan(b, n, m, torch.int8)
        assert (p.grid, p.rows, p.chunk) == (grid, 16, -(-n // 32) * 32)
        assert bool(p.xraw) == bool(p.wraw) == (n == 9)
    # rows a block grow, and then k parts are traded for rows, only while
    # the grid keeps 132 blocks
    assert [(p.rows, p.ks) for p in map(lambda b: mxv.mxv_plan(b, 252, 28),
                                        (262, 263, 524, 525))] == \
        [(1, 4), (2, 4), (2, 4), (4, 2)]
    assert mxv.mxv_plan(1024, 256, 256).ks == 1


def test_mxv_plan_is_cached_and_refuses_empty_shapes():
    assert mxv.mxv_plan(256, 252, 28) is mxv.mxv_plan(256, 252, 28)
    assert mxv.mxv_plan(256, 252, 28, torch.bfloat16).xstride < \
        mxv.mxv_plan(256, 252, 28).xstride
    for shape in ((0, 4, 4), (4, 0, 4), (4, 4, 0)):
        with pytest.raises(ValueError):
            mxv.mxv_plan(*shape)


@given(b=st.integers(1, 3000), n=st.integers(1, 6000), m=st.integers(1, 300),
       dtype=st.sampled_from(DTYPES))
@settings(max_examples=60, deadline=None, derandomize=True)
def test_mxv_plan_covers_random_shapes(b, n, m, dtype):
    _check_plan(b, n, m, dtype)


# ------------------------------------------- the float kernel's sum order
def _fma(a, b, c):
    # a * b is exact in float64; the sum rounds twice (to f64, then f32),
    # which differs from one fused rounding far below the 1e-5 bound
    return (a.astype(np.float64) * b + c).astype(np.float32)


def emulate_float_kernel(x, wq, scale):
    """``csrc/mxv.cu``'s float kernel in float32 numpy, in its order: each
    k part (``mxv_plan``'s ``kc`` columns of each ``chunk``) summed in
    ascending k into 4 accumulators, k mod 4 picking one, by fused
    multiply-adds; (a0 + a1) + (a2 + a3); the parts added in ascending
    order; one multiply by the scale."""
    b, n = x.shape
    m = wq.shape[0]
    plan = mxv.mxv_plan(b, n, m)
    w = wq.astype(np.float32)
    parts = np.zeros((plan.ks, b, m), np.float32)
    acc = np.zeros((plan.ks, 4, b, m), np.float32)
    for k in range(n):
        p = (k % plan.chunk) // plan.kc
        acc[p, k % 4] = _fma(x[:, k, None], w[None, :, k], acc[p, k % 4])
    for p in range(plan.ks):
        parts[p] = (acc[p, 0] + acc[p, 1]) + (acc[p, 2] + acc[p, 3])
    total = parts[0]
    for p in range(1, plan.ks):
        total = total + parts[p]
    return total * scale[None, :]


@pytest.mark.parametrize("b,n,m", [(256, 252, 28), (17, 130, 129),
                                   (4, 3000, 28)])
def test_float_kernel_order_matches_pallas(b, n, m):
    """The float kernel's fixed summation order, emulated, against the
    Pallas kernel in interpret mode at the bound of ``tests/test_kernels.py``
    (1e-5): the main path's shape, a ragged edge, and an N whose k takes
    two chunks (the accumulators carry across them)."""
    x, wq, ws = _inputs(b, n, m, seed=n + m)
    got = emulate_float_kernel(x, wq, ws)
    want = np.asarray(jmxv.crossbar_mxv_padded(x, wq, ws, interpret=True))
    if n == 3000:
        assert mxv.mxv_plan(b, n, m).chunk < n
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
