"""The selective scan's backward in the port: its plain version against
``jax.vjp`` of the JAX package's chunked scan, ``SelectiveScan``'s gradients
by ``gradcheck``, and the routing of training and serving calls.

``ref.selective_scan_bwd_ref`` (the reverse-time recurrence written out,
what the backward kernels of ``csrc/mamba_scan_bwd.cu`` compute) is held to
``jax.vjp`` of ``repro.models.layers._ssm_scan_chunked`` plus the skip term
``d_skip * u`` at 1e-5 x max(1, max|g|) in f32 (the two sum the same f32
products in other orders): L a multiple of the chunk and not, L = 1, N = 1,
4 and 17.  On CPU tensors ``SelectiveScan`` runs the plain versions with
the saved tensors the card's kernels get; ``gradcheck`` holds its gradients
in f64.  The card's kernels are held against the same plain version by the
``cuda`` tests of ``tests/test_torch_kernels_cuda.py`` and by
``chip_smoke.py`` phase 23.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.layers as JL
from repro_torch.kernels import mamba_scan, ops, ref
from test_torch_train import _one_torch_thread  # noqa: F401

RNG = np.random.default_rng(23)


def _inputs(b, l, d, n, rng=RNG):
    u = rng.normal(size=(b, l, d)).astype(np.float32)
    dt = np.log1p(np.exp(rng.normal(size=(b, l, d)) - 1.0)).astype(np.float32)
    a = -np.exp(rng.normal(size=(d, n)) * 0.3
                + np.log(np.arange(1, n + 1))).astype(np.float32)
    bb = rng.normal(size=(b, l, n)).astype(np.float32)
    cc = rng.normal(size=(b, l, n)).astype(np.float32)
    dsk = rng.normal(size=(d,)).astype(np.float32)
    dy = rng.normal(size=(b, l, d)).astype(np.float32)
    return u, dt, a, bb, cc, dsk, dy


def _reference_vjp(u, dt, a, bb, cc, dsk, dy, chunk):
    """``jax.vjp`` of the reference's chunked scan plus the skip term, the
    model's y, at cotangent ``dy`` on y (none on the final state)."""
    def f(u, dt, a, bb, cc, dsk):
        y, _ = JL._ssm_scan_chunked(u, dt, a, bb, cc, chunk)
        return y + dsk[None, None] * u
    _, vjp = jax.vjp(f, *map(jnp.asarray, (u, dt, a, bb, cc, dsk)))
    return vjp(jnp.asarray(dy))


def _close(got, want, tol=1e-5):
    want = np.asarray(want)
    got = got.detach().float().numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(1.0, np.abs(want).max()))


@pytest.mark.parametrize("b,l,d,n,chunk", [
    (2, 16, 8, 4, 4),        # four chunks of the reference carry g
    (1, 13, 6, 3, 4),        # L no chunk divides: the reference's one chunk
    (2, 1, 5, 4, 8),         # L = 1
    (1, 20, 7, 1, 8),        # N = 1
    (2, 24, 5, 17, 8),       # N = 17: two groups of the kernel
    (1, 40, 9, 16, 8)])      # past two of the kernel's chunks of 16 steps
def test_bwd_ref_matches_reference_vjp(b, l, d, n, chunk):
    args = _inputs(b, l, d, n)
    want = _reference_vjp(*args, chunk)
    got = ref.selective_scan_bwd_ref(*map(torch.from_numpy, args))
    assert [g.dtype for g in got] == [torch.float32] * 6
    for g, w in zip(got, want):
        _close(g, w)


LOG2E = 1.4426950408889634
# csrc/mamba_scan_bwd.cu's reverse walk: state columns a group, lanes a
# channel (2 columns each), warps a block, groups of RG lanes a warp
GW, RG, WARPS, GROUPS = 16, 8, 8, 4


def _tree(x, dim):
    """``x`` summed over ``dim`` (a power of two) as a reduce-scatter of
    shuffles sums it: halves first, (i, i + n/2) pairs, then the halves'
    halves."""
    x = x.movedim(dim, -1)
    while x.shape[-1] > 1:
        h = x.shape[-1] // 2
        x = x[..., :h] + x[..., h:]
    return x[..., 0]


def _kernel_emulation(u, dt, a, bb, cc, dsk, dy, drop_at=None):
    """The arithmetic of ``csrc/mamba_scan_bwd.cu`` in f32 torch: the states
    at the chunks' starts by a forward walk (kernel 1); each chunk's states
    recomputed from its stored start, g walked back and carried across
    chunks (kernel 2); du's and ddt's shares summed over a lane's 2
    columns, then over the channel's 8 lanes in the reduce-scatter's order,
    then over the groups in order; dB's and dC's terms over a lane's
    channels in order, then over the warp's 4 groups of lanes in the
    reduce-scatter's order, then over the block's 8 warps in order, then
    over the blocks of ``BWD_CHANNELS`` channels in order (kernel 3); dA
    and dD per sequence, then over the sequences.  Channels, columns and steps past Din, N and L run as zeros.
    ``drop_at``: g not carried from that step (a chunk's start) into the
    step before it, the planted fault."""
    tc, ch = mamba_scan.BWD_CHUNK, mamba_scan.BWD_CHANNELS
    per_warp = ch // WARPS
    bsz, l, d = u.shape
    n = a.shape[1]
    lp, dp, npad = -(-l // tc) * tc, -(-d // ch) * ch, -(-n // GW) * GW

    def pad(x, *shape):
        out = torch.zeros(shape, dtype=torch.float32)
        out[tuple(slice(0, s) for s in x.shape)] = torch.from_numpy(x)
        return out
    u, dt, dy = (pad(x, bsz, lp, dp) for x in (u, dt, dy))
    bb, cc = (pad(x, bsz, lp, npad) for x in (bb, cc))
    af, dsk = pad(a, dp, npad), pad(dsk, dp)
    a2 = af * LOG2E
    at = torch.exp2(dt[..., None] * a2)                   # (B, L, D, N)
    dtu = dt * u
    chunks = lp // tc
    start = [torch.zeros((bsz, dp, npad))]
    h = start[0]
    for t in range(lp - tc):
        h = h * at[:, t] + dtu[:, t, :, None] * bb[:, t, None, :]
        if (t + 1) % tc == 0:
            start.append(h)
    g = torch.zeros((bsz, dp, npad))
    an = torch.zeros((bsz, dp, npad))
    da = torch.zeros((bsz, dp, npad))
    du, ddt = torch.zeros((bsz, lp, dp)), torch.zeros((bsz, lp, dp))
    db, dc = torch.zeros((bsz, lp, npad)), torch.zeros((bsz, lp, npad))
    skip = torch.zeros((dp, npad // GW, RG))
    skip[:, 0, 0] = dsk                   # lane 0 of group 0 adds D dy
    lanes = (bsz, dp, npad // GW, RG, 2)
    for k in reversed(range(chunks)):
        hs = [start[k]]
        for t in range(k * tc, (k + 1) * tc):
            hs.append(hs[-1] * at[:, t] + dtu[:, t, :, None] * bb[:, t, None, :])
        if drop_at is not None and (k + 1) * tc == drop_at:
            g = torch.zeros_like(g)
        for j in reversed(range(tc)):
            t = k * tc + j
            g = an * g + dy[:, t, :, None] * cc[:, t, None, :]
            q = g * (at[:, t] * hs[j])
            gb = (g * bb[:, t, None, :]).reshape(lanes)
            sdu = gb[..., 0] + gb[..., 1]
            qa = (af * q).reshape(lanes)
            sq = qa[..., 0] + qa[..., 1]
            dtv, uv, dyv = (x[:, t, :, None, None] for x in (dt, u, dy))
            x_du = dtv * sdu + skip * dyv
            x_dt = uv * sdu + sq
            for out, x in ((du, x_du), (ddt, x_dt)):
                per_group = _tree(x, 3)                   # (B, D, groups)
                acc = per_group[..., 0]
                for grp in range(1, per_group.shape[-1]):
                    acc = acc + per_group[..., grp]
                out[:, t] = acc
            da = da + dt[:, t, :, None] * q
            for out, term in ((db, g * dtu[:, t, :, None]),
                              (dc, dy[:, t, :, None] * hs[j + 1])):
                by_lane = term.reshape(bsz, dp // per_warp, GROUPS,
                                       per_warp // GROUPS, npad)
                lane = by_lane[:, :, :, 0]        # a lane's channels, in order
                for kk in range(1, by_lane.shape[3]):
                    lane = lane + by_lane[:, :, :, kk]
                warps = _tree(lane, 2)
                blocks = warps.reshape(bsz, dp // ch, WARPS, npad)
                per_block = torch.zeros((bsz, dp // ch, npad))
                for w in range(WARPS):
                    per_block = per_block + blocks[:, :, w]
                acc = torch.zeros((bsz, npad))
                for blk in range(dp // ch):
                    acc = acc + per_block[:, blk]
                out[:, t] = acc
            an = at[:, t]
    dd_seq = (dy * u).flip(1).sum(1)                    # reverse order
    da_all, dd_all = torch.zeros((dp, npad)), torch.zeros(dp)
    for b in range(bsz):
        da_all, dd_all = da_all + da[b], dd_all + dd_seq[b]
    return (du[:, :l, :d], ddt[:, :l, :d], da_all[:d, :n], db[:, :l, :n],
            dc[:, :l, :n], dd_all[:d])


@pytest.mark.parametrize("b,l,d,n,chunk", [
    (2, 16, 8, 4, 4), (1, 13, 6, 3, 4), (2, 1, 5, 4, 8), (1, 20, 7, 1, 8),
    (2, 24, 5, 17, 8), (1, 40, 9, 16, 8),
    (2, 40, 70, 16, 8)])     # three of the kernel's blocks of 32 channels
def test_kernel_arithmetic_matches_reference_vjp(b, l, d, n, chunk):
    """The backward kernels' arithmetic (chunks recomputed from their
    stored starts, g carried, the sums in the kernels' order) emulated in
    f32 torch against ``jax.vjp`` of the reference's chunked scan."""
    args = _inputs(b, l, d, n)
    want = _reference_vjp(*args, chunk)
    for g, w in zip(_kernel_emulation(*args), want):
        _close(g, w)


@pytest.mark.parametrize("b,l,d,n", [(1, 40, 9, 16), (2, 40, 70, 16)])
def test_kernel_arithmetic_with_carry_dropped_misses(b, l, d, n):
    """The tolerance sees the kernel with g not carried across the chunk
    boundary ``chip_smoke.py``'s planted fault drops it at."""
    args = _inputs(b, l, d, n)
    want = _reference_vjp(*args, 8)
    tc = mamba_scan.BWD_CHUNK
    bad = _kernel_emulation(*args, drop_at=tc * (-(-l // tc) // 2))
    missed = []
    for g, w in zip(bad, want):
        w = np.asarray(w)
        err = np.abs(g.numpy() - w).max()
        missed.append(err > 1e-5 * max(1.0, np.abs(w).max()))
    assert missed[:4] == [True] * 4      # du, ddt, dA, dB take g's carry


def test_bwd_wrapper_on_cpu_is_the_plain_version():
    """The wrapper runs the plain version on CPU tensors, launches nothing,
    and checks dy's shape."""
    args = [torch.from_numpy(x) for x in _inputs(2, 9, 4, 3)]
    before = dict(mamba_scan.LAUNCHES)
    got = mamba_scan.selective_scan_bwd(*args)
    assert mamba_scan.LAUNCHES == before
    for g, w in zip(got, ref.selective_scan_bwd_ref(*args)):
        assert torch.equal(g, w)
    with pytest.raises(ValueError, match="dy"):
        mamba_scan.selective_scan_bwd(*args[:-1], args[-1][:, :4])


@pytest.mark.parametrize("b,l,d,n", [(1, 5, 3, 2), (2, 4, 2, 3)])
def test_function_gradcheck_f64(b, l, d, n):
    gen = torch.Generator().manual_seed(b * 100 + l)
    u, b_, c = (torch.randn(shape, dtype=torch.float64, generator=gen)
                for shape in ((b, l, d), (b, l, n), (b, l, n)))
    dt = torch.rand((b, l, d), dtype=torch.float64, generator=gen) + 0.1
    a = -torch.rand((d, n), dtype=torch.float64, generator=gen) - 0.5
    dsk = torch.randn((d,), dtype=torch.float64, generator=gen)
    args = [t.requires_grad_(True) for t in (u, dt, a, b_, c, dsk)]
    assert torch.autograd.gradcheck(mamba_scan.SelectiveScan.apply, args)


def test_autograd_goes_through_the_function_and_matches_plain():
    """Where autograd records the call, ``selective_scan`` is
    ``SelectiveScan`` (its backward the plain recurrence on the CPU), and
    its gradients are autograd's of the plain scan; B and C as column
    slices of one projection get theirs through the slices."""
    u, dt, a, bb, cc, dsk, dy = _inputs(2, 11, 5, 4)
    proj = np.concatenate([bb, cc], axis=-1)
    leaves = [torch.from_numpy(x).requires_grad_(True)
              for x in (u, dt, a, proj, dsk)]
    u_, dt_, a_, p_, d_ = leaves
    y = mamba_scan.selective_scan(u_, dt_, a_, p_[..., :4], p_[..., 4:], d_)
    assert type(y.grad_fn).__name__ == "SelectiveScanBackward"
    y.backward(torch.from_numpy(dy))
    plain = [t.detach().clone().requires_grad_(True) for t in leaves]
    pu, pdt, pa, pp, pd = plain
    ref.selective_scan_ref(pu, pdt, pa, pp[..., :4], pp[..., 4:],
                           pd).backward(torch.from_numpy(dy))
    for got, want in zip(leaves, plain):
        _close(got.grad, want.grad.numpy())


def test_bf16_inputs_keep_bf16_gradients():
    args = [torch.from_numpy(x) for x in _inputs(1, 7, 4, 3)]
    u, dt, a, bb, cc, dsk, dy = args
    leaves = [t.to(torch.bfloat16).requires_grad_(True)
              for t in (u, dt, bb, cc)] + [a.requires_grad_(True),
                                           dsk.requires_grad_(True)]
    u_, dt_, b_, c_, a_, d_ = leaves
    mamba_scan.selective_scan(u_, dt_, a_, b_, c_, d_).backward(dy)
    assert [t.grad.dtype for t in leaves] == [torch.bfloat16] * 4 + [
        torch.float32] * 2
    want = ref.selective_scan_bwd_ref(u_.detach(), dt_.detach(), a,
                                      b_.detach(), c_.detach(), dsk, dy)
    for got, w in zip((u_, dt_, a_, b_, c_, d_), want):
        assert torch.equal(got.grad, w)


def test_return_state_raises_under_autograd():
    args = [torch.from_numpy(x) for x in _inputs(1, 4, 3, 2)[:-1]]
    args[0].requires_grad_(True)
    with pytest.raises(ValueError, match="return_state"):
        mamba_scan.selective_scan(*args, return_state=True)
    with pytest.raises(ValueError, match="return_state"):
        ops.mamba_scan(*args)                 # prefill's call asks for hT


def test_serving_calls_take_the_forward_path():
    """With grad off (or no input requiring grad) the call is the forward
    alone, as serving and a CUDA graph's capture make it: no Function, the
    final state available, no backward launch counted."""
    args = [torch.from_numpy(x).requires_grad_(True)
            for x in _inputs(2, 6, 3, 2)[:-1]]
    before = dict(mamba_scan.LAUNCHES)
    with torch.no_grad():
        y, h = mamba_scan.selective_scan(*args, return_state=True)
    assert y.grad_fn is None and tuple(h.shape) == (2, 3, 2)
    frozen = [t.detach() for t in args]
    y2, h2 = ops.mamba_scan(*frozen)
    assert y2.grad_fn is None
    assert torch.equal(y, y2) and torch.equal(h, h2)
    assert mamba_scan.LAUNCHES == before
