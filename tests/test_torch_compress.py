"""The port's gradient compression (``repro_torch.distributed.compression``)
and its hand-written int8 pass (``repro_torch.kernels.compress``), and
AdamW's f32 gradients beside bf16 parameters.

On the CPU, against the JAX package's ``repro.distributed.compression`` on
the same numpy inputs from a seed:

* ``quantize_blockwise``'s codes and scales and ``dequantize_blockwise``
  bit-equal (torch and XLA on the CPU both divide, round half to even and
  multiply in IEEE f32: no gap was measured), over ragged sizes, every
  block from 16 to 1,024 and scales from 1e-3 to 1e3;
* ``topk_sparsify`` keeping the same set on inputs without ties, and
  ``topk_densify`` equal;
* ``compress_with_feedback`` equal trees (compressed values and residuals),
  int8 and top-k, with and without error feedback, bit for bit;
* the reference's own cases (``tests/test_distributed.py``) carried over
  to the port's functions as parametrised cases: the int8 round trip's
  bound (``absmax_block / 254``), zero and constant blocks, the EF residual
  and its promotion of a coordinate, EF-SGD converging on a quadratic
  (int8 and top-k), ``wire_bytes``;
* the kernel's plain version (``compress_int8_ref_``, what the wrapper runs
  on CPU tensors) bit-equal to ``compress_with_feedback`` over a tree, with
  and without residuals; ``compress_in_place`` equal to
  ``compress_with_feedback`` on a zero residual; non-finite blocks as the
  kernel module documents them; the wrapper's refusals;
* AdamW's plain version with f32 gradients beside bf16 parameters against
  the reference's ``adamw_update`` (which casts every gradient to f32).

On the card (marked ``cuda``; JAX is imported only inside the CPU tests, so
they run on a machine without it: ``python -m pytest -q -m cuda
tests/test_torch_compress.py``): the kernel bit-equal to its plain version
on small trees (ragged sizes, blocks 16 to 1,024, a block that is not a
multiple of 4 and a misaligned tensor, which take the scalar path, with and
without residuals), one launch a call, non-finite blocks, and AdamW's
kernels with f32 gradients bit-equal to their plain version.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro_torch.distributed import compression as tc
from repro_torch.kernels import adamw as kadamw
from repro_torch.kernels import compress as kcompress
from repro_torch.optim.adamw import hyper_values

# (n, block, scale, seed): ragged sizes, every block size class, scales
CASES = [(1, 16, 1.0, 0), (1000, 256, 3.0, 1), (4097, 64, 1e-3, 2),
         (333, 17, 1e3, 3), (100_000, 256, 1.0, 4), (5000, 1024, 0.1, 5),
         (256, 256, 2.0, 6), (70, 1024, 1.0, 7)]


def _ref():
    from repro.distributed import compression
    return compression


def _x(n, scale, seed):
    return (np.random.default_rng(seed).standard_normal(n) * scale
            ).astype(np.float32)


def _same_bits(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and a.dtype == b.dtype and \
        a.tobytes() == b.tobytes()


@pytest.mark.parametrize("n,block,scale,seed", CASES)
def test_quantize_and_dequantize_are_the_references_bits(n, block, scale,
                                                          seed):
    import jax.numpy as jnp
    ref = _ref()
    x = _x(n, scale, seed)
    jq, js = ref.quantize_blockwise(jnp.asarray(x), block)
    q, s = tc.quantize_blockwise(torch.from_numpy(x), block)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert _same_bits(q.numpy(), jq) and _same_bits(s.numpy(), js)
    back = tc.dequantize_blockwise(q, s, (n,))
    assert _same_bits(back.numpy(), ref.dequantize_blockwise(jq, js, (n,)))
    # a 2-d leaf, viewed flat
    x2 = x[: (n // 2) * 2].reshape(2, -1)
    if x2.size:
        jq2, js2 = ref.quantize_blockwise(jnp.asarray(x2), block)
        q2, s2 = tc.quantize_blockwise(torch.from_numpy(x2), block)
        assert _same_bits(q2.numpy(), jq2) and _same_bits(s2.numpy(), js2)
        assert _same_bits(tc.dequantize_blockwise(q2, s2, x2.shape).numpy(),
                          ref.dequantize_blockwise(jq2, js2, x2.shape))


@pytest.mark.parametrize("n,frac,seed", [(4, 0.5, 0), (100, 0.1, 1),
                                         (512, 0.3, 2), (1000, 0.01, 3)])
def test_topk_keeps_the_references_set(n, frac, seed):
    import jax.numpy as jnp
    ref = _ref()
    x = _x(n, 1.0, seed)
    assert len(np.unique(np.abs(x))) == n            # no ties
    jv, ji = ref.topk_sparsify(jnp.asarray(x), frac)
    v, i = tc.topk_sparsify(torch.from_numpy(x), frac)
    assert i.dtype == torch.int32
    assert sorted(i.tolist()) == sorted(np.asarray(ji).tolist())
    assert _same_bits(np.sort(v.numpy()), np.sort(np.asarray(jv)))
    assert _same_bits(tc.topk_densify(v, i, (n,)).numpy(),
                      ref.topk_densify(jv, ji, (n,)))


def _tree(seed):
    rng = np.random.default_rng(seed)
    return {"w": (rng.standard_normal((7, 300)) * 0.1).astype(np.float32),
            "b": rng.standard_normal(33).astype(np.float32),
            "s": np.zeros(5, np.float32)}


@pytest.mark.parametrize("kind,block,ef", [("int8", 256, True),
                                           ("int8", 64, False),
                                           ("int8", 17, True),
                                           ("topk", 256, True),
                                           ("topk", 256, False),
                                           ("none", 256, True)])
def test_compress_with_feedback_gives_the_references_trees(kind, block, ef):
    import jax
    import jax.numpy as jnp
    ref = _ref()
    g, e = _tree(0), {k: v * 0.01 for k, v in _tree(1).items()}
    jspec = ref.CompressionSpec(kind=kind, block=block, topk_frac=0.1,
                                error_feedback=ef)
    spec = tc.CompressionSpec(kind=kind, block=block, topk_frac=0.1,
                              error_feedback=ef)
    tg = {k: torch.from_numpy(v.copy()) for k, v in g.items()}
    te = {k: torch.from_numpy(v.copy()) for k, v in e.items()}
    for _ in range(2):                    # the second step feeds e' back
        jc, je = ref.compress_with_feedback(
            jax.tree.map(jnp.asarray, g), jax.tree.map(jnp.asarray, e), jspec)
        c, te = tc.compress_with_feedback(tg, te, spec)
        for k in g:
            assert _same_bits(c[k].numpy(), jc[k]), k
            assert _same_bits(te[k].numpy(), je[k]), k
        e = jax.tree.map(np.asarray, je)


# ----------------------------------------- the reference's own cases, ported
@settings(max_examples=40, deadline=None)
@given(n=st.integers(1, 2048), block=st.sampled_from([16, 64, 256]),
       scale=st.floats(1e-3, 1e3), seed=st.integers(0, 2**31 - 1))
def test_int8_roundtrip_error_bound(n, block, scale, seed):
    """|x - dq(q(x))| <= absmax_block / 254 per element (symmetric int8),
    the plain functions and the kernel's plain version alike."""
    x = (np.random.default_rng(seed).standard_normal(n) * scale
         ).astype(np.float32)
    q, s = tc.quantize_blockwise(torch.from_numpy(x), block)
    back = tc.dequantize_blockwise(q, s, (n,)).numpy()
    inplace = torch.from_numpy(x.copy())
    kcompress.compress_int8_([inplace], block=block)
    assert _same_bits(inplace.numpy(), back)
    n_blocks = -(-n // block)
    pad = lambda a: np.pad(a, (0, n_blocks * block - n)).reshape(
        n_blocks, block)
    xpad = pad(x)
    bound = np.abs(xpad).max(axis=1, keepdims=True) / 254.0 + 1e-7
    assert (np.abs(xpad - pad(back)) <= bound + 1e-6 * np.abs(xpad)).all()


@pytest.mark.parametrize("case", ["zero", "constant"])
def test_int8_exact_on_zero_and_constant(case):
    if case == "zero":
        q, s = tc.quantize_blockwise(torch.zeros(100), 32)
        assert tc.dequantize_blockwise(q, s, (100,)).sum().item() == 0
        assert torch.equal(s, torch.ones(4))
    else:
        q, s = tc.quantize_blockwise(torch.full((64,), 3.5), 32)
        np.testing.assert_allclose(
            tc.dequantize_blockwise(q, s, (64,)).numpy(), 3.5, rtol=1e-6)


def test_error_feedback_accumulates_residual():
    """One compressed step leaves residual = x - C(x); the next step's
    compression target includes it (EF21 invariant)."""
    spec = tc.CompressionSpec(kind="topk", topk_frac=0.5)       # k = 2
    g = {"w": torch.tensor([4.0, 0.3, 0.2, 0.05])}
    ef = tc.init_error_feedback(g)
    c, ef = tc.compress_with_feedback(g, ef, spec)
    np.testing.assert_allclose(c["w"].numpy(), [4, 0.3, 0, 0], atol=1e-6)
    np.testing.assert_allclose(ef["w"].numpy(), [0, 0, 0.2, 0.05], atol=1e-6)
    # second step: same grads; the residual promotes coord 2 (0.2 + 0.2 =
    # 0.4) over coord 1 (0.3) into the top-2
    c2, _ = tc.compress_with_feedback(g, ef, spec)
    np.testing.assert_allclose(c2["w"].numpy(), [4, 0, 0.4, 0], atol=1e-6)


@pytest.mark.parametrize("kind", ["int8", "topk"])
def test_ef_sgd_converges_on_quadratic(kind):
    """Compressed SGD with error feedback drives ||x|| to ~0 on
    f = 0.5 ||x||^2."""
    spec = tc.CompressionSpec(kind=kind, topk_frac=0.3, block=16,
                              error_feedback=True)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(32) * 5
                         ).to(torch.float32)
    ef = tc.init_error_feedback({"x": x})
    for _ in range(300):
        c, ef = tc.compress_with_feedback({"x": x}, ef, spec)
        x = x - 0.3 * c["x"]
    assert torch.linalg.norm(x).item() < 1e-2


@pytest.mark.parametrize("kind,kw,n,want", [
    ("int8", {"block": 256}, 1024, 1024 + 4 * 4),
    ("topk", {"topk_frac": 0.01}, 10_000, 8 * 100),
    ("none", {}, 10, 40)])
def test_wire_bytes_model(kind, kw, n, want):
    ref = _ref()
    assert tc.CompressionSpec(kind=kind, **kw).wire_bytes(n) == want == \
        ref.CompressionSpec(kind=kind, **kw).wire_bytes(n)


# --------------------------------------------- the kernel's plain version
def _torch_tree(seed, sizes=((7, 300), (33,), (5,), (1,), (1030,))):
    gen = torch.Generator().manual_seed(seed)
    return [torch.randn(s, generator=gen) * (0.1 + i) for i, s in
            enumerate(sizes)]


@pytest.mark.parametrize("block", [16, 17, 256, 1024])
@pytest.mark.parametrize("residual", [False, True])
def test_plain_version_is_compress_with_feedback(block, residual):
    gs = _torch_tree(0)
    es = [g * 0.01 for g in _torch_tree(1)] if residual else None
    names = [f"t{i}" for i in range(len(gs))]
    spec = tc.CompressionSpec(kind="int8", block=block)
    ef = dict(zip(names, es)) if residual else tc.init_error_feedback(
        dict(zip(names, gs)))
    want_c, want_e = tc.compress_with_feedback(dict(zip(names, gs)), ef,
                                               spec)
    got_g = [g.clone() for g in gs]
    got_e = [e.clone() for e in es] if residual else None
    before = kcompress.LAUNCHES["compress"]
    kcompress.compress_int8_(got_g, got_e, block=block)
    assert kcompress.LAUNCHES["compress"] == before     # no kernel here
    for i, k in enumerate(names):
        assert _same_bits(got_g[i].numpy(), want_c[k].numpy())
        if residual:
            assert _same_bits(got_e[i].numpy(), want_e[k].numpy())


@pytest.mark.parametrize("kind", ["int8", "topk", "none"])
def test_compress_in_place_is_a_zero_residual(kind):
    spec = tc.CompressionSpec(kind=kind, block=64, topk_frac=0.1)
    tree = dict(zip("abcde", _torch_tree(2)))
    want, _ = tc.compress_with_feedback(tree, tc.init_error_feedback(tree),
                                        spec)
    got = {k: v.clone() for k, v in tree.items()}
    tc.compress_in_place(got, spec)
    for k in tree:
        assert _same_bits(got[k].numpy(), want[k].numpy()), k


def _non_finite(device="cpu"):
    """Three blocks of 16: one holding an Inf, one holding a NaN, one
    finite."""
    x = torch.full((48,), 0.25, device=device)
    x[:4] = torch.tensor([0.3, float("inf"), -2.6, 1.0])
    x[16:20] = torch.tensor([0.5, float("nan"), -2.6, 7.4])
    return x


def test_non_finite_blocks():
    """A block holding an Inf comes out NaN (its scale is Inf, 0 x Inf); a
    block holding a NaN keeps scale 1 (the max keeps the NaN, as
    ``jnp.max``), so its finite elements come out rounded to integers."""
    x = _non_finite()
    _, s = tc.quantize_blockwise(x, 16)
    assert s[0].item() == float("inf") and s[1].item() == 1.0
    g = x.clone()
    kcompress.compress_int8_([g], block=16)
    # the Inf and the NaN themselves go through an int8 cast here (undefined)
    assert torch.isnan(g[[0, 2, 3, 4, 15]]).all()
    assert g[16].item() == 0.0 and g[18].item() == -3.0 and \
        g[19].item() == 7.0 and g[20].item() == 0.0
    assert torch.equal(g[32:], x[32:])


def test_wrapper_refuses_what_the_kernel_refuses():
    g = torch.zeros(64)
    with pytest.raises(TypeError, match="f32"):
        kcompress.compress_int8_([g.bfloat16()])
    with pytest.raises(ValueError, match="block"):
        kcompress.compress_int8_([g], block=8)
    with pytest.raises(ValueError, match="block"):
        kcompress.compress_int8_([g], block=2048)
    with pytest.raises(ValueError, match="contiguous"):
        kcompress.compress_int8_([torch.zeros(8, 8).t()])
    with pytest.raises(ValueError, match="residual"):
        kcompress.compress_int8_([g], [torch.zeros(63)])
    with pytest.raises(ValueError, match="residuals"):
        kcompress.compress_int8_([g], [])
    with pytest.raises(ValueError, match="no tensors"):
        kcompress.compress_int8_([])


# --------------------------------------------- AdamW with f32 gradients
def test_adamw_takes_f32_gradients_beside_bf16_parameters():
    """The reference casts every gradient to f32 before its update: an f32
    gradient beside a bf16 parameter (the accumulated step's) gives its
    result, and the plain version gives the bf16 gradient's bits where the
    f32 gradient holds the same values."""
    import jax
    import jax.numpy as jnp
    from repro.optim import adamw_init as jinit, adamw_update as jupdate
    rng = np.random.default_rng(3)
    shapes = {"w": (64, 48), "b": (48,)}
    p16 = {k: torch.from_numpy(rng.standard_normal(s).astype(np.float32)
                               ).bfloat16() for k, s in shapes.items()}
    g32 = {k: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
           for k, s in shapes.items()}
    names = list(shapes)
    hyper = torch.tensor(hyper_values(1, 1e-2))
    p, m, v = ([p16[k].clone() for k in names],
               [torch.zeros(shapes[k]) for k in names],
               [torch.zeros(shapes[k]) for k in names])
    gnorm = kadamw.adamw_step(p, [g32[k] for k in names], m, v,
                              [True, False], hyper)
    import ml_dtypes
    jp = {k: jnp.asarray(p16[k].float().numpy().astype(ml_dtypes.bfloat16))
          for k in names}
    jopt = jinit(jp)
    newp, newopt, met = jupdate({k: jnp.asarray(g32[k].numpy())
                                 for k in names}, jopt, jp, 1e-2)
    np.testing.assert_allclose(gnorm.item(), float(met["grad_norm"]),
                               rtol=1e-5)
    for i, k in enumerate(names):
        np.testing.assert_allclose(m[i].numpy(), np.asarray(newopt.mu[k]),
                                   rtol=0, atol=1e-6)
        got = p[i].float().numpy()
        want = np.asarray(newp[k]).astype(np.float32)
        # one bf16 ulp at the parameters' magnitude
        assert np.abs(got - want).max() <= 2.0 ** -7 * max(
            1.0, np.abs(want).max())
    # f32 gradients holding bf16 values give the bf16 gradients' bits
    g16 = [g32[k].bfloat16() for k in names]
    a = [[p16[k].clone() for k in names]] + [
        [torch.zeros(shapes[k]) for k in names] for _ in range(2)]
    b = [[p16[k].clone() for k in names]] + [
        [torch.zeros(shapes[k]) for k in names] for _ in range(2)]
    na = kadamw.adamw_step(a[0], g16, a[1], a[2], [True, False], hyper)
    nb = kadamw.adamw_step(b[0], [g.float() for g in g16], b[1], b[2],
                           [True, False], hyper)
    assert torch.equal(na, nb)
    for x, y in zip(sum(a, []), sum(b, [])):
        assert torch.equal(x, y)
    with pytest.raises(ValueError, match="gradient dtype"):
        kadamw.adamw_step([torch.zeros(4)], [torch.zeros(4).bfloat16()],
                          [torch.zeros(4)], [torch.zeros(4)], [True], hyper)


# ------------------------------------------------------------------ the card
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the compression kernel has no "
                    "CPU mode")
    return torch.device("cuda", 0)


SIZES = [(3,), (16,), (1000,), (7, 300), (1,), (65_537,), (4, 1024)]


def _card_tree(dev, seed, scale=1.0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn(s, generator=gen, device=dev) * (scale + i)
            for i, s in enumerate(SIZES)]


@pytest.mark.cuda
@pytest.mark.parametrize("block", [16, 17, 64, 256, 1000, 1024])
@pytest.mark.parametrize("residual", [False, True])
def test_kernel_equals_the_plain_version_on_the_card(cuda_device, block,
                                                     residual):
    gs = _card_tree(cuda_device, 0)
    es = [e * 0.01 for e in _card_tree(cuda_device, 1)] if residual \
        else None
    want_g = [g.clone() for g in gs]
    want_e = [e.clone() for e in es] if residual else None
    before = kcompress.LAUNCHES["compress"]
    kcompress.compress_int8_(gs, es, block=block)
    assert kcompress.LAUNCHES["compress"] == before + 1
    kcompress.compress_int8_ref_(want_g, want_e, block)
    torch.cuda.synchronize()
    for got, want in zip(gs + (es or []), want_g + (want_e or [])):
        assert torch.equal(got, want)


@pytest.mark.cuda
def test_kernel_on_a_misaligned_tensor_and_non_finite_blocks(cuda_device):
    """A tensor 4 bytes off 16-byte alignment takes the scalar path; a
    block with an Inf comes out NaN, a block with a NaN keeps scale 1."""
    base = torch.randn(1 + 4096, device=cuda_device)
    g = base[1:]
    want = g.clone()
    kcompress.compress_int8_([g], block=256)
    kcompress.compress_int8_ref_([want], None, 256)
    assert torch.equal(g, want)
    x = _non_finite(cuda_device)
    kcompress.compress_int8_([x], block=16)
    assert torch.isnan(x[:16]).all() and torch.isnan(x[17])
    assert x[16].item() == 0.0 and x[18].item() == -3.0 and \
        x[19].item() == 7.0
    assert torch.equal(x[32:], _non_finite(cuda_device)[32:])


@pytest.mark.cuda
def test_adamw_kernels_take_f32_gradients_on_the_card(cuda_device):
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    shapes = [(3,), (8193,), (64, 1000), (5, 7)]
    ps = [torch.randn(s, generator=gen, device=cuda_device).bfloat16()
          for s in shapes]
    gs = [torch.randn(s, generator=gen, device=cuda_device) * 3
          for s in shapes]
    ms = [torch.randn(s, generator=gen, device=cuda_device) * 0.1
          for s in shapes]
    vs = [torch.rand(s, generator=gen, device=cuda_device) * 0.01
          for s in shapes]
    ms[1], vs[1] = ms[1].bfloat16(), vs[1].bfloat16()      # a bf16 pair
    dec = [True, False, True, True]
    hyper = torch.tensor(hyper_values(3, 2e-3), device=cuda_device)
    want = [[t.clone() for t in ts] for ts in (ps, ms, vs)]
    got_norm = kadamw.adamw_step(ps, gs, ms, vs, dec, hyper)
    want_norm = kadamw.adamw_step_ref(want[0], gs, want[1], want[2], dec,
                                      hyper)
    torch.cuda.synchronize()
    assert abs(got_norm.item() - want_norm.item()) <= 1e-6 * want_norm.item()
    for got, exp in zip(ps + ms + vs, want[0] + want[1] + want[2]):
        assert torch.equal(got, exp)
