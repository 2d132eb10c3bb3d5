"""The port's Listing-1 conv (``repro_torch.kernels.conv2d``) against the JAX
package's.

On CPU tensors ``crossbar_conv2d`` runs its plain version; both it and
``ops.conv2d`` are held against the Pallas ``crossbar_conv2d`` (interpret
mode) and ``repro.kernels.ref.crossbar_conv2d_ref`` on the same numpy
inputs, at rtol/atol 1e-4 (``tests/test_kernels.py``'s bound for the Pallas
kernel: both sum the same f32 products in different orders).  The CUDA
kernel itself is held against the plain version on the card
(``tests/test_torch_kernels_cuda.py``, ``chip_smoke.py``); its launch plan,
``conv2d.conv_plan``, is Python and is held here: every output written
once, every channel summed once, the shared memory within its budget.
"""

from __future__ import annotations

import collections

import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.conv2d import crossbar_conv2d as jax_conv2d
from repro_torch.kernels import conv2d, ops
from repro_torch.launch import quickstart

# (C, H, W, FL, FH, FW, stride, pad)
CASES = {
    "kernels_pad1": (3, 8, 8, 8, 3, 3, 1, 1),
    "kernels_stride2": (4, 12, 12, 16, 3, 3, 2, 0),    # OH = 5: rows unused
    "kernels_1x1": (1, 6, 6, 4, 1, 1, 1, 0),
    "kernels_pad2_nonsquare": (2, 9, 7, 8, 3, 3, 1, 2),
    "main_path": (28, 16, 16, 28, 3, 3, 1, 1),         # K = 252
    "lenet28_conv1": (1, 28, 28, 4, 3, 3, 1, 0),
    "lenet28_conv2": (4, 13, 13, 8, 3, 3, 1, 0),
    "transformer_1x1": (8, 4, 1, 16, 1, 1, 1, 0),      # (d_model, T, 1)
}


def _inputs(case, wdtype, seed=0):
    c, h, w, fl, fh, fw, _, _ = case
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(c, h, w)).astype(np.float32)
    wf = rng.normal(size=(fl, c * fh * fw)).astype(np.float32)
    if wdtype == "int8":
        wq, sc = (np.array(a) for a in jref.quantize_crossbar(wf))
    else:
        wq = wf
        sc = rng.uniform(0.5, 1.5, size=fl).astype(np.float32)
    return x, wq, sc


@pytest.mark.parametrize("wdtype", ["int8", "f32"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_conv2d_matches_pallas_and_oracle(name, wdtype):
    case = CASES[name]
    *_, fh, fw, stride, pad = case
    x, wq, sc = _inputs(case, wdtype)
    kw = dict(stride=stride, pad=pad, fh=fh, fw=fw)
    pallas = np.asarray(jax_conv2d(x, wq, sc, **kw))
    oracle = np.asarray(jref.crossbar_conv2d_ref(x, wq, sc, stride, pad, fh,
                                                 fw))
    tx, twq, tsc = (torch.from_numpy(np.array(a)) for a in (x, wq, sc))
    got = {"wrapper": conv2d.crossbar_conv2d(tx, twq, tsc, **kw),
           "ops": ops.conv2d(tx, twq, tsc, **kw),
           "plain": ops.conv2d(tx, twq, tsc, use_kernel=False, **kw)}
    for label, y in got.items():
        assert y.dtype == torch.float32 and tuple(y.shape) == pallas.shape
        for want in (pallas, oracle):
            np.testing.assert_allclose(y.numpy(), want, rtol=1e-4, atol=1e-4,
                                       err_msg=label)


def test_strided_x_and_no_launch_counted_on_cpu():
    x, wq, sc = _inputs(CASES["main_path"], "int8", seed=1)
    tx = torch.from_numpy(np.ascontiguousarray(x.transpose(0, 2, 1))
                          ).transpose(1, 2)
    assert not tx.is_contiguous()
    twq, tsc = torch.from_numpy(wq), torch.from_numpy(sc)
    conv2d.reset_launches()
    y = conv2d.crossbar_conv2d(tx, twq, tsc, stride=1, pad=1)
    want = conv2d.crossbar_conv2d_plain(tx.contiguous(), twq, tsc, 1, 1, 3, 3)
    torch.testing.assert_close(y, want, rtol=0, atol=0)
    assert conv2d.LAUNCHES == {"crossbar_conv2d": 0}


def test_wrapper_rejects_what_the_kernel_does_not_take():
    x, wq, sc = (torch.from_numpy(a)
                 for a in _inputs(CASES["kernels_pad1"], "int8"))
    f = conv2d.crossbar_conv2d
    with pytest.raises(ValueError, match="columns"):
        f(x, wq[:, :-1].contiguous(), sc, pad=1)           # K != C*FH*FW
    with pytest.raises(ValueError, match="columns"):
        f(x, wq, sc, pad=1, fh=1, fw=1)
    with pytest.raises(TypeError, match="x must be float32"):
        f(x.double(), wq, sc, pad=1)
    with pytest.raises(TypeError, match="wq must be int8 or float32"):
        f(x, wq.to(torch.int16), sc, pad=1)
    with pytest.raises(ValueError, match="scale"):
        f(x, wq, sc[:-1], pad=1)
    with pytest.raises(ValueError, match="scale"):
        f(x, wq, sc.double(), pad=1)
    with pytest.raises(ValueError, match="wq must be contiguous"):
        f(x, wq.T.contiguous().T, sc, pad=1)
    with pytest.raises(ValueError, match="one device"):
        f(x, wq.to("meta"), sc, pad=1)
    with pytest.raises(ValueError, match="stride"):
        f(x, wq, sc, stride=0, pad=1)
    with pytest.raises(ValueError, match="pad"):
        f(x, wq, sc, pad=-1)
    with pytest.raises(ValueError, match="does not fit"):
        f(x[:, :2, :2], wq, sc)                            # 3x3 over 2x2
    with pytest.raises(ValueError, match="must be \\(C, H, W\\)"):
        f(x[0], wq, sc, pad=1)
    # one channel's input rows past the kernel's shared memory
    wide = torch.zeros(1, 3, 7000)
    wide_q = torch.zeros(4, 9, dtype=torch.int8)
    with pytest.raises(ValueError, match="shared memory"):
        f(wide, wide_q, torch.ones(4), stride=200)


def test_quickstart_runs_on_cpu(capsys):
    out = quickstart.main(["--device", "cpu"])
    assert out["n_convs"] == 4 and len(out["conv_errs"]) == 4
    assert out["sequential_cycles"] > out["pipelined_cycles"] > 0
    text = capsys.readouterr().out
    assert "all outputs match the reference executor — OK" in text
    assert "Listing 1 on cpu: 4 convs match" in text


# ------------------------------------------------------------ launch plan
def _check_plan(c, fl, fh, fw, stride, oh, ow):
    """Walk ``csrc/conv2d.cu``'s index math under ``conv_plan``'s choice and
    check that it covers the conv exactly once."""
    plan = conv2d.conv_plan(c, fl, fh, fw, stride, oh, ow)
    tj, ks, cc = plan.tj, plan.ks, plan.cc
    assert tj * ks == conv2d.THREADS and conv2d.TF * tj <= conv2d.THREADS
    assert 1 <= tj <= conv2d.MAX_TJ and 1 <= cc <= c
    ws = (tj - 1) * stride + fw                 # staged input columns
    assert plan.smem_bytes == 4 * (conv2d.THREADS * conv2d.TF
                                   + cc * fh * (ws + fw * conv2d.TF))
    assert plan.smem_bytes <= conv2d.SMEM_BYTES
    # every (f, j) of an output row written once (blockIdx.x is the row)
    assert plan.grid[0] == oh
    written = collections.Counter()
    for by in range(plan.grid[1]):
        for bz in range(plan.grid[2]):
            for t in range(conv2d.TF * tj):
                f, j = bz * conv2d.TF + t // tj, by * tj + t % tj
                if f < fl and j < ow:
                    written[f, j] += 1
    assert written == {(f, j): 1 for f in range(fl) for j in range(ow)}
    # every channel summed once by one K part: chunks of cc, channel cc0
    # of a chunk to part cc0 % ks (each of its fh * fw taps in the part)
    summed = collections.Counter()
    for part in range(ks):
        for c0 in range(0, c, cc):
            for cc0 in range(part, min(cc, c - c0), ks):
                summed[c0 + cc0] += 1
    assert summed == {ch: 1 for ch in range(c)}
    # the last staged column a thread reads lies inside the slab
    assert (tj - 1) * stride + fw - 1 < ws
    return plan


ZOO = dict(CASES, full_crossbar=(256, 32, 32, 256, 1, 1, 1, 0),
           k2304=(256, 8, 8, 256, 3, 3, 1, 1),
           stride2_nonsquare=(6, 11, 17, 10, 3, 3, 2, 1))


@pytest.mark.parametrize("name", sorted(ZOO))
def test_conv_plan_covers_the_zoos_convs_once(name):
    c, h, w, fl, fh, fw, stride, pad = ZOO[name]
    oh = (h + 2 * pad - fh) // stride + 1
    ow = (w + 2 * pad - fw) // stride + 1
    plan = _check_plan(c, fl, fh, fw, stride, oh, ow)
    if name == "main_path":
        # the grid covers the card: at least one block per SM
        assert plan.tj == 8 and plan.ks == 32
        assert np.prod(plan.grid) >= conv2d.SMS
    if name == "k2304":
        assert plan.cc < c                      # the weights take chunks


def test_conv_plan_covers_random_shapes():
    hyp = pytest.importorskip("hypothesis")
    st = hyp.strategies

    @hyp.settings(max_examples=200, deadline=None, database=None)
    @hyp.given(c=st.integers(1, 600), fl=st.integers(1, 70),
               fh=st.integers(1, 7), fw=st.integers(1, 7),
               stride=st.integers(1, 4), oh=st.integers(1, 40),
               ow=st.integers(1, 70))
    def check(c, fl, fh, fw, stride, oh, ow):
        _check_plan(c, fl, fh, fw, stride, oh, ow)
    check()


def test_conv_plan_refuses_what_does_not_fit():
    """One channel's input rows and weights past the shared memory raise
    where the plan is made, before any launch (so on the CPU too)."""
    with pytest.raises(ValueError, match="shared memory"):
        conv2d.conv_plan(1, 4, 3, 3, 200, 1, 35)
    plan = conv2d.conv_plan(1, 4, 3, 3, 100, 1, 35)
    assert plan.smem_bytes <= conv2d.SMEM_BYTES
