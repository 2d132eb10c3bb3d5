"""The port's Listing-1 conv (``repro_torch.kernels.conv2d``) against the JAX
package's.

On CPU tensors ``crossbar_conv2d`` runs its plain version; both it and
``ops.conv2d`` are held against the Pallas ``crossbar_conv2d`` (interpret
mode) and ``repro.kernels.ref.crossbar_conv2d_ref`` on the same numpy
inputs, at rtol/atol 1e-4 (``tests/test_kernels.py``'s bound for the Pallas
kernel: both sum the same f32 products in different orders).  The CUDA
kernel itself is held against the plain version on the card
(``tests/test_torch_kernels_cuda.py``, ``chip_smoke.py``).
"""

from __future__ import annotations

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
