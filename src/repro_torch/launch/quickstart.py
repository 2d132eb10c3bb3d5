"""Quickstart: the paper end to end in one page, on the port.

    python -m repro_torch.launch.quickstart [--device cuda|cpu]

Port of ``examples/quickstart.py``: compile a CNN with cmnnc (partition ->
mapping -> polyhedral lowering), simulate pipelined execution on the CM
accelerator, and check the result against the reference executor, with
int8 "analog" crossbars.  One step of its own: the paper's Listing 1 on one
core.  Every ``conv2d`` node of the graph runs through
:func:`repro_torch.kernels.ops.conv2d` with the node's int8 crossbar (the
hand-written conv kernel on the card, its plain version with
``--device cpu``), held against ``conv2d_mxv`` on the same input activation
at rtol 1e-4 and atol 1e-4 x max(1, max|y|).
"""

from __future__ import annotations

import argparse
import copy

import numpy as np
import torch

from ..core import (Simulator, build_resnet_block_chain, compile_model,
                    execute_reference, make_chip, serialize_config)
from ..core.compute_plane import quantize_matrix
from ..core.graph import conv2d_mxv
from ..kernels import ops


def quantized_mxv(m, v):
    """The crossbar model: int8 weights with per-row scales (paper §3.5)."""
    wq, sc = quantize_matrix(m)
    return (np.asarray(v, np.float32)[None] @ wq.astype(np.float32).T
            * sc[None, :])[0]


def listing1(graph, image, device) -> dict:
    """Every conv of ``graph`` through ``ops.conv2d`` on ``device``, held
    against Listing 1 per pixel (``conv2d_mxv``) on the input activation a
    reference-executor pass gives it.  Returns the worst error per conv."""
    every = copy.copy(graph)
    every.outputs = [n.outputs[0] for n in graph.nodes]
    env = execute_reference(every, {graph.inputs[0]: image},
                            mxv_fn=quantized_mxv)
    env[graph.inputs[0]] = np.asarray(image, np.float32)
    errs = {}
    for node in graph.nodes:
        if node.op != "conv2d":
            continue
        x = env[node.inputs[0]]
        w = graph.weights[node.inputs[1]]
        b = graph.weights[node.inputs[2]] if len(node.inputs) > 2 else None
        fl, _, fh, fw = w.shape
        stride, pad = node.attrs["stride"], node.attrs["pad"]
        wq, sc = ops.quantize_crossbar(torch.from_numpy(w.reshape(fl, -1)))
        y = ops.conv2d(torch.from_numpy(x).to(device), wq.to(device),
                       sc.to(device), stride=stride, pad=pad, fh=fh, fw=fw)
        got = y.cpu().numpy()
        if b is not None:
            got = got + b[:, None, None]
        want = conv2d_mxv(x, w, b, stride, pad, quantized_mxv)
        if got.shape != want.shape or not np.isfinite(got).all():
            raise AssertionError(f"{node.name}: conv gave {got.shape}, "
                                 f"Listing 1 {want.shape}")
        atol = 1e-4 * max(1.0, float(np.abs(want).max()))
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=atol,
                                   err_msg=node.name)
        errs[node.name] = float(np.abs(got - want).max())
    return errs


def main(argv=None, *, c: int = 4, img: int = 8) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    # 1. an NN dataflow graph (two residual blocks, paper Fig. 2 pattern)
    graph = build_resnet_block_chain(n_blocks=2, c=c, img=img)
    n_convs = sum(1 for n in graph.nodes if n.op == "conv2d")
    print(f"graph: {len(graph.nodes)} nodes, {n_convs} convolutions")

    # 2. a CM accelerator: 8 cores, banded interconnect (5-prism stand-in)
    chip = make_chip(8, "banded", width=256, sram_bytes=256 * 1024)

    # 3. compile: partition (§3.1) -> mapping (§3.1) -> lowering (§3.2)
    #    with Appendix-A polyhedral LCU state machines
    prog = compile_model(graph, chip)
    print(f"partitions -> cores: {prog.mapping}")
    core0 = prog.cores[min(prog.cores)]
    print("one generated LCU evaluator:")
    print("\n".join("   " + ln for ln in
                    next(iter(core0.lcu.values())).gen_src.splitlines()[:6]))

    # 4. the serialized configuration bundle that initializes the chip
    blob = serialize_config(prog)
    print(f"serialized config: {len(blob)} bytes")

    # 5. simulate pipelined inference on a stream of images
    rng = np.random.default_rng(0)
    shape = graph.values[graph.inputs[0]].shape
    images = [rng.normal(size=shape).astype(np.float32) for _ in range(4)]
    sim = Simulator(prog, chip, mxv_fn=quantized_mxv, check_raw=True)
    outs, stats = sim.run(images, schedule="pipelined")
    print(f"pipelined: {stats.cycles} cycles, "
          f"mean core utilization {stats.mean_utilization():.2f}")

    _, seq = sim.run(images, schedule="sequential")
    print(f"sequential: {seq.cycles} cycles "
          f"(pipeline speedup {seq.cycles / stats.cycles:.2f}x)")

    # 6. verify against the reference executor (same quantized crossbars)
    for img_, out in zip(images, outs):
        want = execute_reference(graph, {"x": img_}, mxv_fn=quantized_mxv)
        for k in want:
            np.testing.assert_allclose(out[k], want[k], rtol=1e-5, atol=1e-5)
    print("all outputs match the reference executor — OK")

    # 7. Listing 1 on one core: each conv through the conv kernel's op
    errs = listing1(graph, images[0], torch.device(args.device))
    print(f"Listing 1 on {args.device}: {len(errs)} convs match Listing 1 "
          f"per pixel, worst abs err {max(errs.values()):.3g} — OK")
    return {"n_convs": n_convs, "pipelined_cycles": stats.cycles,
            "sequential_cycles": seq.cycles, "conv_errs": errs,
            "config_bytes": len(blob)}


if __name__ == "__main__":
    main()
