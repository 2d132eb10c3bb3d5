"""The crossbar MxV kernels' times on one card, at the CM paths' shapes.

    python -m repro_torch.launch.mxv_times [--other SRC]

Kernel: ``crossbar_mxv`` (f32 x) at the CM main path's (B, N, M) = (256,
252, 28) and at B = 1, 7 and 196 on the same crossbar; ``crossbar_mxv_int8``
at the DAC path's (121, 36, 8), (676, 9, 4) and (1, 200, 10).  For each:
the device time of one call under torch.profiler
(``scan_times.device_us``), the time per launch (CUDA events around 50
back-to-back wrapper calls, host cost included, median of 7), the
wrapper's host time per call (``decode_host_cost.host_us_per_call``) and,
for the float kernel, ``F.linear`` on the dequantized f32 crossbar (the
library yardstick, never called by the port): its device time, per launch
and host time.  The plan's grid and layout (``mxv_plan``) beside each.

The wrapper's host cost part by part (this checkout only): its operand
checks, ``contiguous``, the output's ``new_empty``, ``mxv_plan``, the
current device, the current stream's handle, the ctypes call that
launches the kernel, what the wrapper no longer does on every call
(entering ``torch.cuda.device``) and ``torch.empty`` with its keywords
beside ``new_empty``.

End to end: one ``TorchPlane.mxv_batch`` call (upload, launch, download)
at the main path's and the DAC path's most frequent shape, and the wall
time of the CM main serve (``build_resnet_block_chain(2, c=28, img=16)``
on ``make_chip(8, "banded")``, 8 Poisson requests, ``CmServer`` on
``TorchPlane``) and of the DAC serve (``build_lenet_like(img=28)``,
``TorchPlane(dac=True)``), as ``chip_smoke.py`` phases 3-4 serve them.

``--other SRC`` loads the ``repro_torch`` of another checkout (its
``src``) into the same process.  Every measurement then runs in turns,
other, this, this, other, on the same inputs, ``ROUNDS`` times for the
serves and plane calls, with ``TorchPlane``'s kernels
(``core.compute_plane.kmxv``) set to the other checkout's module for its
turns, so that both see one card.  Prints one JSON object a measurement,
then one for the whole.

``events_ms``, ``crossbar`` and ``plane_call_us`` are ``chip_smoke.py``'s
timers and inputs too.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time

import numpy as np
import torch

from ._checkout import load_other
from .decode_host_cost import host_us_per_call
from .scan_times import device_us

F32_SHAPES = ((256, 252, 28), (1, 252, 28), (7, 252, 28), (196, 252, 28))
INT8_SHAPES = ((121, 36, 8), (676, 9, 4), (1, 200, 10))
KERNELS = {"crossbar_mxv": "crossbar_mxv_kernel",
           "crossbar_mxv_int8": "crossbar_mxv_int8_kernel"}
ROUNDS = 5     # turns of each checkout for the plane calls and serves


def events_ms(fn, reps=50, trials=7, warmup=10):
    """Median over ``trials`` of (CUDA-event time of ``reps`` back-to-back
    calls) / ``reps``, in ms."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(trials):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b) / reps)
    return statistics.median(out)


def crossbar(m, n, gen, dev):
    """A random (M, N) crossbar from ``gen``, quantized: (wq, ws) on
    ``dev``."""
    from repro_torch.kernels.ref import quantize_crossbar
    wq, ws = quantize_crossbar(torch.randn(m, n, generator=gen))
    return wq.to(dev), ws.to(dev)


def plane_call_us(plane, desc, V, reps=200):
    """Median host time of one ``plane.mxv_batch`` call: upload, launch,
    download (the ``.cpu()`` at its end waits for the card)."""
    for _ in range(10):
        plane.mxv_batch(desc, V)
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        plane.mxv_batch(desc, V)
        out.append(time.perf_counter() - t0)
    return statistics.median(out) * 1e6


def _plan_row(plan):
    return {"grid": list(plan.grid), "threads": plan.threads,
            "cols_a_tile": plan.mt, "rows_a_block": plan.rows,
            "k_parts": plan.ks, "k_a_part": plan.kc,
            "smem_bytes": plan.smem_bytes}


def _kernel_rows(mods, order, dev):
    from repro_torch.kernels import mxv
    from repro_torch.kernels.ref import quantize_vec
    gen = torch.Generator().manual_seed(1)
    rows = []
    wq, ws = crossbar(28, 252, gen, dev)
    for kind, shapes in (("crossbar_mxv", F32_SHAPES),
                         ("crossbar_mxv_int8", INT8_SHAPES)):
        for b, n, m in shapes:
            if kind == "crossbar_mxv_int8" or (n, m) != (252, 28):
                wq, ws = crossbar(m, n, gen, dev)
            x = torch.randn(b, n, generator=gen).to(dev)
            xq, xs = quantize_vec(x)
            row = {"kernel": kind, "shape_bnm": [b, n, m],
                   "plan (computed by mxv_plan)": _plan_row(mxv.mxv_plan(
                       b, n, m, torch.int8 if "int8" in kind
                       else torch.float32))}
            for pkg in order:
                k = mods[pkg]
                call = ((lambda k=k: k.crossbar_mxv(x, wq, ws))
                        if kind == "crossbar_mxv" else
                        (lambda k=k: k.crossbar_mxv_int8(xq, xs, wq, ws)))
                before = dict(k.LAUNCHES)
                row.setdefault(f"{pkg}.device_us", []).append(
                    device_us(call, match=KERNELS[kind]))
                row.setdefault(f"{pkg}.per_launch_us", []).append(
                    events_ms(call) * 1e3)
                row.setdefault(f"{pkg}.host_us", []).append(
                    host_us_per_call(call, calls=500, runs=5))
                k.LAUNCHES.update(before)
            if kind == "crossbar_mxv":
                wdeq = wq.float() * ws[:, None]
                lib = lambda: torch.nn.functional.linear(x, wdeq)  # noqa: E731
                row["F.linear.device_us"] = device_us(lib, match="")
                row["F.linear.per_launch_us"] = events_ms(lib) * 1e3
                row["F.linear.host_us"] = host_us_per_call(lib, calls=500)
            rows.append(row)
            print(json.dumps(row), flush=True)
    return rows


def _host_parts(dev):
    """The float wrapper's host cost at (256, 252, 28), part by part."""
    from repro_torch.kernels import _build, mxv
    gen = torch.Generator().manual_seed(2)
    b, n, m = 256, 252, 28
    wq, ws = crossbar(m, n, gen, dev)
    x = torch.randn(b, n, generator=gen).to(dev)
    y = torch.empty(b, m, device=dev)
    lib = _build.load()
    plan = mxv.mxv_plan(b, n, m, torch.float32)
    stream = torch.cuda.current_stream(dev).cuda_stream
    ptrs = (x.data_ptr(), wq.data_ptr(), ws.data_ptr(), y.data_ptr())

    def checks():
        mxv._check_common("crossbar_mxv", x, wq, [("scale", ws, m)],
                          (torch.float32, torch.bfloat16))
        mxv._check_resident("crossbar_mxv", [("wq", wq), ("scale", ws)])

    def device_context():
        with torch.cuda.device(dev):
            pass
    before = dict(mxv.LAUNCHES)
    parts = {
        "whole wrapper": lambda: mxv.crossbar_mxv(x, wq, ws),
        "operand checks": checks,
        "x.contiguous()": x.contiguous,
        "x.new_empty (the output)": lambda: x.new_empty((b, m)),
        "mxv_plan (cached)": lambda: mxv.mxv_plan(b, n, m, x.dtype),
        "current device (torch.cuda.current_device())":
            torch.cuda.current_device,
        "current stream (current_stream(dev).cuda_stream)":
            lambda: torch.cuda.current_stream(dev).cuda_stream,
        "data_ptr x 4": lambda: (x.data_ptr(), wq.data_ptr(),
                                 ws.data_ptr(), y.data_ptr()),
        "ctypes call (launches the kernel)": lambda: lib.crossbar_mxv_f32(
            *ptrs, b, n, m, plan.args, stream),
        "not done any more: enter torch.cuda.device": device_context,
        "beside new_empty: torch.empty(..., dtype=, device=)":
            lambda: torch.empty((b, m), dtype=x.dtype, device=x.device),
    }
    out = {k: host_us_per_call(fn, calls=1000, runs=7)
           for k, fn in parts.items()}
    mxv.LAUNCHES.update(before)
    print(json.dumps({"host_parts_us at (256, 252, 28)": out}), flush=True)
    return out


def _serve_setup(graph):
    from repro_torch.core import compile_model, dequantize_int8, make_chip
    from repro_torch.runtime import poisson_arrivals
    chip = make_chip(8, "banded")
    prog = compile_model(graph, chip, quantizer=dequantize_int8)
    shp = graph.values[graph.inputs[0]].shape
    rng = np.random.default_rng(0)
    images = [rng.normal(size=shp).astype(np.float32) for _ in range(8)]
    return prog, chip, images, poisson_arrivals(8, rate=0.002, seed=7)


def _end_to_end(mods, order, dev):
    """Plane calls and serves in turns, ``TorchPlane``'s kernels set to
    each package's module for its turn."""
    from repro_torch.core import (TorchPlane, build_lenet_like,
                                  build_resnet_block_chain, compute_plane,
                                  make_descriptor)
    from repro_torch.runtime import CmServer
    paths = {"main": (build_resnet_block_chain(2, c=28, img=16), False,
                      (256, 252, 28)),
             "dac": (build_lenet_like(img=28), True, (121, 36, 8))}
    own = compute_plane.kmxv
    out = {}
    try:
        for name, (graph, dac, (b, n, m)) in paths.items():
            setup = _serve_setup(graph)
            desc = make_descriptor(
                np.random.default_rng(2).normal(size=(m, n)), "conv2d")
            V = np.random.default_rng(3).normal(size=(b, n)).astype(
                np.float32)
            plane = TorchPlane(dev, dac=dac)
            res = {"plane_call_us": {}, "serve_wall_ms": {},
                   "plane_call_shape_bnm": [b, n, m]}
            for _ in range(ROUNDS):
                for pkg in order:
                    compute_plane.kmxv = mods[pkg]
                    res["plane_call_us"].setdefault(pkg, []).append(
                        plane_call_us(plane, desc, V))
                    prog, chip, images, arrivals = setup
                    server = CmServer(prog, chip, max_inflight=4,
                                      compute_plane=TorchPlane(dev, dac=dac))
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    server.serve_images(images, arrivals)
                    torch.cuda.synchronize()
                    res["serve_wall_ms"].setdefault(pkg, []).append(
                        (time.perf_counter() - t0) * 1e3)
                compute_plane.kmxv = own
            out[name] = res
            print(json.dumps({name: res}), flush=True)
    finally:
        compute_plane.kmxv = own
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", default=None,
                    help="the src directory of another checkout to compare")
    args = ap.parse_args(argv)
    from repro_torch.kernels import mxv
    mods = {"this": mxv}
    order = ["this", "this"]
    if args.other:
        mods["other"], = load_other(args.other, "kernels.mxv")
        order = ["other", "this", "this", "other"]
    if not torch.cuda.is_available():
        raise SystemExit("mxv_times: no CUDA device; it times the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", torch.cuda.current_device())
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    out = {"device": torch.cuda.get_device_name(0),
           "card": smi.stdout.strip().splitlines()[0],
           "packages": {k: m.__file__ for k, m in mods.items()},
           "kernels": _kernel_rows(mods, order, dev),
           "host_parts_us": _host_parts(dev),
           "end_to_end": _end_to_end(mods, order, dev)}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
