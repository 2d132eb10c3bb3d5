"""The selective scan's times at falcon-mamba-7b's prefill, on one card:
the kernel alone and end to end.

    python -m repro_torch.launch.scan_times [--other SRC]

Kernel: at falcon-mamba-7b's prefill shapes (Din 8192, N 16, bf16 u and
dt, B and C column slices of one projection), the generate's B = 8 x 512
and the batcher's B = 1 at L = 16, 128, 512 and 1024: the device time of
one call under torch.profiler (:func:`device_us`), the time per
(b, t, d, n) element, and the exponentials' estimate (16 a clock per SM on
132 SMs at 1.98 GHz).

End to end: falcon-mamba-7b at full width and depth (64 layers, bf16,
random weights from seed 0 on the card): ``ServeEngine.throughput_probe(8,
512, 32)`` (prefill ms, decode tok/s), then one ``ContinuousBatcher`` run
(8 slots, 16 requests of 16-1000 prompt tokens from seed 7, 32 new tokens
each), after one run to warm up: its wall time and that of its prefills,
each prefill timed between two synchronisations; the scan's launches in
each.

``--other SRC`` loads the ``repro_torch`` of another checkout (its
``src``) into the same process.  Every measurement then runs in turns,
other, this, this, other, on the same inputs and the same model, the
model's scan (``kernels.ops.selective_scan``) set to the other checkout's
wrapper for its turns, so that both see one card.  Prints one JSON object
a measurement, then one for the whole.
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

SHAPES = ((8, 512), (1, 16), (1, 128), (1, 512), (1, 1024))
ARCH, DIN, N = "falcon-mamba-7b", 8192, 16
EXP_PER_S = 16 * 132 * 1.98e9
PROBE = (8, 512, 32)                    # batch, prompt, new tokens
SLOTS, REQUESTS, NEW, MAX_LEN = 8, 16, 32, 2048


def scan_inputs(gen, b, l, d, n, dev, dtype=torch.bfloat16, strided=True):
    """u, dt, a, B, C, d_skip at falcon-mamba's scales: dt as softplus
    gives it (small, positive), B/C O(1); A = -exp(A_log) and d_skip drawn
    for each channel, so that a kernel reading another channel's A or D
    disagrees; with ``strided`` B and C are column slices of one (B, L,
    256 + 2N) projection, the model's layout."""
    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev)
    u = rnd(b, l, d).to(dtype)
    dt = torch.nn.functional.softplus(rnd(b, l, d) - 4.0).to(dtype)
    a = -torch.exp(rnd(d, n))
    if strided:
        proj = rnd(b, l, 256 + 2 * n).to(dtype)
        bm, cm = proj[..., 256:256 + n], proj[..., 256 + n:]
    else:
        bm, cm = rnd(b, l, n).to(dtype), rnd(b, l, n).to(dtype)
    return u, dt, a, bm, cm, rnd(d)


def device_us(fn, reps=20, match="scan"):
    """Device µs of one call: over ``reps`` profiled calls, each kernel
    whose name contains ``match``, its mean duration times its launches
    per call (rounded, so that a profile that dropped a few events still
    counts each launch once), summed; None where the profile shows none."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    spans = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and match in e.name:
            spans.setdefault(e.name, []).append(
                e.time_range.end - e.time_range.start)
    if not spans:
        return None
    return sum(max(1, round(len(d) / reps)) * statistics.fmean(d)
               for d in spans.values())


def _kernel_rows(mods, order, dev, plan_of):
    rows = []
    gen = torch.Generator(device=dev).manual_seed(10)
    for b, l in SHAPES:
        args = scan_inputs(gen, b, l, DIN, N, dev)
        elems = b * l * DIN * N
        plan = plan_of(b, l, DIN, N, torch.bfloat16)
        row = {"shape": [b, l, DIN, N, "bfloat16"],
               "exp_estimate_us": elems / EXP_PER_S * 1e6,
               "plan (computed by scan_plan)": {
                   "states": plan.states, "lanes": plan.lanes,
                   "grid": plan.grid, "working_warps": plan.working_warps}}
        for pkg in order:
            row.setdefault(f"{pkg}.device_us", []).append(device_us(
                lambda m=mods[pkg]: m.selective_scan(*args,
                                                     return_state=True)))
        for pkg in mods:
            got = [v for v in row[f"{pkg}.device_us"] if v is not None]
            row[f"{pkg}.ps_per_element"] = (
                None if not got else min(got) / elems * 1e6)
        rows.append(row)
        print(json.dumps(row), flush=True)
    return rows


def _batcher_run(cfg, model, prompts, scan_mod):
    """One batcher run: wall s, its prefills' s (each between two
    synchronisations), the prefills and the scan's launches."""
    from repro_torch.serve import ContinuousBatcher, Request
    cb = ContinuousBatcher(cfg, n_slots=SLOTS, max_len=MAX_LEN,
                           params=model)
    spans, prefill = [], cb._prefill

    def timed(tokens, true_len):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = prefill(tokens, true_len)
        torch.cuda.synchronize()
        spans.append(time.perf_counter() - t0)
        return out

    cb._prefill = timed
    reqs = [Request(rid=i, prompt=p, max_new=NEW)
            for i, p in enumerate(prompts)]
    for r in reqs:
        cb.submit(r)
    before = scan_mod.LAUNCHES["selective_scan"]
    t0 = time.perf_counter()
    cb.run_until_drained()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if not all(r.done and len(r.out) == NEW for r in reqs):
        raise AssertionError("scan_times: batcher requests unfinished")
    return {"wall_s": wall, "prefill_s": sum(spans),
            "prefills": cb.stats["prefills"],
            "scan_launches": scan_mod.LAUNCHES["selective_scan"] - before}


def _end_to_end(mods, order, dev):
    """throughput_probe and one batcher run in turns, the model's scan set
    to each package's wrapper for its turn."""
    from repro_torch.configs.base import get_arch
    from repro_torch.kernels import ops
    from repro_torch.models import build_model
    from repro_torch.serve import ServeEngine
    cfg = get_arch(ARCH)
    model = build_model(cfg, dev, seed=0)
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, cfg.vocab_size, (int(n),)).astype(np.int32)
               for n in rng.integers(16, 1001, REQUESTS)]
    own = ops.selective_scan
    out = {"probe": {}, "batcher": {}}
    try:
        for pkg in order:
            ops.selective_scan = mods[pkg].selective_scan
            eng = ServeEngine(cfg, max_len=PROBE[1] + PROBE[2] + 1,
                              params=model)
            before = mods[pkg].LAUNCHES["selective_scan"]
            p = eng.throughput_probe(*PROBE)
            p["scan_launches"] = (mods[pkg].LAUNCHES["selective_scan"]
                                  - before)
            out["probe"].setdefault(pkg, []).append(p)
            print(json.dumps({"probe": pkg, **p}), flush=True)
        ops.selective_scan = own
        _batcher_run(cfg, model, prompts, mods["this"])     # warm-up
        for pkg in order:
            ops.selective_scan = mods[pkg].selective_scan
            r = _batcher_run(cfg, model, prompts, mods[pkg])
            out["batcher"].setdefault(pkg, []).append(r)
            print(json.dumps({"batcher": pkg, **r}), flush=True)
    finally:
        ops.selective_scan = own
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", default=None,
                    help="the src directory of another checkout to compare")
    args = ap.parse_args(argv)
    from repro_torch.kernels import mamba_scan
    mods = {"this": mamba_scan}
    order = ["this", "this"]
    if args.other:
        mods["other"], = load_other(args.other, "kernels.mamba_scan")
        order = ["other", "this", "this", "other"]
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    out = {"device": torch.cuda.get_device_name(0),
           "card": smi.stdout.strip().splitlines()[0],
           "packages": {k: m.__file__ for k, m in mods.items()},
           "kernel": _kernel_rows(mods, order, dev, mamba_scan.scan_plan),
           "end_to_end": _end_to_end(mods, order, dev)}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
