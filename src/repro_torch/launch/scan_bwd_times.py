"""The selective scan's backward on one card: its kernels' times at
falcon-mamba-7b's training shape, and falcon-mamba-7b's training step.

    python -m repro_torch.launch.scan_bwd_times [--other SRC] [--steps N]

Kernels: at (B, L, Din, N) = (8, 512, 8192, 16), bf16 u and dt, B and C
column slices of one projection (``scan_inputs``), f32 dy: each backward
kernel's device µs (torch.profiler, ``scan_times.device_us``) and their
sum, the call's, and the call's µs by CUDA events, back to back
(``mxv_times.events_ms``).

Step (``--steps N``, N > 0): falcon-mamba-7b at full width and 32 of its 64
layers (what fits one card with f32 moments), ``Trainer`` on B = 8 x 512
synthetic tokens from seed 0: N steps a turn, each step's ms (CUDA events).

``--other SRC`` loads the ``repro_torch`` of another checkout (its ``src``)
into the same process: every measurement then runs in turns, other, this,
this, other, on the same inputs (the step with ``mamba_scan``'s backward
set to the other checkout's for its turns, the model and optimizer state
shared), so that both see one card.

Prints one JSON object a measurement, then one for the whole.
"""

from __future__ import annotations

import argparse
import json
import subprocess

import torch

from ._checkout import load_other
from .mxv_times import events_ms
from .scan_times import device_us, scan_inputs

SHAPE = (8, 512, 8192, 16)
ARCH, LAYERS = "falcon-mamba-7b", 32
BATCH, SEQ, LR = 8, 512, 3e-3


def kernel_us(call) -> dict:
    """{kernel name: device µs a call} for each backward kernel (the names
    of ``mamba_scan.BWD_KERNELS``, which the other checkout's kernels
    share), and ``"call"``, their sum."""
    from repro_torch.kernels.mamba_scan import BWD_KERNELS
    out = {k: device_us(call, reps=10, match=k) for k in BWD_KERNELS}
    out["call"] = sum(out.values())
    return out


def _kernels(mods, order, dev):
    gen = torch.Generator(device=dev).manual_seed(26)
    args = scan_inputs(gen, *SHAPE, dev, torch.bfloat16, True)
    dy = torch.randn(SHAPE[:3], generator=gen, device=dev)
    row = {"shape": [*SHAPE, "bfloat16"]}
    for pkg in order:
        call = (lambda m=mods[pkg]: m.selective_scan_bwd(*args, dy))
        row.setdefault(f"{pkg}.device_us", []).append(kernel_us(call))
        row.setdefault(f"{pkg}.events_us", []).append(
            events_ms(call, reps=10, trials=3, warmup=1) * 1e3)
    got = {pkg: mods[pkg].selective_scan_bwd(*args, dy) for pkg in mods}
    row["equal_to_this"] = {pkg: [bool(torch.equal(a, b)) for a, b in zip(
        g, got["this"])] for pkg, g in got.items()}
    print(json.dumps(row), flush=True)
    return row


def _steps(mods, order, dev, n):
    """``n`` training steps a turn, the backward set to each package's."""
    import dataclasses
    from repro_torch.configs.base import get_arch
    from repro_torch.kernels import mamba_scan
    from repro_torch.train import Trainer
    cfg = dataclasses.replace(get_arch(ARCH), n_layers=LAYERS)
    tr = Trainer(cfg=cfg, batch=BATCH, seq_len=SEQ, peak_lr=LR, device=dev)
    state = tr.init_state()
    own = mamba_scan.selective_scan_bwd
    bwd = {pkg: own if mods[pkg] is mamba_scan else mods[pkg].selective_scan_bwd
           for pkg in mods}
    out = {"arch": ARCH, "layers": LAYERS, "batch": BATCH, "seq_len": SEQ}
    try:
        for pkg in order:
            mamba_scan.selective_scan_bwd = bwd[pkg]
            before = mods[pkg].LAUNCHES["selective_scan_bwd"]
            tr.run(n, state=state)
            turn = {"step_ms": tr.step_ms[-n:], "loss": tr.history[-n:],
                    "bwd_launches": (mods[pkg].LAUNCHES["selective_scan_bwd"]
                                     - before)}
            out.setdefault(pkg, []).append(turn)
            print(json.dumps({"step": pkg, **turn}), flush=True)
    finally:
        mamba_scan.selective_scan_bwd = own
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", default=None,
                    help="the src directory of another checkout to compare")
    ap.add_argument("--steps", type=int, default=0,
                    help="training steps a turn (0: none)")
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
           "packages": {k: m.__file__ for k, m in mods.items()}}
    out["kernels"] = _kernels(mods, order, dev)
    if args.steps > 0:
        out["step"] = _steps(mods, order, dev, args.steps)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
