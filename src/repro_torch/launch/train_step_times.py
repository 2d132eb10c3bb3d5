"""Where llama3.2-3b's training step spends its time on one card, and the
step's times eager against captured, this checkout against another.

    python -m repro_torch.launch.train_step_times [--split] [--steps N]
        [--other SRC] [--out FILE]

llama3.2-3b at full width and depth, ``Trainer`` on B = 8 x 512 synthetic
tokens from seed 0, lr 3e-3, f32 moments, remat.

``--split``: one eager step under torch.profiler (CPU and CUDA activity):
each aten operation's own device ms (the kernels it launched itself,
``self_device_time_total``) and its calls, the kernels' device ms by part
of the step (:data:`PARTS`, by kernel name), the device's busy ms (the
union of every kernel's and copy's interval) over the step's wall ms; then
one ``adamw_update`` alone, after a forward and backward outside the
profile, the same way: the optimizer's device ms by operation and in all.

``--steps N`` (N > 0): the step in turns on one model and optimizer state,
N steps a turn, each step's ms (CUDA events), tokens/s and peak allocated
GiB (``Trainer.step_ms`` and ``peak_bytes``): this checkout's eager step
(``compile=False``) and its captured step (``compile=True``: the first
steps eager, then replays of one capture; a turn's replays are marked),
and with ``--other SRC`` the other checkout's ``Trainer`` (its ``src``,
loaded into the same process: ``_checkout.load_other``) on the same model
and moments, captured where it has ``compile``, else eager.  Order: other,
eager, captured, captured, eager, other.  Then one replayed and one eager
step profiled for device activity only: wall ms, busy ms, idle share.

Prints one JSON object a measurement, then one for the whole (also
written to ``--out``).
"""

from __future__ import annotations

import argparse
import collections
import inspect
import json
import subprocess
import time

import torch

from ._checkout import load_other

ARCH, BATCH, SEQ, LR = "llama3.2-3b", 8, 512, 3e-3
# a kernel's part of the step: the first whose keys its name holds
PARTS = (("adamw kernels", ("adamw_",)),
         ("flash backward", ("attn_bwd_",)),
         ("flash forward", ("flash_attention",)),
         ("f32 GEMM", ("f32f32", "sgemm")),
         ("bf16 GEMM", ("nvjet", "gemm", "xmma", "cutlass")),
         ("elementwise, reductions, copies",
          ("elementwise", "reduce", "copy", "memset", "memcpy")))


def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return smi.stdout.strip().splitlines()[0]


def union(spans) -> float:
    """The length of the union of ``(start, end)`` intervals."""
    spans = sorted(spans)
    if not spans:
        return 0.0
    busy, (lo, hi) = 0.0, spans[0]
    for a, b in spans[1:]:
        if a > hi:
            busy += hi - lo
            lo, hi = a, b
        else:
            hi = max(hi, b)
    return busy + hi - lo


def _self_device_us(avg) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(avg, attr):
            return float(getattr(avg, attr))
    return 0.0


def profile_ms(fn, cpu: bool = True) -> dict:
    """``fn()`` once under torch.profiler: wall ms (synchronised), device
    busy ms (the union of the device intervals) and idle share, device ms
    by part (:data:`PARTS`), the kernels with the most device time, every
    kernel's name and, with ``cpu``, device ms by aten operation (its own
    kernels) with its calls.  ``chip_smoke.py`` phase 22 profiles its
    steps with it too."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if cpu else [])
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    spans, by_kernel = [], collections.defaultdict(float)
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            spans.append((e.time_range.start, e.time_range.end))
            by_kernel[e.name] += (e.time_range.end - e.time_range.start) / 1e3
    busy = union(spans) / 1e3
    parts = dict.fromkeys([p for p, _ in PARTS] + ["other"], 0.0)
    for name, ms in by_kernel.items():
        part = next((p for p, keys in PARTS
                     if any(k in name.lower() for k in keys)), "other")
        parts[part] += ms
    out = {"wall_ms": wall, "busy_ms": busy,
           "kernels_ms": sum(by_kernel.values()),
           "idle_share": 1 - busy / wall if wall else None,
           "device_events": len(spans), "parts_ms": parts,
           "top_kernels_ms": sorted(
               ([n[:120], ms] for n, ms in by_kernel.items()),
               key=lambda kv: -kv[1])[:15],
           "kernel_names": sorted(by_kernel)}
    if cpu:
        ops = [(a.key, _self_device_us(a) / 1e3, a.count)
               for a in prof.key_averages()
               if a.device_type == DeviceType.CPU and _self_device_us(a) > 0]
        out["ops_ms"] = sorted(([k, ms, n] for k, ms, n in ops),
                               key=lambda kv: -kv[1])[:40]
    return out


def _trainer(pkg, cfg, dev, compile):
    """A ``Trainer`` of ``pkg``'s ``train``; ``compile`` where it has
    one."""
    kw = dict(cfg=cfg, batch=BATCH, seq_len=SEQ, peak_lr=LR, device=dev)
    if "compile" in inspect.signature(pkg.Trainer).parameters:
        kw["compile"] = compile
    return pkg.Trainer(**kw)


def split(tr, state) -> dict:
    """One eager step profiled, then one ``adamw_update`` alone."""
    from repro_torch import models, optim
    from repro_torch.models.convert import decayed
    from repro_torch.train.loop import to_device
    out = {"step": profile_ms(lambda: tr.run(1, state=state))}
    model = state.model
    batch = to_device(tr.data.next(), tr.device)
    loss, _ = models.loss(model.cfg, model, batch)
    loss.backward()
    params = dict(model.named_parameters())
    grads = {n: p.grad if p.grad is not None else torch.zeros_like(p)
             for n, p in params.items()}
    dec = decayed(model)
    out["adamw"] = profile_ms(lambda: optim.adamw_update(
        grads, state.opt, params, 1e-4, decayed=dec))
    for p in params.values():
        p.grad = None
    del grads
    print(json.dumps({"split": out}), flush=True)
    return out


def turns(cfg, dev, steps, other) -> dict:
    """``steps`` steps a turn in the order other, eager, captured,
    captured, eager, other on one model and moments; ``other``: the other
    checkout's (train, optim) modules."""
    from repro_torch import optim, train
    own = _trainer(train, cfg, dev, False)
    state = own.init_state()
    model, mu, nu = state.model, state.opt.mu, state.opt.nu
    trainers = {"eager": (own, train, optim),
                "captured": (_trainer(train, cfg, dev, True), train, optim)}
    order = ["eager", "captured", "captured", "eager"]
    if other is not None:
        trainers["other"] = (_trainer(other[0], cfg, dev, True), *other)
        order = ["other"] + order + ["other"]
    count, step, out = 0, 0, {}

    def run(kind, n):
        nonlocal count, step
        tr, pkg, opt = trainers[kind]
        new = tr.run(n, state=pkg.TrainState(
            model, opt.OptState(mu, nu, count), step))
        count, step = new.opt.count, int(new.step)
        return tr

    for kind in order:
        n0 = len(trainers[kind][0].step_ms)
        torch.cuda.reset_peak_memory_stats(dev)
        tr = run(kind, steps)
        turn = {"step_ms": tr.step_ms[n0:], "loss": tr.history[n0:],
                "tokens_per_s": [BATCH * SEQ / ms * 1e3
                                 for ms in tr.step_ms[n0:]],
                "peak_gib": [b / 2**30 for b in tr.peak_bytes[n0:]],
                "replayed": getattr(tr, "replayed", [False] * len(
                    tr.step_ms))[n0:],
                "reserved_gib": torch.cuda.memory_reserved(dev) / 2**30}
        out.setdefault(kind, []).append(turn)
        print(json.dumps({"turn": kind, **turn}), flush=True)
    for kind in ("captured", "eager"):
        prof = profile_ms(lambda: run(kind, 1), cpu=False)
        out[f"{kind}_profiled"] = prof
        print(json.dumps({"profiled": kind, **prof}), flush=True)
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--split", action="store_true",
                    help="profile one eager step and one AdamW update")
    ap.add_argument("--steps", type=int, default=0,
                    help="steps a turn (0: no turns)")
    ap.add_argument("--other", default=None,
                    help="the src directory of another checkout to compare")
    ap.add_argument("--out", default=None,
                    help="also write the whole result to this JSON file")
    args = ap.parse_args(argv)
    from repro_torch import train
    from repro_torch.configs.base import get_arch
    cfg = get_arch(ARCH)
    other = None
    if args.other:
        other = load_other(args.other, "train", "optim")
    dev = torch.device("cuda")
    out = {"device": torch.cuda.get_device_name(0), "card": card(),
           "arch": ARCH, "layers": cfg.n_layers, "batch": BATCH,
           "seq_len": SEQ}
    print(json.dumps(out), flush=True)
    if args.split:
        tr = _trainer(train, cfg, dev, False)
        state = tr.init_state()
        state = tr.run(2, state=state)      # warm: the first steps build
        out["split"] = split(tr, state)
        del tr, state
        torch.cuda.empty_cache()
    if args.steps > 0:
        out["turns"] = turns(cfg, dev, args.steps, other)
    print(json.dumps(out))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return out


if __name__ == "__main__":
    main()
