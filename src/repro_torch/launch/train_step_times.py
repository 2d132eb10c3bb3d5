"""Where llama3.2-3b's training step spends its time on one card, and the
step's times eager against captured, this checkout against another; and
the step under context parallelism across ranks.

    python -m repro_torch.launch.train_step_times [--split] [--steps N]
        [--other SRC] [--out FILE]
    torchrun --nproc-per-node 4 -m repro_torch.launch.train_step_times \
        --meshes 1x4,2x2 [--variant seq_causal|baseline] [--arch A]
        [--steps N] [--seq-len S] [--depth L] [--reduced]
        [--device cuda|cpu] [--collectives] [--out FILE]

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

``--meshes DxM,...`` (under ``torchrun``, one rank a card on ``nccl``,
else ``gloo``; ``--device cpu`` runs on the CPU): ``--arch`` (llama3.2-3b
by default; its depth cut to ``--depth`` if given; ``--reduced``: its
smoke config) under ``--variant``, one of two of the reference's
hillclimb variants (:data:`VARIANTS`, each with its global batch and
default sequence: ``seq_causal`` by default, ``attn_shard="seq"`` with
``causal_bound`` and ``seq_residual``, B = 2 x S = 4,096 as the
reference's ``train_4k``; ``baseline`` the default layout, where the model
built under the mesh holds its rank's shards: tensor parallelism over
"model", ZeRO-1 moments over "data", FSDP where the config has it, B = 8
x S = 512), trained by ``Trainer`` under each ``("data", "model")`` mesh
of D x M ranks (``models.layers.ambient_mesh``; the batch split over
"data": ``train.loop``), S = ``--seq-len`` if given, synthetic tokens
from seed 0, eager (a step across ranks is not captured), ``--steps``
steps: every rank's step ms (CUDA events), the global tokens/s, peak
allocated GiB and flash launches a step, then on the card one more step
profiled for device activity: wall ms, busy ms, idle share.  Then the
one-card step of the same model at the same B x S on rank 0 (no mesh,
eager as the mesh steps are: ``compile=False``), the same figures, while
the other ranks wait; on a card whose memory its parameters, gradients
and moments exceed (:func:`one_card_bytes`) the record says so instead.
Each record lists ``replayed``: every step's is False.
``--collectives``: after the timed steps, one more step a mesh under
``distributed.comm.CollectiveLog``; rank 0 then traces the same step on a
fake world of the mesh's ranks on the backend's branches
(``launch.dryrun.start_traces``, in a process of its own) and records, for
every rank, whether its log equals the trace record for record, its
logged bytes, and its profiled NCCL ms beside the roofline's collective
term (NVLink's data-sheet rate).

Prints one JSON object a measurement, then one for the whole (also
written to ``--out``).
"""

from __future__ import annotations

import argparse
import collections
import inspect
import json
import os
import subprocess
import time

import torch

from ._checkout import load_other

ARCH, BATCH, SEQ, LR = "llama3.2-3b", 8, 512, 3e-3
# two of the reference's hillclimb variants (src/repro/launch/hillclimb.py):
# name -> (config fields, global batch, default sequence)
VARIANTS = {
    "baseline": ({}, 8, 512),
    "seq_causal": ({"attn_shard": "seq", "causal_bound": True,
                    "seq_residual": True}, 2, 4096),
}
# a kernel's part of the step: the first whose keys its name holds
PARTS = (("NCCL collectives", ("nccl",)),
         ("adamw kernels", ("adamw_",)),
         ("compress kernels", ("compress_",)),
         ("flash backward", ("attn_bwd_",)),
         ("flash forward", ("flash_attention",)),
         ("f32 GEMM", ("f32f32", "sgemm")),
         ("bf16 GEMM", ("nvjet", "gemm", "xmma", "cutlass")),
         # the accumulated step's acc + g / n (distributed/overlap.py)
         ("gradient accumulation", ("addcdiv",)),
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


def _steps_record(tr, batch, seq) -> dict:
    """A rank's figures of ``tr``'s steps: step ms, tokens/s of the global
    batch, peak GiB, losses, whether each step was a graph's replay."""
    ms = list(tr.step_ms)
    return {"step_ms": ms, "loss": list(tr.history),
            "tokens_per_s": [batch * seq / m * 1e3 for m in ms],
            "peak_gib": [b / 2**30 for b in tr.peak_bytes],
            "replayed": list(tr.replayed)}


def _train_turn(cfg, dev, args, mesh=None) -> dict:
    """``args.steps`` eager steps of a new ``Trainer`` of ``cfg`` (under
    ``mesh`` if given), the flash launches of each step (the last
    ``args.steps - 1``: the first builds), then on the card one more step
    profiled for device activity (``profile_ms``), outside the figures."""
    import contextlib
    from ..kernels import flash_attn
    from ..models import layers as L
    from ..train import Trainer
    tr = Trainer(cfg, batch=args.batch, seq_len=args.seq_len, peak_lr=LR,
                 device=dev, compile=False)
    with (L.ambient_mesh(mesh) if mesh is not None
          else contextlib.nullcontext()):
        state = tr.run(1)
        flash_attn.reset_launches()
        state = tr.run(args.steps - 1, state=state)
        rec = _steps_record(tr, args.batch, args.seq_len)
        rec["flash_launches_per_step"] = {
            k: v / max(1, args.steps - 1)
            for k, v in flash_attn.LAUNCHES.items()}
        if args.collectives and mesh is not None:
            from ..distributed.comm import CollectiveLog
            with CollectiveLog(mesh) as log:
                state = tr.run(1, state=state)
            rec["collectives"] = [list(r.key()) for r in log.records]
        if dev.type == "cuda":
            prof = profile_ms(lambda: tr.run(1, state=state), cpu=False)
            rec["profiled"] = {k: prof[k] for k in (
                "wall_ms", "busy_ms", "idle_share", "device_events",
                "parts_ms")}
            rec["profiled"]["top_kernels_ms"] = prof["top_kernels_ms"][:8]
            rec["profiled"]["replayed"] = tr.replayed[-1]
    del tr, state
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return rec


def one_card_bytes(cfg) -> int:
    """The bytes of ``cfg``'s parameters, their gradients and AdamW's two
    moments on one card (activations not counted)."""
    from ..models.layers import _dtype
    from ..sharding.rules import abstract_model
    moment = _dtype(cfg.adam_dtype).itemsize
    return sum(p.numel() * (2 * p.element_size() + 2 * moment)
               for p in abstract_model(cfg).parameters())


def _traced_beside(spec: dict, per_rank: list) -> dict:
    """The dry run's trace of the step ``--meshes`` runs
    (``launch.dryrun.start_traces``: a fake world in a process of its own),
    held against every rank's logged collectives; each rank's NCCL ms (its
    profiled step) beside the roofline's collective term."""
    from .dryrun import finish_traces, start_traces
    try:
        tr = finish_traces(start_traces({"step": spec}))["step"]
    except RuntimeError as e:
        return {"error": str(e)[-2000:]}
    out = {k: tr[k] for k in ("coll_bytes", "flops", "memory", "roofline")}
    out["records"] = len(tr["records"])
    out["per_rank"] = [{
        "log_equal": r.get("collectives") == tr["records"],
        "logged_bytes": sum(k[3] for k in r.get("collectives", [])),
        "nccl_ms": (r.get("profiled") or {}).get("parts_ms", {}).get(
            "NCCL collectives"),
        "t_collective_ms": tr["roofline"]["t_collective_s"] * 1e3}
        for r in per_rank]
    return out


def mesh_turns(args) -> dict:
    """``--meshes``: the step across the ranks of each mesh, every rank's
    figures gathered to every rank; then the one-card step on rank 0."""
    import dataclasses
    import torch.distributed as dist
    from ..configs.base import get_arch, smoke_config
    from .mesh import make_host_mesh
    from .pipeline_prefill import _init_group
    dev, backend = _init_group(args.device)
    world, rank = dist.get_world_size(), dist.get_rank()
    cfg = smoke_config(args.arch) if args.reduced else get_arch(args.arch)
    fields, args.batch, seq = VARIANTS[args.variant]
    over = dict(fields, **({"n_layers": args.depth} if args.depth else {}))
    args.seq_len = args.seq_len or seq
    cfg = dataclasses.replace(cfg, **over)
    out = {"device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                      else "cpu"),
           "card": card() if dev.type == "cuda" else None,
           "arch": args.arch, "layers": cfg.n_layers, "batch": args.batch,
           "seq_len": args.seq_len, "backend": backend, "world": world,
           "variant": args.variant, "meshes": {}}
    for spec in args.meshes.split(","):
        dd, mm = (int(v) for v in spec.split("x"))
        if dd * mm != world:
            raise ValueError(f"mesh {spec} is not the {world} ranks")
        # a gloo group's mesh is a CPU mesh: its collectives move a card's
        # tensors through the host (distributed.comm)
        mesh = make_host_mesh(dd, mm, device_type=(
            dev.type if backend == "nccl" else "cpu"))
        rec = _train_turn(cfg, dev, args, mesh)
        per_rank = [None] * world
        dist.all_gather_object(per_rank, rec)
        out["meshes"][spec] = {"data": dd, "model": mm,
                               "per_rank": per_rank}
        if rank == 0:
            print(json.dumps({"mesh": spec, "per_rank": per_rank}),
                  flush=True)
        if args.collectives and rank == 0:
            out["meshes"][spec]["dryrun"] = beside = _traced_beside(
                {"arch": args.arch, "reduced": args.reduced,
                 "overrides": over, "batch": args.batch,
                 "seq_len": args.seq_len, "mesh": [dd, mm],
                 "branches": backend}, per_rank)
            print(json.dumps({"mesh": spec, "dryrun": beside}), flush=True)
        dist.barrier()
    if rank == 0:
        need = one_card_bytes(cfg)
        have = (torch.cuda.get_device_properties(dev).total_memory
                if dev.type == "cuda" else None)
        out["one_card"] = (_train_turn(cfg, dev, args)
                           if have is None or need < have else
                           {"skipped": f"parameters, gradients and moments "
                                       f"need {need / 2**30:.1f} GiB, the "
                                       f"card has {have / 2**30:.1f} GiB"})
        print(json.dumps({"one_card": out["one_card"]}), flush=True)
    dist.barrier()
    dist.destroy_process_group()
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
    ap.add_argument("--meshes", default=None,
                    help="under torchrun: DxM (data x model) meshes, "
                         "comma-separated, each the whole world")
    ap.add_argument("--seq-len", type=int, default=0,
                    help="with --meshes: the sequence (0: the variant's)")
    ap.add_argument("--arch", default=ARCH,
                    help="with --meshes: the architecture")
    ap.add_argument("--variant", default="seq_causal",
                    choices=sorted(VARIANTS),
                    help="with --meshes: the reference's hillclimb variant "
                         "(baseline: the default layout, sharded)")
    ap.add_argument("--depth", type=int, default=0,
                    help="layers (0: the model's whole depth)")
    ap.add_argument("--reduced", action="store_true",
                    help="the arch's smoke config")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--collectives", action="store_true",
                    help="with --meshes: one more step a mesh under the "
                         "collective log, held against the dry run's trace "
                         "of the same step (launch.dryrun.step_trace)")
    args = ap.parse_args(argv)
    if args.meshes:
        if args.steps < 2:
            raise ValueError("--meshes needs --steps >= 2")
        out = mesh_turns(args)
        if int(os.environ.get("RANK", "0")) == 0:
            print(json.dumps(out))
            if args.out:
                with open(args.out, "w") as f:
                    json.dump(out, f, indent=1)
        return out
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
