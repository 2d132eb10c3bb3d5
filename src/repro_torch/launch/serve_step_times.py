"""Serving under a mesh across four cards: each rank prefills and decodes on
its shards and its part of the cache (``models.prefill``,
``models.decode_step`` on a model built under the mesh), timed, with the
dry run's bound for the same cell and mesh beside it and the one-card time
where the model fits one card.

    torchrun --nproc-per-node 4 -m repro_torch.launch.serve_step_times \
        [--runs NAME,...] [--new N] [--prompt S] [--reduced]
        [--device cuda|cpu] [--out FILE]

A run (:data:`RUNS`) is an architecture at full width and depth
(``--reduced``: its smoke config, on the CPU only, since the card's kernels
are not built for the smoke configs' head dims), a ``("data", "model")``
mesh of the world's ranks, a batch of B prompts of S tokens from seed 0
(``--prompt`` sets S for every run) and ``--new`` greedy tokens (the
whole logits gathered, ``models.gather_logits``, their argmax fed back).
``nccl`` where each rank has a card, else ``gloo``; eager (a step across
ranks is not captured).  Each run records on every rank: one prefill's ms
after a warm one, the decode's ms a token over the ``--new`` steps and the
global tokens/s, the peak allocated GiB, the kernels' launches over the
prefill and the steps; then, on the card, one decode step profiled for
device activity (wall, busy and idle share, the NCCL kernels' ms).
Beside them: ``launch.dryrun``'s trace of the same prefill and decode
cells on a fake world of the mesh's ranks (rank 0 starts it in a process
of its own at the start: ``dryrun.start_traces``),
its roofline at the H100's data-sheet rates and its bound (the largest of
its compute, memory and collective terms); a Mamba model's prefill is not
traced (the plain scan on fake tensors is one step a position: minutes at
full depth).  Then the one-card run of the same model, batch and tokens
on rank 0 (the other ranks wait), the same figures, its greedy tokens
against the mesh's, where its parameters and cache fit the card.

Prints one JSON object a run, then one for the whole (also written to
``--out``, after each run).
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

# name -> (arch, (data, model), batch, prompt tokens)
RUNS = {
    "llama_1x4": ("llama3.2-3b", (1, 4), 8, 512),
    "llama_2x2": ("llama3.2-3b", (2, 2), 8, 512),
    "llama_b1_32k_2x2": ("llama3.2-3b", (2, 2), 1, 32768),
    "qwen2moe_2x2": ("qwen2-moe-a2.7b", (2, 2), 8, 512),
    "falcon_1x4": ("falcon-mamba-7b", (1, 4), 8, 512),
    "phi3_1x4": ("phi3-medium-14b", (1, 4), 8, 512),
}
NEW = 32


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _config(arch: str, args):
    from ..configs.base import get_arch, smoke_config
    return smoke_config(arch) if args.reduced else get_arch(arch)


def _prompts(cfg, b: int, s: int, dev) -> dict:
    rng = np.random.default_rng(0)
    if cfg.embed_inputs:
        x = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
        return {"embeds": torch.from_numpy(x).to(dev)}
    return {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (b, s))).to(dev)}


def _serve(cfg, model, batch, max_len: int, new: int, dev, barrier):
    """One timed prefill (after a warm one) and ``new`` timed greedy
    steps: (record, first logits whole, greedy tokens)."""
    from .. import models
    from ..kernels import launch_counts
    for _ in range(2):                        # warm, then timed
        barrier()
        _sync(dev)
        t0 = time.perf_counter()
        logits, cache = models.prefill(cfg, model, batch, max_len)
        whole = models.gather_logits(cfg, model, logits, cache)
        _sync(dev)
        prefill_ms = (time.perf_counter() - t0) * 1e3
        first = whole
    before = launch_counts()
    toks = []
    barrier()
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(new):
        tok = whole.argmax(-1)
        toks.append(tok)
        logits, cache = models.decode_step(
            cfg, model, cache, models.step_input(cfg, model, tok))
        whole = models.gather_logits(cfg, model, logits, cache)
    _sync(dev)
    decode_s = time.perf_counter() - t0
    after = launch_counts()
    b = next(iter(batch.values())).shape[0]
    rec = {"prefill_ms": prefill_ms,
           "decode_ms_per_token": decode_s * 1e3 / new,
           "tokens_per_s": b * new / decode_s,
           "launches": {k: after[k] - before[k] for k in after
                        if after[k] != before[k]}}
    if dev.type == "cuda":
        from .train_step_times import profile_ms

        def step():
            models.decode_step(cfg, model, cache, models.step_input(
                cfg, model, whole.argmax(-1)))
        barrier()
        prof = profile_ms(step, cpu=False)
        rec["profiled_decode"] = {
            k: prof[k] for k in ("wall_ms", "busy_ms", "idle_share")}
        rec["profiled_decode"]["nccl_ms"] = prof["parts_ms"][
            "NCCL collectives"]
        rec["profiled_decode"]["top_kernels_ms"] = prof["top_kernels_ms"][:8]
        rec["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    return rec, first, torch.stack(toks)


def _trace_specs(args, runs) -> dict:
    specs = {}
    for name in runs:
        arch, mesh, b, s = RUNS[name]
        s = args.prompt or s
        cfg = _config(arch, args)
        base = {"arch": arch, "reduced": args.reduced, "batch": b,
                "overrides": {"n_layers": cfg.n_layers}, "mesh": list(mesh),
                "branches": "nccl"}
        if cfg.ssm is None:
            specs[name + "/prefill"] = dict(base, kind="prefill",
                                            seq_len=s)
        specs[name + "/decode"] = dict(base, kind="decode",
                                       seq_len=s + args.new)
    return specs


def _bound(tr: dict) -> dict:
    r = tr["roofline"]
    out = {k: r[k] for k in ("t_compute_s", "t_memory_s", "t_collective_s",
                             "dominant")}
    out["bound_ms"] = 1e3 * max(r["t_compute_s"], r["t_memory_s"],
                                r["t_collective_s"])
    out["coll_bytes"] = tr["coll_bytes"]
    out["argument_bytes"] = tr["memory"]["argument_size_in_bytes"]
    return out


def _fits(cfg, b: int, max_len: int, dev) -> tuple:
    """(whether the parameters and the cache fit the card with a fifth to
    spare, their bytes)."""
    from ..models import lm
    from ..sharding.rules import abstract_model
    need = sum(p.numel() * p.element_size()
               for p in abstract_model(cfg).parameters())
    cache = lm.init_cache(cfg, b, max_len, "meta")
    need += sum(t.numel() * t.element_size()
                for e in cache["layers"] for t in e.values())
    if dev.type != "cuda":
        return True, need
    return need * 1.2 < torch.cuda.get_device_properties(
        dev).total_memory, need


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--runs", default=",".join(RUNS),
                    help="comma-separated names of RUNS")
    ap.add_argument("--new", type=int, default=NEW,
                    help="greedy tokens a run decodes")
    ap.add_argument("--prompt", type=int, default=0,
                    help="prompt tokens of every run (0: the run's)")
    ap.add_argument("--reduced", action="store_true",
                    help="each arch's smoke config")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if args.reduced and args.device == "cuda":
        ap.error("--reduced runs on the CPU only (--device cpu): the card's "
                 "kernels are built for head dims 32, 64, 128 and 256, and "
                 "the smoke configs' are smaller")
    import torch.distributed as dist

    from .. import models
    from ..models import layers as L
    from .dryrun import finish_traces, start_traces
    from .mesh import make_host_mesh
    from .pipeline_prefill import _init_group
    from .train_step_times import card
    dev, backend = _init_group(args.device)
    world, rank = dist.get_world_size(), dist.get_rank()
    runs = args.runs.split(",")
    for name in runs:
        if name not in RUNS:
            raise ValueError(f"unknown run {name!r}: one of {sorted(RUNS)}")
        if int(np.prod(RUNS[name][1])) != world:
            raise ValueError(f"{name}: its mesh {RUNS[name][1]} is not the "
                             f"{world} ranks")
    traces = None
    if rank == 0:
        traces = start_traces(_trace_specs(args, runs))
    out = {"device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                      else "cpu"),
           "card": card() if dev.type == "cuda" else None,
           "backend": backend, "world": world, "new": args.new, "runs": {}}
    if rank == 0:
        print(json.dumps({k: out[k] for k in ("device", "card", "backend")}),
              flush=True)
    one_card = {}
    for name in runs:
        arch, (dd, mm), b, s = RUNS[name]
        s = args.prompt or s
        cfg = _config(arch, args)
        max_len = s + args.new
        mesh = make_host_mesh(dd, mm, device_type=(
            dev.type if backend == "nccl" else "cpu"))
        batch = _prompts(cfg, b, s, dev)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        with L.ambient_mesh(mesh):
            t0 = time.perf_counter()
            model = models.build_model(cfg, dev, seed=0)
            _sync(dev)
            build_s = time.perf_counter() - t0
            rec, first, toks = _serve(cfg, model, batch, max_len, args.new,
                                      dev, dist.barrier)
        rec["build_s"] = build_s
        del model
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        per_rank = [None] * world
        dist.all_gather_object(per_rank, rec)
        run = {"arch": arch, "layers": cfg.n_layers, "data": dd,
               "model": mm, "batch": b, "prompt": s, "per_rank": per_rank}
        if rank == 0:
            key = (arch, b, s)
            fits, need = _fits(cfg, b, max_len, dev)
            if key not in one_card and fits:
                if dev.type == "cuda":
                    torch.cuda.reset_peak_memory_stats(dev)
                model = models.build_model(cfg, dev, seed=0)
                one, ofirst, otoks = _serve(cfg, model, batch, max_len,
                                            args.new, dev, lambda: None)
                del model
                if dev.type == "cuda":
                    torch.cuda.empty_cache()
                one_card[key] = (one, ofirst, otoks)
            if key in one_card:
                one, ofirst, otoks = one_card[key]
                scale = max(1.0, float(ofirst.abs().max()))
                run["one_card"] = dict(one, prefill_logits_err=float(
                    (first.float() - ofirst.float()).abs().max()) / scale,
                    greedy_agree=float((toks == otoks).float().mean()))
            else:
                run["one_card"] = {
                    "skipped": f"parameters and cache need {need / 2**30:.1f}"
                               f" GiB"}
            print(json.dumps({"run": name, **run}), flush=True)
        out["runs"][name] = run
        if rank == 0 and args.out:          # what has run, kept as it goes
            with open(args.out, "w") as f:
                json.dump(out, f, indent=1)
        dist.barrier()
    if traces is not None:
        try:
            got = finish_traces(traces)
        except RuntimeError as e:
            got = {"error": str(e)}
        for name in runs:
            out["runs"][name]["dryrun"] = {
                part: _bound(got[f"{name}/{part}"]) if f"{name}/{part}" in got
                else None for part in ("prefill", "decode")}
            if "error" in got:
                out["runs"][name]["dryrun"]["error"] = got["error"][-1000:]
    dist.barrier()
    dist.destroy_process_group()
    if rank == 0:
        print(json.dumps(out))
        if args.out:
            with open(args.out, "w") as f:
                json.dump(out, f, indent=1)
    return out


if __name__ == "__main__":
    main()
