"""Pipelined prefill over the "pod" dimension: the paper's execution model
across ranks.

The CM accelerator runs inference as a *layer pipeline*: every core holds
its layers' weights permanently and a compiled LCU state machine advances
each core as its input dependencies are satisfied (paper §2/§3).  Here:

  * "core"       -> one rank of the mesh's "pod" dimension (a pipeline
    stage), with the ranks of its "model" dimension running the stage's
    sequence in parallel (``--variant seq_causal``: ``attn_shard="seq"``,
    ``causal_bound=True``, the blocked residual);
  * "layer"      -> a stage of n_layers / n_stages layers, weights resident
    (``models.lm.init_stage``: a rank holds its stage's layers only, and
    stage 0 the embedding);
  * "LCU automaton" -> ``core.pipeline.derive_schedule`` over
    ``pointwise`` edges (micro-batch t of stage s+1 depends on micro-batch
    t of stage s);
  * "SRAM write at cycle+1" -> one activation hop a tick
    (``core.pipeline.pipeline_apply``).

Port of ``repro.launch.pipeline_prefill``.  Where the reference compiles
the program and records XLA's cost analysis, this runs it and records what
the card measures: ms a prefill, tokens/s, the peak memory of each rank and
the bytes of one hop.

Run (one rank a card, ``nccl``)::

    torchrun --nproc-per-node 4 -m repro_torch.launch.pipeline_prefill \\
        --arch llama3.2-3b --micro 4 [--seq-len 512] [--batch 8] \\
        [--variant baseline|seq_causal] [--depth N] [--reduced] \\
        [--device cuda|cpu]

With more ranks than cards (or ``--device cpu``) the group is ``gloo``;
an activation on the card then hops through a host copy.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import pathlib
import time
from typing import Any, Dict

import torch

from ..configs.base import ArchConfig, get_arch, smoke_config
from ..core import pipeline
from ..distributed import comm
from ..models import layers as L
from ..models import lm

VARIANTS = ("baseline", "seq_causal")
ITERS = 10                        # timed prefills a run, after one warm-up


def variant_config(cfg: ArchConfig, variant: str) -> ArchConfig:
    """``seq_causal``: context parallelism inside each stage, striped
    (``attn_shard="seq"``, ``causal_bound=True``), as the reference's."""
    if variant == "seq_causal":
        return dataclasses.replace(cfg, attn_shard="seq", causal_bound=True)
    if variant != "baseline":
        raise ValueError(f"unknown variant {variant!r}; one of {VARIANTS}")
    return cfg


def make_pipelined_prefill(cfg: ArchConfig, mesh, n_micro: int,
                           seq_len: int, batch: int):
    """(fn, schedule).  ``fn(stage, tokens)`` runs on every rank of
    ``mesh`` (``("pod", "data", "model")``; stages over "pod", context
    parallelism over "model" where ``cfg.attn_shard == "seq"``), ``stage``
    this rank's :class:`models.lm.Stage` of ``mesh``'s pod size, and maps
    tokens (n_micro, b_m, S) to the last token's hidden state (n_micro,
    b_m, d) before the final norm, on every rank.  Under a blocked residual
    (``seq_residual``) a hop carries the rank's (b_m, S/mm, d) rows, not
    the whole sequence; ``fn.hop_rows`` is the rows a hop carries."""
    names = tuple(mesh.mesh_dim_names)
    n_stages = int(mesh.shape[names.index("pod")])
    if batch % n_micro:
        raise ValueError(f"batch {batch} does not split into {n_micro} "
                         f"micro-batches")
    b_m = batch // n_micro
    scfg = lm.stage_config(cfg, n_stages)
    sched = pipeline.derive_schedule(["pointwise"] * (n_stages - 1), n_micro)
    group = mesh.get_group("pod")
    # a stage's layers run within its pod: "pod" carries stages, not the
    # batch (no MoE aux mean over it)
    pod = mesh["data", "model"]
    with L.ambient_mesh(pod):
        cp = lm.residual_block(scfg, seq_len)
    # under a blocked residual a stage takes, keeps and hops its own rows;
    # the last token is on the last model rank
    blocked = cp is not None and cp.residual
    rows = cp.sl if blocked else seq_len            # rows a hop carries

    def stage_fn(stage, x):
        pos = torch.arange(seq_len, device=x.device)[None].expand(b_m,
                                                                  seq_len)
        if blocked:
            pos = cp.block(pos, dim=-1)
        return lm.run_stack(scfg, stage, x, pos, blocked=blocked)

    def fn(stage, tokens):
        if tuple(tokens.shape) != (n_micro, b_m, seq_len):
            raise ValueError(f"tokens {tuple(tokens.shape)}, want "
                             f"{(n_micro, b_m, seq_len)}")
        if stage.n_stages != n_stages or \
                stage.sid != mesh.get_local_rank("pod"):
            raise ValueError(f"rank at pod {mesh.get_local_rank('pod')} of "
                             f"{n_stages} holds stage {stage.sid} of "
                             f"{stage.n_stages}")
        dev = stage.device
        if stage.embed is not None:
            toks = cp.block(tokens, dim=-1) if blocked else tokens
            xs = stage.embed[toks.to(dev)]
        else:                         # only stage 0 reads the stream
            xs = torch.empty((n_micro, b_m, rows, cfg.d_model),
                             dtype=L._dtype(cfg.param_dtype), device=dev)
        with L.ambient_mesh(pod), torch.no_grad():
            h = pipeline.pipeline_apply(stage_fn, stage, xs, sched, group,
                                        collect=lambda y: y[:, -1])
            if blocked:
                h = comm.broadcast(h, cp.mm - 1, cp.group)
            return h

    fn.hop_rows = rows
    return fn, sched


def _init_group(device: str):
    """The default group from ``torchrun``'s environment: ``nccl`` where
    every local rank has a card of its own, else ``gloo``."""
    import torch.distributed as dist
    local = int(os.environ.get("LOCAL_RANK", "0"))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", "1"))
    if device == "cuda":
        lm.resolve_device("cuda")
        n_cards = torch.cuda.device_count()
        dev = torch.device("cuda", local % n_cards)
        torch.cuda.set_device(dev)
        backend = "nccl" if local_world <= n_cards else "gloo"
    else:
        dev, backend = torch.device("cpu"), "gloo"
    if not dist.is_initialized():
        if backend == "nccl":
            dist.init_process_group(backend, device_id=dev)
        else:
            dist.init_process_group(backend)
    return dev, backend


def main(argv=None) -> Dict[str, Any]:
    import torch.distributed as dist

    from .mesh import make_pod_mesh

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-3b")
    ap.add_argument("--micro", type=int, default=4)
    ap.add_argument("--seq-len", type=int, default=512)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--depth", type=int, default=0,
                    help="layers per stage (0 = the model's whole depth)")
    ap.add_argument("--variant", default="baseline", choices=VARIANTS)
    ap.add_argument("--reduced", action="store_true",
                    help="the arch's smoke config")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--out", default="build/pipeline_prefill")
    args = ap.parse_args(argv)

    dev, backend = _init_group(args.device)
    world = dist.get_world_size()
    mm = 2 if args.variant == "seq_causal" else 1     # model ranks a stage
    if world % mm:
        raise ValueError(f"{world} ranks do not split into stages of {mm}")
    n_stages = world // mm
    cfg = variant_config(smoke_config(args.arch) if args.reduced
                         else get_arch(args.arch), args.variant)
    if args.depth:
        cfg = dataclasses.replace(cfg, n_layers=args.depth * n_stages)
    # a gloo group's mesh is a CPU mesh: its collectives move a card's
    # tensors through the host (distributed.comm)
    mesh = make_pod_mesh(n_stages, 1, mm, device_type=(
        dev.type if backend == "nccl" else "cpu"))
    sid = mesh.get_local_rank("pod")
    stage = lm.init_stage(cfg, sid, n_stages, dev, seed=0)
    gen = torch.Generator().manual_seed(0)
    b_m = args.batch // args.micro
    tokens = torch.randint(0, cfg.vocab_size, (args.micro, b_m, args.seq_len),
                           generator=gen)
    fn, sched = make_pipelined_prefill(cfg, mesh, args.micro, args.seq_len,
                                       args.batch)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        dist.barrier()

    h = fn(stage, tokens)                 # warm-up: builds the kernels
    sync()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    times = []
    for _ in range(ITERS):
        sync()
        t0 = time.perf_counter()
        h = fn(stage, tokens)
        sync()
        times.append((time.perf_counter() - t0) * 1e3)
    peak, prof = None, None
    if dev.type == "cuda":
        from .train_step_times import profile_ms
        peak = torch.cuda.max_memory_allocated(dev)
        sync()
        # one more prefill, profiled: the rank's device busy share and parts
        p = profile_ms(lambda: fn(stage, tokens), cpu=False)
        prof = {k: p[k] for k in ("wall_ms", "busy_ms", "idle_share",
                                  "device_events", "parts_ms")}
        prof["top_kernels_ms"] = p["top_kernels_ms"][:6]
    per_rank = [None] * world
    dist.all_gather_object(per_rank, (peak, prof))
    ms = sorted(times)[len(times) // 2]
    item = torch.empty((), dtype=L._dtype(cfg.param_dtype)).element_size()
    rec = {
        "arch": args.arch, "mode": "pipelined_prefill",
        "variant": args.variant, "n_stages": n_stages,
        "n_micro": args.micro, "schedule_ticks": sched.n_ticks,
        "schedule_utilization": sched.utilization(),
        "model_ranks": mm, "layers_per_stage": cfg.n_layers // n_stages,
        "seq_len": args.seq_len, "batch": args.batch, "backend": backend,
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
        "ms_per_prefill": ms, "ms_all": times,
        "tokens_per_s": args.batch * args.seq_len / (ms / 1e3),
        "peak_bytes_per_rank": [r[0] for r in per_rank],
        "hop_bytes": b_m * fn.hop_rows * cfg.d_model * item,
        "profile_per_rank": [r[1] for r in per_rank],
        "out_shape": list(h.shape),
        "out_finite": bool(torch.isfinite(h).all()),
    }
    if dist.get_rank() == 0:
        print(json.dumps(rec))
        out = pathlib.Path(args.out)
        out.mkdir(parents=True, exist_ok=True)
        (out / f"{args.arch}_pipeline_{args.variant}_m{args.micro}.json"
         ).write_text(json.dumps(rec, indent=1))
    dist.barrier()
    dist.destroy_process_group()
    return rec


if __name__ == "__main__":
    main()
