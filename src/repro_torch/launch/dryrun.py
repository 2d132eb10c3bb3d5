"""Multi-pod dry run: one rank's step on fake tensors over a fake process
group.

Port of ``repro.launch.dryrun``.  For every (architecture x input shape)
cell and both production meshes (16 x 16 single-pod, 2 x 16 x 16
multi-pod), the reference lowers and compiles the step for 512 fake XLA
devices.  PyTorch has no SPMD compiler: the port writes each rank's
program out with ``torch.distributed`` calls, so this traces **one
rank's** program (``launch.specs.make_cell``) on ``FakeTensor``s over a
``fake`` process group of 256 or 512 ranks (``torch.testing._internal.
distributed.fake_pg``: collectives that move nothing), set up here and
never at import.  Every rank runs the same collectives of the same bytes
on its own shards (across pods, in an order that follows which data rank
owns each layer's moments); rank 0 is traced (ZeRO-1 gives each data rank
the same number of whole periods, so no rank holds more).  The
collectives take ``nccl``'s branches, the program the card runs
(``distributed.comm``).

A record holds:

- ``flops``: what ``torch.utils.flop_counter.FlopCounterMode`` counts,
  the matrix products and attention's (plain attention on fake tensors:
  every score of the causal square); elementwise work (norms, softmax,
  the scan's recurrence, AdamW) is not counted, where XLA's
  ``cost_analysis`` counts it;
- ``bytes``: every operand and result of every traced operator that is not
  a view, an unfused upper bound (the reference's ``bytes accessed``);
- ``collectives``: ``{kind: {"bytes", "count"}}`` of the rank's
  collectives (``distributed.comm.CollectiveLog``), operand bytes;
- ``memory``: ``argument_size_in_bytes`` and ``output_size_in_bytes``, the
  bytes of the rank's fake inputs and outputs (each storage once);
  ``temp_size_in_bytes``, the peak of live tensor bytes through the step,
  the arguments included;
- ``roofline``: ``launch.roofline.roofline_terms`` at the H100's
  data-sheet rates; ``ok`` or ``error``.

Serving cells trace on the mesh: the rank's shards, its part of the cache
as ``cache_specs`` lays it out (``memory``'s argument bytes count it) and
the collectives of serving under a mesh (the score sums over "model" of a
head dim split there, the windows' merge over "data", the MoE's rows
gathered at decode).  An enc-dec or ``attn_shard="seq"`` serving cell on a
mesh is recorded as failed (ROADMAP item 10(k)) and traced on one rank
(file suffix ``_one``).  The plain selective scan is one step a position,
so a Mamba cell at full depth takes minutes on fake tensors: ``--scaled``
traces one and two layer periods and extrapolates.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3.2-3b \\
        --shape train_4k [--mesh single|multi|one|both] [--scaled] \\
        [--out experiments/dryrun]
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import json
import os
import time
import traceback
import weakref
from typing import Any, Dict, Iterable, List, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ..configs.base import SHAPES, get_arch, shapes_for
from ..configs import archs
from .roofline import (analytic_bytes, collective_summary, network_bytes,
                       roofline_terms)
from .specs import make_cell, model_flops

MESHES = {"single": (16, 16), "multi": (2, 16, 16), "one": None}


@contextlib.contextmanager
def fake_world(n: int, rank: int = 0):
    """A default ``fake`` process group of ``n`` ranks (this is ``rank``),
    destroyed on the way out."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=n)
    try:
        yield
    finally:
        dist.destroy_process_group()


@contextlib.contextmanager
def production_mesh(pod: str):
    """The mesh of ``pod`` ("single", "multi", "one": None) over a fake
    world of its size."""
    shape = MESHES[pod]
    if shape is None:
        yield None
        return
    from .mesh import make_production_mesh
    with fake_world(int(torch.tensor(shape).prod())):
        yield make_production_mesh(multi_pod=pod == "multi",
                                   device_type="cpu")


def _walk(x, seen: Dict[int, Any]) -> None:
    """Every tensor reachable from ``x`` (modules' parameters, mappings,
    sequences) into ``seen``, by storage."""
    if isinstance(x, torch.Tensor):
        st = x.untyped_storage()
        seen.setdefault(id(st), (st, x))
    elif isinstance(x, torch.nn.Module):
        for p in x.parameters():
            _walk(p, seen)
    elif isinstance(x, dict):
        for v in x.values():
            _walk(v, seen)
    elif isinstance(x, (list, tuple)):
        for v in x:
            _walk(v, seen)


def tensor_bytes(*trees) -> int:
    """The bytes of the distinct storages reachable from ``trees``."""
    seen: Dict[int, Any] = {}
    for t in trees:
        _walk(t, seen)
    return sum(st.nbytes() for st, _ in seen.values())


class _Traffic(TorchDispatchMode):
    """Live tensor bytes (each storage from its first sight to its
    release) and their peak; the bytes every non-view operator reads and
    writes."""

    def __init__(self, args):
        super().__init__()
        self.live = self.peak = self.accessed = 0
        self._refs: Dict[int, Any] = {}
        seen: Dict[int, Any] = {}
        _walk(args, seen)
        for st, _ in seen.values():
            self._track(st)

    def _gone(self, key, n, _ref) -> None:
        self._refs.pop(key, None)
        self.live -= n

    def _track(self, st) -> None:
        key = id(st)
        if key in self._refs:
            return
        n = st.nbytes()
        self._refs[key] = weakref.ref(st, functools.partial(self._gone, key,
                                                            n))
        self.live += n
        self.peak = max(self.peak, self.live)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.namespace not in ("c10d", "_c10d_functional") and \
                not func.is_view:
            ins: List[torch.Tensor] = []
            _flat(args, ins)
            _flat(kwargs, ins)
            outs: List[torch.Tensor] = []
            _flat(out, outs)
            self.accessed += sum(t.nbytes for t in ins + outs)
            for t in outs:
                self._track(t.untyped_storage())
        return out


def _flat(x, acc: List[torch.Tensor]) -> None:
    if isinstance(x, torch.Tensor):
        acc.append(x)
    elif isinstance(x, dict):
        for v in x.values():
            _flat(v, acc)
    elif isinstance(x, (list, tuple)):
        for v in x:
            _flat(v, acc)


def trace_cell(cell) -> dict:
    """Run ``cell`` (``specs.CellSpec``) once on its fake tensors and count
    its FLOPs, bytes, collectives and memory (the module docstring)."""
    from torch.utils.flop_counter import FlopCounterMode

    from ..distributed.comm import CollectiveLog
    from ..models import layers as L
    with cell.mode, L.ambient_mesh(cell.mesh):
        args_bytes = tensor_bytes(cell.args)
        flops = FlopCounterMode(display=False)
        log = CollectiveLog(cell.mesh)
        traffic = _Traffic(cell.args)
        with flops, log, traffic:
            out = cell.fn(*cell.args)
        out_bytes = tensor_bytes(out)
    return {"flops": float(flops.get_total_flops()),
            "bytes": float(traffic.accessed),
            "records": log.records,
            "collectives": collective_summary(log.records),
            "coll_bytes": float(sum(r.nbytes for r in log.records)),
            "network_bytes": network_bytes(log.records),
            "memory": {"argument_size_in_bytes": args_bytes,
                       "output_size_in_bytes": out_bytes,
                       "temp_size_in_bytes": traffic.peak}}


def step_trace(cfg, shape, mesh_shape, branches: str = "nccl",
               rank: int = 0) -> dict:
    """:func:`trace_cell` of one step of ``cfg`` at ``shape`` on a
    fake world of ``mesh_shape``'s ranks (``("data", "model")``, or with
    three sizes ``("pod", "data", "model")``), the collectives on
    ``branches``' branches ("nccl" or "gloo"): what a run of that step on
    real ranks of that backend issues, as rank ``rank`` of the world.  Run
    it where no other process group lives (:func:`start_traces`)."""
    from ..distributed import comm
    from .mesh import make_host_mesh, make_pod_mesh
    make = make_host_mesh if len(mesh_shape) == 2 else make_pod_mesh
    with fake_world(int(torch.tensor(mesh_shape).prod()), rank), \
            comm.fake_branches(branches):
        return trace_cell(make_cell(cfg, shape, make(
            *mesh_shape, device_type="cpu")))


def trace_spec(spec: dict) -> dict:
    """One rank's train step of ``spec`` traced, JSON in and out (for
    :func:`start_traces`): ``arch``, ``reduced`` (its smoke config),
    ``overrides``, ``seq_len``, ``batch``, ``mesh`` (sizes, as
    :func:`step_trace`'s; None or absent: one rank and no process group),
    ``branches`` and ``kind`` ("train" if absent; "prefill" or "decode":
    the serving call of that cell, a decode step against a ``seq_len``-deep
    cache).  Returns the collective records' keys, the counts of
    :func:`trace_cell`, the model FLOPs, the roofline at the H100's
    data-sheet rates and the seconds the trace took."""
    import dataclasses
    import math

    from ..configs.base import ShapeSpec, smoke_config
    t0 = time.perf_counter()
    cfg = smoke_config(spec["arch"]) if spec.get("reduced") else \
        get_arch(spec["arch"])
    cfg = dataclasses.replace(cfg, **spec.get("overrides", {}))
    shape = ShapeSpec("step", spec["seq_len"], spec["batch"],
                      spec.get("kind", "train"))
    mesh = spec.get("mesh")
    st = trace_cell(make_cell(cfg, shape, None)) if mesh is None else \
        step_trace(cfg, shape, tuple(mesh), spec.get("branches", "nccl"))
    return {"records": [list(r.key()) for r in st["records"]],
            "memory": st["memory"], "model_flops": model_flops(cfg, shape),
            "roofline": _roofline(st, cfg, shape, math.prod(mesh or (1,))),
            "s": time.perf_counter() - t0,
            **{k: st[k] for k in ("flops", "bytes", "coll_bytes",
                                  "network_bytes")}}


def start_traces(specs: Dict[str, dict]):
    """:func:`trace_spec` of each of ``specs`` (name -> spec) in one process
    on the host: no card, no process group of the caller (torchrun's
    variables dropped), one thread at the lowest priority, so that it takes
    only the host's idle time from work beside it; killed at exit if still
    running.  :func:`finish_traces` reads it."""
    import atexit
    import subprocess
    import sys
    from pathlib import Path
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                        "MASTER_PORT")}
    src = str(Path(__file__).resolve().parents[2])
    env.update(PYTHONPATH=os.pathsep.join(
        p for p in (src, env.get("PYTHONPATH")) if p),
        CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    code = ("import json, os, sys, torch\n"
            "os.nice(19)\n"
            "torch.set_num_threads(1)\n"
            "from repro_torch.launch.dryrun import trace_spec\n"
            "specs = json.loads(sys.argv[1])\n"
            "print(json.dumps({k: trace_spec(v) for k, v in specs.items()}))")
    proc = subprocess.Popen([sys.executable, "-c", code, json.dumps(specs)],
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    atexit.register(lambda: proc.poll() is None and proc.kill())
    return proc


def finish_traces(proc, timeout: float = 1800) -> Dict[str, dict]:
    """What :func:`start_traces`' process traced, name -> record; raises
    with its errors if it failed."""
    out, err = proc.communicate(timeout=timeout)
    if proc.returncode:
        raise RuntimeError(f"the traces failed: {err[-3000:]}")
    return json.loads(out.strip().splitlines()[-1])


def _chips(pod: str) -> int:
    shape = MESHES[pod]
    return 1 if shape is None else int(torch.tensor(shape).prod())


def _pod(multi_pod: Optional[bool]) -> str:
    return "one" if multi_pod is None else "multi" if multi_pod else "single"


def _mesh_text(pod: str) -> str:
    return {"single": "16x16", "multi": "2x16x16", "one": "1"}[pod]


def _roofline(stats: dict, cfg, shape, chips: int, scale: float = 1.0):
    return roofline_terms(
        flops_per_device=stats["flops"], bytes_per_device=stats["bytes"],
        coll_bytes_per_device=stats["coll_bytes"], chips=chips,
        model_flops=model_flops(cfg, shape) * scale,
        analytic_bytes_per_device=analytic_bytes(cfg, shape, chips) * scale,
        network_bytes_per_device=stats["network_bytes"])


def _write(rec: dict, out_dir: str, name: str) -> None:
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, name), "w") as f:
            json.dump(rec, f, indent=1)


def run_cell(arch: str, shape_name: str, multi_pod: Optional[bool],
             out_dir: str, overrides=None, tag: str = "") -> dict:
    """Trace one cell on the production mesh (``multi_pod`` None: one
    rank), print its numbers, write ``<arch>_<shape>_<single|multi|one>
    [_<tag>].json`` under ``out_dir`` (none where it is empty)."""
    pod = _pod(multi_pod)
    chips = _chips(pod)
    cfg = get_arch(arch)
    shape = SHAPES[shape_name]
    t0 = time.time()
    rec = {"arch": arch, "shape": shape_name, "kind": shape.kind,
           "mesh": list(MESHES[pod] or (1,)), "chips": chips,
           "multi_pod": bool(multi_pod), "tag": tag, "rank": 0,
           "ok": False}
    try:
        with production_mesh(pod) as mesh:
            cell = make_cell(arch, shape_name, mesh, overrides)
            stats = trace_cell(cell)
        rec["memory"] = stats["memory"]
        print(f"[{arch}/{shape_name}] memory:", rec["memory"])
        rec["cost"] = {"flops": stats["flops"],
                       "bytes_accessed": stats["bytes"]}
        print(f"[{arch}/{shape_name}] traced: flops={stats['flops']:.3e} "
              f"bytes={stats['bytes']:.3e}")
        rec["collectives"] = stats["collectives"]
        rec["network_bytes"] = stats["network_bytes"]
        rec["roofline"] = _roofline(stats, cfg, shape, chips)
        if shape.kind != "train":
            rec["cache_bytes"] = cache_bytes(cell)
        rec["ok"] = True
    except Exception:
        rec["error"] = traceback.format_exc()[-2000:]
    rec["trace_s"] = round(time.time() - t0, 1)
    suffix = f"_{tag}" if tag else ""
    _write(rec, out_dir, f"{arch}_{shape_name}_{pod}{suffix}.json")
    status = "OK" if rec["ok"] else "FAIL"
    print(f"[{status}] {arch} x {shape_name} x {_mesh_text(pod)} "
          f"({rec['trace_s']}s)", flush=True)
    return rec


def cache_bytes(cell) -> int:
    """The bytes of one rank's decode cache of a serving ``cell``
    (``specs.make_cell``): the whole cache's leaves cut as the cell's
    placements (``cache_specs``) lay them out."""
    from ..models import lm
    from ..sharding import rules
    whole = lm.init_cache(cell.cfg, cell.shape.global_batch,
                          cell.shape.seq_len, "meta")
    tree = {k: whole[k] for k in ("layers", "length")}
    if cell.placements is not None:
        sizes = rules.mesh_sizes(cell.mesh)
        tree = rules._tree_zip(lambda t, place: torch.empty(
            rules.local_shape(t.shape, place, sizes), dtype=t.dtype,
            device="meta"), tree, cell.placements["cache"])
    return sum(t.numel() * t.element_size()
               for e in tree["layers"] for t in e.values()) + \
        tree["length"].numel() * tree["length"].element_size()


def _depth_overrides(cfg, depth: int, extra=None) -> dict:
    ov = {"n_layers": depth}
    if cfg.encoder_layers:
        ov["encoder_layers"] = depth
    if extra:
        ov.update(extra)
    return ov


def _trace_stats(arch: str, shape_name: str, multi_pod: Optional[bool],
                 depth: int, extra_overrides=None) -> dict:
    """Trace at ``depth`` layers (a multiple of the layer period) and
    return the raw counts."""
    cfg = get_arch(arch)
    if depth % len(cfg.layer_period or "A"):
        raise ValueError(f"{arch}: depth {depth} is not a whole number of "
                         f"periods")
    with production_mesh(_pod(multi_pod)) as mesh:
        stats = trace_cell(make_cell(arch, shape_name, mesh, _depth_overrides(
            cfg, depth, extra_overrides)))
    stats["depth"] = depth
    return stats


def run_cell_scaled(arch: str, shape_name: str, multi_pod: Optional[bool],
                    out_dir: str, tag: str = "scaled",
                    extra_overrides=None) -> dict:
    """Differential depth: trace at one and two layer periods, then scale
    the per-period delta to the architecture's full depth.  Head, embedding
    and CE costs cancel in the delta and are added once; so do the
    arguments' bytes."""
    pod = _pod(multi_pod)
    chips = _chips(pod)
    cfg = get_arch(arch)
    shape = SHAPES[shape_name]
    plen = len(cfg.layer_period or "A")
    n_periods = cfg.n_layers // plen
    t0 = time.time()
    rec = {"arch": arch, "shape": shape_name, "kind": shape.kind,
           "chips": chips, "multi_pod": bool(multi_pod), "tag": tag,
           "rank": 0, "ok": False,
           "method": f"differential depth {plen}+{2 * plen} -> "
                     f"{cfg.n_layers} layers"}
    try:
        s1 = _trace_stats(arch, shape_name, multi_pod, plen, extra_overrides)
        s2 = _trace_stats(arch, shape_name, multi_pod, 2 * plen,
                          extra_overrides)

        def scale(a, b):
            return a + (b - a) * (n_periods - 1)

        stats = {k: scale(s1[k], s2[k])
                 for k in ("flops", "bytes", "coll_bytes", "network_bytes")}
        rec["cost"] = {"flops": stats["flops"],
                       "bytes_accessed": stats["bytes"],
                       "per_period_flops": s2["flops"] - s1["flops"],
                       "head_flops": 2 * s1["flops"] - s2["flops"]}
        rec["collectives"] = {
            k: {f: scale(s1["collectives"][k][f], s2["collectives"][k][f])
                for f in ("bytes", "count")} for k in s1["collectives"]}
        rec["collectives_1p"] = s1["collectives"]
        rec["collectives_2p"] = s2["collectives"]
        rec["memory_1p"], rec["memory_2p"] = s1["memory"], s2["memory"]
        rec["memory_scaled_args"] = int(scale(
            s1["memory"]["argument_size_in_bytes"],
            s2["memory"]["argument_size_in_bytes"]))
        rec["network_bytes"] = stats["network_bytes"]
        rec["roofline"] = _roofline(stats, cfg, shape, chips)
        rec["ok"] = True
    except Exception:
        rec["error"] = traceback.format_exc()[-2000:]
    rec["trace_s"] = round(time.time() - t0, 1)
    _write(rec, out_dir, f"{arch}_{shape_name}_{pod}_{tag}.json")
    status = "OK" if rec["ok"] else "FAIL"
    print(f"[{status}] scaled {arch} x {shape_name} x {_mesh_text(pod)} "
          f"({rec['trace_s']}s)", flush=True)
    return rec


def _cells(args) -> Iterable:
    if args.all or args.arch is None:
        for a in archs.ALL:
            for s in shapes_for(get_arch(a)):
                yield a, s
    else:
        shapes = [args.shape] if args.shape else shapes_for(
            get_arch(args.arch))
        for s in shapes:
            yield args.arch, s


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "one", "both"],
                    default="both")
    ap.add_argument("--out", default="experiments/dryrun")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--unroll", action="store_true",
                    help="accepted for the reference's command lines; the "
                         "port's trace runs every layer (tag='unroll')")
    ap.add_argument("--scaled", action="store_true",
                    help="differential-depth roofline mode (tag='scaled')")
    args = ap.parse_args()
    tag = "unroll" if args.unroll else ""
    meshes = {"single": [False], "multi": [True], "one": [None],
              "both": [False, True]}[args.mesh]
    n_fail = 0
    for arch, shape in _cells(args):
        todo = list(meshes)
        cfg = get_arch(arch)
        if SHAPES[shape].kind != "train" and None not in todo and (
                cfg.is_encdec or cfg.attn_shard == "seq"):
            todo.append(None)          # item 10(k): traced on one rank too
        for mp in todo:
            pod = _pod(mp)
            suffix = "_scaled" if args.scaled else (f"_{tag}" if tag else "")
            path = os.path.join(args.out, f"{arch}_{shape}_{pod}{suffix}.json")
            if args.skip_existing and os.path.exists(path):
                with open(path) as f:
                    if json.load(f).get("ok"):
                        print(f"[skip] {arch} x {shape} x {pod}{suffix}")
                        continue
            if args.scaled:
                rec = run_cell_scaled(arch, shape, mp, args.out)
            else:
                rec = run_cell(arch, shape, mp, args.out, tag=tag)
            n_fail += 0 if rec["ok"] else 1
    print(f"dry-run complete: {n_fail} failures")
    raise SystemExit(1 if n_fail else 0)


if __name__ == "__main__":
    main()
