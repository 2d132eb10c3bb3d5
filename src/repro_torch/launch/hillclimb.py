"""Perf-hillclimb harness: trace one (arch x shape) cell's rank at reduced
depth, attribute every collective to the port function that issued it, and
diff roofline terms across named variants.

Port of ``repro.launch.hillclimb``: the trace is ``launch.dryrun``'s (one
rank's program on fake tensors over a fake process group of 256 or 512
ranks), and the collectives are grouped by ``distributed.comm.
CollectiveLog``'s issuer where the reference groups by HLO ``op_name``.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.hillclimb --arch qwen2-vl-7b \\
      --shape prefill_32k --variant baseline --depth 1 [--set k=v ...]

Variants are named override-sets (``VARIANTS``, the reference's); each run
writes experiments/hillclimb/<arch>_<shape>_<variant>_d<depth>.json.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from collections import defaultdict
from typing import Iterable

from ..configs.base import SHAPES, get_arch
from .dryrun import _depth_overrides, production_mesh, trace_cell
from .roofline import analytic_bytes, roofline_terms
from .specs import make_cell, model_flops


def attribute_collectives(records: Iterable, top: int = 25):
    """Operand bytes grouped by (kind, issuer): rows (bytes, count, kind,
    issuer), largest first; a backward's collective is marked so."""
    groups = defaultdict(lambda: [0.0, 0])
    for r in records:
        name = r.issuer + (" (backward)" if r.backward else "")
        groups[(r.kind, name)][0] += r.nbytes
        groups[(r.kind, name)][1] += 1
    rows = sorted(((b, c, k, n) for (k, n), (b, c) in groups.items()),
                  reverse=True)
    return rows[:top]


VARIANTS = {
    # paper-faithful / current default
    "baseline": {},
    # hillclimb steps (hypotheses in EXPERIMENTS.md §Perf):
    "seq": {"attn_shard": "seq"},
    "seq_bf16": {"attn_shard": "seq", "scores_dtype": "bfloat16"},
    "bf16scores": {"scores_dtype": "bfloat16"},
    "seq_causal": {"attn_shard": "seq", "causal_bound": True},
    "seq_causal_bf16": {"attn_shard": "seq", "causal_bound": True,
                        "scores_dtype": "bfloat16"},
    "causal": {"causal_bound": True},
    "kv_int8": {"kv_dtype": "int8"},
    "seq_attn_only": {"attn_shard": "seq", "seq_residual": False},
    "seq_causal_attn_only": {"attn_shard": "seq", "seq_residual": False,
                             "causal_bound": True},
}


def run(arch: str, shape_name: str, variant: str, depth: int,
        multi_pod: bool, out_dir: str, extra: dict, attribute: bool = True):
    cfg = get_arch(arch)
    shape = SHAPES[shape_name]
    plen = len(cfg.layer_period or "A")
    depth = depth * plen
    ov = _depth_overrides(cfg, depth)
    ov.update(VARIANTS.get(variant, {}))
    ov.update(extra)
    t0 = time.time()
    with production_mesh("multi" if multi_pod else "single") as mesh:
        chips = int(mesh.size())
        stats = trace_cell(make_cell(arch, shape_name, mesh, overrides=ov))
    flops, nbytes, coll = stats["flops"], stats["bytes"], stats["coll_bytes"]
    rec = {
        "arch": arch, "shape": shape_name, "variant": variant,
        "depth": depth, "chips": chips, "overrides": {
            k: str(v) for k, v in ov.items()},
        "flops": flops, "bytes": nbytes, "coll_bytes": coll,
        "network_bytes": stats["network_bytes"],
        "collectives": stats["collectives"],
        "trace_s": round(time.time() - t0, 1),
    }
    # roofline at THIS depth (not scaled) — variants compare like-for-like
    rec["roofline_at_depth"] = roofline_terms(
        flops_per_device=flops, bytes_per_device=nbytes,
        coll_bytes_per_device=coll, chips=chips,
        model_flops=model_flops(cfg, shape) * depth / cfg.n_layers,
        analytic_bytes_per_device=analytic_bytes(cfg, shape, chips)
        * depth / cfg.n_layers,
        network_bytes_per_device=stats["network_bytes"])
    print(f"== {arch} x {shape_name} [{variant}] depth={depth} "
          f"chips={chips} trace={rec['trace_s']}s")
    print(f"   flops/dev={flops:.3e} bytes/dev={nbytes:.3e} "
          f"coll/dev={coll:.3e}")
    rf = rec["roofline_at_depth"]
    print(f"   t_comp={rf['t_compute_s']:.4f}s t_mem={rf['t_memory_s']:.4f}s "
          f"t_coll={rf['t_collective_s']:.4f}s dom={rf['dominant']}")
    if attribute:
        print("   top collectives by operand bytes:")
        for b, c, k, n in attribute_collectives(stats["records"]):
            print(f"     {b:12.3e}B x{c:<3d} {k:<20s} {n[:90]}")
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        path = os.path.join(out_dir,
                            f"{arch}_{shape_name}_{variant}_d{depth}.json")
        with open(path, "w") as f:
            json.dump(rec, f, indent=1)
    return rec


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--variant", default="baseline")
    ap.add_argument("--depth", type=int, default=1,
                    help="layer periods to trace (scaled roofline uses 1+2)")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--out", default="experiments/hillclimb")
    ap.add_argument("--set", nargs="*", default=[],
                    help="extra cfg overrides k=v (int/float/str/bool)")
    args = ap.parse_args()
    extra = {}
    for kv in args.set:
        k, v = kv.split("=", 1)
        for cast in (int, float):
            try:
                v = cast(v)
                break
            except ValueError:
                continue
        if v in ("true", "false"):
            v = v == "true"
        extra[k] = v
    run(args.arch, args.shape, args.variant, args.depth, args.multi_pod,
        args.out, extra)


if __name__ == "__main__":
    main()
