"""Aggregate dry-run JSONs into the roofline table.

Port of ``repro.launch.report`` (plain Python, unchanged but for this
docstring and the records' source: ``repro_torch.launch.dryrun``'s traces
at the H100's data-sheet rates).

Run: PYTHONPATH=src python -m repro_torch.launch.report [--dir experiments/dryrun]
     [--tag scaled]
"""

from __future__ import annotations

import argparse
import glob
import json
import os
from typing import Dict, List


ARCH_ORDER = [
    "qwen2-vl-7b", "qwen2-moe-a2.7b", "qwen3-moe-235b-a22b",
    "jamba-1.5-large-398b", "llama3.2-3b", "gemma-2b", "phi3-medium-14b",
    "qwen2-7b", "falcon-mamba-7b", "seamless-m4t-large-v2",
]
SHAPE_ORDER = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]


def load(dir_: str, tag: str = "") -> List[Dict]:
    recs = []
    for path in sorted(glob.glob(os.path.join(dir_, "*.json"))):
        with open(path) as f:
            r = json.load(f)
        if r.get("tag", "") == tag:
            recs.append(r)
    recs.sort(key=lambda r: (ARCH_ORDER.index(r["arch"])
                             if r["arch"] in ARCH_ORDER else 99,
                             SHAPE_ORDER.index(r["shape"])
                             if r["shape"] in SHAPE_ORDER else 99))
    return recs


def fmt_s(x: float) -> str:
    if x >= 1:
        return f"{x:.2f}s"
    if x >= 1e-3:
        return f"{x*1e3:.1f}ms"
    return f"{x*1e6:.0f}us"


def table(recs: List[Dict], multi_pod: bool = False) -> str:
    rows = []
    hdr = ("| arch | shape | t_compute | t_memory | t_mem(HLO ub) | "
           "t_collective | bound | MODEL/HLO flops | roofline frac |")
    sep = "|" + "---|" * 9
    rows.append(hdr)
    rows.append(sep)
    for r in recs:
        if r["multi_pod"] != multi_pod or not r.get("ok"):
            continue
        rf = r["roofline"]
        rows.append(
            f"| {r['arch']} | {r['shape']} | {fmt_s(rf['t_compute_s'])} | "
            f"{fmt_s(rf['t_memory_s'])} | "
            f"{fmt_s(rf.get('t_memory_hlo_ub_s', rf['t_memory_s']))} | "
            f"{fmt_s(rf['t_collective_s'])} | "
            f"{rf['dominant']} | {rf['useful_flops_ratio']:.2f} | "
            f"{rf['roofline_fraction']:.1%} |")
    return "\n".join(rows)


def failures(recs: List[Dict]) -> List[str]:
    return [f"{r['arch']} x {r['shape']} x "
            f"{'multi' if r['multi_pod'] else 'single'}"
            for r in recs if not r.get("ok")]


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="experiments/dryrun")
    ap.add_argument("--tag", default="")
    args = ap.parse_args()
    recs = load(args.dir, args.tag)
    ok = [r for r in recs if r.get("ok")]
    print(f"{len(ok)}/{len(recs)} cells OK (tag={args.tag!r})")
    bad = failures(recs)
    if bad:
        print("FAILURES:", *bad, sep="\n  ")
    print("\n== single-pod (16x16 = 256 chips) ==")
    print(table(recs, multi_pod=False))
    multi = [r for r in recs if r["multi_pod"]]
    if multi:
        print("\n== multi-pod (2x16x16 = 512 chips) ==")
        print(table(recs, multi_pod=True))


if __name__ == "__main__":
    main()
