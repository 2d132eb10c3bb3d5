"""Inject generated roofline tables into a Markdown file's placeholders.

Port of ``repro.launch.finalize_experiments`` (plain Python): the same
tables from ``repro_torch.launch.dryrun``'s records, the levers naming the
port's knobs and kernels.  Reads ``<dir>/*_scaled.json`` and replaces:

  TABLE-PLACEHOLDER-ROOFLINE  -> per-cell three-term roofline table
  TABLE-PLACEHOLDER-LEVERS    -> per-cell dominant bottleneck + lever

Run: PYTHONPATH=src python -m repro_torch.launch.finalize_experiments
     [EXPERIMENTS.md] [--dir experiments/dryrun]
Idempotent: placeholders are kept as HTML comments so re-runs refresh the
tables in place.
"""

from __future__ import annotations

import argparse
import re

from ..configs.base import get_arch
from .report import fmt_s, load

LEVERS = {
    ("collective", "train"):
        "attn_shard=seq (context parallelism: no TP all-reduce of every "
        "layer's output); then the f32 gradient sums as one bucket a group "
        "(ROADMAP 10(j))",
    ("collective", "prefill"):
        "attn_shard=seq + causal_bound: striped queries through the flash "
        "kernel's q_stride, K/V gathered once a layer",
    ("collective", "decode"):
        "serving under cache_specs: KV heads over model where they divide "
        "(no score all-reduce), the batch over data; a head dim split over "
        "model all-reduces each layer's scores",
    ("memory", "decode"):
        "kv_dtype=int8 halves cache reads; the int8 split-KV decode kernel "
        "(csrc/decode_attn.cu) reads the codes once",
    ("memory", "train"):
        "remat_policy='dots' + the flash kernels (analytic model); the "
        "traced ub is unfused",
    ("memory", "prefill"):
        "the flash prefill kernel (csrc/flash_attn.cu: no S^2 traffic)",
    ("compute", "train"):
        "already compute-bound: raise useful-flops ratio (remat policy, "
        "causal tiles skipped by the flash kernels)",
    ("compute", "prefill"):
        "causal_bound trims ~45% attention flops; rest is useful work",
    ("compute", "decode"):
        "compute-bound decode is the good case; batch growth amortizes "
        "weights",
}


def roofline_table(recs) -> str:
    rows = ["| arch | shape | t_compute | t_memory | t_mem(HLO ub) | "
            "t_collective | bound | MODEL/HLO flops | roofline frac |",
            "|---|---|---|---|---|---|---|---|---|"]
    for r in recs:
        rf = r["roofline"]
        rows.append(
            f"| {r['arch']} | {r['shape']} | {fmt_s(rf['t_compute_s'])} | "
            f"{fmt_s(rf['t_memory_s'])} | "
            f"{fmt_s(rf.get('t_memory_hlo_ub_s', rf['t_memory_s']))} | "
            f"{fmt_s(rf['t_collective_s'])} | {rf['dominant']} | "
            f"{rf['useful_flops_ratio']:.2f} | "
            f"{rf['roofline_fraction']:.1%} |")
    return "\n".join(rows)


def _family(arch: str) -> str:
    return get_arch(arch).family


def _lever(r) -> str:
    rf = r["roofline"]
    dom, kind, fam = rf["dominant"], _kind(r["shape"]), _family(r["arch"])
    if fam == "ssm" or (fam == "hybrid" and dom == "collective"):
        if dom == "collective":
            return ("mamba in/out projections: the rank's channels "
                    "(in_proj's halves) keep the scan local; the out_proj "
                    "sum over model is the collective")
        if dom == "memory":
            return ("SSM state read is near its floor; remaining lever is "
                    "f32->bf16 state (2x) at recurrence-precision cost")
    if fam == "moe" and dom == "collective":
        if kind == "prefill":
            return ("attn_shard=seq: the sequence-parallel MoE dispatches "
                    "each rank's own groups")
        if kind == "train":
            return ("expert parallelism over model (n_experts divides it); "
                    "the f32 gradient sums as one bucket (ROADMAP 10(j))")
    return LEVERS.get((dom, kind), "—")


def levers_table(recs) -> str:
    rows = ["| arch | shape | bound | what moves it down |",
            "|---|---|---|---|"]
    for r in recs:
        rf = r["roofline"]
        rows.append(f"| {r['arch']} | {r['shape']} | {rf['dominant']} | "
                    f"{_lever(r)} |")
    return "\n".join(rows)


def _kind(shape: str) -> str:
    return {"train_4k": "train", "prefill_32k": "prefill",
            "decode_32k": "decode", "long_500k": "decode"}[shape]


def inject(md: str, marker: str, table: str) -> str:
    begin = f"<!-- {marker} -->"
    end = f"<!-- /{marker} -->"
    block = f"{begin}\n{table}\n{end}"
    if begin in md:
        return re.sub(re.escape(begin) + r".*?" + re.escape(end), block,
                      md, flags=re.S)
    return md.replace(f"**{marker}**", block)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("markdown", nargs="?", default="EXPERIMENTS.md")
    ap.add_argument("--dir", default="experiments/dryrun")
    args = ap.parse_args()
    recs = [r for r in load(args.dir, "scaled")
            if r.get("ok") and not r["multi_pod"]]
    n_expected = 32
    with open(args.markdown) as f:
        md = f.read()
    md = inject(md, "TABLE-PLACEHOLDER-ROOFLINE", roofline_table(recs))
    md = inject(md, "TABLE-PLACEHOLDER-LEVERS", levers_table(recs))
    note = (f"\n*{len(recs)}/{n_expected} scaled cells present at "
            "generation time.*\n")
    if f"{len(recs)}/{n_expected} scaled cells" not in md:
        md = re.sub(r"\n\*\d+/\d+ scaled cells present at generation "
                    r"time\.\*\n", "\n", md)
        md = md.replace("<!-- /TABLE-PLACEHOLDER-ROOFLINE -->",
                        "<!-- /TABLE-PLACEHOLDER-ROOFLINE -->" + note)
    with open(args.markdown, "w") as f:
        f.write(md)
    print(f"injected {len(recs)} cells into {args.markdown}")


if __name__ == "__main__":
    main()
