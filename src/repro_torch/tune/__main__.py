"""CLI for the autotuner: run a zoo search, or verify its committed artifact.

    python -m repro_torch.tune --model lenet             # search + report
    python -m repro_torch.tune --model lenet --check     # bit-for-bit gate

``--check`` re-runs the search recorded in the committed artifact and
exits non-zero unless the regenerated bytes match exactly (the same
gate as the reference's ``python -m repro.tune --check``, on the same
committed files).  The port reads ``configs/tuned/`` and never writes it:
an artifact is recorded with ``python -m repro.tune --write``.

Port copy of the checking half of ``repro.tune.__main__``, with every
import inside ``repro_torch``.
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional

from .artifacts import TUNED_DIR, ZOO, artifact_json, tune_zoo_entry


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.tune",
        description="Design-space autotuner over the event simulator")
    ap.add_argument("--model", required=True, choices=sorted(ZOO),
                    help="zoo entry to search")
    ap.add_argument("--check", action="store_true",
                    help="re-run the recorded search and require the "
                         "committed artifact to reproduce byte-for-byte")
    args = ap.parse_args(argv)

    result = tune_zoo_entry(args.model)
    print(f"[tune] {args.model}: best={result.best.key()} "
          f"cycles={result.best_cycles} "
          f"(baseline {result.baseline.key()}={result.baseline_cycles}), "
          f"{result.counts['candidates']} candidates / "
          f"{result.n_simulated} simulated")

    if not args.check:
        return 0
    committed = TUNED_DIR / f"{args.model}.json"
    if not committed.exists():
        print(f"[tune] FAIL: no committed artifact at {committed}",
              file=sys.stderr)
        return 1
    if artifact_json(result) != committed.read_text():
        print(f"[tune] FAIL: regenerated artifact for {args.model!r} "
              f"differs from committed {committed} (search is seeded — a "
              f"diff means the code path changed)", file=sys.stderr)
        return 1
    print(f"[tune] OK: {committed} reproduced bit-for-bit")
    return 0


if __name__ == "__main__":
    sys.exit(main())
