"""Serving launcher: ``python -m repro_torch.launch.serve --arch <id> [...]``.

Port of ``repro.launch.serve``: batched prefill + decode over the
``ServeEngine``, on the card unless ``--device cpu``; prints the reference's
line.  ``--reduced`` takes the arch's smoke config.  Every arch runs: a
model with embedding inputs (qwen2-vl, seamless-m4t) gets the reference's
standard-normal embeddings from ``ServeEngine.throughput_probe``.
"""

from __future__ import annotations

import argparse

from ..configs import archs
from ..configs.base import get_arch, smoke_config
from ..serve import ServeEngine


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=archs.ALL)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen-tokens", type=int, default=16)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    cfg = smoke_config(args.arch) if args.reduced else get_arch(args.arch)
    eng = ServeEngine(cfg, max_len=args.prompt_len + args.gen_tokens + 1,
                      device=args.device)
    stats = eng.throughput_probe(args.batch, args.prompt_len,
                                 args.gen_tokens)
    print(f"{cfg.name}: prefill {stats['prefill_s']*1e3:.1f} ms, "
          f"decode {stats['decode_tok_per_s']:.1f} tok/s "
          f"(batch={args.batch}, prompt={args.prompt_len})")


if __name__ == "__main__":
    main()
