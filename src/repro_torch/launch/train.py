"""Training launcher: ``python -m repro_torch.launch.train --arch <id>
[--reduced] [--device cuda|cpu] [--compile auto|on|off] [...]``.

Port of ``repro.launch.train``, with its flags: the fault-tolerant
``Trainer`` on the card unless ``--device cpu``, on the arch's config or,
with ``--reduced``, its smoke config.  Every ``--arch`` trains: dense,
MoE, Mamba, hybrid, VLM and enc-dec.  ``--compile`` is ``Trainer``'s
``compile``: ``auto`` (the default) replays the step as a CUDA graph on
the card and runs it eagerly on the CPU, ``on`` insists (refused on the
CPU), ``off`` keeps the eager step.
"""

from __future__ import annotations

import argparse
import time

from ..configs import archs
from ..configs.base import get_arch, smoke_config
from ..train import Trainer


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=archs.ALL)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--reduced", action="store_true",
                    help="use the smoke (reduced) config")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--compile", default="auto", choices=("auto", "on", "off"),
                    help="replay the step as a CUDA graph (auto: on the card)")
    args = ap.parse_args(argv)

    cfg = smoke_config(args.arch) if args.reduced else get_arch(args.arch)
    tr = Trainer(cfg=cfg, batch=args.batch, seq_len=args.seq_len,
                 ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                 peak_lr=args.lr, seed=args.seed, device=args.device,
                 compile={"auto": "auto", "on": True,
                          "off": False}[args.compile])
    state = tr.resume_or_init() if args.resume else tr.init_state()
    print(f"training {cfg.name} ({cfg.param_count()/1e6:.1f}M params) "
          f"from step {int(state.step)}")
    t0 = time.monotonic()
    state = tr.run(args.steps, state=state)
    dt = time.monotonic() - t0
    n = len(tr.history)
    print(f"steps={n} loss {tr.history[0]:.4f} -> {tr.history[-1]:.4f} "
          f"({dt/max(n,1)*1e3:.1f} ms/step)")
    if tr.slow_steps:
        print(f"watchdog flagged {len(tr.slow_steps)} slow steps")


if __name__ == "__main__":
    main()
