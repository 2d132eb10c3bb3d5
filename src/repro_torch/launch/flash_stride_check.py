"""The flash kernels at ``q_stride`` 1 against another checkout's, bit for
bit: the forward and the backward.

    PYTHONPATH=src python3 -m repro_torch.launch.flash_stride_check \\
        --other <other checkout>/src

Both checkouts' ``flash_attention`` wrappers run in one process on the card
(the other's imported beside this one, ``launch._checkout``) on the same
inputs: llama3.2-3b's heads (Hq 24, Hkv 8, D 128) at S 1, 17, 128, 512
and 2048, B 1 and 8, causal and not, Sq < Sk and causal Sq > Sk, and D 32,
64 and 256 at S 128, in bf16 and f32.  Then the backward kernels
(``flash_attention_bwd``: the tensor-core pair for bf16 at D <= 128, else
the CUDA-core pair) at every such shape a backward takes (no causal Sq >
Sk), both checkouts' on this one's forward output and lse: dq, dk, dv.
Prints one JSON line: every shape and whether the two results are equal
bit for bit.  Exits 1 where one is not.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from ..kernels import flash_attn
from ._checkout import load_other

# (b, hq, hkv, sq, sk, d, causal)
SHAPES = ([(b, 24, 8, s, s, 128, c) for b in (1, 8)
           for s in (1, 17, 128, 512, 2048) for c in (True, False)]
          + [(2, 24, 8, 100, 300, 128, True), (2, 24, 8, 100, 33, 128, True),
             (2, 24, 8, 100, 300, 128, False)]
          + [(2, 8, 2, 128, 128, d, True) for d in (32, 64, 256)])


def compare(other, dev) -> list:
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = []
    for dt in (torch.bfloat16, torch.float32):
        for b, hq, hkv, sq, sk, d, causal in SHAPES:
            q = torch.randn(b, sq, hq, d, generator=gen, device=dev).to(dt)
            k, v = (torch.randn(b, sk, hkv, d, generator=gen,
                                device=dev).to(dt) for _ in range(2))
            args = tuple(t.transpose(1, 2) for t in (q, k, v))
            mine = flash_attn.flash_attention(*args, causal=causal)
            theirs = other.flash_attention(*args, causal=causal)
            rows.append({"shape": [b, hq, hkv, sq, sk, d, causal,
                                   str(dt).split(".")[-1]],
                         "equal": bool(torch.equal(mine, theirs))})
    return rows


def compare_bwd(other, dev) -> list:
    """This checkout's backward at ``q_stride`` 1 against ``other``'s
    (which may have no ``q_stride``), on the same inputs, lse and dO."""
    gen = torch.Generator(device=dev).manual_seed(1)
    rows = []
    for dt in (torch.bfloat16, torch.float32):
        for b, hq, hkv, sq, sk, d, causal in SHAPES:
            if causal and sq > sk:
                continue
            q, do = (torch.randn(b, sq, hq, d, generator=gen,
                                 device=dev).to(dt).transpose(1, 2)
                     for _ in range(2))
            k, v = (torch.randn(b, sk, hkv, d, generator=gen,
                                device=dev).to(dt).transpose(1, 2)
                    for _ in range(2))
            o, lse = flash_attn.flash_attention_fwd(q, k, v, causal)
            mine = flash_attn.flash_attention_bwd(q, k, v, o, lse, do, causal,
                                                  q_stride=1)
            theirs = other.flash_attention_bwd(q, k, v, o, lse, do, causal)
            rows.append({"shape": [b, hq, hkv, sq, sk, d, causal,
                                   str(dt).split(".")[-1]],
                         "equal": all(bool(torch.equal(x, y))
                                      for x, y in zip(mine, theirs))})
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", required=True,
                    help="the other checkout's src directory")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("flash_stride_check: needs the card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    (other,) = load_other(args.other, "kernels.flash_attn")
    rows, bwd = compare(other, dev), compare_bwd(other, dev)
    n_equal = sum(r["equal"] for r in rows)
    n_bwd = sum(r["equal"] for r in bwd)
    print(json.dumps({"device": torch.cuda.get_device_name(dev),
                      "compared": len(rows), "bit_equal": n_equal,
                      "bwd_compared": len(bwd), "bwd_bit_equal": n_bwd,
                      "rows": rows, "bwd_rows": bwd}))
    return 0 if n_equal == len(rows) and n_bwd == len(bwd) else 1


if __name__ == "__main__":
    sys.exit(main())
