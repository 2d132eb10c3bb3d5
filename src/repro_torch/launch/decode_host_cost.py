"""Host time per call of the flash decode wrappers, on one card.

    python -m repro_torch.launch.decode_host_cost [--calls 1000]
        [--runs 15] [--other SRC]

At llama3.2-3b's decode in ``chip_smoke.py`` (B 8, Hq 24, Hkv 8, D 128, a
2048-position bf16 cache, lengths 529 as a device tensor) it times
``flash_decode`` and ``flash_decode_int8``: ``time.perf_counter`` around
``--calls`` back-to-back calls, read before the card is waited for, over
the calls.  A call's device time (about 12 µs) is below its host time, so
the launch queue never fills and this is the wrapper's host cost: checks,
views, allocations and the ctypes call that launches the kernels.  Also
timed alone: ``decode_plan`` and the workspace's allocation.

``--other SRC`` loads the ``repro_torch`` of another checkout (its
``src``) into the same process and times its wrappers too, run for run in
turns with this one's, so that both see the same host: the comparison the
host's noise (tens of µs between processes) allows.  Prints one JSON
object: per package and wrapper, the minimum and the median over
``--runs`` runs, in µs per call.
"""

from __future__ import annotations

import argparse
import json
import statistics
import time

import torch

from ._checkout import load_other


def host_us_per_call(fn, calls: int = 1000, runs: int = 5) -> float:
    """Median over ``runs`` of the host time of ``calls`` back-to-back
    calls of ``fn``, per call, in µs."""
    return statistics.median(_runs(fn, calls, runs))


def _runs(fn, calls, runs):
    for _ in range(50):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(runs):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        out.append((time.perf_counter() - t0) / calls * 1e6)
        torch.cuda.synchronize()
    return out


def _other(src: str):
    """The decode wrappers of the ``repro_torch`` under ``src``
    (``_checkout.load_other``)."""
    return load_other(src, "kernels.decode_attn", "kernels.decode_attn_int8")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--calls", type=int, default=1000)
    ap.add_argument("--runs", type=int, default=15)
    ap.add_argument("--other", default=None,
                    help="the src directory of another checkout to compare")
    args = ap.parse_args(argv)
    from repro_torch.kernels import decode_attn, decode_attn_int8
    from repro_torch.models.layers import kv_quantize
    packages = {"this": (decode_attn, decode_attn_int8)}
    if args.other:
        packages["other"] = _other(args.other)
    dev = torch.device("cuda")
    b, hq, hkv, s, d = 8, 24, 8, 2048, 128
    gen = torch.Generator(device=dev).manual_seed(9)
    q = torch.randn(b, hq, d, generator=gen, device=dev).bfloat16()
    k, v = (torch.randn(b, s, hkv, d, generator=gen, device=dev)
            for _ in range(2))
    lengths = torch.full((b,), 529, dtype=torch.int32, device=dev)
    kt, vt = (t.bfloat16().transpose(1, 2) for t in (k, v))
    (k8, ks), (v8, vs) = kv_quantize(k), kv_quantize(v)
    int8 = (q, k8.transpose(1, 2), ks.transpose(1, 2), v8.transpose(1, 2),
            vs.transpose(1, 2), lengths)
    calls = {}
    for pkg, (dec, dec8) in packages.items():
        calls[pkg, "flash_decode"] = (
            lambda dec=dec: dec.flash_decode(q, kt, vt, lengths))
        calls[pkg, "flash_decode_int8"] = (
            lambda dec8=dec8: dec8.flash_decode_int8(*int8))
    plan = decode_attn.decode_plan(b, hq, hkv, s, d)
    calls["this", "decode_plan"] = (
        lambda: decode_attn.decode_plan(b, hq, hkv, s, d))
    calls["this", "workspace"] = (
        lambda: torch.empty(plan.workspace, dtype=torch.float32, device=dev))
    times = {key: [] for key in calls}
    for _ in range(args.runs):          # in turns: each run sees one host
        for key, fn in calls.items():
            times[key] += _runs(fn, args.calls, 1)
    out = {"device": torch.cuda.get_device_name(0), "calls": args.calls,
           "runs": args.runs,
           "packages": {pkg: mods[0].__file__
                        for pkg, mods in packages.items()}}
    for (pkg, name), ts in times.items():
        out[f"{pkg}.{name}_host_us"] = {"min": min(ts),
                                        "median": statistics.median(ts)}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
