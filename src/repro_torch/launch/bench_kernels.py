"""The port's kernels at ``benchmarks/bench_kernels.py``'s three rows, on
one card: crossbar MxV 16 x 512 x 512, flash attention 4 heads x 512 x 64
(2 KV heads, causal), the selective scan 2 x 256 x 64 (N 16), all f32 as
the reference's rows.  Also SDPA's backward at the tensor-parallel flash
backward's shapes (B 4, S 512, D 128, bf16, causal; query/KV heads 12/4,
6/2, 8/8, 4/4: llama's and qwen2-moe's heads on a model rank).

    python -m repro_torch.launch.bench_kernels [--out FILE]

For each row: the kernel's µs per launch (CUDA events, back to back) and
device µs (``torch.profiler``: each kernel's mean duration times its
launches a call, ``scan_times.device_us``), the plain PyTorch version's
µs, the largest absolute difference from it and its limit (the bounds
``chip_smoke.py`` holds these kernels to), the operations and bytes, and
``launch.roofline.kernel_bound`` (the H100's data-sheet rates).  SDPA's
backward is timed as ATen's flash-attention backward op, called directly,
and through autograd.  Prints one JSON object a row, then the card's name
and power limit.  It needs a card: without one it exits non-zero, and it
never runs on the CPU.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from typing import Callable, Dict, Optional

import torch

from .roofline import kernel_bound
from .scan_times import device_us

ATTN_BWD_HEADS = ((12, 4), (6, 2), (8, 8), (4, 4))


# ------------------------------------------------------- work of each kernel
def mxv_cost(b: int, n: int, m: int) -> tuple:
    """(operations, bytes) of the crossbar MxV: x (B, N) f32, wq (M, N)
    int8, its M f32 scales, y (B, M) f32."""
    return 2 * b * n * m + b * m, b * n * 4 + m * n + m * 4 + b * m * 4


def attn_cost(b: int, hq: int, hkv: int, sq: int, sk: int, d: int,
              elem: int, causal: bool = True) -> tuple:
    """(operations, bytes) of flash attention: 4 d operations per unmasked
    (query, key) pair and head; q, k, v read once, o written once."""
    off = sk - sq
    pairs = sum(min(sk, max(0, i + 1 + off)) for i in range(sq)) \
        if causal else sq * sk
    return (4 * d * pairs * b * hq,
            elem * (2 * b * hq * sq * d + 2 * b * hkv * sk * d))


def scan_cost(b: int, l: int, d: int, n: int, elem: int) -> tuple:
    """(operations, bytes) of the selective scan: 6 operations per (b, t,
    d, n) and 3 per (b, t, d); u, dt, B, C, A, D read once, y (f32) and the
    final state written once."""
    return (6 * b * l * d * n + 3 * b * l * d,
            2 * b * l * d * elem + 2 * b * l * n * elem + d * n * 4 + d * 4
            + b * l * d * 4 + b * d * n * 4)


# ------------------------------------------------------------------ timing
def events_us(fn: Callable, reps: int = 20, trials: int = 5) -> float:
    """Median over ``trials`` of the mean µs a call over ``reps`` calls
    back to back (CUDA events), after two warm-up calls."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(trials):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        torch.cuda.synchronize()
        out.append(a.elapsed_time(b) * 1e3 / reps)
    return statistics.median(out)


def kernel_names(fn: Callable, reps: int = 3) -> list:
    """The names (their first 60 characters) of the kernels one call of
    ``fn`` runs on the card, from a profile of ``reps`` calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sorted({e.name[:60] for e in prof.events()
                   if e.device_type == DeviceType.CUDA})


def _row(name: str, kernel: Callable, plain: Callable, match: str,
         cost: tuple, dtype: str, limit: float,
         library: Optional[Callable] = None) -> Dict:
    got, want = kernel(), plain()
    got, want = (got[0], want[0]) if isinstance(got, tuple) else (got, want)
    err = float((got.float() - want.float()).abs().max())
    scale = max(1.0, float(want.float().abs().max()))
    bound_s, by = kernel_bound(cost[0], cost[1], dtype)
    row = {"case": name, "us_per_launch": events_us(kernel),
           "device_us": device_us(kernel, match=match),
           "plain_us": events_us(plain, reps=3, trials=3),
           "max_abs_err": err, "limit": limit * scale,
           "ok": err <= limit * scale, "operations": cost[0],
           "bytes": cost[1], "bound_us": bound_s * 1e6, "bound_by": by,
           "library_us": events_us(library) if library else None}
    print(json.dumps(row), flush=True)
    return row


def rows(dev) -> list:
    """The three rows on ``dev``, each kernel held against its plain
    version."""
    import torch.nn.functional as F

    from ..kernels import ref
    from ..kernels.flash_attn import flash_attention
    from ..kernels.mamba_scan import selective_scan
    from ..kernels.mxv import crossbar_mxv
    gen = torch.Generator(device=dev).manual_seed(0)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    wq, sc = ref.quantize_crossbar(rnd(512, 512))
    x = rnd(16, 512)
    out = [_row("mxv 16x512x512", lambda: crossbar_mxv(x, wq, sc),
                lambda: ref.crossbar_mxv_ref(x, wq, sc), "crossbar_mxv",
                mxv_cost(16, 512, 512), "f32", 1e-5,
                lambda: F.linear(x, wq.to(torch.float32)) * sc)]
    q, k, v = rnd(1, 4, 512, 64), rnd(1, 2, 512, 64), rnd(1, 2, 512, 64)
    out.append(_row(
        "flash 4h x 512 x 64", lambda: flash_attention(q, k, v, causal=True),
        lambda: ref.attention_ref(q, k, v, causal=True), "flash_attention",
        attn_cost(1, 4, 2, 512, 512, 64, 4), "f32", 2e-3,
        lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                               enable_gqa=True)))
    u = rnd(2, 256, 64) * 0.3
    dt = rnd(2, 256, 64).abs() * 0.05
    a = -rnd(64, 16).abs()
    b, c, d = rnd(2, 256, 16), rnd(2, 256, 16), rnd(64)
    out.append(_row(
        "mamba_scan 2x256x64",
        lambda: selective_scan(u, dt, a, b, c, d, return_state=True),
        lambda: ref.selective_scan_ref(u, dt, a, b, c, d, return_state=True),
        "scan", scan_cost(2, 256, 64, 16, 4), "f32", 2e-3))
    return out


def sdpa_backward(dev) -> list:
    """SDPA's backward at the tensor-parallel flash backward's shapes, two
    ways: ATen's flash-attention backward called directly on the outputs
    of its forward (one call, as ``chip_smoke.py`` times the port's
    ``flash_attention_bwd``; its gradients held against autograd's), and
    through ``torch.autograd.grad`` of ``scaled_dot_product_attention``
    (``enable_gqa``; the autograd engine's host time included, and the
    backend SDPA picks).  µs per call (events), device µs and the kernels
    of each, and the op's largest difference from autograd's gradients
    over max(1, max |autograd's|)."""
    import torch.nn.functional as F
    aten = torch.ops.aten
    gen = torch.Generator(device=dev).manual_seed(1)
    out = []
    for hq, hkv in ATTN_BWD_HEADS:
        b, s, d = 4, 512, 128
        leaves = [torch.randn(shape, generator=gen, device=dev).to(
            torch.bfloat16).requires_grad_(True)
            for shape in ((b, hq, s, d), (b, hkv, s, d), (b, hkv, s, d))]
        do = torch.randn((b, hq, s, d), generator=gen, device=dev).to(
            torch.bfloat16)
        o = F.scaled_dot_product_attention(*leaves, is_causal=True,
                                           enable_gqa=True)
        grad = lambda: torch.autograd.grad(o, leaves, do, retain_graph=True)
        q, k, v = (t.detach() for t in leaves)
        fo, lse, cq, ck, mq, mk, seed, off = \
            aten._scaled_dot_product_flash_attention(q, k, v, 0.0, True)[:8]
        op = lambda: aten._scaled_dot_product_flash_attention_backward(
            do, q, k, v, fo, lse, cq, ck, mq, mk, 0.0, True, seed, off)
        err = max(float((a.float() - w.float()).abs().max())
                  / max(1.0, float(w.float().abs().max()))
                  for a, w in zip(op(), grad()))
        row = {"case": f"SDPA backward ({b}, {hq}, {hkv}, {s}, {d}) bf16 "
                       f"causal", "us_per_call": events_us(op, reps=10),
               "device_us": device_us(op, reps=10, match=""),
               "autograd_us_per_call": events_us(grad, reps=10),
               "autograd_device_us": device_us(grad, reps=10, match=""),
               "op_vs_autograd_rel": err, "op_kernels": kernel_names(op),
               "autograd_kernels": kernel_names(grad)}
        print(json.dumps(row), flush=True)
        out.append(row)
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bench_kernels: no CUDA device; the kernels run only on the "
              "card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False   # plain versions in f32
    dev = torch.device("cuda", 0)
    rec = {"rows": rows(dev), "sdpa_backward": sdpa_backward(dev)}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    rec["card"] = smi.stdout.strip().splitlines()[0] if smi.stdout else None
    print(rec["card"])
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rec, f, indent=1)
    return 0 if all(r["ok"] for r in rec["rows"]) else 1


if __name__ == "__main__":
    sys.exit(main())
