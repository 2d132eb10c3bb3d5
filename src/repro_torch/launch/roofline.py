"""Three-term roofline of one rank's step, at an NVIDIA H100 SXM's data-sheet
rates.

Port of ``repro.launch.roofline``:

  compute    = FLOPs      / (chips * 989 TFLOP/s bf16)
  memory     = bytes      / (chips * 3.35 TB/s HBM3)
  collective = coll_bytes / (chips * 450 GB/s NVLink), the bytes of groups
               that span more than one host of 8 cards at 50 GB/s a card

Every rate here is the **specification** (NVIDIA's H100 SXM data sheet,
dense, and the DGX H100's network), not a measurement; PERF.md measures
against them.  ``roofline_terms`` keeps the reference's formula and output
keys, with the rates as keyword arguments (the reference's TPU rates
given there reproduce its numbers).  Its FLOPs, bytes and collective bytes
come from a trace of the rank's program on fake tensors
(``launch.dryrun``): the collectives from ``distributed.comm.
CollectiveLog``, which takes the place of the reference's
``cost_dict``/``parse_collectives`` over XLA's HLO
(:func:`collective_summary`).
"""

from __future__ import annotations

from typing import Dict, Iterable, Tuple

# NVIDIA H100 SXM5 data sheet (dense, no sparsity): spec, not measured.
PEAK_FLOPS = 989e12           # bf16 tensor cores, per card
PEAK_OPS = {"bf16": 989e12, "f32": 67e12, "int8": 1979e12}
HBM_BW = 3.35e12              # bytes/s per card, HBM3
LINK_BW = 450e9               # bytes/s each way, NVLink 4 to the host's cards
# DGX H100: one 400 Gb/s NDR InfiniBand port a GPU (ConnectX-7), 50 GB/s
# each way: what a group that leaves its host moves at.
NETWORK_BW = 50e9
CARDS_PER_HOST = 8            # DGX H100; rank r on host r // 8


def collective_summary(records: Iterable) -> Dict[str, Dict[str, float]]:
    """``{kind: {"bytes", "count"}}`` of ``distributed.comm.Collective``
    records, as the reference's ``parse_collectives`` gives it."""
    from ..distributed.comm import KINDS
    out: Dict[str, Dict[str, float]] = {
        k: {"bytes": 0.0, "count": 0} for k in KINDS}
    for r in records:
        out[r.kind]["bytes"] += r.nbytes
        out[r.kind]["count"] += 1
    return out


def spans_hosts(ranks: Tuple[int, ...],
                cards_per_host: int = CARDS_PER_HOST) -> bool:
    """Whether a group of these global ranks spans more than one host."""
    return len({r // cards_per_host for r in ranks}) > 1


def network_bytes(records: Iterable,
                  cards_per_host: int = CARDS_PER_HOST) -> float:
    """The operand bytes of the collectives whose group leaves its host."""
    return float(sum(r.nbytes for r in records
                     if spans_hosts(r.ranks, cards_per_host)))


def roofline_terms(*, flops_per_device: float, bytes_per_device: float,
                   coll_bytes_per_device: float, chips: int,
                   model_flops: float,
                   analytic_bytes_per_device: float = 0.0,
                   network_bytes_per_device: float = 0.0,
                   peak_flops: float = PEAK_FLOPS, hbm_bw: float = HBM_BW,
                   link_bw: float = LINK_BW,
                   network_bw: float = NETWORK_BW) -> Dict[str, float]:
    """All inputs per device.  ``network_bytes_per_device`` is the part of
    ``coll_bytes_per_device`` over groups that span hosts, charged at
    ``network_bw``; the rest at ``link_bw``.

    ``bytes_per_device`` is an upper bound where given (every operand of
    every traced operator, unfused); where ``analytic_bytes_per_device``
    is given (:func:`analytic_bytes`), it decides the memory term and the
    traced one is reported as ``t_memory_hlo_ub_s``, as in the
    reference."""
    global_flops = flops_per_device * chips
    global_bytes = bytes_per_device * chips
    global_coll = coll_bytes_per_device * chips
    t_compute = global_flops / (chips * peak_flops)
    t_memory_hlo = global_bytes / (chips * hbm_bw)
    t_memory = (analytic_bytes_per_device / hbm_bw
                if analytic_bytes_per_device else t_memory_hlo)
    t_coll = ((coll_bytes_per_device - network_bytes_per_device) / link_bw
              + network_bytes_per_device / network_bw)
    dominant = max((("compute", t_compute), ("memory", t_memory),
                    ("collective", t_coll)), key=lambda kv: kv[1])[0]
    bound = max(t_compute, t_memory, t_coll)
    return {
        "hlo_flops": global_flops,
        "hlo_bytes": global_bytes,
        "analytic_bytes_per_device": analytic_bytes_per_device,
        "collective_bytes": global_coll,
        "t_compute_s": t_compute,
        "t_memory_s": t_memory,
        "t_memory_hlo_ub_s": t_memory_hlo,
        "t_collective_s": t_coll,
        "dominant": dominant,
        "model_flops": model_flops,
        "useful_flops_ratio": (model_flops / global_flops
                               if global_flops else 0.0),
        # the share of the compute roofline a step at the bound reaches
        "roofline_fraction": (model_flops / (chips * peak_flops)) / bound
        if bound else 0.0,
    }


def kernel_bound(flops: float, nbytes: float,
                 dtype: str = "bf16") -> Tuple[float, str]:
    """(seconds, "bytes" or "operations"): the least time a card could take
    for a kernel that moves ``nbytes`` (each input read once, each output
    written once) and does ``flops`` operations of ``dtype`` ("bf16",
    "f32", "int8"), the larger of the two at the data-sheet rates."""
    t_bytes, t_ops = nbytes / HBM_BW, flops / PEAK_OPS[dtype]
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def analytic_bytes(cfg, shape, chips: int) -> float:
    """Per-device HBM traffic model for one step on the card.

    Assumptions (the reference's):
      * attention runs in the port's flash kernels (``csrc/flash_attn.cu``
        and its backward): no S^2 score traffic;
      * elementwise chains move each tensor once (read x, write y once per
        layer block);
      * c_act activation-IO coefficient: ~12 tensor r/w of (B,S,d) per
        layer forward (QKV/O + gate/up/down + norms + residuals), x1.5 for
        remat recompute, x2 for backward;
      * train weight traffic: read fwd + read recompute + read bwd + write
        update (params), read+write both Adam moments, read+write grads
        (the AdamW kernels' one pass);
      * MoE: all expert weights stream through per step, dispatch buffers
        add cf*top_k expanded activation traffic;
      * decode: active params read once + KV/SSM cache read (the split-KV
        decode kernels) + tail write.
    """
    p_total = cfg.param_count()
    p_active = cfg.active_param_count()
    pb = 2 if cfg.param_dtype == "bfloat16" else 4
    ab = 2 if cfg.adam_dtype == "bfloat16" else 4
    b, s = shape.global_batch, shape.seq_len
    d, L = cfg.d_model, cfg.n_layers + cfg.encoder_layers
    act_b = 2 if cfg.compute_dtype == "bfloat16" else 4

    c_act = 12.0
    if cfg.moe is not None:
        c_act += 2.0 * cfg.moe.capacity_factor * cfg.moe.top_k
    if shape.kind == "train":
        w_io = p_total * (3 * pb + pb + 4 * ab + 2 * pb)
        act_io = L * c_act * b * s * d * act_b * 1.5 * 2
        return (w_io + act_io) / chips
    if shape.kind == "prefill":
        w_io = p_total * pb
        act_io = L * c_act * b * s * d * act_b
        cache_w = _cache_bytes(cfg, b, s, act_b)
        return (w_io + act_io + cache_w) / chips
    # decode: one token
    w_io = p_active * pb
    cache_rw = _cache_bytes(cfg, b, s, act_b) * 1.0     # full read
    return (w_io + cache_rw) / chips


def _cache_bytes(cfg, batch: int, seq_len: int, act_b: int) -> float:
    if cfg.attn_free:
        ssm = cfg.ssm
        din = ssm.expand * cfg.d_model
        return cfg.n_layers * batch * din * (ssm.state * 4 + ssm.conv * act_b)
    pat = (cfg.layer_period or "A") * (
        cfg.n_layers // len(cfg.layer_period or "A"))
    n_attn = pat.count("A")
    kv_b = (1.0 + 4.0 / cfg.hd) if cfg.kv_dtype == "int8" else act_b
    kv = 2 * n_attn * batch * seq_len * cfg.n_kv_heads * cfg.hd * kv_b
    if cfg.ssm is not None:
        din = cfg.ssm.expand * cfg.d_model
        kv += pat.count("M") * batch * din * (cfg.ssm.state * 4
                                              + cfg.ssm.conv * act_b)
    if cfg.is_encdec:
        kv += 2 * cfg.n_layers * batch * seq_len * cfg.n_kv_heads * \
            cfg.hd * kv_b                               # cross K/V
    return kv
