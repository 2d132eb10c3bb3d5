"""Architecture configuration system.

One ``ArchConfig`` per assigned architecture (exact dims from the assignment
table), plus reduced smoke variants and the per-arch input-shape sets.

Port copy of ``repro.configs.base`` (pure Python, unchanged).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoESpec:
    n_experts: int
    top_k: int
    d_ff: int                      # per-expert intermediate size
    n_shared: int = 0              # shared ("always-on") experts
    shared_d_ff: int = 0
    every: int = 1                 # MoE on layers where i % every == offset
    offset: int = 0
    capacity_factor: float = 1.25


@dataclasses.dataclass(frozen=True)
class SSMSpec:
    state: int = 16
    conv: int = 4
    expand: int = 2
    dt_rank: int = 0               # 0 => ceil(d_model / 16)


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                    # dense | moe | hybrid | ssm | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0              # 0 => d_model // n_heads
    qkv_bias: bool = False
    qk_norm: bool = False
    mlp_act: str = "silu"          # silu => SwiGLU, gelu => GeGLU
    norm: str = "rmsnorm"
    rope_theta: float = 1_000_000.0
    mrope_sections: Optional[Tuple[int, ...]] = None   # qwen2-vl M-RoPE
    tie_embeddings: bool = False
    moe: Optional[MoESpec] = None
    ssm: Optional[SSMSpec] = None
    # layer pattern, one char per position within a repeating period:
    #   'A' attention block, 'M' mamba block.  None => all 'A'.
    layer_period: Optional[str] = None
    encoder_layers: int = 0        # >0 => encoder-decoder
    embed_inputs: bool = False     # vlm/audio: inputs are precomputed embeddings
    # dtype / memory policy
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    adam_dtype: str = "float32"
    fsdp: bool = False             # shard params over 'data' too (ZeRO-3 style)
    remat: bool = True
    remat_policy: str = "full"     # full | dots (save matmul outputs)
    q_chunk: int = 512             # blockwise-attention query chunk
    ssm_chunk: int = 256           # chunked associative scan length
    # Dry-run only: unroll every lax.scan/map into straight-line HLO so
    # compiled.cost_analysis() counts all iterations (XLA costs while-loop
    # bodies ONCE; see EXPERIMENTS.md §Dry-run caveats).  Never used on the
    # host paths — unrolled 94-layer graphs are compile-time hostile.
    static_unroll: bool = False
    # Attention-internal sharding (hillclimb; see EXPERIMENTS.md §Perf).
    #   default   — leave layout to GSPMD (head_dim gets sharded when heads
    #               don't divide the model axis => giant score all-reduce);
    #   replicate — constrain q/k/v to batch-only sharding (scores local);
    #   seq       — context-parallel: q and scores sharded over the model
    #               axis on the *query-sequence* dim, k/v replicated (the
    #               GQA long-context layout).
    attn_shard: str = "default"
    # Cross-device reduction dtype for attention scores path: bf16 halves
    # any score-sized collective and score HBM traffic (MXU accumulates in
    # f32 regardless; CPU oracle tolerance in tests covers the delta).
    scores_dtype: str = "float32"
    # Causal flop bounding: q-chunk i only multiplies against keys that can
    # be unmasked for it (a *static* slice when chunks are unrolled).  With
    # attn_shard="seq" the sequence is STRIPED across the model axis (row j
    # of group g has global position j*mm + g) so the key bound is uniform
    # over groups — work stays balanced AND ~45% of attention flops vanish.
    causal_bound: bool = False
    # Decode KV-cache dtype: "compute" stores K/V in compute_dtype; "int8"
    # stores symmetric per-(position, kv-head) int8 with an f32 scale —
    # halves the cache-read traffic that dominates decode (§Perf pair B).
    kv_dtype: str = "compute"
    # With attn_shard="seq": also keep the residual stream sequence-sharded
    # between blocks (full sequence parallelism).  False = CP inside
    # attention only, Megatron-style replicated residual for the MLP —
    # cheaper backward (no sharded-token weight-grad contraction).
    seq_residual: bool = True
    # Gradient accumulation: >1 selects the microbatched train step
    # (distributed.overlap.make_accum_train_step) — per-microbatch bucket
    # reductions overlap the next microbatch's backward.
    grad_accum: int = 1
    # Gradient compression applied to the accumulated gradient before the
    # optimizer ("none" | "int8" | "topk") — wire-faithful numerics; the
    # payload accounting lives in distributed.compression.wire_bytes.
    grad_compression: str = "none"
    notes: str = ""

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    @property
    def attn_free(self) -> bool:
        return self.layer_period is not None and "A" not in self.layer_period

    def pattern(self) -> str:
        """Full per-layer pattern string of length n_layers."""
        if self.layer_period is None:
            return "A" * self.n_layers
        period = self.layer_period
        assert self.n_layers % len(period) == 0, (self.name, len(period))
        return period * (self.n_layers // len(period))

    def moe_layer(self, i: int) -> bool:
        return (self.moe is not None
                and i % self.moe.every == self.moe.offset)

    def param_count(self) -> int:
        """Approximate parameter count (embeddings + blocks)."""
        d, v = self.d_model, self.vocab_size
        total = v * d * (1 if self.tie_embeddings else 2)
        pat = self.pattern()
        for i, kind in enumerate(pat):
            if kind == "A":
                qkv = d * (self.n_heads + 2 * self.n_kv_heads) * self.hd
                total += qkv + self.n_heads * self.hd * d
            else:
                ssm = self.ssm or SSMSpec()
                di = ssm.expand * d
                dtr = ssm.dt_rank or -(-d // 16)
                total += 2 * d * di + di * d + ssm.conv * di \
                    + di * (dtr + 2 * ssm.state) + dtr * di + 2 * di
            if self.moe_layer(i):
                m = self.moe
                total += m.n_experts * 3 * d * m.d_ff
                total += m.n_shared * 3 * d * m.shared_d_ff // max(m.n_shared, 1) \
                    if m.n_shared else 0
                total += d * m.n_experts  # router
            else:
                total += 3 * d * self.d_ff
        if self.is_encdec:  # encoder stack + cross-attention
            enc = self.encoder_layers * (
                4 * d * self.n_heads * self.hd + 3 * d * self.d_ff)
            cross = self.n_layers * 4 * d * self.n_heads * self.hd
            total += enc + cross
        return total

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: top-k + shared only)."""
        if self.moe is None:
            return self.param_count()
        d = self.d_model
        m = self.moe
        total = self.param_count()
        n_moe_layers = sum(self.moe_layer(i) for i in range(self.n_layers))
        total -= n_moe_layers * m.n_experts * 3 * d * m.d_ff
        total += n_moe_layers * m.top_k * 3 * d * m.d_ff
        return total


# ------------------------------------------------------------------- shapes
@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str                      # train | prefill | decode


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


def shapes_for(cfg: ArchConfig) -> List[str]:
    """Applicable shape cells for an architecture (skips noted in DESIGN.md)."""
    out = ["train_4k", "prefill_32k", "decode_32k"]
    # long_500k needs sub-quadratic attention: run only for SSM/hybrid.
    if cfg.family in ("ssm", "hybrid"):
        out.append("long_500k")
    return out


_REGISTRY: Dict[str, ArchConfig] = {}


def register(cfg: ArchConfig) -> ArchConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_arch(name: str) -> ArchConfig:
    if name not in _REGISTRY:
        from . import archs  # noqa: F401  (populate registry)
    return _REGISTRY[name]


def all_archs() -> List[str]:
    from . import archs  # noqa: F401
    return sorted(_REGISTRY)


def smoke_config(name: str) -> ArchConfig:
    """Reduced same-family config for CPU smoke tests."""
    cfg = get_arch(name)
    changes = dict(
        n_layers=len(cfg.layer_period) if cfg.layer_period else 2,
        d_model=64, n_heads=4, n_kv_heads=max(1, min(cfg.n_kv_heads, 2)),
        d_ff=128, vocab_size=256, head_dim=16,
        param_dtype="float32", compute_dtype="float32",
        q_chunk=16, ssm_chunk=8, fsdp=False,
    )
    if cfg.moe is not None:
        changes["moe"] = dataclasses.replace(
            cfg.moe, n_experts=4, top_k=2, d_ff=32,
            shared_d_ff=32 if cfg.moe.n_shared else 0)
    if cfg.ssm is not None:
        changes["ssm"] = dataclasses.replace(cfg.ssm, state=4, dt_rank=8)
    if cfg.encoder_layers:
        changes["encoder_layers"] = 2
    if cfg.mrope_sections is not None:
        changes["mrope_sections"] = (2, 3, 3)
    return dataclasses.replace(cfg, **changes)
