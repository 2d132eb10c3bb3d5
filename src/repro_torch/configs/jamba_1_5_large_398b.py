"""Assigned architecture config (exact dims from the assignment table).

Port copy of ``repro.configs.jamba_1_5_large_398b`` (pure Python, unchanged).
"""

from .base import ArchConfig, MoESpec, SSMSpec, register

jamba_15_large = register(ArchConfig(
    name="jamba-1.5-large-398b", family="hybrid",
    n_layers=72, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=24576, vocab_size=65536, head_dim=128,
    moe=MoESpec(n_experts=16, top_k=2, d_ff=24576, every=2, offset=1),
    ssm=SSMSpec(state=16, conv=4, expand=2),
    # attn:mamba 1:7 interleave — one attention layer per 8-layer period.
    layer_period="MMMMAMMM",
    fsdp=True, adam_dtype="bfloat16",
    notes="Mamba+attn 1:7, MoE every 2 layers [arXiv:2403.19887]",
))
