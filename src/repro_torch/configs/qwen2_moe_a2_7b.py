"""Assigned architecture config (exact dims from the assignment table).

Port copy of ``repro.configs.qwen2_moe_a2_7b`` (pure Python, unchanged).
"""

from .base import ArchConfig, MoESpec, register

qwen2_moe_a27b = register(ArchConfig(
    name="qwen2-moe-a2.7b", family="moe",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=1408, vocab_size=151936, head_dim=128, qkv_bias=True,
    moe=MoESpec(n_experts=60, top_k=4, d_ff=1408,
                n_shared=4, shared_d_ff=5632),
    notes="4 shared + 60 routed top-4 [hf:Qwen/Qwen1.5-MoE-A2.7B]",
))
