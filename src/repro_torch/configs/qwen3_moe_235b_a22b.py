"""Assigned architecture config (exact dims from the assignment table).

Port copy of ``repro.configs.qwen3_moe_235b_a22b`` (pure Python, unchanged).
"""

from .base import ArchConfig, MoESpec, register

qwen3_moe_235b = register(ArchConfig(
    name="qwen3-moe-235b-a22b", family="moe",
    n_layers=94, d_model=4096, n_heads=64, n_kv_heads=4,
    d_ff=1536, vocab_size=151936, head_dim=128, qk_norm=True,
    moe=MoESpec(n_experts=128, top_k=8, d_ff=1536),
    fsdp=True, adam_dtype="bfloat16",
    notes="128 experts top-8 [hf:Qwen/Qwen3-30B-A3B scaled]; FSDP + bf16 "
          "moments to fit 16GB/chip at 256 chips",
))
