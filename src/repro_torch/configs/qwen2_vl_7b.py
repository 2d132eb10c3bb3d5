"""Assigned architecture config (exact dims from the assignment table).

Port copy of ``repro.configs.qwen2_vl_7b`` (pure Python, unchanged).
"""

from .base import ArchConfig, register

qwen2_vl_7b = register(ArchConfig(
    name="qwen2-vl-7b", family="vlm",
    n_layers=28, d_model=3584, n_heads=28, n_kv_heads=4,
    d_ff=18944, vocab_size=152064, head_dim=128,
    qkv_bias=True, mrope_sections=(16, 24, 24), embed_inputs=True,
    notes="M-RoPE, dynamic resolution; patch frontend stubbed — "
          "input_specs() provides precomputed patch embeddings "
          "[arXiv:2409.12191]",
))
