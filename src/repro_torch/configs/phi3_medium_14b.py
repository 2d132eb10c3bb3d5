"""Assigned architecture config (exact dims from the assignment table).

Port copy of ``repro.configs.phi3_medium_14b`` (pure Python, unchanged).
"""

from .base import ArchConfig, register

phi3_medium_14b = register(ArchConfig(
    name="phi3-medium-14b", family="dense",
    n_layers=40, d_model=5120, n_heads=40, n_kv_heads=10,
    d_ff=17920, vocab_size=100352, head_dim=128,
    notes="RoPE SwiGLU GQA [arXiv:2404.14219]",
))
