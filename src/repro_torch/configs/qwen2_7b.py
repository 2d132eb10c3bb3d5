"""Assigned architecture config (exact dims from the assignment table).

Port copy of ``repro.configs.qwen2_7b`` (pure Python, unchanged).
"""

from .base import ArchConfig, register

qwen2_7b = register(ArchConfig(
    name="qwen2-7b", family="dense",
    n_layers=28, d_model=3584, n_heads=28, n_kv_heads=4,
    d_ff=18944, vocab_size=152064, head_dim=128, qkv_bias=True,
    notes="GQA, QKV bias [arXiv:2407.10671]",
))
