"""Assigned architecture config (exact dims from the assignment table).

Port copy of ``repro.configs.llama3_2_3b`` (pure Python, unchanged).
"""

from .base import ArchConfig, register

llama32_3b = register(ArchConfig(
    name="llama3.2-3b", family="dense",
    n_layers=28, d_model=3072, n_heads=24, n_kv_heads=8,
    d_ff=8192, vocab_size=128256, head_dim=128,
    rope_theta=500_000.0, tie_embeddings=True,
    notes="small llama3 [hf:meta-llama/Llama-3.2-3B]",
))
