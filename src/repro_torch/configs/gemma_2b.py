"""Assigned architecture config (exact dims from the assignment table).

Port copy of ``repro.configs.gemma_2b`` (pure Python, unchanged).
"""

from .base import ArchConfig, register

gemma_2b = register(ArchConfig(
    name="gemma-2b", family="dense",
    n_layers=18, d_model=2048, n_heads=8, n_kv_heads=1,
    d_ff=16384, vocab_size=256000, head_dim=256,
    mlp_act="gelu", tie_embeddings=True, rope_theta=10_000.0,
    notes="GeGLU, head_dim=256, MQA [arXiv:2403.08295]",
))
