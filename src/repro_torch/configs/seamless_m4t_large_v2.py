"""Assigned architecture config (exact dims from the assignment table).

Port copy of ``repro.configs.seamless_m4t_large_v2`` (pure Python, unchanged).
"""

from .base import ArchConfig, register

seamless_m4t_large_v2 = register(ArchConfig(
    name="seamless-m4t-large-v2", family="encdec",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=8192, vocab_size=256206, head_dim=64,
    norm="layernorm", encoder_layers=24, embed_inputs=True,
    tie_embeddings=True,
    notes="enc-dec (24 enc + 24 dec per hf config), speech frontend "
          "stubbed — input_specs() provides frame embeddings "
          "[arXiv:2308.11596]",
))
