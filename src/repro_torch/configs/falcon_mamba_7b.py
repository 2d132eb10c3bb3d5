"""Assigned architecture config (exact dims from the assignment table).

Port copy of ``repro.configs.falcon_mamba_7b`` (pure Python, unchanged).
"""

from .base import ArchConfig, SSMSpec, register

falcon_mamba_7b = register(ArchConfig(
    name="falcon-mamba-7b", family="ssm",
    n_layers=64, d_model=4096, n_heads=0, n_kv_heads=0,
    d_ff=0, vocab_size=65024,
    ssm=SSMSpec(state=16, conv=4, expand=2),
    layer_period="M",
    notes="mamba1 arch, attn-free [arXiv:2410.05355]",
))
