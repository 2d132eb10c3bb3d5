"""The 10 assigned architectures — one module per arch (deliverable f).

Importing this module populates the registry; ``get_arch(name)`` /
``all_archs()`` in :mod:`repro.configs.base` trigger the import lazily.

Port copy of ``repro.configs.archs`` (pure Python, unchanged).
"""

from .qwen2_vl_7b import qwen2_vl_7b
from .qwen2_moe_a2_7b import qwen2_moe_a27b
from .qwen3_moe_235b_a22b import qwen3_moe_235b
from .jamba_1_5_large_398b import jamba_15_large
from .llama3_2_3b import llama32_3b
from .gemma_2b import gemma_2b
from .phi3_medium_14b import phi3_medium_14b
from .qwen2_7b import qwen2_7b
from .falcon_mamba_7b import falcon_mamba_7b
from .seamless_m4t_large_v2 import seamless_m4t_large_v2

ALL = [
    "qwen2-vl-7b", "qwen2-moe-a2.7b", "qwen3-moe-235b-a22b",
    "jamba-1.5-large-398b", "llama3.2-3b", "gemma-2b", "phi3-medium-14b",
    "qwen2-7b", "falcon-mamba-7b", "seamless-m4t-large-v2",
]

__all__ = ["ALL"]
