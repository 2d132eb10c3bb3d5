"""Language models of the port: the dense, MoE, Mamba (SSM) and hybrid
decoder families.

Port of ``repro.models`` for decoder-only models.  ``build_model(cfg,
device=...)`` returns an :class:`lm.LM`, an ``nn.Module`` holding the
parameters, with ``init_cache(batch, max_len)``, ``prefill(tokens,
max_len)`` and ``decode_step(cache, tokens)`` (the reference's ``Model``
takes the params as an argument instead).  Entry points run on ``"cuda"``
unless given ``device="cpu"``.  Enc-dec models, embedding inputs and M-RoPE
(qwen2-vl, seamless-m4t) are not ported yet and raise
``NotImplementedError`` naming their ROADMAP item.
"""

from __future__ import annotations

from ..configs.base import ArchConfig
from . import layers, lm
from .lm import LM

# what each unported feature waits for, as ROADMAP.md's queues name it
_UNPORTED = (
    ("is_encdec", "encoder-decoder models (models/encdec.py) are not ported "
                  "yet (ROADMAP Queue 1 item 8)"),
    ("embed_inputs", "embedding inputs (the VLM and audio families) are not "
                     "ported yet (ROADMAP Queue 1 item 8)"),
    ("mrope_sections", "M-RoPE (qwen2-vl) is not ported yet (ROADMAP Queue 1 "
                       "item 8)"),
)


def build_model(cfg: ArchConfig, device="cuda", seed: int = 0) -> LM:
    """The LM of ``cfg`` on ``device``, initialised from ``seed``."""
    for attr, why in _UNPORTED:
        if getattr(cfg, attr):
            raise NotImplementedError(f"{cfg.name}: {why}")
    if cfg.scores_dtype != "float32":
        raise NotImplementedError(
            f"{cfg.name}: scores_dtype={cfg.scores_dtype!r} (a knob of the "
            f"sharded dry run) is not ported; the flash kernels keep f32 "
            f"scores")
    if cfg.kv_dtype not in ("compute", "int8"):
        raise ValueError(f"{cfg.name}: unknown kv_dtype {cfg.kv_dtype!r}")
    return LM(cfg, device, seed)


__all__ = ["LM", "build_model", "layers", "lm"]
