"""Models of the port: the dense, MoE, Mamba (SSM), hybrid and VLM decoder
families, and the encoder-decoder family.

Port of ``repro.models``.  ``build_model(cfg, device=...)`` returns an
``nn.Module`` holding the parameters: an :class:`lm.LM` for a decoder (the
VLM qwen2-vl included: it prefills from embeddings), an
:class:`encdec.EncDec` for ``cfg.is_encdec`` (seamless-m4t).  The
reference's ``Model`` takes the params as an argument and gives one
interface for every family; here :func:`prefill`, :func:`decode_step`,
:func:`init_cache` and :func:`reset_cache` do, over either module, with
the reference's ``batch`` dicts, and :func:`step_input` and
:func:`encoder_frames` say what a family's decode step takes and over how
many encoder frames.  :func:`loss` is the reference's ``Model.loss``
for every family: ``lm.lm_loss`` for the decoders (dense, MoE, Mamba,
hybrid, VLM), ``encdec.encdec_loss`` for the enc-dec.  Entry points run on
``"cuda"`` unless given ``device="cpu"``.
"""

from __future__ import annotations

from typing import Dict, Optional, Union

import torch

from ..configs.base import ArchConfig
from . import encdec, layers, lm
from .encdec import EncDec
from .lm import LM

Model = Union[LM, EncDec]


def build_model(cfg: ArchConfig, device="cuda", seed: int = 0) -> Model:
    """The model of ``cfg`` on ``device``, initialised from ``seed``."""
    if cfg.scores_dtype != "float32":
        raise NotImplementedError(
            f"{cfg.name}: scores_dtype={cfg.scores_dtype!r} (a knob of the "
            f"sharded dry run) is not ported; the flash kernels keep f32 "
            f"scores")
    if cfg.kv_dtype not in ("compute", "int8"):
        raise ValueError(f"{cfg.name}: unknown kv_dtype {cfg.kv_dtype!r}")
    if cfg.is_encdec:
        return EncDec(cfg, device, seed)
    return LM(cfg, device, seed)


def prefill(cfg: ArchConfig, model: Model, batch: Dict, max_len: int,
            use_kernel: bool = True, cache: Optional[Dict] = None):
    """The reference's ``Model.prefill``: ``batch`` holds ``"tokens"`` (B,
    S), or ``"embeds"`` (B, S, d) for the VLM family, or both for an
    enc-dec (frame embeddings and the decoder prompt).  Returns
    (last_logits (B, V) f32, cache); given ``cache``, fills it in place."""
    if cfg.is_encdec:
        return encdec.encdec_prefill(cfg, model, batch["embeds"],
                                     batch["tokens"], max_len, use_kernel,
                                     cache)
    return lm.prefill(cfg, model, batch.get("embeds", batch.get("tokens")),
                      max_len, use_kernel, cache)


def decode_step(cfg: ArchConfig, model: Model, cache: Dict, tokens,
                use_kernel: bool = True):
    """One step of every sequence, the cache updated in place: tokens (B,),
    or (B, d) embeddings for the VLM family."""
    if cfg.is_encdec:
        return encdec.encdec_decode_step(cfg, model, cache, tokens,
                                         use_kernel)
    return lm.decode_step(cfg, model, cache, tokens, use_kernel)


def loss(cfg: ArchConfig, model: Model, batch: Dict,
         use_kernel: bool = True):
    """The reference's ``Model.loss``: (scalar loss, {"ce", "aux"}) of
    ``batch`` (tensors on the model's device: a decoder's ``"tokens"`` or
    ``"embeds"``, ``"labels"``, optional ``"positions"``; an enc-dec's
    ``"embeds"``, ``"tokens"``, ``"labels"``), differentiable."""
    if cfg.is_encdec:
        return encdec.encdec_loss(cfg, model, batch, use_kernel)
    return lm.lm_loss(cfg, model, batch, use_kernel)


def step_input(cfg: ArchConfig, model: Model, tok: torch.Tensor):
    """A decode step's input, as the reference's engine feeds it: the
    tokens (B,), or for the VLM family their embeddings (B, d)."""
    if cfg.embed_inputs and not cfg.is_encdec:
        return model.embed[tok]
    return tok


def encoder_frames(cfg: ArchConfig, batch: Dict) -> int:
    """S_enc of a prefill ``batch``: an enc-dec's frames, 0 for a
    decoder."""
    return batch["embeds"].shape[1] if cfg.is_encdec else 0


def init_cache(cfg: ArchConfig, model: Model, batch: int, max_len: int,
               enc_len: int = 0) -> Dict:
    """A zero cache of ``batch`` rows of ``max_len`` positions (over
    ``enc_len`` encoder frames for an enc-dec), on the model's device."""
    if cfg.is_encdec:
        return encdec.init_encdec_cache(cfg, batch, max_len, enc_len,
                                        model.device)
    return lm.init_cache(cfg, batch, max_len, model.device)


def reset_cache(cfg: ArchConfig, cache: Dict) -> None:
    """Set ``cache`` back to :func:`init_cache`'s values, in place."""
    if cfg.is_encdec:
        encdec.reset_cache(cache)
    else:
        lm.reset_cache(cache)


__all__ = ["EncDec", "LM", "Model", "build_model", "decode_step", "encdec",
           "encoder_frames", "init_cache", "layers", "lm", "loss", "prefill",
           "reset_cache", "step_input"]
