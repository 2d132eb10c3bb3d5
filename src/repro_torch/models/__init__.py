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

**Under a mesh.**  A model built under an ambient mesh of more than one
rank (``layers.ambient_mesh``) holds only its rank's shards, as
``sharding.rules.port_layout`` lays them out (``model.shards``; each
parameter's ``placement``): the values of the one-card model from the same
seed, each layer's tensors made whole, cut to the rank's part and freed
before the next layer's are made.  An enc-dec keeps its parameters
replicated there (its moments are still cut by ZeRO-1).  Such a model
trains (``train.loop``); serving it is not ported (``prefill`` and
``decode_step`` raise).
"""

from __future__ import annotations

from typing import Dict, Optional, Union

import torch

from ..configs.base import ArchConfig
from ..kernels import ops
from . import encdec, layers, lm
from .encdec import EncDec
from .lm import LM

Model = Union[LM, EncDec]


def build_model(cfg: ArchConfig, device="cuda", seed: int = 0,
                shard: bool = True) -> Model:
    """The model of ``cfg`` on ``device``, initialised from ``seed``; under
    an ambient mesh of more than one rank (and ``shard``), the rank's
    shards of it (the module docstring).  ``scores_dtype="bfloat16"`` only
    off the card: its attention takes the plain path."""
    if cfg.scores_dtype not in ("float32", "bfloat16"):
        raise ValueError(f"{cfg.name}: unknown scores_dtype "
                         f"{cfg.scores_dtype!r}")
    if cfg.scores_dtype != "float32" and torch.device(device).type == "cuda":
        raise NotImplementedError(
            f"{cfg.name}: scores_dtype={cfg.scores_dtype!r} "
            f"{ops.SCORES_ON_THE_CARD}")
    if cfg.kv_dtype not in ("compute", "int8"):
        raise ValueError(f"{cfg.name}: unknown kv_dtype {cfg.kv_dtype!r}")
    mesh = layers._ambient_mesh()
    if not shard or mesh is None or mesh.size() == 1:
        return EncDec(cfg, device, seed) if cfg.is_encdec else \
            LM(cfg, device, seed)
    from ..sharding.rules import ModelShards, abstract_model, port_layout
    shards = ModelShards(mesh, *port_layout(cfg, abstract_model(cfg), mesh))
    if cfg.is_encdec:
        model = EncDec(cfg, device, seed)
    else:
        model = LM(cfg, device, seed, keep=shards.cut)
    model.shards = shards
    for name, p in model.named_parameters():
        p.placement = shards.params[name]
    return model


def _refuse_split(model: Model) -> None:
    if model.shards is not None and model.shards.split:
        raise NotImplementedError(
            f"{model.cfg.name}: serving a model split over a mesh is not "
            f"ported (ROADMAP Queue 1 item 10(i), serving under "
            f"cache_specs)")


def prefill(cfg: ArchConfig, model: Model, batch: Dict, max_len: int,
            use_kernel: bool = True, cache: Optional[Dict] = None):
    """The reference's ``Model.prefill``: ``batch`` holds ``"tokens"`` (B,
    S), or ``"embeds"`` (B, S, d) for the VLM family, or both for an
    enc-dec (frame embeddings and the decoder prompt).  Returns
    (last_logits (B, V) f32, cache); given ``cache``, fills it in place."""
    _refuse_split(model)
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
    _refuse_split(model)
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
