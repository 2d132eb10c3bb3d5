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
trains (``train.loop``) and, a decoder (dense, MoE, Mamba, hybrid, VLM),
serves: :func:`prefill` and :func:`decode_step`, called on every rank under
the mesh with the whole batch, run on the rank's shards and its part of
the cache, laid out by ``sharding.rules.cache_specs`` (:func:`init_cache`
makes the rank's part; ``models.lm.serve_part``): the batch over the batch
axes where they divide it, else the positions over "data"; the KV heads
over "model" where it divides them, else the head dim; Mamba's channels
over "model".  The logits are the rank's block, as the reference's
``logit_sh`` lays them (rows over the batch axes where they divide B, the
vocabulary over "model" where it divides V); :func:`gather_logits` makes
them whole.  The enc-dec and ``attn_shard="seq"``, whose parameters stay
whole under a mesh, do not serve there (ROADMAP item 10(k)).
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
    cfg = model.cfg
    if model.shards is not None and (cfg.is_encdec
                                     or cfg.attn_shard == "seq"):
        what = "an enc-dec" if cfg.is_encdec else 'attn_shard="seq"'
        raise NotImplementedError(
            f"{cfg.name}: serving {what} built under a mesh is not ported "
            f"(ROADMAP Queue 1 item 10(k): its parameters stay whole there)")


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
    tokens (B,), or for the VLM family their embeddings (B, d) (looked up
    on every model rank's rows of a split table, ``lm.vocab_lookup``)."""
    if cfg.embed_inputs and not cfg.is_encdec:
        return lm.vocab_lookup(model.embed, tok)
    return tok


def gather_logits(cfg: ArchConfig, model: Model, logits: torch.Tensor,
                  cache: Dict) -> torch.Tensor:
    """The whole (B, V) logits from every rank's block of them (a
    collective every rank of the mesh calls), for a greedy caller; the
    logits themselves without a mesh.  ``cache``: the call's."""
    part = cache.get("part")
    if part is None:
        return logits
    from ..sharding.rules import Placement, unshard
    table = lm.unembed_matrix(cfg, model)
    vocab = "model" if layers._split_over(table, "model", 0) else None
    return unshard(logits, Placement((part.row_entry, vocab)),
                   model.shards.mesh)


def encoder_frames(cfg: ArchConfig, batch: Dict) -> int:
    """S_enc of a prefill ``batch``: an enc-dec's frames, 0 for a
    decoder."""
    return batch["embeds"].shape[1] if cfg.is_encdec else 0


def init_cache(cfg: ArchConfig, model: Model, batch: int, max_len: int,
               enc_len: int = 0) -> Dict:
    """A zero cache of ``batch`` rows of ``max_len`` positions (over
    ``enc_len`` encoder frames for an enc-dec), on the model's device; for
    a model built under a mesh, the rank's part of it."""
    _refuse_split(model)
    if cfg.is_encdec:
        return encdec.init_encdec_cache(cfg, batch, max_len, enc_len,
                                        model.device)
    return lm.init_cache(cfg, batch, max_len, model.device,
                         lm.model_part(cfg, model, batch, max_len))


def reset_cache(cfg: ArchConfig, cache: Dict) -> None:
    """Set ``cache`` back to :func:`init_cache`'s values, in place."""
    if cfg.is_encdec:
        encdec.reset_cache(cache)
    else:
        lm.reset_cache(cache)


__all__ = ["EncDec", "LM", "Model", "build_model", "decode_step", "encdec",
           "encoder_frames", "gather_logits", "init_cache", "layers", "lm",
           "loss", "prefill", "reset_cache", "step_input"]
