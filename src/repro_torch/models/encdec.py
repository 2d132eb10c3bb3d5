"""Encoder-decoder transformer (the seamless-m4t backbone): parameters,
encoder, prefill and cached decode.

Port of the serving part of ``repro.models.encdec``.  The encoder is a
stack of bidirectional self-attention blocks over precomputed frame
embeddings (the speech frontend is a stub, as in the reference); the
decoder a stack of causal self-attention, cross-attention over the
encoder's output, and an MLP.  The reference keeps each stack's leaves
stacked over layers and runs ``lax.scan``; here :class:`EncDec` holds one
:class:`EncoderBlock` / :class:`DecoderBlock` per layer on an explicit
device and dtype, and the scan is a Python loop.  The embedding is tied:
the logits are ``h.f32 @ embed.f32^T``, from one f32 copy of the embedding
(:meth:`EncDec.unembed_f32`; 1.05 GB for seamless-m4t's 256,206 x 1,024).

Every attention goes through the port's kernels (``use_kernel=False``
selects the plain versions): the encoder's self-attention is a non-causal
flash attention, the decoder's a causal one in prefill and a flash decode
over its cache in a step, and the cross-attention a non-causal flash
attention with Sk = S_enc in prefill and a flash decode over the cross
cache (every row's length S_enc) in a step (``layers.cross_attention``).

The decode cache keeps the reference's structure, ``{"k", "v": (L, B,
max_len, Hkv, D), "xk", "xv": (L, B, S_enc, Hkv, D), "length": (B,)
int32}``, all in the compute dtype: the reference has no int8 cache for
this family, and :func:`check_config` refuses ``kv_dtype="int8"``.
:func:`encdec_decode_step` updates it **in place** (the self K/V at
``length``, then ``length`` itself), so a step captured once as a CUDA
graph (``serve.graphs.DecodeGraph``) advances it at every replay;
:func:`encdec_prefill` fills a new cache or, given ``cache=``, one the
caller owns; :func:`reset_cache` sets a cache back to zeros.

Training: :func:`encdec_loss` (the encoder, :func:`decode_train`'s
teacher-forced decoder, then ``lm.chunked_ce_loss`` over the tied
embedding), differentiated by autograd, with the flash kernels' backward
on the card: the encoder's attention non-causal, the decoder's causal, and
the cross-attention non-causal with Sq = S_dec over Sk = S_enc.  With
``cfg.remat`` each encoder and decoder layer runs under
``torch.utils.checkpoint`` where autograd records it, as the reference
wraps each in ``jax.checkpoint``: the backward recomputes the layer, so a
step launches the forward kernel twice per attention call.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.utils.checkpoint
from torch import nn

from ..configs.base import ArchConfig
from . import layers as L
from .lm import F32Unembedding, _frozen, chunked_ce_loss, resolve_device


def check_config(cfg: ArchConfig) -> None:
    """Raise for what the reference's enc-dec path does not have."""
    if cfg.kv_dtype != "compute":
        raise ValueError(f"{cfg.name}: kv_dtype={cfg.kv_dtype!r}, but the "
                         f"reference's encoder-decoder has no such path: its "
                         f"cache is always in the compute dtype")


class EncoderBlock(nn.Module):
    """One encoder layer: pre-norm bidirectional self-attention + pre-norm
    MLP."""

    def __init__(self, cfg: ArchConfig, gen: torch.Generator):
        super().__init__()
        self.norm1 = _frozen(L.init_norm(cfg, cfg.d_model, gen.device))
        self.attn = _frozen(L.init_attention(cfg, gen))
        self.norm2 = _frozen(L.init_norm(cfg, cfg.d_model, gen.device))
        self.mlp = _frozen(L.init_mlp(cfg, gen))

    def groups(self):
        return ("norm1", "attn", "norm2", "mlp")


class DecoderBlock(nn.Module):
    """One decoder layer: pre-norm causal self-attention (``norm1``,
    ``attn``), pre-norm cross-attention (``norm3``, ``cross``: no qkv
    bias), pre-norm MLP (``norm2``, ``mlp``)."""

    def __init__(self, cfg: ArchConfig, gen: torch.Generator):
        super().__init__()
        self.norm1 = _frozen(L.init_norm(cfg, cfg.d_model, gen.device))
        self.attn = _frozen(L.init_attention(cfg, gen))
        self.norm3 = _frozen(L.init_norm(cfg, cfg.d_model, gen.device))
        self.cross = _frozen(L.init_attention(cfg, gen, cross=True))
        self.norm2 = _frozen(L.init_norm(cfg, cfg.d_model, gen.device))
        self.mlp = _frozen(L.init_mlp(cfg, gen))

    def groups(self):
        return ("norm1", "attn", "norm3", "cross", "norm2", "mlp")


class EncDec(F32Unembedding, nn.Module):
    """An encoder-decoder's parameters on one device, initialised from
    ``seed`` by a ``torch.Generator`` on that device (other numbers than
    the reference's ``jax.random`` init: carry its weights across with
    ``models.convert.params_from_reference``)."""

    def __init__(self, cfg: ArchConfig, device="cuda", seed: int = 0):
        super().__init__()
        check_config(cfg)
        dev = resolve_device(device)
        self.cfg = cfg
        gen = torch.Generator(device=dev).manual_seed(seed)
        self.encoder = nn.ModuleList(EncoderBlock(cfg, gen)
                                     for _ in range(cfg.encoder_layers))
        self.enc_final_norm = _frozen(L.init_norm(cfg, cfg.d_model, dev))
        self.decoder = nn.ModuleList(DecoderBlock(cfg, gen)
                                     for _ in range(cfg.n_layers))
        self.final_norm = _frozen(L.init_norm(cfg, cfg.d_model, dev))
        self.embed = nn.Parameter(
            (torch.randn((cfg.vocab_size, cfg.d_model), generator=gen,
                         device=dev) * 0.02).to(L._dtype(cfg.param_dtype)),
            requires_grad=False)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def unembed_weight(self) -> torch.Tensor:
        return self.embed                        # tied, as the reference

    def init_cache(self, batch: int, max_len: int, enc_len: int) -> Dict:
        return init_encdec_cache(self.cfg, batch, max_len, enc_len,
                                 self.device)

    def prefill(self, embeds, tokens, max_len: int, use_kernel: bool = True,
                cache: Optional[Dict] = None):
        return encdec_prefill(self.cfg, self, embeds, tokens, max_len,
                              use_kernel, cache)

    def decode_step(self, cache: Dict, tokens, use_kernel: bool = True):
        return encdec_decode_step(self.cfg, self, cache, tokens, use_kernel)


def _positions(b: int, s: int, device) -> torch.Tensor:
    return torch.arange(s, device=device)[None].expand(b, s)


def _logits(model: EncDec, h):
    return h.to(torch.float32) @ model.unembed_f32().T


def _layers(cfg: ArchConfig, run, x, blocks):
    """``x`` through ``run(x, block)`` for each block in turn, each under
    ``torch.utils.checkpoint`` where autograd records it and ``cfg.remat``
    (the reference's ``jax.checkpoint`` of each layer)."""
    remat = cfg.remat and torch.is_grad_enabled()
    for p in blocks:
        if remat:
            x = torch.utils.checkpoint.checkpoint(
                run, x, p, use_reentrant=False, preserve_rng_state=False)
        else:
            x = run(x, p)
    return x


def encode(cfg: ArchConfig, model: EncDec, embeds,
           use_kernel: bool = True):
    """embeds (B, S_enc, d) -> the encoder's hidden states (B, S_enc, d),
    in the compute dtype."""
    b, s, _ = embeds.shape
    pos = _positions(b, s, model.device)
    x = embeds.to(device=model.device, dtype=L._dtype(cfg.compute_dtype))

    def run(x, p):
        h = L.apply_norm(cfg, p.norm1, x)
        x = x + L.attention(cfg, p.attn, h, pos, causal=False,
                            use_kernel=use_kernel)
        h = L.apply_norm(cfg, p.norm2, x)
        return x + L.mlp(cfg, p.mlp, h)

    x = _layers(cfg, run, x, model.encoder)
    return L.apply_norm(cfg, model.enc_final_norm, x)


# ------------------------------------------------------------------- training
def decode_train(cfg: ArchConfig, model: EncDec, tokens, enc_out,
                 use_kernel: bool = True):
    """The teacher-forced decoder: tokens (B, S_dec) over ``enc_out`` (B,
    S_enc, d) -> h (B, S_dec, d) after the final norm.  Mirrors
    ``repro.models.encdec.decode_train``."""
    b, s = tokens.shape
    pos = _positions(b, s, model.device)
    x = model.embed[tokens]

    def run(x, p):
        h = L.apply_norm(cfg, p.norm1, x)
        x = x + L.attention(cfg, p.attn, h, pos, causal=True,
                            use_kernel=use_kernel)
        h = L.apply_norm(cfg, p.norm3, x)
        kv = L.cross_kv(cfg, p.cross, enc_out)
        x = x + L.cross_attention(cfg, p.cross, h, kv, use_kernel=use_kernel)
        h = L.apply_norm(cfg, p.norm2, x)
        return x + L.mlp(cfg, p.mlp, h)

    x = _layers(cfg, run, x, model.decoder)
    return L.apply_norm(cfg, model.final_norm, x)


def encdec_loss(cfg: ArchConfig, model: EncDec, batch: Dict,
                use_kernel: bool = True) -> Tuple[torch.Tensor, Dict]:
    """batch: {'embeds' (B, S_enc, d), 'tokens' (B, S_dec), 'labels' (B,
    S_dec)} as tensors on the model's device -> (CE, {"ce", "aux": 0}), as
    ``repro.models.encdec.encdec_loss``."""
    enc_out = encode(cfg, model, batch["embeds"], use_kernel)
    h = decode_train(cfg, model, batch["tokens"], enc_out, use_kernel)
    ce = chunked_ce_loss(cfg, model, h, batch["labels"])
    return ce, {"ce": ce, "aux": torch.zeros((), dtype=torch.float32,
                                             device=ce.device)}


# --------------------------------------------------------------------- decode
def init_encdec_cache(cfg: ArchConfig, batch: int, max_len: int,
                      enc_len: int, device) -> Dict:
    """The decode cache of ``batch`` rows: self K/V of ``max_len``
    positions and cross K/V of ``enc_len`` frames per decoder layer, each
    leaf its own tensor (the reference shares one zero array between k and
    v; here they are written in place)."""
    check_config(cfg)
    cdt = L._dtype(cfg.compute_dtype)
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.hd)
    xshape = (cfg.n_layers, batch, enc_len, cfg.n_kv_heads, cfg.hd)
    return {"k": torch.zeros(shape, dtype=cdt, device=device),
            "v": torch.zeros(shape, dtype=cdt, device=device),
            "xk": torch.zeros(xshape, dtype=cdt, device=device),
            "xv": torch.zeros(xshape, dtype=cdt, device=device),
            "length": torch.zeros((batch,), dtype=torch.int32,
                                  device=device)}


def reset_cache(cache: Dict) -> None:
    """Set ``cache`` in place to :func:`init_encdec_cache`'s values."""
    for leaf in cache.values():
        leaf.zero_()


def _check_cache(cfg: ArchConfig, cache: Dict, batch: int, max_len: int,
                 enc_len: int) -> None:
    want = init_encdec_cache(cfg, batch, max_len, enc_len, "meta")
    if set(cache) != set(want) or any(
            cache[n].shape != w.shape or cache[n].dtype != w.dtype
            for n, w in want.items()):
        raise ValueError(f"{cfg.name}: the cache is not one of {batch} rows "
                         f"of {max_len} positions over {enc_len} frames")


def encdec_prefill(cfg: ArchConfig, model: EncDec, embeds, tokens,
                   max_len: int, use_kernel: bool = True,
                   cache: Optional[Dict] = None):
    """Encode ``embeds`` (B, S_enc, d), then run the decoder prompt
    ``tokens`` (B, S) teacher-forced; return (last_logits (B, V) f32,
    cache) with the self K/V of the prompt's S positions and the cross K/V
    filled.  Given ``cache`` (:func:`init_encdec_cache`'s for B, ``max_len``
    and S_enc), the state is written into it in place: its first S
    positions, the cross K/V and the length; a caller that reuses a cache
    resets it first (:func:`reset_cache`)."""
    b, s = tokens.shape
    if s > max_len:
        raise ValueError(f"prompt of {s} tokens does not fit a cache of "
                         f"{max_len}")
    enc_len = embeds.shape[1]
    if cache is None:
        cache = init_encdec_cache(cfg, b, max_len, enc_len, model.device)
    else:
        _check_cache(cfg, cache, b, max_len, enc_len)
    enc_out = encode(cfg, model, embeds, use_kernel)
    pos = _positions(b, s, model.device)
    x = model.embed[tokens]
    for i, p in enumerate(model.decoder):
        h = L.apply_norm(cfg, p.norm1, x)
        y, (k, v) = L.attention(cfg, p.attn, h, pos, causal=True,
                                kv_out=True, use_kernel=use_kernel)
        x = x + y
        cache["k"][i, :, :s] = k
        cache["v"][i, :, :s] = v
        h = L.apply_norm(cfg, p.norm3, x)
        xk, xv = L.cross_kv(cfg, p.cross, enc_out)
        cache["xk"][i] = xk
        cache["xv"][i] = xv
        x = x + L.cross_attention(cfg, p.cross, h, (xk, xv),
                                  use_kernel=use_kernel)
        h = L.apply_norm(cfg, p.norm2, x)
        x = x + L.mlp(cfg, p.mlp, h)
    h = L.apply_norm(cfg, model.final_norm, x)
    cache["length"].fill_(s)
    return _logits(model, h[:, -1]), cache


def encdec_decode_step(cfg: ArchConfig, model: EncDec, cache: Dict, tokens,
                       use_kernel: bool = True):
    """One decoder token for every sequence, tokens (B,) integer, over the
    self cache and the cross cache.  Updates ``cache`` in place (the new
    K/V at ``length``, then ``length`` advanced by one: the same tensor)
    and returns (logits (B, V) f32, cache).  Reads nothing back to the
    host, so it can be captured as a CUDA graph."""
    length = cache["length"]
    x = model.embed[tokens][:, None]                    # (B, 1, d)
    for i, p in enumerate(model.decoder):
        h = L.apply_norm(cfg, p.norm1, x)
        x = x + L.attention_decode(cfg, p.attn, h, cache["k"][i],
                                   cache["v"][i], length,
                                   use_kernel=use_kernel)
        h = L.apply_norm(cfg, p.norm3, x)
        x = x + L.cross_attention(cfg, p.cross, h,
                                  (cache["xk"][i], cache["xv"][i]),
                                  use_kernel=use_kernel)
        h = L.apply_norm(cfg, p.norm2, x)
        x = x + L.mlp(cfg, p.mlp, h)
    h = L.apply_norm(cfg, model.final_norm, x)[:, 0]
    length.add_(1)
    return _logits(model, h), cache
