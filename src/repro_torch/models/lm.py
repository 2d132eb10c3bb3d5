"""Dense decoder-only language model: parameters, prefill and cached decode.

Port of the dense serving part of ``repro.models.lm``.  The reference keeps
parameters as a pytree with each period position's leaves stacked over
periods and runs ``lax.scan`` over them; here they live in :class:`LM`, an
``nn.Module`` with one :class:`Block` per layer on an explicit device and
dtype, and the scan is a Python loop over layers.  Layer ``i`` is period
``i // len(period)``, position ``i % len(period)``.

The decode cache keeps the reference's structure, ``{"layers": [per period
position: {"k", "v"[, "k_scale", "v_scale"]} with leaves (P, B, S, Hkv, ·)],
"length": (B,) int32}``, and :func:`decode_step` updates it **in place**
(``models.layers.attention_decode``) before returning it with
``length + 1``.

The logits are ``h.f32 @ W.f32^T``, as in the reference.  For a bf16
unembedding ``W`` (the tied embedding of llama3.2-3b: 128,256 x 3,072) the
model keeps one f32 copy (1.58 GB there) instead of converting it at every
step; :meth:`LM.unembed_f32` rebuilds it when ``W`` changes.

Training (``lm_loss``, ``chunked_ce_loss``) waits for its slice; MoE, Mamba
and the other families are refused by :func:`models.build_model`.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch
from torch import nn

from ..configs.base import ArchConfig
from . import layers as L


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; raises for CUDA without a card
    (entry points default to ``"cuda"`` and never move to the CPU on their
    own)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the LM runs on the card by "
                           "default; pass device='cpu' to run on the CPU")
    return dev


def _frozen(params: dict) -> nn.ParameterDict:
    return nn.ParameterDict({k: nn.Parameter(t, requires_grad=False)
                             for k, t in params.items()})


# ------------------------------------------------------------------ structure
def period_structure(cfg: ArchConfig) -> List[Dict[str, str]]:
    """Per position within one period: mixer kind + ffn kind."""
    pat = cfg.layer_period or "A"
    out = []
    for i, kind in enumerate(pat):
        out.append({
            "mixer": "attn" if kind == "A" else "mamba",
            "ffn": "moe" if cfg.moe_layer(i) else "dense",
        })
    return out


def n_periods(cfg: ArchConfig) -> int:
    plen = len(cfg.layer_period or "A")
    if cfg.n_layers % plen:
        raise ValueError(f"{cfg.name}: {cfg.n_layers} layers are not whole "
                         f"periods of {plen}")
    return cfg.n_layers // plen


# ----------------------------------------------------------------- parameters
class Block(nn.Module):
    """One dense layer: pre-norm attention + pre-norm MLP."""

    def __init__(self, cfg: ArchConfig, gen: torch.Generator):
        super().__init__()
        self.norm1 = _frozen(L.init_norm(cfg, cfg.d_model, gen.device))
        self.norm2 = _frozen(L.init_norm(cfg, cfg.d_model, gen.device))
        self.attn = _frozen(L.init_attention(cfg, gen))
        self.mlp = _frozen(L.init_mlp(cfg, gen))


class LM(nn.Module):
    """A dense LM's parameters on one device, initialised from ``seed`` by a
    ``torch.Generator`` on that device.  The same seed gives other numbers
    than the reference's ``jax.random`` init: carry the reference's weights
    across with ``models.convert.params_from_reference``."""

    def __init__(self, cfg: ArchConfig, device="cuda", seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        gen = torch.Generator(device=dev).manual_seed(seed)
        dt = L._dtype(cfg.param_dtype)
        self.layers = nn.ModuleList(Block(cfg, gen)
                                    for _ in range(cfg.n_layers))
        shape = (cfg.vocab_size, cfg.d_model)
        self.embed = nn.Parameter(
            (torch.randn(shape, generator=gen, device=dev) * 0.02).to(dt),
            requires_grad=False)
        self.final_norm = _frozen(L.init_norm(cfg, cfg.d_model, dev))
        self.lm_head: Optional[nn.Parameter] = None
        if not cfg.tie_embeddings:
            self.lm_head = nn.Parameter(
                (torch.randn(shape, generator=gen, device=dev) * 0.02
                 ).to(dt), requires_grad=False)
        self._unembed = None
        self._unembed_key = None

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def unembed_f32(self) -> torch.Tensor:
        """The unembedding matrix (V, d) in f32: itself when it is f32, else
        a copy kept until the matrix's data or version changes."""
        w = unembed_matrix(self.cfg, self)
        if w.dtype == torch.float32:
            return w
        key = (w.data_ptr(), w._version)
        if key != self._unembed_key:
            self._unembed = None                 # free the old copy first
            self._unembed = w.detach().to(torch.float32)
            self._unembed_key = key
        return self._unembed

    def init_cache(self, batch: int, max_len: int) -> Dict:
        return init_cache(self.cfg, batch, max_len, self.device)

    def prefill(self, tokens, max_len: int, use_kernel: bool = True):
        return prefill(self.cfg, self, tokens, max_len, use_kernel)

    def decode_step(self, cache: Dict, tokens, use_kernel: bool = True):
        return decode_step(self.cfg, self, cache, tokens, use_kernel)


def init_lm(cfg: ArchConfig, device="cuda", seed: int = 0) -> LM:
    return LM(cfg, device, seed)


def _layer(model: LM, per: int, pos_i: int, plen: int) -> Block:
    return model.layers[per * plen + pos_i]


# -------------------------------------------------------------------- forward
def _position_block(cfg: ArchConfig, p: Block, x, pos, kv_out: bool = False,
                    use_kernel: bool = True):
    """One layer: pre-norm attention + pre-norm MLP.  Returns (x, extras)."""
    extras = None
    h = L.apply_norm(cfg, p.norm1, x)
    if kv_out:
        y, extras = L.attention(cfg, p.attn, h, pos, kv_out=True,
                                use_kernel=use_kernel)
    else:
        y = L.attention(cfg, p.attn, h, pos, use_kernel=use_kernel)
    x = x + y
    h = L.apply_norm(cfg, p.norm2, x)
    return x + L.mlp(cfg, p.mlp, h), extras


def backbone(cfg: ArchConfig, model: LM, x, pos, collect_cache: bool = False,
             use_kernel: bool = True):
    """x (B, S, d) -> (h (B, S, d), caches | None).

    ``collect_cache``: also return, per period position, the list over
    periods of the layer's (k, v), each (B, S, Hkv, hd), for prefill."""
    struct = period_structure(cfg)
    caches: List[List] = [[] for _ in struct]
    for per in range(n_periods(cfg)):
        for pos_i in range(len(struct)):
            p = _layer(model, per, pos_i, len(struct))
            x, extra = _position_block(cfg, p, x, pos, kv_out=collect_cache,
                                       use_kernel=use_kernel)
            caches[pos_i].append(extra)
    h = L.apply_norm(cfg, model.final_norm, x)
    return h, (caches if collect_cache else None)


def embed_tokens(cfg: ArchConfig, model: LM, tokens):
    return model.embed[tokens]


def unembed_matrix(cfg: ArchConfig, model: LM):
    return model.embed if cfg.tie_embeddings else model.lm_head


def _logits(model: LM, h):
    return h.to(torch.float32) @ model.unembed_f32().T


# --------------------------------------------------------------------- decode
def init_cache(cfg: ArchConfig, batch: int, max_len: int, device) -> Dict:
    """Decode cache: per period position, leaves stacked over periods.  Every
    leaf is its own tensor (the reference may share one immutable array
    between k and v; here they are written in place)."""
    struct = period_structure(cfg)
    np_ = n_periods(cfg)
    cdt = L._dtype(cfg.compute_dtype)
    shape = (np_, batch, max_len, cfg.n_kv_heads, cfg.hd)
    entries = []
    for _ in struct:
        if cfg.kv_dtype == "int8":
            sshape = shape[:-1] + (1,)
            entries.append({
                "k": torch.zeros(shape, dtype=torch.int8, device=device),
                "v": torch.zeros(shape, dtype=torch.int8, device=device),
                "k_scale": torch.ones(sshape, dtype=torch.float32,
                                      device=device),
                "v_scale": torch.ones(sshape, dtype=torch.float32,
                                      device=device)})
        else:
            entries.append({
                "k": torch.zeros(shape, dtype=cdt, device=device),
                "v": torch.zeros(shape, dtype=cdt, device=device)})
    return {"layers": entries,
            "length": torch.zeros((batch,), dtype=torch.int32,
                                  device=device)}


def decode_step(cfg: ArchConfig, model: LM, cache: Dict, tokens,
                use_kernel: bool = True):
    """One token for every sequence.  tokens (B,) integer.

    Updates ``cache`` in place and returns (logits (B, V) f32, cache) with
    ``cache["length"]`` advanced by one.  Every row's length must stay
    below the cache's ``max_len`` for its token to be kept (the reference
    drops it too)."""
    struct = period_structure(cfg)
    length = cache["length"]
    x = model.embed[tokens][:, None]                    # (B, 1, d)
    quant = cfg.kv_dtype == "int8"
    # positions outer, periods inner: the reference's loop order
    for pos_i in range(len(struct)):
        c = cache["layers"][pos_i]
        for per in range(n_periods(cfg)):
            p = _layer(model, per, pos_i, len(struct))
            h = L.apply_norm(cfg, p.norm1, x)
            if quant:
                y = L.attention_decode(cfg, p.attn, h, c["k"][per],
                                       c["v"][per], length,
                                       c["k_scale"][per], c["v_scale"][per],
                                       use_kernel=use_kernel)
            else:
                y = L.attention_decode(cfg, p.attn, h, c["k"][per],
                                       c["v"][per], length,
                                       use_kernel=use_kernel)
            x = x + y
            h = L.apply_norm(cfg, p.norm2, x)
            x = x + L.mlp(cfg, p.mlp, h)
    h = L.apply_norm(cfg, model.final_norm, x)[:, 0]      # (B, d)
    cache["length"] = length + 1
    return _logits(model, h), cache


def prefill(cfg: ArchConfig, model: LM, tokens, max_len: int,
            use_kernel: bool = True):
    """Process a full prompt; return (last_logits (B, V) f32, filled
    cache)."""
    b, s = tokens.shape[:2]
    if s > max_len:
        raise ValueError(f"prompt of {s} tokens does not fit a cache of "
                         f"{max_len}")
    dev = model.device
    pos = torch.arange(s, device=dev)[None].expand(b, s)
    x = embed_tokens(cfg, model, tokens)
    h, extras = backbone(cfg, model, x, pos, collect_cache=True,
                         use_kernel=use_kernel)
    cache = init_cache(cfg, b, max_len, dev)
    for pos_i, c in enumerate(cache["layers"]):
        for per, (k, v) in enumerate(extras[pos_i]):
            if cfg.kv_dtype == "int8":
                k8, ks = L.kv_quantize(k)
                v8, vs = L.kv_quantize(v)
                c["k"][per, :, :s] = k8
                c["v"][per, :, :s] = v8
                c["k_scale"][per, :, :s] = ks
                c["v_scale"][per, :, :s] = vs
            else:
                c["k"][per, :, :s] = k
                c["v"][per, :, :s] = v
    cache["length"].fill_(s)
    return _logits(model, h[:, -1]), cache
