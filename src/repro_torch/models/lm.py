"""Decoder-only and hybrid language models: parameters, prefill and cached
decode.

Port of the serving part of ``repro.models.lm``.  An architecture is a
repeating *period* of layer kinds (jamba's ``MMMMAMMM`` with MoE on odd
positions; ``A`` for the dense and MoE families, ``M`` for falcon-mamba).
The reference keeps parameters as a pytree with each period position's
leaves stacked over periods and runs ``lax.scan`` over them; here they live
in :class:`LM`, an ``nn.Module`` with one :class:`Block` per layer on an
explicit device and dtype, and the scan is a Python loop over layers.
Layer ``i`` is period ``i // len(period)``, position ``i % len(period)``.
Each block holds ``norm1``, ``norm2``, its mixer (``attn`` or ``mamba``)
and its FFN (``mlp`` or ``moe``).

The decode cache keeps the reference's structure, ``{"layers": [per period
position: {"k", "v"[, "k_scale", "v_scale"]} with leaves (P, B, S, Hkv, ·)
for attention, {"conv" (P, B, K-1, Din), "ssm" (P, B, Din, N) f32} for
Mamba], "length": (B,) int32}``, and :func:`decode_step` updates it **in
place**: the K/V (``models.layers.attention_decode``), the Mamba states
and, after the last layer, ``length`` itself (``add_(1)``), so a step
captured once as a CUDA graph (``serve.graphs``) advances the cache at
every replay.  :func:`prefill` fills a new cache or, given ``cache=``, one
the caller owns; :func:`reset_cache` sets a cache back to
:func:`init_cache`'s values in place.

The logits are ``h.f32 @ W.f32^T``, as in the reference.  For a bf16
unembedding ``W`` (the tied embedding of llama3.2-3b: 128,256 x 3,072) the
model keeps one f32 copy (1.58 GB there) instead of converting it at every
step; :meth:`LM.unembed_f32` rebuilds it when ``W`` changes.

Not ported: training (``lm_loss``, ``chunked_ce_loss``, ROADMAP Queue 1
item 9) and the sequence-parallel MoE branch of ``_position_block``, which
needs a model axis above 1 (Queue 1 item 10); enc-dec, embedding inputs and
M-RoPE are refused by :func:`models.build_model`.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

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
    """Tensors as frozen parameters; a nested dict (MoE's ``shared`` MLP)
    becomes a nested ``ParameterDict``."""
    return nn.ParameterDict({
        k: _frozen(t) if isinstance(t, dict) else
        nn.Parameter(t, requires_grad=False) for k, t in params.items()})


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
    """One layer of the position ``spec``: pre-norm mixer (``attn`` or
    ``mamba``) + pre-norm FFN (``mlp`` or ``moe``), as the reference's
    ``init_position``."""

    def __init__(self, cfg: ArchConfig, gen: torch.Generator,
                 spec: Dict[str, str]):
        super().__init__()
        self.spec = dict(spec)
        self.norm1 = _frozen(L.init_norm(cfg, cfg.d_model, gen.device))
        self.norm2 = _frozen(L.init_norm(cfg, cfg.d_model, gen.device))
        if spec["mixer"] == "attn":
            self.attn = _frozen(L.init_attention(cfg, gen))
        else:
            self.mamba = _frozen(L.init_mamba(cfg, gen))
        if spec["ffn"] == "moe":
            self.moe = _frozen(L.init_moe(cfg, gen))
        else:
            self.mlp = _frozen(L.init_mlp(cfg, gen))

    def groups(self) -> Tuple[str, ...]:
        """The parameter groups, in the reference's names."""
        return ("norm1", "norm2",
                "attn" if self.spec["mixer"] == "attn" else "mamba",
                "moe" if self.spec["ffn"] == "moe" else "mlp")


class LM(nn.Module):
    """An LM's parameters on one device, initialised from ``seed`` by a
    ``torch.Generator`` on that device.  The same seed gives other numbers
    than the reference's ``jax.random`` init: carry the reference's weights
    across with ``models.convert.params_from_reference``."""

    def __init__(self, cfg: ArchConfig, device="cuda", seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        gen = torch.Generator(device=dev).manual_seed(seed)
        dt = L._dtype(cfg.param_dtype)
        struct = period_structure(cfg)
        n_periods(cfg)                   # whole periods, or raise
        self.layers = nn.ModuleList(Block(cfg, gen, struct[i % len(struct)])
                                    for i in range(cfg.n_layers))
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

    def prefill(self, tokens, max_len: int, use_kernel: bool = True,
                cache: Optional[Dict] = None):
        return prefill(self.cfg, self, tokens, max_len, use_kernel, cache)

    def decode_step(self, cache: Dict, tokens, use_kernel: bool = True):
        return decode_step(self.cfg, self, cache, tokens, use_kernel)


def init_lm(cfg: ArchConfig, device="cuda", seed: int = 0) -> LM:
    return LM(cfg, device, seed)


def _layer(model: LM, per: int, pos_i: int, plen: int) -> Block:
    return model.layers[per * plen + pos_i]


# -------------------------------------------------------------------- forward
def _ffn(cfg: ArchConfig, p: Block, h):
    """The position's FFN on h (B, S, d); MoE dispatches each row's S tokens
    as one group.  Returns (y, aux loss or None for a dense MLP)."""
    if p.spec["ffn"] == "moe":
        return L.moe(cfg, p.moe, h)
    return L.mlp(cfg, p.mlp, h), None


def _position_block(cfg: ArchConfig, p: Block, x, pos, kv_out: bool = False,
                    use_kernel: bool = True):
    """One layer: pre-norm mixer + pre-norm FFN.  Returns (x, aux, extras):
    aux is the MoE aux loss (None for a dense MLP); extras are the layer's
    (k, v) for attention or (conv_state, ssm_state) for Mamba when
    ``kv_out``, else None.

    The reference's sequence-parallel MoE branch needs a model axis above 1;
    on one card it takes this plain branch."""
    extras = None
    h = L.apply_norm(cfg, p.norm1, x)
    if p.spec["mixer"] == "attn":
        if kv_out:
            y, extras = L.attention(cfg, p.attn, h, pos, kv_out=True,
                                    use_kernel=use_kernel)
        else:
            y = L.attention(cfg, p.attn, h, pos, use_kernel=use_kernel)
    else:
        if kv_out:
            y, extras = L.mamba(cfg, p.mamba, h, return_state=True,
                                use_kernel=use_kernel)
        else:
            y = L.mamba(cfg, p.mamba, h, use_kernel=use_kernel)
    x = x + y
    h = L.apply_norm(cfg, p.norm2, x)
    y, aux = _ffn(cfg, p, h)
    return x + y, aux, extras


def backbone(cfg: ArchConfig, model: LM, x, pos, collect_cache: bool = False,
             use_kernel: bool = True):
    """x (B, S, d) -> (h (B, S, d), aux loss, caches | None).

    ``collect_cache``: also return, per period position, the list over
    periods of the layer's (k, v), each (B, S, Hkv, hd), or (conv_state,
    ssm_state), for prefill."""
    struct = period_structure(cfg)
    caches: List[List] = [[] for _ in struct]
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for per in range(n_periods(cfg)):
        for pos_i in range(len(struct)):
            p = _layer(model, per, pos_i, len(struct))
            x, a, extra = _position_block(cfg, p, x, pos,
                                          kv_out=collect_cache,
                                          use_kernel=use_kernel)
            if a is not None:
                aux = aux + a
            caches[pos_i].append(extra)
    h = L.apply_norm(cfg, model.final_norm, x)
    return h, aux, (caches if collect_cache else None)


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
    entries = []
    for spec in struct:
        # an attention-free model (falcon-mamba-7b) has no heads: only an
        # attention position has a KV shape
        shape = (np_, batch, max_len, cfg.n_kv_heads, cfg.hd) \
            if spec["mixer"] == "attn" else None
        if spec["mixer"] == "mamba":
            s = L._ssm(cfg)
            din = s.expand * cfg.d_model
            entries.append({
                "conv": torch.zeros((np_, batch, s.conv - 1, din), dtype=cdt,
                                    device=device),
                "ssm": torch.zeros((np_, batch, din, s.state),
                                   dtype=torch.float32, device=device)})
        elif cfg.kv_dtype == "int8":
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


def reset_cache(cache: Dict) -> None:
    """Set ``cache`` in place to :func:`init_cache`'s values: zeros, int8
    scales one, length 0."""
    for entry in cache["layers"]:
        for name, leaf in entry.items():
            leaf.fill_(1 if name.endswith("_scale") else 0)
    cache["length"].zero_()


def _check_cache(cfg: ArchConfig, cache: Dict, batch: int,
                 max_len: int) -> None:
    """Raise unless ``cache`` has :func:`init_cache`'s structure, shapes and
    dtypes for ``batch`` rows of ``max_len`` positions."""
    want = init_cache(cfg, batch, max_len, "meta")
    got_layers = cache["layers"]
    ok = len(got_layers) == len(want["layers"]) and all(
        set(g) == set(w) and all(
            g[n].shape == w[n].shape and g[n].dtype == w[n].dtype
            for n in w) for g, w in zip(got_layers, want["layers"]))
    length = cache["length"]
    if not ok or length.shape != (batch,) or length.dtype != torch.int32:
        raise ValueError(f"{cfg.name}: the cache is not one of {batch} rows "
                         f"of {max_len} positions")


def decode_step(cfg: ArchConfig, model: LM, cache: Dict, tokens,
                use_kernel: bool = True):
    """One token for every sequence.  tokens (B,) integer.

    Updates ``cache`` in place, ``cache["length"]`` too (the same tensor,
    advanced by one after the last layer), and returns (logits (B, V) f32,
    cache).  The step reads nothing back to the host and allocates no
    shape that depends on the data, so it can be captured as a CUDA graph
    (``serve.graphs.DecodeGraph``).  Every row's length must stay
    below the cache's ``max_len`` for its token to be kept (the reference
    drops it too).  A MoE layer routes the B tokens as one dispatch group,
    as the reference does, so its capacity couples the rows."""
    struct = period_structure(cfg)
    length = cache["length"]
    x = model.embed[tokens][:, None]                    # (B, 1, d)
    quant = cfg.kv_dtype == "int8"
    # positions outer, periods inner: the reference's loop order
    for pos_i, spec in enumerate(struct):
        c = cache["layers"][pos_i]
        for per in range(n_periods(cfg)):
            p = _layer(model, per, pos_i, len(struct))
            h = L.apply_norm(cfg, p.norm1, x)
            if spec["mixer"] == "mamba":
                y, nconv, nssm = L.mamba_decode(cfg, p.mamba, h,
                                                c["conv"][per],
                                                c["ssm"][per])
                c["conv"][per] = nconv
                c["ssm"][per] = nssm
            elif quant:
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
            if spec["ffn"] == "moe":
                y2, _ = L.moe(cfg, p.moe, h.transpose(0, 1))  # (1, B, d)
                x = x + y2.transpose(0, 1)
            else:
                x = x + L.mlp(cfg, p.mlp, h)
    h = L.apply_norm(cfg, model.final_norm, x)[:, 0]      # (B, d)
    length.add_(1)
    return _logits(model, h), cache


def prefill(cfg: ArchConfig, model: LM, tokens, max_len: int,
            use_kernel: bool = True, cache: Optional[Dict] = None):
    """Process a full prompt; return (last_logits (B, V) f32, filled
    cache).

    Given ``cache`` (B rows of ``max_len`` positions, as :func:`init_cache`
    makes them), the prompt's state is written into it, in place, instead
    of into a new cache: its first S positions, the Mamba states and the
    length.  The rest is left as it was, so a caller that reuses a cache
    resets it first (:func:`reset_cache`)."""
    b, s = tokens.shape[:2]
    if s > max_len:
        raise ValueError(f"prompt of {s} tokens does not fit a cache of "
                         f"{max_len}")
    dev = model.device
    if cache is None:
        cache = init_cache(cfg, b, max_len, dev)
    else:
        _check_cache(cfg, cache, b, max_len)
    pos = torch.arange(s, device=dev)[None].expand(b, s)
    x = embed_tokens(cfg, model, tokens)
    h, _, extras = backbone(cfg, model, x, pos, collect_cache=True,
                            use_kernel=use_kernel)
    for pos_i, c in enumerate(cache["layers"]):
        for per, ex in enumerate(extras[pos_i]):
            if "conv" in c:
                c["conv"][per] = ex[0]
                c["ssm"][per] = ex[1]
            elif cfg.kv_dtype == "int8":
                k8, ks = L.kv_quantize(ex[0])
                v8, vs = L.kv_quantize(ex[1])
                c["k"][per, :, :s] = k8
                c["v"][per, :, :s] = v8
                c["k_scale"][per, :, :s] = ks
                c["v_scale"][per, :, :s] = vs
            else:
                c["k"][per, :, :s] = ex[0]
                c["v"][per, :, :s] = ex[1]
    cache["length"].fill_(s)
    return _logits(model, h[:, -1]), cache
