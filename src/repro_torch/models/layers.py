"""Model building blocks, in PyTorch: norms, RoPE and M-RoPE, GQA
attention through the port's flash kernels, cached decode over a float or
int8 KV cache, cross-attention over an encoder's K/V, SwiGLU/GeGLU MLPs,
capacity-based top-k MoE, and the Mamba-1 block with its selective scan
through the port's scan kernel.

Port of ``repro.models.layers``.  Functions keep the
reference's names and ``(cfg, p, x, ...) -> y`` form, with ``p`` a mapping
of tensors (an ``nn.ParameterDict`` of :class:`models.lm.LM`).  They round
to the compute dtype where the reference does: norms and RoPE compute in f32
and cast back, attention keeps f32 scores, softmax and accumulator and casts
its output to the input's dtype.

Not ported, because on one card the reference's model-axis size is 1 and
they never act: the sharding constraints (``_constrain``, ``_rope_hd_pin``,
``_attn_constraints``, ``constrain_residual``) and
``_seq_parallel_attention``, ``_constrain_moe_groups`` (it pins the MoE
dispatch groups' sharding only); ``_chunked_attention`` only bounds memory,
and the kernel computes the whole causal attention in one call.

**The decode cache is updated in place.**  ``attention_decode`` writes the
new K/V (or int8 codes and scales) at position ``length`` of the cache
tensors it is given, where the reference blends a one-hot over the whole
cache and returns new arrays.  The two agree bit for bit: the blend computes
``c * 1 + 0 * k`` and ``c * 0 + 1 * k``, both exact.
"""

from __future__ import annotations

import math
from typing import Mapping, Optional

import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig, SSMSpec
from ..kernels import ops

Params = Mapping[str, torch.Tensor]


# ------------------------------------------------------------------- helpers
def _dtype(name: str) -> torch.dtype:
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


def dense_init(gen: torch.Generator, shape, in_axis: int = 0,
               dtype=torch.float32) -> torch.Tensor:
    fan_in = shape[in_axis]
    return (torch.randn(shape, generator=gen, device=gen.device)
            / math.sqrt(fan_in)).to(dtype)


# --------------------------------------------------------------------- norms
def rmsnorm(x, scale, eps: float = 1e-6):
    x32 = x.to(torch.float32)
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * scale.to(torch.float32)
            ).to(x.dtype)


def layernorm(x, scale, bias, eps: float = 1e-5):
    x32 = x.to(torch.float32)
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.var(x32, dim=-1, keepdim=True, correction=0)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * scale.to(torch.float32) + bias.to(torch.float32)
            ).to(x.dtype)


def apply_norm(cfg: ArchConfig, p: Params, x):
    if cfg.norm == "layernorm":
        return layernorm(x, p["scale"], p["bias"])
    return rmsnorm(x, p["scale"])


def init_norm(cfg: ArchConfig, d: int, device) -> dict:
    dt = _dtype(cfg.param_dtype)
    p = {"scale": torch.ones((d,), dtype=dt, device=device)}
    if cfg.norm == "layernorm":
        p["bias"] = torch.zeros((d,), dtype=dt, device=device)
    return p


# ---------------------------------------------------------------------- RoPE
def rope_freqs(hd: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                         device=device) / hd))


def apply_rope(x, pos, theta: float):
    """x (..., S, H, D) rotated by position ``pos`` (..., S)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                 # (D/2,)
    ang = pos[..., None].to(torch.float32) * freqs          # (..., S, D/2)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def _mrope_bands(sections, n: int):
    """How many of the ``n`` frequency bands each position stream drives,
    in order, as the reference's ``jnp.repeat(arange(3), sections,
    total_repeat_length=n)`` gives them: stream i starts at the sum of the
    sections before it (cut at ``n``) and runs to the next stream's start,
    the last one to ``n``."""
    starts = [0]
    for c in sections[:-1]:
        starts.append(starts[-1] + int(c))
    ends = [min(s, n) for s in starts[1:]] + [n]
    return [e - min(s, n) for s, e in zip(starts, ends)]


def apply_mrope(x, pos3, theta: float, sections):
    """Qwen2-VL M-RoPE: the rotary frequency bands split across the (t, h,
    w) position streams.  ``pos3`` is (3, ..., S); ``sections`` gives each
    stream's number of bands (:func:`_mrope_bands`).  The bands' positions
    are put together by slices, with no index tensor, so the step copies
    nothing from the host and can be captured."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                 # (D/2,)
    pos3 = pos3.to(torch.float32)
    pos = torch.cat([pos3[i][..., None].expand(*pos3.shape[1:], c)
                     for i, c in enumerate(_mrope_bands(sections, hd // 2))
                     if c], dim=-1)                         # (..., S, D/2)
    ang = pos * freqs
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def positional_rotate(cfg: ArchConfig, x, pos):
    """RoPE, or M-RoPE where ``cfg.mrope_sections`` is set.  pos: (B, S),
    or (3, B, S) for M-RoPE; a (B, S) position drives all three streams
    (text only: t = h = w)."""
    if cfg.mrope_sections is not None:
        if pos.dim() == 2:
            pos = pos[None].expand((3,) + tuple(pos.shape))
        return apply_mrope(x, pos, cfg.rope_theta, cfg.mrope_sections)
    return apply_rope(x, pos, cfg.rope_theta)


# ----------------------------------------------------------------- attention
def init_attention(cfg: ArchConfig, gen: torch.Generator,
                   cross: bool = False) -> dict:
    d, hd = cfg.d_model, cfg.hd
    hq, hkv = cfg.n_heads, cfg.n_kv_heads
    dt = _dtype(cfg.param_dtype)
    dev = gen.device
    p = {
        "wq": dense_init(gen, (d, hq * hd), 0, dt),
        "wk": dense_init(gen, (d, hkv * hd), 0, dt),
        "wv": dense_init(gen, (d, hkv * hd), 0, dt),
        "wo": dense_init(gen, (hq * hd, d), 0, dt),
    }
    if cfg.qkv_bias and not cross:                      # as the reference
        p["bq"] = torch.zeros((hq * hd,), dtype=dt, device=dev)
        p["bk"] = torch.zeros((hkv * hd,), dtype=dt, device=dev)
        p["bv"] = torch.zeros((hkv * hd,), dtype=dt, device=dev)
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((hd,), dtype=dt, device=dev)
        p["k_norm"] = torch.ones((hd,), dtype=dt, device=dev)
    return p


def _project_qkv(cfg: ArchConfig, p: Params, xq, xkv):
    b, sq, _ = xq.shape
    skv = xkv.shape[1]
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = xq @ p["wq"]
    k = xkv @ p["wk"]
    v = xkv @ p["wv"]
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(b, sq, hq, hd)
    k = k.reshape(b, skv, hkv, hd)
    v = v.reshape(b, skv, hkv, hd)
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"])
        k = rmsnorm(k, p["k_norm"])
    return q, k, v


def attention(cfg: ArchConfig, p: Params, x, pos, causal: bool = True,
              kv_out: bool = False, use_kernel: bool = True):
    """Causal GQA self-attention over the whole sequence, one
    ``ops.attention`` call (the flash kernel on the card).

    The causal mask is that of query i over keys 0..i: ``pos`` is the
    prefill's ``arange(S)`` for every row, as in the reference's callers.
    """
    b, s, _ = x.shape
    q, k, v = _project_qkv(cfg, p, x, x)
    q = positional_rotate(cfg, q, pos)
    k = positional_rotate(cfg, k, pos)
    # (B, S, H, D) tensors seen as (B, H, S, D): the kernel reads strides
    o = ops.attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                      causal=causal, use_kernel=use_kernel)
    y = o.transpose(1, 2).reshape(b, s, cfg.n_heads * cfg.hd) @ p["wo"]
    if kv_out:
        return y, (k, v)
    return y


def cross_kv(cfg: ArchConfig, p: Params, enc_out):
    """The encoder's K/V of a cross-attention block: enc_out (B, S_enc, d)
    -> (k, v), each (B, S_enc, Hkv, D), no RoPE."""
    b, se, _ = enc_out.shape
    hkv, hd = cfg.n_kv_heads, cfg.hd
    k = (enc_out @ p["wk"]).reshape(b, se, hkv, hd)
    v = (enc_out @ p["wv"]).reshape(b, se, hkv, hd)
    if cfg.qk_norm:
        k = rmsnorm(k, p["k_norm"])
    return k, v


def cross_attention(cfg: ArchConfig, p: Params, x, kv,
                    use_kernel: bool = True):
    """Decoder cross-attention over the encoder's K/V ``kv`` (each (B,
    S_enc, Hkv, D)), every position seen, no RoPE, scale 1/sqrt(D).  x (B,
    Sq, d) -> (B, Sq, d).  Sq > 1 (prefill) is one non-causal
    ``ops.attention`` call (flash attention with Sk = S_enc); Sq = 1 (a
    decode step) is one ``ops.decode_attention`` call with every row's
    length S_enc (the split-KV decode)."""
    b, s, _ = x.shape
    hq, hd = cfg.n_heads, cfg.hd
    q = (x @ p["wq"]).reshape(b, s, hq, hd)
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"])
    k, v = kv
    if s == 1:
        # the lengths made on the device (a fill), not copied from the host
        length = torch.full((b,), k.shape[1], dtype=torch.int32,
                            device=x.device)
        o = ops.decode_attention(q.reshape(b, hq, hd), k.transpose(1, 2),
                                 v.transpose(1, 2), length,
                                 use_kernel=use_kernel)
    else:
        o = ops.attention(q.transpose(1, 2), k.transpose(1, 2),
                          v.transpose(1, 2), causal=False,
                          use_kernel=use_kernel).transpose(1, 2)
    return o.reshape(b, s, hq * hd).to(x.dtype) @ p["wo"]


# ------------------------------------------------------ int8 KV quantization
def kv_quantize(x):
    """(..., Hkv, D) -> (int8 same shape, f32 scale (..., Hkv, 1)).

    Symmetric per-(position, head) scaling, as the reference's."""
    x32 = x.to(torch.float32)
    absmax = torch.amax(torch.abs(x32), dim=-1, keepdim=True)
    scale = torch.where(absmax > 0, absmax / 127.0,
                        torch.ones_like(absmax))
    q = torch.clamp(torch.round(x32 / scale), -127, 127)
    return q.to(torch.int8), scale


def kv_dequantize(q, scale, dtype):
    return (q.to(torch.float32) * scale).to(dtype)


def _write_at(cache, new, length):
    """``cache[b, length[b]] = new[b]`` in place, for each row b whose
    ``length[b]`` is inside the cache; a row at or past the end keeps its
    cache, as the reference's one-hot blend drops such a write."""
    b, s = cache.shape[:2]
    rows = torch.arange(b, device=cache.device)
    at = length.clamp(0, s - 1).to(torch.int64)
    inside = (length < s).reshape(b, *([1] * (new.dim() - 1)))
    cache[rows, at] = torch.where(inside, new.to(cache.dtype),
                                  cache[rows, at])


def attention_decode(cfg: ArchConfig, p: Params, x, cache_k, cache_v,
                     length, k_scale=None, v_scale=None,
                     use_kernel: bool = True):
    """One-token decode: x (B, 1, d); cache (B, S, Hkv, D); length (B,).

    Writes the new K/V at ``length`` **in place** (the int8 codes and
    scales when ``cfg.kv_dtype == "int8"``) and attends over positions
    ``< length + 1``.  Returns y (B, 1, d).
    """
    b = x.shape[0]
    hq, hd = cfg.n_heads, cfg.hd
    q, k, v = _project_qkv(cfg, p, x, x)                # (B,1,H,D)
    pos = length[:, None]                               # (B,1)
    q = positional_rotate(cfg, q, pos)
    k = positional_rotate(cfg, k, pos)
    kl = length + 1
    qh = q.reshape(b, hq, hd)
    if cfg.kv_dtype == "int8":
        k8, ks = kv_quantize(k)
        v8, vs = kv_quantize(v)
        _write_at(cache_k, k8[:, 0], length)
        _write_at(cache_v, v8[:, 0], length)
        _write_at(k_scale, ks[:, 0], length)
        _write_at(v_scale, vs[:, 0], length)
        o = ops.decode_attention_int8(
            qh, cache_k.transpose(1, 2), k_scale.transpose(1, 2),
            cache_v.transpose(1, 2), v_scale.transpose(1, 2), kl,
            use_kernel=use_kernel)
    else:
        _write_at(cache_k, k[:, 0], length)
        _write_at(cache_v, v[:, 0], length)
        o = ops.decode_attention(qh, cache_k.transpose(1, 2),
                                 cache_v.transpose(1, 2), kl,
                                 use_kernel=use_kernel)
    return o.reshape(b, 1, hq * hd).to(x.dtype) @ p["wo"]


# ---------------------------------------------------------------------- MLPs
def init_mlp(cfg: ArchConfig, gen: torch.Generator,
             d_ff: Optional[int] = None) -> dict:
    d, ff = cfg.d_model, d_ff or cfg.d_ff
    dt = _dtype(cfg.param_dtype)
    return {"gate": dense_init(gen, (d, ff), 0, dt),
            "up": dense_init(gen, (d, ff), 0, dt),
            "down": dense_init(gen, (ff, d), 0, dt)}


def _act(name: str):
    # jax.nn.gelu's default is the tanh approximation
    if name == "gelu":
        return lambda t: F.gelu(t, approximate="tanh")
    return F.silu


def mlp(cfg: ArchConfig, p: Params, x):
    """SwiGLU (silu) or GeGLU (gelu) gated MLP."""
    a = _act(cfg.mlp_act)
    return (a(x @ p["gate"]) * (x @ p["up"])) @ p["down"]


# ----------------------------------------------------------------------- MoE
def init_moe(cfg: ArchConfig, gen: torch.Generator) -> dict:
    m = cfg.moe
    d, dt = cfg.d_model, _dtype(cfg.param_dtype)
    p = {
        "router": dense_init(gen, (d, m.n_experts), 0, torch.float32),
        "w_gate": dense_init(gen, (m.n_experts, d, m.d_ff), 1, dt),
        "w_up": dense_init(gen, (m.n_experts, d, m.d_ff), 1, dt),
        "w_down": dense_init(gen, (m.n_experts, m.d_ff, d), 1, dt),
    }
    if m.n_shared:
        p["shared"] = init_mlp(cfg, gen, m.shared_d_ff)
        p["shared_gate"] = dense_init(gen, (d, 1), 0, torch.float32)
    return p


def moe_capacity(cfg: ArchConfig, t: int) -> int:
    """Tokens each expert takes per dispatch group of ``t`` tokens."""
    m = cfg.moe
    k = m.top_k
    return max(1, min(t * k, int(math.ceil(t * k / m.n_experts
                                           * m.capacity_factor))))


def moe(cfg: ArchConfig, p: Params, x, *, capacity: Optional[int] = None):
    """Capacity-based top-k MoE with scatter dispatch / gather combine.

    ``x`` is (G, T, d): G dispatch groups (capacity is budgeted per group),
    T tokens per group.  Returns (y (G, T, d), the load-balancing aux loss).
    Each (token, k) slot keeps its place in its expert's queue up to the
    capacity; the rest go to a sentinel row and add nothing.  The dispatch
    scatter (``index_add_``) adds one non-zero row to each buffer row it
    fills, so its result does not depend on the order of the adds.  Ties
    among the router's probabilities may be broken otherwise than by
    ``jax.lax.top_k``; with float logits they do not occur.

    Differentiable, and bit-stable from run to run on the card: the k
    copies of a token are an expanded copy, whose backward sums the k
    copies by a reduction (no atomics);
    the dispatch's backward gathers (``index_select``); the combine's
    backward (``index_put_`` with accumulate) adds one row into each filled
    slot, and into the sentinel only rows the mask has zeroed.  The aux
    loss's gradient flows through ``probs``, not the one-hot, as in the
    reference.
    """
    m = cfg.moe
    g_, t, d = x.shape
    e, k = m.n_experts, m.top_k
    c = moe_capacity(cfg, t) if capacity is None else capacity

    logits = x.to(torch.float32) @ p["router"]          # (G, T, E)
    probs = torch.softmax(logits, dim=-1)
    w, idx = torch.topk(probs, k, dim=-1)               # (G, T, K)
    w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)

    # position of each (token, k) slot within its expert queue, per group
    onehot = F.one_hot(idx, e)                          # (G, T, K, E) int64
    oh_flat = onehot.reshape(g_, t * k, e)
    pos = torch.cumsum(oh_flat, dim=1) - oh_flat        # (G, T*K, E)
    pos_tk = torch.sum(pos * oh_flat, dim=-1)           # (G, T*K)
    e_tk = idx.reshape(g_, t * k)
    keep = pos_tk < c
    slot = torch.where(keep, e_tk * c + pos_tk,
                       torch.full_like(e_tk, e * c))    # sentinel row

    # each token's k copies, (G, T*K, d): an expanded copy, whose backward
    # sums the k copies by a reduction, no atomics (repeat_interleave's
    # would index_add_ them with float atomics on the card, in an order
    # that changes run to run)
    x_rep = x[:, :, None].expand(g_, t, k, d).reshape(g_, t * k, d)
    rows = e * c + 1
    base = torch.arange(g_, device=x.device)[:, None] * rows
    buf = torch.zeros((g_ * rows, d), dtype=x.dtype, device=x.device)
    buf.index_add_(0, (slot + base).reshape(-1),
                   (x_rep * keep[..., None].to(x.dtype)).reshape(-1, d))
    xe = buf.reshape(g_, rows, d)[:, :e * c].reshape(g_, e, c, d)

    a = _act(cfg.mlp_act)
    h = a(torch.einsum("gecd,edf->gecf", xe, p["w_gate"])) * \
        torch.einsum("gecd,edf->gecf", xe, p["w_up"])
    ye = torch.einsum("gecf,efd->gecd", h, p["w_down"])  # (G, E, C, d)

    flat = torch.cat([ye.reshape(g_, e * c, d),
                      torch.zeros((g_, 1, d), dtype=ye.dtype,
                                  device=ye.device)], dim=1)
    y_tk = flat[torch.arange(g_, device=x.device)[:, None], slot]
    y_tk = y_tk * (w.reshape(g_, t * k, 1) * keep[..., None]).to(y_tk.dtype)
    y = y_tk.reshape(g_, t, k, d).sum(dim=2)

    if m.n_shared:
        gate = torch.sigmoid(x.to(torch.float32) @ p["shared_gate"])
        y = y + (mlp(cfg, p["shared"], x) * gate.to(x.dtype))

    # load-balancing auxiliary loss (Switch-style)
    me = probs.mean(dim=(0, 1))                         # (E,)
    ce = onehot.to(torch.float32).mean(dim=(0, 1, 2)) * e
    aux = torch.sum(me * ce)
    return y, aux


# ------------------------------------------------------------------- Mamba-1
def _ssm(cfg: ArchConfig) -> SSMSpec:
    return cfg.ssm or SSMSpec()


def init_mamba(cfg: ArchConfig, gen: torch.Generator) -> dict:
    s = _ssm(cfg)
    d = cfg.d_model
    din = s.expand * d
    dtr = s.dt_rank or -(-d // 16)
    dt = _dtype(cfg.param_dtype)
    dev = gen.device
    a = torch.arange(1, s.state + 1, dtype=torch.float32,
                     device=dev).repeat(din, 1)
    dt_b = torch.log(torch.expm1(torch.full((din,), 0.01,
                                            dtype=torch.float32,
                                            device=dev)))
    return {
        "in_proj": dense_init(gen, (d, 2 * din), 0, dt),
        "conv_w": (torch.randn((din, s.conv), generator=gen, device=dev)
                   / math.sqrt(s.conv)).to(dt),
        "conv_b": torch.zeros((din,), dtype=dt, device=dev),
        "x_proj": dense_init(gen, (din, dtr + 2 * s.state), 0, dt),
        "dt_w": dense_init(gen, (dtr, din), 0, dt),
        "dt_b": dt_b,
        "A_log": torch.log(a),
        "D": torch.ones((din,), dtype=torch.float32, device=dev),
        "out_proj": dense_init(gen, (din, d), 0, dt),
    }


def _ssm_scan_chunked(u, dt, a, bm, cm, chunk: int):
    """h_t = exp(dt_t A) h_{t-1} + (dt_t u_t) B_t ;  y_t = (h_t C_t).sum(N).

    The plain scan of the model (``use_kernel=False``): within chunks of
    ``chunk`` steps an inclusive scan of the reference's ``combine`` in
    log2(chunk) doubling steps, chunks one after another, so the
    (B, chunk, D, N) intermediates stay bounded.  As in the reference, an L
    that ``chunk`` does not divide is one chunk.  Returns (y (B, L, D) f32,
    hT (B, D, N) f32).
    """
    b, l, d = u.shape
    n = a.shape[1]
    chunk = min(chunk, l)
    if l % chunk:
        chunk = l
    a = a.to(torch.float32)
    h = torch.zeros((b, d, n), dtype=torch.float32, device=u.device)
    ys = []
    for i in range(0, l, chunk):
        u_, dt_, b_, c_ = (t[:, i:i + chunk].to(torch.float32)
                           for t in (u, dt, bm, cm))
        acum = torch.exp(dt_[..., None] * a[None, None])      # (B, C, D, N)
        bcum = (dt_ * u_)[..., None] * b_[:, :, None, :]      # (B, C, D, N)
        off = 1
        while off < acum.shape[1]:
            # combine((a1, b1), (a2, b2)) = (a1 a2, b1 a2 + b2), earlier first
            a1, b1 = acum[:, :-off], bcum[:, :-off]
            a2, b2 = acum[:, off:], bcum[:, off:]
            acum = torch.cat([acum[:, :off], a1 * a2], dim=1)
            bcum = torch.cat([bcum[:, :off], b1 * a2 + b2], dim=1)
            del a1, b1, a2, b2
            off *= 2
        hs = acum * h[:, None] + bcum                       # (B, C, D, N)
        del acum, bcum
        ys.append(torch.einsum("bcdn,bcn->bcd", hs, c_))
        h = hs[:, -1].clone()
        del hs
    return torch.cat(ys, dim=1), h


def _causal_conv1d(x, w, b):
    """Depthwise causal conv: x (B, L, D), w (D, K) -> (B, L, D), the
    reference's sum of K shifted products (no cuDNN, which would run f32 in
    TF32)."""
    k = w.shape[1]
    xp = F.pad(x, (0, 0, k - 1, 0))
    y = xp[:, 0:x.shape[1], :] * w[:, 0][None, None, :]
    for i in range(1, k):
        y = y + xp[:, i:i + x.shape[1], :] * w[:, i][None, None, :]
    return y + b[None, None, :]


def _mamba_proj(cfg: ArchConfig, p: Params, xa, dtype):
    """xa -> (dt, B, C, A) as the reference derives them."""
    s = _ssm(cfg)
    dtr = p["dt_w"].shape[0]
    proj = xa @ p["x_proj"]                             # (..., dtr + 2N)
    dt_raw = proj[..., :dtr]
    bm = proj[..., dtr:dtr + s.state]
    cm = proj[..., dtr + s.state:]
    dt = F.softplus(dt_raw @ p["dt_w"] + p["dt_b"].to(dtype))
    a = -torch.exp(p["A_log"])                          # (Din, N)
    return dt, bm, cm, a


def mamba(cfg: ArchConfig, p: Params, x, return_state: bool = False,
          use_kernel: bool = True):
    """Mamba-1 block.  x (B, S, d) -> (B, S, d).

    ``use_kernel`` runs the scan through ``ops.mamba_scan`` (the scan kernel
    on the card; where autograd records it, ``SelectiveScan`` with its
    backward kernels), else through the plain chunked scan (under autograd
    in training).  With
    ``return_state`` also returns (conv_state (B, K-1, Din), ssm_state
    (B, Din, N) f32) for decode handoff.  The conv state is the last K-1
    inputs of the conv, zeros before the first token (where the reference
    slices fewer than K-1 rows for a prompt shorter than K-1, which its
    decode cannot take).
    """
    s = _ssm(cfg)
    xz = x @ p["in_proj"]
    xin, z = torch.chunk(xz, 2, dim=-1)                 # (B, S, Din)
    xc = _causal_conv1d(xin, p["conv_w"], p["conv_b"])
    xa = F.silu(xc)
    dt, bm, cm, a = _mamba_proj(cfg, p, xa, x.dtype)
    if use_kernel:
        out = ops.mamba_scan(xa, dt, a, bm, cm, p["D"],
                             return_state=return_state)
        y, hT = out if return_state else (out, None)
    else:
        y, hT = _ssm_scan_chunked(xa, dt, a, bm, cm, cfg.ssm_chunk)
        y = y + p["D"][None, None] * xa.to(torch.float32)
    y = y.to(x.dtype) * F.silu(z)
    out = y @ p["out_proj"]
    if return_state:
        k1 = s.conv - 1
        conv_state = F.pad(xin, (0, 0, k1, 0))[:, xin.shape[1]:]
        return out, (conv_state, hT)
    return out


def mamba_decode(cfg: ArchConfig, p: Params, x, conv_state, ssm_state):
    """One-token decode.  x (B, 1, d); conv_state (B, K-1, Din);
    ssm_state (B, Din, N) f32.  Returns (y (B, 1, d), new conv state, new
    ssm state), as the reference; plain torch (no kernel here, as in the
    reference)."""
    s = _ssm(cfg)
    xz = x[:, 0] @ p["in_proj"]
    xin, z = torch.chunk(xz, 2, dim=-1)                 # (B, Din)
    window = torch.cat([conv_state, xin[:, None]], dim=1)   # (B, K, Din)
    xc = torch.einsum("bkd,dk->bd", window, p["conv_w"]) + p["conv_b"]
    xa = F.silu(xc)
    dt, bm, cm, a = _mamba_proj(cfg, p, xa, x.dtype)
    da = torch.exp(dt[..., None].to(torch.float32) * a[None])  # (B, Din, N)
    db = (dt * xa)[..., None].to(torch.float32) * \
        bm[:, None, :].to(torch.float32)
    h = ssm_state * da + db
    y = torch.sum(h * cm[:, None, :].to(torch.float32), dim=-1)
    y = y + p["D"][None] * xa.to(torch.float32)
    y = y.to(x.dtype) * F.silu(z)
    out = (y @ p["out_proj"])[:, None]
    new_conv = window[:, 1:] if s.conv > 1 else conv_state
    return out, new_conv, h
