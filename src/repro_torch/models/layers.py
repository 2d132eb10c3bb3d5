"""Model building blocks for dense decoders, in PyTorch: norms, RoPE, GQA
attention through the port's flash kernels, cached decode over a float or
int8 KV cache, and SwiGLU/GeGLU MLPs.

Port of the dense part of ``repro.models.layers``.  Functions keep the
reference's names and ``(cfg, p, x, ...) -> y`` form, with ``p`` a mapping
of tensors (an ``nn.ParameterDict`` of :class:`models.lm.LM`).  They round
to the compute dtype where the reference does: norms and RoPE compute in f32
and cast back, attention keeps f32 scores, softmax and accumulator and casts
its output to the input's dtype.

Not ported, because on one card the reference's model-axis size is 1 and
they never act: the sharding constraints (``_constrain``, ``_rope_hd_pin``,
``_attn_constraints``, ``constrain_residual``) and
``_seq_parallel_attention``; ``_chunked_attention`` only bounds memory, and
the kernel computes the whole causal attention in one call.  M-RoPE,
cross-attention, MoE and Mamba wait for their slices (ROADMAP).

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

from ..configs.base import ArchConfig
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


def positional_rotate(cfg: ArchConfig, x, pos):
    """RoPE.  pos: (B, S).  M-RoPE (``cfg.mrope_sections``) is not ported."""
    if cfg.mrope_sections is not None:
        raise NotImplementedError("M-RoPE is not ported yet (ROADMAP Queue 1 "
                                  "item 8)")
    return apply_rope(x, pos, cfg.rope_theta)


# ----------------------------------------------------------------- attention
def init_attention(cfg: ArchConfig, gen: torch.Generator) -> dict:
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
    if cfg.qkv_bias:
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
