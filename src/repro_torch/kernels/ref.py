"""Plain PyTorch oracles for the port's kernels.

Port of ``repro.kernels.ref``: the same functions, with torch tensors on
any device.  The
quantizers give int8 codes and f32 scales identical to the JAX oracles and
to the numpy twins in ``core.compute_plane`` (same f32 division,
round-half-to-even, clip).  The attention oracles take the reference's
layouts, (B, H, S, D), and compute in f32 with a full softmax; on CUDA
tensors the caller keeps ``torch.backends.cuda.matmul.allow_tf32`` False, or
the products run in TF32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def quantize_crossbar(w: torch.Tensor, bits: int = 8):
    """Symmetric per-row quantization: the 'analog programming' model."""
    w = w.to(torch.float32)
    qmax = 2.0 ** (bits - 1) - 1
    scale = w.abs().amax(dim=1).clamp_min(1e-12) / qmax
    wq = torch.clamp(torch.round(w / scale[:, None]), -qmax, qmax)
    return wq.to(torch.int8), scale


def quantize_vec(x: torch.Tensor, bits: int = 8):
    """Per-row symmetric activation quantization (the DAC model)."""
    x = x.to(torch.float32)
    qmax = 2.0 ** (bits - 1) - 1
    scale = x.abs().amax(dim=-1).clamp_min(1e-12) / qmax
    xq = torch.clamp(torch.round(x / scale[..., None]), -qmax, qmax)
    return xq.to(torch.int8), scale


def crossbar_mxv_ref(x: torch.Tensor, wq: torch.Tensor,
                     scale: torch.Tensor) -> torch.Tensor:
    """``(x @ wq^T) * scale`` in f32.  On a CUDA tensor the caller keeps
    ``torch.backends.cuda.matmul.allow_tf32`` False, or the product runs in
    TF32 (about three decimal digits)."""
    return (x.to(torch.float32) @ wq.to(torch.float32).T) * scale[None, :]


def crossbar_mxv_int8_ref(xq: torch.Tensor, xs: torch.Tensor,
                          wq: torch.Tensor, ws: torch.Tensor) -> torch.Tensor:
    """``(acc * xs[:, None]) * ws[None, :]`` with ``acc = xq @ wq^T``.

    The integer product is taken in float64, which is exact here (|acc| <=
    127^2 * N, far below 2^53) and, unlike an int32 matmul, runs on CUDA
    tensors too."""
    acc = xq.to(torch.float64) @ wq.to(torch.float64).T
    return acc.to(torch.float32) * xs[:, None] * ws[None, :]


def crossbar_conv2d_ref(x: torch.Tensor, wq: torch.Tensor,
                        scale: torch.Tensor, stride: int = 1, pad: int = 0,
                        fh: int = 3, fw: int = 3) -> torch.Tensor:
    """Paper Listing 1 in torch: conv as per-pixel MxV.  x (C, H, W); wq
    (FL, C*FH*FW) int8 or f32, k over (c, fh, fw); scale (FL,) -> (FL, OH,
    OW) f32, zero padding.  The crossbar is dequantized first and the
    im2col patches (OH*OW, K) multiply its transpose; on a CUDA tensor the
    caller keeps ``torch.backends.cuda.matmul.allow_tf32`` False."""
    _, h, w = x.shape
    fl = wq.shape[0]
    oh = (h + 2 * pad - fh) // stride + 1
    ow = (w + 2 * pad - fw) // stride + 1
    m = wq.to(torch.float32) * scale[:, None]
    pat = F.unfold(x.to(torch.float32)[None], (fh, fw), padding=pad,
                   stride=stride)[0]                       # (K, OH*OW)
    return (pat.T @ m.T).T.reshape(fl, oh, ow)


# ----------------------------------------------------------------- attention
NEG_INF = -1e30


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True) -> torch.Tensor:
    """q (B,Hq,Sq,D); k/v (B,Hkv,Sk,D) — full-softmax GQA oracle.  Query i
    sits at absolute position ``i + Sk - Sq``; output in q's dtype."""
    d = q.shape[-1]
    sq, sk = q.shape[2], k.shape[2]
    g = q.shape[1] // k.shape[1]
    k = k.repeat_interleave(g, dim=1)
    v = v.repeat_interleave(g, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.to(torch.float32),
                     k.to(torch.float32)) / (d ** 0.5)
    if causal:
        mask = torch.ones((sq, sk), dtype=torch.bool,
                          device=q.device).tril(diagonal=sk - sq)
        s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p,
                        v.to(torch.float32)).to(q.dtype)


def _work_dtype(dtype: torch.dtype) -> torch.dtype:
    """What the backward's plain versions compute in: f32, or f64 for f64
    inputs (``gradcheck``)."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def _scores(q, k, causal):
    """The scaled, masked scores (B, Hq, Sq, Sk) of ``attention_ref``, in
    f32 (f64 for f64 inputs), K repeated over the G query heads of each KV
    head."""
    d = q.shape[-1]
    sq, sk = q.shape[2], k.shape[2]
    wt = _work_dtype(q.dtype)
    k = k.repeat_interleave(q.shape[1] // k.shape[1], dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.to(wt), k.to(wt)) / (d ** 0.5)
    if causal:
        mask = torch.ones((sq, sk), dtype=torch.bool,
                          device=q.device).tril(diagonal=sk - sq)
        s = torch.where(mask, s, NEG_INF)
    return s


def attention_lse_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      causal: bool = True):
    """``attention_ref`` and the f32 (B, Hq, Sq) natural-log log-sum-exp of
    its scaled, masked scores: what the flash kernels' forward stores for
    the backward.  f64 inputs are computed, and give lse, in f64."""
    s = _scores(q, k, causal)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    v = v.repeat_interleave(q.shape[1] // v.shape[1], dim=1)
    o = torch.einsum("bhqk,bhkd->bhqd", p, v.to(s.dtype))
    return o.to(q.dtype), lse


def attention_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                      causal: bool = True):
    """(dq, dk, dv) of ``attention_ref`` by the FlashAttention-2 formulas,
    in f32, each in its input's dtype: ``D_i = sum dO_i O_i``,
    ``P = exp(S scale - lse)``, ``dV = sum_g P^T dO``,
    ``dS = P (dO V^T - D)``, ``dQ = scale dS K``,
    ``dK = scale sum_g dS^T Q``; the sums over g run over the G query heads
    of each KV head.  The arithmetic the backward kernels do, written out
    (not autograd of ``attention_ref``); f64 inputs in f64."""
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    g = hq // hkv
    scale = 1.0 / (d ** 0.5)
    wt = _work_dtype(q.dtype)
    q32, k32, v32, do32 = (t.to(wt) for t in (q, k, v, do))
    delta = (do32 * o.to(wt)).sum(-1)                        # (B, Hq, Sq)
    p = torch.exp(_scores(q, k, causal) - lse[..., None])    # (B, Hq, Sq, Sk)
    kr = k32.repeat_interleave(g, dim=1)
    vr = v32.repeat_interleave(g, dim=1)
    dp = torch.einsum("bhqd,bhkd->bhqk", do32, vr)
    ds = p * (dp - delta[..., None])
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kr) * scale
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q32).reshape(
        b, hkv, g, sk, d).sum(2) * scale
    dv = torch.einsum("bhqk,bhqd->bhkd", p, do32).reshape(
        b, hkv, g, sk, d).sum(2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _row_lengths(length, device) -> torch.Tensor:
    """A scalar or (B,) length as an int64 column, (1, 1) or (B, 1)."""
    return torch.as_tensor(length, device=device).to(torch.int64).reshape(
        -1, 1)


def decode_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               length) -> torch.Tensor:
    """q (B,Hq,D); k/v (B,Hkv,S,D) — decode oracle with cache-length mask.

    ``length`` is a scalar (every row, as in the reference) or a (B,)
    vector (one per row); positions ``>= length`` are masked.  A row with
    ``length == 0`` has every position masked, and the softmax then
    averages V over all S positions."""
    d = q.shape[-1]
    s = k.shape[2]
    g = q.shape[1] // k.shape[1]
    kr = k.repeat_interleave(g, dim=1)
    vr = v.repeat_interleave(g, dim=1)
    sc = torch.einsum("bhd,bhkd->bhk", q.to(torch.float32),
                      kr.to(torch.float32)) / (d ** 0.5)
    mask = torch.arange(s, device=q.device)[None, :] < _row_lengths(
        length, q.device)                                   # (B|1, S)
    sc = torch.where(mask[:, None, :], sc, NEG_INF)
    p = torch.softmax(sc, dim=-1)
    return torch.einsum("bhk,bhkd->bhd", p,
                        vr.to(torch.float32)).to(q.dtype)


def decode_int8_ref(q: torch.Tensor, k8: torch.Tensor, k_scale: torch.Tensor,
                    v8: torch.Tensor, v_scale: torch.Tensor,
                    length) -> torch.Tensor:
    """Oracle for flash_decode_int8: dequantize then exact decode attention.

    q (B, Hq, D); k8/v8 (B, Hkv, S, D) int8; scales (B, Hkv, S, 1) f32.
    """
    k = k8.to(torch.float32) * k_scale
    v = v8.to(torch.float32) * v_scale
    return decode_ref(q, k, v, length)


# -------------------------------------------------------------- mamba-1 scan
def selective_scan_ref(u: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                       b: torch.Tensor, c: torch.Tensor, d_skip: torch.Tensor,
                       return_state: bool = False):
    """Oracle for the selective scan, one time step after another in f32:
    ``h_t = exp(dt_t a) h_{t-1} + (dt_t u_t) B_t`` and
    ``y_t = sum_N h_t C_t + d_skip u_t``.

    u/dt (B, L, D); a (D, N); b/c (B, L, N); d_skip (D,) -> y (B, L, D) f32
    [, final state hT (B, D, N) f32].  It returns what the kernel returns:
    the reference's oracle casts y to u's dtype, which its callers here do
    themselves where they need it.  f64 inputs are computed, and give y
    and hT, in f64 (``gradcheck``)."""
    bsz, l, d = u.shape
    n = a.shape[1]
    wt = _work_dtype(u.dtype)
    a = a.to(wt)
    u32, dt32 = u.to(wt), dt.to(wt)
    b32, c32 = b.to(wt), c.to(wt)
    h = torch.zeros((bsz, d, n), dtype=wt, device=u.device)
    y = torch.empty((bsz, l, d), dtype=wt, device=u.device)
    for t in range(l):
        da = torch.exp(dt32[:, t, :, None] * a[None])           # (B, D, N)
        h = h * da + (dt32[:, t] * u32[:, t])[:, :, None] * b32[:, t, None, :]
        y[:, t] = torch.sum(h * c32[:, t, None, :], dim=2)
    y = y + d_skip.to(wt)[None, None, :] * u32
    return (y, h) if return_state else y


def selective_scan_bwd_ref(u: torch.Tensor, dt: torch.Tensor,
                           a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                           d_skip: torch.Tensor, dy: torch.Tensor):
    """(du, ddt, da, db, dc, dd): the gradients of ``selective_scan_ref``'s
    y at ``dy`` (B, L, D), by the reverse-time recurrence written out (not
    autograd), in f32 (f64 for f64 inputs).  With ``a_t = exp(dt_t A)`` and
    the states ``h_t`` of the forward (``h_{-1} = 0``):

    ``g_t = dy_t C_t + a_{t+1} g_{t+1}`` (``g_L = 0``), per (b, d, n);
    ``du_t = dt_t sum_n g_t B_t + d_skip dy_t``;
    ``ddt_t = sum_n g_t (u_t B_t + A a_t h_{t-1})``;
    ``da = sum_{b,t} g_t dt_t a_t h_{t-1}``;
    ``db_t = sum_d g_t dt_t u_t``; ``dc_t = sum_d dy_t h_t``;
    ``dd = sum_{b,t} dy_t u_t``.

    du, ddt, db, dc come in u's dtype (rounded once), da and dd in f32 (f64
    for f64 inputs): what the backward kernels of ``csrc/mamba_scan_bwd.cu``
    compute.  Keeps every state, (B, L, D, N) in the work dtype."""
    bsz, l, d = u.shape
    wt = _work_dtype(u.dtype)
    a = a.to(wt)
    u32, dt32, b32, c32, dy32 = (t.to(wt) for t in (u, dt, b, c, dy))
    h = torch.zeros((bsz, d, a.shape[1]), dtype=wt, device=u.device)
    hs = [h]                                  # hs[t] = h_{t-1}
    for t in range(l):
        at = torch.exp(dt32[:, t, :, None] * a[None])
        h = at * h + (dt32[:, t] * u32[:, t])[:, :, None] * b32[:, t, None, :]
        hs.append(h)
    du, ddt = torch.empty_like(u32), torch.empty_like(u32)
    db, dc = torch.empty_like(b32), torch.empty_like(c32)
    da = torch.zeros_like(a)
    g = torch.zeros_like(h)
    a_next = torch.zeros_like(h)
    for t in reversed(range(l)):
        at = torch.exp(dt32[:, t, :, None] * a[None])        # (B, D, N)
        g = dy32[:, t, :, None] * c32[:, t, None, :] + a_next * g
        ah = at * hs[t]
        du[:, t] = dt32[:, t] * torch.sum(g * b32[:, t, None, :], dim=2) \
            + d_skip.to(wt)[None] * dy32[:, t]
        ddt[:, t] = torch.sum(g * (u32[:, t, :, None] * b32[:, t, None, :]
                                   + a[None] * ah), dim=2)
        da += torch.sum(g * dt32[:, t, :, None] * ah, dim=0)
        db[:, t] = torch.sum(g * (dt32[:, t] * u32[:, t])[:, :, None], dim=1)
        dc[:, t] = torch.sum(dy32[:, t, :, None] * hs[t + 1], dim=1)
        a_next = at
    dd = torch.sum(dy32 * u32, dim=(0, 1))
    return (du.to(u.dtype), ddt.to(dt.dtype), da, db.to(b.dtype),
            dc.to(c.dtype), dd)
