"""Flash attention (prefill): causal GQA online-softmax attention on Hopper.

``flash_attention`` launches a hand-written CUDA kernel of
``csrc/flash_attn.cu`` (port of the Pallas kernel
``repro.kernels.flash_attn.flash_attention``) on CUDA tensors, and runs its
plain PyTorch version (:func:`flash_attention_plain`, the oracle
``ref.attention_ref``) on CPU tensors.  The kernel follows the dtype: bf16
runs on Hopper's warpgroup tensor cores (``flash_attention_wgmma_kernel``:
bf16 products, f32 accumulation, P rounded to bf16 before the P.V
product), f32 on the CUDA cores in f32 (``flash_attention_kernel``), which
holds the f32 checks a tensor-core product would not.  A CUDA tensor never falls back to
the plain version or to the other kernel: the kernel launches or the
wrapper raises.

The signature is the reference's, q (B, Hq, Sq, D) and k/v (B, Hkv, Sk, D),
but any strides with a contiguous last dimension are read as they are: the
model passes its (B, S, H, D) projections as ``transpose(1, 2)`` views, and
the output has q's layout (so ``out.transpose(1, 2)`` is contiguous for
such a q).  Unlike the Pallas wrapper there are no block-size arguments and
no divisibility rule: the kernels mask their ragged edges.  An operand whose
data pointer or b, h, s strides are not multiples of the kernel's load
width (4 elements in f32, 8 in bf16: 16 bytes either way) is copied first;
the model's views are never copied.

**Strided queries.**  ``q_stride`` > 1 places query row i at position
``i * q_stride + Sk - 1 - (Sq - 1) * q_stride`` (the last row at Sk - 1):
context parallelism's striped rows (``models.layers.SeqParallel``), one
rank's rows g, g + mm, ... over the keys up to its last row.  Both kernels
take it in their key bound and causal masks only; at 1 they compute what
they computed before, bit for bit.  So do the backward kernels, which take
it the same way (``FlashAttention`` carries it from the forward).

**Training.**  Where autograd records the call (grad mode on and an input
requires grad), :func:`flash_attention` goes through :class:`FlashAttention`:
its forward is the same kernel, which then also stores each row's f32
log-sum-exp (lse), and its backward (:func:`flash_attention_bwd`) three
kernels of ``csrc/flash_attn_bwd.cu`` (FlashAttention-2: a row-sum
preprocess, dK/dV by KV tile, dQ by query tile; no atomics, so a backward
is bit-equal from run to run).  bf16 at D <= 128 runs its products on the
tensor cores (wgmma, P and dS rounded to bf16 before their products, as
the forward rounds P); f32, and bf16 at D = 256, on the CUDA cores in f32
(:func:`bwd_kernels`).  The JAX package has no such kernel: it
differentiates its plain chunked attention.  On CPU tensors the Function
runs the plain versions ``ref.attention_lse_ref`` / ``ref.attention_bwd_ref``
with the same saved tensors and formulas.  Causal attention with Sq > Sk
(rows before the first key) has no backward and raises when recorded.
Otherwise the call goes straight to the forward kernel, without lse, as in
serving and in a CUDA graph's capture.

``LAUNCHES`` counts wrapper calls that launch the kernels, one per call:
``flash_attention`` for the forward (plain-version calls are not counted; a
causal call with Sq > Sk also launches ``prefix_mean_kernel`` for the rows
before the first key), ``flash_attention_bwd`` for the backward's three
kernels; :func:`reset_launches` zeroes them.
"""

from __future__ import annotations

import torch

from . import _build, _tensors
from .ref import (_work_dtype, attention_bwd_ref, attention_lse_ref,
                  attention_ref)

LAUNCHES = {"flash_attention": 0, "flash_attention_bwd": 0}
_GRID_MAX = 65535
BQ_BF16 = 64          # queries per block of the tensor-core kernel


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def bwd_kernels(dtype: torch.dtype, d: int):
    """(dK/dV kernel, dQ kernel, tile) that :func:`flash_attention_bwd`
    launches on CUDA tensors of ``dtype`` at head dim ``d``, after
    ``attn_bwd_preprocess_kernel``: the tensor-core pair for bf16 at
    D <= 128, with 64-row tiles; else the CUDA-core pair, with tiles of 64
    (32 at D = 256).  A call never takes the other pair."""
    if dtype == torch.bfloat16 and d <= 128:
        return "attn_bwd_dkdv_wgmma_kernel", "attn_bwd_dq_wgmma_kernel", 64
    return "attn_bwd_dkdv_kernel", "attn_bwd_dq_kernel", 32 if d == 256 \
        else 64


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True,
                          q_stride: int = 1) -> torch.Tensor:
    """The plain version of :func:`flash_attention`."""
    return attention_ref(q, k, v, causal=causal, q_stride=q_stride)


def _check_stride(sq, sk, causal, q_stride):
    """A query stride is a positive int; above 1 with causal, every row
    needs a key at or before its position (the last row at Sk - 1, the
    first at Sk - 1 - (Sq - 1) q_stride >= 0)."""
    if not isinstance(q_stride, int) or q_stride < 1:
        raise ValueError(f"flash_attention: q_stride must be an int >= 1, "
                         f"got {q_stride!r}")
    if causal and q_stride > 1 and sk < (sq - 1) * q_stride + 1:
        raise ValueError(f"flash_attention: Sq={sq} rows at stride "
                         f"{q_stride} need Sk >= {(sq - 1) * q_stride + 1}, "
                         f"got {sk}")


def _check(q, k, v, causal, train=False):
    """The operands' sizes; ``train`` (the autograd path) also takes f64 on
    the CPU, for ``gradcheck``."""
    name = "flash_attention"
    dtypes = _tensors.FLOAT_DTYPES + (
        (torch.float64,) if train and q.device.type == "cpu" else ())
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"{name}: q, k, v must be 4-D, got {tuple(q.shape)},"
                         f" {tuple(k.shape)}, {tuple(v.shape)}")
    if q.dtype not in dtypes or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{name}: q, k, v must share one of "
                        f"{dtypes}, got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    b, hq, sq, d = q.shape
    bk, hkv, sk, dk = k.shape
    if (bk, dk) != (b, d) or tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"{name}: q {tuple(q.shape)} and k/v "
                         f"{tuple(k.shape)}/{tuple(v.shape)} disagree")
    if hkv == 0 or hq % hkv:
        raise ValueError(f"{name}: Hq={hq} is not a multiple of Hkv={hkv}")
    if sk == 0:
        raise ValueError(f"{name}: no keys (Sk == 0)")
    if k.device != q.device or v.device != q.device:
        raise ValueError(f"{name}: q, k, v must be on one device")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {q.device}")
    return b, hq, hkv, sq, sk, d


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, q_stride: int = 1) -> torch.Tensor:
    """q (B, Hq, Sq, D); k/v (B, Hkv, Sk, D), f32 or bf16 -> (B, Hq, Sq, D)
    in q's dtype.  Query head h reads KV head ``h // (Hq // Hkv)``; with
    ``causal`` query i sees keys at positions ``<= i + Sk - Sq``.  Where
    Sq > Sk, a query row before the first key (``i + Sk - Sq < 0``) sees
    none and gets the mean of V over all Sk keys, as the Pallas kernel
    (which masks with the finite -1e30) and the plain version give.
    Differentiable where autograd records it (:class:`FlashAttention`).

    ``q_stride`` > 1 (context parallelism's striped rows): query i sits at position ``i * q_stride + Sk - 1 - (Sq - 1) *
    q_stride``, the last row at Sk - 1, so the caller passes the keys up to
    its last row's position; no row may come before the first key."""
    _check(q, k, v, causal)
    _check_stride(q.shape[2], k.shape[2], causal, q_stride)
    if _tensors.grad_needed(q, k, v):
        return FlashAttention.apply(q, k, v, causal, q_stride)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal, q_stride)
    return _forward(q, k, v, causal, with_lse=False, q_stride=q_stride)[0]


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, q_stride: int = 1):
    """(out, lse): :func:`flash_attention`'s output and the f32 (B, Hq, Sq)
    natural-log log-sum-exp of each row's scaled, masked scores, stored by
    the forward kernel (``ref.attention_lse_ref`` on CPU tensors).  Causal
    with Sq > Sk raises: no backward takes it."""
    _check(q, k, v, causal, train=True)
    _check_stride(q.shape[2], k.shape[2], causal, q_stride)
    _check_trainable(q, k, causal)
    if q.device.type == "cpu":
        return attention_lse_ref(q, k, v, causal, q_stride)
    return _forward(q, k, v, causal, with_lse=True, q_stride=q_stride)


def _check_trainable(q, k, causal):
    if causal and q.shape[2] > k.shape[2]:
        raise ValueError(f"flash_attention: no backward for causal attention "
                         f"with Sq={q.shape[2]} > Sk={k.shape[2]} (rows "
                         f"before the first key)")


def _forward(q, k, v, causal, with_lse, q_stride=1):
    """The forward kernel on checked CUDA operands: (out, lse or None)."""
    b, hq, sq, d = q.shape
    sk = k.shape[2]
    _tensors.check_cuda_head_dim("flash_attention", d)
    bf16 = q.dtype == torch.bfloat16
    if bf16 and (b > _GRID_MAX or -(-sq // BQ_BF16) > _GRID_MAX):
        raise ValueError(f"flash_attention: B={b} or Sq={sq} exceeds the "
                         f"kernel's grid")
    q, k, v = (_tensors.aligned(t, 8 if bf16 else 4) for t in (q, k, v))
    out = torch.empty_like(q)        # q's layout; its last stride is 1
    lse = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device) \
        if with_lse else None
    if b == 0 or hq == 0 or sq == 0:
        return out, lse
    lib = _build.load()
    fn = lib.flash_attention_bf16 if bf16 else lib.flash_attention_f32
    st = _tensors.strides((q, (0, 1, 2)), (k, (0, 1, 2)), (v, (0, 1, 2)),
                          (out, (0, 1, 2)))
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 0 if lse is None else lse.data_ptr(), b, hq, k.shape[1], sq,
                 sk, d, int(causal), q_stride, 1.0 / (d ** 0.5), st,
                 _tensors.stream(q.device))
    _build.check(lib, "flash_attention", err)
    LAUNCHES["flash_attention"] += 1
    return out, lse


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, lse: torch.Tensor,
                        do: torch.Tensor, causal: bool = True,
                        q_stride: int = 1):
    """(dq, dk, dv) of :func:`flash_attention` at ``do`` (the gradient of its
    output ``o``), from the forward's ``lse``: three backward kernels on
    CUDA tensors (:func:`bwd_kernels` says which), ``ref.attention_bwd_ref``
    on CPU tensors; ``q_stride`` as the forward's.  Each gradient
    has its input's dtype and shape (and, on the card, its layout)."""
    b, hq, hkv, sq, sk, d = _check(q, k, v, causal, train=True)
    _check_stride(sq, sk, causal, q_stride)
    _check_trainable(q, k, causal)
    if tuple(o.shape) != tuple(q.shape) or tuple(do.shape) != tuple(q.shape) \
            or o.dtype != q.dtype or do.dtype != q.dtype:
        raise ValueError(f"flash_attention_bwd: o {o.dtype} "
                         f"{tuple(o.shape)} and do {do.dtype} "
                         f"{tuple(do.shape)} must match q {q.dtype} "
                         f"{tuple(q.shape)}")
    if lse.dtype != _work_dtype(q.dtype) or tuple(lse.shape) != (b, hq, sq):
        raise ValueError(f"flash_attention_bwd: lse must be float32 of shape "
                         f"{(b, hq, sq)}, got {lse.dtype} {tuple(lse.shape)}")
    if q.device.type == "cpu":
        return attention_bwd_ref(q, k, v, o, lse, do, causal, q_stride)
    _tensors.check_cuda_head_dim("flash_attention_bwd", d)
    bt = bwd_kernels(q.dtype, d)[2]       # grid z: tiles of keys, queries
    if b > _GRID_MAX or -(-max(sq, sk) // bt) > _GRID_MAX:
        raise ValueError(f"flash_attention_bwd: B={b}, Sq={sq} or Sk={sk} "
                         f"exceeds the kernels' grid")
    n = 8 if q.dtype == torch.bfloat16 else 4
    q, k, v, o, do = (_tensors.aligned(t, n) for t in (q, k, v, o, do))
    lse = lse.contiguous()
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    if b == 0 or hq == 0 or sq == 0:
        return dq, dk.zero_(), dv.zero_()
    delta = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
    lib = _build.load()
    fn = lib.flash_attention_bwd_bf16 if q.dtype == torch.bfloat16 \
        else lib.flash_attention_bwd_f32
    st = _tensors.strides(*((t, (0, 1, 2)) for t in (q, k, v, o, do, dq, dk,
                                                       dv)))
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                 dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, hq, hkv, sq,
                 sk, d, int(causal), q_stride, 1.0 / (d ** 0.5), st,
                 _tensors.stream(q.device))
    _build.check(lib, "flash_attention_bwd", err)
    LAUNCHES["flash_attention_bwd"] += 1
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """Flash attention with a backward: the forward kernel with lse, the
    backward kernels (the plain versions on CPU tensors), at the forward's
    ``q_stride``.  It saves q, k, v, the output and lse."""

    @staticmethod
    def forward(ctx, q, k, v, causal, q_stride=1):
        o, lse = flash_attention_fwd(q, k, v, causal, q_stride)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.q_stride = causal, q_stride
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do, ctx.causal,
                                         ctx.q_stride)
        return dq, dk, dv, None, None
