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

``LAUNCHES`` counts wrapper calls that launch the kernels, one per call
(plain-version calls are not counted; a causal call with Sq > Sk also
launches ``prefix_mean_kernel`` for the rows before the first key);
:func:`reset_launches` zeroes it.
"""

from __future__ import annotations

import torch

from . import _build, _tensors
from .ref import attention_ref

LAUNCHES = {"flash_attention": 0}
_GRID_MAX = 65535
BQ_BF16 = 64          # queries per block of the tensor-core kernel


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True) -> torch.Tensor:
    """The plain version of :func:`flash_attention`."""
    return attention_ref(q, k, v, causal=causal)


def _check(q, k, v, causal):
    name = "flash_attention"
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"{name}: q, k, v must be 4-D, got {tuple(q.shape)},"
                         f" {tuple(k.shape)}, {tuple(v.shape)}")
    if q.dtype not in _tensors.FLOAT_DTYPES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise TypeError(f"{name}: q, k, v must share one of "
                        f"{_tensors.FLOAT_DTYPES}, got {q.dtype}, {k.dtype}, "
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
                    causal: bool = True) -> torch.Tensor:
    """q (B, Hq, Sq, D); k/v (B, Hkv, Sk, D), f32 or bf16 -> (B, Hq, Sq, D)
    in q's dtype.  Query head h reads KV head ``h // (Hq // Hkv)``; with
    ``causal`` query i sees keys at positions ``<= i + Sk - Sq``.  Where
    Sq > Sk, a query row before the first key (``i + Sk - Sq < 0``) sees
    none and gets the mean of V over all Sk keys, as the Pallas kernel
    (which masks with the finite -1e30) and the plain version give."""
    b, hq, hkv, sq, sk, d = _check(q, k, v, causal)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal)
    _tensors.check_cuda_head_dim("flash_attention", d)
    bf16 = q.dtype == torch.bfloat16
    if bf16 and (b > _GRID_MAX or -(-sq // BQ_BF16) > _GRID_MAX):
        raise ValueError(f"flash_attention: B={b} or Sq={sq} exceeds the "
                         f"kernel's grid")
    q, k, v = (_tensors.aligned(t, 8 if bf16 else 4) for t in (q, k, v))
    out = torch.empty_like(q)        # q's layout; its last stride is 1
    if b == 0 or hq == 0 or sq == 0:
        return out
    lib = _build.load()
    fn = lib.flash_attention_bf16 if bf16 else lib.flash_attention_f32
    st = _tensors.strides((q, (0, 1, 2)), (k, (0, 1, 2)), (v, (0, 1, 2)),
                          (out, (0, 1, 2)))
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 b, hq, hkv, sq, sk, d, int(causal), 1.0 / (d ** 0.5), st,
                 _tensors.stream(q.device))
    _build.check(lib, "flash_attention", err)
    LAUNCHES["flash_attention"] += 1
    return out
