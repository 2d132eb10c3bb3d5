"""Operand checks shared by the kernels' wrappers.

The attention kernels read their operands through element strides with a
contiguous last dimension, in loads of 16 bytes (4 f32, 8 bf16 or 16 int8
elements: the bf16 flash attention kernel and the decode kernels' k and v)
or of four elements; these helpers give them such views (copying only what
does not qualify), the launch stream and the per-row lengths.  The scan
kernel takes its strides and stream from here too.  :func:`check_no_grad`
is the guard of the kernels that have no backward.
"""

from __future__ import annotations

import ctypes

import torch

# head dims the CUDA attention kernels are instantiated for
HEAD_DIMS = (32, 64, 128, 256)
FLOAT_DTYPES = (torch.float32, torch.bfloat16)


def aligned(t: torch.Tensor, n: int) -> torch.Tensor:
    """``t`` itself when its last stride is 1 and its data pointer and every
    other stride are multiples of ``n`` elements; else a contiguous copy
    (whose strides are then multiples of ``n`` where its last dimension is:
    the wrappers check head dims first)."""
    ok = (t.stride(-1) == 1
          and all(s % n == 0 for s in t.stride()[:-1])
          and t.data_ptr() % (n * t.element_size()) == 0)
    return t if ok else t.clone(memory_format=torch.contiguous_format)


def grad_needed(*tensors) -> bool:
    """Whether autograd would record a call on ``tensors``: grad mode is on
    and one of them requires grad."""
    return torch.is_grad_enabled() and any(
        isinstance(t, torch.Tensor) and t.requires_grad for t in tensors)


def check_no_grad(name: str, *tensors) -> None:
    """Raise where a kernel with no backward would be recorded by autograd:
    its output would have no ``grad_fn``, and the gradients below it would
    be silently missing."""
    if grad_needed(*tensors):
        raise RuntimeError(f"{name}: the CUDA kernel has no backward; call it "
                           f"under torch.no_grad() or on tensors that do not "
                           f"require grad")


def strides(*tensors_dims) -> ctypes.Array:
    """The element strides of each ``(tensor, dims)`` pair, concatenated, as
    the ``long long`` array the kernels take."""
    vals = [t.stride(d) for t, dims in tensors_dims for d in dims]
    return (ctypes.c_longlong * len(vals))(*vals)


def stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def check_cuda_head_dim(name: str, d: int) -> None:
    if d not in HEAD_DIMS:
        raise ValueError(f"{name}: the CUDA kernel is built for head dims "
                         f"{HEAD_DIMS}, got {d}")


def row_lengths(name: str, length, b: int,
                device: torch.device) -> torch.Tensor:
    """A scalar or (B,) ``length`` as a contiguous (B,) int32 tensor on
    ``device`` (a tensor already there is not copied to the host)."""
    if isinstance(length, torch.Tensor):
        if length.numel() not in (1, b) or length.dim() > 1:
            raise ValueError(f"{name}: length must be a scalar or ({b},), "
                             f"got {tuple(length.shape)}")
        if length.is_floating_point() or length.is_complex():
            raise TypeError(f"{name}: length must be an integer, got "
                            f"{length.dtype}")
        out = length.to(device=device, dtype=torch.int32).reshape(-1)
        return out.expand(b).contiguous() if out.numel() != b else \
            out.contiguous()
    return torch.full((b,), int(length), dtype=torch.int32, device=device)
