"""Gradient compression for the slow (cross-pod) wire.

Port of ``repro.distributed.compression``.  The multi-pod mesh has two link
classes: the fast intra-pod links and the inter-pod links, an order of
magnitude slower.  Compressing the *inter-pod* hop of the gradient
reduction buys near-linear scaling across pods while keeping the intra-pod
reduction exact:

  hierarchical_psum:   all-reduce over "data" (exact, fast wire)
                       -> blockwise-int8 quantize
                       -> all-reduce over "pod" in the dequantized domain
                          (the wire carries int8 payload + f32 scales)

Error feedback (EF21 / 1-bit-Adam style residual memory) makes the biased
quantizer unbiased *in the long run*: the compression error of step t is
added back into step t+1's gradient.

As in the reference, the functions are pure and take trees (here dicts
keyed by parameter name) of tensors; the reference's mesh axis names inside
``shard_map`` become a ``torch.distributed.device_mesh.DeviceMesh`` and an
axis name (``mesh.get_group(axis)``).  The int8 round trip of a tree is
one call of ``kernels.compress.compress_int8_``: on CUDA tensors one
hand-written pass over the whole tree (``csrc/compress.cu``), on CPU
tensors its plain version, the composition of :func:`quantize_blockwise`
and :func:`dequantize_blockwise` (which live in that kernel module and are
re-exported here); the two are bit-equal.  :func:`compress_in_place`
is the accumulated step's form: a zero residual, discarded, the result
written over the f32 accumulator.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from ..kernels import compress as kcompress
# the int8 blockwise arithmetic is the kernel's plain version: one copy, in
# the kernel layer below this one
from ..kernels.compress import dequantize_blockwise, quantize_blockwise

Tree = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class CompressionSpec:
    """What to do to gradients on the slow wire."""
    kind: str = "int8"              # int8 | topk | none
    block: int = 256                # quantization block (per-block scale)
    topk_frac: float = 0.01         # fraction kept by topk
    error_feedback: bool = True

    def wire_bytes(self, n_elems: int) -> int:
        """Payload bytes this spec puts on the wire for n f32 elements."""
        if self.kind == "int8":
            n_blocks = -(-n_elems // self.block)
            return n_elems + 4 * n_blocks            # int8 + f32 scales
        if self.kind == "topk":
            k = max(1, int(n_elems * self.topk_frac))
            return 8 * k                              # f32 value + int32 idx
        return 4 * n_elems


# ------------------------------------------------------------------- top-k
def topk_sparsify(x: torch.Tensor, frac: float
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Keep the k = max(1, frac*n) largest-|.| entries of flat x.

    Returns (values f32 [k], indices int32 [k]); ``torch.topk`` as the
    reference's ``lax.top_k`` (ties may be kept in another order)."""
    flat = x.to(torch.float32).reshape(-1)
    k = max(1, int(flat.shape[0] * frac))
    _, idx = torch.topk(torch.abs(flat), k)
    return flat[idx], idx.to(torch.int32)


def topk_densify(values: torch.Tensor, idx: torch.Tensor, shape,
                 dtype=torch.float32) -> torch.Tensor:
    n = 1
    for d in shape:
        n *= d
    out = torch.zeros((n,), dtype=torch.float32, device=values.device)
    out[idx.long()] = values.to(torch.float32)
    return out.reshape(shape).to(dtype)


# ----------------------------------------------------------- error feedback
def init_error_feedback(grads: Tree) -> Tree:
    """Residual memory tree, f32, zero-initialized."""
    return {k: torch.zeros(g.shape, dtype=torch.float32, device=g.device)
            for k, g in grads.items()}


def _f32_copy(t: torch.Tensor) -> torch.Tensor:
    out = torch.empty(t.shape, dtype=torch.float32, device=t.device)
    return out.copy_(t)


def _compress_leaf(g: torch.Tensor, spec: CompressionSpec) -> torch.Tensor:
    """Round-trip one leaf through the compressor (the value that actually
    reaches the far side of the wire), f32."""
    if spec.kind == "int8":
        t = _f32_copy(g)
        kcompress.compress_int8_([t], block=spec.block)
        return t
    if spec.kind == "topk":
        v, i = topk_sparsify(g, spec.topk_frac)
        return topk_densify(v, i, g.shape)
    return g.to(torch.float32)


@torch.no_grad()
def compress_with_feedback(grads: Tree, ef: Tree, spec: CompressionSpec
                           ) -> Tuple[Tree, Tree]:
    """(compressed grads, new residuals).  c = C(g + e); e' = g + e - c.
    The int8 kind runs the whole tree in one ``kernels.compress`` call
    (which forms g + e itself)."""
    names = list(grads)
    if names and spec.kind == "int8":
        comp = {k: _f32_copy(grads[k]) for k in names}
        new_ef = ({k: ef[k].clone(memory_format=torch.contiguous_format)
                   for k in names} if spec.error_feedback else dict(ef))
        kcompress.compress_int8_(
            [comp[k] for k in names],
            [new_ef[k] for k in names] if spec.error_feedback else None,
            block=spec.block)
        return {k: comp[k].to(grads[k].dtype) for k in names}, new_ef
    comp, new_ef = {}, {}
    for k in names:
        target = grads[k].to(torch.float32) + (
            ef[k] if spec.error_feedback else 0.0)
        c = _compress_leaf(target, spec)
        new_ef[k] = (target - c) if spec.error_feedback else ef[k]
        comp[k] = c.to(grads[k].dtype)
    return comp, new_ef


@torch.no_grad()
def compress_in_place(grads: Tree, spec: CompressionSpec) -> None:
    """``compress_with_feedback`` on a zero residual, which is discarded,
    its result written over ``grads`` (f32: the accumulated step's
    accumulator, ``overlap.accum_step_body``).  The int8 kind is one
    ``kernels.compress`` call over the tree, with no residual read."""
    names = list(grads)
    if names and spec.kind == "int8":
        kcompress.compress_int8_([grads[k] for k in names], block=spec.block)
        return
    for k in names:
        # the reference's target g + 0 (a zero residual, or no feedback)
        grads[k].copy_(_compress_leaf(grads[k] + 0.0, spec))


# ------------------------------------------------------- hierarchical psum
def hierarchical_psum(x: torch.Tensor, mesh, *, fast_axis: str = "data",
                      slow_axis: Optional[str] = "pod",
                      spec: Optional[CompressionSpec] = None
                      ) -> torch.Tensor:
    """Two-level reduction over ``mesh`` (a ``DeviceMesh``), on every rank's
    ``x``; ``x`` itself is not changed.

    Exact all-reduce over the intra-pod ``fast_axis``; the inter-pod hop
    is quantized (per ``spec``) before the slow-wire all-reduce.  With
    slow_axis=None (single pod) this is a plain all-reduce."""
    import torch.distributed as dist
    x = x.clone()
    dist.all_reduce(x, group=mesh.get_group(fast_axis))
    if slow_axis is None:
        return x
    if spec is None or spec.kind == "none":
        dist.all_reduce(x, group=mesh.get_group(slow_axis))
        return x
    # quantize the *local* contribution; sum the dequantized payloads (what
    # the receiver reconstructs from int8 + scales)
    c = _compress_leaf(x, spec).to(x.dtype)
    dist.all_reduce(c, group=mesh.get_group(slow_axis))
    return c


def hierarchical_psum_sharded(mesh, x: torch.Tensor, *,
                              fast_axis: str = "data",
                              slow_axis: Optional[str] = "pod",
                              spec: Optional[CompressionSpec] = None
                              ) -> torch.Tensor:
    """``hierarchical_psum`` of the reference's global view: ``x`` holds one
    slice per (slow, fast) device, leading, slow-major (the reference's
    ``P((slow, fast))``); this rank reduces its own slice, and the result,
    like the reference's, has ``x``'s shape with the reduced value in every
    slice."""
    axes = (slow_axis, fast_axis) if slow_axis else (fast_axis,)
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    n, idx = 1, 0
    for a in axes:
        n *= sizes[a]
        idx = idx * sizes[a] + mesh.get_local_rank(a)
    if x.shape[0] != n:
        raise ValueError(
            f"x leading dim {x.shape[0]} != {axes} device count {n}: each "
            "device contributes exactly one slice")
    out = hierarchical_psum(x[idx], mesh, fast_axis=fast_axis,
                            slow_axis=slow_axis, spec=spec)
    return out.unsqueeze(0).expand(n, *out.shape).clone()
