"""Ring all-reduce on ``torch.distributed`` and the accumulated train step.

Port of ``repro.distributed.overlap``.

1. :func:`ring_all_reduce`: the reference's explicit ring (a reduce-scatter
   sweep, then an all-gather sweep: 2(n-1) hops, each segment optionally
   split into ``n_chunks``), with the reference's segment indices, each hop
   a ``dist.batch_isend_irecv`` pair to the next rank and from the
   previous one.  Each rank adds what it receives to its own segment, in
   the reference's order (``segs[i] + recv``).

2. :func:`make_accum_train_step`: microbatched gradient accumulation, in
   the reference's order of operations: ``n_micro`` forward/backward
   passes (micro-batch i is rows ``i B/n .. (i+1) B/n`` of every field),
   each gradient cast to f32, divided by ``n_micro`` and added into an f32
   accumulator (one ``addcdiv_`` a tensor: ``acc + g / n``); the loss and
   ``ce`` summed as ``x / n_micro``; with a compression spec, the
   accumulator round-tripped through the compressor on a zero residual,
   which is discarded (``compression.compress_in_place``: on the card one
   pass of ``csrc/compress.cu`` over the tree); then one AdamW call on the
   f32 accumulator (``optim.adamw.adamw_apply``: the kernels take f32
   gradients beside bf16 parameters).  Its body,
   :func:`accum_step_body`, has ``train.loop.step_body``'s signature, so
   ``train.graphs.TrainGraph`` captures it as it captures the plain step,
   and ``train.loop.make_train_step`` wraps it as it wraps the plain one:
   :func:`make_accum_train_step` only passes it in.

``slow_axis`` changes nothing, as in the reference: in one process the
compressed wire's numerics are the round trip itself.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig
from ..models import loss as model_loss
from ..models.convert import decayed
from ..optim.adamw import OptState, adamw_apply
from .compression import CompressionSpec, compress_in_place


# ------------------------------------------------------------ ring allreduce
def _hop(segs, send_idx, recv, nxt, prv, group) -> None:
    """One hop: segment ``send_idx`` (its ``n_chunks`` parts) to the next
    rank, the previous rank's into ``recv``."""
    import torch.distributed as dist
    ops = []
    for c in range(segs.shape[1]):
        ops.append(dist.P2POp(dist.isend, segs[send_idx, c], nxt, group))
        ops.append(dist.P2POp(dist.irecv, recv[c], prv, group))
    for work in dist.batch_isend_irecv(ops):
        work.wait()


@torch.no_grad()
def ring_all_reduce(x: torch.Tensor, group=None, *, n_chunks: int = 1
                    ) -> torch.Tensor:
    """All-reduce of every rank's ``x`` over ``group`` (the default group
    where None) as 2(n-1) ring hops (reduce-scatter, then all-gather); a
    new tensor of ``x``'s shape, ``x`` unchanged.

    The flat view is padded to n segments of ``n_chunks`` parts each; every
    part is its own send and receive."""
    import torch.distributed as dist
    n = dist.get_world_size(group)
    if n == 1:
        return x.clone()
    me = dist.get_rank(group)
    nxt, prv = ((me + 1) % n, (me - 1) % n)
    if group is not None:
        nxt = dist.get_global_rank(group, nxt)
        prv = dist.get_global_rank(group, prv)
    flat = x.reshape(-1)
    seg = -(-flat.shape[0] // (n * n_chunks)) * n_chunks
    flat = F.pad(flat, (0, seg * n - flat.shape[0]))
    segs = flat.view(n, n_chunks, seg // n_chunks)     # ring segment j
    recv = torch.empty_like(segs[0])
    # reduce-scatter sweep: after n-1 hops, rank d owns the full sum of
    # segment (d+1) mod n
    for k in range(n - 1):
        _hop(segs, (me - k) % n, recv, nxt, prv, group)
        segs[(me - k - 1) % n] += recv
    # all-gather sweep: circulate the finished segments
    for k in range(n - 1):
        _hop(segs, (me + 1 - k) % n, recv, nxt, prv, group)
        segs[(me - k) % n].copy_(recv)
    return flat[:x.numel()].reshape(x.shape)


def ring_all_reduce_sharded(mesh, x: torch.Tensor, axis: str, *,
                            n_chunks: int = 1) -> torch.Tensor:
    """:func:`ring_all_reduce` over ``mesh``'s ``axis`` on the reference's
    global view: ``x`` holds one slice per device of ``axis``, leading; this
    rank reduces its own slice, and the result, like the reference's, has
    ``x``'s shape with the ring sum in every slice."""
    n = dict(zip(mesh.mesh_dim_names, mesh.shape))[axis]
    if x.shape[0] != n:
        raise ValueError(
            f"x leading dim {x.shape[0]} != axis {axis!r} size {n}: each "
            "device contributes exactly one slice")
    out = ring_all_reduce(x[mesh.get_local_rank(axis)],
                          mesh.get_group(axis), n_chunks=n_chunks)
    return out.unsqueeze(0).expand(n, *out.shape).clone()


# ------------------------------------------------- microbatch accumulation
def wants_accum(cfg: ArchConfig) -> bool:
    """Whether a train cell of ``cfg`` takes the accumulated step: the rule
    of the reference's ``launch/specs.py::make_cell``."""
    return cfg.grad_accum > 1 or cfg.grad_compression != "none"


def compression_of(cfg: ArchConfig) -> Optional[CompressionSpec]:
    """The compression spec ``make_cell`` gives the accumulated step."""
    return (CompressionSpec(kind=cfg.grad_compression)
            if cfg.grad_compression != "none" else None)


def accum_step_body(model, opt: OptState, n_micro: int,
                    compression: Optional[CompressionSpec] = None, *,
                    weight_decay: float = 0.1) -> Callable:
    """``body(batch, hyper) -> metrics``: one accumulated step of ``model``
    with the moments of ``opt``, all on the device (the module docstring's
    order); ``hyper`` as ``train.loop.step_body``'s.  Metrics: ``loss``,
    ``ce``, ``aux`` (0-d f32 tensors) and ``grad_norm``.  A parameter the
    loss does not reach has a zero accumulated gradient, as under
    ``jax.grad``."""
    cfg = model.cfg
    params = dict(model.named_parameters())
    decay = decayed(model)

    def body(batch: Dict[str, torch.Tensor], hyper: torch.Tensor) -> Dict:
        first = next(iter(batch.values()))
        size = first.shape[0] // n_micro
        dev = first.device
        n = torch.full((), float(n_micro), dtype=torch.float32, device=dev)
        acc = {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
               for k, p in params.items()}
        sums = [torch.zeros((), dtype=torch.float32, device=dev)
                for _ in range(3)]
        for i in range(n_micro):
            micro = {k: v[i * size:(i + 1) * size] for k, v in batch.items()}
            for p in params.values():
                p.grad = None
            loss, metrics = model_loss(cfg, model, micro)
            loss.backward()
            with torch.no_grad():
                for k, p in params.items():
                    if p.grad is not None:
                        acc[k].addcdiv_(p.grad, n)
                        p.grad = None
                parts = (loss, metrics.get("ce", loss), metrics.get("aux"))
                for j, x in enumerate(parts):
                    if x is not None:
                        sums[j] = sums[j] + x.detach().to(torch.float32) / n
            del loss, metrics
        if compression is not None and compression.kind != "none":
            compress_in_place(acc, compression)
        gnorm = adamw_apply(acc, opt, params, hyper,
                            weight_decay=weight_decay, decayed=decay)
        del acc
        return {"loss": sums[0], "ce": sums[1], "aux": sums[2],
                "grad_norm": gnorm}

    return body


def make_accum_train_step(model, *, n_micro: int, peak_lr: float = 3e-4,
                          total_steps: int = 10_000,
                          weight_decay: float = 0.1,
                          compression: Optional[CompressionSpec] = None,
                          slow_axis: Optional[str] = None) -> Callable:
    """(state, batch) -> (state, metrics) with gradient accumulation,
    eagerly: ``train.loop.make_train_step``'s wrapper around
    :func:`accum_step_body`.  Metrics: ``loss``, ``lr``, ``ce``, ``aux``
    and ``grad_norm``, the reference's.

    ``train.loop`` is imported here, as the reference imports its
    ``TrainState`` inside this function (``overlap.py:142-143``): the loop
    takes its accumulated body from this module, and this module only
    lends it the reference's signature."""
    from ..train.loop import make_train_step
    del slow_axis                   # the reference's, unused there too
    return make_train_step(
        model, peak_lr=peak_lr, total_steps=total_steps,
        weight_decay=weight_decay,
        body=lambda m, opt, *, weight_decay: accum_step_body(
            m, opt, n_micro, compression, weight_decay=weight_decay))
