"""Hops and collectives on ``torch.distributed``, routed by the process
group's backend.

The pipeline's stage-to-stage hop and context parallelism's gathers,
all-to-alls and reductions go through these functions.  The group's
backend decides how a tensor travels, never a caught error:

- ``nccl``: device tensors go directly;
- ``gloo``: a CUDA tensor goes through an explicit host copy and comes
  back to its device.  This exists for several ranks sharing one card
  (NCCL refuses two ranks on one device); compute stays on the card.  CPU
  tensors go as they are.

Any other backend raises.  Ranks are the group's own (0 .. n-1); each
function maps them to global ranks itself.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch


def _dist():
    import torch.distributed as dist
    return dist


def group_of(group):
    """A process group from a ``ProcessGroup``, a 1-D ``DeviceMesh`` or
    ``None`` (the default group)."""
    if group is not None and hasattr(group, "get_group"):
        if group.ndim != 1:
            raise ValueError(f"a {group.ndim}-D mesh is not one group; pass "
                             f"mesh.get_group(<dim>)")
        return group.get_group()
    return group


def _via_host(t: torch.Tensor, group) -> bool:
    """Whether ``t`` crosses ``group`` through a host copy: a CUDA tensor on
    ``gloo``.  ``nccl`` takes device tensors; other backends raise."""
    backend = str(_dist().get_backend(group))
    if backend == "nccl":
        if t.device.type != "cuda":
            raise ValueError(f"nccl takes CUDA tensors, got {t.device}")
        return False
    if backend == "gloo":
        return t.device.type == "cuda"
    raise ValueError(f"unsupported process-group backend {backend!r}")


def _wire(t: torch.Tensor, host: bool) -> torch.Tensor:
    """``t`` as it crosses the wire: contiguous, on the host if ``host``."""
    t = t.contiguous()
    return t.cpu() if host else t


def _global(group, r: int) -> int:
    return _dist().get_global_rank(group, r) if group is not None else r


def rank(group) -> int:
    return _dist().get_rank(group)


def size(group) -> int:
    return _dist().get_world_size(group)


def hop(send: Optional[torch.Tensor], dst: Optional[int],
        recv_like: Optional[torch.Tensor], src: Optional[int],
        group) -> Optional[torch.Tensor]:
    """Send ``send`` to group rank ``dst`` and receive a tensor shaped as
    ``recv_like`` from ``src``, as one ``batch_isend_irecv``; either side
    may be ``None``.  Returns the received tensor (on ``recv_like``'s
    device) once both are done, else ``None``."""
    dist = _dist()
    ops, out, wire_in = [], None, None
    if send is not None:
        host = _via_host(send, group)
        ops.append(dist.P2POp(dist.isend, _wire(send, host),
                              _global(group, dst), group))
    if recv_like is not None:
        host = _via_host(recv_like, group)
        wire_in = torch.empty(recv_like.shape, dtype=recv_like.dtype,
                              device="cpu" if host else recv_like.device)
        ops.append(dist.P2POp(dist.irecv, wire_in, _global(group, src),
                              group))
    if not ops:
        return None
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    if wire_in is not None:
        out = wire_in.to(recv_like.device)
    return out


def all_gather(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in rank order."""
    dist = _dist()
    host = _via_host(x, group)
    w = _wire(x, host)
    parts = [torch.empty_like(w) for _ in range(size(group))]
    dist.all_gather(parts, w, group=group)
    return torch.cat(parts, dim=dim).to(x.device)


def all_to_all(x: torch.Tensor, send_counts: Sequence[int],
               recv_counts: Sequence[int], group) -> torch.Tensor:
    """Rows of ``x`` (dim 0) split by ``send_counts`` in rank order, part r
    to rank r; returns the parts received, concatenated in rank order
    (``recv_counts`` rows from each)."""
    dist = _dist()
    host = _via_host(x, group)
    w = _wire(x, host)
    out = torch.empty((sum(recv_counts),) + tuple(x.shape[1:]),
                      dtype=x.dtype, device=w.device)
    dist.all_to_all_single(out, w, output_split_sizes=list(recv_counts),
                           input_split_sizes=list(send_counts), group=group)
    return out.to(x.device)


def all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of every rank's ``x`` (a new tensor)."""
    host = _via_host(x, group)
    w = _wire(x, host).clone()
    _dist().all_reduce(w, group=group)
    return w.to(x.device)


def broadcast(x: torch.Tensor, src: int, group) -> torch.Tensor:
    """Group rank ``src``'s ``x`` on every rank (others pass a tensor of the
    same shape and dtype to receive into)."""
    host = _via_host(x, group)
    w = _wire(x, host).clone()
    _dist().broadcast(w, src=_global(group, src), group=group)
    return w.to(x.device)
