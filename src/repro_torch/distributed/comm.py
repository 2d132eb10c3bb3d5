"""Hops and collectives on ``torch.distributed``, routed by the process
group's backend.

The pipeline's stage-to-stage hop and context parallelism's gathers,
all-to-alls and reductions go through these functions.  The group's
backend decides how a tensor travels, never a caught error:

- ``nccl``: device tensors go directly;
- ``gloo``: a CUDA tensor goes through an explicit host copy and comes
  back to its device.  This exists for several ranks sharing one card
  (NCCL refuses two ranks on one device); compute stays on the card.  CPU
  tensors go as they are;
- ``fake`` (``torch.testing._internal.distributed.fake_pg``: collectives
  that move nothing, for a trace of one rank's program on fake tensors,
  ``launch.dryrun``): the branches of ``nccl``, the program the card
  runs, on tensors of any device; within :func:`fake_branches` ``("gloo")``
  those of ``gloo``.

Any other backend raises.  Ranks are the group's own (0 .. n-1); each
function maps them to global ranks itself.

**Gradients.**  :func:`all_gather`, :func:`reduce_scatter`,
:func:`all_to_all` and :func:`all_reduce` are differentiable
(``torch.autograd.Function``s): each one's backward is its adjoint, the
linear map that sends every rank's output gradient back to every rank's
input, run through the same routing by backend:

- ``all_gather`` <-> ``reduce_scatter`` (rank r's part of the gathered
  gradient, summed over every rank);
- ``all_to_all`` <-> the inverse ``all_to_all`` (the counts swapped);
- ``all_reduce`` <-> ``all_reduce``.

So a program that runs on every rank of a group, with every rank's result
scaled by 1/n before ``backward`` (a result that is the same on every rank
counts n times) and every parameter's gradient summed over the group, gets
the gradient of the one program the ranks compute together.  ``hop``,
:func:`broadcast` and :func:`reduce` have no backward (the pipeline
prefills; ZeRO-1's gradients to the data rank that owns them and its
parameters back, ``optim.adamw``).

The reductions (``all_reduce``, ``reduce_scatter``, forward or backward,
and ``reduce``) sum bf16 and f16 tensors in f32 and round once to the
tensor's dtype: NCCL and gloo sum in the buffer's dtype, rounding after
every add of n ranks' parts.  ``reduce_scatter`` on ``gloo`` is an
all-reduce of which each rank keeps its part (the host path carries n
times the bytes; gloo's reduce-scatter is not in every PyTorch release);
on ``nccl`` ``reduce_scatter_tensor``.

**The collective log.**  :class:`CollectiveLog` records every collective
a program issues, as the ``c10d`` operators that reach the dispatcher
(so the direct ``torch.distributed`` calls of ``compression.py`` and
``overlap.py`` count too): its kind, its group's size and mesh dimension,
its operand bytes (``repro.launch.roofline``'s definition: an all-gather's
operand is its input, a reduce-scatter's its whole input), and the port
function that issued it.
"""

from __future__ import annotations

import contextlib
import sys
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode


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


_FAKE_AS = ["nccl"]           # the backend whose branches "fake" takes


@contextlib.contextmanager
def fake_branches(backend: str):
    """Within, a ``fake`` group takes ``backend``'s branches ("nccl" or
    "gloo"): a trace to hold against a run on that backend."""
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"fake groups take nccl's or gloo's branches, not "
                         f"{backend!r}")
    prev, _FAKE_AS[0] = _FAKE_AS[0], backend
    try:
        yield
    finally:
        _FAKE_AS[0] = prev


def _backend(group) -> str:
    """The backend whose branches a collective on ``group`` takes."""
    backend = str(_dist().get_backend(group))
    return _FAKE_AS[0] if backend == "fake" else backend


def _via_host(t: torch.Tensor, group) -> bool:
    """Whether ``t`` crosses ``group`` through a host copy: a CUDA tensor on
    ``gloo``.  ``nccl`` takes device tensors, a ``fake`` group any tensor;
    other backends raise."""
    fake = str(_dist().get_backend(group)) == "fake"
    backend = _backend(group)
    if backend == "nccl":
        if t.device.type != "cuda" and not fake:
            raise ValueError(f"nccl takes CUDA tensors, got {t.device}")
        return False
    if backend == "gloo":
        return t.device.type == "cuda"
    raise ValueError(f"unsupported process-group backend {backend!r}")


def _wire(t: torch.Tensor, host: bool) -> torch.Tensor:
    """``t`` as it crosses the wire: contiguous, on the host if ``host``."""
    t = t.contiguous()
    return t.cpu() if host else t


def _sum_dtype(t: torch.Tensor) -> torch.dtype:
    """The dtype a reduction of ``t`` sums in: f32 for bf16 and f16."""
    return torch.float32 if t.dtype in (torch.bfloat16, torch.float16) \
        else t.dtype


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


def _all_gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    dist = _dist()
    host = _via_host(x, group)
    w = _wire(x, host)
    parts = [torch.empty_like(w) for _ in range(size(group))]
    dist.all_gather(parts, w, group=group)
    return torch.cat(parts, dim=dim).to(x.device)


def _reduce_scatter(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    dist = _dist()
    n = size(group)
    if x.shape[dim] % n:
        raise ValueError(f"reduce_scatter: dim {dim} of {tuple(x.shape)} does "
                         f"not split over {n} ranks")
    host = _via_host(x, group)
    w = _wire(torch.stack(x.chunk(n, dim)), host).to(_sum_dtype(x))
    if _backend(group) == "nccl":
        out = torch.empty(w.shape[1:], dtype=w.dtype, device=w.device)
        dist.reduce_scatter_tensor(out, w, group=group)
    else:
        dist.all_reduce(w, group=group)
        out = w[rank(group)]
    return out.to(device=x.device, dtype=x.dtype)


def _all_to_all(x: torch.Tensor, send_counts: Sequence[int],
                recv_counts: Sequence[int], group) -> torch.Tensor:
    dist = _dist()
    host = _via_host(x, group)
    w = _wire(x, host)
    out = torch.empty((sum(recv_counts),) + tuple(x.shape[1:]),
                      dtype=x.dtype, device=w.device)
    dist.all_to_all_single(out, w, output_split_sizes=list(recv_counts),
                           input_split_sizes=list(send_counts), group=group)
    return out.to(x.device)


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    host = _via_host(x, group)
    # summed in place: a copy of x, unless the host copy already is one
    w = _wire(x, host).to(_sum_dtype(x), copy=not host)
    _dist().all_reduce(w, group=group)
    return w.to(device=x.device, dtype=x.dtype)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, ctx.group, ctx.dim), None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _reduce_scatter(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.group, ctx.dim), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, send_counts, recv_counts, group):
        ctx.counts, ctx.group = (tuple(send_counts), tuple(recv_counts)), group
        return _all_to_all(x, send_counts, recv_counts, group)

    @staticmethod
    def backward(ctx, g):
        send, recv = ctx.counts
        return _all_to_all(g, recv, send, ctx.group), None, None, None


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


def all_gather(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in rank order;
    backward: :func:`reduce_scatter`."""
    return _AllGather.apply(x, group, dim)


def reduce_scatter(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Part r (of n equal parts along ``dim``) of the sum over the ranks of
    ``x``, on rank r; backward: :func:`all_gather`."""
    return _ReduceScatter.apply(x, group, dim)


def all_to_all(x: torch.Tensor, send_counts: Sequence[int],
               recv_counts: Sequence[int], group) -> torch.Tensor:
    """Rows of ``x`` (dim 0) split by ``send_counts`` in rank order, part r
    to rank r; returns the parts received, concatenated in rank order
    (``recv_counts`` rows from each).  Backward: the inverse all-to-all."""
    return _AllToAll.apply(x, send_counts, recv_counts, group)


def all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of every rank's ``x`` (a new tensor); backward: the sum of
    every rank's gradient."""
    return _AllReduce.apply(x, group)


def broadcast(x: torch.Tensor, src: int, group) -> torch.Tensor:
    """Group rank ``src``'s ``x`` on every rank (others pass a tensor of the
    same shape and dtype to receive into)."""
    host = _via_host(x, group)
    w = _wire(x, host).clone()
    _dist().broadcast(w, src=_global(group, src), group=group)
    return w.to(x.device)


def reduce(x: torch.Tensor, dst: int, group) -> Optional[torch.Tensor]:
    """The sum of every rank's ``x`` on group rank ``dst`` (a new tensor),
    None on the others."""
    host = _via_host(x, group)
    w = _wire(x, host).to(_sum_dtype(x), copy=not host)
    _dist().reduce(w, dst=_global(group, dst), group=group)
    if rank(group) != dst:
        return None
    return w.to(device=x.device, dtype=x.dtype)


# ------------------------------------------------------------ the collective log
# c10d operator -> (kind, the argument that holds its operand); recv_ and
# barrier carry no new bytes (a receive is its send's other end)
_KINDS = {
    "allreduce_": ("all-reduce", "tensors"),
    "allreduce_coalesced_": ("all-reduce", "tensors"),
    "allgather_": ("all-gather", "input_tensors"),
    "_allgather_base_": ("all-gather", "input_tensor"),
    "allgather_into_tensor_coalesced_": ("all-gather", "inputs"),
    "reduce_scatter_": ("reduce-scatter", "input_tensors"),
    "_reduce_scatter_base_": ("reduce-scatter", "input_tensor"),
    "reduce_scatter_tensor_coalesced_": ("reduce-scatter", "inputs"),
    "alltoall_": ("all-to-all", "input_tensors"),
    "alltoall_base_": ("all-to-all", "input"),
    "broadcast_": ("broadcast", "tensors"),
    "reduce_": ("reduce", "tensors"),
    "send": ("collective-permute", "tensors"),
}
KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
         "collective-permute", "broadcast", "reduce")


class Collective(NamedTuple):
    """One collective as :class:`CollectiveLog` records it: ``kind`` (one of
    :data:`KINDS`), ``axis`` (the mesh dimension of its group, None for a
    group that is none of the mesh's), ``size`` (the group's ranks),
    ``nbytes`` (operand bytes), ``issuer`` (:func:`_issuer`), ``backward``
    (issued by autograd's backward) and ``ranks`` (the group's global
    ranks)."""
    kind: str
    axis: Optional[str]
    size: int
    nbytes: int
    issuer: str
    backward: bool
    ranks: Tuple[int, ...]

    def key(self) -> tuple:
        """What two runs of one program share: everything but the group's
        global ranks (another rank's groups are others)."""
        return (self.kind, self.axis, self.size, self.nbytes, self.issuer,
                self.backward)


def _tensors(x) -> List[torch.Tensor]:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _tensors(v)]
    return []


_DIST = __file__.rsplit("/", 1)[0] + "/"
_PORT = _DIST.rstrip("/").rsplit("/", 1)[0] + "/"
_LIBS = tuple({sys.prefix, sys.base_prefix, sys.exec_prefix})


def _issuer() -> str:
    """Who issued a collective: the adjoint of a collective of this module
    (``module:Function.backward``: autograd may run it on a thread of its
    own, with no frame of the caller's); else ``module:function`` of the
    innermost frame of the port outside ``distributed/`` and dispatch
    modes; where the port has none (a script's own collectives), of the
    innermost frame outside the port's ``distributed/`` and the installed
    packages and library."""
    f, other = sys._getframe(1), None
    while f is not None:
        path, name = f.f_code.co_filename, f.f_code.co_name
        if path == __file__ and name == "backward":
            return f"repro_torch/distributed/comm.py:" \
                f"{getattr(f.f_code, 'co_qualname', name)}"
        if name != "__torch_dispatch__" and not path.startswith(_DIST):
            if path.startswith(_PORT):
                return f"{path[len(_PORT) - len('repro_torch/'):]}:{name}"
            if other is None and not path.startswith(_LIBS):
                other = f"{path.rsplit('/', 1)[-1]}:{name}"
        f = f.f_back
    return other or "?"


class CollectiveLog(TorchDispatchMode):
    """Within, every collective issued on this process is recorded in
    ``records`` (:class:`Collective`), in order; the collective itself runs
    as it would.  ``mesh`` (a ``DeviceMesh``; by default the ambient one,
    ``models.layers.ambient_mesh``, when the log is entered) names each
    group's dimension."""

    def __init__(self, mesh=None):
        super().__init__()
        self.mesh = mesh
        self.records: List[Collective] = []
        self._groups: Dict[str, tuple] = {}

    def __enter__(self):
        if self.mesh is None:
            from ..models.layers import _ambient_mesh
            self.mesh = _ambient_mesh()
        names = {}
        if self.mesh is not None:
            for n in self.mesh.mesh_dim_names:
                names[self.mesh.get_group(n).group_name] = n
        self._names = names
        return super().__enter__()

    def _group(self, pg) -> tuple:
        if not isinstance(pg, _dist().ProcessGroup):
            pg = _dist().ProcessGroup.unbox(pg)
        name = pg.group_name
        if name not in self._groups:
            ranks = tuple(_dist().get_process_group_ranks(pg))
            self._groups[name] = (self._names.get(name), len(ranks), ranks)
        return self._groups[name]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func.namespace == "c10d" and func._opname in _KINDS:
            kind, operand = _KINDS[func._opname]
            names = [a.name for a in func._schema.arguments]
            bound = dict(zip(names, args), **kwargs)
            axis, size, ranks = self._group(bound["process_group"])
            nbytes = sum(t.numel() * t.element_size()
                         for t in _tensors(bound[operand]))
            self.records.append(Collective(
                kind, axis, size, nbytes, _issuer(),
                torch._C._current_graph_task_id() != -1, ranks))
        return func(*args, **kwargs)
