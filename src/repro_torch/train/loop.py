"""Training loop: the train step, eager or captured as a CUDA graph, and a
fault-tolerant loop around it.

Port of ``repro.train.loop``.  The step runs on an explicit device
(``"cuda"`` unless the caller passes ``device="cpu"``): the family's loss
(``models.loss``: every family the reference builds), autograd (on the
card the flash kernels' backward and the selective scan's), then AdamW in
place over the whole tree (``optim.adamw``: on the card the kernels of
``kernels/adamw.py``).  As the reference jits its step, ``Trainer`` on a
CUDA device replays it as a CUDA graph (``train.graphs.TrainGraph``,
``compile="auto"``): its first ``graphs.WARMUP_STEPS`` steps on a model
run eagerly, then it captures one step and replays it.  ``compile=False``
keeps the eager step; ``compile=True`` on the CPU raises.  A config that
asks for ``grad_accum > 1`` or ``grad_compression != "none"`` trains with
the accumulated step (``distributed.overlap.accum_step_body``: the rule of
the reference's ``launch/specs.py::make_cell``), eager or captured by the
same rule; every other config with :func:`step_body`.

**Across ranks.**  Under an ambient ``("data", "model")`` or ``("pod",
"data", "model")`` mesh of more than one rank
(``models.layers.ambient_mesh``), :func:`step_body` runs on every rank of
the mesh (:class:`MeshStep`) on the model built there
(``models.build_model``): with ``attn_shard="default"`` each rank holds
its shards as ``sharding.rules`` lays them out (tensor parallelism over
"model", FSDP's d_model split over "data", every parameter replicated over
"pod"), with ``"seq"`` whole parameters and context parallelism over
"model".  Each (pod, data) rank takes its share of the batch
(``sharding.batch_specs``: the batch over ``("pod", "data")``, pod-major,
the rows ``[r B/n, (r+1) B/n)`` of part r = pod dd + data of n = pods
dd), every rank's loss is scaled by 1 / (pods dd mm) before ``backward``
(every collective's backward is its adjoint), and every gradient is
summed over each mesh dimension its parameter is replicated on, never
over one that splits it, in f32 and rounded once to its dtype.  The sum
is the gradient of the reference's loss, the mean over the global batch.
AdamW then runs ZeRO-1 (``optim.adamw``), which makes those sums itself,
each to the ranks that update it (over "data" a reduce to the owning
data rank or a reduce-scatter, then over "pod" an all-reduce of that
rank's part alone): each rank updates
what its moments cover (cut over "data" only, the same on every pod, as
the reference's ``opt_specs``), the global norm summed over the mesh with
each element counted once, and the owners send the updated parameters to
the other data ranks of their pod, so every copy of a parameter is equal,
bit for bit.  The loss and CE reported are the mean over the batch's
ranks.  Such a step runs
eagerly (``capture.resolve_compile``; its capture on ``nccl`` is ROADMAP
Queue 1 item 10(e)), and the accumulated step does not take a mesh (item
10(f)).

As in the reference: ``AsyncCheckpointer`` every ``ckpt_every`` steps with
the data cursor, ``resume_or_init`` restores parameters, moments, step and
cursor and replays the identical stream; a prefetched input pipeline; a
step-time watchdog that flags slow steps; ``die_at`` injects a failure.
Each step's loss is kept in ``history`` and its global gradient norm in
``grad_norms``, its time in ``step_ms`` (CUDA events around the step on
the card, the host clock on the CPU), whether it was a replay in
``replayed`` and, on the card, in ``peak_bytes`` the step's peak of
allocated memory (for a replay its graph's, the capture's peak).
``TrainState`` holds the model itself (its parameters are trained in
place), the moments keyed by parameter name, and the step.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, Callable, Dict, NamedTuple, Optional

import numpy as np
import torch

from ..capture import resolve_compile
from ..checkpoint import (AsyncCheckpointer, latest_checkpoint,
                          restore_checkpoint)
from ..configs.base import ArchConfig
from ..data import PrefetchLoader, SyntheticLMData
from ..distributed.overlap import (accum_step_body, compression_of,
                                   wants_accum)
from ..models import Model, build_model, loss as model_loss
from ..models import layers as L
from ..models.convert import decayed
from ..models.lm import resolve_device
from ..optim import OptState, adamw_init, cosine_schedule
from ..optim.adamw import adamw_apply, hyper_values
from . import graphs


class TrainState(NamedTuple):
    model: Model
    opt: OptState
    step: int


def to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """A data batch as tensors on ``device``; token ids and labels as
    int64."""
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        if not t.is_floating_point():
            t = t.to(torch.int64)
        out[k] = t.to(device)
    return out


class MeshStep(NamedTuple):
    """A train step across the ranks of the ambient mesh: ``mesh``, the
    parts its batch splits into ``data`` (pods x data ranks) and this
    rank's part ``data_rank`` (pod-major), its ranks ``ranks`` (pods x data
    x model), and ``groups``, the groups of its dimensions above one,
    "model" first, then "data" and "pod", named in ``names``."""
    mesh: Any
    data: int
    data_rank: int
    ranks: int
    groups: tuple
    names: tuple

    def shard(self, batch: Dict[str, torch.Tensor]) -> Dict[str,
                                                            torch.Tensor]:
        """This rank's rows of every tensor of ``batch`` (dim 0), as
        ``sharding.batch_specs`` lays them out: split over ("pod", "data")
        where it divides the rows, else every rank's whole."""
        from ..sharding.rules import batch_specs, mesh_sizes
        specs = batch_specs(None, batch, mesh_sizes(self.mesh))
        return {k: v.chunk(self.data, 0)[self.data_rank]
                if specs[k] and specs[k][0] is not None else v
                for k, v in batch.items()}

    @torch.no_grad()
    def reduce_grads(self, params: Dict[str, torch.Tensor]) -> None:
        """Every parameter's gradient summed over each mesh dimension the
        parameter is replicated on ("model", then "data", then "pod"),
        never over one that splits it (a rank's shard's gradient is its
        own; an FSDP shard's came back summed over "data" by the gather's
        adjoint): in f32 over each group in turn, rounded once to its dtype
        (a bf16 sum over ranks would round at every add), one tensor at a
        time.  A parameter the loss does not reach has no gradient on any
        rank and is skipped."""
        from ..distributed import comm
        from ..sharding.rules import spec_axes
        for p in params.values():
            if p.grad is None:
                continue
            split = spec_axes(L._spec(p))
            groups = [g for n, g in zip(self.names, self.groups)
                      if n not in split]
            if not groups:
                continue
            g = p.grad.to(torch.float32)
            for group in groups:
                g = comm.all_reduce(g, group)
            p.grad = g.to(p.grad.dtype)

    @torch.no_grad()
    def mean_over_data(self, t: torch.Tensor) -> torch.Tensor:
        """``t``'s mean over the batch's ranks, "data" and "pod" (a model
        rank's loss is every model rank's)."""
        if self.data == 1:
            return t
        from ..distributed import comm
        for n, g in zip(self.names, self.groups):
            if n != "model":
                t = comm.all_reduce(t, g)
        return t / self.data


def mesh_step() -> Optional[MeshStep]:
    """The :class:`MeshStep` of the ambient mesh, or None without one or
    with one rank.  A mesh dimension above one other than "pod", "data"
    and "model" raises."""
    mesh = L._ambient_mesh()
    if mesh is None:
        return None
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    other = {n: s for n, s in sizes.items()
             if n not in ("pod", "data", "model") and s > 1}
    if other:
        raise ValueError(f"a train step runs across 'pod', 'data' and "
                         f"'model' only; the ambient mesh also has {other}")
    pp, dd, mm = (sizes.get(n, 1) for n in ("pod", "data", "model"))
    if pp * dd * mm == 1:
        return None
    names = tuple(n for n in ("model", "data", "pod") if sizes.get(n, 1) > 1)
    rank = {n: mesh.get_local_rank(n) if sizes.get(n, 1) > 1 else 0
            for n in ("pod", "data")}
    return MeshStep(mesh=mesh, data=pp * dd,
                    data_rank=rank["pod"] * dd + rank["data"],
                    ranks=pp * dd * mm,
                    groups=tuple(mesh.get_group(n) for n in names),
                    names=names)


def loss_and_grads(cfg, model, batch, *, summed: bool = True):
    """The loss and its gradients (in ``.grad``): on this rank alone, or
    across the ambient mesh's ranks (:class:`MeshStep`), each gradient
    summed over the mesh dimensions its parameter is replicated on
    (``MeshStep.reduce_grads``); with ``summed`` False left as this rank's
    part of that sum, which ZeRO-1's step sums to the ranks that update it
    (``optim.adamw``).  Returns (loss, metrics), detached."""
    across = mesh_step()
    if across is None:
        loss, metrics = model_loss(cfg, model, batch)
        loss.backward()
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}
    # the backward inside the mesh too: remat recomputes under it
    with L.ambient_mesh(across.mesh):
        loss, metrics = model_loss(cfg, model, across.shard(batch))
        (loss / across.ranks).backward()
    if summed:
        across.reduce_grads(dict(model.named_parameters()))
    return across.mean_over_data(loss.detach()), {
        "ce": across.mean_over_data(metrics["ce"].detach()),
        "aux": metrics["aux"].detach()}


def step_body(model: Model, opt: OptState, *,
              weight_decay: float = 0.1) -> Callable:
    """``body(batch, hyper) -> metrics``: one step of ``model`` with the
    moments of ``opt``, all on the device: the loss and its gradients, then
    AdamW over every parameter in place, lr and the bias corrections read
    from ``hyper`` ((3,) f32: ``optim.adamw.hyper_values``).  A parameter
    the loss does not reach (a VLM's input embedding) has no gradient and
    counts as a zero gradient, as under ``jax.grad``; nothing is allocated
    for it.  The eager step and the captured one (``graphs.TrainGraph``)
    both run it.  Under an ambient mesh of more than one rank the loss and
    its gradients are the mesh's (the module docstring, "Across
    ranks")."""
    cfg = model.cfg
    params = dict(model.named_parameters())
    decay = decayed(model)

    def body(batch, hyper):
        for p in params.values():
            p.grad = None
        loss, metrics = loss_and_grads(cfg, model, batch,
                                       summed=model.shards is None)
        grads = {n: p.grad for n, p in params.items()}
        gnorm = adamw_apply(grads, opt, params, hyper,
                            weight_decay=weight_decay, decayed=decay,
                            shards=model.shards)
        del grads
        for p in params.values():
            p.grad = None
        return {"loss": loss, **metrics, "grad_norm": gnorm}

    return body


def train_body(model: Model, opt: OptState, *,
               weight_decay: float = 0.1) -> Callable:
    """The step body ``model``'s config trains with: the accumulated one
    (``grad_accum`` micro-batches, ``grad_compression``) where the config
    asks for it, else :func:`step_body`.  The accumulated step under an
    ambient mesh of more than one rank raises (ROADMAP Queue 1 item
    10(f))."""
    cfg = model.cfg
    if wants_accum(cfg):
        if mesh_step() is not None:
            raise NotImplementedError(
                f"{cfg.name}: the accumulated step (grad_accum="
                f"{cfg.grad_accum}, grad_compression="
                f"{cfg.grad_compression!r}) across the ranks of a mesh is "
                f"not ported yet (ROADMAP Queue 1 item 10(f))")
        return accum_step_body(model, opt, max(cfg.grad_accum, 1),
                               compression_of(cfg),
                               weight_decay=weight_decay)
    return step_body(model, opt, weight_decay=weight_decay)


def step_hyper(state: TrainState, *, peak_lr: float,
               total_steps: int = 10_000) -> tuple:
    """(lr, count, hyper) of the step after ``state``: the schedule's lr
    (``cosine_schedule``, host f32 as the reference's), the moments' new
    count, and ``[lr, bc1, bc2]`` (``optim.adamw.hyper_values``), what the
    step's device buffer holds."""
    lr = cosine_schedule(state.step, peak_lr=peak_lr, total=total_steps)
    count = state.opt.count + 1
    return lr, count, hyper_values(count, lr)


def make_train_step(model: Model, *, peak_lr: float = 3e-4,
                    total_steps: int = 10_000,
                    weight_decay: float = 0.1,
                    body: Callable = train_body) -> Callable:
    """(state, batch) -> (state, metrics), eagerly: the step body that
    ``body(model, opt, weight_decay=...)`` builds (by default
    :func:`train_body`: :func:`step_body`, or the accumulated step where
    the config asks for it; built once for the moments it is given first,
    and again only for others) with this step's :func:`step_hyper` written
    to a new device buffer."""
    built: list = [None, None]          # the moments, the body built on them

    def train_step(state: TrainState, batch) -> tuple:
        if built[0] is not state.opt.mu:
            built[:] = [state.opt.mu, body(
                model, state.opt, weight_decay=weight_decay)]
        lr, count, hyper = step_hyper(state, peak_lr=peak_lr,
                                      total_steps=total_steps)
        metrics = built[1](batch, torch.tensor(
            hyper, dtype=torch.float32,
            device=next(model.parameters()).device))
        out = {"loss": metrics.pop("loss"), "lr": lr, **metrics}
        opt = OptState(state.opt.mu, state.opt.nu, count)
        return TrainState(model, opt, state.step + 1), out

    return train_step


@dataclasses.dataclass
class Trainer:
    """End-to-end loop around the train step, on ``device``; on a CUDA
    device the step is replayed from a CUDA graph unless ``compile`` is
    False (``capture.resolve_compile``'s rule).  Run under an ambient mesh
    (``models.layers.ambient_mesh``) on every rank of it, the step runs
    across the mesh, eagerly (the module docstring, "Across ranks"); each
    rank reads the same global batches from ``seed``."""

    cfg: ArchConfig
    batch: int
    seq_len: int
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 50
    seed: int = 0
    peak_lr: float = 3e-4
    watchdog_factor: float = 10.0      # step > factor x median => flagged
    delay_fn: Optional[Callable] = None
    device: str = "cuda"
    compile: Any = "auto"

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self.compiled = resolve_compile(self.compile, self.device)
        self.model: Optional[Model] = None
        self.data = SyntheticLMData(
            self.cfg.vocab_size, self.batch, self.seq_len, self.seed,
            embed_dim=self.cfg.d_model if self.cfg.embed_inputs else 0,
            encdec=self.cfg.is_encdec)
        self.ckpt = (AsyncCheckpointer(self.ckpt_dir)
                     if self.ckpt_dir else None)
        self.slow_steps: list = []
        self.history: list = []
        self.grad_norms: list = []
        self.step_ms: list = []
        self.peak_bytes: list = []
        self.replayed: list = []
        # the captured step, and the eager steps run on the capture stream
        # for the model and moments they belong to
        self.graph: Optional[graphs.TrainGraph] = None
        self._warm: tuple = (None, None, 0)

    def init_state(self) -> TrainState:
        """Fresh parameters from ``seed``, trainable (a model is built frozen,
        for serving), and zero moments; the previous state's model and
        graph are dropped first."""
        self.model = None
        self.graph = None
        self._warm = (None, None, 0)
        self.model = build_model(self.cfg, self.device,
                                 self.seed).requires_grad_(True)
        opt = adamw_init(dict(self.model.named_parameters()),
                         self.cfg.adam_dtype, self.model.shards)
        return TrainState(self.model, opt, 0)

    def resume_or_init(self) -> TrainState:
        state = self.init_state()
        if self.ckpt_dir:
            path = latest_checkpoint(self.ckpt_dir)
            if path:
                restored, extra = restore_checkpoint(path, state)
                if extra and "data" in extra:
                    self.data.load_state_dict(extra["data"])
                return restored
        return state

    def _graph_for(self, state: TrainState, batch) -> Optional[
            graphs.TrainGraph]:
        """The captured step for ``state``'s model and moments: captured
        here once ``graphs.WARMUP_STEPS`` eager steps have run on them
        (on ``batch``'s shapes), else None (the step runs eagerly on the
        capture stream)."""
        model, mu = state.model, state.opt.mu
        if self.graph is not None and self.graph.owns(model, mu):
            return self.graph
        self.graph = None
        m, u, warm = self._warm
        if m is not model or u is not mu:
            self._warm = (model, mu, 0)
            return None
        if warm < graphs.WARMUP_STEPS:
            return None
        self._warm = (None, None, 0)
        self.graph = graphs.TrainGraph(
            model, mu, train_body(model, state.opt), to_device(batch,
                                                               self.device))
        return self.graph

    def run(self, n_steps: int, state: Optional[TrainState] = None,
            die_at: Optional[int] = None) -> TrainState:
        """Train ``n_steps`` more steps.  ``die_at`` injects a failure
        (raises) at that global step: the fault-tolerance tests use it."""
        if state is None:
            state = self.resume_or_init()
        self.model = state.model
        step_fn = make_train_step(state.model, peak_lr=self.peak_lr)
        across = mesh_step()
        compiled = self.compiled if across is None else resolve_compile(
            self.compile, self.device, across.ranks)
        loader = PrefetchLoader(self.data, deadline_s=None,
                                delay_fn=self.delay_fn)
        times: list = []
        cuda = self.device.type == "cuda"
        try:
            for _ in range(n_steps):
                gstep = int(state.step)
                if die_at is not None and gstep == die_at:
                    raise RuntimeError(f"injected failure at step {gstep}")
                data_step, batch = loader.next()
                graph = self._graph_for(state, batch) if compiled else None
                warm = compiled and graph is None
                with (graphs.on_capture_stream(self.device) if warm
                      else contextlib.nullcontext()):
                    if cuda:
                        torch.cuda.reset_peak_memory_stats(self.device)
                        events = [torch.cuda.Event(enable_timing=True)
                                  for _ in range(2)]
                        events[0].record()
                    t0 = time.monotonic()
                    if graph is not None:
                        _, count, hyper = step_hyper(state,
                                                     peak_lr=self.peak_lr)
                        metrics = graph.replay(to_device(batch, "cpu"),
                                               hyper)
                        state = TrainState(state.model, OptState(
                            state.opt.mu, state.opt.nu, count), gstep + 1)
                    else:
                        state, metrics = step_fn(
                            state, to_device(batch, self.device))
                    if cuda:
                        events[1].record()
                if warm:
                    m, u, n = self._warm
                    self._warm = (m, u, n + 1)
                loss = float(metrics["loss"])
                took = time.monotonic() - t0
                self.grad_norms.append(float(metrics["grad_norm"]))
                if cuda:
                    self.step_ms.append(events[0].elapsed_time(events[1]))
                    self.peak_bytes.append(
                        graph.peak_bytes if graph is not None else
                        torch.cuda.max_memory_allocated(self.device))
                else:
                    self.step_ms.append(took * 1e3)
                self.replayed.append(graph is not None)
                times.append(took)
                med = float(np.median(times))
                if len(times) > 5 and took > self.watchdog_factor * med:
                    self.slow_steps.append((gstep, took))  # watchdog flag
                self.history.append(loss)
                if (self.ckpt and (gstep + 1) % self.ckpt_every == 0):
                    # cursor = last *consumed* step + 1 (the prefetch queue
                    # runs ahead; replay must restart after what we used)
                    cursor = {"step": data_step + 1, "seed": self.data.seed}
                    self.ckpt.save(gstep + 1, state, {"data": cursor})
        finally:
            loader.close()
            if self.ckpt:
                self.ckpt.wait()
        return state
