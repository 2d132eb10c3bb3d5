"""Training loop: an eager train step and a fault-tolerant loop around it.

Port of ``repro.train.loop``.  The step runs eagerly on an explicit device
(``"cuda"`` unless the caller passes ``device="cpu"``): the family's loss
(``models.loss``: every family the reference builds), autograd (on the
card the flash kernels' backward and the selective scan's), then AdamW in
place.  A CUDA graph of the step is later work.

As in the reference: ``AsyncCheckpointer`` every ``ckpt_every`` steps with
the data cursor, ``resume_or_init`` restores parameters, moments, step and
cursor and replays the identical stream; a prefetched input pipeline; a
step-time watchdog that flags slow steps; ``die_at`` injects a failure.
Each step's time is kept in ``step_ms`` (CUDA events around the step on
the card, the host clock on the CPU) and, on the card, the peak of
allocated memory so far in ``peak_bytes``.
``TrainState`` holds the model itself (its parameters are trained in
place), the moments keyed by parameter name, and the step.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, NamedTuple, Optional

import numpy as np
import torch

from ..checkpoint import (AsyncCheckpointer, latest_checkpoint,
                          restore_checkpoint)
from ..configs.base import ArchConfig
from ..data import PrefetchLoader, SyntheticLMData
from ..models import Model, build_model, loss as model_loss
from ..models.convert import decayed
from ..models.lm import resolve_device
from ..optim import OptState, adamw_init, adamw_update, cosine_schedule


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


def make_train_step(model: Model, *, peak_lr: float = 3e-4,
                    total_steps: int = 10_000,
                    weight_decay: float = 0.1) -> Callable:
    """(state, batch) -> (state, metrics): the loss and its gradients, then
    AdamW over every parameter (in place).  A parameter the loss does not
    reach (a VLM's input embedding) gets a zero gradient, as under
    ``jax.grad``."""
    cfg = model.cfg
    params = dict(model.named_parameters())
    decay = decayed(model)

    def train_step(state: TrainState, batch) -> tuple:
        for p in params.values():
            p.grad = None
        loss, metrics = model_loss(cfg, model, batch)
        loss.backward()
        grads = {n: p.grad if p.grad is not None else torch.zeros_like(p)
                 for n, p in params.items()}
        lr = cosine_schedule(state.step, peak_lr=peak_lr, total=total_steps)
        opt, opt_metrics = adamw_update(grads, state.opt, params, lr,
                                        weight_decay=weight_decay,
                                        decayed=decay)
        del grads
        for p in params.values():
            p.grad = None
        out = {"loss": loss.detach(), "lr": lr,
               **{k: v.detach() for k, v in metrics.items()}, **opt_metrics}
        return TrainState(model, opt, state.step + 1), out

    return train_step


@dataclasses.dataclass
class Trainer:
    """End-to-end loop around the train step, on ``device``."""

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

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self.model: Optional[Model] = None
        self.data = SyntheticLMData(
            self.cfg.vocab_size, self.batch, self.seq_len, self.seed,
            embed_dim=self.cfg.d_model if self.cfg.embed_inputs else 0,
            encdec=self.cfg.is_encdec)
        self.ckpt = (AsyncCheckpointer(self.ckpt_dir)
                     if self.ckpt_dir else None)
        self.slow_steps: list = []
        self.history: list = []
        self.step_ms: list = []
        self.peak_bytes: list = []

    def init_state(self) -> TrainState:
        """Fresh parameters from ``seed``, trainable (a model is built frozen,
        for serving), and zero moments; the previous state's model is
        dropped first."""
        self.model = None
        self.model = build_model(self.cfg, self.device,
                                 self.seed).requires_grad_(True)
        opt = adamw_init(dict(self.model.named_parameters()),
                         self.cfg.adam_dtype)
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

    def run(self, n_steps: int, state: Optional[TrainState] = None,
            die_at: Optional[int] = None) -> TrainState:
        """Train ``n_steps`` more steps.  ``die_at`` injects a failure
        (raises) at that global step: the fault-tolerance tests use it."""
        if state is None:
            state = self.resume_or_init()
        self.model = state.model
        step_fn = make_train_step(state.model, peak_lr=self.peak_lr)
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
                batch = to_device(batch, self.device)
                if cuda:
                    events = [torch.cuda.Event(enable_timing=True)
                              for _ in range(2)]
                    events[0].record()
                t0 = time.monotonic()
                state, metrics = step_fn(state, batch)
                if cuda:
                    events[1].record()
                loss = float(metrics["loss"])
                took = time.monotonic() - t0
                if cuda:
                    self.step_ms.append(events[0].elapsed_time(events[1]))
                    self.peak_bytes.append(torch.cuda.max_memory_allocated(
                        self.device))
                else:
                    self.step_ms.append(took * 1e3)
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
