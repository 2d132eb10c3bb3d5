"""The compiled train step: one training step captured as a CUDA graph and
replayed.

Port of the reference's compiled step: ``Trainer`` jits its train step
with donation, ``jax.jit(make_train_step(...), donate_argnums=0)``
(``src/repro/train/loop.py:79-80``), so XLA runs the forward, the backward
and AdamW as one program.  Here a :class:`TrainGraph` records one step of
a model and its optimizer state (the loss, autograd's backward with the
flash and scan kernels' backwards, AdamW's kernels over the whole tree:
``kernels/adamw.py``) as a ``torch.cuda.CUDAGraph`` and replays it: one
launch from the host for the ~5,000 of an eager llama3.2-3b step.
``Trainer`` (``train.loop``) takes it on a CUDA device by default
(``compile="auto"``, the rule of ``capture.resolve_compile``);
``compile=False`` keeps the eager step, for comparison.

A graph replays the kernels it recorded on the buffers it recorded, so:

* the graph owns static buffers: the batch (``to_device``'s tensors of the
  first batch, (B, S) int64 tokens and labels, (B, S, d) embeddings for the
  VLM, the enc-dec's fields), each replay's batch copied in; the (3,) f32
  ``hyper`` of AdamW (lr, bc1, bc2: ``optim.adamw.hyper_values``), written
  before each replay; the outputs (loss, the aux metrics, ``grad_norm``),
  which the caller reads after a replay and before the next;
* the parameters and moments are the model's and the optimizer state's own
  tensors, updated in place by every replay: a checkpoint restored into
  them (``restore_checkpoint`` copies in place) keeps the graph valid, a
  new model (``Trainer.init_state``) needs a new graph;
* what the step allocates (activations, gradients, the kernels'
  workspaces) comes from the graph's memory pool, the same memory at every
  replay; ``peak_bytes`` is the capture's peak of allocated memory (the
  replays reuse exactly the capture's allocations);
* the warm-up is the trainer's own first ``WARMUP_STEPS`` steps, real
  steps run eagerly on the capture stream (:func:`capture_stream`), which
  build the kernel library and cuBLAS's workspace for that stream.  The
  capture itself runs nothing, so it applies no update that the step
  sequence lacks; the eager and the captured steps are bit-equal, so the
  mix cannot be seen.

The kernels' wrappers count launches in Python, which a replay does not
run: the graph records what the capture counted (``launches``, taken out
of the counters as the capture's own) and adds it at every replay, as
``serve.graphs.DecodeGraph`` does.

No fallback: a capture or a replay that fails raises, and nothing runs the
eager step instead.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, Dict, Iterator

import torch

from ..capture import side_stream
from ..kernels import add_launches, launches_apart

# the trainer's eager steps on the capture stream before it captures
WARMUP_STEPS = 2


def capture_stream(device: torch.device) -> torch.cuda.Stream:
    """The stream on which a trainer's warm-up steps run and its step is
    captured (the serving graphs' side stream of the same device)."""
    return side_stream(device.index if device.index is not None
                       else torch.cuda.current_device())


@contextlib.contextmanager
def on_capture_stream(device: torch.device) -> Iterator[None]:
    """Run the block on :func:`capture_stream`, after the current stream's
    work so far and before its work after the block."""
    stream = capture_stream(device)
    current = torch.cuda.current_stream(device)
    stream.wait_stream(current)
    with torch.cuda.stream(stream):
        yield
    current.wait_stream(stream)


class TrainGraph:
    """``body(batch, hyper) -> metrics`` (one training step of ``model``
    over static buffers: forward, backward, AdamW in place) captured once
    as a CUDA graph.

    Attributes: ``batch`` (the static input, shaped as ``batch``), ``hyper``
    ((3,) f32), ``metrics`` (the static outputs), ``launches`` (kernel
    launches a replay, by name; the capture's own are kept out of the
    counters), ``capture_ms`` (host ms of the capture, synchronised),
    ``peak_bytes`` (allocated memory at the capture's peak)."""

    def __init__(self, model, opt_mu, body: Callable,
                 batch: Dict[str, torch.Tensor]):
        dev = next(model.parameters()).device
        if dev.type != "cuda":
            raise ValueError(f"a CUDA graph needs a CUDA device, the model is "
                             f"on {dev}")
        self.model, self.opt_mu = model, opt_mu
        self.batch = {k: v.to(dev).clone() for k, v in batch.items()}
        self.hyper = torch.zeros((3,), dtype=torch.float32, device=dev)
        self.graph = torch.cuda.CUDAGraph()
        self.launches: Dict[str, int] = {}
        stream = capture_stream(dev)
        t0 = time.perf_counter()
        stream.wait_stream(torch.cuda.current_stream(dev))
        torch.cuda.reset_peak_memory_stats(dev)
        with launches_apart(self.launches), \
                torch.cuda.graph(self.graph, stream=stream):
            self.metrics = body(self.batch, self.hyper)
        torch.cuda.current_stream(dev).wait_stream(stream)
        torch.cuda.synchronize(dev)
        self.capture_ms = (time.perf_counter() - t0) * 1e3
        self.peak_bytes = torch.cuda.max_memory_allocated(dev)

    def owns(self, model, opt_mu) -> bool:
        """Whether this graph steps ``model`` with these moments."""
        return self.model is model and self.opt_mu is opt_mu

    def replay(self, batch: Dict[str, torch.Tensor],
               hyper: list) -> Dict[str, torch.Tensor]:
        """One step on ``batch`` (copied into the static input) with
        ``hyper`` ([lr, bc1, bc2]): the metrics, in the static buffers the
        next replay overwrites."""
        for k, v in batch.items():
            self.batch[k].copy_(v)
        self.hyper.copy_(torch.tensor(hyper, dtype=torch.float32))
        self.graph.replay()
        add_launches(self.launches)
        return self.metrics
