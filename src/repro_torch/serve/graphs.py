"""The compiled serving step: ``lm.decode_step`` captured once as a CUDA
graph and replayed.

Port of the reference's ``jax.jit`` of the serving step:
``repro.serve.engine`` compiles ``decode_step`` and ``prefill`` once per
engine (``src/repro/serve/engine.py:32-36``), and ``repro.serve.scheduler``
compiles the batched ``decode_step`` and one prefill per prompt bucket
(``src/repro/serve/scheduler.py:74-90``).  Here a :class:`DecodeGraph`
records one decode step of a model for one (B, max_len) as a
``torch.cuda.CUDAGraph`` and replays it: one launch from the host instead
of one per operation of every layer.  ``ServeEngine`` and
``ContinuousBatcher`` take it on a CUDA device by default
(:func:`resolve_compile`); ``compile=False`` keeps the eager step, for
comparison.  :class:`PrefillGraph` does the same for the batcher's
single-prompt prefill of one bucket; the engine's batched prefill runs
eagerly (on an H100 it keeps the card busy on its own: PERF.md).

A graph replays the kernels it recorded on the buffers it recorded, so:

* the graph owns its static buffers: the token buffer (B,) int64, the
  decode cache (``lm.init_cache``'s, on which the step writes K/V and
  Mamba states and advances ``length`` in place) and the logits (B, V) f32
  that every replay overwrites.  Callers fill the cache (``lm.prefill(...,
  cache=graph.cache)``, a batcher's slot writes) and copy the step's
  tokens in through :meth:`DecodeGraph.replay`;
* the warm-up (a few eager steps on a side stream, as PyTorch's recipe for
  CUDA graphs asks: the kernel library is built and loaded, the model's
  f32 unembedding made, cuBLAS's workspace allocated) and the capture run
  on the graph's own cache, which is then reset: never on a request's;
* what the step allocates (activations, each decode call's workspace)
  comes from the graph's memory pool and is the same memory at every
  replay.  A batcher's graphs, which replay one at a time on one stream,
  share one pool, and its bucket prefills one cache;
* the kernels launch through ctypes on ``torch.cuda.current_stream``, the
  capture stream while capturing, so the graph records them; their launch
  code (``cudaFuncSetAttribute`` and ``cudaGetLastError`` at every
  launch) is legal under PyTorch's strictest capture mode (``global``);
* the weights are read where they were at capture: a model whose weights
  change needs a new graph.

The kernels' wrappers count launches in Python (``LAUNCHES`` of each
kernel module, moved together by ``repro_torch.kernels.add_launches`` and
``launches_apart``), which a replay does not run.  The graph records what the
capture counted and adds it at every replay; the warm-up's and the
capture's own launches are kept apart, in :attr:`DecodeGraph.setup_launches`,
so ``LAUNCHES`` counts what the card ran for the caller, as on the eager
path.

No fallback: a capture or a replay that fails raises, and nothing runs the
eager step instead.  Graphs need a CUDA device; on the CPU the engines run
eagerly (``compile="auto"``) or refuse (``compile=True``).
"""

from __future__ import annotations

import functools
import time
from typing import Any, Dict, Optional

import torch

from ..configs.base import ArchConfig
from ..kernels import add_launches, launches_apart
from ..models import LM, lm

# eager steps before the capture
WARMUP_STEPS = 2


def resolve_compile(compile: Any, device: torch.device) -> bool:
    """Whether an engine on ``device`` replays a captured step: ``"auto"``
    on a CUDA device, ``True`` (a CUDA device or ValueError), ``False``
    never."""
    if compile == "auto":
        return device.type == "cuda"
    if compile is True:
        if device.type != "cuda":
            raise ValueError(f"compile=True needs a CUDA device (the step is "
                             f"captured as a CUDA graph), got {device}")
        return True
    if compile is False:
        return False
    raise ValueError(f"compile must be 'auto', True or False, got "
                     f"{compile!r}")


@functools.lru_cache(maxsize=None)
def _side_stream(index: int) -> torch.cuda.Stream:
    """The one stream of device ``index`` on which every graph warms up and
    is captured: the allocator hands a freed block again only on the
    stream it was allocated on, so graphs that share a memory pool reuse
    each other's blocks only if they were captured on one stream."""
    return torch.cuda.Stream(torch.device("cuda", index))


class _CapturedStep:
    """One step of a model captured as a CUDA graph over buffers it owns:
    ``tokens`` (the static input), ``cache``, ``logits`` (the static
    output).  A subclass makes ``tokens`` and ``cache`` and gives
    :meth:`_step`; :meth:`_capture` warms up, captures (into ``pool``, a
    graph's memory pool, or a private one) and resets the cache."""

    def _capture(self, model: LM, pool: Optional[Any] = None) -> None:
        dev = model.device
        self.graph = torch.cuda.CUDAGraph()
        self.launches: Dict[str, int] = {}
        self.setup_launches: Dict[str, int] = {}
        t0 = time.perf_counter()
        stream = _side_stream(dev.index if dev.index is not None
                              else torch.cuda.current_device())
        with torch.no_grad():
            model.unembed_f32()           # made before capture, kept after
            stream.wait_stream(torch.cuda.current_stream(dev))
            with launches_apart(self.setup_launches), \
                    torch.cuda.stream(stream):
                for _ in range(WARMUP_STEPS):
                    self._step()
            torch.cuda.current_stream(dev).wait_stream(stream)
            with launches_apart(self.launches), \
                    torch.cuda.graph(self.graph, pool=pool, stream=stream):
                self.logits = self._step()
            for name, n in self.launches.items():
                self.setup_launches[name] += n
            lm.reset_cache(self.cache)
        torch.cuda.synchronize(dev)
        self.capture_ms = (time.perf_counter() - t0) * 1e3

    def _step(self) -> torch.Tensor:
        raise NotImplementedError

    def replay(self, tokens: torch.Tensor) -> torch.Tensor:
        """The step on ``tokens`` (copied into the static input): the
        logits, in the static buffer the next replay overwrites."""
        self.tokens.copy_(tokens)
        self.graph.replay()
        add_launches(self.launches)
        return self.logits


def _check_cuda(model: LM) -> torch.device:
    if model.device.type != "cuda":
        raise ValueError(f"a CUDA graph needs a CUDA device, the model is "
                         f"on {model.device}")
    return model.device


class DecodeGraph(_CapturedStep):
    """``lm.decode_step`` of ``model`` for ``batch`` rows of ``max_len``
    positions, captured once as a CUDA graph over a cache the graph owns.

    Attributes: ``cache`` (the static decode cache, reset after capture),
    ``tokens`` (B,) and ``logits`` (B, V) (the static input and output),
    ``launches`` (kernel launches per replay, by name), ``setup_launches``
    (the warm-up's and the capture's, counted apart from ``LAUNCHES``),
    ``capture_ms`` (host ms of warm-up and capture, synchronised).
    :meth:`replay` runs one step over :attr:`cache`."""

    def __init__(self, cfg: ArchConfig, model: LM, batch: int,
                 max_len: int, use_kernel: bool = True):
        dev = _check_cuda(model)
        self.cfg, self.model, self.use_kernel = cfg, model, use_kernel
        self.cache = lm.init_cache(cfg, batch, max_len, dev)
        self.tokens = torch.zeros((batch,), dtype=torch.int64, device=dev)
        self._capture(model)

    def _step(self) -> torch.Tensor:
        logits, _ = lm.decode_step(self.cfg, self.model, self.cache,
                                   self.tokens, self.use_kernel)
        return logits


class PrefillGraph(_CapturedStep):
    """``lm.prefill`` of ``model`` for ``batch`` prompts of ``seq`` tokens
    into a cache of ``max_len`` positions, captured once as a CUDA graph: a
    batcher's prefill of one prompt bucket.  Attributes as
    :class:`DecodeGraph`'s, ``tokens`` (B, seq) and ``logits`` (B, V) the
    last position's.  A replay resets :attr:`cache` and writes the
    prompt's state into it, so it ends as a fresh ``lm.prefill``'s.

    ``cache`` (``lm.init_cache``'s for ``batch`` and ``max_len``) and
    ``pool`` (another graph's ``graph.pool()``) let the graphs of one
    batcher share their cache and memory pool; they replay one at a time,
    on one stream.  Without them the graph makes its own."""

    def __init__(self, cfg: ArchConfig, model: LM, batch: int, seq: int,
                 max_len: int, use_kernel: bool = True,
                 cache: Optional[Dict] = None, pool: Optional[Any] = None):
        dev = _check_cuda(model)
        self.cfg, self.model, self.use_kernel = cfg, model, use_kernel
        self.max_len = max_len
        self.cache = cache if cache is not None else \
            lm.init_cache(cfg, batch, max_len, dev)
        self.tokens = torch.zeros((batch, seq), dtype=torch.int64,
                                  device=dev)
        self._capture(model, pool)

    def _step(self) -> torch.Tensor:
        lm.reset_cache(self.cache)
        logits, _ = lm.prefill(self.cfg, self.model, self.tokens,
                               self.max_len, self.use_kernel, cache=self.cache)
        return logits
