"""Batched serving engine: prefill + decode loop over a fixed batch.

Port of ``repro.serve.engine``: configure once (parameters resident on the
card), then stream requests through — prefill fills the KV caches (and the Mamba
states), ``decode_step`` advances every sequence one token per call,
greedy.  The reference jit-compiles both steps.  Here the decode step is
captured once per batch size as a CUDA graph (``serve.graphs.DecodeGraph``,
``compile="auto"`` on a CUDA device, or ``True``) and replayed over a
static cache that prefill fills in place; ``compile=False``, and
``"auto"`` on the CPU, run it eagerly.  Prefill runs eagerly.  Attention
and the selective scan go through the port's kernels (``use_kernel=False``
selects the plain PyTorch versions instead, for comparison).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..configs.base import ArchConfig
from ..models import LM, build_model, lm
from .graphs import DecodeGraph, resolve_compile


def check_params(cfg: ArchConfig, params: LM) -> None:
    """``params`` must be a model of ``cfg``; only the KV cache's dtype may
    differ (it is the server's choice, not the weights')."""
    if cfg.kv_dtype not in ("compute", "int8"):
        raise ValueError(f"{cfg.name}: unknown kv_dtype {cfg.kv_dtype!r}")
    if dataclasses.replace(params.cfg, kv_dtype=cfg.kv_dtype) != cfg:
        raise ValueError(f"params were built for {params.cfg.name} with "
                         f"other dimensions than the config {cfg.name}")


@dataclasses.dataclass
class ServeEngine:
    cfg: ArchConfig
    max_len: int
    params: Optional[LM] = None
    seed: int = 0
    device: Any = "cuda"
    use_kernel: bool = True
    compile: Any = "auto"

    def __post_init__(self):
        if self.params is None:
            self.params = build_model(self.cfg, self.device, self.seed)
        check_params(self.cfg, self.params)
        self.device = self.params.device
        self._compiled = resolve_compile(self.compile, self.device)
        self.graphs: Dict[int, DecodeGraph] = {}   # by batch size

    def _graph(self, batch: int) -> DecodeGraph:
        """The captured decode step for ``batch`` rows, made at first use."""
        if batch not in self.graphs:
            self.graphs[batch] = DecodeGraph(self.cfg, self.params, batch,
                                             self.max_len, self.use_kernel)
        return self.graphs[batch]

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def generate(self, prompts: np.ndarray, n_tokens: int,
                 embeds: Optional[np.ndarray] = None,
                 eos: Optional[int] = None) -> np.ndarray:
        """prompts (B, S_p) int32 -> generated ids (B, n_tokens)."""
        if embeds is not None:
            raise NotImplementedError("embedding inputs are not ported yet "
                                      "(ROADMAP Queue 1 item 8)")
        model = self.params
        with torch.no_grad():
            tokens = torch.as_tensor(np.asarray(prompts), dtype=torch.int64,
                                     device=self.device)
            if self._compiled:
                graph = self._graph(tokens.shape[0])
                lm.reset_cache(graph.cache)
                logits, _ = lm.prefill(self.cfg, model, tokens, self.max_len,
                                       self.use_kernel, cache=graph.cache)
                step = graph.replay
            else:
                logits, cache = lm.prefill(self.cfg, model, tokens,
                                           self.max_len, self.use_kernel)
                step = lambda tok: lm.decode_step(  # noqa: E731
                    self.cfg, model, cache, tok, self.use_kernel)[0]
            b = logits.shape[0]
            out = np.zeros((b, n_tokens), np.int32)
            done = np.zeros((b,), bool)
            tok = torch.argmax(logits, -1)
            for t in range(n_tokens):
                tok_np = tok.cpu().numpy().astype(np.int32)
                out[:, t] = np.where(done, eos if eos is not None else 0,
                                     tok_np)
                if eos is not None:
                    done |= tok_np == eos
                    if done.all():
                        break
                tok = torch.argmax(step(tok), -1)
        return out

    def throughput_probe(self, batch: int, prompt_len: int,
                         n_tokens: int = 8) -> Dict[str, float]:
        """Tokens/sec measurement harness (the reference's), with the card
        synchronised at the end of each timed call.  The warm-up call
        captures the decode step, so the timed calls replay it."""
        rng = np.random.default_rng(0)
        prompts = rng.integers(0, self.cfg.vocab_size,
                               (batch, prompt_len)).astype(np.int32)
        self.generate(prompts, 2)                        # warm-up
        self._sync()
        t0 = time.monotonic()
        self.generate(prompts, 1)
        self._sync()
        prefill_s = time.monotonic() - t0
        t0 = time.monotonic()
        self.generate(prompts, n_tokens)
        self._sync()
        total_s = time.monotonic() - t0
        decode_s = max(total_s - prefill_s, 1e-9)
        return {"prefill_s": prefill_s,
                "decode_tok_per_s": batch * (n_tokens - 1) / decode_s}
