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

As in the reference, a model with embedding inputs takes ``embeds`` (B,
S, d) in :meth:`ServeEngine.generate`: the VLM family prefills from them and
feeds its decode steps the embeddings of its tokens (``embed[tok]``); an
enc-dec encodes them and prefills its decoder from the token prompts.  An
enc-dec's captured step is keyed by (B, S_enc), the shape of its cross
cache.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..capture import resolve_compile
from ..configs.base import ArchConfig
from ..models import (Model, build_model, decode_step, encoder_frames,
                      prefill, reset_cache, step_input)
from .graphs import DecodeGraph


def check_params(cfg: ArchConfig, params: Model) -> None:
    """``params`` must be a model of ``cfg``; only the KV cache's dtype may
    differ (it is the server's choice, not the weights')."""
    if cfg.kv_dtype not in ("compute", "int8"):
        raise ValueError(f"{cfg.name}: unknown kv_dtype {cfg.kv_dtype!r}")
    if dataclasses.replace(params.cfg, kv_dtype=cfg.kv_dtype) != cfg:
        raise ValueError(f"params were built for {params.cfg.name} with "
                         f"other dimensions than the config {cfg.name}")


def prefill_batch(cfg: ArchConfig, prompts, embeds,
                  device) -> Dict[str, torch.Tensor]:
    """The reference's prefill batch on ``device``: ``tokens`` (B, S)
    int64, or ``embeds`` (B, S, d) for the VLM family, or both for an
    enc-dec."""
    batch = {}
    if cfg.embed_inputs:
        if embeds is None:
            raise ValueError(f"{cfg.name} takes embedding inputs: pass "
                             f"embeds (B, S, {cfg.d_model})")
        batch["embeds"] = torch.as_tensor(np.asarray(embeds), device=device)
    if not cfg.embed_inputs or cfg.is_encdec:
        batch["tokens"] = torch.as_tensor(np.asarray(prompts),
                                          dtype=torch.int64, device=device)
    return batch


@dataclasses.dataclass
class ServeEngine:
    cfg: ArchConfig
    max_len: int
    params: Optional[Model] = None
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
        # by (batch size, encoder frames): 0 frames for a decoder
        self.graphs: Dict[Any, DecodeGraph] = {}

    def _graph(self, batch: int, enc_len: int) -> DecodeGraph:
        """The captured decode step for ``batch`` rows over ``enc_len``
        encoder frames (0 for a decoder), made at first use."""
        key = (batch, enc_len)
        if key not in self.graphs:
            self.graphs[key] = DecodeGraph(self.cfg, self.params, batch,
                                           self.max_len, self.use_kernel,
                                           enc_len)
        return self.graphs[key]

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def generate(self, prompts: np.ndarray, n_tokens: int,
                 embeds: Optional[np.ndarray] = None,
                 eos: Optional[int] = None) -> np.ndarray:
        """prompts (B, S_p) int32 -> generated ids (B, n_tokens).  A model
        with embedding inputs also takes ``embeds`` (B, S, d) (the VLM
        family prefills from them alone)."""
        cfg, model = self.cfg, self.params
        with torch.no_grad():
            batch = prefill_batch(cfg, prompts, embeds, self.device)
            b = next(iter(batch.values())).shape[0]
            if self._compiled:
                graph = self._graph(b, encoder_frames(cfg, batch))
                reset_cache(cfg, graph.cache)
                logits, _ = prefill(cfg, model, batch, self.max_len,
                                    self.use_kernel, cache=graph.cache)
                step = graph.replay
            else:
                logits, cache = prefill(cfg, model, batch, self.max_len,
                                        self.use_kernel)
                step = lambda x: decode_step(  # noqa: E731
                    cfg, model, cache, x, self.use_kernel)[0]
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
                tok = torch.argmax(step(step_input(cfg, model, tok)), -1)
        return out

    def throughput_probe(self, batch: int, prompt_len: int,
                         n_tokens: int = 8) -> Dict[str, float]:
        """Tokens/sec measurement harness (the reference's), with the card
        synchronised at the end of each timed call.  The warm-up call
        captures the decode step, so the timed calls replay it.  A model
        with embedding inputs gets the reference's standard-normal
        embeddings (B, prompt_len, d) from the same generator."""
        rng = np.random.default_rng(0)
        prompts = rng.integers(0, self.cfg.vocab_size,
                               (batch, prompt_len)).astype(np.int32)
        embeds = None
        if self.cfg.embed_inputs:
            embeds = rng.standard_normal(
                (batch, prompt_len, self.cfg.d_model)).astype(np.float32)
        self.generate(prompts, 2, embeds=embeds)         # warm-up
        self._sync()
        t0 = time.monotonic()
        self.generate(prompts, 1, embeds=embeds)
        self._sync()
        prefill_s = time.monotonic() - t0
        t0 = time.monotonic()
        self.generate(prompts, n_tokens, embeds=embeds)
        self._sync()
        total_s = time.monotonic() - t0
        decode_s = max(total_s - prefill_s, 1e-9)
        return {"prefill_s": prefill_s,
                "decode_tok_per_s": batch * (n_tokens - 1) / decode_s}
