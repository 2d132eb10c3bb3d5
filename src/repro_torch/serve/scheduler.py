"""Continuous batching: admit requests into free decode slots mid-flight.

Port of ``repro.serve.scheduler``: a fixed-slot decode batch where finished
sequences free their slot for the next queued request.

  * one single-sequence prefill per request, over the prompt padded to its
    length *bucket* (the reference's buckets, so shapes and results match
    it), writes the request's KV/SSM state into its slot of the live cache;
    the padding's K/V stay in the cache, masked, and the slot's length is
    the true prompt length.  A Mamba layer's conv and SSM states are taken
    after the padding, as in the reference (no mask reaches them).  On a
    CUDA device the prefill of a bucket up to ``PREFILL_GRAPH_MAX_BUCKET``
    is captured at its first use (``serve.graphs.PrefillGraph``, the
    reference's jitted prefill per bucket) and replayed; the bucket graphs
    share one single-sequence cache and, with the decode graph, one memory
    pool;
  * one batched ``decode_step`` advances every slot: on a CUDA device a
    replay of the step captured over the live cache at construction, while
    no slot is live (``serve.graphs.DecodeGraph``, the reference's jitted
    ``decode_step``; ``compile=False`` runs it eagerly);
  * per-slot lengths come from the cache's ``length`` vector.

As in the reference, decode is seeded with the prompt's last token, so that
token is processed twice (in prefill and at position ``len(prompt)``); this
is kept, since changing it changes every token.

Determinism invariant (tested for the dense and Mamba models): a request's
output is identical whether it ran alone or was co-scheduled with arbitrary
other traffic.  It cannot hold for MoE models, in the reference either:
decode routes every slot's token as one group, and the experts' capacity
couples the rows.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..configs.base import ArchConfig
from ..models import LM, build_model, lm
from ..runtime.runtime import Request
from .engine import check_params
from .graphs import DecodeGraph, PrefillGraph, resolve_compile

# the largest prompt bucket whose prefill is captured: an eager B = 1
# bucket prefill left the card idle for more than half its wall time up to
# bucket 512 for both llama3.2-3b and falcon-mamba-7b on an H100 (at 1024
# falcon-mamba's was below half; PERF.md); larger buckets run eagerly
PREFILL_GRAPH_MAX_BUCKET = 512


def _buckets(n: int, sizes=(16, 32, 64, 128, 256, 512, 1024, 2048, 4096)):
    for s in sizes:
        if n <= s:
            return s
    return sizes[-1]


class ContinuousBatcher:
    """Slot-based continuous batching over a fixed decode batch."""

    def __init__(self, cfg: ArchConfig, n_slots: int, max_len: int,
                 params: Optional[LM] = None, eos: Optional[int] = None,
                 seed: int = 0, device: Any = "cuda",
                 use_kernel: bool = True, compile: Any = "auto"):
        self.cfg = cfg
        self.n_slots = n_slots
        self.max_len = max_len
        self.eos = eos
        self.use_kernel = use_kernel
        self.params = params if params is not None else \
            build_model(cfg, device, seed)
        check_params(cfg, self.params)
        self.model = self.params
        self.device = self.model.device
        # the captured step owns the live cache; it was reset after capture
        self.graph: Optional[DecodeGraph] = None
        self.prefill_graphs: Dict[int, PrefillGraph] = {}   # by bucket
        if resolve_compile(compile, self.device):
            self.graph = DecodeGraph(cfg, self.model, n_slots, max_len,
                                     use_kernel)
            self.cache = self.graph.cache
            self._prefill_cache = lm.init_cache(cfg, 1, max_len, self.device)
        else:
            self.cache = lm.init_cache(cfg, n_slots, max_len, self.device)
        self.slots: List[Optional[Request]] = [None] * n_slots
        self.queue: List[Request] = []
        self.last_tok = np.zeros((n_slots,), np.int32)
        self.stats = {"steps": 0, "prefills": 0, "slot_busy_ticks": 0}

    # ------------------------------------------------------------ plumbing
    def _prefill(self, tokens: torch.Tensor, true_len: int):
        # run the full-bucket prefill, then reset length to the true prompt
        # length (the suffix is padding that the length mask hides)
        bucket = tokens.shape[1]
        if self.graph is not None and bucket <= PREFILL_GRAPH_MAX_BUCKET:
            if bucket not in self.prefill_graphs:
                self.prefill_graphs[bucket] = PrefillGraph(
                    self.cfg, self.model, 1, bucket, self.max_len,
                    self.use_kernel, cache=self._prefill_cache,
                    pool=self.graph.graph.pool())
            graph = self.prefill_graphs[bucket]
            graph.replay(tokens)
            cache = graph.cache
        else:
            _, cache = lm.prefill(self.cfg, self.model, tokens, self.max_len,
                                  self.use_kernel)
        cache["length"].fill_(true_len)
        return cache

    def _insert_slot(self, slot: int, one_cache) -> None:
        """Write a single-sequence cache into batch slot ``slot``."""
        for batch_c, one_c in zip(self.cache["layers"], one_cache["layers"]):
            for name, leaf in batch_c.items():
                leaf[:, slot] = one_c[name][:, 0]      # (P, B, ...)
        self.cache["length"][slot] = one_cache["length"][0]

    def _slot_logits_token(self, logits_row: np.ndarray) -> int:
        return int(np.argmax(logits_row))

    # ------------------------------------------------------------- control
    def submit(self, req: Request) -> None:
        self.queue.append(req)

    def _admit(self) -> None:
        for slot in range(self.n_slots):
            if self.slots[slot] is not None or not self.queue:
                continue
            req = self.queue.pop(0)
            sp = len(req.prompt)
            bucket = _buckets(sp)
            toks = np.zeros((1, bucket), np.int64)
            toks[0, :sp] = req.prompt
            cache1 = self._prefill(torch.as_tensor(toks, device=self.device),
                                   sp)
            self._insert_slot(slot, cache1)
            self.slots[slot] = req
            self.stats["prefills"] += 1
            # next-token seed: decode once with the last prompt token (the
            # reference's choice, kept for equal tokens)
            self.last_tok[slot] = int(req.prompt[-1])

    def step(self) -> None:
        """One engine tick: admit, batched-decode, retire."""
        with torch.no_grad():
            self._admit()
            live = [i for i, r in enumerate(self.slots) if r is not None]
            if not live:
                return
            self.stats["steps"] += 1
            self.stats["slot_busy_ticks"] += len(live)
            tok = torch.as_tensor(self.last_tok.astype(np.int64),
                                  device=self.device)
            if self.graph is not None:
                logits = self.graph.replay(tok)
            else:
                logits, _ = lm.decode_step(self.cfg, self.model, self.cache,
                                           tok, self.use_kernel)
            logits = logits.cpu().numpy()
        for i in live:
            req = self.slots[i]
            tok = self._slot_logits_token(logits[i])
            req.out.append(tok)
            self.last_tok[i] = tok
            if (self.eos is not None and tok == self.eos) or \
                    len(req.out) >= req.max_new:
                req.done = True
                self.slots[i] = None                     # free the slot

    def run_until_drained(self, max_steps: int = 10_000) -> None:
        for _ in range(max_steps):
            if not self.queue and all(s is None for s in self.slots):
                return
            self.step()
        raise RuntimeError("scheduler did not drain")

    @property
    def utilization(self) -> float:
        s = self.stats
        return s["slot_busy_ticks"] / max(1, s["steps"] * self.n_slots)
