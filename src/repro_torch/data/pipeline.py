"""Synthetic LM data pipeline: deterministic, checkpointable, prefetched.

A copy of ``repro.data.pipeline`` (NumPy and threads; the port keeps its
own): the same seed gives batches byte-equal to the reference's.

* ``SyntheticLMData`` — deterministic per-step batches (seeded by
  ``(seed, step)``), so resume-from-checkpoint replays the exact stream.
  Emits next-token-prediction pairs over a Zipfian vocab with enough local
  structure (a noisy bigram chain) that the training loss measurably
  decreases — the end-to-end training run's acceptance signal.
* ``PrefetchLoader`` — background-thread prefetch with a bounded queue and
  a per-batch deadline; a shard that misses the deadline is logged and
  skipped (straggler mitigation at the input layer; tests inject delays).
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Dict, Iterator, Optional

import numpy as np


class SyntheticLMData:
    """Deterministic synthetic token stream."""

    def __init__(self, vocab_size: int, batch: int, seq_len: int,
                 seed: int = 0, embed_dim: int = 0, encdec: bool = False):
        self.vocab = vocab_size
        self.batch = batch
        self.seq = seq_len
        self.seed = seed
        self.embed_dim = embed_dim          # >0: emit precomputed embeddings
        self.encdec = encdec
        self.step = 0
        # fixed bigram successor table gives the stream learnable structure
        rng = np.random.default_rng(seed)
        self._succ = rng.integers(0, vocab_size, size=vocab_size)

    def state_dict(self) -> Dict:
        return {"step": self.step, "seed": self.seed}

    def load_state_dict(self, st: Dict) -> None:
        self.step = int(st["step"])
        assert int(st["seed"]) == self.seed, "resume with a different seed"

    def _tokens(self, rng) -> np.ndarray:
        toks = np.empty((self.batch, self.seq + 1), np.int32)
        toks[:, 0] = rng.integers(0, self.vocab, self.batch)
        noise = rng.random((self.batch, self.seq)) < 0.15
        rand = rng.integers(0, self.vocab, (self.batch, self.seq))
        for t in range(self.seq):
            nxt = self._succ[toks[:, t]]
            toks[:, t + 1] = np.where(noise[:, t], rand[:, t], nxt)
        return toks

    def next(self) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng((self.seed << 20) + self.step)
        toks = self._tokens(rng)
        batch: Dict[str, np.ndarray] = {
            "tokens": toks[:, :-1], "labels": toks[:, 1:]}
        if self.embed_dim:
            batch["embeds"] = rng.standard_normal(
                (self.batch, self.seq, self.embed_dim)).astype(np.float32)
            if not self.encdec:
                del batch["tokens"]      # decoder-only VLM: embeds replace ids
        self.step += 1
        return batch

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            yield self.next()


class PrefetchLoader:
    """Background prefetch + straggler skip.

    ``delay_fn(step) -> seconds`` lets tests inject a straggling shard; any
    batch whose production exceeds ``deadline_s`` is dropped (and counted)
    rather than stalling the train step — mirroring input-pipeline straggler
    mitigation on a real cluster.
    """

    def __init__(self, source: SyntheticLMData, depth: int = 2,
                 deadline_s: Optional[float] = None, delay_fn=None):
        self.source = source
        self.deadline = deadline_s
        self.delay_fn = delay_fn
        self.skipped = 0
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self) -> None:
        while not self._stop.is_set():
            step = self.source.step
            t0 = time.monotonic()
            if self.delay_fn is not None:
                time.sleep(self.delay_fn(step))
            batch = self.source.next()
            took = time.monotonic() - t0
            if self.deadline is not None and took > self.deadline:
                self.skipped += 1      # straggler: drop, move on
                continue
            while not self._stop.is_set():
                try:
                    self._q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue

    def next(self, timeout: float = 30.0):
        return self._q.get(timeout=timeout)

    def close(self) -> None:
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2.0)
