"""Deterministic request-arrival processes for the CM serving runtime.

Everything here is measured in *simulator cycles* — "offered load" is
images per cycle, so a rate of ``1/64`` against a GCU that needs 16 cycles
to stream one image is a 25%-occupancy open-loop workload.  All processes
are seeded and reproducible: same seed + same parameters => the same
arrival-cycle vector, which (with the deterministic simulator) makes whole
serving experiments replayable bit-for-bit.

Open loop (``poisson_arrivals`` / ``uniform_arrivals``): arrivals don't
react to the system — the classic load-sweep setting where p99 latency
diverges as offered load approaches the pipeline's saturation throughput.

Closed loop (:class:`ClosedLoopClients`): a fixed population of clients,
each submitting its next request ``think_cycles`` after its previous one
completed.  Completion times come from the simulation itself, so the
workload is solved by fixed-point iteration over full runs; under FIFO
admission a later arrival never delays an earlier request's completion,
which makes the iteration converge in at most ``requests_per_client``
sweeps (each sweep finalizes at least one more round of arrivals).

Port copy of ``repro.runtime.workload``: the same code, with every import inside
``repro_torch``; ``tests/test_torch_*.py`` hold the two equal.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np


def _check_rate(rate: float) -> None:
    # NaN fails every comparison, so `rate <= 0` alone would wave it through
    if not np.isfinite(rate) or rate <= 0:
        raise ValueError(f"rate must be a finite value > 0, got {rate}")


def poisson_arrivals(n: int, rate: float, seed: int = 0,
                     start: int = 0) -> np.ndarray:
    """``n`` open-loop Poisson arrival cycles at ``rate`` images/cycle.

    Exponential inter-arrival gaps with mean ``1/rate``, accumulated and
    floored to integer cycles (non-decreasing by construction).
    """
    _check_rate(rate)
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(1.0 / rate, n)
    return (start + np.floor(np.cumsum(gaps))).astype(np.int64)


def uniform_arrivals(n: int, rate: float, start: int = 0) -> np.ndarray:
    """``n`` evenly spaced arrival cycles at ``rate`` images/cycle."""
    _check_rate(rate)
    return (start + np.floor(np.arange(n) / rate)).astype(np.int64)


def rate_sweep(rates: Sequence[float], n: int, kind: str = "poisson",
               seed: int = 0):
    """Yield ``(rate, arrivals)`` per swept rate.

    Each rate draws from its own derived seed (``seed`` + sweep index) so
    the sweep points are independent but individually reproducible.
    """
    for i, rate in enumerate(rates):
        if kind == "poisson":
            yield rate, poisson_arrivals(n, rate, seed=seed + i)
        elif kind == "uniform":
            yield rate, uniform_arrivals(n, rate)
        else:
            raise ValueError(f"unknown arrival kind {kind!r}")


@dataclasses.dataclass
class ClosedLoopClients:
    """Closed-loop population: each client re-submits after a think time.

    ``run(server, images)`` drives a :class:`repro_torch.runtime.CmServer` to the
    fixed point described in the module docstring and returns the final
    :class:`repro_torch.runtime.ServeReport`.  ``images`` is indexed
    ``[client * requests_per_client + k]`` (client-major), one per request.
    """

    n_clients: int
    requests_per_client: int
    think_cycles: int
    start_stagger: int = 0        # client c's first request arrives c*stagger
    max_sweeps: Optional[int] = None   # default: requests_per_client + 1

    def __post_init__(self):
        if self.n_clients <= 0:
            raise ValueError(f"n_clients must be > 0, got {self.n_clients}")
        if self.requests_per_client <= 0:
            raise ValueError(f"requests_per_client must be > 0, got "
                             f"{self.requests_per_client}")
        if self.think_cycles < 0:
            raise ValueError(f"think_cycles must be >= 0, got "
                             f"{self.think_cycles}")
        if self.start_stagger < 0:
            raise ValueError(f"start_stagger must be >= 0, got "
                             f"{self.start_stagger}")
        if self.max_sweeps is not None and self.max_sweeps < 1:
            raise ValueError(f"max_sweeps must be >= 1, got "
                             f"{self.max_sweeps}")

    def initial_arrivals(self) -> np.ndarray:
        arr = np.zeros(self.n_clients * self.requests_per_client, np.int64)
        for c in range(self.n_clients):
            base = c * self.requests_per_client
            arr[base] = c * self.start_stagger
            # optimistic guess: zero service time, think-only cadence
            for k in range(1, self.requests_per_client):
                arr[base + k] = arr[base + k - 1] + self.think_cycles + 1
        return arr

    def run(self, server, images: List[np.ndarray], tenants=None):
        n = self.n_clients * self.requests_per_client
        if len(images) != n:
            raise ValueError(f"need {n} images (client-major), got "
                             f"{len(images)}")
        arrivals = self.initial_arrivals()
        report = None
        limit = (self.max_sweeps if self.max_sweeps is not None
                 else self.requests_per_client + 1)
        for _ in range(limit):
            report = server.serve_images(images, arrivals=arrivals,
                                         tenants=tenants)
            by_rid = report.by_rid()          # rid == client-major index
            nxt = arrivals.copy()
            for c in range(self.n_clients):
                base = c * self.requests_per_client
                for k in range(1, self.requests_per_client):
                    done = by_rid[base + k - 1].completion
                    nxt[base + k] = done + 1 + self.think_cycles
            if np.array_equal(nxt, arrivals):
                return report
            arrivals = nxt
        raise RuntimeError(
            f"closed-loop arrivals did not reach a fixed point within "
            f"{limit} sweeps — under FIFO admission convergence needs at "
            f"most requests_per_client + 1 = {self.requests_per_client + 1} "
            f"sweeps, so either the admission policy is non-FIFO or "
            f"max_sweeps={self.max_sweeps} is set too low")
