"""Crossbar-level value faults as a ComputePlane wrapper.

Analog CM crossbars fail in the *value* domain: individual cells stick at a
conductance, whole arrays drift after programming.  Those faults don't
change the dataflow timing at all — every message is still sent, every
cycle counter unchanged — so they are modeled here as a wrapper around any
:class:`repro_torch.core.compute_plane.ComputePlane`, orthogonal to the timing
faults in :mod:`repro_torch.faults.schedule`.

Determinism contract: the perturbation applied to a crossbar depends only
on ``(seed, matrix contents)`` — the RNG is re-seeded per descriptor from a
CRC of the weight bytes.  Two simulator engines (or two processes) that
load the same weights therefore see bit-identical perturbed crossbars, and
engine×engine output bit-identity survives fault injection (the inner
plane's batch-invariance is preserved because perturbation happens once,
on the weights, not per call).

Port copy of ``repro.faults.planes``: the same code, with every import inside
``repro_torch``; ``tests/test_torch_*.py`` hold the two equal.
"""

from __future__ import annotations

import zlib
from typing import Dict, Optional, Tuple

import numpy as np

from ..core.compute_plane import (ComputeDescriptor, ComputePlane,
                                  NumpyPlane, make_descriptor)


class FaultyPlane(ComputePlane):
    """Stuck-at cells and conductance drift on every crossbar.

    ``stuck_fraction`` of each matrix's cells are forced to
    ``stuck_value``; the surviving cells get multiplicative Gaussian drift
    ``* (1 + drift_sigma * g)``.  Perturbation is computed once per
    descriptor and cached, so repeated MxVs against the same crossbar are
    consistent (a stuck cell stays stuck).
    """

    name = "faulty"

    def __init__(self, stuck_fraction: float = 0.0, stuck_value: float = 0.0,
                 drift_sigma: float = 0.0, seed: int = 0,
                 inner: Optional[ComputePlane] = None):
        if not 0.0 <= stuck_fraction <= 1.0:
            raise ValueError(f"stuck_fraction must be in [0, 1], got "
                             f"{stuck_fraction}")
        if drift_sigma < 0:
            raise ValueError(f"drift_sigma must be >= 0, got {drift_sigma}")
        self.stuck_fraction = float(stuck_fraction)
        self.stuck_value = float(stuck_value)
        self.drift_sigma = float(drift_sigma)
        self.seed = int(seed)
        self.inner = inner if inner is not None else NumpyPlane()
        # id(desc) -> (desc identity check, perturbed descriptor)
        self._cache: Dict[int, Tuple[ComputeDescriptor,
                                     ComputeDescriptor]] = {}

    def _perturbed(self, desc: ComputeDescriptor) -> ComputeDescriptor:
        hit = self._cache.get(id(desc))
        if hit is not None and hit[0] is desc:
            return hit[1]
        m = np.ascontiguousarray(desc.matrix)
        # content-addressed seed: same weights => same perturbation,
        # independent of process / engine / descriptor identity
        rng = np.random.default_rng(
            (self.seed, zlib.crc32(m.tobytes()), m.shape[0], m.shape[1]))
        pm = m.astype(np.float64, copy=True)
        if self.drift_sigma > 0:
            pm *= 1.0 + self.drift_sigma * rng.standard_normal(pm.shape)
        if self.stuck_fraction > 0:
            stuck = rng.random(pm.shape) < self.stuck_fraction
            pm[stuck] = self.stuck_value
        pm = pm.astype(m.dtype, copy=False)
        out = make_descriptor(pm, desc.op)   # re-quantize: a torch inner sees
        self._cache[id(desc)] = (desc, out)  # the faulty conductances too
        return out

    # ---- delegate every entry point with the perturbed descriptor -------
    def mxv_one(self, desc, v):
        return self.inner.mxv_one(self._perturbed(desc), v)

    def mxv_batch(self, desc, V):
        return self.inner.mxv_batch(self._perturbed(desc), V)

    def dyn_mxv_one(self, matrix, v):
        # dynamic matrices (attention scores) live in SRAM, not crossbars:
        # no stuck cells, pass through untouched
        return self.inner.dyn_mxv_one(matrix, v)

    def dyn_mxv_batch(self, matrix, V):
        return self.inner.dyn_mxv_batch(matrix, V)
