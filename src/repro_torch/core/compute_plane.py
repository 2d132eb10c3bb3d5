"""Batched compute plane for the CM simulator (paper §2 compute model).

The event engine admits whole *batches* of ready iterations at once (the
control plane); this module is the matching **compute plane**: it owns
the crossbar MxV for both simulator engines so that stacking iterations into
one ``(B, N)`` activation block cannot change a single output bit unless a
backend explicitly trades exactness for speed.

Three backends:

``torch`` (what ``"auto"`` resolves to)
    :class:`TorchPlane`: the ``kernels/mxv.py`` crossbar kernels, written
    by hand in CUDA for Hopper.  Weights stay resident on the card as int8
    "conductances" with per-row scales (the analog-programming model, paper
    §3.5) and only activations move per call; ``dac=True`` additionally
    quantizes activations per row (the DAC model) and runs the fully-int8
    kernel.  ``TorchPlane(device="cpu")`` runs the kernels' plain PyTorch
    versions.  Equivalence is tolerance-based: with a crossbar matrix that
    is already dequantized-int8 (``compile_model(...,
    quantizer=dequantize_int8)``) the float path matches the numpy plane
    within ``atol=2e-5`` (matmul rounding only); otherwise int8
    weight-quantization error dominates.

``numpy``
    Stacked ``einsum('bn,mn->bm', V, M)``.  ``np.einsum`` evaluates every
    output element with the same contraction order regardless of the batch
    size (verified by the backend-matrix test), so row ``i`` of a stacked
    call is **bit-identical** to the per-iteration call — unlike BLAS, where
    a 1-row GEMM dispatches to GEMV and last-ulp bits differ.  This is why
    the simulator's default per-row MxV is the einsum row kernel
    (:func:`mxv_rowwise`) rather than ``m @ v``.

``reference``
    The per-iteration loop over ``mxv_fn`` — the original execution
    structure, kept as the batching oracle.  With the default ``mxv_fn`` it
    is bit-identical to the numpy plane; with a custom ``mxv_fn`` it is the
    only backend that can honor it.

Lowering tags every crossbar core with a :class:`ComputeDescriptor` (weight
matrix, int8 quantization, op kind) so planes never re-derive per-core state
at simulation time.  Custom backends plug in by subclassing
:class:`ComputePlane` (or via the ``mxv_batch_fn`` hook) — the only contract
is ``mxv_batch(desc, V)[i] == mxv_one(desc, V[i])`` to whatever tolerance
the caller asserts.

Port of ``repro.core.compute_plane``: ``NumpyPlane``, ``ReferencePlane``,
``CustomPlane`` and ``NoisyPlane`` are copied as they are; ``TorchPlane``
takes the place of ``PallasPlane``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from ..kernels import mxv as kmxv
from ..kernels.ref import quantize_vec


# ------------------------------------------------------------- quantization
def quantize_matrix(m: np.ndarray, bits: int = 8):
    """Symmetric per-row weight quantization (pure-numpy twin of
    ``kernels.ref.quantize_crossbar`` — same rounding)."""
    m = np.asarray(m, np.float32)
    qmax = 2.0 ** (bits - 1) - 1
    absmax = np.maximum(np.max(np.abs(m), axis=1), 1e-12)
    scale = (absmax / qmax).astype(np.float32)
    wq = np.clip(np.round(m / scale[:, None]), -qmax, qmax).astype(np.int8)
    return wq, scale


def quantize_rows(x: np.ndarray, bits: int = 8):
    """Per-row symmetric activation quantization (the DAC model)."""
    x = np.asarray(x, np.float32)
    qmax = 2.0 ** (bits - 1) - 1
    absmax = np.maximum(np.max(np.abs(x), axis=-1), 1e-12)
    scale = (absmax / qmax).astype(np.float32)
    xq = np.clip(np.round(x / scale[..., None]), -qmax, qmax).astype(np.int8)
    return xq, scale


def dequantize_int8(m: np.ndarray, bits: int = 8) -> np.ndarray:
    """Round-trip a matrix through int8: the quantizer to pass to
    ``compile_model`` when the torch plane should match float planes within
    matmul rounding only (requantizing the result is exact)."""
    wq, scale = quantize_matrix(m, bits)
    return wq.astype(np.float32) * scale[:, None]


# --------------------------------------------------------------- descriptor
@dataclasses.dataclass
class ComputeDescriptor:
    """Per-core compute-plane programming, built once at lowering.

    ``matrix`` is the float crossbar matrix (paper Listing 1 layout);
    ``wq``/``wscale`` are its int8 conductances + per-row scales for the
    torch plane.  ``op`` records the crossbar op kind ("conv2d"/"gemm").

    ``device_weights`` is the torch plane's resident copy of ``wq``/``wscale``
    as ``(device, wq, wscale)`` tensors: uploaded once per descriptor, like
    programming the crossbar.  It lives on the descriptor itself because a
    cache keyed by ``id(desc)`` would serve stale weights once a short-lived
    descriptor (``NoisyPlane`` makes one per call) is collected and its id
    reused.
    """

    matrix: np.ndarray                 # (M, N) float32, C-contiguous
    wq: np.ndarray                     # (M, N) int8
    wscale: np.ndarray                 # (M,) float32
    op: str
    dtype: str = "float32"
    device_weights: Optional[tuple] = dataclasses.field(
        default=None, repr=False, compare=False)


def make_descriptor(matrix: np.ndarray, op: str) -> ComputeDescriptor:
    m = np.ascontiguousarray(matrix, np.float32)
    wq, wscale = quantize_matrix(m)
    return ComputeDescriptor(matrix=m, wq=wq, wscale=wscale, op=op)


def descriptor_for(cfg) -> ComputeDescriptor:
    """Descriptor of a ``CoreConfig`` (lazily built for hand-made configs)."""
    if cfg.compute is None:
        cfg.compute = make_descriptor(
            cfg.xbar_matrix,
            cfg.xbar_node.op if cfg.xbar_node is not None else "gemm")
    return cfg.compute


@dataclasses.dataclass
class DynMatmulDescriptor:
    """DPU descriptor for the dynamic activation×activation matmul.

    Deliberately ``ComputeDescriptor``-free: there is no weight matrix to
    program, hence no int8 conductances or per-row scales — the "matrix"
    operand (``b_value``) is itself a streamed activation array assembled in
    the consumer core's SRAM at run time.  The op therefore executes on the
    digital DPU for *every* compute plane (the crossbar backends model the
    analog array, which a dynamic operand can never occupy); planes only
    differ in batching (:meth:`ComputePlane.dyn_mxv_batch` vs the reference
    per-iteration loop).
    """

    a_value: str                       # pointwise-streamed operand (Ca, T, 1)
    b_value: str                       # broadcast operand (Cb, Tb, 1)
    transpose_b: bool                  # True: contract channel dims (QKᵀ)
    scale: float = 1.0                 # post-matmul scalar (1/sqrt(d_head))


def dyn_descriptor_for(cfg, node) -> DynMatmulDescriptor:
    """Dynamic-matmul descriptor of a DPU node (lazily built for hand-made
    configs, mirroring :func:`descriptor_for`)."""
    desc = cfg.dyn_compute.get(node.name)
    if desc is None:
        desc = DynMatmulDescriptor(
            a_value=node.inputs[0], b_value=node.inputs[1],
            transpose_b=bool(node.attrs.get("transpose_b", False)),
            scale=float(node.attrs.get("scale", 1.0)))
        cfg.dyn_compute[node.name] = desc
    return desc


# ------------------------------------------------------------------- planes
def mxv_rowwise(m: np.ndarray, v: np.ndarray) -> np.ndarray:
    """The simulator's default per-row crossbar MxV.

    Einsum-based so it is bit-identical to row ``i`` of the numpy plane's
    stacked call (BLAS ``m @ v`` is not: GEMV and GEMM accumulate in
    different orders)."""
    return np.einsum("n,mn->m", v, m)


class ComputePlane:
    """Backend interface: stacked crossbar MxVs for a batch of iterations."""

    name = "?"

    def mxv_one(self, desc: ComputeDescriptor, v: np.ndarray) -> np.ndarray:
        """One iteration's MxV (the reference engine's path)."""
        return np.asarray(self.mxv_batch(desc, v[None]))[0]

    def mxv_batch(self, desc: ComputeDescriptor, V: np.ndarray) -> np.ndarray:
        """Stacked MxVs: rows of ``V``/result are iterations."""
        raise NotImplementedError

    # ---- dynamic matmul (DPU digital path — no crossbar involvement)
    def dyn_mxv_one(self, matrix: np.ndarray, v: np.ndarray) -> np.ndarray:
        """One iteration of the dynamic activation×activation matmul.

        ``matrix`` is the runtime operand assembled from SRAM (see
        :class:`DynMatmulDescriptor`) — it executes on the digital DPU, so
        every plane shares the einsum row kernel (batch-invariant; the
        reference plane overrides the *batch* side with the per-iteration
        loop to stay the batching oracle).
        """
        return np.einsum("n,mn->m", v, matrix)

    def dyn_mxv_batch(self, matrix: np.ndarray, V: np.ndarray) -> np.ndarray:
        """Stacked dynamic matmuls: rows of ``V``/result are iterations."""
        return np.einsum("bn,mn->bm", V, matrix)


class NumpyPlane(ComputePlane):
    """Stacked einsum matmul — fast and bit-identical per row (default)."""

    name = "numpy"

    def mxv_one(self, desc, v):
        return np.einsum("n,mn->m", v, desc.matrix)

    def mxv_batch(self, desc, V):
        return np.einsum("bn,mn->bm", V, desc.matrix)


class ReferencePlane(ComputePlane):
    """Per-iteration loop over ``mxv_fn`` — the PR 1 structure, kept as the
    batching oracle (and the only backend honoring a custom ``mxv_fn``)."""

    name = "reference"

    def __init__(self, mxv_fn: Optional[Callable] = None):
        self.fn = mxv_fn if mxv_fn is not None else mxv_rowwise

    def mxv_one(self, desc, v):
        return np.asarray(self.fn(desc.matrix, v))

    def mxv_batch(self, desc, V):
        return np.stack([np.asarray(self.fn(desc.matrix, V[i]))
                         for i in range(len(V))])

    def dyn_mxv_batch(self, matrix, V):
        # per-iteration loop: the batching oracle for the DPU matmul too
        return np.stack([self.dyn_mxv_one(matrix, V[i])
                         for i in range(len(V))])


class CustomPlane(ComputePlane):
    """Back-compat adapter for the ``mxv_batch_fn`` hook."""

    name = "custom"

    def __init__(self, mxv_fn=None, mxv_batch_fn=None):
        assert mxv_batch_fn is not None
        self._one = mxv_fn
        self._batch = mxv_batch_fn

    def mxv_one(self, desc, v):
        if self._one is not None:
            return np.asarray(self._one(desc.matrix, v))
        return np.asarray(self._batch(desc.matrix, v[None]))[0]

    def mxv_batch(self, desc, V):
        return np.asarray(self._batch(desc.matrix, V))


class NoisyPlane(ComputePlane):
    """Seeded Gaussian conductance noise on top of any backend.

    Each crossbar call draws a fresh matrix-shaped perturbation from this
    instance's own RNG stream and evaluates against
    ``matrix * (1 + sigma * g)`` — the read-noise model (every analog MxV
    sees slightly different conductances), the first brick of a
    quantized-accuracy harness.  Determinism contract: same seed + same
    call sequence => bit-identical outputs (tested in ``test_faults.py``);
    because the draw happens *per call*, the two simulator engines (which
    batch calls differently) are NOT expected to match each other under
    noise — use ``FaultyPlane`` (``repro.faults``, not ported yet) for engine-invariant
    (programming-time) perturbations.

    ``sigma=0`` skips the multiply entirely and is bit-identical to the
    inner plane.  ``reset()`` rewinds the RNG stream for replay.
    """

    name = "noisy"

    def __init__(self, sigma: float, inner: "ComputePlane" = None,
                 seed: int = 0):
        if not (sigma >= 0):                 # also rejects NaN
            raise ValueError(f"sigma must be >= 0, got {sigma}")
        self.sigma = float(sigma)
        self.seed = int(seed)
        self.inner = inner if inner is not None else NumpyPlane()
        self.reset()

    def reset(self):
        """Rewind the noise stream to the post-construction state."""
        self._rng = np.random.default_rng(self.seed)

    def _noisy(self, desc: ComputeDescriptor) -> ComputeDescriptor:
        g = self._rng.standard_normal(desc.matrix.shape)
        m = np.ascontiguousarray(
            desc.matrix * (1.0 + self.sigma * g), np.float32)
        return make_descriptor(m, desc.op)

    def mxv_one(self, desc, v):
        if self.sigma == 0.0:
            return self.inner.mxv_one(desc, v)
        return self.inner.mxv_one(self._noisy(desc), v)

    def mxv_batch(self, desc, V):
        if self.sigma == 0.0:
            return self.inner.mxv_batch(desc, V)
        return self.inner.mxv_batch(self._noisy(desc), V)

    def dyn_mxv_one(self, matrix, v):
        # dynamic matmuls run on the digital DPU — no conductance noise
        return self.inner.dyn_mxv_one(matrix, v)

    def dyn_mxv_batch(self, matrix, V):
        return self.inner.dyn_mxv_batch(matrix, V)


class TorchPlane(ComputePlane):
    """The ``kernels/mxv.py`` crossbar kernels as the compute plane.

    Weight-stationary: ``desc.wq``/``desc.wscale`` go to ``device`` once per
    descriptor (kept in ``desc.device_weights``); each call uploads only the
    ``(B, N)`` activation block and reads back ``(B, M)``.  On a CUDA device
    every MxV is one launch of the hand-written kernel; on the CPU the
    kernels' plain PyTorch versions run instead (the tests' path).
    ``dac=True`` quantizes the activations per row on ``device`` (codes and
    scales identical to :func:`quantize_rows`) and runs the int8 kernel.

    Constructing it for CUDA on a machine without a card raises: the plane
    never falls back to the CPU behind the caller's back.
    """

    name = "torch"

    def __init__(self, device="cuda", dac: bool = False):
        device = torch.device(device)
        if device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "TorchPlane(device='cuda') needs a CUDA device and this "
                    "process has none; pass device='cpu' for the plain "
                    "PyTorch versions or compute_plane='numpy'")
            if device.index is None:
                device = torch.device("cuda", torch.cuda.current_device())
        elif device.type != "cpu":
            raise ValueError(f"TorchPlane runs on 'cuda' or 'cpu', "
                             f"not {device}")
        self.device = device
        self.dac = dac

    def _weights(self, desc: ComputeDescriptor):
        w = desc.device_weights
        if w is None or w[0] != self.device:
            w = (self.device,
                 torch.from_numpy(desc.wq).to(self.device),
                 torch.from_numpy(desc.wscale).to(self.device))
            desc.device_weights = w
        return w[1], w[2]

    def mxv_batch(self, desc, V):
        wq, ws = self._weights(desc)
        x = torch.from_numpy(np.ascontiguousarray(V, np.float32)).to(
            self.device)
        if self.dac:
            xq, xs = quantize_vec(x)
            y = kmxv.crossbar_mxv_int8(xq, xs, wq, ws)
        else:
            y = kmxv.crossbar_mxv(x, wq, ws)
        return y.cpu().numpy()


PLANES = ("torch", "numpy", "reference")


def resolve_plane(spec="auto", mxv_fn=None, mxv_batch_fn=None) -> ComputePlane:
    """Resolve the ``Simulator`` compute-plane argument.

    ``spec`` is a plane name, a :class:`ComputePlane` instance, or ``"auto"``
    (:class:`TorchPlane` on the CUDA card — raising where there is none —
    unless a custom ``mxv_fn`` forces the reference loop).  A
    ``mxv_batch_fn`` hook always wins (back-compat with the legacy hook).
    """
    if mxv_batch_fn is not None:
        return CustomPlane(mxv_fn, mxv_batch_fn)
    if isinstance(spec, ComputePlane):
        if mxv_fn is not None:
            raise ValueError(
                f"compute_plane={type(spec).__name__} instance cannot honor "
                "a separate mxv_fn (the instance's own MxV wins); construct "
                "ReferencePlane(mxv_fn) or pass a matching mxv_batch_fn "
                "hook instead")
        return spec
    if spec == "auto":
        spec = "reference" if mxv_fn is not None else "torch"
    if spec == "reference":
        return ReferencePlane(mxv_fn)
    if mxv_fn is not None:
        raise ValueError(
            f"compute_plane={spec!r} cannot honor a custom mxv_fn; use "
            "compute_plane='reference' (per-iteration loop) or pass a "
            "matching mxv_batch_fn hook instead")
    if spec == "numpy":
        return NumpyPlane()
    if spec == "torch":
        return TorchPlane()
    raise ValueError(f"unknown compute plane {spec!r}; expected one of "
                     f"{PLANES} or a ComputePlane instance")
