"""Fault-tolerant checkpointing: atomic, keep-K, async, in the reference's
file format.

Port of ``repro.checkpoint.ckpt``.  A checkpoint is a path-keyed ``.npz`` of
host numpy arrays with the reference's keys for its ``TrainState(params,
opt=OptState(mu, nu, count), step)``: ``params/embed``,
``params/positions/0/attn/wq`` (per-layer tensors stacked over periods),
``opt/mu/...``, ``opt/nu/...``, ``opt/count``, ``step``, in the order the
reference's tree flattens them, then an ``__extra__`` JSON record (the data
cursor).  So a reference checkpoint restores in the port and a port
checkpoint in the reference.

bf16 leaves are written as the reference writes them, 2-byte ``|V2``
records of the bf16 bits (numpy has no bfloat16 of its own), through
``uint16`` views: no ``ml_dtypes``, which the GPU machine lacks.  A restore
reads ``|V2`` records back as bf16 bits and casts other leaves to the
template's dtype.  (The reference's own restore cannot read its bf16 files:
``astype`` has no cast from ``|V2``.)

Write protocol: serialize to ``step_N.tmp``, then ``os.replace`` (atomic on
POSIX), then prune to the ``keep`` newest, so a crash mid-write never
corrupts the latest checkpoint.  The state is the port's ``TrainState``
(``train.loop``): the model's parameters and the moments, keyed by
parameter name, and ``count`` / ``step`` as integers; a restore copies into
the template's tensors in place.
"""

from __future__ import annotations

import json
import os
import re
import threading
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..models.convert import reference_layout, tree_to_reference

BF16_RECORD = np.dtype("V2")     # how numpy stores a bf16 leaf


def _host(t: torch.Tensor) -> np.ndarray:
    """A tensor as a host numpy array; bf16 as ``|V2`` records of its
    bits."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(BF16_RECORD)
    return t.numpy()


def _flatten(tree, prefix: str, out: Dict[str, np.ndarray]) -> None:
    """``out[prefix/path] = leaf``, dict keys sorted and lists in order, as
    ``jax.tree_util`` flattens."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            _flatten(tree[k], f"{prefix}/{k}", out)
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            _flatten(v, f"{prefix}/{i}", out)
    else:
        out[prefix] = np.asarray(tree)


def state_arrays(state) -> Dict[str, np.ndarray]:
    """The checkpoint's arrays of a ``TrainState``, keyed and ordered as the
    reference's (a snapshot on the host)."""
    model = state.model
    flat: Dict[str, np.ndarray] = {}
    for prefix, tensors in (("params", dict(model.named_parameters())),
                            ("opt/mu", state.opt.mu),
                            ("opt/nu", state.opt.nu)):
        _flatten(tree_to_reference(model, tensors, _host), prefix, flat)
    flat["opt/count"] = np.asarray(state.opt.count, np.int32)
    flat["step"] = np.asarray(state.step, np.int32)
    return flat


def save_checkpoint(ckpt_dir: str, step: int, state: Any,
                    extra: Optional[Dict] = None, keep: int = 3) -> str:
    """Write ``state`` (a ``TrainState``, or :func:`state_arrays` of one)
    as ``step_<step>.npz`` in ``ckpt_dir``; keep the ``keep`` newest."""
    os.makedirs(ckpt_dir, exist_ok=True)
    flat = dict(state) if isinstance(state, dict) else state_arrays(state)
    if extra:
        flat["__extra__"] = np.frombuffer(
            json.dumps(extra).encode(), dtype=np.uint8)
    tmp = os.path.join(ckpt_dir, f"step_{step}.tmp")
    final = os.path.join(ckpt_dir, f"step_{step}.npz")
    with open(tmp, "wb") as f:
        np.savez(f, **flat)
    os.replace(tmp, final)                               # atomic
    _prune(ckpt_dir, keep)
    return final


def _steps(ckpt_dir: str):
    return sorted((int(m.group(1)), f) for f in os.listdir(ckpt_dir)
                  if (m := re.match(r"step_(\d+)\.npz$", f)))


def _prune(ckpt_dir: str, keep: int) -> None:
    ckpts = _steps(ckpt_dir)
    for _, f in ckpts[:max(0, len(ckpts) - keep)]:
        os.remove(os.path.join(ckpt_dir, f))


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    if not os.path.isdir(ckpt_dir):
        return None
    ckpts = _steps(ckpt_dir)
    return os.path.join(ckpt_dir, ckpts[-1][1]) if ckpts else None


def _tensor(arr: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    """A restored leaf in ``like``'s dtype: ``|V2`` records as bf16 bits,
    anything else cast."""
    if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:
        t = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)).view(
            torch.bfloat16)
    else:
        t = torch.from_numpy(np.ascontiguousarray(arr))
    return t.to(like.dtype)


@torch.no_grad()
def restore_checkpoint(path: str, template: Any):
    """Restore ``path`` into ``template`` (a ``TrainState``): its
    parameters and moments are overwritten in place, on their devices.
    Returns (the state with the restored count and step, the extra record
    or None)."""
    data = np.load(path)
    model = template.model
    for prefix, tensors in (("params", dict(model.named_parameters())),
                            ("opt/mu", template.opt.mu),
                            ("opt/nu", template.opt.nu)):
        for name, (path_k, per) in reference_layout(model).items():
            key = "/".join([prefix, *map(str, path_k)])
            arr = data[key] if per is None else data[key][per]
            dst = tensors[name]
            if tuple(arr.shape) != tuple(dst.shape):
                raise ValueError(f"{key}: checkpoint leaf {arr.shape} does "
                                 f"not fit {tuple(dst.shape)}")
            dst.copy_(_tensor(arr, dst))
    extra = None
    if "__extra__" in data:
        extra = json.loads(bytes(data["__extra__"].tobytes()).decode())
    opt = template.opt._replace(count=int(data["opt/count"]))
    return template._replace(opt=opt, step=int(data["step"])), extra


class AsyncCheckpointer:
    """Overlap checkpoint serialization with training (one in flight)."""

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self.saved: list = []

    def save(self, step: int, state: Any, extra: Optional[Dict] = None):
        self.wait()
        host = state_arrays(state)                       # snapshot now

        def work():
            p = save_checkpoint(self.ckpt_dir, step, host, extra, self.keep)
            self.saved.append(p)

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
