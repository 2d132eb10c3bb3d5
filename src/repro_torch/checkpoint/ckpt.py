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

**Sharding-agnostic**, as the reference's ("restore device_puts against the
*current* mesh's shardings"): a model built under a mesh
(``model.shards``) writes whole tensors in the same format, every rank
taking part in making each one whole, one tensor at a time, and the
mesh's first rank keeping them on the host and writing the file (the
other ranks drop each at once); a restore cuts each whole
tensor to the rank's part for the mesh the template was built on, so a
checkpoint written on one mesh restores on another and on one rank.
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


def _whole_moment(shards, name: str, m: torch.Tensor,
                  like: torch.Tensor) -> torch.Tensor:
    """The whole moment of parameter ``name`` (``like``: the rank's part of
    the parameter) from every rank's part ``m``: from its owning data rank,
    then gathered over the axes its spec splits (a collective)."""
    from ..distributed import comm
    from ..sharding.rules import Placement, unshard
    place = shards.moments[name]
    if place.owner is not None:
        buf = m if shards.owns(name) else torch.empty(
            like.shape, dtype=m.dtype, device=m.device)
        m = comm.broadcast(buf, place.owner, shards.mesh.get_group("data"))
        place = Placement(place.spec, place.halves)
    return unshard(m, place, shards.mesh)


def state_arrays(state) -> Dict[str, np.ndarray]:
    """The checkpoint's arrays of a ``TrainState``, keyed and ordered as the
    reference's (a snapshot on the host).  For a model built under a mesh,
    a collective: each tensor made whole on every rank of it, in turn, and
    every rank gets the whole state."""
    return _arrays(state, keep=True)


def _arrays(state, keep: bool) -> Optional[Dict[str, np.ndarray]]:
    """:func:`state_arrays`; with ``keep`` False (a rank of a mesh that does
    not write) the rank takes part in each tensor's collective and drops
    the whole tensor at once, holding one at a time, and gets None.  The
    writing rank holds the whole state on the host, as a one-card save
    does."""
    model = state.model
    params = dict(model.named_parameters())
    shards = model.shards
    flat: Dict[str, np.ndarray] = {}
    for prefix, tensors in (("params", params), ("opt/mu", state.opt.mu),
                            ("opt/nu", state.opt.nu)):
        if shards is None:
            tree = tree_to_reference(model, tensors, _host)
            _flatten(tree, prefix, flat)
            continue
        host = {}
        for n, t in tensors.items():
            whole = (shards.whole(n, t) if prefix == "params" else
                     _whole_moment(shards, n, t, params[n]))
            if keep:
                host[n] = _host(whole)
            del whole
        if keep:
            _flatten(tree_to_reference(model, host, lambda a: a,
                                       gather=False), prefix, flat)
    if not keep:
        return None
    flat["opt/count"] = np.asarray(state.opt.count, np.int32)
    flat["step"] = np.asarray(state.step, np.int32)
    return flat


def save_checkpoint(ckpt_dir: str, step: int, state: Any,
                    extra: Optional[Dict] = None, keep: int = 3) -> str:
    """Write ``state`` (a ``TrainState``, or :func:`state_arrays` of one)
    as ``step_<step>.npz`` in ``ckpt_dir``; keep the ``keep`` newest.  A
    state on a mesh: every rank of it calls this, the first writes."""
    flat = dict(state) if isinstance(state, dict) else _arrays(
        state, keep=writes(state))
    final = os.path.join(ckpt_dir, f"step_{step}.npz")
    if flat is None:
        return final
    os.makedirs(ckpt_dir, exist_ok=True)
    if extra:
        flat["__extra__"] = np.frombuffer(
            json.dumps(extra).encode(), dtype=np.uint8)
    tmp = os.path.join(ckpt_dir, f"step_{step}.tmp")
    with open(tmp, "wb") as f:
        np.savez(f, **flat)
    os.replace(tmp, final)                               # atomic
    _prune(ckpt_dir, keep)
    return final


def writes(state) -> bool:
    """Whether this rank writes ``state``'s checkpoint: the mesh's first
    rank for a model built under a mesh, else every caller."""
    shards = state.model.shards
    return shards is None or not any(shards.coords.values())


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
            t = _part(model.shards, prefix, name, _tensor(arr, dst))
            if t is None:
                continue
            if tuple(t.shape) != tuple(dst.shape):
                raise ValueError(f"{key}: checkpoint leaf {arr.shape} does "
                                 f"not fit {tuple(dst.shape)}")
            dst.copy_(t)
    extra = None
    if "__extra__" in data:
        extra = json.loads(bytes(data["__extra__"].tobytes()).decode())
    opt = template.opt._replace(count=int(data["opt/count"]))
    return template._replace(opt=opt, step=int(data["step"])), extra


def _part(shards, prefix: str, name: str, t: torch.Tensor):
    """The rank's part of the whole restored tensor ``t`` of parameter
    ``name`` (``prefix`` "params" or a moment's), or None for a moment
    another data rank owns; ``t`` itself without ``shards``."""
    if shards is None:
        return t
    from ..sharding.rules import Placement, shard
    if prefix == "params":
        place = shards.params[name]
    else:
        if not shards.owns(name):
            return None
        place = Placement(shards.moments[name].spec,
                          shards.moments[name].halves)
    return shard(t, place, shards.coords, shards.sizes)


class AsyncCheckpointer:
    """Overlap checkpoint serialization with training (one in flight)."""

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self.saved: list = []

    def save(self, step: int, state: Any, extra: Optional[Dict] = None):
        self.wait()
        host = _arrays(state, keep=writes(state))       # snapshot now
        if host is None:
            return

        def work():
            p = save_checkpoint(self.ckpt_dir, step, host, extra, self.keep)
            self.saved.append(p)

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
