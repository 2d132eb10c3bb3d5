"""Carry the reference's weights into the port, and back.

``params_from_reference`` takes the JAX package's LM parameter pytree as
nested dicts and lists of numpy arrays (``jax.tree.map(np.asarray, params)``
on the caller's side; nothing here imports JAX): ``"embed"``,
``"positions"`` (per period position, leaves stacked over periods as
(P, ...)), ``"final_norm"`` and, for untied embeddings, ``"lm_head"``.  A
position holds ``norm1``, ``norm2``, ``attn`` or ``mamba``, and ``mlp`` or
``moe`` (whose ``shared`` MLP is a nested group).  It returns the port's
:class:`models.lm.LM` with every leaf copied exactly (bf16 leaves through
their bits).  ``params_to_reference`` is its inverse.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ..configs.base import ArchConfig
from . import build_model
from .lm import LM, n_periods, period_structure

def _to_torch(arr) -> torch.Tensor:
    arr = np.array(arr)           # a writable copy: JAX's are read-only
    if arr.dtype.name == "bfloat16":
        # numpy has no bfloat16 of its own: move the bits
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes  # registers numpy's bfloat16 dtype
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def _copy(dst: torch.Tensor, src, what: str) -> None:
    t = _to_torch(src)
    if tuple(t.shape) != tuple(dst.shape) or t.dtype != dst.dtype:
        raise ValueError(f"{what}: reference leaf {t.dtype} "
                         f"{tuple(t.shape)} does not fit {dst.dtype} "
                         f"{tuple(dst.shape)}")
    with torch.no_grad():
        dst.copy_(t)


def _same_keys(got, want, what: str) -> None:
    if set(got) != set(want):
        raise ValueError(f"{what}: reference keys {sorted(got)} != port "
                         f"keys {sorted(want)}")


def params_from_reference(tree: Dict[str, Any], cfg: ArchConfig,
                          device="cuda") -> LM:
    """The port's model of ``cfg`` on ``device`` holding ``tree``'s
    weights."""
    model = build_model(cfg, device)
    struct = period_structure(cfg)
    want = {"embed", "positions", "final_norm"} | (
        set() if cfg.tie_embeddings else {"lm_head"})
    _same_keys(tree, want, "params")
    _copy(model.embed, tree["embed"], "embed")
    if not cfg.tie_embeddings:
        _copy(model.lm_head, tree["lm_head"], "lm_head")
    _same_keys(tree["final_norm"], model.final_norm, "final_norm")
    for name, leaf in tree["final_norm"].items():
        _copy(model.final_norm[name], leaf, f"final_norm.{name}")
    if len(tree["positions"]) != len(struct):
        raise ValueError(f"{len(tree['positions'])} period positions, the "
                         f"config has {len(struct)}")
    for pos_i, stacked in enumerate(tree["positions"]):
        groups = model.layers[pos_i].groups()
        _same_keys(stacked, groups, f"positions[{pos_i}]")
        for per in range(n_periods(cfg)):
            block = model.layers[per * len(struct) + pos_i]
            for group in groups:
                _copy_group(getattr(block, group), stacked[group], per,
                            f"positions[{pos_i}].{group}")
    return model


def _copy_group(dst, src: Dict[str, Any], per: int, what: str) -> None:
    """Period ``per`` of the stacked leaves ``src`` into ``dst``, a
    (possibly nested) ``ParameterDict``."""
    _same_keys(src, dst, what)
    for name, leaf in src.items():
        if isinstance(leaf, dict):
            _copy_group(dst[name], leaf, per, f"{what}.{name}")
        else:
            _copy(dst[name], np.asarray(leaf)[per], f"{what}.{name}[{per}]")


def _stack_group(groups) -> Dict[str, Any]:
    """One group of every period's block, stacked over periods as numpy."""
    return {name: _stack_group([g[name] for g in groups])
            if isinstance(groups[0][name], torch.nn.ParameterDict)
            else np.stack([_to_numpy(g[name]) for g in groups])
            for name in groups[0]}


def params_to_reference(model: LM) -> Dict[str, Any]:
    """The reference's pytree layout of ``model``'s weights, as numpy."""
    cfg = model.cfg
    struct = period_structure(cfg)
    positions = []
    for pos_i in range(len(struct)):
        blocks = [model.layers[per * len(struct) + pos_i]
                  for per in range(n_periods(cfg))]
        positions.append({
            group: _stack_group([getattr(b, group) for b in blocks])
            for group in blocks[0].groups()})
    tree = {"embed": _to_numpy(model.embed), "positions": positions,
            "final_norm": {k: _to_numpy(v)
                           for k, v in model.final_norm.items()}}
    if not cfg.tie_embeddings:
        tree["lm_head"] = _to_numpy(model.lm_head)
    return tree
