"""Carry the reference's weights into the port, and back.

``params_from_reference`` takes the JAX package's LM parameter pytree as
nested dicts and lists of numpy arrays (``jax.tree.map(np.asarray, params)``
on the caller's side; nothing here imports JAX): ``"embed"``,
``"positions"`` (per period position, leaves stacked over periods as
(P, ...)), ``"final_norm"`` and, for untied embeddings, ``"lm_head"``.  A
position holds ``norm1``, ``norm2``, ``attn`` or ``mamba``, and ``mlp`` or
``moe`` (whose ``shared`` MLP is a nested group).  An enc-dec's tree
(``repro.models.encdec.init_encdec``) holds ``"embed"``, ``"encoder"``
(``norm1``, ``attn``, ``norm2``, ``mlp``, leaves stacked over encoder
layers), ``"enc_final_norm"``, ``"decoder"`` (``norm1``, ``attn``,
``norm3``, ``cross``, ``norm2``, ``mlp``, stacked over decoder layers) and
``"final_norm"``.  It returns the port's :class:`models.lm.LM` or
:class:`models.encdec.EncDec` with every leaf copied exactly (bf16 leaves
through their bits).  ``params_to_reference`` is its inverse.

Any other tree of the parameters' shapes (gradients, AdamW's ``mu`` and
``nu``) crosses with :func:`tree_from_reference` (a reference tree to
tensors keyed by the port's parameter names) and :func:`tree_to_reference`
(back); :func:`reference_layout` says where each parameter lies in the
reference's tree, and :func:`decayed` which ones the reference's AdamW
decays.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from ..configs.base import ArchConfig
from . import Model, build_model
from .encdec import EncDec
from .lm import n_periods, period_structure


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


def _copy_norm(dst, src, what: str) -> None:
    _same_keys(src, dst, what)
    for name, leaf in src.items():
        _copy(dst[name], leaf, f"{what}.{name}")


def params_from_reference(tree: Dict[str, Any], cfg: ArchConfig,
                          device="cuda") -> Model:
    """The port's model of ``cfg`` on ``device`` holding ``tree``'s
    weights."""
    model = build_model(cfg, device)
    if isinstance(model, EncDec):
        _same_keys(tree, {"embed", "encoder", "enc_final_norm", "decoder",
                          "final_norm"}, "params")
        _copy(model.embed, tree["embed"], "embed")
        for name in ("enc_final_norm", "final_norm"):
            _copy_norm(getattr(model, name), tree[name], name)
        for stack in ("encoder", "decoder"):
            blocks = getattr(model, stack)
            _same_keys(tree[stack], blocks[0].groups(), stack)
            for i, block in enumerate(blocks):
                for group in block.groups():
                    _copy_group(getattr(block, group), tree[stack][group], i,
                                f"{stack}.{group}")
        return model
    struct = period_structure(cfg)
    want = {"embed", "positions", "final_norm"} | (
        set() if cfg.tie_embeddings else {"lm_head"})
    _same_keys(tree, want, "params")
    _copy(model.embed, tree["embed"], "embed")
    if not cfg.tie_embeddings:
        _copy(model.lm_head, tree["lm_head"], "lm_head")
    _copy_norm(model.final_norm, tree["final_norm"], "final_norm")
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
    """Period (or layer) ``per`` of the stacked leaves ``src`` into ``dst``,
    a (possibly nested) ``ParameterDict``."""
    _same_keys(src, dst, what)
    for name, leaf in src.items():
        if isinstance(leaf, dict):
            _copy_group(dst[name], leaf, per, f"{what}.{name}")
        else:
            _copy(dst[name], np.asarray(leaf)[per], f"{what}.{name}[{per}]")


def reference_layout(model: Model
                     ) -> Dict[str, Tuple[Tuple[Any, ...], Optional[int]]]:
    """For each parameter name of ``model`` (``named_parameters`` order):
    the path of its reference leaf (dict keys and list indices, e.g.
    ``("positions", 0, "attn", "wq")``) and its index on that leaf's stacked
    first axis (period or layer), or None for a leaf of its own (``embed``,
    the final norms, ``lm_head``)."""
    plen = len(period_structure(model.cfg)) if not isinstance(
        model, EncDec) else 1
    out = {}
    for name, _ in model.named_parameters():
        parts = name.split(".")
        if parts[0] == "layers":                  # an LM block: (period, pos)
            i = int(parts[1])
            out[name] = (("positions", i % plen, *parts[2:]), i // plen)
        elif parts[0] in ("encoder", "decoder"):
            out[name] = ((parts[0], *parts[2:]), int(parts[1]))
        else:
            out[name] = (tuple(parts), None)
    return out


def decayed(model: Model) -> Dict[str, bool]:
    """Which parameters the reference's AdamW decays: those whose reference
    leaf has two axes or more (``p.ndim >= 2`` on leaves stacked over
    periods), so every per-layer tensor, norm scales and biases included,
    and of the rest the matrices; not the final norms."""
    params = dict(model.named_parameters())
    return {name: params[name].dim() + (per is not None) >= 2
            for name, (_, per) in reference_layout(model).items()}


def tree_to_reference(model: Model, tensors: Mapping[str, torch.Tensor],
                      to_numpy: Callable = None) -> Dict[str, Any]:
    """The reference's tree of ``tensors`` (keyed by ``model``'s parameter
    names, of their shapes: parameters, gradients, moments), per-layer
    tensors stacked over periods, as numpy (``to_numpy``, default: bf16 as
    ``ml_dtypes.bfloat16``)."""
    to_numpy = to_numpy or _to_numpy
    leaves: Dict[Tuple, Dict] = {}
    for name, (path, per) in reference_layout(model).items():
        leaves.setdefault(path, {})[per] = tensors[name]
    tree: Dict[Any, Any] = {}
    for path, by_per in leaves.items():
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = to_numpy(by_per[None]) if None in by_per else \
            np.stack([to_numpy(by_per[i]) for i in range(len(by_per))])
    return _lists(tree)


def _lists(node):
    """Dicts keyed 0..n-1 as lists (the reference's ``positions``)."""
    if not isinstance(node, dict):
        return node
    out = {k: _lists(v) for k, v in node.items()}
    if out and all(isinstance(k, int) for k in out):
        return [out[i] for i in range(len(out))]
    return out


def tree_from_reference(model: Model, tree: Dict[str, Any]
                        ) -> Dict[str, torch.Tensor]:
    """A reference tree of ``model``'s parameter shapes (numpy leaves, bf16
    as ``ml_dtypes.bfloat16``) as tensors keyed by the parameter names, on
    the model's device, each in its leaf's dtype."""
    params = dict(model.named_parameters())
    out = {}
    for name, (path, per) in reference_layout(model).items():
        leaf = tree
        for key in path:
            leaf = leaf[key]
        arr = np.asarray(leaf) if per is None else np.asarray(leaf)[per]
        t = _to_torch(arr)
        if tuple(t.shape) != tuple(params[name].shape):
            raise ValueError(f"{name}: reference leaf {tuple(t.shape)} does "
                             f"not fit {tuple(params[name].shape)}")
        out[name] = t.to(params[name].device)
    return out


def params_to_reference(model: Model) -> Dict[str, Any]:
    """The reference's pytree layout of ``model``'s weights, as numpy."""
    return tree_to_reference(model, dict(model.named_parameters()))
