"""Decoder-only and hybrid language models: parameters, prefill and cached
decode.

Port of the serving part of ``repro.models.lm``.  An architecture is a
repeating *period* of layer kinds (jamba's ``MMMMAMMM`` with MoE on odd
positions; ``A`` for the dense and MoE families, ``M`` for falcon-mamba).
The reference keeps parameters as a pytree with each period position's
leaves stacked over periods and runs ``lax.scan`` over them; here they live
in :class:`LM`, an ``nn.Module`` with one :class:`Block` per layer on an
explicit device and dtype, and the scan is a Python loop over layers.
Layer ``i`` is period ``i // len(period)``, position ``i % len(period)``.
Each block holds ``norm1``, ``norm2``, its mixer (``attn`` or ``mamba``)
and its FFN (``mlp`` or ``moe``).

The decode cache keeps the reference's structure, ``{"layers": [per period
position: {"k", "v"[, "k_scale", "v_scale"]} with leaves (P, B, S, Hkv, ·)
for attention, {"conv" (P, B, K-1, Din), "ssm" (P, B, Din, N) f32} for
Mamba], "length": (B,) int32}``, and :func:`decode_step` updates it **in
place**: the K/V (``models.layers.attention_decode``), the Mamba states
and, after the last layer, ``length`` itself (``add_(1)``), so a step
captured once as a CUDA graph (``serve.graphs``) advances the cache at
every replay.  :func:`prefill` fills a new cache or, given ``cache=``, one
the caller owns; :func:`reset_cache` sets a cache back to
:func:`init_cache`'s values in place.

The logits are ``h.f32 @ W.f32^T``, as in the reference.  For a bf16
unembedding ``W`` (the tied embedding of llama3.2-3b: 128,256 x 3,072) the
model keeps one f32 copy (1.58 GB there) instead of converting it at every
step; :meth:`LM.unembed_f32` rebuilds it when ``W`` changes.

A model with ``cfg.embed_inputs`` (the VLM family, qwen2-vl) prefills from
embeddings (B, S, d) instead of token ids, cast to the compute dtype, and
its :func:`decode_step` takes (B,) token ids or (B, d) embeddings, as the
reference's.  M-RoPE (``cfg.mrope_sections``) rotates through
``layers.positional_rotate``.

Training: :func:`lm_loss` (CE through :func:`chunked_ce_loss` plus 0.01 x
the MoE aux loss), differentiated by autograd, with the flash kernel's
backward on the card.  Its logits are ``h.f32 @ W.f32^T`` per chunk of 512
positions with ``W`` converted once per loss under autograd (not
:meth:`LM.unembed_f32`, which detaches), so a tied embedding gets both its
gradients.  Every family trains: attention through the flash kernels'
backward on the card, a Mamba layer's scan through ``SelectiveScan``'s
backward kernels (``use_kernel=False``: autograd of the plain chunked
scan), a MoE layer's routing and dispatch through autograd (bit-stable
from run to run: ``layers.moe``).  With ``cfg.remat`` each period runs
under ``torch.utils.checkpoint`` (non-reentrant), as the reference wraps
its period in ``jax.checkpoint``: the backward recomputes the period, so a
training step launches the forward kernels twice per attention or Mamba
layer, and a recomputed MoE layer routes every token as the first forward
did (the same inputs, the same deterministic kernels).  With
``cfg.remat_policy == "dots"`` the checkpoint saves the outputs of the
matrix products without batch dimensions and recomputes the rest, as the
reference's ``jax.checkpoint_policies.dots_with_no_batch_dims_saveable``
(:func:`remat_context`); any other policy recomputes the period whole, as
the reference's.  The parameters are built frozen
(``requires_grad=False``) for serving; a trainer turns them on.

Pipelines and context parallelism: :func:`run_stack` is the period stack
without embedding, final norm or head, the unit a pipeline stage runs;
:func:`stage_config` / :func:`init_stage` / :func:`split_stages` give stage
``s`` of ``n`` the layers ``[s L/n, (s+1) L/n)`` (stage 0 also the
embedding), as the reference's ``launch.pipeline_prefill.stage_config``.
Under an ambient mesh whose "model" dimension is above 1
(``layers.ambient_mesh``) with ``cfg.attn_shard == "seq"``,
:func:`run_stack` and :func:`backbone` run the sequence in parallel over
the model ranks (``layers.SeqParallel``): with ``cfg.seq_residual`` the
residual is blocked at their entry and gathered at their exit (a pipeline
stage takes and returns the rank's block: ``run_stack(blocked=True)``),
and a MoE layer takes the reference's sequence-parallel branch (each
rank's (B, S/mm) rows are its share of the (B mm, S/mm) dispatch groups,
data-major and model-minor; capacity budgeted from S/mm; the aux loss
over every group).
A prefill under it fills the whole cache on every model rank.  A loss
under it trains (:func:`lm_loss`): every collective's backward is its
adjoint, the striped flash call has its backward kernels, and under remat
the backward recomputes each period's forward, collectives included, in
the same order on every rank.  The loss is the same on every model rank
(the residual is gathered before the final norm, as without a blocked
residual); ``train.loop.step_body`` scales it and sums the gradients over
the mesh.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.utils.checkpoint
from torch import nn

from ..configs.base import ArchConfig
from . import layers as L


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; raises for CUDA without a card
    (entry points default to ``"cuda"`` and never move to the CPU on their
    own)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the LM runs on the card by "
                           "default; pass device='cpu' to run on the CPU")
    return dev


def _keep_all(name: str, t: torch.Tensor) -> torch.Tensor:
    return t


def _frozen(params: dict, keep: Callable = _keep_all,
            prefix: str = "") -> nn.ParameterDict:
    """Tensors as frozen parameters; a nested dict (MoE's ``shared`` MLP)
    becomes a nested ``ParameterDict``.  ``keep(name, t)`` gives what the
    parameter ``prefix + name`` holds of ``t`` (a rank's shard: a model
    built under a mesh, ``models.build_model``)."""
    return nn.ParameterDict({
        k: _frozen(t, keep, f"{prefix}{k}.") if isinstance(t, dict) else
        nn.Parameter(keep(prefix + k, t), requires_grad=False)
        for k, t in params.items()})


# --------------------------------------------------------------------- remat
# the products "dots" saves: a matmul without batch dimensions reaches the
# dispatcher as mm or addmm (an (B, S, d) @ (d, f) product is folded to 2-D
# first); batched products (bmm, the einsums of attention and of the MoE
# experts) and the kernels' autograd Functions are recomputed
_DOTS_SAVED = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    from torch.utils.checkpoint import CheckpointPolicy
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS_SAVED
            else CheckpointPolicy.PREFER_RECOMPUTE)


def remat_context(cfg: ArchConfig) -> Callable:
    """``torch.utils.checkpoint``'s ``context_fn`` for ``cfg.remat_policy``:
    for "dots" a selective checkpoint that saves :data:`_DOTS_SAVED`'s
    outputs (the reference's ``dots_with_no_batch_dims_saveable``), else
    the default, which saves nothing inside the period."""
    if cfg.remat_policy == "dots":
        from torch.utils.checkpoint import (
            create_selective_checkpoint_contexts)
        return functools.partial(create_selective_checkpoint_contexts,
                                 _dots_policy)
    return torch.utils.checkpoint.noop_context_fn


# ------------------------------------------------------------------ structure
def period_structure(cfg: ArchConfig) -> List[Dict[str, str]]:
    """Per position within one period: mixer kind + ffn kind."""
    pat = cfg.layer_period or "A"
    out = []
    for i, kind in enumerate(pat):
        out.append({
            "mixer": "attn" if kind == "A" else "mamba",
            "ffn": "moe" if cfg.moe_layer(i) else "dense",
        })
    return out


def n_periods(cfg: ArchConfig) -> int:
    plen = len(cfg.layer_period or "A")
    if cfg.n_layers % plen:
        raise ValueError(f"{cfg.name}: {cfg.n_layers} layers are not whole "
                         f"periods of {plen}")
    return cfg.n_layers // plen


# ----------------------------------------------------------------- parameters
class Block(nn.Module):
    """One layer of the position ``spec``: pre-norm mixer (``attn`` or
    ``mamba``) + pre-norm FFN (``mlp`` or ``moe``), as the reference's
    ``init_position``."""

    def __init__(self, cfg: ArchConfig, gen: torch.Generator,
                 spec: Dict[str, str], keep: Callable = _keep_all,
                 prefix: str = ""):
        super().__init__()
        self.spec = dict(spec)
        dev = gen.device
        self.norm1 = _frozen(L.init_norm(cfg, cfg.d_model, dev), keep,
                             prefix + "norm1.")
        self.norm2 = _frozen(L.init_norm(cfg, cfg.d_model, dev), keep,
                             prefix + "norm2.")
        if spec["mixer"] == "attn":
            self.attn = _frozen(L.init_attention(cfg, gen), keep,
                                prefix + "attn.")
        else:
            self.mamba = _frozen(L.init_mamba(cfg, gen), keep,
                                 prefix + "mamba.")
        if spec["ffn"] == "moe":
            self.moe = _frozen(L.init_moe(cfg, gen), keep, prefix + "moe.")
        else:
            self.mlp = _frozen(L.init_mlp(cfg, gen), keep, prefix + "mlp.")

    def groups(self) -> Tuple[str, ...]:
        """The parameter groups, in the reference's names."""
        return ("norm1", "norm2",
                "attn" if self.spec["mixer"] == "attn" else "mamba",
                "moe" if self.spec["ffn"] == "moe" else "mlp")


class F32Unembedding:
    """The f32 unembedding of a model whose :meth:`unembed_weight` (V, d)
    may be bf16: one f32 copy, kept until the matrix's data or version
    changes, instead of a conversion at every step."""

    _unembed = None
    _unembed_key = None

    def unembed_weight(self) -> torch.Tensor:
        raise NotImplementedError

    def unembed_f32(self) -> torch.Tensor:
        """The unembedding matrix (V, d) in f32: itself when it is f32, else
        a copy kept until the matrix's data or version changes."""
        w = self.unembed_weight()
        if w.dtype == torch.float32:
            return w
        key = (w.data_ptr(), w._version)
        if key != self._unembed_key:
            self._unembed = None                 # free the old copy first
            self._unembed = w.detach().to(torch.float32)
            self._unembed_key = key
        return self._unembed


def _vocab_table(cfg: ArchConfig, gen: torch.Generator,
                 keep: Callable = _keep_all, name: str = "embed"
                 ) -> nn.Parameter:
    """A (V, d) embedding or head drawn from ``gen``, as the reference's
    (what ``keep`` keeps of it)."""
    t = torch.randn((cfg.vocab_size, cfg.d_model), generator=gen,
                    device=gen.device) * 0.02
    return nn.Parameter(keep(name, t.to(L._dtype(cfg.param_dtype))),
                        requires_grad=False)


class LM(F32Unembedding, nn.Module):
    """An LM's parameters on one device, initialised from ``seed`` by a
    ``torch.Generator`` on that device.  The same seed gives other numbers
    than the reference's ``jax.random`` init: carry the reference's weights
    across with ``models.convert.params_from_reference``.  ``keep(name,
    t)``: what parameter ``name`` holds of its whole tensor ``t``, made
    one layer's group at a time (a rank's shard, ``models.build_model``
    under a mesh: the same values as the one-card model's).  ``shards``:
    the model's layout on a mesh (``sharding.rules.ModelShards``), or
    None."""

    shards = None

    def __init__(self, cfg: ArchConfig, device="cuda", seed: int = 0,
                 keep: Callable = _keep_all):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        gen = torch.Generator(device=dev).manual_seed(seed)
        struct = period_structure(cfg)
        n_periods(cfg)                   # whole periods, or raise
        self.layers = nn.ModuleList(Block(cfg, gen, struct[i % len(struct)],
                                          keep, f"layers.{i}.")
                                    for i in range(cfg.n_layers))
        self.embed = _vocab_table(cfg, gen, keep, "embed")
        self.final_norm = _frozen(L.init_norm(cfg, cfg.d_model, dev), keep,
                                  "final_norm.")
        self.lm_head: Optional[nn.Parameter] = None
        if not cfg.tie_embeddings:
            self.lm_head = _vocab_table(cfg, gen, keep, "lm_head")

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def unembed_weight(self) -> torch.Tensor:
        return unembed_matrix(self.cfg, self)

    def init_cache(self, batch: int, max_len: int) -> Dict:
        return init_cache(self.cfg, batch, max_len, self.device,
                          model_part(self.cfg, self, batch, max_len))

    def prefill(self, tokens, max_len: int, use_kernel: bool = True,
                cache: Optional[Dict] = None):
        return prefill(self.cfg, self, tokens, max_len, use_kernel, cache)

    def decode_step(self, cache: Dict, tokens, use_kernel: bool = True):
        return decode_step(self.cfg, self, cache, tokens, use_kernel)


def init_lm(cfg: ArchConfig, device="cuda", seed: int = 0) -> LM:
    return LM(cfg, device, seed)


def _layer(model, per: int, pos_i: int, plen: int) -> Block:
    return model.layers[per * plen + pos_i]


# ------------------------------------------------------------------- stages
def stage_config(cfg: ArchConfig, n_stages: int) -> ArchConfig:
    """The config of one of ``n_stages`` pipeline stages: ``n_layers / n``
    layers, whole periods (the reference's
    ``launch.pipeline_prefill.stage_config``)."""
    if n_stages < 1 or cfg.n_layers % n_stages:
        raise ValueError(f"{cfg.name}: {cfg.n_layers} layers do not split "
                         f"into {n_stages} stages")
    scfg = dataclasses.replace(cfg, n_layers=cfg.n_layers // n_stages)
    n_periods(scfg)                      # whole periods, or raise
    return scfg


class Stage(nn.Module):
    """Pipeline stage ``sid`` of ``n_stages`` of a model of ``cfg``: its
    layers ``[sid L/n, (sid+1) L/n)`` and, on stage 0, the embedding
    (``embed`` is None elsewhere).  ``cfg`` is the whole model's; the
    stage runs as :func:`run_stack` of :func:`stage_config`'s config."""

    def __init__(self, cfg: ArchConfig, sid: int, n_stages: int, layers,
                 embed: Optional[nn.Parameter]):
        super().__init__()
        stage_config(cfg, n_stages)              # whole periods, or raise
        self.cfg, self.sid, self.n_stages = cfg, sid, n_stages
        self.layers = nn.ModuleList(layers)
        self.embed = embed

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device


def stage_layers(cfg: ArchConfig, sid: int, n_stages: int) -> range:
    """The layers stage ``sid`` of ``n_stages`` holds."""
    per = stage_config(cfg, n_stages).n_layers
    return range(sid * per, (sid + 1) * per)


def split_stages(model: LM, n_stages: int) -> List[Stage]:
    """``model``'s stages, holding its own parameters (no copy)."""
    cfg = model.cfg
    return [Stage(cfg, s, n_stages,
                  [model.layers[i] for i in stage_layers(cfg, s, n_stages)],
                  model.embed if s == 0 else None)
            for s in range(n_stages)]


def init_stage(cfg: ArchConfig, sid: int, n_stages: int, device="cuda",
               seed: int = 0) -> Stage:
    """Stage ``sid`` of ``n_stages`` of ``LM(cfg, device, seed)``, bit for bit,
    holding only that stage's parameters: the model's generator is run
    through every layer in :class:`LM`'s order (on ``device``, as the
    model's), and only the stage's layers (and, on stage 0, the embedding,
    drawn after them) are kept."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    struct = period_structure(cfg)
    n_periods(cfg)
    keep = stage_layers(cfg, sid, n_stages)
    layers = []
    for i in range(cfg.n_layers):
        block = Block(cfg, gen, struct[i % len(struct)])
        if i in keep:
            layers.append(block)
        del block
    embed = _vocab_table(cfg, gen) if sid == 0 else None
    return Stage(cfg, sid, n_stages, layers, embed)


# -------------------------------------------------------------------- forward
def _ffn(cfg: ArchConfig, p: Block, h, aux_groups=()):
    """The position's FFN on h (B, S, d); MoE dispatches each row's S tokens
    as one group.  Returns (y, aux loss or None for a dense MLP).  Under a
    blocked residual h is the rank's (B, S/mm, d): the reference's
    sequence-parallel MoE, its aux loss over every rank's groups
    (``aux_groups``: ``layers.aux_groups``, also over every data
    rank's)."""
    if p.spec["ffn"] == "moe":
        return L.moe(cfg, p.moe, h, aux_groups=aux_groups)
    return L.mlp(cfg, p.mlp, h), None


def _position_block(cfg: ArchConfig, p: Block, x, pos, kv_out: bool = False,
                    use_kernel: bool = True,
                    cp: Optional[L.SeqParallel] = None, aux_groups=()):
    """One layer: pre-norm mixer + pre-norm FFN.  Returns (x, aux, extras):
    aux is the MoE aux loss (None for a dense MLP); extras are the layer's
    (k, v) for attention or (conv_state, ssm_state) for Mamba when
    ``kv_out``, else None.  ``cp``: context parallelism (x and pos the
    rank's block under a blocked residual); ``aux_groups``: :func:`_ffn`'s.
    Both are decided once a stack, outside remat, so that a recomputed
    period issues the collectives of its first run."""
    extras = None
    h = L.apply_norm(cfg, p.norm1, x)
    if p.spec["mixer"] == "attn":
        out = L.attention(cfg, p.attn, h, pos, kv_out=kv_out,
                          use_kernel=use_kernel, cp=cp)
    else:
        out = L.mamba(cfg, p.mamba, h, return_state=kv_out,
                      use_kernel=use_kernel, cp=cp)
    y, extras = out if kv_out else (out, None)
    x = x + y
    h = L.apply_norm(cfg, p.norm2, x)
    y, aux = _ffn(cfg, p, h, aux_groups)
    return x + y, aux, extras


def _periods(cfg: ArchConfig, layers, x, pos, collect_cache: bool,
             use_kernel: bool, blocked: bool = False):
    """The period loop over ``layers`` (a model or a stage): x (B, S, d) ->
    (x, aux loss, caches | None).  Under context parallelism
    (``layers.seq_parallel``) with a blocked residual, x and pos are cut to
    the rank's block here and x gathered whole at the end; with
    ``blocked`` they come as the block and x leaves as it."""
    struct = period_structure(cfg)
    caches: List[List] = [[] for _ in struct]
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    cp = residual_block(cfg, x.shape[1], blocked)
    if cp is not None and cp.residual and not blocked:
        x, pos = cp.block(x), cp.block(pos, dim=-1)
    groups = L.aux_groups(cp)

    def period_run(x, per):
        a_total = torch.zeros((), dtype=torch.float32, device=x.device)
        for pos_i in range(len(struct)):
            p = _layer(layers, per, pos_i, len(struct))
            x, a, extra = _position_block(cfg, p, x, pos,
                                          kv_out=collect_cache,
                                          use_kernel=use_kernel, cp=cp,
                                          aux_groups=groups)
            if a is not None:
                a_total = a_total + a
            if collect_cache:
                caches[pos_i].append(extra)
        return x, a_total

    for per in range(n_periods(cfg)):
        if cfg.remat and not collect_cache and torch.is_grad_enabled():
            x, a = torch.utils.checkpoint.checkpoint(
                period_run, x, per, use_reentrant=False,
                preserve_rng_state=False, context_fn=remat_context(cfg))
        else:
            x, a = period_run(x, per)
        aux = aux + a
    if cp is not None and cp.residual and not blocked:
        x = cp.gather(x)
    return x, aux, (caches if collect_cache else None)


def residual_block(cfg: ArchConfig, s: int, blocked: bool = False
                   ) -> Optional[L.SeqParallel]:
    """The context parallelism of a sequence of ``s`` rows (``layers.
    seq_parallel``); with ``blocked``, ``s`` is the rows of a rank's block
    of a blocked residual, which must then be what the ambient mesh and
    ``cfg`` give."""
    if not blocked:
        return L.seq_parallel(cfg, s)
    cp = L.seq_parallel(cfg, s * L._mesh_axis("model"))
    if cp is None or not cp.residual:
        raise ValueError(f"{cfg.name}: blocked rows given, but there is no "
                         f"blocked residual under the ambient mesh")
    return cp


def run_stack(cfg: ArchConfig, layers, x, pos, use_kernel: bool = True,
              blocked: bool = False):
    """The period stack of ``layers`` (an :class:`LM` or a :class:`Stage`
    whose ``cfg`` is ``cfg``) on x (B, S, d), without embedding, final norm
    or head: the unit a pipeline stage runs.  The aux loss is dropped, as in
    the reference (stages serve).  ``blocked``: under a blocked residual, x
    and pos are this rank's rows (B, S/mm, d) and so is the result, so that
    a pipeline hops a rank's block and not the whole sequence."""
    return _periods(cfg, layers, x, pos, False, use_kernel, blocked)[0]


def backbone(cfg: ArchConfig, model: LM, x, pos, collect_cache: bool = False,
             use_kernel: bool = True):
    """x (B, S, d) -> (h (B, S, d), aux loss, caches | None).

    ``collect_cache``: also return, per period position, the list over
    periods of the layer's (k, v), each (B, S, Hkv, hd), or (conv_state,
    ssm_state), for prefill.  Without it, where autograd records the call
    and ``cfg.remat``, each period runs under ``torch.utils.checkpoint``
    (training)."""
    x, aux, caches = _periods(cfg, model, x, pos, collect_cache, use_kernel)
    h = L.apply_norm(cfg, model.final_norm, x)
    return h, aux, caches


def embed_tokens(cfg: ArchConfig, model: LM, tokens):
    """Token ids (B, S) through the embedding table; with
    ``cfg.embed_inputs`` the input is already (B, S, d) embeddings, cast to
    the compute dtype."""
    if cfg.embed_inputs:
        return tokens.to(L._dtype(cfg.compute_dtype))
    return vocab_lookup(model.embed, tokens)


def _vocab_part(w) -> Tuple[Optional[object], int]:
    """(the "model" group, this rank's first row) of a (V, d) table split
    over "model" (vocab parallelism), else (None, 0)."""
    group = L._model_group(w, 0)
    if group is None:
        return None, 0
    return group, L._model_place()[1] * w.shape[0]


def vocab_lookup(w, tokens):
    """``w[tokens]``; on a rank's rows of a table split over "model" each
    rank looks up the tokens in its rows (zeros elsewhere) and the rows
    are summed over "model" (one non-zero term each: exact)."""
    group, lo = _vocab_part(w)
    w = L.use(w)
    if group is None:
        return w[tokens]
    n = w.shape[0]
    local = tokens - lo
    inside = (local >= 0) & (local < n)
    x = w[local.clamp(0, n - 1)] * inside[..., None].to(w.dtype)
    return L.reduce_model(x, group)


def unembed_matrix(cfg: ArchConfig, model: LM):
    return model.embed if cfg.tie_embeddings else model.lm_head


def _logits(model: LM, h):
    """h (B, d) -> logits (B, V) f32; on a rank's rows of an unembedding
    split over "model" (vocab parallelism) the rank's columns (B, V/mm),
    the reference's ``logit_sh`` (``models.gather_logits`` makes them
    whole).  A table that FSDP splits over "data" is gathered first."""
    table = unembed_matrix(model.cfg, model)
    if any(L._split_over(table, a, 1) for a in ("data", "pod")):
        return h.to(torch.float32) @ L.use(table).to(torch.float32).T
    return h.to(torch.float32) @ model.unembed_f32().T


# ------------------------------------------------------------------- training
def chunked_ce_loss(cfg: ArchConfig, model: LM, h, labels, chunk: int = 512):
    """Mean CE over the B x S tokens, the (B, c, V) f32 logits made one
    chunk of ``chunk`` positions at a time (the whole S where it does not
    divide), as the reference's.  The unembedding is converted to f32 once,
    under autograd.  On a rank's rows of an unembedding split over "model"
    (vocab parallelism) each rank makes (B, c, V/mm) logits and the
    logsumexp and the gold logit are reduced over "model": no rank holds
    the whole (B, c, V)."""
    b, s, _ = h.shape
    table = unembed_matrix(cfg, model)
    group, lo = _vocab_part(table)
    w = L.use(table).to(torch.float32)                     # (V, d)
    chunk = min(chunk, s)
    if s % chunk:
        chunk = s
    labels = labels.to(torch.int64)
    tot = torch.zeros((), dtype=torch.float32, device=h.device)
    for c0 in range(0, s, chunk):
        logits = h[:, c0:c0 + chunk].to(torch.float32) @ w.T
        lab = labels[:, c0:c0 + chunk]
        if group is None:
            lse = torch.logsumexp(logits, dim=-1)
            gold = torch.gather(logits, -1, lab[..., None])[..., 0]
        else:
            lse, gold = _vocab_parallel_ce(logits, lab - lo, group)
        tot = tot + torch.sum(lse - gold)
    return tot / (b * s)


def _vocab_parallel_ce(logits, lab, group):
    """(logsumexp, gold logit) of rows whose logits (B, c, V/mm) are this
    rank's columns of the vocabulary, ``lab`` the labels less its first
    column: the max over every rank's columns (a constant to the
    gradient), the sums of exponentials and the gold logit (held by one
    rank) summed over ``group``."""
    from ..distributed import comm
    with torch.no_grad():
        top = comm.all_gather(logits.amax(-1)[None], group, 0).amax(0)
    total = L.reduce_model(torch.exp(logits - top[..., None]).sum(-1), group)
    n = logits.shape[-1]
    inside = (lab >= 0) & (lab < n)
    gold = torch.gather(logits, -1, lab.clamp(0, n - 1)[..., None])[..., 0]
    gold = L.reduce_model(gold * inside, group)
    return top + torch.log(total), gold


def lm_loss(cfg: ArchConfig, model: LM, batch: Dict,
            use_kernel: bool = True) -> Tuple[torch.Tensor, Dict]:
    """batch: {'tokens' (B, S) or 'embeds' (B, S, d), 'labels' (B, S),
    optional 'positions'} as tensors on the model's device ->
    (CE + 0.01 x aux, {"ce", "aux"}).  Under context parallelism every
    model rank computes the same loss (of its data rank's batch)."""
    tokens = batch.get("embeds", batch.get("tokens"))
    b, s = tokens.shape[:2]
    pos = batch.get("positions")
    if pos is None:
        pos = torch.arange(s, device=tokens.device)[None].expand(b, s)
    x = embed_tokens(cfg, model, tokens)
    h, aux, _ = backbone(cfg, model, x, pos, use_kernel=use_kernel)
    ce = chunked_ce_loss(cfg, model, h, batch["labels"])
    return ce + 0.01 * aux, {"ce": ce, "aux": aux}


# --------------------------------------------------------------------- decode
def serve_part(cfg: ArchConfig, batch: int, max_len: int,
               mesh) -> L.CachePart:
    """The rank's part of a serving cache of ``batch`` rows and ``max_len``
    positions on ``mesh`` (``layers.CachePart``): the whole cache's
    ``sharding.rules.cache_placements``, read at this rank's coordinates."""
    from ..sharding import rules
    whole = init_cache(cfg, batch, max_len, "meta")
    places = rules.cache_placements(cfg, whole, mesh)
    coords, sizes = rules.mesh_coords(mesh), rules.mesh_sizes(mesh)
    shapes = rules._tree_zip(
        lambda t, place: rules.local_shape(t.shape, place, sizes), whole,
        places)

    def part(entry, n):
        if entry is None:
            return None
        i, count = rules._part(entry, coords, sizes)
        return i * (n // count), n // count

    row_entry = places["length"].spec[0]
    window = heads = dims = None
    for entry in places["layers"]:
        if "k" in entry:
            _, _, sspec, hspec, dspec = entry["k"].spec
            window = part(sspec, max_len)
            heads = part(hspec, cfg.n_kv_heads)
            if heads is not None:
                heads = (heads[0], heads[0] + heads[1])
            dims = part(dspec, cfg.hd)
            if dims is not None:
                dims = (dims[0], dims[0] + dims[1])
            break
    return L.CachePart(places, shapes, row_entry, part(row_entry, batch),
                       window, heads, dims)


def init_cache(cfg: ArchConfig, batch: int, max_len: int, device,
               part: Optional[L.CachePart] = None) -> Dict:
    """Decode cache: per period position, leaves stacked over periods.  Every
    leaf is its own tensor (the reference may share one immutable array
    between k and v; here they are written in place).  With ``part`` (a
    model built under a mesh, :func:`serve_part`) the rank's part of each
    leaf, and the part itself under ``"part"``."""
    struct = period_structure(cfg)
    np_ = n_periods(cfg)
    cdt = L._dtype(cfg.compute_dtype)
    entries = []
    for i, spec in enumerate(struct):
        shape_of = (lambda name, shape: shape) if part is None else \
            (lambda name, shape, i=i: part.shapes["layers"][i][name])
        # an attention-free model (falcon-mamba-7b) has no heads: only an
        # attention position has a KV shape
        shape = (np_, batch, max_len, cfg.n_kv_heads, cfg.hd) \
            if spec["mixer"] == "attn" else None
        if spec["mixer"] == "mamba":
            s = L._ssm(cfg)
            din = s.expand * cfg.d_model
            entries.append({
                "conv": torch.zeros(shape_of("conv", (np_, batch, s.conv - 1,
                                                      din)),
                                    dtype=cdt, device=device),
                "ssm": torch.zeros(shape_of("ssm", (np_, batch, din,
                                                    s.state)),
                                   dtype=torch.float32, device=device)})
        elif cfg.kv_dtype == "int8":
            sshape = shape[:-1] + (1,)
            entries.append({
                "k": torch.zeros(shape_of("k", shape), dtype=torch.int8,
                                 device=device),
                "v": torch.zeros(shape_of("v", shape), dtype=torch.int8,
                                 device=device),
                "k_scale": torch.ones(shape_of("k_scale", sshape),
                                      dtype=torch.float32, device=device),
                "v_scale": torch.ones(shape_of("v_scale", sshape),
                                      dtype=torch.float32, device=device)})
        else:
            entries.append({
                "k": torch.zeros(shape_of("k", shape), dtype=cdt,
                                 device=device),
                "v": torch.zeros(shape_of("v", shape), dtype=cdt,
                                 device=device)})
    rows = batch if part is None else part.shapes["length"][0]
    cache = {"layers": entries,
             "length": torch.zeros((rows,), dtype=torch.int32,
                                   device=device)}
    if part is not None:
        cache["part"] = part
    return cache


def reset_cache(cache: Dict) -> None:
    """Set ``cache`` in place to :func:`init_cache`'s values: zeros, int8
    scales one, length 0."""
    for entry in cache["layers"]:
        for name, leaf in entry.items():
            leaf.fill_(1 if name.endswith("_scale") else 0)
    cache["length"].zero_()


def _check_cache(cfg: ArchConfig, cache: Dict, batch: int,
                 max_len: int, part: Optional[L.CachePart] = None) -> None:
    """Raise unless ``cache`` has :func:`init_cache`'s structure, shapes and
    dtypes for ``batch`` rows of ``max_len`` positions (with ``part``: the
    rank's part of them)."""
    want = init_cache(cfg, batch, max_len, "meta", part)
    got_layers = cache["layers"]
    ok = len(got_layers) == len(want["layers"]) and all(
        set(g) == set(w) and all(
            g[n].shape == w[n].shape and g[n].dtype == w[n].dtype
            for n in w) for g, w in zip(got_layers, want["layers"]))
    length = cache["length"]
    ok = ok and (part is None) == ("part" not in cache) and (
        part is None or cache["part"] == part)
    if not ok or length.shape != want["length"].shape or \
            length.dtype != torch.int32:
        raise ValueError(f"{cfg.name}: the cache is not one of {batch} rows "
                         f"of {max_len} positions"
                         + ("" if part is None else " as this rank holds "
                            "them"))


def model_part(cfg: ArchConfig, model: LM, batch: int,
               max_len: int) -> Optional[L.CachePart]:
    """The rank's part of a serving cache for a model built under a mesh
    (``model.shards``; the mesh ambient), else None (the one-card
    cache)."""
    if getattr(model, "shards", None) is None:
        return None
    return serve_part(cfg, batch, max_len, model.shards.mesh)


def decode_step(cfg: ArchConfig, model: LM, cache: Dict, tokens,
                use_kernel: bool = True):
    """One token for every sequence.  tokens (B,) integer or, with
    ``cfg.embed_inputs``, (B, d) embeddings (cast to the compute dtype).

    Updates ``cache`` in place, ``cache["length"]`` too (the same tensor,
    advanced by one after the last layer), and returns (logits (B, V) f32,
    cache).  The step reads nothing back to the host and allocates no
    shape that depends on the data, so it can be captured as a CUDA graph
    (``serve.graphs.DecodeGraph``).  Every row's length must stay
    below the cache's ``max_len`` for its token to be kept (the reference
    drops it too).  A MoE layer routes the B tokens as one dispatch group,
    as the reference does, so its capacity couples the rows.

    Under a mesh (a cache of :func:`init_cache` with ``part``) ``tokens``
    are the whole batch's; the rank decodes its rows on its part of the
    cache (``layers.attention_decode``, ``layers.mamba_decode``), a MoE
    layer gathers every rank's rows over the batch axes before routing,
    and the logits are the rank's block (:func:`_logits`)."""
    struct = period_structure(cfg)
    length = cache["length"]
    part = cache.get("part")
    if part is not None:
        tokens = part.my_rows(tokens)
    if cfg.embed_inputs and tokens.dim() == 2:
        x = tokens[:, None].to(L._dtype(cfg.compute_dtype))
    else:
        x = vocab_lookup(model.embed, tokens)[:, None]  # (B, 1, d)
    quant = cfg.kv_dtype == "int8"
    # positions outer, periods inner: the reference's loop order
    for pos_i, spec in enumerate(struct):
        c = cache["layers"][pos_i]
        for per in range(n_periods(cfg)):
            p = _layer(model, per, pos_i, len(struct))
            h = L.apply_norm(cfg, p.norm1, x)
            if spec["mixer"] == "mamba":
                y, nconv, nssm = L.mamba_decode(cfg, p.mamba, h,
                                                c["conv"][per],
                                                c["ssm"][per])
                c["conv"][per] = nconv
                c["ssm"][per] = nssm
            elif quant:
                y = L.attention_decode(cfg, p.attn, h, c["k"][per],
                                       c["v"][per], length,
                                       c["k_scale"][per], c["v_scale"][per],
                                       use_kernel=use_kernel, part=part)
            else:
                y = L.attention_decode(cfg, p.attn, h, c["k"][per],
                                       c["v"][per], length,
                                       use_kernel=use_kernel, part=part)
            x = x + y
            h = L.apply_norm(cfg, p.norm2, x)
            if spec["ffn"] == "moe":
                x = x + _moe_decode(cfg, p, h, part)
            else:
                x = x + L.mlp(cfg, p.mlp, h)
    h = L.apply_norm(cfg, model.final_norm, x)[:, 0]      # (B, d)
    length.add_(1)
    return _logits(model, h), cache


def _moe_decode(cfg: ArchConfig, p: Block, h, part):
    """A MoE layer at decode, h (B, 1, d): the step's B tokens are one
    dispatch group, as in the reference; under a mesh whose batch axes
    split the rows, every rank's rows are gathered and routed together,
    and this rank's kept."""
    hh = h.transpose(0, 1)                                 # (1, B, d)
    if part is not None:
        hh = part.all_rows(hh, 1)
    y, _ = L.moe(cfg, p.moe, hh)
    if part is not None:
        y = part.my_rows(y, 1)
    return y.transpose(0, 1)


def prefill(cfg: ArchConfig, model: LM, tokens, max_len: int,
            use_kernel: bool = True, cache: Optional[Dict] = None):
    """Process a full prompt, tokens (B, S) or, with ``cfg.embed_inputs``,
    embeddings (B, S, d); return (last_logits (B, V) f32, filled cache).

    Given ``cache`` (B rows of ``max_len`` positions, as :func:`init_cache`
    makes them), the prompt's state is written into it, in place, instead
    of into a new cache: its first S positions, the Mamba states and the
    length.  The rest is left as it was, so a caller that reuses a cache
    resets it first (:func:`reset_cache`).

    For a model built under a mesh (``model.shards``, the mesh ambient)
    ``tokens`` are the whole batch's: the rank prefills its rows where the
    batch axes split them (else every row), and writes its part of the
    cache (:func:`serve_part`): its KV heads, or its slice of the head dim
    (every head computed, an int8 cache's codes from the whole head's
    scale), or its window of the positions; its channels of the Mamba
    states.  The logits are the rank's block (:func:`_logits`)."""
    b, s = tokens.shape[:2]
    if s > max_len:
        raise ValueError(f"prompt of {s} tokens does not fit a cache of "
                         f"{max_len}")
    dev = model.device
    part = model_part(cfg, model, b, max_len)
    if cache is None:
        cache = init_cache(cfg, b, max_len, dev, part)
    else:
        _check_cache(cfg, cache, b, max_len, part)
    # the rank's rows, its positions' window and its slice of the head dim
    rows, (w0, n), (d0, d1) = b, (0, s), (0, None)
    if part is not None:
        tokens = part.my_rows(tokens)
        rows = tokens.shape[0]
        if part.window is not None:
            w0 = part.window[0]
            n = max(0, min(s, w0 + part.window[1]) - w0)
        if part.dims is not None:
            d0, d1 = part.dims
    pos = torch.arange(s, device=dev)[None].expand(rows, s)
    x = embed_tokens(cfg, model, tokens)
    h, _, extras = backbone(cfg, model, x, pos, collect_cache=True,
                            use_kernel=use_kernel)
    for pos_i, c in enumerate(cache["layers"]):
        for per, ex in enumerate(extras[pos_i]):
            if "conv" in c:
                c["conv"][per] = ex[0]
                c["ssm"][per] = ex[1]
                continue
            k, v = (t[:, w0:w0 + n] for t in ex)
            if cfg.kv_dtype == "int8":
                # the codes of the whole head's scale, then the rank's slice
                k8, ks = L.kv_quantize(k)
                v8, vs = L.kv_quantize(v)
                c["k"][per, :, :n] = k8[..., d0:d1]
                c["v"][per, :, :n] = v8[..., d0:d1]
                c["k_scale"][per, :, :n] = ks
                c["v_scale"][per, :, :n] = vs
            else:
                c["k"][per, :, :n] = k[..., d0:d1]
                c["v"][per, :, :n] = v[..., d0:d1]
    cache["length"].fill_(s)
    return _logits(model, h[:, -1]), cache
