"""Dataflow-graph IR for the cmnnc compiler (paper §3).

The paper consumes ONNX models; offline we provide an equivalent in-memory IR
with the same semantics: a DAG of operator nodes over named tensors, plus
initializer data (weights).  Tensors are single-image, channel-first:
``(C, H, W)`` — the paper ignores the outer (streaming) batch loop (§3.3).

Supported ops (the CNN families the paper targets):
  conv2d   — lowered to the crossbar MxV (paper Listing 1)
  gemm     — fully-connected layer, also a crossbar op
  relu     — DPU elementwise
  add      — DPU elementwise (skip connections, paper Fig. 2)
  maxpool2d / avgpool2d — DPU windowed reduction
  global_avgpool — DPU reduction
  flatten  — layout-only

Transformer extension — sequences ride the same ``(C, H, W)``
layout with **channels = feature dim, H = tokens, W = 1**, so a per-token
op iterates ``(T, 1)`` exactly like a conv iterates output pixels, and a
1x1 ``conv2d`` is a per-token linear projection (Q/K/V/O and the MLP gemms
stay weight-stationary crossbar ops, unchanged):
  layernorm — DPU row-wise normalization over the channel dim (per token)
  softmax   — DPU row-wise softmax over the channel dim (per score row)
  matmul    — *dynamic* activation×activation matmul (QKᵀ / attn·V).  Both
              operands are streamed activations, so it cannot live on a
              weight-stationary crossbar: it lowers to a DPU partition of
              its own, reading operand ``a`` pointwise (one token per
              iteration) and operand ``b`` broadcast (every iteration needs
              the whole array).
  transpose — DPU channel<->token swap ``(C, T, 1) -> (T, C, 1)``
              (broadcast read, own partition — like matmul's ``b``)
  reshape   — layout-only alias (generalized flatten)

Port copy of ``repro.core.graph``: the same code, with every import inside
``repro_torch``; ``tests/test_torch_*.py`` hold the two equal.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

CROSSBAR_OPS = ("conv2d", "gemm")
# DPU ops that read a producer array non-pointwise (whole-array broadcast):
# they must head their own crossbar-less partition — fused into a producer's
# partition they would read values that iteration hasn't produced yet.
BROADCAST_DPU_OPS = ("matmul", "transpose")
# Layout-only ops: never executed, resolved as aliases at lowering.
ALIAS_OPS = ("flatten", "reshape")


@dataclasses.dataclass(frozen=True)
class ValueInfo:
    """Shape/dtype metadata for a named tensor."""

    name: str
    shape: Tuple[int, ...]
    dtype: str = "float32"

    @property
    def nbytes(self) -> int:
        return int(np.prod(self.shape)) * np.dtype(self.dtype).itemsize


@dataclasses.dataclass
class Node:
    """A single operator in the dataflow graph."""

    name: str
    op: str
    inputs: List[str]
    outputs: List[str]
    attrs: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"Node({self.name}:{self.op} {self.inputs}->{self.outputs})"


class Graph:
    """A DAG of nodes.  Nodes are stored in topological order."""

    def __init__(self) -> None:
        self.nodes: List[Node] = []
        self.values: Dict[str, ValueInfo] = {}
        self.weights: Dict[str, np.ndarray] = {}
        self.inputs: List[str] = []
        self.outputs: List[str] = []

    # ------------------------------------------------------------------ build
    def add_input(self, name: str, shape: Sequence[int], dtype: str = "float32") -> str:
        self.values[name] = ValueInfo(name, tuple(shape), dtype)
        self.inputs.append(name)
        return name

    def add_weight(self, name: str, data: np.ndarray) -> str:
        self.weights[name] = np.asarray(data, dtype=np.float32)
        self.values[name] = ValueInfo(name, tuple(data.shape), "float32")
        return name

    def add_node(self, node: Node, out_shape: Sequence[int], dtype: str = "float32") -> str:
        for i in node.inputs:
            if i not in self.values:
                raise ValueError(f"{node.name}: unknown input {i!r}")
        (out,) = node.outputs
        if out in self.values:
            raise ValueError(f"{node.name}: output {out!r} already defined (SSA)")
        self.values[out] = ValueInfo(out, tuple(out_shape), dtype)
        self.nodes.append(node)
        return out

    def mark_output(self, name: str) -> None:
        self.outputs.append(name)

    # ------------------------------------------------------------- operators
    def conv2d(self, name: str, x: str, w: str, bias: Optional[str] = None,
               stride: int = 1, pad: int = 0) -> str:
        fl, c, fh, fw = self.values[w].shape
        ci, h, wd = self.values[x].shape
        assert c == ci, f"{name}: channel mismatch {c} vs {ci}"
        oh = (h + 2 * pad - fh) // stride + 1
        ow = (wd + 2 * pad - fw) // stride + 1
        inputs = [x, w] + ([bias] if bias else [])
        node = Node(name, "conv2d", inputs, [name + ":out"],
                    dict(stride=stride, pad=pad))
        return self.add_node(node, (fl, oh, ow))

    def gemm(self, name: str, x: str, w: str, bias: Optional[str] = None) -> str:
        od, idim = self.values[w].shape
        (xin,) = (int(np.prod(self.values[x].shape)),)
        assert idim == xin, f"{name}: gemm dim mismatch {idim} vs {xin}"
        inputs = [x, w] + ([bias] if bias else [])
        node = Node(name, "gemm", inputs, [name + ":out"], {})
        return self.add_node(node, (od,))

    def relu(self, name: str, x: str) -> str:
        node = Node(name, "relu", [x], [name + ":out"], {})
        return self.add_node(node, self.values[x].shape)

    def add(self, name: str, a: str, b: str) -> str:
        assert self.values[a].shape == self.values[b].shape, \
            f"{name}: add shape mismatch"
        node = Node(name, "add", [a, b], [name + ":out"], {})
        return self.add_node(node, self.values[a].shape)

    def maxpool2d(self, name: str, x: str, k: int = 2, stride: int = 2) -> str:
        c, h, w = self.values[x].shape
        oh, ow = (h - k) // stride + 1, (w - k) // stride + 1
        node = Node(name, "maxpool2d", [x], [name + ":out"], dict(k=k, stride=stride))
        return self.add_node(node, (c, oh, ow))

    def avgpool2d(self, name: str, x: str, k: int = 2, stride: int = 2) -> str:
        c, h, w = self.values[x].shape
        oh, ow = (h - k) // stride + 1, (w - k) // stride + 1
        node = Node(name, "avgpool2d", [x], [name + ":out"], dict(k=k, stride=stride))
        return self.add_node(node, (c, oh, ow))

    def global_avgpool(self, name: str, x: str) -> str:
        c, h, w = self.values[x].shape
        node = Node(name, "global_avgpool", [x], [name + ":out"], {})
        return self.add_node(node, (c,))

    def flatten(self, name: str, x: str) -> str:
        node = Node(name, "flatten", [x], [name + ":out"], {})
        return self.add_node(node, (int(np.prod(self.values[x].shape)),))

    def reshape(self, name: str, x: str, shape: Sequence[int]) -> str:
        """Layout-only alias (generalized flatten): same element count,
        consumed through full reads (like flatten feeding a gemm)."""
        shape = tuple(int(s) for s in shape)
        assert int(np.prod(self.values[x].shape)) == int(np.prod(shape)), \
            f"{name}: reshape {self.values[x].shape} -> {shape} size mismatch"
        node = Node(name, "reshape", [x], [name + ":out"], dict(shape=shape))
        return self.add_node(node, shape)

    # ------------------------------------------------- transformer operators
    def layernorm(self, name: str, x: str, gamma: str, beta: str,
                  eps: float = 1e-5) -> str:
        """Row-wise layer norm over the channel (feature) dim, per token."""
        shape = self.values[x].shape
        c = shape[0]
        assert self.values[gamma].shape == (c,), f"{name}: gamma shape"
        assert self.values[beta].shape == (c,), f"{name}: beta shape"
        node = Node(name, "layernorm", [x, gamma, beta], [name + ":out"],
                    dict(eps=float(eps)))
        return self.add_node(node, shape)

    def softmax(self, name: str, x: str) -> str:
        """Row-wise softmax over the channel dim (the key dim of a score
        row in the ``(keys, queries, 1)`` score layout)."""
        node = Node(name, "softmax", [x], [name + ":out"], {})
        return self.add_node(node, self.values[x].shape)

    def matmul(self, name: str, a: str, b: str, transpose_b: bool = False,
               scale: float = 1.0) -> str:
        """Dynamic activation×activation matmul (no weight operand).

        Sequence tensors are ``(C, T, 1)`` (channels x tokens).  Per output
        token ``t``: ``out[:, t] = B_mat @ a[:, t]`` where
        ``transpose_b=True`` takes ``B_mat = b.T`` of shape ``(Tb, Cb)``
        (QKᵀ: contract the shared feature dim, ``Cb == Ca``) and
        ``transpose_b=False`` takes ``B_mat = b`` of shape ``(Cb, Tb)``
        (attn·V: contract b's token dim, ``Tb == Ca``).  ``scale`` is the
        post-matmul scalar (1/sqrt(d_head) for attention scores).
        """
        ca, ha, wa = self.values[a].shape
        cb, hb, wb = self.values[b].shape
        assert wa == 1 and wb == 1, f"{name}: matmul needs W=1 sequences"
        if transpose_b:
            assert ca == cb, f"{name}: contract dim {ca} vs {cb}"
            out_shape = (hb, ha, 1)
        else:
            assert hb == ca, f"{name}: contract dim {hb} vs {ca}"
            out_shape = (cb, ha, 1)
        node = Node(name, "matmul", [a, b], [name + ":out"],
                    dict(transpose_b=bool(transpose_b), scale=float(scale)))
        return self.add_node(node, out_shape)

    def transpose(self, name: str, x: str) -> str:
        """Channel<->token swap: ``(C, T, 1) -> (T, C, 1)``."""
        c, h, w = self.values[x].shape
        assert w == 1, f"{name}: transpose needs W=1 sequences"
        node = Node(name, "transpose", [x], [name + ":out"], {})
        return self.add_node(node, (h, c, 1))

    # ----------------------------------------------------------------- query
    def producer_of(self, value: str) -> Optional[Node]:
        for n in self.nodes:
            if value in n.outputs:
                return n
        return None

    def consumers_of(self, value: str) -> List[Node]:
        return [n for n in self.nodes if value in n.inputs]

    def validate(self) -> None:
        seen = set(self.inputs) | set(self.weights)
        for n in self.nodes:
            for i in n.inputs:
                if i not in seen:
                    raise ValueError(f"graph not topologically ordered at {n.name}: {i}")
            seen.update(n.outputs)
        for o in self.outputs:
            if o not in seen:
                raise ValueError(f"undefined graph output {o}")


def from_reference_graph(g) -> Graph:
    """Rebuild a graph made with the JAX package as a port :class:`Graph`.

    Duck-typed, so this module needs nothing of that package: ``g`` has
    ``nodes`` (each with ``name``/``op``/``inputs``/``outputs``/``attrs``),
    ``values`` (each with ``name``/``shape``/``dtype``), ``weights`` (numpy
    arrays), ``inputs`` and ``outputs``.  Weights are copied as float32
    numpy arrays, so the new graph shares no buffer with ``g``.
    """
    out = Graph()
    out.values = {k: ValueInfo(v.name, tuple(int(s) for s in v.shape),
                               str(v.dtype))
                  for k, v in g.values.items()}
    out.weights = {k: np.array(w, dtype=np.float32, copy=True)
                   for k, w in g.weights.items()}
    out.nodes = [Node(n.name, n.op, list(n.inputs), list(n.outputs),
                      dict(n.attrs)) for n in g.nodes]
    out.inputs = list(g.inputs)
    out.outputs = list(g.outputs)
    out.validate()
    return out


# ============================================================== reference exec
def execute_reference(graph: Graph, feeds: Dict[str, np.ndarray],
                      mxv_fn=None) -> Dict[str, np.ndarray]:
    """Pure-numpy oracle executor (paper's 'functional semantics').

    ``mxv_fn(m, v) -> y`` lets callers swap in the quantized crossbar MxV so
    the simulator comparison is apples-to-apples.  Defaults to exact matmul.
    """
    if mxv_fn is None:
        mxv_fn = lambda m, v: m @ v
    env: Dict[str, np.ndarray] = {}
    env.update({k: np.asarray(v, np.float32) for k, v in feeds.items()})
    env.update(graph.weights)
    for node in graph.nodes:
        env[node.outputs[0]] = _exec_node(graph, node, env, mxv_fn)
    return {o: env[o] for o in graph.outputs}


def _exec_node(graph: Graph, node: Node, env: Dict[str, np.ndarray], mxv_fn):
    op = node.op
    if op == "conv2d":
        x = env[node.inputs[0]]
        w = graph.weights[node.inputs[1]]
        b = graph.weights[node.inputs[2]] if len(node.inputs) > 2 else None
        return conv2d_mxv(x, w, b, node.attrs["stride"], node.attrs["pad"], mxv_fn)
    if op == "gemm":
        x = env[node.inputs[0]].reshape(-1)
        w = graph.weights[node.inputs[1]]
        y = mxv_fn(w, x)
        if len(node.inputs) > 2:
            y = y + graph.weights[node.inputs[2]]
        return y
    if op == "relu":
        return np.maximum(env[node.inputs[0]], 0.0)
    if op == "add":
        return env[node.inputs[0]] + env[node.inputs[1]]
    if op in ("maxpool2d", "avgpool2d"):
        x = env[node.inputs[0]]
        k, s = node.attrs["k"], node.attrs["stride"]
        c, h, w = x.shape
        oh, ow = (h - k) // s + 1, (w - k) // s + 1
        out = np.empty((c, oh, ow), np.float32)
        red = np.max if op == "maxpool2d" else np.mean
        for i in range(oh):
            for j in range(ow):
                out[:, i, j] = red(x[:, i * s:i * s + k, j * s:j * s + k], axis=(1, 2))
        return out
    if op == "global_avgpool":
        return env[node.inputs[0]].mean(axis=(1, 2))
    if op == "flatten":
        return env[node.inputs[0]].reshape(-1)
    if op == "reshape":
        return env[node.inputs[0]].reshape(node.attrs["shape"])
    if op == "layernorm":
        x = env[node.inputs[0]]
        g = graph.weights[node.inputs[1]]
        b = graph.weights[node.inputs[2]]
        eps = np.float32(node.attrs["eps"])
        mu = x.mean(axis=0, keepdims=True)
        xc = x - mu
        var = (xc * xc).mean(axis=0, keepdims=True)
        bshape = (-1,) + (1,) * (x.ndim - 1)
        return xc / np.sqrt(var + eps) * g.reshape(bshape) + b.reshape(bshape)
    if op == "softmax":
        x = env[node.inputs[0]]
        e = np.exp(x - x.max(axis=0, keepdims=True))
        return e / e.sum(axis=0, keepdims=True)
    if op == "matmul":
        a = env[node.inputs[0]]
        b = env[node.inputs[1]]
        a2 = a.reshape(a.shape[0], -1)           # (Ca, Ta)
        b2 = b.reshape(b.shape[0], -1)           # (Cb, Tb)
        dmat = np.ascontiguousarray(b2.T if node.attrs["transpose_b"] else b2,
                                    np.float32)
        y = dmat @ a2                            # (M, Ta)
        scale = node.attrs["scale"]
        if scale != 1.0:
            y = y * np.float32(scale)
        return y.astype(np.float32)[:, :, None]
    if op == "transpose":
        return np.ascontiguousarray(env[node.inputs[0]].transpose(1, 0, 2))
    raise NotImplementedError(op)


def conv2d_mxv(inp: np.ndarray, flt: np.ndarray, bias, stride: int, pad: int,
               mxv_fn) -> np.ndarray:
    """Convolution via MxV — the paper's Listing 1, verbatim semantics.

    The filter tensor is reshaped to the crossbar matrix ``(FL, C*FH*FW)``;
    each output pixel is one MxV over the flattened input window.
    """
    fl, c, fh, fw = flt.shape
    if pad:
        inp = np.pad(inp, ((0, 0), (pad, pad), (pad, pad)))
    _, ih, iw = inp.shape
    oh = (ih - fh) // stride + 1
    ow = (iw - fw) // stride + 1
    m = flt.reshape(fl, c * fh * fw)
    out = np.empty((fl, oh, ow), np.float32)
    for i in range(oh):
        for j in range(ow):
            v = inp[:, i * stride:i * stride + fh, j * stride:j * stride + fw].reshape(-1)
            out[:, i, j] = mxv_fn(m, v)
    if bias is not None:
        out += bias[:, None, None]
    return out


# ============================================================ example builders
def build_fig2_graph(c: int = 4, h: int = 8, w: int = 8, seed: int = 0) -> Graph:
    """The paper's Fig. 2: two convolutions and an addition (residual)."""
    rng = np.random.default_rng(seed)
    g = Graph()
    x = g.add_input("x", (c, h, w))
    w1 = g.add_weight("w1", rng.normal(size=(c, c, 3, 3), scale=0.2))
    w2 = g.add_weight("w2", rng.normal(size=(c, c, 3, 3), scale=0.2))
    o1 = g.conv2d("conv1", x, w1, pad=1)
    o2 = g.conv2d("conv2", o1, w2, pad=1)
    o3 = g.add("add", o1, o2)
    g.mark_output(o3)
    g.validate()
    return g


def build_lenet_like(in_ch: int = 1, img: int = 12, n_classes: int = 10,
                     seed: int = 0) -> Graph:
    """conv-relu-pool ×2 → gemm.  Small LeNet-style pipeline."""
    rng = np.random.default_rng(seed)
    g = Graph()
    x = g.add_input("x", (in_ch, img, img))
    w1 = g.add_weight("w1", rng.normal(size=(4, in_ch, 3, 3), scale=0.3))
    b1 = g.add_weight("b1", rng.normal(size=(4,), scale=0.1))
    w2 = g.add_weight("w2", rng.normal(size=(8, 4, 3, 3), scale=0.3))
    fc_in = 8 * (((img - 2) // 2 - 2) // 2) ** 2
    wf = g.add_weight("wf", rng.normal(size=(n_classes, fc_in), scale=0.2))
    h1 = g.conv2d("conv1", x, w1, bias=b1)
    h1 = g.relu("relu1", h1)
    h1 = g.maxpool2d("pool1", h1)
    h2 = g.conv2d("conv2", h1, w2)
    h2 = g.relu("relu2", h2)
    h2 = g.maxpool2d("pool2", h2)
    hf = g.flatten("flat", h2)
    out = g.gemm("fc", hf, wf)
    g.mark_output(out)
    g.validate()
    return g


def build_tiny_transformer(seq: int = 4, d_model: int = 8, d_head: int = 8,
                           d_ff: int = 16, n_classes: int = 4, seed: int = 0,
                           explicit_transpose: bool = False) -> Graph:
    """A single-head transformer encoder block + classifier head.

    Sequence layout: ``(d_model, seq, 1)`` — channels are the feature dim,
    H is the token dim (see the module docstring).  Q/K/V/O projections and
    both MLP gemms are 1x1 ``conv2d`` nodes (weight-stationary crossbar MxV,
    one token per iteration); layernorm/softmax are fused DPU ops; QKᵀ and
    attn·V are dynamic ``matmul`` nodes (DPU partitions of their own).
    ``explicit_transpose=True`` computes QKᵀ as ``matmul(q, transpose(k))``
    instead of ``matmul(q, k, transpose_b=True)`` — same math, exercising
    the transpose op end-to-end.
    """
    rng = np.random.default_rng(seed)
    g = Graph()

    def proj(name: str, x: str, d_out: int, d_in: int) -> str:
        w = g.add_weight(f"{name}_w", rng.normal(size=(d_out, d_in, 1, 1),
                                                 scale=1.0 / math.sqrt(d_in)))
        return g.conv2d(name, x, w)

    x = g.add_input("x", (d_model, seq, 1))
    g.add_weight("ln1_g", np.ones(d_model))
    g.add_weight("ln1_b", np.zeros(d_model))
    ln1 = g.layernorm("ln1", x, "ln1_g", "ln1_b")
    q = proj("q_proj", ln1, d_head, d_model)
    k = proj("k_proj", ln1, d_head, d_model)
    v = proj("v_proj", ln1, d_head, d_model)
    inv_sqrt_d = 1.0 / math.sqrt(d_head)
    if explicit_transpose:
        kt = g.transpose("k_t", k)
        s = g.matmul("qk", q, kt, transpose_b=False, scale=inv_sqrt_d)
    else:
        s = g.matmul("qk", q, k, transpose_b=True, scale=inv_sqrt_d)
    p = g.softmax("attn_sm", s)
    a = g.matmul("attn_v", p, v)
    o = proj("o_proj", a, d_model, d_head)
    r1 = g.add("res1", x, o)
    g.add_weight("ln2_g", np.ones(d_model))
    g.add_weight("ln2_b", np.zeros(d_model))
    ln2 = g.layernorm("ln2", r1, "ln2_g", "ln2_b")
    m1 = proj("mlp1", ln2, d_ff, d_model)
    h = g.relu("mlp_relu", m1)
    m2 = proj("mlp2", h, d_model, d_ff)
    r2 = g.add("res2", r1, m2)
    flat = g.reshape("head_flat", r2, (d_model * seq,))
    wc = g.add_weight("cls_w", rng.normal(size=(n_classes, d_model * seq),
                                          scale=0.2))
    out = g.gemm("cls", flat, wc)
    g.mark_output(out)
    g.validate()
    return g


def build_resnet_block_chain(n_blocks: int = 2, c: int = 4, img: int = 8,
                             seed: int = 0) -> Graph:
    """A chain of residual blocks (conv-relu-conv-add-relu), paper Fig. 2 style."""
    rng = np.random.default_rng(seed)
    g = Graph()
    x = g.add_input("x", (c, img, img))
    cur = x
    for b in range(n_blocks):
        w1 = g.add_weight(f"b{b}w1", rng.normal(size=(c, c, 3, 3), scale=0.2))
        w2 = g.add_weight(f"b{b}w2", rng.normal(size=(c, c, 3, 3), scale=0.2))
        h = g.conv2d(f"b{b}conv1", cur, w1, pad=1)
        h = g.relu(f"b{b}relu1", h)
        h = g.conv2d(f"b{b}conv2", h, w2, pad=1)
        h = g.add(f"b{b}add", cur, h)
        cur = g.relu(f"b{b}relu2", h)
    g.mark_output(cur)
    g.validate()
    return g
