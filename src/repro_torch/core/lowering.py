"""Lowering (paper §3.2): produce per-core configurations.

For every partition we emit a ``CoreConfig`` holding
  * the crossbar programming (the reshaped weight matrix, paper Listing 1),
  * the DPU program (the fused non-crossbar ops + send instructions),
  * the LCU configuration: one dependency automaton per cross-partition input
    array — the Appendix-A ``S`` relation compiled to Python (generated code,
    §3.4) plus its enumerated table form (the restricted-hardware variant,
    §3.5).

Array coordinates in all ISL relations are *unpadded* producer coordinates;
padding reads clip out of the relations automatically (they are never
written), and each consumer stores its own locally-padded SRAM copy.

Port copy of ``repro.core.lowering``: the same code, with every import inside
``repro_torch``; ``tests/test_torch_*.py`` hold the two equal.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from . import poly
from .compute_plane import (ComputeDescriptor, DynMatmulDescriptor,
                            make_descriptor)
from .hwspec import ChipMesh, LinkSpec
from .poly import isl  # islpy when installed, the finite fisl backend otherwise
from .graph import ALIAS_OPS, CROSSBAR_OPS, Graph, Node
from .partition import (GCU_PARTITION, PartitionedGraph,
                        partition_iteration_bounds)

Point = Tuple[int, ...]


# ---------------------------------------------------------------- write specs
@dataclasses.dataclass
class WriteSpec:
    """How a producer partition finalizes an array, per iteration.

    kind:
      'pixel'      — value v[:, oh, ow] finalized at iteration (oh, ow)
      'pool'       — pooled v[:, ph, pw] finalized when its window completes
      'full'       — whole array finalized at the single gemm iteration
      'reduce'     — scalar-per-channel (global pool) finalized at last iter
      'gcu_stream' — graph input, streamed row-major by the GCU
    """

    value: str
    kind: str
    shape: Tuple[int, ...]
    attrs: Dict[str, int] = dataclasses.field(default_factory=dict)

    def isl_write(self, iter_name: str) -> isl.Map:
        shp = self.shape
        if self.kind == "pixel":
            c, h, w = shp
            return isl.Map(
                f"{{ {iter_name}[oh,ow] -> A[c,ih,iw] : 0<=oh<{h} and 0<=ow<{w} "
                f"and ih=oh and iw=ow and 0<=c<{c} }}")
        if self.kind == "pool":
            c, ph, pw = shp
            k, s = self.attrs["k"], self.attrs["stride"]
            return isl.Map(
                f"{{ {iter_name}[oh,ow] -> A[c,i,j] : 0<=i<{ph} and 0<=j<{pw} "
                f"and oh = {s}*i + {k - 1} and ow = {s}*j + {k - 1} and 0<=c<{c} }}")
        if self.kind == "full":
            (d,) = shp
            return isl.Map(f"{{ {iter_name}[i] -> A[d] : i = 0 and 0<=d<{d} }}")
        if self.kind == "reduce":
            c = shp[0]
            oh, ow = self.attrs["last_oh"], self.attrs["last_ow"]
            return isl.Map(
                f"{{ {iter_name}[oh,ow] -> A[c] : oh={oh} and ow={ow} and 0<=c<{c} }}")
        if self.kind == "gcu_stream":
            c, h, w = shp
            return isl.Map(
                f"{{ {iter_name}[ih,iw] -> A[c,i,j] : i=ih and j=iw and "
                f"0<=ih<{h} and 0<=iw<{w} and 0<=c<{c} }}")
        raise NotImplementedError(self.kind)


# ----------------------------------------------------------------- read specs
def conv_read_relation(iter_name: str, out_hw: Tuple[int, int],
                       in_shape: Tuple[int, int, int], fh: int, fw: int,
                       stride: int, pad: int) -> isl.Map:
    """Paper Listing 2, generalized with stride/pad and extent clipping."""
    oh, ow = out_hw
    c, ih, iw = in_shape
    return isl.Map(
        f"{{ {iter_name}[oh,ow] -> A[c,i,j] : 0<=oh<{oh} and 0<=ow<{ow} and "
        f"0<=c<{c} and {stride}*oh-{pad} <= i < {stride}*oh-{pad}+{fh} and "
        f"{stride}*ow-{pad} <= j < {stride}*ow-{pad}+{fw} and "
        f"0<=i<{ih} and 0<=j<{iw} }}")


def pointwise_read_relation(iter_name: str, out_hw: Tuple[int, int],
                            in_shape: Tuple[int, int, int]) -> isl.Map:
    c, h, w = in_shape
    oh, ow = out_hw
    assert (h, w) == (oh, ow), "pointwise read at mismatched resolution"
    return isl.Map(
        f"{{ {iter_name}[oh,ow] -> A[c,i,j] : i=oh and j=ow and "
        f"0<=oh<{h} and 0<=ow<{w} and 0<=c<{c} }}")


def full_read_relation(iter_name: str, in_shape: Tuple[int, ...]) -> isl.Map:
    dims = [f"d{i}" for i in range(len(in_shape))]
    cons = " and ".join(f"0<=d{i}<{s}" for i, s in enumerate(in_shape))
    return isl.Map(
        f"{{ {iter_name}[i] -> A[{','.join(dims)}] : i=0 and {cons} }}")


def pool_read_relation(iter_name: str, out_hw: Tuple[int, int],
                       in_shape: Tuple[int, int, int], k: int,
                       stride: int) -> isl.Map:
    """A crossbar-less pool partition reading a remote array (rare path)."""
    c, ih, iw = in_shape
    oh, ow = out_hw
    return isl.Map(
        f"{{ {iter_name}[oh,ow] -> A[c,i,j] : 0<=oh<{oh} and 0<=ow<{ow} and "
        f"0<=c<{c} and {stride}*oh <= i < {stride}*oh+{k} and "
        f"{stride}*ow <= j < {stride}*ow+{k} and 0<=i<{ih} and 0<=j<{iw} }}")


def broadcast_read_relation(iter_name: str, out_hw: Tuple[int, int],
                            in_shape: Tuple[int, int, int]) -> isl.Map:
    """Every iteration reads the *whole* array (dynamic matmul's streamed
    ``b`` operand, transpose): the Appendix-A ``S`` collapses to the
    all-or-nothing gate — no reader iteration is safe before the producer's
    last write, every one is after it.
    """
    c, ih, iw = in_shape
    oh, ow = out_hw
    return isl.Map(
        f"{{ {iter_name}[oh,ow] -> A[c,i,j] : 0<=oh<{oh} and 0<=ow<{ow} and "
        f"0<=c<{c} and 0<=i<{ih} and 0<=j<{iw} }}")


# ---------------------------------------------------------------- core config
@dataclasses.dataclass
class LcuDep:
    """One dependency automaton: the Appendix-A ``S`` of a single producer
    partition's writes into this array.  An unreplicated producer yields one
    ``LcuDep``; a k-replicated producer yields k (the producer's write
    relation domain-restricted to iterations ``rank == r (mod k)``), and a
    consumer iteration is admitted only when *every* per-replica frontier
    says it is safe — which is exactly the max-merge of the k interleaved
    producer streams."""

    src_partition: int
    dep: poly.DepInfo
    gen_src: str                      # generated Python source for S (§3.4)
    table: Optional[poly.FrontierTable] = None

    def make_frontier(self) -> poly.Frontier:
        ns: Dict[str, object] = {}
        exec(compile(self.gen_src, "<lcu>", "exec"), ns)  # noqa: S102
        return poly.Frontier(self.dep, ns["s_eval"])


@dataclasses.dataclass
class LcuArrayConfig:
    value: str
    src_partition: int
    dep: poly.DepInfo
    gen_src: str                      # generated Python source for S (paper §3.4)
    pad: int                          # local SRAM padding for this array
    shape: Tuple[int, ...]            # unpadded shape
    # Vectorized LCU: S precompiled over all array locations (built once at
    # lowering time; consumed by the event-driven simulator engine).
    table: Optional[poly.FrontierTable] = None
    # Authoritative dependency list, one entry per producer partition
    # (replication fans a single producer out into k entries).  The scalar
    # fields above mirror ``deps[0]`` for the common unreplicated case.
    deps: List[LcuDep] = dataclasses.field(default_factory=list)

    # mirror fields proxied into deps[0] on write, so post-construction
    # monkeypatching (e.g. the deadlock test replacing gen_src/table) stays
    # visible to the engines, which consult ``deps`` exclusively
    _MIRROR = frozenset({"src_partition", "dep", "gen_src", "table"})

    def __post_init__(self):
        if not self.deps:
            self.deps = [LcuDep(src_partition=self.src_partition,
                                dep=self.dep, gen_src=self.gen_src,
                                table=self.table)]

    def __setattr__(self, name, value):
        object.__setattr__(self, name, value)
        if name in LcuArrayConfig._MIRROR:
            deps = self.__dict__.get("deps")
            if deps:
                setattr(deps[0], name, value)

    def make_frontier(self) -> poly.Frontier:
        return self.deps[0].make_frontier()


@dataclasses.dataclass
class SendSpec:
    value: str
    write: WriteSpec
    dst_cores: List[int]              # consumer cores (empty => GMEM output)
    to_gmem: bool = False


@dataclasses.dataclass
class CoreConfig:
    core_id: int
    partition_idx: int
    iter_bounds: Tuple[int, ...]      # iteration space = box [0,b0) x [0,b1)
    xbar_node: Optional[Node]
    xbar_matrix: Optional[np.ndarray]  # (rows, cols) programmed into crossbar
    xbar_bias: Optional[np.ndarray]
    dpu_nodes: List[Node]             # fused non-crossbar ops, topo order
    lcu: Dict[str, LcuArrayConfig]    # per cross-partition input array
    sends: List[SendSpec]
    conv_attrs: Dict[str, int] = dataclasses.field(default_factory=dict)
    xbar_input: Optional[str] = None  # value name the crossbar reads
    # Bottleneck replication: this core runs the iterations of its
    # partition's box with flat rank == repl_r (mod repl_k), in rank order.
    repl_k: int = 1
    repl_r: int = 0
    # Compute-plane descriptor (weight matrix + int8 quantization), built at
    # lowering so simulator backends never re-derive per-core state.
    compute: Optional[ComputeDescriptor] = None
    # Dynamic-matmul descriptors per DPU matmul node (ComputeDescriptor-free:
    # both operands are streamed activations, so there is nothing to program
    # into a crossbar — the op runs on the digital DPU).
    dyn_compute: Dict[str, DynMatmulDescriptor] = dataclasses.field(
        default_factory=dict)

    def dpu_listing(self) -> List[str]:
        """Human-readable DPU 'instruction sequence' for the config dump."""
        out = []
        if self.xbar_node is not None:
            out.append(f"XBAR_{self.xbar_node.op.upper()} "
                       f"in={self.xbar_input}")
            if self.xbar_bias is not None:
                out.append("ADD_BIAS")
        for n in self.dpu_nodes:
            out.append(f"{n.op.upper()} {','.join(n.inputs)} -> {n.outputs[0]}")
        for s in self.sends:
            tgt = "GMEM" if s.to_gmem else f"cores{s.dst_cores}"
            out.append(f"SEND {s.value}[{s.write.kind}] -> {tgt}")
        return out


@dataclasses.dataclass
class GcuConfig:
    input_value: str
    input_shape: Tuple[int, ...]
    dst_cores: List[int]
    outputs: Dict[str, Tuple[int, ...]]   # value -> shape collected in GMEM


@dataclasses.dataclass
class InterChipStream:
    """One cut edge lowered to an inter-chip DMA stream.

    The producer core pushes each finalized chunk of ``value`` onto the
    ``link``; the consumer core's LCU snoops the (delayed) SRAM writes
    exactly as it does intra-chip ones — the unlock conditions are the same
    ``poly.compile_frontier_table`` ramps (``LcuArrayConfig.table``), fed
    with link-delayed arrival cycles instead of ``send + 1``.
    """

    value: str
    src_core: int
    dst_core: int
    src_chip: int
    dst_chip: int
    link: LinkSpec


@dataclasses.dataclass
class AcceleratorProgram:
    cores: Dict[int, CoreConfig]
    gcu: GcuConfig
    mapping: Dict[int, int]              # partition -> core (global id)
    pgraph: PartitionedGraph
    mesh: Optional[ChipMesh] = None      # multi-chip scale-out (None: 1 chip)
    dma_streams: List[InterChipStream] = dataclasses.field(
        default_factory=list)

    def chip_of(self, core: int) -> int:
        return self.mesh.chip_of(core) if self.mesh is not None else 0


class LoweringError(Exception):
    pass


# ------------------------------------------------------------------- lowering
def _resolve_alias(graph: Graph, value: str, aliases: Dict[str, str]) -> str:
    while value in aliases:
        value = aliases[value]
    return value


def graph_aliases(graph: Graph) -> Dict[str, str]:
    """Alias chain (flatten/reshape outputs -> their storage value)."""
    aliases: Dict[str, str] = {}
    for node in graph.nodes:
        if node.op in ALIAS_OPS:
            aliases[node.outputs[0]] = node.inputs[0]
    return aliases


def build_write_specs(graph: Graph, pg: PartitionedGraph,
                      aliases: Optional[Dict[str, str]] = None
                      ) -> Dict[str, WriteSpec]:
    """How every value gets finalized, per producer iteration.

    This is the single source of the producer-side access relations: both
    :func:`lower` and the static verifier (``repro_torch.analysis``) derive the
    Appendix-A ``W1`` from these specs, so the verifier checks the compiled
    artifacts against an independently rebuilt relation rather than against
    whatever the program object happens to carry.
    """
    if aliases is None:
        aliases = graph_aliases(graph)
    write_specs: Dict[str, WriteSpec] = {}
    for v in graph.inputs:
        write_specs[v] = WriteSpec(v, "gcu_stream", graph.values[v].shape)
    for node in graph.nodes:
        out = node.outputs[0]
        shape = graph.values[out].shape
        if node.op in ("conv2d", "relu", "add", "layernorm", "softmax",
                       "matmul", "transpose"):
            if len(shape) == 3:
                write_specs[out] = WriteSpec(out, "pixel", shape)
            else:  # relu/add/layernorm/softmax over 1-D (post-gemm) tensors
                write_specs[out] = WriteSpec(out, "full", shape)
        elif node.op in ("maxpool2d", "avgpool2d"):
            # Fused pool (input produced in the same partition): pooled
            # pixel (i, j) finalizes at the *producer-grid* iteration that
            # completes its window.  Direct pool (input streams in from
            # another partition — the shape a pool takes when split off a
            # replicated stage): the partition iterates the pool's own
            # output grid and each iteration gathers one full window from
            # SRAM, so the write is an ordinary pixel write.
            pin = _resolve_alias(graph, node.inputs[0], aliases)
            direct = (pg.value_part.get(pin, GCU_PARTITION)
                      != pg.node_part[node.name])
            if direct:
                write_specs[out] = WriteSpec(out, "pixel", shape)
            else:
                write_specs[out] = WriteSpec(out, "pool", shape,
                                             dict(k=node.attrs["k"],
                                                  stride=node.attrs["stride"]))
        elif node.op == "global_avgpool":
            src_shape = graph.values[node.inputs[0]].shape
            write_specs[out] = WriteSpec(out, "reduce", shape,
                                         dict(last_oh=src_shape[1] - 1,
                                              last_ow=src_shape[2] - 1))
        elif node.op == "gemm":
            write_specs[out] = WriteSpec(out, "full", shape)
        elif node.op in ALIAS_OPS:
            pass
        else:
            raise LoweringError(f"no write spec for op {node.op}")
    return write_specs


def partition_conv_attrs(graph: Graph, part) -> Dict[str, int]:
    """Stride/pad/filter extents of a partition's conv2d crossbar ({} else)."""
    xbar = part.crossbar
    if xbar is None or xbar.op != "conv2d":
        return {}
    w = graph.weights[xbar.inputs[1]]
    _, _, fh, fw = w.shape
    return dict(stride=xbar.attrs["stride"], pad=xbar.attrs["pad"],
                fh=fh, fw=fw)


def partition_read_relations(graph: Graph, pg: PartitionedGraph, part,
                             bounds: Tuple[int, ...],
                             aliases: Optional[Dict[str, str]] = None
                             ) -> Tuple[Dict[str, "isl.Map"], Dict[str, int]]:
    """Per cross-partition input array: the partition's read relation
    (unioned over the consuming ops) and the local SRAM padding it needs.

    Shared by :func:`lower` and the static verifier, which rebuilds the
    reader-side Appendix-A ``R2`` from the graph rather than trusting the
    lowered program.
    """
    if aliases is None:
        aliases = graph_aliases(graph)
    conv_attrs = partition_conv_attrs(graph, part)
    iname = "IT"
    reads: Dict[str, isl.Map] = {}
    in_pads: Dict[str, int] = {}
    cross_in = {_resolve_alias(graph, v, aliases): src
                for v, src in pg.cross_edges_into(part.idx).items()}
    for node in part.nodes:
        if node.op in ALIAS_OPS:
            continue
        for pos, raw_in in enumerate(node.inputs):
            if raw_in in graph.weights:
                continue
            v = _resolve_alias(graph, raw_in, aliases)
            if v not in cross_in:
                # intra-partition value — except for the broadcast-read
                # operands, which by the partitioning contract can never
                # be produced in this partition (matmul/transpose head
                # their own partition precisely so both operands stream
                # in through the LCU)
                if node.op == "transpose" or (
                        node.op == "matmul" and pos == 1):
                    raise LoweringError(
                        f"{node.name}: broadcast operand {v!r} must be "
                        "cross-partition")
                continue
            in_shape = graph.values[v].shape
            if node.op == "conv2d":
                rel = conv_read_relation(
                    iname, bounds, in_shape, conv_attrs["fh"],
                    conv_attrs["fw"], conv_attrs["stride"],
                    conv_attrs["pad"])
                in_pads[v] = max(in_pads.get(v, 0), conv_attrs["pad"])
            elif node.op in ("relu", "add", "layernorm", "softmax"):
                if len(in_shape) == 3:
                    rel = pointwise_read_relation(iname, bounds, in_shape)
                else:
                    rel = full_read_relation(iname, in_shape)
            elif node.op == "matmul":
                # operand a (pos 0) streams one token per iteration;
                # operand b (pos 1) is the runtime matrix — broadcast
                if pos == 0:
                    rel = pointwise_read_relation(iname, bounds, in_shape)
                else:
                    rel = broadcast_read_relation(iname, bounds, in_shape)
            elif node.op == "transpose":
                rel = broadcast_read_relation(iname, bounds, in_shape)
            elif node.op in ("maxpool2d", "avgpool2d"):
                rel = pool_read_relation(iname, tuple(
                    graph.values[node.outputs[0]].shape[1:]), in_shape,
                    node.attrs["k"], node.attrs["stride"])
            elif node.op in ("gemm", "global_avgpool"):
                rel = full_read_relation(iname, in_shape)
            else:
                raise LoweringError(f"no read relation for {node.op}")
            reads[v] = rel if v not in reads else reads[v].union(rel)
            in_pads.setdefault(v, 0)
    return reads, in_pads


def lower(pg: PartitionedGraph, mapping: Dict[int, int],
          quantizer=None, mesh: Optional[ChipMesh] = None
          ) -> AcceleratorProgram:
    """Produce per-core configurations (paper's 'lowering' step).

    ``quantizer(w) -> w'`` optionally models crossbar programming noise /
    quantization; identity by default.

    ``mesh``: multi-chip scale-out.  ``mapping`` then holds *global* core
    ids; cut edges (sends whose destination lives on another chip) are
    additionally materialized as :class:`InterChipStream` DMA descriptors.
    The LCU configuration is chip-agnostic by construction — the Appendix-A
    ``S`` relation only sees array coordinates, so a consumer's frontier
    table enforces a cross-chip dependency with the same compiled ramp as an
    intra-chip one.
    """
    graph = pg.graph
    aliases = graph_aliases(graph)

    # ---- write specs: how each cross-partition value gets finalized
    write_specs = build_write_specs(graph, pg, aliases)

    cores: Dict[int, CoreConfig] = {}
    for part in pg.partitions:
        core_id = mapping[part.idx]
        xbar = part.crossbar

        # Iteration space (all replicas share the full box; a replica core
        # walks its rank == repl_r (mod repl_k) stride of it).
        bounds = partition_iteration_bounds(pg, part)

        # Crossbar programming (paper Listing 1: reshape to (FL, C*FH*FW)).
        xbar_matrix = xbar_bias = None
        conv_attrs = partition_conv_attrs(graph, part)
        xbar_input = None
        if xbar is not None:
            w = graph.weights[xbar.inputs[1]]
            if xbar.op == "conv2d":
                fl, c, fh, fw = w.shape
                xbar_matrix = w.reshape(fl, c * fh * fw)
            else:
                xbar_matrix = w
            if quantizer is not None:
                xbar_matrix = quantizer(xbar_matrix)
            if len(xbar.inputs) > 2:
                xbar_bias = graph.weights[xbar.inputs[2]]
            xbar_input = _resolve_alias(graph, xbar.inputs[0], aliases)

        # ---- read relations per cross-partition input array
        reads, in_pads = partition_read_relations(graph, pg, part, bounds,
                                                  aliases)
        cross_in = {_resolve_alias(graph, v, aliases): src
                    for v, src in pg.cross_edges_into(part.idx).items()}

        # ---- LCU: S per input array (Appendix A), with generated evaluator
        # and the precompiled vectorized frontier table (event engine path).
        # A replicated producer contributes one dependency automaton per
        # replica: its write relation intersected with the round-robin
        # filter rank == r (mod k); the consumer's admission is the AND of
        # all of them.
        lcu: Dict[str, LcuArrayConfig] = {}
        for v, rel in reads.items():
            w1 = write_specs[v].isl_write("WR")
            src_leader = cross_in[v]
            deps: List[LcuDep] = []
            for s in pg.replicas_of(src_leader):
                sp = (None if s == GCU_PARTITION else pg.partitions[s])
                if sp is not None and sp.repl_k > 1:
                    w1_s = poly.restrict_writes_mod(
                        w1, partition_iteration_bounds(pg, sp),
                        sp.repl_k, sp.repl_r)
                else:
                    w1_s = w1
                dep, gen_src, table = poly.compile_lcu(
                    w1_s, rel, graph.values[v].shape, bounds)
                deps.append(LcuDep(src_partition=s, dep=dep,
                                   gen_src=gen_src, table=table))
            lcu[v] = LcuArrayConfig(value=v,
                                    src_partition=deps[0].src_partition,
                                    dep=deps[0].dep, gen_src=deps[0].gen_src,
                                    pad=in_pads[v],
                                    shape=graph.values[v].shape,
                                    table=deps[0].table, deps=deps)

        # ---- sends: every value of this partition consumed elsewhere/GMEM
        sends: List[SendSpec] = []
        produced = {n.outputs[0] for n in part.nodes}
        for v in sorted(produced):
            rv = _resolve_alias(graph, v, aliases)
            if rv != v:
                continue  # aliases (flatten) are layout-only, never sent
            dsts = sorted({
                mapping[dst] for (src, dst), vals in pg.edges.items()
                if src == part.idx
                and any(_resolve_alias(graph, ev, aliases) == v for ev in vals)})
            to_gmem = any(_resolve_alias(graph, o, aliases) == v
                          for o in graph.outputs)
            if dsts or to_gmem:
                sends.append(SendSpec(v, write_specs[v], dsts, to_gmem))

        dpu_nodes = [n for n in part.nodes
                     if n.op not in CROSSBAR_OPS and n.op not in ALIAS_OPS]
        compute = (make_descriptor(xbar_matrix, xbar.op)
                   if xbar is not None else None)
        dyn_compute = {
            n.name: DynMatmulDescriptor(
                a_value=_resolve_alias(graph, n.inputs[0], aliases),
                b_value=_resolve_alias(graph, n.inputs[1], aliases),
                transpose_b=bool(n.attrs["transpose_b"]),
                scale=float(n.attrs["scale"]))
            for n in dpu_nodes if n.op == "matmul"}
        cores[core_id] = CoreConfig(
            core_id=core_id, partition_idx=part.idx, iter_bounds=bounds,
            xbar_node=xbar, xbar_matrix=xbar_matrix, xbar_bias=xbar_bias,
            dpu_nodes=dpu_nodes, lcu=lcu, sends=sends,
            conv_attrs=conv_attrs, xbar_input=xbar_input, compute=compute,
            dyn_compute=dyn_compute, repl_k=part.repl_k, repl_r=part.repl_r)

    # ---- GCU config
    if len(graph.inputs) != 1:
        raise LoweringError("exactly one graph input supported")
    inp = graph.inputs[0]
    dst_cores = sorted({mapping[dst] for (src, dst) in pg.edges
                        if src == GCU_PARTITION})
    gcu = GcuConfig(input_value=inp, input_shape=graph.values[inp].shape,
                    dst_cores=dst_cores,
                    outputs={o: graph.values[o].shape for o in graph.outputs})

    # ---- inter-chip DMA streams: every send with a cross-chip destination
    dma_streams: List[InterChipStream] = []
    if mesh is not None:
        for cid, cfg in cores.items():
            src_chip = mesh.chip_of(cid)
            for spec in cfg.sends:
                for dst in spec.dst_cores:
                    dst_chip = mesh.chip_of(dst)
                    if dst_chip == src_chip:
                        continue
                    dma_streams.append(InterChipStream(
                        value=spec.value, src_core=cid, dst_core=dst,
                        src_chip=src_chip, dst_chip=dst_chip,
                        link=mesh.link_between(src_chip, dst_chip)))
    return AcceleratorProgram(cores=cores, gcu=gcu, mapping=mapping,
                              pgraph=pg, mesh=mesh, dma_streams=dma_streams)
