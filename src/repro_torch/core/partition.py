"""Graph partitioning (paper §3.1).

Invariants enforced (verbatim from the paper):
  1. each partition contains *at most one* crossbar operator (conv2d/gemm);
  2. the partition graph is acyclic.

Algorithm (also verbatim): iterate nodes in topological order, create a new
partition whenever a crossbar node is encountered; every other node is bundled
with the *latest* partition among its producers, which reproduces the paper's
Fig. 2 resolution (the ADD joins the right-hand-side partition — joining the
left would create a cycle).

Broadcast DPU ops (dynamic ``matmul``, ``transpose``) are the one
exception to the bundling rule: they read a producer array *non-pointwise*
(iteration ``t`` needs locations the producer's iteration ``t`` has not
written yet), so fusing them into a producer's partition would deadlock the
per-iteration pipeline.  They head a crossbar-less partition of their own and
receive their operands through the LCU like any cross-partition edge.

Port copy of ``repro.core.partition``: the same code, with every import inside
``repro_torch``; ``tests/test_torch_*.py`` hold the two equal.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List, Optional, Sequence, Tuple
from .graph import BROADCAST_DPU_OPS, CROSSBAR_OPS, Graph, Node
from .hwspec import ChipMesh

GCU_PARTITION = -1  # virtual partition for graph inputs (fed by the GCU)

# DPU ops that read/write exactly their own iteration's pixel — safe to keep
# inside a replicated stage (every iteration is independent of the others).
ELEMENTWISE_DPU_OPS = ("relu", "add", "layernorm", "softmax")
# Windowed reductions that can head a crossbar-less partition in *direct*
# mode (gather the whole window from SRAM per output iteration) — the form a
# pool takes when it is split off a replicated producer stage.
DIRECT_POOL_OPS = ("maxpool2d", "avgpool2d")


@dataclasses.dataclass
class Partition:
    idx: int
    nodes: List[Node] = dataclasses.field(default_factory=list)
    crossbar: Optional[Node] = None
    # Bottleneck replication: ``repl_k`` copies of this stage run
    # round-robin over the iteration space — this partition executes the
    # iterations with flat rank == repl_r (mod repl_k).  ``repl_group`` is
    # the leader partition idx shared by the whole group (None: unreplicated).
    repl_k: int = 1
    repl_r: int = 0
    repl_group: Optional[int] = None


@dataclasses.dataclass
class PartitionedGraph:
    graph: Graph
    partitions: List[Partition]
    node_part: Dict[str, int]                 # node name -> partition idx
    value_part: Dict[str, int]                # value name -> producing partition
    # (src partition, dst partition) -> shared value names (paper: edges with
    # the same endpoints are combined into a single shared array)
    edges: Dict[Tuple[int, int], List[str]]
    # leader partition idx -> all member partition idxs (consecutive)
    replica_groups: Dict[int, Tuple[int, ...]] = dataclasses.field(
        default_factory=dict)

    def partition_of_value(self, value: str) -> int:
        return self.value_part[value]

    def leader_of(self, pidx: int) -> int:
        if pidx == GCU_PARTITION:
            return pidx
        g = self.partitions[pidx].repl_group
        return pidx if g is None else g

    def replicas_of(self, pidx: int) -> Tuple[int, ...]:
        """All members of ``pidx``'s replica group (``(pidx,)`` when not
        replicated).  ``pidx`` may be any member; the leader is returned
        first."""
        return self.replica_groups.get(self.leader_of(pidx), (pidx,))

    def cross_edges_into(self, pidx: int) -> Dict[str, int]:
        """value name -> src partition (group *leader*), for all
        cross-partition reads of ``pidx``."""
        out: Dict[str, int] = {}
        for (src, dst), vals in self.edges.items():
            if dst == pidx:
                for v in vals:
                    out[v] = self.leader_of(src)
        return out


class PartitionError(Exception):
    pass


def partition_graph(graph: Graph) -> PartitionedGraph:
    graph.validate()
    partitions: List[Partition] = []
    node_part: Dict[str, int] = {}
    value_part: Dict[str, int] = {v: GCU_PARTITION for v in graph.inputs}

    for node in graph.nodes:
        if node.op in CROSSBAR_OPS:
            part = Partition(idx=len(partitions), crossbar=node)
            partitions.append(part)
        elif node.op in BROADCAST_DPU_OPS:
            # non-pointwise consumer: must not fuse with any producer
            part = Partition(idx=len(partitions))
            partitions.append(part)
        else:
            producers = [value_part[i] for i in node.inputs if i in value_part
                         and i not in graph.weights]
            latest = max(producers) if producers else GCU_PARTITION
            if latest == GCU_PARTITION:
                # A non-crossbar node reading only graph inputs: give it a
                # crossbar-less partition of its own.
                part = Partition(idx=len(partitions))
                partitions.append(part)
            else:
                part = partitions[latest]
        part.nodes.append(node)
        node_part[node.name] = part.idx
        for o in node.outputs:
            value_part[o] = part.idx

    # Invariant 1 holds by construction; double-check anyway.
    for p in partitions:
        n_xbar = sum(1 for n in p.nodes if n.op in CROSSBAR_OPS)
        if n_xbar > 1:
            raise PartitionError(f"partition {p.idx} has {n_xbar} crossbar ops")

    # Cross-partition edges (combining same-endpoint edges, paper §3.3).
    edges: Dict[Tuple[int, int], List[str]] = {}
    for node in graph.nodes:
        dst = node_part[node.name]
        for i in node.inputs:
            if i in graph.weights:
                continue
            src = value_part[i]
            if src != dst:
                edges.setdefault((src, dst), [])
                if i not in edges[(src, dst)]:
                    edges[(src, dst)].append(i)

    # Invariant 2: acyclicity.  With the max-producer rule every edge goes
    # forward (src < dst); verify.
    for (src, dst) in edges:
        if src != GCU_PARTITION and src >= dst:
            raise PartitionError(f"partition graph has back edge {src}->{dst}")

    return PartitionedGraph(graph=graph, partitions=partitions,
                            node_part=node_part, value_part=value_part,
                            edges=edges)


# ------------------------------------------------- bottleneck replication pass
def partition_iteration_bounds(pg: PartitionedGraph, part: Partition):
    """The iteration-space box a partition's cores sweep (mirrors the bounds
    logic in ``lowering.lower`` — conv partitions iterate the conv's output
    grid, gemm partitions run one big iteration, crossbar-less partitions
    iterate their head node's output pixel grid)."""
    g = pg.graph
    if part.crossbar is not None:
        if part.crossbar.op == "conv2d":
            _, oh, ow = g.values[part.crossbar.outputs[0]].shape
            return (oh, ow)
        return (1,)
    shp = g.values[part.nodes[0].outputs[0]].shape
    return tuple(int(x) for x in shp[1:]) if len(shp) == 3 else (1,)


def partition_iterations(pg: PartitionedGraph, part: Partition) -> int:
    n = 1
    for b in partition_iteration_bounds(pg, part):
        n *= int(b)
    return n


def _split_for_replication(g: Graph, nodes: List[Node],
                           crossbar: Optional[Node]):
    """-> (replica_nodes, tail_nodes).

    The replica prefix is the head (conv2d crossbar, elementwise chain head,
    or direct-mode pool) plus every following elementwise pixel op — each of
    its iterations reads and writes only its own pixel, so a round-robin
    split over iterations is exact.  Anything after that is split into a
    tail partition, which must be headed by a pool (executed in *direct*
    mode: it gathers each k x k window from SRAM, fed by the replicas'
    interleaved pixel streams).  Raises :class:`PartitionError` when the
    stage has no replicable form.
    """
    if crossbar is not None:
        if crossbar.op != "conv2d":
            raise PartitionError(
                f"only conv2d crossbar stages are replicable, not "
                f"{crossbar.op} ({crossbar.name})")
        if nodes[0] is not crossbar:
            raise PartitionError(
                f"crossbar {crossbar.name} is not the partition head")
    else:
        head = nodes[0]
        shp = g.values[head.outputs[0]].shape
        if head.op in DIRECT_POOL_OPS:
            pass  # direct-mode pool: iterates its own output grid
        elif head.op in ELEMENTWISE_DPU_OPS and len(shp) == 3:
            pass
        else:
            raise PartitionError(
                f"partition headed by {head.op} ({head.name}) is not "
                "replicable")
    repl = [nodes[0]]
    for n in nodes[1:]:
        if (n.op in ELEMENTWISE_DPU_OPS
                and len(g.values[n.outputs[0]].shape) == 3):
            repl.append(n)
        else:
            break
    tail = nodes[len(repl):]
    if tail and tail[0].op not in DIRECT_POOL_OPS:
        raise PartitionError(
            f"cannot split {tail[0].op} ({tail[0].name}) off a replicated "
            f"stage: tail partitions must be headed by one of "
            f"{DIRECT_POOL_OPS}")
    return repl, tail


def _rebuild(g: Graph, partitions: List[Partition],
             replica_groups: Dict[int, Tuple[int, ...]]) -> PartitionedGraph:
    """Recompute node/value ownership and edges for an edited partition
    list.  Replicas share their leader's nodes; ``node_part``/``value_part``
    point at the leader, while ``edges`` materialize the full replica
    fan-out (every replica of a producer feeds every replica of a
    consumer — replicas of the *same* stage never communicate)."""
    node_part: Dict[str, int] = {}
    value_part: Dict[str, int] = {v: GCU_PARTITION for v in g.inputs}
    for p in partitions:
        if p.repl_group is not None and p.repl_group != p.idx:
            continue  # non-leader replica: same nodes as the leader
        for n in p.nodes:
            node_part[n.name] = p.idx
            for o in n.outputs:
                value_part[o] = p.idx

    def members(leader: int) -> Tuple[int, ...]:
        if leader == GCU_PARTITION:
            return (GCU_PARTITION,)
        return replica_groups.get(leader, (leader,))

    edges: Dict[Tuple[int, int], List[str]] = {}
    for p in partitions:
        dst_leader = p.repl_group if p.repl_group is not None else p.idx
        for node in partitions[dst_leader].nodes:
            for i in node.inputs:
                if i in g.weights:
                    continue
                src_leader = value_part[i]
                if src_leader == dst_leader:
                    continue
                for s in members(src_leader):
                    edges.setdefault((s, p.idx), [])
                    if i not in edges[(s, p.idx)]:
                        edges[(s, p.idx)].append(i)

    for (src, dst) in edges:
        if src != GCU_PARTITION and src >= dst:
            raise PartitionError(
                f"replication produced back edge {src}->{dst}")
    return PartitionedGraph(graph=g, partitions=partitions,
                            node_part=node_part, value_part=value_part,
                            edges=edges, replica_groups=dict(replica_groups))


def _replicate_one(pg: PartitionedGraph, pidx: int, k: int,
                   anchor: Optional[str] = None) -> PartitionedGraph:
    """Replace partition ``pidx`` with ``k`` round-robin replicas of its
    replicable prefix (plus a tail partition for the rest, if any).  With
    ``k == 1`` this is a pure prefix/tail split (identity when there is no
    tail)."""
    g = pg.graph
    old = pg.partitions
    p = old[pidx]
    if p.repl_k != 1:
        raise PartitionError(f"partition {pidx} is already replicated")
    repl_nodes, tail_nodes = _split_for_replication(g, p.nodes, p.crossbar)
    if anchor is not None and anchor in {n.name for n in tail_nodes}:
        # The named stage lives in the tail: split it off unreplicated
        # first, then replicate the tail partition it lands in.
        split = _replicate_one(pg, pidx, 1)
        return _replicate_one(split, split.node_part[anchor], k, anchor)
    n_iters = partition_iterations(pg, p)
    if k > n_iters:
        raise PartitionError(
            f"cannot replicate partition {pidx} x{k}: only {n_iters} "
            "iterations")

    shift = (k - 1) + (1 if tail_nodes else 0)
    parts: List[Partition] = list(old[:pidx])
    for r in range(k):
        parts.append(Partition(
            idx=pidx + r, nodes=list(repl_nodes), crossbar=p.crossbar,
            repl_k=k, repl_r=r, repl_group=(pidx if k > 1 else None)))
    if tail_nodes:
        parts.append(Partition(idx=pidx + k, nodes=list(tail_nodes)))
    for q in old[pidx + 1:]:
        parts.append(dataclasses.replace(
            q, idx=q.idx + shift,
            repl_group=(None if q.repl_group is None
                        else q.repl_group + shift)))

    groups: Dict[int, Tuple[int, ...]] = {}
    for leader, mem in pg.replica_groups.items():
        if leader > pidx:
            groups[leader + shift] = tuple(m + shift for m in mem)
        else:
            groups[leader] = mem
    if k > 1:
        groups[pidx] = tuple(range(pidx, pidx + k))
    return _rebuild(g, parts, groups)


def replicate_partitions(pg: PartitionedGraph,
                         plan: Dict[str, int]) -> PartitionedGraph:
    """Apply a replication plan ``{node name: k}``.

    Each entry replicates the partition containing the named node ``k``
    ways.  Entries are applied one at a time in execution order, re-resolving
    names between applications — so ``{"conv1": 4, "pool1": 2}`` works even
    though ``pool1`` starts out fused into ``conv1``'s partition (the first
    application splits it into a tail partition of its own).  ``k == 1``
    entries are dropped.
    """
    todo = {str(n): int(v) for n, v in plan.items() if int(v) > 1}
    out = pg
    while todo:
        cands = []
        for name in todo:
            if name not in out.node_part:
                raise PartitionError(f"replication plan names unknown or "
                                     f"non-executable node {name!r}")
            pidx = out.node_part[name]
            order = [n.name for n in out.partitions[pidx].nodes].index(name)
            cands.append((pidx, order, name))
        _, _, name = min(cands)
        out = _replicate_one(out, out.node_part[name], todo.pop(name),
                             anchor=name)
    return out


def _stage_chain(pg: PartitionedGraph, part: Partition):
    """Decompose a partition into its replicable segments:
    ``[(anchor node name, n_iters, replicable)]`` — segment 0 is the
    partition's replica prefix, then the prefix of its tail, and so on.
    A segment that cannot be split further ends the chain."""
    g = pg.graph
    chain = []
    nodes, crossbar = part.nodes, part.crossbar
    if crossbar is not None and crossbar.op == "conv2d":
        _, oh, ow = g.values[crossbar.outputs[0]].shape
        n0 = oh * ow
    else:
        n0 = partition_iterations(pg, part)
    while nodes:
        try:
            repl, tail = _split_for_replication(g, nodes, crossbar)
        except PartitionError:
            chain.append((nodes[0].name, n0, False))
            return chain
        chain.append((repl[0].name, n0, True))
        nodes, crossbar = tail, None
        if nodes:
            shp = g.values[nodes[0].outputs[0]].shape
            n0 = 1
            for x in shp[1:]:
                n0 *= int(x)
    return chain


def plan_replication(pg: PartitionedGraph, n_cores: int,
                     dma_pixels_per_cycle: Optional[int] = None
                     ) -> Dict[str, int]:
    """Greedy static cost model for ``compile_model(replicate="auto")``.

    Service time of a stage is its iteration count divided by its replica
    count (one iteration per core per cycle).  Repeatedly replicate the
    current max-service replicable stage — jumping straight to the smallest
    ``k`` that lowers its service — until the spare cores run out or the
    bottleneck hits the input-streaming floor (the GCU feeds
    ``dma_pixels_per_cycle`` input pixels per cycle; no amount of
    replication beats that).  Returns a plan for
    :func:`replicate_partitions`; empty when nothing helps.
    """
    g = pg.graph
    floor = 1
    if dma_pixels_per_cycle and g.inputs:
        pixels = 1
        for x in g.values[g.inputs[0]].shape:
            pixels *= int(x)
        floor = max(1, -(-pixels // int(dma_pixels_per_cycle)))

    segs = []  # [anchor, iters, replicable, k, part_key]
    split_cost = {}  # part_key -> extra cores materialized by first split
    for p in pg.partitions:
        chain = _stage_chain(pg, p)
        split_cost[p.idx] = len(chain) - 1
        for (anchor, iters, ok) in chain:
            segs.append([anchor, iters, ok, 1, p.idx])

    cores_used = len(pg.partitions)
    capped = set()
    while True:
        best = None
        for s in segs:
            svc = -(-s[1] // s[3])
            if not s[2] or s[0] in capped or svc <= max(floor, 1):
                continue
            if best is None or svc > -(-best[1] // best[3]):
                best = s
        if best is None:
            break
        anchor, iters, _, k, pkey = best
        svc = -(-iters // k)
        k_new = -(-iters // (svc - 1))  # smallest k with a lower service
        cost = (k_new - k) + split_cost.pop(pkey, 0)
        if k_new > iters or cores_used + cost > n_cores:
            capped.add(anchor)
            continue
        best[3] = k_new
        cores_used += cost
    return {s[0]: s[3] for s in segs if s[3] > 1}


# ------------------------------------------- enumerable search neighborhoods
def replicable_stages(pg: PartitionedGraph) -> List[Tuple[str, int]]:
    """The replication axis of the design-space search, enumerated:
    ``[(anchor node name, iteration count)]`` for every replicable segment
    of every (unreplicated) partition, in execution order.  The iteration
    count is the largest useful replica factor — ``k`` beyond it leaves
    replicas with no iterations (``replicate_partitions`` rejects it).
    """
    out: List[Tuple[str, int]] = []
    for p in pg.partitions:
        if p.repl_group is not None and p.repl_group != p.idx:
            continue
        for (anchor, iters, ok) in _stage_chain(pg, p):
            if ok:
                out.append((anchor, int(iters)))
    return out


# -------------------------------------------------------- multi-chip scale-out
def cut_bytes(pg: PartitionedGraph, boundary: int) -> int:
    """Bytes of every partition edge crossing the cut before ``boundary``
    (i.e. edges (src, dst) with src < boundary <= dst).  GCU edges are host
    I/O, never cut traffic."""
    g = pg.graph
    total = 0
    for (src, dst), vals in pg.edges.items():
        if src == GCU_PARTITION:
            continue
        if src < boundary <= dst:
            total += sum(g.values[v].nbytes for v in vals)
    return total


def chip_cuts_of(assign: Dict[int, int], n_chips: int) -> Tuple[int, ...]:
    """The boundary tuple of a contiguous chip assignment: entry ``c`` is
    the number of partitions placed on chips ``[0, c]`` — the inverse of
    ``partition_chips(..., cuts=)``, used by the autotuner to turn the DP's
    pick into an explicit, perturbable starting point."""
    counts = [0] * n_chips
    for p, c in assign.items():
        counts[c] += 1
    bounds = []
    acc = 0
    for c in range(n_chips - 1):
        acc += counts[c]
        bounds.append(acc)
    return tuple(bounds)


def cut_neighbors(cuts: Sequence[int], n_parts: int
                  ) -> Iterator[Tuple[int, ...]]:
    """The cut-point neighborhood of the design-space search: every tuple
    reachable by moving one boundary one partition left or right, kept
    non-decreasing within ``[0, n_parts]``.  Capacity and link feasibility
    are *not* checked here — ``partition_chips(..., cuts=)`` validates
    exactly, and an infeasible neighbor is discarded for free by the
    search's compile pre-filter."""
    cuts = tuple(int(c) for c in cuts)
    for i in range(len(cuts)):
        for d in (-1, 1):
            c = cuts[i] + d
            lo = cuts[i - 1] if i > 0 else 0
            hi = cuts[i + 1] if i + 1 < len(cuts) else n_parts
            if lo <= c <= hi:
                yield cuts[:i] + (c,) + cuts[i + 1:]


def _assign_from_cuts(pg: PartitionedGraph, mesh: ChipMesh,
                      cuts: Sequence[int], fwd_edges) -> Dict[int, int]:
    """Explicit-cut mode: validate ``cuts`` exactly (shape, monotonicity,
    capacity, link feasibility) and return the assignment, raising
    :class:`PartitionError` naming the violated property."""
    n_parts = len(pg.partitions)
    cap = mesh.chip.n_cores
    cuts = tuple(int(c) for c in cuts)
    if len(cuts) != mesh.n_chips - 1:
        raise PartitionError(
            f"chip cuts {cuts} need {mesh.n_chips - 1} boundaries for "
            f"{mesh.n_chips} chips, got {len(cuts)}")
    bounds = [0, *cuts, n_parts]
    for lo, hi in zip(bounds, bounds[1:]):
        if hi < lo or lo < 0 or hi > n_parts:
            raise PartitionError(
                f"chip cuts {cuts} are not non-decreasing in [0, {n_parts}]")
        if hi - lo > cap:
            raise PartitionError(
                f"chip cuts {cuts} put {hi - lo} partitions on one chip "
                f"(capacity {cap})")
    assign = {}
    for chip_idx, (lo, hi) in enumerate(zip(bounds, bounds[1:])):
        for p in range(lo, hi):
            assign[p] = chip_idx
    if not _links_ok(fwd_edges, assign, mesh):
        raise PartitionError(
            f"chip cuts {cuts} stretch a partition edge over a missing "
            f"mesh link (links: {sorted(mesh.links)})")
    return assign


def partition_chips(pg: PartitionedGraph, mesh: ChipMesh,
                    cuts: Optional[Sequence[int]] = None) -> Dict[int, int]:
    """Split the partition chain across the mesh's chips: partition -> chip.

    ``cuts`` overrides the byte-minimizing DP with explicit boundaries
    (``len == n_chips - 1``, non-decreasing partition indices) — the
    autotuner's cut-point search axis.  Explicit cuts are validated exactly
    (capacity + link feasibility) and raise :class:`PartitionError` when
    infeasible instead of falling back.

    Contract (the chip-level pass the per-chip mapper builds on):
      * assignments are *contiguous* in partition order — every partition
        edge goes forward (partition.py invariant 2), so contiguous segments
        keep the chip-level graph acyclic and forward, matching the mesh's
        chain/banded link direction;
      * each chip holds at most ``mesh.chip.n_cores`` partitions (one core
        per partition, paper §3.1);
      * cut positions minimize total cross-chip traffic: the sum over chosen
        boundaries of the bytes crossing them (an edge spanning ``h`` chips
        is counted on all ``h`` links it rides, i.e. the objective is
        bytes x hops);
      * a cut is only legal where every edge it splits lands on an existing
        link.  The DP prunes most violations (adjacent-boundary spans on
        chain meshes; empty middle chips and multi-hop topologies escape
        the prune); its optimum is always validated exactly against
        ``mesh.links``, and on failure an exhaustive sweep over all
        contiguous splits finds the cheapest *feasible* one —
        ``PartitionError`` only when none exists.
    """
    n_parts = len(pg.partitions)
    n_chips = mesh.n_chips
    cap = mesh.chip.n_cores
    if n_parts > n_chips * cap:
        raise PartitionError(
            f"{n_parts} partitions > {n_chips} chips x {cap} cores")
    fwd_edges = [(s, d) for (s, d) in pg.edges if s != GCU_PARTITION]
    if cuts is not None:
        return _assign_from_cuts(pg, mesh, cuts, fwd_edges)
    max_span = max(1, mesh.max_edge_span())

    bcost = [cut_bytes(pg, i) for i in range(n_parts + 1)]

    def span_ok(lo: int, hi: int) -> bool:
        """Adjacent-boundary pruning: no edge may both enter segment
        [lo, hi) from before ``lo`` and leave it past ``hi`` when edges are
        limited to a single boundary (chain meshes).  Multi-hop meshes
        (max_span > 1) are not pruned here — the exact feasibility pass
        below handles them."""
        if max_span > 1:
            return True
        return not any(s < lo and d >= hi for (s, d) in fwd_edges)

    INF = float("inf")
    # f[c][i] = min cost with partitions [0, i) on chips [0, c)
    f = [[INF] * (n_parts + 1) for _ in range(n_chips + 1)]
    back = [[-1] * (n_parts + 1) for _ in range(n_chips + 1)]
    f[0][0] = 0.0
    for c in range(1, n_chips + 1):
        for i in range(n_parts + 1):
            # descending j: on byte ties prefer the largest previous
            # boundary, i.e. fill earlier chips and leave trailing chips
            # empty (a chain that fits on one chip stays on chip 0)
            for j in range(i, max(0, i - cap) - 1, -1):
                if f[c - 1][j] == INF:
                    continue
                if j < i and not span_ok(j, i):
                    continue
                cost = f[c - 1][j] + (bcost[j] if 0 < j < n_parts else 0)
                if cost < f[c][i]:
                    f[c][i] = cost
                    back[c][i] = j
    if f[n_chips][n_parts] == INF:
        assign = _cheapest_feasible_split(pg, mesh, fwd_edges, bcost)
        if assign is None:
            raise PartitionError(
                f"no feasible contiguous split of {n_parts} partitions over "
                f"{n_chips} chips (capacity {cap}, max edge span {max_span})")
        return assign

    bounds = []
    i = n_parts
    for c in range(n_chips, 0, -1):
        j = back[c][i]
        bounds.append((j, i))
        i = j
    bounds.reverse()
    assign: Dict[int, int] = {}
    for chip_idx, (lo, hi) in enumerate(bounds):
        for p in range(lo, hi):
            assign[p] = chip_idx

    if _links_ok(fwd_edges, assign, mesh):
        return assign
    # The byte-minimal DP split stretches some edge over a missing link
    # (multi-hop meshes, or a chain split with an empty middle chip — the
    # span prune only sees adjacent boundary pairs).  Fall back to the
    # cheapest *feasible* contiguous split, found exhaustively (partition
    # chains are small: one partition per crossbar op).
    assign = _cheapest_feasible_split(pg, mesh, fwd_edges, bcost)
    if assign is None:
        raise PartitionError(
            f"no contiguous split of {n_parts} partitions over {n_chips} "
            "chips satisfies the link topology "
            f"(mesh links: {sorted(mesh.links)})")
    return assign


def _links_ok(fwd_edges, assign: Dict[int, int], mesh: ChipMesh) -> bool:
    return all(mesh.connected(assign[s], assign[d]) for (s, d) in fwd_edges)


def _cheapest_feasible_split(pg: PartitionedGraph, mesh: ChipMesh,
                             fwd_edges, bcost) -> Optional[Dict[int, int]]:
    """Exhaustive sweep over non-decreasing boundary tuples: the cheapest
    capacity-respecting, link-feasible contiguous split, or None."""
    import itertools

    n_parts = len(pg.partitions)
    n_chips = mesh.n_chips
    cap = mesh.chip.n_cores
    best, best_cost = None, float("inf")
    for cuts in itertools.combinations_with_replacement(
            range(n_parts + 1), n_chips - 1):
        bounds = [0] + list(cuts) + [n_parts]
        if any(hi - lo > cap for lo, hi in zip(bounds, bounds[1:])):
            continue
        assign = {}
        for chip_idx, (lo, hi) in enumerate(zip(bounds, bounds[1:])):
            for p in range(lo, hi):
                assign[p] = chip_idx
        if not _links_ok(fwd_edges, assign, mesh):
            continue
        cost = sum(bcost[b] for b in cuts if 0 < b < n_parts)
        if cost < best_cost:
            best, best_cost = assign, cost
    return best
