"""Hardware description of the CM accelerator (paper §2).

The compiler consumes: number of cores, per-core crossbar width, local SRAM
size, and the interconnect topology as a directed graph (paper: "we decide to
expose the interconnect topology to the compiler").

Port copy of ``repro.core.hwspec``: the same code, with every import inside
``repro_torch``; ``tests/test_torch_*.py`` hold the two equal.
"""

from __future__ import annotations

import dataclasses
from typing import FrozenSet, Tuple
Edge = Tuple[int, int]


@dataclasses.dataclass(frozen=True)
class CoreSpec:
    """One CM core: crossbar of ``width``×``width`` cells + SRAM + DPU."""

    width: int = 256
    sram_bytes: int = 64 * 1024  # "typically, a few kilobytes of SRAM"


@dataclasses.dataclass(frozen=True)
class ChipSpec:
    """The CM accelerator chip: cores + interconnect + global buffer."""

    n_cores: int
    core: CoreSpec
    edges: FrozenSet[Edge]            # directed: (src can send to dst)
    gmem_bytes: int = 1 << 20
    dma_pixels_per_cycle: int = 4     # GCU -> GMEM -> input-core stream rate

    def connected(self, a: int, b: int) -> bool:
        return (a, b) in self.edges


# ------------------------------------------------------------------ topologies
def all_to_all(n: int) -> FrozenSet[Edge]:
    return frozenset((a, b) for a in range(n) for b in range(n) if a != b)


def chain(n: int) -> FrozenSet[Edge]:
    return frozenset((i, i + 1) for i in range(n - 1))


def ring(n: int) -> FrozenSet[Edge]:
    return frozenset((i, (i + 1) % n) for i in range(n))


def grid2d(rows: int, cols: int) -> FrozenSet[Edge]:
    """Bidirectional 2-D mesh."""
    edges = set()
    for r in range(rows):
        for c in range(cols):
            i = r * cols + c
            if c + 1 < cols:
                edges |= {(i, i + 1), (i + 1, i)}
            if r + 1 < rows:
                edges |= {(i, i + cols), (i + cols, i)}
    return frozenset(edges)


def banded(n: int, k: int = 5) -> FrozenSet[Edge]:
    """Forward-banded DAG topology: core i can send to i+1 .. i+k.

    This is our stand-in for the 5-Parallel-Prism of Dazzi et al. [33]: a
    bounded-degree topology whose forward skip edges are exactly what residual
    CNNs (paper Fig. 2) need — the skip connection rides the (i, i+2) edge
    while the main path uses (i, i+1).
    """
    return frozenset((i, i + d) for i in range(n) for d in range(1, k + 1)
                     if i + d < n)


def make_chip(n_cores: int, topology: str = "all_to_all", width: int = 256,
              sram_bytes: int = 256 * 1024, **kw) -> ChipSpec:
    builders = {
        "all_to_all": lambda: all_to_all(n_cores),
        "chain": lambda: chain(n_cores),
        "ring": lambda: ring(n_cores),
        "banded": lambda: banded(n_cores, kw.pop("k", 5)),
        "grid2d": lambda: grid2d(kw.pop("rows", 1), kw.pop("cols", n_cores)),
    }
    edges = builders[topology]()
    return ChipSpec(n_cores=n_cores, core=CoreSpec(width, sram_bytes),
                    edges=edges, **kw)


# ------------------------------------------------------- tenant core windows
def subchip(chip: ChipSpec, lo: int, hi: int) -> ChipSpec:
    """The induced sub-chip over the core window ``[lo, hi)``, relabeled to
    0-based ids.

    Tenant placement (``compile_model``'s :func:`place_tenants` pass) solves
    each tenant's mapping against the window's *induced* interconnect, so a
    mapping that is feasible on the sub-chip is feasible verbatim on the real
    chip once core ids are offset by ``lo`` — contiguous windows of the
    homogeneous topologies (``chain``/``banded``/``all_to_all``) induce the
    same topology, which is why tenants get contiguous core ranges.
    """
    if not (0 <= lo < hi <= chip.n_cores):
        raise ValueError(f"core window [{lo}, {hi}) outside chip "
                         f"[0, {chip.n_cores})")
    edges = frozenset((a - lo, b - lo) for (a, b) in chip.edges
                      if lo <= a < hi and lo <= b < hi)
    return dataclasses.replace(chip, n_cores=hi - lo, edges=edges)


# ------------------------------------------------------------ multi-chip mesh
@dataclasses.dataclass(frozen=True)
class LinkSpec:
    """One bounded inter-chip link.

    ``latency`` — extra cycles a message spends on the wire beyond the
    intra-chip SRAM-write-at-cycle+1 (paper §2); ``width_bytes`` — bytes the
    link moves per cycle, so a message of ``n`` bytes adds
    ``ceil(n / width_bytes) - 1`` serialization cycles on top of the latency.
    Both are per-message and deterministic (no cross-stream queueing), which
    is what lets the event-driven and dense simulator engines stay
    bit-identical on multi-chip programs.
    """

    latency: int = 4
    width_bytes: int = 64

    def beats(self, nbytes: int) -> int:
        """Cycles the link is occupied by one message of ``nbytes`` — the
        single definition both the delay model and the occupancy accounting
        (``LinkStats.busy``) derive from."""
        return -(-int(nbytes) // self.width_bytes)

    def transfer_delay(self, nbytes: int) -> int:
        """Extra arrival cycles for one message of ``nbytes`` on this link."""
        return self.latency + max(0, self.beats(nbytes) - 1)

    def degraded(self, latency_add: int = 0,
                 width_shrink: int = 1) -> "LinkSpec":
        """This link with extra latency and/or a fraction of its width —
        the effective spec while a :class:`repro.faults.LinkFault` is
        active.  Width never degrades below one byte per cycle."""
        if latency_add < 0 or width_shrink < 1:
            raise ValueError("links only degrade: latency_add >= 0 and "
                             "width_shrink >= 1 required")
        return LinkSpec(latency=self.latency + int(latency_add),
                        width_bytes=max(1, self.width_bytes
                                        // int(width_shrink)))


@dataclasses.dataclass(frozen=True)
class ChipMesh:
    """N homogeneous CM chips joined by bounded directed links.

    Cores get *global* ids: core ``i`` of chip ``c`` is
    ``c * chip.n_cores + i``, so a multi-chip ``AcceleratorProgram`` looks
    exactly like a wide single-chip one to the mapper/lowering, with the
    link model applied only to messages whose endpoints live on different
    chips.  GCU/GMEM host I/O is chip-local (each chip has its own host
    interface, the paper's global-memory abstraction), so mesh links carry
    only core-to-core activation streams (the cut edges of the partition
    graph).
    """

    chip: ChipSpec
    n_chips: int
    links: "frozenset[Edge]"
    link: LinkSpec = LinkSpec()

    @property
    def n_cores_total(self) -> int:
        return self.n_chips * self.chip.n_cores

    @property
    def dma_pixels_per_cycle(self) -> int:
        return self.chip.dma_pixels_per_cycle

    def chip_of(self, core: int) -> int:
        return core // self.chip.n_cores

    def local_core(self, core: int) -> int:
        return core % self.chip.n_cores

    def global_core(self, chip_idx: int, local: int) -> int:
        return chip_idx * self.chip.n_cores + local

    def connected(self, a: int, b: int) -> bool:
        return a == b or (a, b) in self.links

    def link_between(self, a: int, b: int) -> LinkSpec:
        if (a, b) not in self.links:
            raise KeyError(f"no link between chips {a} and {b}")
        return self.link

    def max_edge_span(self) -> int:
        """Largest forward hop ``h`` with every ``(c, c+h)`` link present."""
        h = 0
        while h + 1 < self.n_chips and all(
                (c, c + h + 1) in self.links
                for c in range(self.n_chips - h - 1)):
            h += 1
        return h


def submesh(mesh: ChipMesh, lo: int, hi: int) -> ChipMesh:
    """The induced sub-mesh over the chip window ``[lo, hi)``, relabeled to
    0-based chip ids (tenant placement over meshes is chip-granular: each
    tenant owns whole chips, so its cut edges ride links no other tenant's
    partition chain uses — the shared contention is the host GCU stream)."""
    if not (0 <= lo < hi <= mesh.n_chips):
        raise ValueError(f"chip window [{lo}, {hi}) outside mesh "
                         f"[0, {mesh.n_chips})")
    links = frozenset((a - lo, b - lo) for (a, b) in mesh.links
                      if lo <= a < hi and lo <= b < hi)
    return ChipMesh(chip=mesh.chip, n_chips=hi - lo, links=links,
                    link=mesh.link)


def make_mesh(n_chips: int, chip: ChipSpec = None, topology: str = "chain",
              link_latency: int = 4, link_width_bytes: int = 64,
              k: int = 2, **chip_kw) -> ChipMesh:
    """``n_chips`` copies of ``chip`` joined by ``topology`` links.

    ``topology`` is a chip-level variant of the intra-chip builders:
    ``chain`` (forward pipeline, the default — layer chains only ever send
    forward), ``ring``, ``banded`` (forward skips of depth ``k``, for deeper
    residual pipelines, after the Parallel-Prism construction),
    ``all_to_all``.  Remaining keywords build the chip when none is given.
    """
    if chip is None:
        chip = make_chip(chip_kw.pop("n_cores", 8),
                         chip_kw.pop("chip_topology", "all_to_all"),
                         **chip_kw)
    elif chip_kw:
        raise TypeError(f"chip given AND chip kwargs {sorted(chip_kw)}")
    builders = {
        "all_to_all": lambda: all_to_all(n_chips),
        "chain": lambda: chain(n_chips),
        "ring": lambda: ring(n_chips),
        "banded": lambda: banded(n_chips, k),
    }
    return ChipMesh(chip=chip, n_chips=n_chips, links=builders[topology](),
                    link=LinkSpec(link_latency, link_width_bytes))
