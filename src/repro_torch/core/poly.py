"""Polyhedral machinery (paper §3.3 + Appendix A), on real ISL via islpy.

Everything the paper does symbolically we do symbolically:

* iteration spaces / array extents are ISL sets,
* read/write access relations are ISL maps (paper Listing 2),
* the dependency-frontier relation ``S : O -> J`` is computed with the exact
  Appendix-A recipe (K, D, D', L, M, S),
* the LCU evaluator is *generated code*: the single-valued ``S`` is converted
  to a piecewise multi-affine function and emitted as Python source, mirroring
  the paper's ISL-AST -> Python-AST -> bytecode flow (§3.4/§3.5).

When ``islpy`` is unavailable, the module falls back to the finite-relation
backend in :mod:`.fisl` and an equivalent numeric (prefix-max) construction
of ``S`` — semantically the paper's §3.5 enumerated "restricted hardware"
variant.  ``HAVE_ISL`` records which backend is active.

Beyond the paper's per-write generated code, :func:`compile_frontier_table`
precompiles the whole piecewise multi-affine ``S`` into one dense lookup
array per dependency (every array location -> flattened reader-iteration
rank), which is what the event-driven simulator engine consumes: a write
batch advances a frontier with a single vectorized gather + max.

Port copy of ``repro.core.poly``: the same code, with every import inside
``repro_torch``; ``tests/test_torch_*.py`` hold the two equal.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

try:
    import islpy as isl
    HAVE_ISL = True
except ModuleNotFoundError:  # gate the dep: fall back to finite relations
    from . import fisl as isl
    HAVE_ISL = False

Point = Tuple[int, ...]


# --------------------------------------------------------------------- helpers
def set_from_box(name: str, dims: Sequence[str], ubs: Sequence[int]) -> isl.Set:
    """{ name[d0,..] : 0 <= di < ubs[i] }."""
    vars_ = ",".join(dims)
    cons = " and ".join(f"0 <= {d} < {u}" for d, u in zip(dims, ubs))
    if not dims:
        return isl.Set(f"{{ {name}[] }}")
    return isl.Set(f"{{ {name}[{vars_}] : {cons} }}")


def map_from_str(s: str) -> isl.Map:
    return isl.Map(s)


def point_tuple(p, ndim: int) -> Point:
    if isinstance(p, tuple):          # fisl backend yields plain tuples
        return p
    return tuple(
        int(p.get_coordinate_val(isl.dim_type.set, i).to_python()) for i in range(ndim)
    )


def enumerate_set(s) -> List[Point]:
    """All integer points of a (bounded) set, in lexicographic order."""
    if hasattr(s, "_points"):
        return s._points()
    pts: List[Point] = []
    nd = s.dim(isl.dim_type.set)
    s.foreach_point(lambda p: pts.append(point_tuple(p, nd)))
    pts.sort()
    return pts


def enumerate_map(m) -> List[Tuple[Point, Point]]:
    """All (in -> out) pairs of a bounded map."""
    if hasattr(m, "_pairs"):
        return m._pairs()
    nd_in = m.dim(isl.dim_type.in_)
    nd_out = m.dim(isl.dim_type.out)
    pairs: List[Tuple[Point, Point]] = []

    def visit(p) -> None:
        coords = point_tuple(p, nd_in + nd_out)
        pairs.append((coords[:nd_in], coords[nd_in:]))

    m.wrap().foreach_point(visit)
    pairs.sort()
    return pairs


def single_point(s) -> Optional[Point]:
    if s.is_empty():
        return None
    p = s.sample_point()
    return point_tuple(p, s.dim(isl.dim_type.set))


def relation_stream(m) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Enumerate an access relation as an execution-ordered event stream.

    Returns ``(iters, idx, locs)``: the distinct input iterations in
    lexicographic order (``(n_iters, nd_in)``), and for every
    ``iteration -> location`` pair of the relation the index of its
    iteration (``(n_pairs,)``) plus the accessed location
    (``(n_pairs, nd_out)``).  Cores execute their iteration boxes in
    lexicographic order, so for a write relation this is exactly the order
    the producer emits SRAM writes in — the stream the static verifier
    replays against the compiled frontier ramp (``frontier_limit_ramp``).
    """
    nd_i = m.dim(isl.dim_type.in_)
    nd_o = m.dim(isl.dim_type.out)
    pairs = enumerate_map(m)
    if not pairs:
        return (np.zeros((0, nd_i), np.int64), np.zeros(0, np.int64),
                np.zeros((0, nd_o), np.int64))
    arr = np.asarray([list(i) + list(o) for i, o in pairs], np.int64)
    iters, idx = np.unique(arr[:, :nd_i], axis=0, return_inverse=True)
    return iters, idx.astype(np.int64).ravel(), arr[:, nd_i:]


# ------------------------------------------------------------------ Appendix A
@dataclasses.dataclass
class DepInfo:
    """Everything the LCU needs for one (producer-array -> reader) edge."""

    S: isl.Map                  # O -> J   (single-valued after lexmax)
    D_lexmin: Optional[Point]   # first reader iteration with a dependency
    D_lexmax: Optional[Point]   # last reader iteration with a dependency
    reader_ndim: int
    array_ndim: int


def compute_S(W1, R2):
    """Appendix A, verbatim.

    W1 : I -> O  (producer write access relation; injective per location)
    R2 : J -> O  (reader read access relation)
    returns S : O -> J, mapping each observed write location to the
    lexicographically-maximal reader iteration that is then safe to execute.
    """
    if not HAVE_ISL:
        return _numeric_S_parts(W1, R2)[0]
    # K := W1^-1(R2)   (J -> I): pair each read iteration with the write
    # iterations producing the locations it reads.  Reads of locations never
    # written (e.g. padding) drop out of the composition automatically.
    K = R2.apply_range(W1.reverse())
    # D := dom(K)
    D = K.domain()
    if D.is_empty():
        # Reader never touches producer-written locations (e.g. pure padding):
        # S is the empty relation in the O -> J space.
        return isl.Map.empty(R2.reverse().get_space())
    # D' := D >>= D    (J -> J): j mapped to every iteration zeta <= j
    Dp = D.lex_ge_set(D)
    # L := lexmax(K(D'))  (J -> I)
    L = Dp.apply_range(K).lexmax()
    # M := W1(L)          (J -> O)
    M = L.apply_range(W1)
    # S := lexmax(M^-1)   (O -> J)
    S = M.reverse().lexmax()
    return S


def _numeric_S_parts(W1, R2):
    """Finite-backend equivalent of the Appendix-A recipe.

    With all relations enumerated, ``S`` has a direct prefix-max reading:
    order write iterations lexicographically ("write time"); for each reader
    iteration j, T(j) is the latest write time among the written locations j
    reads; the running lex-prefix maximum of T over sorted readers is the
    write iteration L(j) whose completion unlocks j.  ``S`` then maps every
    location written by L(j) to the lexmax such j — exactly
    lexmax(M^-1) of the symbolic recipe.

    Returns ``(S, D_lexmin, D_lexmax)``.
    """
    from . import fisl

    nd_o = W1.dim(isl.dim_type.out)
    nd_j = R2.dim(isl.dim_type.in_)
    empty = fisl.Map.empty((nd_o, nd_j))
    wpts, ni_w = W1.pts, W1.nin
    rpts, ni_r = R2.pts, R2.nin
    if not len(wpts) or not len(rpts):
        return empty, None, None
    wloc = wpts[:, ni_w:]
    _, w_time = np.unique(wpts[:, :ni_w], axis=0, return_inverse=True)
    loc_time: Dict[Point, int] = {}
    for row, t in zip(wloc, w_time):
        key = tuple(int(x) for x in row)
        if key not in loc_time or int(t) > loc_time[key]:
            loc_time[key] = int(t)
    readers, r_inv = np.unique(rpts[:, :ni_r], axis=0, return_inverse=True)
    times = np.array(
        [loc_time.get(tuple(int(x) for x in row), -1) for row in rpts[:, ni_r:]],
        np.int64)
    T = np.full(len(readers), -1, np.int64)
    np.maximum.at(T, r_inv, times)
    in_D = T >= 0
    D = readers[in_D]
    if not len(D):
        return empty, None, None
    Tpref = np.maximum.accumulate(T[in_D])
    # lexmax reader per distinct unlocking write time (last occurrence)
    vals, first_rev = np.unique(Tpref[::-1], return_index=True)
    last_reader = {int(v): int(len(Tpref) - 1 - i)
                   for v, i in zip(vals, first_rev)}
    rows: List[List[int]] = []
    for row, t in zip(wloc, w_time):
        li = last_reader.get(int(t))
        if li is not None:
            rows.append([int(x) for x in row] + [int(x) for x in D[li]])
    pts = (np.array(rows, np.int64) if rows
           else np.zeros((0, nd_o + nd_j), np.int64))
    S = fisl.Map.from_points(pts, nin=nd_o, in_name="A", out_name="RD")
    return S, tuple(int(x) for x in D[0]), tuple(int(x) for x in D[-1])


def restrict_writes_mod(W1, iter_bounds: Sequence[int], k: int, r: int):
    """Domain-restrict a write relation to producer iterations with flat
    lexicographic rank ``== r (mod k)`` — the round-robin iteration filter of
    a replicated partition.

    ``iter_bounds`` is the producer partition's iteration box, which defines
    the flattening radix (same mixed-radix convention as :func:`iter_rank`).
    Composing the existing Appendix-A relations with this filter yields the
    per-replica ``S``: the consumer then keeps one frontier per replica and
    admits an iteration only when *every* replica's frontier does.
    """
    k, r = int(k), int(r)
    if k <= 1:
        return W1
    nd = W1.dim(isl.dim_type.in_)
    bounds = tuple(int(b) for b in iter_bounds)
    assert nd == len(bounds), (nd, bounds)
    radix = [1] * nd
    for d in range(nd - 2, -1, -1):
        radix[d] = radix[d + 1] * bounds[d + 1]
    if not HAVE_ISL:
        pts = W1.pts
        if len(pts):
            ranks = pts[:, :nd] @ np.asarray(radix, np.int64)
            pts = pts[(ranks % k) == r]
        return isl.Map.from_points(pts, nin=nd, in_name=W1.in_name,
                                   out_name=W1.out_name)
    tup = W1.get_tuple_name(isl.dim_type.in_)
    dims = [f"i{i}" for i in range(nd)]
    expr = " + ".join(f"{radix[i]}*{dims[i]}" for i in range(nd))
    dom = isl.Set(f"{{ {tup}[{','.join(dims)}] : ({expr}) mod {k} = {r} }}")
    return W1.intersect_domain(dom)


def compute_dep_info(W1, R2) -> DepInfo:
    if not HAVE_ISL:
        S, dmin, dmax = _numeric_S_parts(W1, R2)
        return DepInfo(S=S, D_lexmin=dmin, D_lexmax=dmax,
                       reader_ndim=R2.dim(isl.dim_type.in_),
                       array_ndim=W1.dim(isl.dim_type.out))
    S = compute_S(W1, R2)
    K = R2.apply_range(W1.reverse())
    D = K.domain()
    return DepInfo(
        S=S,
        D_lexmin=single_point(D.lexmin()) if not D.is_empty() else None,
        D_lexmax=single_point(D.lexmax()) if not D.is_empty() else None,
        reader_ndim=R2.dim(isl.dim_type.in_),
        array_ndim=W1.dim(isl.dim_type.out),
    )


# ------------------------------------------------------- S -> generated Python
def _aff_to_py(aff: isl.Aff, invars: List[str]) -> str:
    """Convert an isl Aff over ``invars`` into a Python expression string.

    Handles integer-division terms (floord) recursively — Python's ``//`` is
    floor division, matching isl's floord semantics.  Rational coefficients
    (they appear e.g. for strided accesses) are cleared by scaling the whole
    Aff by its common denominator first, then flooring at the top level.
    """
    den = aff.get_denominator_val().to_python()
    if den != 1:
        aff = aff.scale_val(isl.Val.int_from_si(aff.get_ctx(), den))
    n_in = aff.dim(isl.dim_type.in_)
    n_div = aff.dim(isl.dim_type.div)
    terms: List[str] = []
    for i in range(n_in):
        c = aff.get_coefficient_val(isl.dim_type.in_, i).to_python()
        if c:
            terms.append(f"({c})*{invars[i]}")
    for d in range(n_div):
        c = aff.get_coefficient_val(isl.dim_type.div, d).to_python()
        if c:
            div = aff.get_div(d)  # an Aff whose value is floor(inner)
            inner = _aff_to_py(div, invars)
            terms.append(f"({c})*({inner})")
    cst_num = aff.get_constant_val().to_python()
    expr = " + ".join(terms) if terms else "0"
    expr = f"({expr} + ({cst_num}))"
    if den != 1:
        expr = f"(({expr}) // ({den}))"
    return expr


def _constraint_to_py(c: isl.Constraint, invars: List[str]) -> str:
    aff = c.get_aff()
    body = _aff_to_py(aff, invars)
    return f"{body} == 0" if c.is_equality() else f"{body} >= 0"


def _bset_to_py(bset: isl.BasicSet, invars: List[str]) -> str:
    conds = [_constraint_to_py(c, invars) for c in bset.get_constraints()]
    return " and ".join(conds) if conds else "True"


def generate_s_evaluator(dep: DepInfo, fn_name: str = "s_eval") -> Tuple[str, object]:
    """Generate Python source for evaluating S at an array location.

    Returns ``(source, callable)``.  The callable maps a location tuple to the
    maximal-safe reader iteration tuple, or ``None`` when this write does not
    advance the frontier.  This mirrors the paper's §3.4: code generated from
    the ISL representation, compiled to Python bytecode.  On the finite
    backend the emitted code is the §3.5 enumerated-table variant instead of
    piecewise-affine conditionals.
    """
    if not HAVE_ISL:
        return _generate_table_evaluator(dep, fn_name)
    nd_o = dep.array_ndim
    invars = [f"o{i}" for i in range(nd_o)]
    lines = [f"def {fn_name}({', '.join(invars) if invars else ''}):"]
    try:
        pma = isl.PwMultiAff.from_map(dep.S)
        pieces: List[Tuple[isl.Set, isl.MultiAff]] = []
        pma.foreach_piece(lambda st, ma: pieces.append((st, ma)))
        if not pieces:
            lines.append("    return None")
        for st, ma in pieces:
            for bset in st.get_basic_sets():
                cond = _bset_to_py(bset, invars)
                outs = [
                    _aff_to_py(ma.get_at(j), invars) for j in range(ma.dim(isl.dim_type.out))
                ]
                lines.append(f"    if {cond}:")
                lines.append(f"        return ({', '.join(outs)}{',' if len(outs) == 1 else ''})")
    except Exception:
        # Relations composed with the modular replication filter can carry
        # existentially-quantified constraints the affine printer cannot
        # express; the enumerated-table codegen (§3.5) is always available.
        return _generate_table_evaluator(dep, fn_name)
    lines.append("    return None")
    src = "\n".join(lines) + "\n"
    ns: Dict[str, object] = {}
    exec(compile(src, f"<isl-gen:{fn_name}>", "exec"), ns)  # noqa: S102 - paper's own flow
    return src, ns[fn_name]


def _generate_table_evaluator(dep: DepInfo, fn_name: str) -> Tuple[str, object]:
    """Finite-backend codegen: the enumerated ``S`` as a dict lookup."""
    entries = {i: o for i, o in enumerate_map(dep.S)}
    invars = [f"o{i}" for i in range(dep.array_ndim)]
    args = ", ".join(invars)
    key = f"({args},)" if len(invars) == 1 else f"({args})"
    src = (f"_S_TABLE = {entries!r}\n\n"
           f"def {fn_name}({args}):\n"
           f"    return _S_TABLE.get({key})\n")
    ns: Dict[str, object] = {}
    exec(compile(src, f"<table-gen:{fn_name}>", "exec"), ns)  # noqa: S102
    return src, ns[fn_name]


def s_table(dep: DepInfo) -> Dict[Point, Point]:
    """Enumerated S — the 'restricted hardware LCU' variant (paper §3.5)."""
    return {o: j for o, j in enumerate_map(dep.S)}


# ------------------------------------------------------------ frontier automaton
class Frontier:
    """The per-array piece of the LCU state machine.

    Tracks the lexicographically-maximal safe reader iteration given the
    writes observed so far.  Three phases:
      * before any frontier-advancing write: iterations strictly before
        ``D_lexmin`` are safe (they have no RAW dependency on this array);
      * after writes: iterations ``<= S(last advancing write)`` are safe;
      * once the frontier reaches ``D_lexmax``: every iteration is safe.
    """

    def __init__(self, dep: DepInfo, evaluator=None):
        self.dep = dep
        self.eval = evaluator if evaluator is not None else generate_s_evaluator(dep)[1]
        self.bound: Optional[Point] = None  # max safe iteration (inclusive)
        self.unbounded = dep.D_lexmin is None  # array never constrains us

    def observe(self, loc: Point) -> None:
        if self.unbounded:
            return
        j = self.eval(*loc)
        if j is None:
            return
        if self.bound is None or j > self.bound:
            self.bound = tuple(j)
        if self.bound == self.dep.D_lexmax:
            self.unbounded = True

    def safe(self, it: Point) -> bool:
        if self.unbounded:
            return True
        if self.bound is None:
            return it < self.dep.D_lexmin
        return it <= self.bound or it < self.dep.D_lexmin


# ------------------------------------------------- compiled frontier tables
INF_RANK = 1 << 62
"""Saturation sentinel: a frontier limit of INF_RANK admits every iteration."""


def frontier_limit_ramp(ranks: np.ndarray, d_lexmin_rank: int,
                        d_lexmax_rank: int, floor: int = -1):
    """Frontier limits after each write of a rank stream (the table contract).

    ``ranks`` are table lookups (``FrontierTable.rank``) for a sequence of
    writes in arrival order; ``floor`` carries the running bound of earlier
    streams.  Returns ``(cummax, limits)``: the running lexmax rank, and the
    admitted-iteration limit after each write — ``max(cummax, d_lexmin - 1)``
    (iterations before ``D_lexmin`` have no dependency), saturating to
    ``INF_RANK`` once ``D_lexmax`` is reached (then everything is safe).
    Both consumers — the event engine's runtime LCU and the pipeline
    scheduler — must use this one definition.
    """
    cm = np.maximum.accumulate(ranks)
    if floor >= 0:
        np.maximum(cm, floor, out=cm)
    limits = np.where(cm >= d_lexmax_rank, INF_RANK,
                      np.maximum(cm, d_lexmin_rank - 1))
    return cm, limits


def iter_rank(point: Sequence[int], bounds: Sequence[int]) -> int:
    """Flatten a reader iteration to its lexicographic rank (mixed radix)."""
    r = 0
    for p, b in zip(point, bounds):
        r = r * int(b) + int(p)
    return r


@dataclasses.dataclass
class FrontierTable:
    """``S`` precompiled to a dense per-location lookup (the vectorized LCU).

    ``rank[o] = iter_rank(S(o), reader_bounds)`` for every array location
    ``o``, or ``-1`` where the write does not advance the frontier.  Because
    consumer cores execute their iteration space in lexicographic order, a
    frontier is a single integer threshold: iteration ``j`` is safe iff
    ``iter_rank(j) <= max(observed-bound, d_lexmin_rank - 1)`` — one gather +
    running max per delivered write batch, no generated-code calls.
    """

    rank: np.ndarray                  # int64, shape == array extents
    reader_bounds: Tuple[int, ...]
    d_lexmin_rank: int                # -1 => array never constrains execution
    d_lexmax_rank: int

    @property
    def never_constrains(self) -> bool:
        return self.d_lexmin_rank < 0

    @property
    def nbytes(self) -> int:
        return int(self.rank.nbytes)


def _table_ranks_from_pairs(dep: DepInfo, array_shape: Sequence[int],
                            bounds: Sequence[int]) -> np.ndarray:
    rank = np.full(tuple(array_shape), -1, np.int64)
    pairs = enumerate_map(dep.S)
    if pairs:
        locs = np.array([o for o, _ in pairs], np.int64)
        outs = np.array([j for _, j in pairs], np.int64)
        radix = np.ones(len(bounds), np.int64)
        for d in range(len(bounds) - 2, -1, -1):
            radix[d] = radix[d + 1] * bounds[d + 1]
        rank[tuple(locs.T)] = outs @ radix
    return rank


def _table_ranks_isl_vectorized(dep: DepInfo, array_shape: Sequence[int],
                                bounds: Sequence[int]) -> np.ndarray:
    """Evaluate the piecewise multi-affine ``S`` on the full location grid.

    Reuses the §3.4 codegen printers but evaluates each piece's guard and
    affine outputs elementwise over numpy index grids, so the whole table is
    produced with a handful of array ops per piece.
    """
    nd_j = dep.reader_ndim
    invars = [f"o{i}" for i in range(dep.array_ndim)]
    grids = np.meshgrid(*[np.arange(s, dtype=np.int64) for s in array_shape],
                        indexing="ij")
    env = {v: g for v, g in zip(invars, grids)}
    pma = isl.PwMultiAff.from_map(dep.S)
    pieces: List[Tuple[object, object]] = []
    pma.foreach_piece(lambda st, ma: pieces.append((st, ma)))
    rank = np.full(tuple(array_shape), -1, np.int64)
    radix = np.ones(nd_j, np.int64)
    for d in range(nd_j - 2, -1, -1):
        radix[d] = radix[d + 1] * bounds[d + 1]
    for st, ma in pieces:
        for bset in st.get_basic_sets():
            mask = np.ones(tuple(array_shape), bool)
            for c in bset.get_constraints():
                expr = _constraint_to_py(c, invars)
                mask &= np.asarray(eval(expr, {"__builtins__": {}}, env))  # noqa: S307
            if not mask.any():
                continue
            r = np.zeros(tuple(array_shape), np.int64)
            for j in range(nd_j):
                val = eval(_aff_to_py(ma.get_at(j), invars),  # noqa: S307
                           {"__builtins__": {}}, env)
                r += np.asarray(val, np.int64) * radix[j]
            rank[mask] = r[mask]
    return rank


def compile_frontier_table(dep: DepInfo, array_shape: Sequence[int],
                           reader_bounds: Sequence[int]) -> FrontierTable:
    """Build the vectorized frontier table for one (producer array, reader).

    ``array_shape`` are the unpadded array extents; ``reader_bounds`` is the
    consumer core's iteration-space box (``CoreConfig.iter_bounds``).  Built
    once at lowering time; O(|array|) memory, replaces one generated-code
    call per SRAM write with a table gather.
    """
    bounds = tuple(int(b) for b in reader_bounds)
    assert len(bounds) == dep.reader_ndim, (bounds, dep.reader_ndim)
    if dep.D_lexmin is None:
        return FrontierTable(np.full(tuple(array_shape), -1, np.int64),
                             bounds, -1, -1)
    if HAVE_ISL:
        try:
            rank = _table_ranks_isl_vectorized(dep, array_shape, bounds)
        except Exception as e:  # defensive: fall back to point enumeration
            import warnings
            warnings.warn(
                f"vectorized ISL table compilation failed ({e!r}); "
                "falling back to per-point enumeration", RuntimeWarning)
            rank = _table_ranks_from_pairs(dep, array_shape, bounds)
    else:
        rank = _table_ranks_from_pairs(dep, array_shape, bounds)
    return FrontierTable(rank, bounds,
                         iter_rank(dep.D_lexmin, bounds),
                         iter_rank(dep.D_lexmax, bounds))


# ------------------------------------------------------ frontier-compile cache
# Lowering cost is dominated by the Appendix-A S computation + codegen + table
# compile (BENCH_compile: lower_isl_ms ~ 99% of compile).  Identical layer
# shapes produce byte-identical relations, so the compiled unit is content-
# addressed by the relation text (islpy) / point set (fisl) plus the array
# extents and reader bounds.  Entries are immutable after construction (the
# simulator only reads DepInfo/FrontierTable), so sharing across cores and
# programs is safe.
_LCU_CACHE: Dict[tuple, tuple] = {}
_LCU_CACHE_STATS = {"hits": 0, "misses": 0}
_LCU_CACHE_ENABLED = True


def _relation_key(m) -> tuple:
    if HAVE_ISL:
        return ("isl", str(m))
    return ("fisl", m.nin, m.pts.shape, m.pts.tobytes())


def frontier_cache_enable(flag: bool) -> None:
    """Toggle the compiled-frontier cache (on by default)."""
    global _LCU_CACHE_ENABLED
    _LCU_CACHE_ENABLED = bool(flag)


def frontier_cache_clear() -> None:
    _LCU_CACHE.clear()
    _LCU_CACHE_STATS["hits"] = 0
    _LCU_CACHE_STATS["misses"] = 0


def frontier_cache_stats() -> Dict[str, int]:
    return dict(_LCU_CACHE_STATS)


def compile_lcu(W1, R2, array_shape: Sequence[int],
                reader_bounds: Sequence[int]) -> tuple:
    """The full per-dependency LCU unit: ``(DepInfo, gen_src, FrontierTable)``.

    One content-addressed cache entry per (write relation, read relation,
    array extents, reader bounds) under the active backend — repeated layer
    shapes (resnet chains, transformer blocks, replica groups) compile once.
    """
    key = (_relation_key(W1), _relation_key(R2),
           tuple(int(x) for x in array_shape),
           tuple(int(x) for x in reader_bounds))
    if _LCU_CACHE_ENABLED:
        unit = _LCU_CACHE.get(key)
        if unit is not None:
            _LCU_CACHE_STATS["hits"] += 1
            return unit
    dep = compute_dep_info(W1, R2)
    gen_src, _ = generate_s_evaluator(dep)
    table = compile_frontier_table(dep, array_shape, reader_bounds)
    unit = (dep, gen_src, table)
    if _LCU_CACHE_ENABLED:
        _LCU_CACHE_STATS["misses"] += 1
        _LCU_CACHE[key] = unit
    return unit
