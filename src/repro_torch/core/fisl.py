"""Finite-relation fallback for the islpy subset this compiler uses.

The paper's flow is symbolic: access relations are ISL maps and the
Appendix-A ``S`` is derived with ISL operations.  When ``islpy`` is not
installed we still want the *whole* compiler + simulator to work, so this
module provides drop-in ``Map``/``Set`` objects that

  * parse the exact relation-string subset the compiler emits
    (``{ NAME[i,j] -> A[c,x,y] : <conjunction of chained affine compares> }``),
  * enumerate the (always bounded) integer points with numpy, and
  * expose the handful of ISL methods the rest of the code touches
    (``domain``, ``reverse``, ``lexmin``/``lexmax``, ``is_empty``,
    ``is_single_valued``, ``dim``, ``union``, ...).

This is semantically the paper's §3.5 "restricted hardware" variant: every
relation is materialized as an enumerated table rather than kept symbolic.
``poly.compute_S`` detects this backend and runs an equivalent numeric
prefix-max construction of ``S`` (see ``poly._numeric_S_parts``) instead of
the symbolic Appendix-A recipe.

Port copy of ``repro.core.fisl``: the same code, with every import inside
``repro_torch``; ``tests/test_torch_*.py`` hold the two equal.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Tuple

import numpy as np

Point = Tuple[int, ...]

_TOKEN = re.compile(r"\d+|[A-Za-z_]\w*|<=|>=|==|[<>=+\-*]")
_MAX_PROPAGATE = 64


class dim_type:  # mirrors isl.dim_type for the attributes poly.py touches
    set = "set"
    in_ = "in"
    out = "out"
    div = "div"
    param = "param"


class FislError(Exception):
    pass


# ------------------------------------------------------------------ parsing
class _Lin:
    """Integer-affine expression: sum(coeffs[v] * v) + const."""

    __slots__ = ("coeffs", "const")

    def __init__(self, coeffs: Optional[Dict[str, int]] = None, const: int = 0):
        self.coeffs = coeffs or {}
        self.const = const

    def __add__(self, o: "_Lin") -> "_Lin":
        c = dict(self.coeffs)
        for v, a in o.coeffs.items():
            c[v] = c.get(v, 0) + a
        return _Lin(c, self.const + o.const)

    def __sub__(self, o: "_Lin") -> "_Lin":
        c = dict(self.coeffs)
        for v, a in o.coeffs.items():
            c[v] = c.get(v, 0) - a
        return _Lin(c, self.const - o.const)

    def vars(self) -> set:
        return {v for v, a in self.coeffs.items() if a}


def _parse_expr(tokens: List[str], pos: int) -> Tuple[_Lin, int]:
    """expr := ['-'] term (('+'|'-') term)*; term := INT ['*' VAR] | VAR."""
    out = _Lin()
    sign = 1
    if pos < len(tokens) and tokens[pos] == "-":
        sign, pos = -1, pos + 1
    while True:
        tok = tokens[pos]
        if tok.isdigit():
            val = int(tok)
            if pos + 2 < len(tokens) and tokens[pos + 1] == "*":
                var = tokens[pos + 2]
                out = out + _Lin({var: sign * val})
                pos += 3
            else:
                out = out + _Lin(const=sign * val)
                pos += 1
        elif re.match(r"[A-Za-z_]", tok):
            out = out + _Lin({tok: sign})
            pos += 1
        else:
            raise FislError(f"unexpected token {tok!r}")
        if pos < len(tokens) and tokens[pos] in ("+", "-"):
            sign = 1 if tokens[pos] == "+" else -1
            pos += 1
        else:
            return out, pos


class _Constraint:
    """lhs OP 0 with OP in {'==', '<='}  (lhs is a _Lin)."""

    __slots__ = ("lin", "eq")

    def __init__(self, lin: _Lin, eq: bool):
        self.lin = lin
        self.eq = eq

    def vars(self) -> set:
        return self.lin.vars()


def _parse_constraints(src: str) -> List[_Constraint]:
    out: List[_Constraint] = []
    for part in src.split(" and "):
        part = part.strip()
        if not part:
            continue
        tokens = _TOKEN.findall(part)
        exprs: List[_Lin] = []
        ops: List[str] = []
        pos = 0
        while True:
            e, pos = _parse_expr(tokens, pos)
            exprs.append(e)
            if pos >= len(tokens):
                break
            op = tokens[pos]
            if op not in ("<=", "<", ">=", ">", "=", "=="):
                raise FislError(f"unexpected operator {op!r} in {part!r}")
            ops.append(op)
            pos += 1
        for (l, op, r) in zip(exprs, ops, exprs[1:]):
            if op in ("=", "=="):
                out.append(_Constraint(l - r, eq=True))
            elif op == "<=":
                out.append(_Constraint(l - r, eq=False))
            elif op == "<":
                out.append(_Constraint((l - r) + _Lin(const=1), eq=False))
            elif op == ">=":
                out.append(_Constraint(r - l, eq=False))
            else:  # '>'
                out.append(_Constraint((r - l) + _Lin(const=1), eq=False))
    return out


_REL = re.compile(
    r"^\s*\{\s*(?P<in>[A-Za-z_]\w*\s*\[[^\]]*\])\s*"
    r"(->\s*(?P<out>[A-Za-z_]\w*\s*\[[^\]]*\])\s*)?"
    r"(:\s*(?P<cons>.*?))?\s*\}\s*$", re.S)


def _parse_tuple(s: str) -> Tuple[str, List[str]]:
    name, rest = s.split("[", 1)
    body = rest.rsplit("]", 1)[0].strip()
    dims = [d.strip() for d in body.split(",")] if body else []
    return name.strip(), dims


# -------------------------------------------------------------- enumeration
def _propagate_intervals(vars_: List[str], cons: List[_Constraint]):
    """Interval propagation to finite [lo, hi] bounds for every variable."""
    NEG, POS = -(1 << 60), (1 << 60)
    lo = {v: NEG for v in vars_}
    hi = {v: POS for v in vars_}
    for _ in range(_MAX_PROPAGATE):
        changed = False
        for c in cons:
            for v, a in c.lin.coeffs.items():
                if a == 0:
                    continue
                # a*v + rest OP 0 ; bound rest over current intervals
                r_lo = c.lin.const
                r_hi = c.lin.const
                unbounded = False
                for u, b in c.lin.coeffs.items():
                    if u == v or b == 0:
                        continue
                    cand = sorted((b * lo[u], b * hi[u]))
                    if lo[u] <= NEG or hi[u] >= POS:
                        unbounded = True
                        break
                    r_lo += cand[0]
                    r_hi += cand[1]
                if unbounded:
                    continue
                # a*v <= -rest  (for '<='); equality adds both directions
                if a > 0:
                    new_hi = (-r_lo) // a
                    if new_hi < hi[v]:
                        hi[v] = new_hi
                        changed = True
                    if c.eq:
                        new_lo = -(-(-r_hi) // a)  # ceil(-r_hi / a)
                        if new_lo > lo[v]:
                            lo[v] = new_lo
                            changed = True
                else:
                    # a<0: a*v + rest <= 0  =>  v >= ceil(rest / -a);
                    # the loosest bound over rest in [r_lo, r_hi] is at r_lo.
                    new_lo = -(-r_lo // (-a))
                    if new_lo > lo[v]:
                        lo[v] = new_lo
                        changed = True
                    if c.eq:
                        new_hi = r_hi // (-a)
                        if new_hi < hi[v]:
                            hi[v] = new_hi
                            changed = True
        if not changed:
            break
    for v in vars_:
        if lo[v] <= NEG or hi[v] >= POS:
            raise FislError(f"variable {v} is unbounded in relation")
    return lo, hi


def _enumerate_points(vars_: List[str], cons: List[_Constraint]) -> np.ndarray:
    """All integer points satisfying the conjunction, (N, len(vars_)) lex-sorted."""
    if not vars_:
        return np.zeros((1, 0), np.int64)
    lo, hi = _propagate_intervals(vars_, cons)
    cols: Dict[str, np.ndarray] = {}
    n_rows = 1
    assigned: List[str] = []
    remaining = list(cons)
    for v in vars_:
        usable = [c for c in remaining
                  if v in c.vars() and c.vars() <= set(assigned) | {v}]
        vlo = np.full(n_rows, lo[v], np.int64)
        vhi = np.full(n_rows, hi[v], np.int64)
        for c in usable:
            a = c.lin.coeffs[v]
            rest = np.full(n_rows, c.lin.const, np.int64)
            for u, b in c.lin.coeffs.items():
                if u != v and b:
                    rest = rest + b * cols[u]
            if c.eq:
                q, r = np.divmod(-rest, a)
                ok = r == 0
                vlo = np.maximum(vlo, np.where(ok, q, 1))
                vhi = np.minimum(vhi, np.where(ok, q, 0))
            elif a > 0:  # a*v + rest <= 0  ->  v <= floor(-rest/a)
                vhi = np.minimum(vhi, np.floor_divide(-rest, a))
            else:        # a<0: v >= ceil(rest / -a)
                vlo = np.maximum(vlo, np.floor_divide(rest + (-a) - 1, -a))
        lens = np.maximum(vhi - vlo + 1, 0)
        total = int(lens.sum())
        idx = np.repeat(np.arange(n_rows), lens)
        starts = np.concatenate(([0], np.cumsum(lens)[:-1]))
        offs = np.arange(total) - np.repeat(starts, lens)
        vcol = vlo[idx] + offs
        cols = {u: col[idx] for u, col in cols.items()}
        cols[v] = vcol
        n_rows = total
        assigned.append(v)
        remaining = [c for c in remaining if c not in usable]
        if n_rows == 0:
            break
    if remaining and n_rows:
        mask = np.ones(n_rows, bool)
        for c in remaining:
            val = np.full(n_rows, c.lin.const, np.int64)
            for u, b in c.lin.coeffs.items():
                if b:
                    val = val + b * cols[u]
            mask &= (val == 0) if c.eq else (val <= 0)
        cols = {u: col[mask] for u, col in cols.items()}
        n_rows = int(mask.sum())
    pts = (np.stack([cols[v] for v in vars_], axis=1)
           if n_rows else np.zeros((0, len(vars_)), np.int64))
    if len(pts):
        order = np.lexsort(tuple(pts[:, d] for d in range(pts.shape[1] - 1, -1, -1)))
        pts = pts[order]
    return pts.astype(np.int64)


def _lex_unique_rows(a: np.ndarray) -> np.ndarray:
    if not len(a):
        return a
    return np.unique(a, axis=0)


# ------------------------------------------------------------------ objects
class Set:
    """Finite integer set; drop-in for the isl.Set subset we use."""

    def __init__(self, src=None, *, _pts: Optional[np.ndarray] = None,
                 _name: str = "S", _dims: Optional[List[str]] = None):
        if src is not None:
            m = _REL.match(src)
            if not m or m.group("out"):
                raise FislError(f"bad set syntax: {src!r}")
            name, dims = _parse_tuple(m.group("in"))
            cons = _parse_constraints(m.group("cons") or "")
            self.name, self.dims = name, dims
            self.pts = _enumerate_points(dims, cons)
        else:
            self.name = _name
            self.dims = _dims if _dims is not None else []
            self.pts = _pts if _pts is not None else np.zeros((0, 0), np.int64)

    # introspection
    def _points(self) -> List[Point]:
        return [tuple(int(x) for x in row) for row in self.pts]

    def dim(self, dt) -> int:
        return self.pts.shape[1]

    def is_empty(self) -> bool:
        return len(self.pts) == 0

    def foreach_point(self, fn) -> None:
        for row in self.pts:
            fn(tuple(int(x) for x in row))

    def lexmin(self) -> "Set":
        pts = self.pts[:1] if len(self.pts) else self.pts
        return Set(_pts=pts, _name=self.name, _dims=self.dims)

    def lexmax(self) -> "Set":
        pts = self.pts[-1:] if len(self.pts) else self.pts
        return Set(_pts=pts, _name=self.name, _dims=self.dims)

    def sample_point(self) -> Point:
        if self.is_empty():
            raise FislError("sample_point on empty set")
        return tuple(int(x) for x in self.pts[0])

    def union(self, other: "Set") -> "Set":
        pts = _lex_unique_rows(np.concatenate([self.pts, other.pts]))
        return Set(_pts=pts, _name=self.name, _dims=self.dims)

    def _membership(self, other: "Set") -> np.ndarray:
        """Boolean mask over ``self.pts``: which rows also appear in ``other``.

        Both point lists are lex-sorted, so membership is a searchsorted on
        the flattened mixed-radix row keys — no Python-level set of tuples.
        """
        if not len(self.pts) or not len(other.pts):
            return np.zeros(len(self.pts), bool)
        assert self.pts.shape[1] == other.pts.shape[1], "dim mismatch"
        both = np.concatenate([self.pts, other.pts])
        lo = both.min(axis=0)
        span = (both.max(axis=0) - lo + 1).astype(np.int64)
        radix = np.ones(both.shape[1], np.int64)
        for d in range(both.shape[1] - 2, -1, -1):
            radix[d] = radix[d + 1] * span[d + 1]
        mine = (self.pts - lo) @ radix
        theirs = np.sort((other.pts - lo) @ radix)
        pos = np.searchsorted(theirs, mine)
        pos = np.minimum(pos, len(theirs) - 1)
        return theirs[pos] == mine

    def subtract(self, other: "Set") -> "Set":
        """Points of ``self`` not in ``other`` (isl.Set.subtract)."""
        keep = ~self._membership(other)
        return Set(_pts=self.pts[keep], _name=self.name, _dims=self.dims)

    def intersect(self, other: "Set") -> "Set":
        """Points common to both sets (isl.Set.intersect)."""
        keep = self._membership(other)
        return Set(_pts=self.pts[keep], _name=self.name, _dims=self.dims)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"fisl.Set({self.name}, {len(self.pts)} pts, dim={self.dim(None)})"


class Map:
    """Finite integer relation; drop-in for the isl.Map subset we use."""

    def __init__(self, src=None, *, _pts: Optional[np.ndarray] = None,
                 _nin: int = 0, _in_name: str = "I", _out_name: str = "O",
                 _in_dims: Optional[List[str]] = None,
                 _out_dims: Optional[List[str]] = None):
        if src is not None:
            m = _REL.match(src)
            if not m or not m.group("out"):
                raise FislError(f"bad map syntax: {src!r}")
            self.in_name, self.in_dims = _parse_tuple(m.group("in"))
            self.out_name, self.out_dims = _parse_tuple(m.group("out"))
            cons = _parse_constraints(m.group("cons") or "")
            dup = set(self.in_dims) & set(self.out_dims)
            if dup:
                raise FislError(f"shared dim names not supported: {dup}")
            self.pts = _enumerate_points(self.in_dims + self.out_dims, cons)
        else:
            self.in_name, self.out_name = _in_name, _out_name
            self.in_dims = _in_dims if _in_dims is not None else []
            self.out_dims = _out_dims if _out_dims is not None else []
            self.pts = _pts if _pts is not None else np.zeros((0, _nin), np.int64)
        self.nin = len(self.in_dims)
        self.nout = self.pts.shape[1] - self.nin

    @classmethod
    def from_points(cls, pts: np.ndarray, nin: int,
                    in_name: str = "I", out_name: str = "O") -> "Map":
        pts = np.asarray(pts, np.int64).reshape(len(pts), -1)
        if len(pts):
            order = np.lexsort(tuple(pts[:, d]
                                     for d in range(pts.shape[1] - 1, -1, -1)))
            pts = pts[order]
        in_dims = [f"i{k}" for k in range(nin)]
        out_dims = [f"o{k}" for k in range(pts.shape[1] - nin)]
        return cls(_pts=pts, _in_name=in_name, _out_name=out_name,
                   _in_dims=in_dims, _out_dims=out_dims)

    @classmethod
    def empty(cls, space) -> "Map":
        nin, nout = space
        m = cls(_pts=np.zeros((0, nin + nout), np.int64),
                _in_dims=[f"i{k}" for k in range(nin)],
                _out_dims=[f"o{k}" for k in range(nout)])
        return m

    def get_space(self):
        return (self.nin, self.nout)

    # introspection
    def _pairs(self) -> List[Tuple[Point, Point]]:
        n = self.nin
        return [(tuple(int(x) for x in row[:n]), tuple(int(x) for x in row[n:]))
                for row in self.pts]

    def dim(self, dt) -> int:
        if dt == dim_type.in_:
            return self.nin
        if dt == dim_type.out:
            return self.nout
        return self.pts.shape[1]

    def is_empty(self) -> bool:
        return len(self.pts) == 0

    def domain(self) -> Set:
        return Set(_pts=_lex_unique_rows(self.pts[:, :self.nin]),
                   _name=self.in_name, _dims=list(self.in_dims))

    def range(self) -> Set:
        return Set(_pts=_lex_unique_rows(self.pts[:, self.nin:]),
                   _name=self.out_name, _dims=list(self.out_dims))

    def reverse(self) -> "Map":
        pts = np.concatenate([self.pts[:, self.nin:], self.pts[:, :self.nin]],
                             axis=1)
        m = Map.from_points(pts, self.nout, self.out_name, self.in_name)
        return m

    def wrap(self) -> Set:
        return Set(_pts=self.pts, _name=self.in_name,
                   _dims=list(self.in_dims) + list(self.out_dims))

    def union(self, other: "Map") -> "Map":
        assert self.nin == other.nin and self.nout == other.nout
        pts = _lex_unique_rows(np.concatenate([self.pts, other.pts]))
        return Map.from_points(pts, self.nin, self.in_name, self.out_name)

    def is_single_valued(self) -> bool:
        seen: Dict[Point, Point] = {}
        for i, o in self._pairs():
            if i in seen and seen[i] != o:
                return False
            seen[i] = o
        return True

    def lexmax(self) -> "Map":
        """Per input, keep only the lexicographically maximal output."""
        if not len(self.pts):
            return self
        keep: Dict[Point, Point] = {}
        for i, o in self._pairs():
            if i not in keep or o > keep[i]:
                keep[i] = o
        pts = np.array([list(i) + list(o) for i, o in keep.items()], np.int64)
        return Map.from_points(pts, self.nin, self.in_name, self.out_name)

    def apply_range(self, other: "Map") -> "Map":
        """self: A -> B composed with other: B -> C, giving A -> C."""
        assert self.nout == other.nin
        by_b: Dict[Point, List[Point]] = {}
        for b, c in other._pairs():
            by_b.setdefault(b, []).append(c)
        rows: List[List[int]] = []
        for a, b in self._pairs():
            for c in by_b.get(b, ()):
                rows.append(list(a) + list(c))
        pts = (np.array(rows, np.int64) if rows
               else np.zeros((0, self.nin + other.nout), np.int64))
        return Map.from_points(_lex_unique_rows(pts), self.nin,
                               self.in_name, other.out_name)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"fisl.Map({self.in_name}[{self.nin}] -> "
                f"{self.out_name}[{self.nout}], {len(self.pts)} pts)")
