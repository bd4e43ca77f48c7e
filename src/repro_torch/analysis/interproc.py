"""Bounded interprocedural summaries over a `ProjectIndex`, with the
port's facts.

Port of `repro/analysis/interproc.py`.  Each summary answers one
question about a function with at most TWO levels of callee inlining
(`depth=2`): may it raise on the serving path, does it contain a
reduction over a mesh axis / a product, does it launch a CUDA kernel.
The two-level bound keeps the analysis linear and the answers local
enough to explain in a finding message; anything the bound or the
resolver cannot see resolves to "unknown", and every client rule treats
unknown as "do not flag" — the engine adds reach, never guesses.

The port's facts, in place of the reference's jit/psum/matmul ones:
  * may-raise dispatch calls (RPL008): `_run_step` (the ASR engine's
    step), `LM.decode_step`, `LM.prefill`, a kernel wrapper's launch
    (`_build.lib().<entry>(...)`), the fault injector's `check`;
  * reduction tails (RPL006, the reference's `PSUM_TAILS`):
    `MeshAxis.all_reduce`, `launch.mesh.reduce_from`, `all_reduce_max`;
  * product tails (the reference's `MATMUL_TAILS`): `torch.matmul`,
    `@`, `F.linear`, `torch.einsum`, `layers.linear_row`,
    `ops.int8_matmul*`;
  * shard-local sources: `sharding.local_block` and
    `ops.shard_local_cols` (a rank's block of a split contraction).

`axis_values` resolves an axis-name expression (the argument of
`mesh.axis(...)`) to the set of string constants it can take (through
locals, IfExp arms, `self.X` assignments anywhere in the class, module
constants, and — one level deep — the arguments callers pass for a
parameter), returning `(values, complete)`.  `complete=False` means
some path was opaque and the caller must not flag.
"""
from __future__ import annotations

import ast
from dataclasses import dataclass
from typing import Dict, List, Optional, Set, Tuple

from repro_torch.analysis.callgraph import (FunctionInfo, ProjectIndex,
                                      is_abstract)

# MeshAxis collectives and launch.mesh's differentiable ones
COLLECTIVE_TAILS = {
    "all_reduce", "all_reduce_max", "all_gather", "all_to_all",
    "ring_shift", "broadcast_object", "reduce_from", "copy_to",
    "gather_from", "gather_sum", "split_to",
}
REDUCTION_TAILS = {"all_reduce", "reduce_from", "all_reduce_max"}
PRODUCT_TAILS = {"matmul", "linear", "einsum", "linear_row", "mm", "bmm",
                 "int8_matmul", "int8_matmul_fused",
                 "int8_matmul_prepared"}
SHARD_LOCAL_TAILS = {"local_block", "shard_local_cols"}
# the port's dispatch calls that may raise on the serving path
DISPATCH_TAILS = {"_run_step", "decode_step", "prefill"}

SUMMARY_DEPTH = 2


def _tail(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return None


def _receiver_mentions(node: ast.AST, needle: str) -> bool:
    """True if any attribute segment (or the root name) on the
    receiver chain contains `needle` — e.g. `self._faults.check`."""
    cur = node
    while isinstance(cur, ast.Attribute):
        if needle in cur.attr:
            return True
        cur = cur.value
    return isinstance(cur, ast.Name) and needle in cur.id


def launches_kernel(call: ast.Call) -> bool:
    """`call` is a kernel launch through the port's library:
    `_build.lib().<entry>(...)`."""
    f = call.func
    return (isinstance(f, ast.Attribute) and isinstance(f.value, ast.Call)
            and _tail(f.value.func) == "lib")


@dataclass(eq=False)
class Collective:
    kind: str
    call: ast.Call
    axis: Optional[ast.expr]      # the axis-name expression, if present


@dataclass(eq=False)
class MayRaise:
    reason: str
    line: int                     # line of the hazard (in `where` file)
    where: str                    # rel path of the hazard site


class Summaries:
    def __init__(self, index: ProjectIndex):
        self.index = index
        self._may_raise: Dict[FunctionInfo, Dict[int, object]] = {}
        self._collectives: Dict[FunctionInfo, List[Collective]] = {}
        self._flags: Dict[Tuple[str, int, int], bool] = {}
        self._in_progress: Set[Tuple[str, int]] = set()

    # ---- collectives -------------------------------------------------
    def collectives(self, fi: FunctionInfo) -> List[Collective]:
        """Mesh collectives `fi` issues: a method of a `MeshAxis`
        (`ax.all_reduce(t)`) or a differentiable collective
        (`reduce_from(t, ax)`); `axis` is the axis expression."""
        if fi not in self._collectives:
            out = []
            for call in self.index.calls_of(fi):
                kind = _tail(call.func)
                if kind not in COLLECTIVE_TAILS:
                    continue
                axis = None
                if kind in ("reduce_from", "copy_to", "gather_from",
                            "gather_sum", "split_to"):
                    if len(call.args) > 1:
                        axis = call.args[1]
                elif isinstance(call.func, ast.Attribute):
                    axis = call.func.value
                out.append(Collective(kind, call, axis))
            self._collectives[fi] = out
        return self._collectives[fi]

    def _has(self, what: str, fi: FunctionInfo, depth: int) -> bool:
        key = (what, id(fi), depth)
        if key in self._flags:
            return self._flags[key]
        tag = (what, id(fi))
        if tag in self._in_progress:
            return False
        self._in_progress.add(tag)
        try:
            hit = False
            if what == "reduction":
                hit = any(c.kind in REDUCTION_TAILS
                          for c in self.collectives(fi))
            elif what == "product":
                hit = any(
                    (isinstance(n, ast.BinOp)
                     and isinstance(n.op, ast.MatMult))
                    or (isinstance(n, ast.Call)
                        and _tail(n.func) in PRODUCT_TAILS)
                    for n in self.index.owned(fi))
            if not hit and depth > 0:
                hit = any(self._has(what, callee, depth - 1)
                          for _, callee in self.index.callees(fi)
                          if callee is not fi)
            self._flags[key] = hit
            return hit
        finally:
            self._in_progress.discard(tag)

    def contains_reduction(self, fi, depth: int = SUMMARY_DEPTH) -> bool:
        return self._has("reduction", fi, depth)

    def contains_product(self, fi, depth: int = SUMMARY_DEPTH) -> bool:
        return self._has("product", fi, depth)

    def is_shard_local(self, fi: FunctionInfo) -> bool:
        """`fi` is a shard-local source by name: `local_block` (a rank's
        block of each split dimension) or `shard_local_cols`."""
        return fi.name in SHARD_LOCAL_TAILS

    # ---- may-raise ---------------------------------------------------
    def may_raise(self, fi: FunctionInfo,
                  depth: int = SUMMARY_DEPTH) -> Optional[MayRaise]:
        cache = self._may_raise.setdefault(fi, {})
        if depth in cache:
            return cache[depth]            # type: ignore[return-value]
        tag = ("raise", id(fi))
        if tag in self._in_progress:
            return None
        self._in_progress.add(tag)
        try:
            result = self._may_raise_uncached(fi, depth)
            cache[depth] = result
            return result
        finally:
            self._in_progress.discard(tag)

    def _may_raise_uncached(self, fi, depth) -> Optional[MayRaise]:
        if is_abstract(fi.node):
            return None
        esc = _escaping_raise(fi.node.body)
        if esc is not None:
            return MayRaise(f"raises at {fi.mod.rel}:{esc.lineno}",
                            esc.lineno, fi.mod.rel)
        for call in self.index.calls_of(fi):
            hazard = self.call_hazard(call)
            if hazard is not None:
                return MayRaise(
                    f"{hazard} at {fi.mod.rel}:{call.lineno}",
                    call.lineno, fi.mod.rel)
        if depth > 0:
            for call, callee in self.index.callees(fi):
                if callee is fi:
                    continue
                sub = self.may_raise(callee, depth - 1)
                if sub is not None:
                    return MayRaise(
                        f"calls {callee.name}() which {sub.reason}",
                        sub.line, sub.where)
        return None

    @staticmethod
    def call_hazard(call: ast.Call) -> Optional[str]:
        """Syntactic may-raise hazards: dispatching a step
        (`self._run_step`, `lm.decode_step`, `lm.prefill`), launching a
        CUDA kernel (`_build.lib().<entry>(...)`) or probing the fault
        injector (`self._faults.check`)."""
        tail = _tail(call.func)
        if tail in DISPATCH_TAILS:
            return f"dispatches {tail}()"
        if launches_kernel(call):
            return f"launches the CUDA kernel {tail}"
        if tail == "check" and isinstance(call.func, ast.Attribute) and \
                _receiver_mentions(call.func.value, "fault"):
            return "probes the fault injector"
        return None

    # ---- axis-name value resolution ----------------------------------
    def axis_values(self, expr: Optional[ast.expr],
                    fi: Optional[FunctionInfo],
                    depth: int = SUMMARY_DEPTH,
                    _seen: Optional[Set] = None) -> \
            Tuple[Set[str], bool]:
        """(possible string values, complete).  `None` constants are
        dropped but stay complete (an IfExp arm disabling the collective
        axis is fine); any unresolvable path flips complete to False."""
        if _seen is None:
            _seen = set()
        if expr is None:
            return set(), True
        if isinstance(expr, ast.Constant):
            if isinstance(expr.value, str):
                return {expr.value}, True
            if expr.value is None:
                return set(), True
            return set(), False
        if isinstance(expr, (ast.Tuple, ast.List, ast.Set)):
            return self._union(expr.elts, fi, depth, _seen)
        if isinstance(expr, ast.IfExp):
            return self._union([expr.body, expr.orelse], fi, depth,
                               _seen)
        if isinstance(expr, ast.BoolOp):
            return self._union(expr.values, fi, depth, _seen)
        if isinstance(expr, ast.Name):
            return self._name_values(expr.id, fi, depth, _seen)
        if isinstance(expr, ast.Attribute) and \
                isinstance(expr.value, ast.Name) and \
                expr.value.id == "self" and fi is not None and \
                fi.cls is not None:
            return self._self_attr_values(expr.attr, fi, depth, _seen)
        return set(), False

    def _union(self, exprs, fi, depth, _seen):
        vals: Set[str] = set()
        complete = True
        for e in exprs:
            v, c = self.axis_values(e, fi, depth, _seen)
            vals |= v
            complete = complete and c
        return vals, complete

    def _name_values(self, name, fi, depth, _seen):
        f = fi
        while f is not None:
            key = ("name", id(f), name)
            if key in _seen:
                return set(), False
            if name in self.index.param_names(f):
                _seen.add(key)
                return self._param_values(f, name, depth, _seen)
            rhss = self.index.local_assignments(f, name)
            if rhss:
                _seen.add(key)
                return self._union(rhss, f, depth, _seen)
            f = f.parent
        if fi is not None:
            rhss = self.index.module_assignments(fi.mod, name)
            if rhss:
                return self._union(rhss, None, depth, _seen)
        return set(), False

    def _self_attr_values(self, attr, fi, depth, _seen):
        key = ("attr", fi.cls, attr)
        if key in _seen:
            return set(), False
        _seen.add(key)
        cls = self.index.classes.get(fi.cls)
        if cls is None:
            return set(), False
        rhss = []
        for c in self.index._ancestry(fi.cls):
            for m in c.methods.values():
                for n in self.index.owned(m):
                    if isinstance(n, ast.Assign):
                        for t in n.targets:
                            if isinstance(t, ast.Attribute) and \
                                    t.attr == attr and \
                                    isinstance(t.value, ast.Name) and \
                                    t.value.id == "self":
                                rhss.append((n.value, m))
        if not rhss:
            return set(), False
        vals: Set[str] = set()
        complete = True
        for rhs, owner in rhss:
            v, c = self.axis_values(rhs, owner, depth, _seen)
            vals |= v
            complete = complete and c
        return vals, complete

    def _param_values(self, f, name, depth, _seen):
        """Union of the argument expressions callers pass for
        parameter `name` of `f` (one level; bounded by `depth`)."""
        if depth <= 0:
            return set(), False
        default = _param_default(f.node, name)
        sites = self.index.callers_of(f)
        if not sites:
            if default is not None:
                return self.axis_values(default, f.parent, depth - 1,
                                        _seen)
            return set(), False
        vals: Set[str] = set()
        complete = True
        for caller, call in sites:
            arg = _bind_arg(f, call, name)
            if arg is _MISSING:
                if default is not None:
                    v, c = self.axis_values(default, f.parent,
                                            depth - 1, _seen)
                    vals |= v
                    complete = complete and c
                else:
                    complete = False
                continue
            if arg is _OPAQUE:
                complete = False
                continue
            v, c = self.axis_values(arg, caller, depth - 1, _seen)
            vals |= v
            complete = complete and c
        return vals, complete


_MISSING = object()
_OPAQUE = object()


def _param_default(node, name) -> Optional[ast.expr]:
    a = node.args
    pos = [*a.posonlyargs, *a.args]
    n_def = len(a.defaults)
    for i, p in enumerate(pos):
        if p.arg == name:
            j = i - (len(pos) - n_def)
            return a.defaults[j] if j >= 0 else None
    for p, d in zip(a.kwonlyargs, a.kw_defaults):
        if p.arg == name:
            return d
    return None


def _bind_arg(f: FunctionInfo, call: ast.Call, name: str):
    """The expression `call` passes for `f`'s parameter `name`.
    Bound-method calls (`obj.m(...)`) skip the `self` slot."""
    for kw in call.keywords:
        if kw.arg == name:
            return kw.value
        if kw.arg is None:                 # **kwargs at the site
            return _OPAQUE
    if any(isinstance(a, ast.Starred) for a in call.args):
        return _OPAQUE
    a = f.node.args
    pos = [p.arg for p in (*a.posonlyargs, *a.args)]
    offset = 0
    if f.cls is not None and pos and pos[0] in ("self", "cls") and \
            isinstance(call.func, ast.Attribute):
        offset = 1
    try:
        idx = pos.index(name) - offset
    except ValueError:
        return _MISSING
    if 0 <= idx < len(call.args):
        return call.args[idx]
    return _MISSING


def _escaping_raise(body) -> Optional[ast.Raise]:
    """First `raise` that can escape the function: raises inside a
    `try` that has except-handlers are treated as caught (precision
    over recall); raises inside handler bodies do escape."""
    for st in body:
        if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef,
                           ast.ClassDef)):
            continue
        if isinstance(st, ast.Raise):
            return st
        if isinstance(st, ast.Try):
            if not st.handlers:
                hit = _escaping_raise(st.body)
                if hit is not None:
                    return hit
            for h in st.handlers:
                hit = _escaping_raise(h.body)
                if hit is not None:
                    return hit
            for blk in (st.orelse, st.finalbody):
                hit = _escaping_raise(blk)
                if hit is not None:
                    return hit
        else:
            for blk_name in ("body", "orelse", "finalbody"):
                blk = getattr(st, blk_name, None)
                if blk:
                    hit = _escaping_raise(blk)
                    if hit is not None:
                        return hit
    return None

