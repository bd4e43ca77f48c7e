"""The port's repro-lint rules (see repro_torch.analysis.__doc__ for the
codes).

Port of `repro/analysis/rules.py`: the same eight codes, each reading
the port's idioms.  RPL003/004/005 are call-graph-LOCAL: they resolve
names within one module (plus the `@worker_only` decorators gathered
across files).  RPL001/002/006/007/008 run over the whole-project symbol
table + call graph in `analysis/callgraph.py` with the bounded
two-level summaries in `analysis/interproc.py` (may-raise, reductions,
products, axis-name value sets); RPL002/007 also read the kernel
registry literal in kernels/policy.py, `_build.SIGNATURES` and the
registry-named sources and tests.  The bound is the contract: anything
the inlining cannot resolve is "unknown" and unknown is never flagged.
Contracts that still need runtime observation keep their guard in
`repro_torch.analysis.guards`.
"""
from __future__ import annotations

import ast
import pathlib
from typing import Dict, List, Optional, Set, Tuple

from repro_torch.analysis.core import (Context, Finding, ParsedModule,
                                       parse_file)


def _attr_tail(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return None


def _attr_root(node: ast.AST) -> Optional[str]:
    while isinstance(node, ast.Attribute):
        node = node.value
    return node.id if isinstance(node, ast.Name) else None


def _const_strs(node: ast.AST) -> List[str]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return [node.value]
    if isinstance(node, (ast.Tuple, ast.List, ast.Set)):
        return [s for elt in node.elts for s in _const_strs(elt)]
    return []


def _torch_call(call: ast.Call) -> bool:
    """`torch.X(...)` / `torch.nn.functional.X(...)` / `F.X(...)`."""
    return isinstance(call.func, ast.Attribute) and \
        _attr_root(call.func) in ("torch", "F")


class _NameScope:
    """Flow-ordered name -> fact map shared by the per-function walks."""

    def __init__(self, facts=None):
        self.facts = dict(facts or {})

    def assign_target(self, target: ast.AST, value) -> None:
        if isinstance(target, ast.Name):
            if value:
                self.facts[target.id] = value
            else:
                self.facts.pop(target.id, None)
        elif isinstance(target, (ast.Tuple, ast.List)):
            for elt in target.elts:
                self.assign_target(elt, value)
        elif isinstance(target, ast.Starred):
            self.assign_target(target.value, value)


# ---------------------------------------------------------------------------
# RPL001 — host reads in a guarded step (interprocedural)
# ---------------------------------------------------------------------------

# attribute reads and methods that yield host values without a read of the
# tensor's data
_SHAPE_ATTRS = {"shape", "ndim", "dtype", "device", "is_cuda", "layout",
                "requires_grad", "is_leaf", "grad_fn", "names", "T", "mT"}
_SHAPE_METHODS = {"dim", "size", "numel", "nelement", "element_size",
                  "stride", "storage_offset", "is_contiguous", "data_ptr",
                  "is_pinned", "get_device", "is_floating_point",
                  "is_complex"}
# reductions: with no dim a 0-d tensor
_REDUCTIONS = {"sum", "mean", "max", "min", "amax", "amin", "argmax",
               "argmin", "prod", "all", "any", "norm", "std", "var",
               "median"}
# keep a 0-d operand 0-d
_ELEMENTWISE = {"long", "int", "float", "double", "half", "bfloat16", "to",
                "clone", "detach", "contiguous", "abs", "neg", "clamp",
                "clamp_min", "clamp_max", "remainder", "fmod", "minimum",
                "maximum", "where", "sqrt", "exp", "log"}
# constructors: 0-d with an empty shape
_CTORS = {"full", "zeros", "ones", "empty"}
# ops sized by their data: the host reads the size back
_SIZED_BY_DATA = {"nonzero", "bincount", "unique", "unique_consecutive",
                  "masked_select", "argwhere"}
_READBACKS = {"item": "`.item()`", "tolist": "`.tolist()`",
              "cpu": "`.cpu()`", "numpy": "`.numpy()`"}
_GUARD = "no_implicit_transfers"
_GUARD_DEPTH = 2            # callee levels walked from a guarded block

NOT_TENSOR, TENSOR, SCALAR = 0, 1, 2


def _ctor_kind(node: ast.AST) -> int:
    """Context-free kind of a constructor call: SCALAR for a 0-d one
    (`torch.full((), v)`, `torch.zeros(())`, `torch.tensor(3)`,
    `torch.scalar_tensor(v)`), TENSOR for one with a shape, else
    NOT_TENSOR (not a constructor: unknown)."""
    if not (isinstance(node, ast.Call) and _torch_call(node)):
        return NOT_TENSOR
    tail = _attr_tail(node.func)
    if tail == "scalar_tensor":
        return SCALAR
    if tail == "tensor" and node.args:
        a = node.args[0]
        if isinstance(a, (ast.List, ast.Tuple, ast.ListComp)):
            return TENSOR
        return SCALAR if isinstance(a, (ast.Constant, ast.UnaryOp)) \
            else NOT_TENSOR
    if tail in _CTORS and node.args:
        shape = node.args[0]
        if isinstance(shape, ast.Tuple) and not shape.elts:
            return SCALAR
        return TENSOR
    if tail in ("arange", "randn", "rand", "randint", "empty_like",
                "zeros_like", "ones_like", "full_like"):
        return TENSOR
    return NOT_TENSOR


def _scalar_keys(mod: ParsedModule) -> Set[str]:
    """String keys that every constructor bound to them in the module
    makes 0-d (`{"offset": torch.zeros(())}`, `c["offset"] =
    torch.full((), n)`): a read of `x["offset"]` is then a 0-d tensor.
    A key also bound to a shaped constructor is not one."""
    kinds: Dict[str, Set[int]] = {}

    def put(key, value):
        k = _ctor_kind(value)
        if k != NOT_TENSOR:
            kinds.setdefault(key, set()).add(k)
    for n in ast.walk(mod.tree):
        if isinstance(n, ast.Dict):
            for k, v in zip(n.keys, n.values):
                if isinstance(k, ast.Constant) and isinstance(k.value, str):
                    put(k.value, v)
        elif isinstance(n, ast.Assign):
            for t in n.targets:
                if isinstance(t, ast.Subscript) and \
                        isinstance(t.slice, ast.Constant) and \
                        isinstance(t.slice.value, str):
                    put(t.slice.value, n.value)
    return {k for k, v in kinds.items() if v == {SCALAR}}


def _tensor_annotation(ann: Optional[ast.AST]) -> bool:
    if ann is None:
        return False
    return any(isinstance(n, (ast.Attribute, ast.Name))
               and _attr_tail(n) == "Tensor" for n in ast.walk(ann))


class _HostReads:
    """One function's walk for RPL001: the kind (NOT_TENSOR, TENSOR,
    SCALAR) of each local, flow-ordered, and the host reads of the
    statements walked while `guarded`."""

    def __init__(self, scalar_keys: Set[str], params: Dict[str, int]):
        self.scalar_keys = scalar_keys
        self.scope = _NameScope(params)
        self.hits: List[Tuple[ast.AST, str]] = []
        self.guards: List[ast.With] = []       # guarded blocks opened here

    # ---- kinds ---------------------------------------------------------
    def kind(self, node: ast.AST) -> int:          # noqa: C901 - small DFA
        if isinstance(node, ast.Name):
            return self.scope.facts.get(node.id, NOT_TENSOR)
        if isinstance(node, ast.Constant):
            return NOT_TENSOR
        if isinstance(node, ast.Attribute):
            if node.attr in _SHAPE_ATTRS:
                return NOT_TENSOR
            return TENSOR if self.kind(node.value) else NOT_TENSOR
        if isinstance(node, ast.Subscript):
            base = self.kind(node.value)
            if base:
                return base
            sl = node.slice
            if isinstance(sl, ast.Constant) and sl.value in self.scalar_keys:
                return SCALAR
            return NOT_TENSOR
        if isinstance(node, ast.Call):
            return self._call_kind(node)
        if isinstance(node, ast.BinOp):
            return self._combine([node.left, node.right])
        if isinstance(node, ast.UnaryOp):
            return self.kind(node.operand)
        if isinstance(node, ast.Compare):
            if all(isinstance(op, (ast.Is, ast.IsNot)) for op in node.ops):
                return NOT_TENSOR
            return self._combine([node.left, *node.comparators])
        if isinstance(node, ast.BoolOp):
            return max(self.kind(v) for v in node.values)
        if isinstance(node, ast.IfExp):
            return max(self.kind(node.body), self.kind(node.orelse))
        return NOT_TENSOR

    def _combine(self, nodes) -> int:
        kinds = [self.kind(n) for n in nodes]
        if TENSOR in kinds:
            return TENSOR
        return SCALAR if SCALAR in kinds else NOT_TENSOR

    def _call_kind(self, node: ast.Call) -> int:
        f = node.func
        tail = _attr_tail(f)
        ctor = _ctor_kind(node)
        if ctor:
            return ctor
        if isinstance(f, ast.Attribute) and not _torch_call(node):
            recv = self.kind(f.value)
            if not recv or tail in _SHAPE_METHODS or tail in _READBACKS:
                return NOT_TENSOR
            if tail in _REDUCTIONS and not node.args and \
                    not any(kw.arg in ("dim", "axis") for kw in node.keywords):
                return SCALAR
            if recv == SCALAR and tail in _ELEMENTWISE:
                return SCALAR
            return TENSOR
        if _torch_call(node):
            if tail in _REDUCTIONS and len(node.args) == 1 and \
                    not any(kw.arg in ("dim", "axis") for kw in node.keywords):
                return SCALAR if self.kind(node.args[0]) else NOT_TENSOR
            if tail in _ELEMENTWISE:
                kinds = {self.kind(a) for a in node.args}
                if TENSOR not in kinds and SCALAR in kinds:
                    return SCALAR
            return TENSOR
        return NOT_TENSOR

    # ---- the walk ------------------------------------------------------
    def flag(self, node: ast.AST, what: str) -> None:
        self.hits.append((node, what))

    def check_expr(self, expr: ast.AST) -> None:
        for n in ast.walk(expr):
            if isinstance(n, ast.Call):
                self._check_call(n)
            elif isinstance(n, ast.Subscript):
                sl = n.slice
                if not isinstance(sl, (ast.Tuple, ast.Slice)) and \
                        self.kind(sl) == SCALAR:
                    self.flag(n, "an index by a 0-d tensor (read back to "
                                 "the host as a Python int)")

    def _check_call(self, n: ast.Call) -> None:
        f = n.func
        tail = _attr_tail(f)
        if isinstance(f, ast.Attribute) and tail in _READBACKS and \
                not _torch_call(n) and not n.args:
            # .cpu(), .numpy() and .item() are tensor readbacks whatever
            # the receiver; .tolist() is one on a tensor
            if tail != "tolist" or self.kind(f.value):
                self.flag(n, f"{_READBACKS[tail]} on a tensor")
        elif isinstance(f, ast.Name) and tail in ("int", "float", "bool") \
                and n.args and self.kind(n.args[0]):
            self.flag(n, f"`{tail}()` of a tensor")
        if tail in _SIZED_BY_DATA and (
                _torch_call(n) or (isinstance(f, ast.Attribute)
                                   and self.kind(f.value))):
            self.flag(n, f"`{tail}` (its output is sized by the data)")
        if tail == "where" and _torch_call(n) and len(n.args) == 1 and \
                not n.keywords:
            self.flag(n, "one-argument `torch.where` (a nonzero)")

    def walk(self, stmts, guarded: bool) -> None:   # noqa: C901
        for st in stmts:
            if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef,
                               ast.ClassDef)):
                continue
            if isinstance(st, (ast.If, ast.While)):
                if guarded:
                    self.check_expr(st.test)
                    if self.kind(st.test):
                        kind = "if" if isinstance(st, ast.If) else "while"
                        self.flag(st, f"Python `{kind}` on a tensor")
                self.walk(st.body, guarded)
                self.walk(st.orelse, guarded)
            elif isinstance(st, ast.For):
                if guarded:
                    self.check_expr(st.iter)
                self.scope.assign_target(
                    st.target, TENSOR if self.kind(st.iter) else NOT_TENSOR)
                self.walk(st.body, guarded)
                self.walk(st.orelse, guarded)
            elif isinstance(st, ast.With):
                opens = any(isinstance(it.context_expr, ast.Call)
                            and _attr_tail(it.context_expr.func) == _GUARD
                            for it in st.items)
                if guarded:
                    for it in st.items:
                        self.check_expr(it.context_expr)
                if opens:
                    self.guards.append(st)
                self.walk(st.body, guarded or opens)
            elif isinstance(st, ast.Try):
                self.walk(st.body, guarded)
                for h in st.handlers:
                    self.walk(h.body, guarded)
                self.walk(st.orelse, guarded)
                self.walk(st.finalbody, guarded)
            else:
                if guarded:
                    self.check_expr(st)
                    if isinstance(st, ast.Assert) and self.kind(st.test):
                        self.flag(st, "`assert` on a tensor")
                if isinstance(st, ast.Assign):
                    value = st.value
                    for t in st.targets:
                        if isinstance(t, (ast.Tuple, ast.List)) and \
                                isinstance(value, (ast.Tuple, ast.List)) and \
                                len(t.elts) == len(value.elts):
                            for te, ve in zip(t.elts, value.elts):
                                self.scope.assign_target(te, self.kind(ve))
                        elif isinstance(t, (ast.Tuple, ast.List)):
                            self.scope.assign_target(
                                t, TENSOR if self.kind(value) else NOT_TENSOR)
                        else:
                            self.scope.assign_target(t, self.kind(value))
                elif isinstance(st, ast.AnnAssign) and st.value is not None:
                    self.scope.assign_target(st.target, self.kind(st.value))
                elif isinstance(st, ast.AugAssign):
                    k = self._combine([st.target, st.value]) \
                        if isinstance(st.target, ast.Name) else NOT_TENSOR
                    self.scope.assign_target(st.target, k)


def _param_kinds(fi, index, mods_keys, depth: int = 1) -> Dict[str, int]:
    """Each parameter's kind: TENSOR where annotated `torch.Tensor`; and,
    one level deep, the kind every resolved caller passes for it (a 0-d
    tensor parameter: SCALAR)."""
    from repro_torch.analysis.interproc import _MISSING, _OPAQUE, _bind_arg
    a = fi.node.args
    out = {p.arg: TENSOR for p in (*a.posonlyargs, *a.args, *a.kwonlyargs)
           if _tensor_annotation(p.annotation)}
    if depth <= 0:
        return out
    sites = index.callers_of(fi)
    if not sites:
        return out
    envs = {}
    for name in index.param_names(fi):
        if name in ("self", "cls"):
            continue
        kinds = []
        for caller, call in sites:
            arg = _bind_arg(fi, call, name)
            if arg is _MISSING or arg is _OPAQUE:
                kinds = []
                break
            if caller not in envs:
                ev = _HostReads(mods_keys(caller.mod),
                                _param_kinds(caller, index, mods_keys, 0))
                ev.walk(caller.node.body, False)
                envs[caller] = ev
            kinds.append(envs[caller].kind(arg))
        if kinds and all(k == SCALAR for k in kinds):
            out[name] = SCALAR
        elif kinds and all(kinds) and name not in out:
            out[name] = TENSOR
    return out


def rule_rpl001(ctx: Context) -> List[Finding]:
    index = ctx.project()
    keys_cache: Dict[str, Set[str]] = {}

    def mods_keys(mod):
        if mod.rel not in keys_cache:
            keys_cache[mod.rel] = _scalar_keys(mod)
        return keys_cache[mod.rel]

    findings: List[Finding] = []
    seen: Set[Tuple[str, int, int]] = set()

    def report(fi, ev, guard_where):
        rel, line, owner = guard_where
        for node, what in ev.hits:
            key = (fi.mod.rel, node.lineno, node.col_offset)
            if key in seen:
                continue
            seen.add(key)
            findings.append(Finding(
                fi.mod.rel, node.lineno, node.col_offset, "RPL001",
                f"{what} in `{fi.name}`, inside the host-sync guard of "
                f"`{owner}` ({rel}:{line}): the host waits on the card "
                "every step (keep the data on the device, or read it "
                "outside the guarded block)",
                related=((rel, line),)))

    # the guarded blocks, and the functions their bodies call: the roots
    roots: Dict[object, Tuple[str, int, str]] = {}
    for fi in list(index.functions.values()):
        ev = _HostReads(mods_keys(fi.mod),
                        _param_kinds(fi, index, mods_keys, 0))
        ev.walk(fi.node.body, False)
        if not ev.guards:
            continue
        for w in ev.guards:
            where = (fi.mod.rel, w.lineno, fi.name)
            report(fi, _guarded_body(fi, w, mods_keys, index), where)
            for n in (n for st in w.body for n in ast.walk(st)):
                if isinstance(n, ast.Call) and index.owner.get(n) is fi:
                    for tgt in index.resolve_callable(n.func, fi, fi.mod):
                        roots.setdefault(tgt, where)
    # their reach, two callee levels below the roots
    frontier = list(roots)
    depth = {fi: 0 for fi in roots}
    while frontier:
        fi = frontier.pop(0)
        if depth[fi] >= _GUARD_DEPTH:
            continue
        for _, tgt in index.callees(fi):
            if tgt not in depth:
                depth[tgt] = depth[fi] + 1
                roots.setdefault(tgt, roots[fi])
                frontier.append(tgt)
    for fi, where in roots.items():
        ev = _HostReads(mods_keys(fi.mod),
                        _param_kinds(fi, index, mods_keys))
        ev.walk(fi.node.body, True)
        report(fi, ev, where)
    return findings


def _guarded_body(fi, w: ast.With, mods_keys, index) -> "_HostReads":
    """The host reads written inside one guarded block itself."""
    ev = _HostReads(mods_keys(fi.mod),
                    _param_kinds(fi, index, mods_keys, 0))
    # the locals as they stand at the block: walk up to it unguarded
    body = []
    for st in fi.node.body:
        if any(n is w for n in ast.walk(st)):
            break
        body.append(st)
    ev.walk(body, False)
    ev.walk(w.body, True)
    return ev


# ---------------------------------------------------------------------------
# RPL002 — kernel contract (global rule)
# ---------------------------------------------------------------------------

_REGISTRY_KEYS = {"replaces", "entry_points", "wrapper", "counters", "entry",
                  "ref", "cost", "test", "cuda_test"}


def _load_registry(policy_mod: ParsedModule):
    for node in ast.walk(policy_mod.tree):
        if isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Name) and t.id == "KERNEL_REGISTRY":
                    try:
                        return ast.literal_eval(node.value), node.lineno
                    except ValueError:
                        return None, node.lineno
    return None, 1


def _sibling_module(ctx: Context, mod: ParsedModule,
                    stem: str) -> Optional[ParsedModule]:
    path = mod.path.parent / f"{stem}.py"
    key = str(path)
    if key in ctx.modules:
        return ctx.modules[key]
    if path.exists():
        return parse_file(path, ctx.root)
    return None


def _as_list(v) -> list:
    return list(v) if isinstance(v, (list, tuple)) else [v]


def _signature_names(build_mod: ParsedModule) -> Set[str]:
    """Keys of `_build.SIGNATURES` (a dict display of string keys)."""
    for node in build_mod.tree.body:
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "SIGNATURES"
                for t in node.targets) and isinstance(node.value, ast.Dict):
            return {k.value for k in node.value.keys
                    if isinstance(k, ast.Constant)}
    return set()


def _module_defs(mod: Optional[ParsedModule]) -> Dict[str, ast.FunctionDef]:
    if mod is None:
        return {}
    return {n.name: n for n in mod.tree.body
            if isinstance(n, ast.FunctionDef)}


def _launch_sites(fn: ast.AST) -> List[ast.Call]:
    """Kernel launches in `fn` that pass device pointers:
    `_build.lib().<entry>(... t.data_ptr() ...)`."""
    from repro_torch.analysis.interproc import launches_kernel
    return [n for n in ast.walk(fn) if isinstance(n, ast.Call)
            and launches_kernel(n)
            and any(isinstance(a, ast.Call)
                    and _attr_tail(a.func) == "data_ptr"
                    for a in ast.walk(n))]


def _fused_names(ops_mod: Optional[ParsedModule]) -> Set[str]:
    """Kernel names of the `cost.fused(name)` decorators in ops.py."""
    out = set()
    for fn in _module_defs(ops_mod).values():
        for deco in fn.decorator_list:
            if isinstance(deco, ast.Call) and \
                    _attr_tail(deco.func) == "fused":
                out |= set(_const_strs(deco.args[0])) if deco.args else set()
    return out


def _kernel_trees(ctx: Context):
    """(policy module, csrc dir) of each kernels/ package analyzed."""
    out = []
    for mod in list(ctx.modules.values()):
        if mod.path.parent.name == "kernels" and mod.path.stem == "policy" \
                and (mod.path.parent / "csrc").is_dir():
            out.append((mod, mod.path.parent / "csrc"))
    return out


def _dominated(fi, line: int, callee: str, index, depth: int = 2,
               _seen=None) -> bool:
    """A call with tail `callee` precedes line `line` in `fi`, or (up to
    `depth` levels) in every resolved caller before its call of `fi`."""
    if fi is None:
        return False
    _seen = set() if _seen is None else _seen
    if id(fi) in _seen:
        return False
    _seen.add(id(fi))
    if any(isinstance(n, ast.Call) and _attr_tail(n.func) == callee
           and n.lineno < line for n in index.owned(fi)):
        return True
    if depth <= 0:
        return False
    sites = index.callers_of(fi)
    return bool(sites) and all(
        _dominated(caller, call.lineno, callee, index, depth - 1, _seen)
        for caller, call in sites)


def rule_rpl002(ctx: Context) -> List[Finding]:    # noqa: C901
    findings: List[Finding] = []
    index = ctx.project()
    for policy, csrc in _kernel_trees(ctx):
        def at(mod, node, msg):
            findings.append(Finding(mod.rel, getattr(node, "lineno", 1),
                                    getattr(node, "col_offset", 0),
                                    "RPL002", msg))
        registry, reg_line = _load_registry(policy)
        if registry is None:
            findings.append(Finding(policy.rel, reg_line, 0, "RPL002",
                                    "KERNEL_REGISTRY missing or not a pure "
                                    "dict literal in kernels/policy.py"))
            continue
        reg = ast.parse("")
        reg.lineno, reg.col_offset = reg_line, 0
        build = _sibling_module(ctx, policy, "_build")
        signatures = _signature_names(build) if build is not None else set()
        ref_defs = _module_defs(_sibling_module(ctx, policy, "ref"))
        ops_mod = _sibling_module(ctx, policy, "ops")
        fused = _fused_names(ops_mod)
        stems = {f.stem for f in csrc.glob("*.cu")}
        for stem in sorted(stems - set(registry)):
            at(policy, reg, f"kernels/csrc/{stem}.cu has no KERNEL_REGISTRY "
                            "entry (every kernel needs its entry points, "
                            "wrapper, plain twin, cost formula and tests "
                            "registered)")
        for name in sorted(set(registry) - stems):
            at(policy, reg, f"KERNEL_REGISTRY[{name!r}] names no source: "
                            f"kernels/csrc/{name}.cu does not exist")
        for name in sorted(set(registry) & stems):
            entry = registry[name]
            missing = _REGISTRY_KEYS - set(entry)
            if missing:
                at(policy, reg, f"KERNEL_REGISTRY[{name!r}] missing keys: "
                                f"{sorted(missing)}")
                continue
            source = (csrc / f"{name}.cu").read_text()
            for ep in _as_list(entry["entry_points"]):
                if ep not in signatures:
                    at(policy, reg, f"KERNEL_REGISTRY[{name!r}] entry point "
                                    f"`{ep}` is not a key of "
                                    "_build.SIGNATURES (the loader would not "
                                    "bind it)")
                if f"{ep}(" not in source:
                    at(policy, reg, f"KERNEL_REGISTRY[{name!r}] entry point "
                                    f"`{ep}` is not defined in "
                                    f"kernels/csrc/{name}.cu")
            wrapper = _sibling_module(ctx, policy, entry["wrapper"])
            if wrapper is None:
                at(policy, reg, f"KERNEL_REGISTRY[{name!r}] wrapper "
                                f"kernels/{entry['wrapper']}.py does not "
                                "exist")
                continue
            counters = _as_list(entry["counters"])
            module_names = {t.id for n in wrapper.tree.body
                            if isinstance(n, ast.Assign)
                            for t in n.targets if isinstance(t, ast.Name)}
            for c in counters:
                if c not in module_names:
                    at(wrapper, wrapper.tree.body[0] if wrapper.tree.body
                       else reg, f"launch counter `{c}` of "
                                 f"KERNEL_REGISTRY[{name!r}] is not a "
                                 f"module-level name of {wrapper.rel}")
            wfis = [index.functions.get(f"{index.mod_name[wrapper.rel]}."
                                        f"{fn.name}")
                    for fn in _module_defs(wrapper).values()] \
                if wrapper.rel in index.mod_name else []
            launched = False
            for wfi in wfis:
                if wfi is None:
                    continue
                for call in _launch_sites(wfi.node):
                    launched = True
                    counted = any(
                        isinstance(n, ast.AugAssign)
                        and isinstance(n.target, ast.Name)
                        and n.target.id in counters
                        for n in index.owned(wfi))
                    if not counted:
                        at(wrapper, call, f"`{wfi.name}` launches "
                                          f"{_attr_tail(call.func)} without "
                                          f"counting it in {counters}")
                    if not _dominated(wfi, call.lineno, "refuse_grad", index):
                        at(wrapper, call, f"`{wfi.name}` launches "
                                          f"{_attr_tail(call.func)} with no "
                                          "_build.refuse_grad before it: a "
                                          "kernel has no backward, and a "
                                          "gradient through it would go "
                                          "missing")
            if not launched:
                at(policy, reg, f"KERNEL_REGISTRY[{name!r}] wrapper "
                                f"{wrapper.rel} launches no kernel "
                                "(`_build.lib().<entry>(...)`)")
            for ref_name in _as_list(entry["ref"]):
                if ref_name not in ref_defs:
                    at(policy, reg, f"registered plain twin `{ref_name}` of "
                                    f"KERNEL_REGISTRY[{name!r}] is not "
                                    "defined in kernels/ref.py")
            for cost in _as_list(entry["cost"]):
                if cost not in fused:
                    at(policy, reg, f"KERNEL_REGISTRY[{name!r}] cost "
                                    f"formula `{cost}`: no kernels/ops.py "
                                    f"function is decorated "
                                    f"`cost.fused({cost!r})`")
            refs = _as_list(entry["ref"]) + _as_list(entry["entry"])
            for test in _as_list(entry["test"]):
                _check_test(ctx, at, policy, reg, name, test, refs, False)
            _check_test(ctx, at, policy, reg, name, entry["cuda_test"],
                        refs, True)
    return findings


def _check_test(ctx, at, policy, reg, name, test, refs, cuda):
    kind = "cuda-marked kernel-vs-plain" if cuda else "CPU parity"
    path = ctx.root / test
    if not path.exists():
        at(policy, reg, f"registered {kind} test `{test}` of "
                        f"KERNEL_REGISTRY[{name!r}] does not exist")
        return
    text = path.read_text()
    if name not in text and not any(r in text for r in refs):
        at(policy, reg, f"{kind} test `{test}` references neither "
                        f"`{name}` nor its wrappers or plain twins")
    if cuda and "mark.cuda" not in text:
        at(policy, reg, f"{kind} test `{test}` of "
                        f"KERNEL_REGISTRY[{name!r}] carries no "
                        "`pytest.mark.cuda` marker")


# ---------------------------------------------------------------------------
# RPL003 — engine-state aliasing
# ---------------------------------------------------------------------------

# attributes holding (or caching) engine/slot state tensors — `_prepared`
# (sharded int8 weight shards) and `_slot_steps` (per-slot step counters)
_STATE_ATTRS = {"result", "_slot_bufs", "_beam", "_stream_state", "_gen",
                "_tokens", "cache", "_prepared", "_slot_steps",
                "_fault_log"}   # _fault_log: per-engine fault forensics
# engine receivers state may hang off
_ENGINE_NAMES = {"self", "eng", "engine", "sess", "session"}
# engine methods whose return values are materialized views over
# engine-owned buffers: callers must route them through copy_result
_READOUT_CALLS = {"slot_best"}
# calls that SANITIZE (deep-copy) a tainted payload
_SANITIZERS = {"copy_result", "deepcopy", "list", "jsonable", "copy"}


def _receiver_ok(node: ast.AST) -> bool:
    root = _attr_root(node)
    return root in _ENGINE_NAMES or (
        isinstance(node, ast.Attribute) and "engine" in node.attr)


class _AliasScope(_NameScope):
    def expr(self, node: ast.AST) -> bool:       # noqa: C901 - small DFA
        if isinstance(node, ast.Name):
            return node.id in self.facts
        if isinstance(node, ast.Attribute):
            if node.attr in _STATE_ATTRS and _receiver_ok(node.value):
                return True
            return self.expr(node.value)
        if isinstance(node, ast.Subscript):
            return self.expr(node.value)
        if isinstance(node, ast.Call):
            tail = _attr_tail(node.func)
            if tail in _SANITIZERS:
                return False
            if tail in _READOUT_CALLS:
                return True
            if tail == "dict":                   # shallow: aliasing survives
                return any(self.expr(a) for a in node.args) or \
                    any(self.expr(kw.value) for kw in node.keywords)
            return False
        if isinstance(node, ast.Dict):
            return any(v is not None and self.expr(v) for v in node.values)
        if isinstance(node, (ast.Tuple, ast.List)):
            return any(self.expr(e) for e in node.elts)
        if isinstance(node, ast.IfExp):
            return self.expr(node.body) or self.expr(node.orelse)
        if isinstance(node, ast.BoolOp):
            return any(self.expr(v) for v in node.values)
        return False


def rule_rpl003(mod: ParsedModule, ctx: Context) -> List[Finding]:
    findings: List[Finding] = []
    for fn in ast.walk(mod.tree):
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        scope = _AliasScope()
        for st in ast.walk(fn):
            if isinstance(st, ast.Assign):
                tainted = scope.expr(st.value)
                for t in st.targets:
                    scope.assign_target(t, tainted)
            elif isinstance(st, ast.Return) and st.value is not None:
                if scope.expr(st.value):
                    findings.append(Finding(
                        mod.rel, st.lineno, st.col_offset, "RPL003",
                        f"`{fn.name}` returns a payload aliasing engine "
                        "slot state without routing through copy_result "
                        "(caller mutation corrupts, or read-only views "
                        "escape, the engine's stored results)"))
            elif isinstance(st, ast.Call) and \
                    _attr_tail(st.func) == "set_result" and st.args and \
                    scope.expr(st.args[0]):
                findings.append(Finding(
                    mod.rel, st.lineno, st.col_offset, "RPL003",
                    "future resolved with a payload aliasing engine slot "
                    "state: route it through copy_result first"))
    return findings


# ---------------------------------------------------------------------------
# RPL004 — thread discipline
# ---------------------------------------------------------------------------

# sync functions that ALSO run on the event-loop thread (not the engine
# worker): supervisor / watchdog / health entry points, matched by name
_LOOP_SIDE_NAMES = ("supervis", "watchdog", "healthz")


def rule_rpl004(mod: ParsedModule, ctx: Context) -> List[Finding]:
    if not ctx.worker_only_names:
        return []
    findings: List[Finding] = []

    def scan(node: ast.AST, in_lambda: bool, where: str):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.Lambda):
                scan(child, True, where)
                continue
            if isinstance(child, ast.Call) and not in_lambda:
                tail = _attr_tail(child.func)
                if isinstance(child.func, ast.Attribute) and \
                        tail in ctx.worker_only_names:
                    findings.append(Finding(
                        mod.rel, child.lineno, child.col_offset, "RPL004",
                        f"@worker_only engine method `{tail}` called from "
                        f"{where}: only the engine's "
                        "EngineWorker thread may drive it — submit a "
                        "thunk via worker.call/submit instead"))
            scan(child, in_lambda, where)

    for fn in ast.walk(mod.tree):
        if isinstance(fn, ast.AsyncFunctionDef):
            scan(fn, False, "an asyncio handler")
        elif isinstance(fn, ast.FunctionDef) and \
                any(k in fn.name.lower() for k in _LOOP_SIDE_NAMES):
            scan(fn, False, f"supervisor/watchdog entry point `{fn.name}`")
    return findings


# ---------------------------------------------------------------------------
# RPL005 — RNG discipline
# ---------------------------------------------------------------------------

# sharded compute: a MeshAxis collective (or a differentiable one), a
# rank's block of a tensor, or a model drawn on its blocks
_SHARDED_TAILS = {"all_reduce", "all_reduce_max", "all_gather", "all_to_all",
                  "ring_shift", "reduce_from", "copy_to", "gather_from",
                  "gather_sum", "split_to", "local_block", "init_local"}
_DRAWS = {"rand", "randn", "randint", "randperm", "rand_like", "randn_like",
          "randint_like", "normal", "bernoulli", "multinomial", "poisson"}
_INPLACE_DRAWS = {"normal_", "uniform_", "bernoulli_", "random_",
                  "exponential_", "geometric_", "cauchy_", "log_normal_"}


def rule_rpl005(mod: ParsedModule, ctx: Context) -> List[Finding]:
    calls = [n for n in ast.walk(mod.tree) if isinstance(n, ast.Call)]
    if not any(_attr_tail(c.func) in _SHARDED_TAILS for c in calls):
        return []
    findings = []
    for c in calls:
        tail = _attr_tail(c.func)
        explicit = any(kw.arg == "generator" for kw in c.keywords)
        what = None
        if tail == "manual_seed" and isinstance(c.func, ast.Attribute) and \
                _attr_root(c.func) == "torch" and \
                isinstance(c.func.value, (ast.Name, ast.Attribute)):
            what = "`torch.manual_seed` seeds the global generator"
        elif tail in _DRAWS and _torch_call(c) and not explicit:
            what = f"`torch.{tail}` draws from the global generator"
        elif tail in _INPLACE_DRAWS and not explicit:
            what = f"`.{tail}` draws from the global generator"
        if what is not None:
            findings.append(Finding(
                mod.rel, c.lineno, c.col_offset, "RPL005",
                f"{what} in a module that runs sharded compute (MeshAxis "
                "collectives, local_block or init_local): the global "
                "generator's state differs across ranks and runs, so the "
                "ranks' draws fork — draw from an explicit "
                "torch.Generator (generator=), seeded alike on every "
                "rank"))
    return findings


# ---------------------------------------------------------------------------
# RPL006 — collective/axis discipline (interprocedural)
# ---------------------------------------------------------------------------

# mesh constructors: the position of their axis names
_MESH_MAKERS = {"make_mesh": 1, "make_dry_mesh": 1}


def _guarded_axes(fi, index) -> Set[str]:
    """Axis names `fi` checks against `mesh.axis_names` before use:
    `"model" in mesh.axis_names`, or a comprehension filtering a
    constant iterable through such a membership test."""
    guarded: Set[str] = set()
    comp_iters: Dict[str, List[ast.expr]] = {}
    for n in index.owned(fi):
        if isinstance(n, (ast.GeneratorExp, ast.ListComp, ast.SetComp)):
            for gen in n.generators:
                if isinstance(gen.target, ast.Name):
                    comp_iters.setdefault(gen.target.id, []) \
                        .append(gen.iter)
    for n in index.owned(fi):
        if not (isinstance(n, ast.Compare) and len(n.ops) == 1
                and isinstance(n.ops[0], (ast.In, ast.NotIn))):
            continue
        if not any(isinstance(a, ast.Attribute)
                   and a.attr == "axis_names"
                   for a in ast.walk(n.comparators[0])):
            continue
        guarded |= set(_const_strs(n.left))
        if isinstance(n.left, ast.Name):
            for it in comp_iters.get(n.left.id, []):
                guarded |= set(_const_strs(it))
    return guarded


def _mesh_binders(index, summ):
    """[(binder function, its make_mesh call, declared axis names, mesh
    local)] for each mesh built from literal axis names."""
    out = []
    for fi in index.functions.values():
        for call in index.calls_of(fi):
            pos = _MESH_MAKERS.get(_attr_tail(call.func))
            if pos is None:
                continue
            names = next((kw.value for kw in call.keywords
                          if kw.arg == "axis_names"),
                         call.args[pos] if len(call.args) > pos else None)
            vals, complete = summ.axis_values(names, fi)
            if not complete or not vals:
                continue
            local = None
            for n in index.owned(fi):
                if isinstance(n, ast.Assign) and n.value is call and \
                        len(n.targets) == 1 and \
                        isinstance(n.targets[0], ast.Name):
                    local = n.targets[0].id
            out.append((fi, call, vals, local))
    return out


def _rpl006_axes(index, summ) -> List[Finding]:
    """A `mesh.axis(name)` reachable from a function that built the mesh
    from literal axis names must name one of them (or check it against
    `mesh.axis_names` first)."""
    findings = []
    for binder, mcall, declared, local in _mesh_binders(index, summ):
        roots = [binder]
        if local is not None:
            for call in index.calls_of(binder):
                if any(isinstance(a, ast.Name) and a.id == local
                       for a in [*call.args,
                                 *(kw.value for kw in call.keywords)]):
                    roots.extend(index.resolve_callable(call.func, binder,
                                                        binder.mod))
        for fi in index.reachable(roots):
            guarded = _guarded_axes(fi, index)
            for call in index.calls_of(fi):
                if not (isinstance(call.func, ast.Attribute)
                        and call.func.attr == "axis" and call.args):
                    continue
                from repro_torch.analysis.interproc import _receiver_mentions
                if not _receiver_mentions(call.func.value, "mesh"):
                    continue
                vals, complete = summ.axis_values(call.args[0], fi)
                bad = vals - declared - guarded
                if complete and bad:
                    findings.append(Finding(
                        fi.mod.rel, call.lineno, call.col_offset, "RPL006",
                        f"`mesh.axis` over {sorted(bad)} in `{fi.name}`, "
                        f"but the mesh `{binder.name}` builds only "
                        f"declares {sorted(declared)}: the lookup raises "
                        "on that mesh (or the collective runs over the "
                        "wrong ranks)",
                        related=((binder.mod.rel, mcall.lineno),)))
    return findings


def _rpl006_partial(fi, summ, index) -> List[Finding]:
    """Two-level taint inside one function: level 1 = a rank's block of a
    split contraction (`local_block` / `shard_local_cols`), level 2 = a
    product over it.  A level-2 value escaping via return (or committed
    to engine state) without reaching a reduction (`all_reduce` in
    place, `reduce_from`, `all_reduce_max`) is each rank's DIFFERENT
    partial sum."""
    from repro_torch.analysis.interproc import (PRODUCT_TAILS,
                                                REDUCTION_TAILS,
                                                SHARD_LOCAL_TAILS)
    findings: List[Finding] = []
    lv: Dict[str, int] = {}

    def level(expr) -> int:                     # noqa: C901
        if isinstance(expr, ast.Name):
            return lv.get(expr.id, 0)
        if isinstance(expr, ast.Call):
            tail = _attr_tail(expr.func)
            argl = max((level(a) for a in expr.args), default=0)
            argl = max(argl, max((level(kw.value)
                                  for kw in expr.keywords), default=0))
            if tail in REDUCTION_TAILS:
                return 0
            if tail in SHARD_LOCAL_TAILS:
                return 1
            callees = index.resolve_callable(expr.func, fi, fi.mod)
            if callees:
                c = callees[0]
                if summ.is_shard_local(c):
                    return 1
                if summ.contains_reduction(c):
                    return 0
                if argl and summ.contains_product(c):
                    return 2
                return argl
            if tail in PRODUCT_TAILS and argl:
                return 2
            if isinstance(expr.func, ast.Attribute):
                return max(argl, level(expr.func.value))
            return argl
        if isinstance(expr, ast.BinOp):
            sub = max(level(expr.left), level(expr.right))
            if isinstance(expr.op, ast.MatMult) and sub:
                return 2
            return sub
        if isinstance(expr, ast.Attribute):
            return 0 if expr.attr in _SHAPE_ATTRS else level(expr.value)
        if isinstance(expr, ast.Subscript):
            return level(expr.value)
        if isinstance(expr, (ast.Tuple, ast.List)):
            return max((level(e) for e in expr.elts), default=0)
        if isinstance(expr, ast.IfExp):
            return max(level(expr.body), level(expr.orelse))
        if isinstance(expr, ast.UnaryOp):
            return level(expr.operand)
        return 0

    def assign(target, val):
        if isinstance(target, ast.Name):
            lv[target.id] = val
        elif isinstance(target, (ast.Tuple, ast.List)):
            for e in target.elts:
                assign(e, val)
        elif isinstance(target, ast.Starred):
            assign(target.value, val)
        elif isinstance(target, ast.Attribute):
            if val >= 2 and target.attr in _STATE_ATTRS and \
                    _attr_root(target) in _ENGINE_NAMES:
                findings.append(Finding(
                    fi.mod.rel, target.lineno, target.col_offset,
                    "RPL006",
                    f"partial product committed to engine state "
                    f"`{target.attr}` without a reduction: each rank "
                    "stores a different partial sum"))
        elif isinstance(target, ast.Subscript):
            assign(target.value, val)

    def walk(stmts):
        for st in stmts:
            if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef,
                               ast.ClassDef)):
                continue
            if isinstance(st, ast.Assign):
                val = level(st.value)
                for t in st.targets:
                    assign(t, val)
            elif isinstance(st, ast.AugAssign):
                assign(st.target, max(level(st.value),
                                      level(st.target)))
            elif isinstance(st, ast.AnnAssign) and st.value is not None:
                assign(st.target, level(st.value))
            elif isinstance(st, ast.Expr) and \
                    isinstance(st.value, ast.Call) and \
                    _attr_tail(st.value.func) in REDUCTION_TAILS:
                # `axis.all_reduce(y)` sums y in place
                for a in st.value.args:
                    if isinstance(a, ast.Name):
                        lv[a.id] = 0
            elif isinstance(st, ast.Return) and st.value is not None:
                if level(st.value) >= 2:
                    findings.append(Finding(
                        fi.mod.rel, st.lineno, st.col_offset, "RPL006",
                        f"`{fi.name}` returns a product over a rank's "
                        "block of a split contraction (local_block / "
                        "shard_local_cols) that reaches no reduction: "
                        "every rank returns a DIFFERENT partial sum — "
                        "reduce it over the axis (launch.mesh.reduce_from, "
                        "MeshAxis.all_reduce) or route it through "
                        "layers.linear_row"))
            else:
                for blk_name in ("body", "orelse", "finalbody"):
                    blk = getattr(st, blk_name, None)
                    if blk:
                        walk(blk)
                for h in getattr(st, "handlers", []):
                    walk(h.body)

    walk(fi.node.body)
    return findings


def rule_rpl006(ctx: Context) -> List[Finding]:
    from repro_torch.analysis.interproc import Summaries
    index = ctx.project()
    summ = Summaries(index)
    findings: List[Finding] = []

    # mesh.shape["axis"] on a mesh PARAMETER without an axis_names
    # membership guard anywhere in the function: helpers taking a
    # caller's mesh must not assume its topology.
    for fi in index.functions.values():
        if "mesh" not in index.param_names(fi):
            continue
        guarded = _guarded_axes(fi, index)
        for n in index.owned(fi):
            if not (isinstance(n, ast.Subscript)
                    and isinstance(n.value, ast.Attribute)
                    and n.value.attr == "shape"
                    and isinstance(n.value.value, ast.Name)
                    and n.value.value.id == "mesh"):
                continue
            sl = n.slice
            if isinstance(sl, ast.Constant) and \
                    isinstance(sl.value, str) and sl.value not in guarded:
                findings.append(Finding(
                    fi.mod.rel, n.lineno, n.col_offset, "RPL006",
                    f"`mesh.shape[{sl.value!r}]` in `{fi.name}` without "
                    f"checking {sl.value!r} in mesh.axis_names: "
                    "KeyErrors on meshes that don't declare the axis — "
                    "guard the lookup or use mesh.shape.get"))
    findings.extend(_rpl006_axes(index, summ))
    for fi in index.functions.values():
        findings.extend(_rpl006_partial(fi, summ, index))
    return findings


# ---------------------------------------------------------------------------
# RPL007 — kernel entry contract (interprocedural)
# ---------------------------------------------------------------------------

def _required_params(fn) -> Set[str]:
    a = fn.args
    pos = [*a.posonlyargs, *a.args]
    required = {p.arg for p in pos[:len(pos) - len(a.defaults)]}
    required |= {p.arg for p, d in zip(a.kwonlyargs, a.kw_defaults)
                 if d is None}
    return required


def _all_params(fn) -> Set[str]:
    a = fn.args
    return {p.arg for p in (*a.posonlyargs, *a.args, *a.kwonlyargs)}


def rule_rpl007(ctx: Context) -> List[Finding]:
    index = ctx.project()
    findings: List[Finding] = []
    for policy, csrc in _kernel_trees(ctx):
        registry, reg_line = _load_registry(policy)
        if registry is None:
            continue                       # RPL002's finding; don't dup
        ref_defs = _module_defs(_sibling_module(ctx, policy, "ref"))
        ops_defs = _module_defs(_sibling_module(ctx, policy, "ops"))
        for name in sorted(registry):
            meta = registry[name]
            if not isinstance(meta, dict) or "wrapper" not in meta:
                continue                   # RPL002's finding
            wrapper = _sibling_module(ctx, policy, meta["wrapper"])
            if wrapper is None:
                continue
            entries = _as_list(meta.get("entry") or [])
            if not entries:
                findings.append(Finding(
                    policy.rel, reg_line, 0, "RPL007",
                    f"KERNEL_REGISTRY[{name!r}] has no 'entry' naming the "
                    "public wrapper whose signature mirrors the plain twin "
                    "and whose body checks its tensors"))
                continue
            wdefs = _module_defs(wrapper)
            refs = [ref_defs[r] for r in _as_list(meta.get("ref", []))
                    if r in ref_defs]
            for ename in entries:
                fn = wdefs.get(ename) or ops_defs.get(ename)
                if fn is None or ename.startswith("_"):
                    findings.append(Finding(
                        wrapper.rel, 1, 0, "RPL007",
                        f"registered entry `{ename}` of "
                        f"KERNEL_REGISTRY[{name!r}] is not a public "
                        f"module-level function of {wrapper.rel} or "
                        "kernels/ops.py"))
                    continue
                if refs and not any(_required_params(r) <= _all_params(fn)
                                    for r in refs):
                    want = sorted(_required_params(refs[0])
                                  - _all_params(fn))
                    findings.append(Finding(
                        wrapper.rel if ename in wdefs else
                        str(pathlib.Path(wrapper.rel).parent / "ops.py"),
                        fn.lineno, fn.col_offset, "RPL007",
                        f"entry wrapper `{ename}` matches no registered "
                        f"plain twin's required signature (e.g. "
                        f"`{refs[0].name}` needs {want}): policy dispatch "
                        "between kernel and plain version would TypeError"))
            # each launch's tensor checks dominate it
            if wrapper.rel not in index.mod_name:
                continue
            prefix = index.mod_name[wrapper.rel]
            for fn in wdefs.values():
                wfi = index.functions.get(f"{prefix}.{fn.name}")
                for call in _launch_sites(fn):
                    if not _dominated(wfi, call.lineno, "require", index):
                        findings.append(Finding(
                            wrapper.rel, call.lineno, call.col_offset,
                            "RPL007",
                            f"`{fn.name}` launches {_attr_tail(call.func)} "
                            "with no _build.require (device, dtype, rank, "
                            "contiguity) before it, in its body or in "
                            "every caller's (two levels): the kernel reads "
                            "raw pointers and row-major strides"))
    return findings


# ---------------------------------------------------------------------------
# RPL008 — commit discipline (interprocedural)
# ---------------------------------------------------------------------------

# transactional slot/pool state: RPL003's attrs minus the readout
# payload (`result`, owned per-session) and the forensics log
# (`_fault_log`, append-only and harvested after recovery)
_RPL008_ATTRS = _STATE_ATTRS - {"result", "_fault_log"}
_RPL008_RECEIVERS = {"self", "eng", "engine"}
_MUTATOR_METHODS = {"append", "extend", "update", "clear", "pop",
                    "remove", "insert", "fill", "setdefault"}


def _state_attr_of(node) -> Optional[str]:
    t = node
    if isinstance(t, ast.Subscript):
        t = t.value
    if isinstance(t, ast.Attribute) and t.attr in _RPL008_ATTRS and \
            _attr_root(t) in _RPL008_RECEIVERS:
        return t.attr
    return None


def _rpl008_fn(fi, summ, index) -> List[Finding]:
    """Execution-order walk flagging a DIRECT engine-state mutation
    followed by a may-raise call (a step dispatch, a kernel launch, a
    fault-injector probe, or a callee that raises — two levels deep).
    Loop bodies are walked once (each iteration is its own
    transaction), except-handler bodies are recovery code and skipped,
    and a try with handlers or a state-restoring finally protects its
    calls."""
    findings: List[Finding] = []
    pending: List[Tuple[str, int]] = []

    def hazard_of(call):
        h = summ.call_hazard(call)
        if h is not None:
            return h, ()
        for tgt in index.resolve_callable(call.func, fi, fi.mod):
            if tgt is fi:
                continue
            mr = summ.may_raise(tgt)
            if mr is not None:
                return (f"calls `{tgt.name}()` which {mr.reason}",
                        ((mr.where, mr.line),))
        return None

    def check_calls(node, protected):
        for n in ast.walk(node):
            if not (isinstance(n, ast.Call)
                    and index.owner.get(n) is fi):
                continue
            hz = hazard_of(n)
            if hz is None or not pending or protected:
                continue
            attr, mline = pending[0]
            reason, related = hz
            findings.append(Finding(
                fi.mod.rel, n.lineno, n.col_offset, "RPL008",
                f"engine state `{attr}` mutated at line {mline} and "
                f"then a may-raise call runs ({reason}): a raise "
                "leaves the slot/pool half-committed — stage results "
                "locally and commit after the call, probe with "
                "commit=False first, or restore in a finally",
                related=((fi.mod.rel, mline),) + related))

    def record(st):
        if isinstance(st, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
            targets = st.targets if isinstance(st, ast.Assign) \
                else [st.target]
            for t in targets:
                attr = _state_attr_of(t)
                if attr is not None:
                    pending.append((attr, st.lineno))
        elif isinstance(st, ast.Expr) and isinstance(st.value, ast.Call):
            c = st.value
            if isinstance(c.func, ast.Attribute) and \
                    c.func.attr in _MUTATOR_METHODS:
                attr = _state_attr_of(c.func.value)
                if attr is not None:
                    pending.append((attr, st.lineno))

    def finally_restores(st) -> bool:
        for blk_st in st.finalbody:
            for n in ast.walk(blk_st):
                if isinstance(n, (ast.Assign, ast.AugAssign,
                                  ast.AnnAssign)):
                    targets = n.targets if isinstance(n, ast.Assign) \
                        else [n.target]
                    if any(_state_attr_of(t) is not None
                           for t in targets):
                        return True
        return False

    def walk(stmts, protected):
        for st in stmts:
            if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef,
                               ast.ClassDef)):
                continue
            if isinstance(st, ast.Try):
                prot = protected or bool(st.handlers) or \
                    finally_restores(st)
                walk(st.body, prot)
                walk(st.orelse, prot)
                walk(st.finalbody, protected)
            elif isinstance(st, (ast.If, ast.While)):
                check_calls(st.test, protected)
                walk(st.body, protected)
                walk(st.orelse, protected)
            elif isinstance(st, ast.For):
                check_calls(st.iter, protected)
                walk(st.body, protected)
                walk(st.orelse, protected)
            elif isinstance(st, ast.With):
                for item in st.items:
                    check_calls(item.context_expr, protected)
                walk(st.body, protected)
            else:
                check_calls(st, protected)
                record(st)

    walk(fi.node.body, False)
    return findings


def rule_rpl008(ctx: Context) -> List[Finding]:
    from repro_torch.analysis.interproc import Summaries
    index = ctx.project()
    summ = Summaries(index)
    findings: List[Finding] = []
    for fi in index.functions.values():
        findings.extend(_rpl008_fn(fi, summ, index))
    return findings


PER_FILE_RULES = {
    "RPL003": rule_rpl003,
    "RPL004": rule_rpl004,
    "RPL005": rule_rpl005,
}

GLOBAL_RULES = {
    "RPL001": rule_rpl001,
    "RPL002": rule_rpl002,
    "RPL006": rule_rpl006,
    "RPL007": rule_rpl007,
    "RPL008": rule_rpl008,
}
