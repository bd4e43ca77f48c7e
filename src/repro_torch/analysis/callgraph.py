"""Whole-project symbol table + call graph for the interprocedural rules.

Port of `repro/analysis/callgraph.py`; module names are rooted at the
import root (`src/repro_torch/x.py` -> `repro_torch.x`).
`ProjectIndex` parses nothing itself — it indexes the `ParsedModule` set
the driver already holds — and resolves *project-internal* calls only:
imports (module- and function-local), module-level defs, `self.`/`cls.`
methods through the class hierarchy (abstract `raise NotImplementedError`
bodies resolve to their concrete overrides), `self.<attr>.<method>`
where the class builds `self.<attr>` from a project class (`self.lm =
LM(...)`), nested defs, and locals bound to a call whose callee returns
a locally-defined function (a `step = self._step_fn()` factory).  Anything
else — third-party calls, arbitrary attribute receivers — resolves to
nothing, so downstream summaries stay conservative instead of guessing.

Resolution is name-based and flow-insensitive: a local rebound to two
different functions resolves to both.  That over-approximation is the
right direction for every current client (reachability, may-raise and
mutation summaries union over candidates).
"""
from __future__ import annotations

import ast
import pathlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from repro_torch.analysis.core import ParsedModule
from repro_torch.analysis.imports import module_name


@dataclass(eq=False)
class FunctionInfo:
    """One indexed function: module-level def, method, or nested def."""
    qualname: str                 # repro_torch.serving.asr.AsrEngine._step
    name: str
    mod: ParsedModule
    node: ast.AST                 # FunctionDef | AsyncFunctionDef
    cls: Optional[str] = None     # enclosing class qualname (methods and
                                  # defs nested inside methods)
    parent: Optional["FunctionInfo"] = None   # enclosing function


@dataclass(eq=False)
class ClassInfo:
    qualname: str
    name: str
    mod: ParsedModule
    node: ast.ClassDef
    bases: List[ast.expr] = field(default_factory=list)
    methods: Dict[str, FunctionInfo] = field(default_factory=dict)


def is_abstract(node: ast.AST) -> bool:
    """Body is (docstring +) a lone `raise NotImplementedError`: an
    interface slot, not a may-raise implementation — calls through it
    resolve to the concrete overrides instead."""
    body = list(getattr(node, "body", []))
    if body and isinstance(body[0], ast.Expr) and \
            isinstance(body[0].value, ast.Constant) and \
            isinstance(body[0].value.value, str):
        body = body[1:]
    if len(body) != 1 or not isinstance(body[0], ast.Raise):
        return False
    exc = body[0].exc
    if isinstance(exc, ast.Call):
        exc = exc.func
    return isinstance(exc, ast.Name) and exc.id == "NotImplementedError"


def _fn_param_names(node) -> List[str]:
    a = node.args
    return [p.arg for p in (*a.posonlyargs, *a.args, *a.kwonlyargs)]


class ProjectIndex:
    def __init__(self, modules: Dict[str, ParsedModule],
                 root: pathlib.Path):
        self.root = root
        self.modules = list(modules.values())
        self.functions: Dict[str, FunctionInfo] = {}
        self.classes: Dict[str, ClassInfo] = {}
        self.mod_name: Dict[str, str] = {}          # rel path -> dotted
        self.mod_scope: Dict[str, Dict[str, str]] = {}
        self.fn_scope: Dict[FunctionInfo, Dict[str, str]] = {}
        self.owner: Dict[ast.AST, Optional[FunctionInfo]] = {}
        self._calls: Dict[FunctionInfo, List[ast.Call]] = {}
        self._assigns: Dict[FunctionInfo, Dict[str, List[ast.expr]]] = {}
        self._callees: Dict[FunctionInfo, List] = {}
        self._callers: Optional[Dict[FunctionInfo, List]] = None
        self._ancestry_cache: Dict[str, List[ClassInfo]] = {}
        for mod in self.modules:
            try:
                dotted = module_name(mod.path.resolve(),
                                     root.resolve())
            except ValueError:
                dotted = mod.path.stem
            self.mod_name[mod.rel] = dotted
            self.mod_scope[dotted] = {}
            self._scan(mod.tree, mod, dotted, fi=None, cls=None,
                       prefix=dotted)
            self._bind_imports(mod, dotted)

    # ---- construction ------------------------------------------------
    def _scan(self, node, mod, dotted, fi, cls, prefix):
        for child in ast.iter_child_nodes(node):
            self.owner[child] = fi
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                if fi is None and cls is None:
                    qual = f"{prefix}.{child.name}"
                    self.mod_scope[dotted][child.name] = qual
                elif fi is None:              # class body: a method
                    qual = f"{prefix}.{child.name}"
                else:                         # nested def
                    qual = f"{prefix}.<locals>.{child.name}"
                sub = FunctionInfo(qual, child.name, mod, child,
                                   cls=cls, parent=fi)
                self.functions[qual] = sub
                if cls is not None and fi is None:
                    self.classes[cls].methods[child.name] = sub
                self._scan(child, mod, dotted, sub, cls, qual)
            elif isinstance(child, ast.ClassDef):
                cqual = f"{prefix}.{child.name}"
                self.classes[cqual] = ClassInfo(
                    cqual, child.name, mod, child, list(child.bases))
                if fi is None and cls is None:
                    self.mod_scope[dotted][child.name] = cqual
                self._scan(child, mod, dotted, None, cqual, cqual)
            else:
                self._scan(child, mod, dotted, fi, cls, prefix)

    def _bind_imports(self, mod, dotted):
        pkg_parts = dotted.split(".")[:-1]
        for node in ast.walk(mod.tree):
            env = None
            if isinstance(node, ast.Import):
                env = self._env_for(node, dotted)
                for alias in node.names:
                    if alias.asname:
                        env[alias.asname] = alias.name
                    else:
                        head = alias.name.split(".")[0]
                        env[head] = head
            elif isinstance(node, ast.ImportFrom):
                env = self._env_for(node, dotted)
                if node.level:
                    base = pkg_parts[:len(pkg_parts) - node.level + 1]
                    prefix = ".".join(base + ([node.module]
                                              if node.module else []))
                else:
                    prefix = node.module or ""
                for alias in node.names:
                    tgt = f"{prefix}.{alias.name}" if prefix else alias.name
                    env[alias.asname or alias.name] = tgt

    def _env_for(self, node, dotted) -> Dict[str, str]:
        fi = self.owner.get(node)
        if fi is None:
            return self.mod_scope[dotted]
        return self.fn_scope.setdefault(fi, {})

    # ---- per-function node access ------------------------------------
    def calls_of(self, fi: FunctionInfo) -> List[ast.Call]:
        """Call nodes belonging DIRECTLY to `fi` (nested defs own their
        own calls)."""
        if fi not in self._calls:
            self._calls[fi] = [n for n in ast.walk(fi.node)
                               if isinstance(n, ast.Call)
                               and self.owner.get(n) is fi]
        return self._calls[fi]

    def owned(self, fi: FunctionInfo):
        for n in ast.walk(fi.node):
            if self.owner.get(n) is fi or n is fi.node:
                yield n

    def local_assignments(self, fi: FunctionInfo,
                          name: str) -> List[ast.expr]:
        """RHS expressions ever assigned to local `name` in `fi`
        (plain/ann assigns; `for name in it` contributes `it`, which
        value-resolution unions elementwise when it is a literal)."""
        if fi not in self._assigns:
            table: Dict[str, List[ast.expr]] = {}

            def put(target, value):
                if isinstance(target, ast.Name):
                    table.setdefault(target.id, []).append(value)

            for n in self.owned(fi):
                if isinstance(n, ast.Assign) and n.value is not None:
                    for t in n.targets:
                        put(t, n.value)
                elif isinstance(n, ast.AnnAssign) and n.value is not None:
                    put(n.target, n.value)
                elif isinstance(n, ast.For):
                    put(n.target, n.iter)
            self._assigns[fi] = table
        return self._assigns[fi].get(name, [])

    def module_assignments(self, mod: ParsedModule,
                           name: str) -> List[ast.expr]:
        out = []
        for n in mod.tree.body:
            if isinstance(n, ast.Assign):
                for t in n.targets:
                    if isinstance(t, ast.Name) and t.id == name:
                        out.append(n.value)
        return out

    # ---- resolution --------------------------------------------------
    def resolve_binding(self, name: str, within: Optional[FunctionInfo],
                        mod: ParsedModule) -> Optional[str]:
        fi = within
        while fi is not None:
            q = f"{fi.qualname}.<locals>.{name}"
            if q in self.functions:
                return q
            env = self.fn_scope.get(fi)
            if env and name in env:
                return env[name]
            fi = fi.parent
        return self.mod_scope.get(self.mod_name[mod.rel], {}).get(name)

    def resolve_callable(self, expr, within: Optional[FunctionInfo],
                         mod: ParsedModule,
                         _depth: int = 0) -> List[FunctionInfo]:
        """Project functions `expr` may denote as a callable."""
        if _depth > 4:
            return []
        if isinstance(expr, ast.Name):
            target = self.resolve_binding(expr.id, within, mod)
            if target is not None:
                fn = self.functions.get(target)
                return [fn] if fn is not None else []
            if within is None:
                return []
            out: List[FunctionInfo] = []
            for rhs in self.local_assignments(within, expr.id):
                if isinstance(rhs, ast.Call):
                    for callee in self.resolve_callable(
                            rhs.func, within, mod, _depth + 1):
                        out.extend(self.returned_functions(callee))
                elif isinstance(rhs, (ast.Name, ast.Attribute)):
                    out.extend(self.resolve_callable(
                        rhs, within, mod, _depth + 1))
            return _dedup(out)
        if isinstance(expr, ast.Attribute):
            if isinstance(expr.value, ast.Name) and \
                    expr.value.id in ("self", "cls"):
                cls = within.cls if within is not None else None
                if cls is not None:
                    return self.resolve_method(cls, expr.attr)
                return []
            if isinstance(expr.value, ast.Attribute) and \
                    isinstance(expr.value.value, ast.Name) and \
                    expr.value.value.id == "self" and within is not None \
                    and within.cls is not None:
                # self.<attr>.<method>: the classes `self.<attr>` is
                # built from in the class's methods (`self.lm = LM(...)`)
                out = []
                for owner in self.self_attr_classes(within.cls,
                                                    expr.value.attr):
                    out.extend(self.resolve_method(owner, expr.attr))
                return _dedup(out)
            parts = []
            cur = expr
            while isinstance(cur, ast.Attribute):
                parts.append(cur.attr)
                cur = cur.value
            if not isinstance(cur, ast.Name):
                return []
            base = self.resolve_binding(cur.id, within, mod)
            if base is None:
                return []
            parts.reverse()
            qual = ".".join([base] + parts)
            fn = self.functions.get(qual)
            if fn is not None:
                return [fn]
            owner_q = ".".join([base] + parts[:-1])
            if owner_q in self.classes:
                return self.resolve_method(owner_q, parts[-1])
            return []
        return []

    def self_attr_classes(self, cls_qual: str, attr: str) -> List[str]:
        """Project classes whose instances the class (or an ancestor)
        assigns to `self.<attr>`: `self.lm = LM(cfg)`."""
        out = []
        for c in self._ancestry(cls_qual):
            for m in c.methods.values():
                for n in self.owned(m):
                    if not (isinstance(n, ast.Assign)
                            and isinstance(n.value, ast.Call)
                            and any(isinstance(t, ast.Attribute)
                                    and t.attr == attr
                                    and isinstance(t.value, ast.Name)
                                    and t.value.id == "self"
                                    for t in n.targets)):
                        continue
                    f = n.value.func
                    tgt = None
                    if isinstance(f, ast.Name):
                        tgt = self.resolve_binding(f.id, m, m.mod)
                    elif isinstance(f, ast.Attribute) and \
                            isinstance(f.value, ast.Name):
                        base = self.resolve_binding(f.value.id, m, m.mod)
                        tgt = f"{base}.{f.attr}" if base else None
                    if tgt in self.classes and tgt not in out:
                        out.append(tgt)
        return out

    def resolve_method(self, cls_qual: str, name: str) -> \
            List[FunctionInfo]:
        for c in self._ancestry(cls_qual):
            m = c.methods.get(name)
            if m is None:
                continue
            if is_abstract(m.node):
                overrides = [k.methods[name] for k in self.modules_subs
                             (cls_qual)
                             if name in k.methods
                             and not is_abstract(k.methods[name].node)]
                return overrides or [m]
            return [m]
        return []

    def _ancestry(self, cls_qual: str) -> List[ClassInfo]:
        if cls_qual in self._ancestry_cache:
            return self._ancestry_cache[cls_qual]
        out: List[ClassInfo] = []
        seen = set()
        queue = [cls_qual]
        while queue:
            q = queue.pop(0)
            if q in seen or q not in self.classes:
                continue
            seen.add(q)
            c = self.classes[q]
            out.append(c)
            for b in c.bases:
                tgt = None
                if isinstance(b, ast.Name):
                    tgt = self.resolve_binding(b.id, None, c.mod)
                elif isinstance(b, ast.Attribute) and \
                        isinstance(b.value, ast.Name):
                    base = self.resolve_binding(b.value.id, None, c.mod)
                    if base is not None:
                        tgt = f"{base}.{b.attr}"
                if tgt is not None:
                    queue.append(tgt)
        self._ancestry_cache[cls_qual] = out
        return out

    def modules_subs(self, cls_qual: str) -> List[ClassInfo]:
        """Classes anywhere in the project whose ancestry includes
        `cls_qual` (the class itself excluded)."""
        return [c for q, c in self.classes.items() if q != cls_qual
                and any(a.qualname == cls_qual for a in self._ancestry(q))]

    def returned_functions(self, fi: FunctionInfo) -> List[FunctionInfo]:
        """Nested defs `fi` returns (directly, or wrapped in
        functools.partial): resolves the `step = self._step_fn()`
        factory pattern."""
        out = []
        for n in self.owned(fi):
            if not isinstance(n, ast.Return) or n.value is None:
                continue
            v = n.value
            if isinstance(v, ast.Call) and v.args and \
                    _tail(v.func) == "partial":
                v = v.args[0]
            if isinstance(v, ast.Name):
                q = f"{fi.qualname}.<locals>.{v.id}"
                if q in self.functions:
                    out.append(self.functions[q])
        return out

    # ---- call graph --------------------------------------------------
    def callees(self, fi: FunctionInfo) -> \
            List[Tuple[ast.Call, FunctionInfo]]:
        if fi not in self._callees:
            out = []
            for call in self.calls_of(fi):
                for tgt in self.resolve_callable(call.func, fi, fi.mod):
                    out.append((call, tgt))
            self._callees[fi] = out
        return self._callees[fi]

    def callers_of(self, fi: FunctionInfo) -> \
            List[Tuple[FunctionInfo, ast.Call]]:
        if self._callers is None:
            self._callers = {}
            for caller in list(self.functions.values()):
                for call, tgt in self.callees(caller):
                    self._callers.setdefault(tgt, []).append((caller, call))
        return self._callers.get(fi, [])

    def reachable(self, roots: List[FunctionInfo]) -> \
            Dict[FunctionInfo, List[FunctionInfo]]:
        """BFS closure over callees: reached function -> the roots that
        reach it (roots reach themselves)."""
        out: Dict[FunctionInfo, List[FunctionInfo]] = {}
        for root in roots:
            queue, seen = [root], {root}
            while queue:
                fi = queue.pop(0)
                out.setdefault(fi, [])
                if root not in out[fi]:
                    out[fi].append(root)
                for _, tgt in self.callees(fi):
                    if tgt not in seen:
                        seen.add(tgt)
                        queue.append(tgt)
        return out

    def param_names(self, fi: FunctionInfo) -> List[str]:
        return _fn_param_names(fi.node)


def _tail(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return None


def _dedup(fis: List[FunctionInfo]) -> List[FunctionInfo]:
    seen, out = set(), []
    for f in fis:
        if id(f) not in seen:
            seen.add(id(f))
            out.append(f)
    return out

