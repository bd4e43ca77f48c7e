"""repro-lint driver for the port: file walking, suppressions, rule
dispatch.

Port of `repro/analysis/core.py`, kept as the port's own copy.  Two-phase
analysis: every file is parsed once into a `ParsedModule`, a shared
`Context` gathers the cross-file facts the rules need (the set of
`@worker_only`-annotated method names; the kernel registry literal in
kernels/policy.py is read by the rules that need it), then per-file and
global rules run over the parsed set.  Pure stdlib `ast` — nothing here
imports torch, so the linter runs in milliseconds and in any
environment.  The suppression syntax is the reference's, so a
suppression in `src/repro_torch/` means the same thing to both linters.
"""
from __future__ import annotations

import ast
import pathlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set

SUPPRESS_TAG = "# repro-lint: disable="
SUPPRESS_FILE_TAG = "# repro-lint: disable-file="

RULE_DOCS = {
    "RPL001": "host read in a guarded step: .item()/.tolist()/.cpu()/"
              ".numpy(), int()/float()/bool() or Python control flow on a "
              "tensor, nonzero/bincount/unique/masked_select/one-argument "
              "where, or an index by a scalar tensor, reachable (two call "
              "levels) from a no_implicit_transfers() block",
    "RPL002": "kernel contract: a kernels/csrc/*.cu without a "
              "KERNEL_REGISTRY entry naming its _build.SIGNATURES entry "
              "points, a wrapper that refuses grad and counts its "
              "launches, a plain twin in kernels/ref.py, a kernels/cost.py "
              "formula, a CPU parity test and a cuda-marked "
              "kernel-vs-plain test",
    "RPL003": "aliasing: engine slot state escapes without copy_result",
    "RPL004": "thread discipline: @worker_only engine method called "
              "from an asyncio handler (or a supervisor/watchdog entry "
              "point) outside a worker thunk",
    "RPL005": "RNG discipline: a module that runs sharded compute "
              "(MeshAxis collectives, local_block, init_local) draws from "
              "torch's global generator (manual_seed, or rand*/randn*/"
              "randint/normal_ without generator=)",
    "RPL006": "collective/axis discipline: a MeshAxis collective over an "
              "axis the cell's mesh does not declare; a product over a "
              "local_block-split contraction that escapes without reaching "
              "a reduction (MeshAxis.all_reduce, reduce_from, "
              "all_reduce_max)",
    "RPL007": "kernel entry contract: the registry's 'entry' names a "
              "public function of kernels/ops.py or of the wrapper module "
              "whose signature covers a registered plain twin, and the "
              "wrapper's device/dtype/shape/contiguity checks dominate its "
              "ctypes launch",
    "RPL008": "commit discipline: engine slot/pool state mutated before "
              "a may-raise call without commit=False probing or a "
              "restoring finally",
}


@dataclass(frozen=True)
class Finding:
    path: str
    line: int
    col: int
    code: str
    message: str
    related: tuple = ()           # ((path, line), ...) secondary sites —
                                  # a suppression at any of them counts

    def format(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: {self.code} " \
               f"{self.message}"


@dataclass
class ParsedModule:
    path: pathlib.Path
    rel: str                      # path relative to the repo root
    source: str
    tree: ast.Module
    lines: List[str] = field(default_factory=list)

    def __post_init__(self):
        if not self.lines:
            self.lines = self.source.splitlines()


class Suppressions:
    """Per-file suppression map.

    A `# repro-lint: disable=RPL001[,RPL002]` comment suppresses those
    codes on its own line; on a comment-only line it also suppresses the
    next statement line (so a suppression can sit above a long
    statement) — and keeps sliding past decorator / blank / comment
    lines so a comment above `@decorator`s covers the `def` line too.
    `# repro-lint: disable-file=RPL001` suppresses a code everywhere in
    the file.  Suppressed findings are counted, never silently lost.
    """

    def __init__(self, lines: Sequence[str]):
        self.by_line: Dict[int, Set[str]] = {}
        self.file_wide: Set[str] = set()
        for i, text in enumerate(lines, start=1):
            if SUPPRESS_FILE_TAG in text:
                self.file_wide |= self._codes(text, SUPPRESS_FILE_TAG)
            if SUPPRESS_TAG in text:
                codes = self._codes(text, SUPPRESS_TAG)
                self.by_line.setdefault(i, set()).update(codes)
                if text.lstrip().startswith("#"):    # comment-only line
                    for j in range(i + 1, min(i + 12, len(lines) + 1)):
                        self.by_line.setdefault(j, set()).update(codes)
                        nxt = lines[j - 1].lstrip()
                        if nxt and not nxt.startswith(("#", "@")):
                            break

    @staticmethod
    def _codes(text: str, tag: str) -> Set[str]:
        spec = text.split(tag, 1)[1].split("#")[0]
        codes = set()
        for chunk in spec.replace(";", ",").split(","):
            tok = chunk.strip().split()
            if tok and tok[0].startswith("RPL"):
                codes.add(tok[0])
        return codes

    def covers(self, finding: Finding) -> bool:
        if finding.code in self.file_wide:
            return True
        return finding.code in self.by_line.get(finding.line, set())


def parse_file(path: pathlib.Path, root: pathlib.Path) -> ParsedModule:
    src = path.read_text()
    try:
        rel = str(path.relative_to(root))
    except ValueError:
        rel = str(path)
    return ParsedModule(path=path, rel=rel, source=src,
                        tree=ast.parse(src, filename=str(path)))


def find_repo_root(start: pathlib.Path) -> pathlib.Path:
    """Nearest ancestor holding pyproject.toml or .git (the anchor for
    registry-relative paths like `tests/test_kernels.py`)."""
    cur = start.resolve()
    if cur.is_file():
        cur = cur.parent
    for cand in (cur, *cur.parents):
        if (cand / "pyproject.toml").exists() or (cand / ".git").exists():
            return cand
    return cur


@dataclass
class Context:
    root: pathlib.Path
    modules: Dict[str, ParsedModule]
    worker_only_names: Set[str] = field(default_factory=set)
    _project = None

    def project(self):
        """Memoized whole-project symbol table + call graph shared by
        the interprocedural rules (RPL006–008)."""
        if self._project is None:
            from repro_torch.analysis.callgraph import ProjectIndex
            self._project = ProjectIndex(self.modules, self.root)
        return self._project


def _collect_worker_only(modules: Dict[str, ParsedModule]) -> Set[str]:
    names: Set[str] = set()
    for mod in modules.values():
        for node in ast.walk(mod.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                for deco in node.decorator_list:
                    d = deco.func if isinstance(deco, ast.Call) else deco
                    tail = d.attr if isinstance(d, ast.Attribute) else \
                        d.id if isinstance(d, ast.Name) else None
                    if tail == "worker_only":
                        names.add(node.name)
    return names


def iter_py_files(paths: Sequence[str]) -> List[pathlib.Path]:
    out: List[pathlib.Path] = []
    for p in paths:
        pth = pathlib.Path(p)
        if pth.is_dir():
            out.extend(sorted(f for f in pth.rglob("*.py")
                              if "__pycache__" not in f.parts))
        elif pth.suffix == ".py":
            out.append(pth)
    return out


def run_paths(paths: Sequence[str], *,
              rules: Optional[Sequence[str]] = None,
              root: Optional[pathlib.Path] = None):
    """Analyze `paths`; returns (findings, suppressed) with findings
    sorted by (path, line, code).  `rules` restricts to a subset of
    codes (default: all)."""
    from repro_torch.analysis import rules as rulemod

    files = iter_py_files(paths)
    if root is None:
        root = find_repo_root(files[0] if files else pathlib.Path("."))
    modules = {str(f): parse_file(f, root) for f in files}
    ctx = Context(root=root, modules=modules)
    ctx.worker_only_names = _collect_worker_only(modules)

    active = set(rules or RULE_DOCS)
    raw: List[Finding] = []
    for mod in modules.values():
        for code, rule in rulemod.PER_FILE_RULES.items():
            if code in active:
                raw.extend(rule(mod, ctx))
    for code, rule in rulemod.GLOBAL_RULES.items():
        if code in active:
            raw.extend(rule(ctx))

    findings: List[Finding] = []
    suppressed: List[Finding] = []
    supp_cache: Dict[str, Suppressions] = {}

    def supp_for(rel: str) -> Optional[Suppressions]:
        if rel not in supp_cache:
            mod = next((m for m in modules.values() if m.rel == rel),
                       None)
            supp_cache[rel] = Suppressions(mod.lines) \
                if mod is not None else None
        return supp_cache[rel]

    for f in raw:
        supp = supp_for(f.path)
        covered = supp is not None and supp.covers(f)
        # an interprocedural finding may also be suppressed at any of
        # its related sites (e.g. the callee line of a may-raise chain)
        for rpath, rline in f.related:
            if covered:
                break
            rsupp = supp_for(rpath)
            covered = rsupp is not None and \
                f.code in (rsupp.file_wide
                           | rsupp.by_line.get(rline, set()))
        (suppressed if covered else findings).append(f)
    findings.sort(key=lambda f: (f.path, f.line, f.code))
    return findings, suppressed
