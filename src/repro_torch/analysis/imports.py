"""Import graph + config-usage report, for the port.

Port of `repro/analysis/imports.py`.  Answers "is this module actually
used?" for the port's config registry (`src/repro_torch/configs/`),
where plain grep lies: every configs/*.py is imported by
configs/archs.py for registration side effects, so import edges alone
make everything look live.  `config_usage` therefore reports, per
config module, (a) its importers OTHER than the blanket archs.py
registration, and (b) the port's files elsewhere (its package, its
tests `tests/test_torch_*.py`, its examples `examples/torch_*.py` and
`chip_smoke.py`) that mention its registered arch name as a string
literal (how tests and launchers actually select a config).  The
reference's files do not count: a config the reference uses may still
be dead in the port.
"""
from __future__ import annotations

import ast
import pathlib
from dataclasses import dataclass, field
from typing import Dict, List, Set

from repro_torch.analysis.core import ParsedModule, iter_py_files, parse_file


def module_name(path: pathlib.Path, root: pathlib.Path) -> str:
    """Dotted module name for `path`, rooted at the import root
    (src/ layout aware: src/repro_torch/x.py -> repro_torch.x)."""
    rel = path.relative_to(root)
    parts = list(rel.with_suffix("").parts)
    if parts and parts[0] == "src":
        parts = parts[1:]
    if parts and parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(parts)


def build_import_graph(modules: Dict[str, ParsedModule],
                       root: pathlib.Path) -> Dict[str, Set[str]]:
    """module dotted name -> set of imported dotted names (absolute;
    relative imports are resolved against the importer's package)."""
    graph: Dict[str, Set[str]] = {}
    for mod in modules.values():
        name = module_name(mod.path, root)
        edges = graph.setdefault(name, set())
        pkg_parts = name.split(".")[:-1]
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Import):
                for alias in node.names:
                    edges.add(alias.name)
            elif isinstance(node, ast.ImportFrom):
                if node.level:
                    base = pkg_parts[:len(pkg_parts) - node.level + 1]
                    prefix = ".".join(base + ([node.module]
                                              if node.module else []))
                else:
                    prefix = node.module or ""
                if prefix:
                    edges.add(prefix)
                for alias in node.names:
                    if prefix:
                        edges.add(f"{prefix}.{alias.name}")
    return graph


@dataclass
class ConfigUsage:
    module: str                      # e.g. repro_torch.configs.qwen2_72b
    arch_names: List[str]            # registered model names
    importers: List[str] = field(default_factory=list)    # minus archs.py
    name_refs: List[str] = field(default_factory=list)    # files citing name

    @property
    def dead(self) -> bool:
        return not self.importers and not self.name_refs


def _registered_names(mod: ParsedModule) -> List[str]:
    """String value of `name=` kwargs in register(ModelConfig(...))."""
    names: List[str] = []
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.Call):
            for kw in node.keywords:
                if kw.arg == "name" and isinstance(kw.value, ast.Constant) \
                        and isinstance(kw.value.value, str):
                    names.append(kw.value.value)
    return names


def port_files(root: pathlib.Path) -> List[pathlib.Path]:
    """The port's Python files: its package, tests, examples and
    `chip_smoke.py`."""
    files = iter_py_files([str(root / "src" / "repro_torch")])
    for pattern in ("tests/test_torch_*.py", "examples/torch_*.py",
                    "chip_smoke.py"):
        files.extend(sorted(root.glob(pattern)))
    return files


def config_usage(root: pathlib.Path) -> List[ConfigUsage]:
    files = port_files(root)
    modules = {str(f): parse_file(f, root) for f in files}
    graph = build_import_graph(modules, root)

    cfg_dir = root / "src" / "repro_torch" / "configs"
    skip = {"__init__", "base", "archs"}
    out: List[ConfigUsage] = []
    for path in sorted(cfg_dir.glob("*.py")):
        if path.stem in skip:
            continue
        dotted = module_name(path, root)
        mod = modules[str(path)]
        usage = ConfigUsage(module=dotted,
                            arch_names=_registered_names(mod))
        for importer, edges in graph.items():
            if importer in (dotted, "repro_torch.configs.archs"):
                continue
            if dotted in edges or any(e.startswith(dotted + ".")
                                      for e in edges):
                usage.importers.append(importer)
        for other in modules.values():
            # the configs package itself (ASSIGNED_ARCHS in base.py, the
            # archs.py import list) is registry bookkeeping, not usage
            if other.path.parent == cfg_dir:
                continue
            if any(isinstance(n, ast.Constant) and n.value in
                   usage.arch_names for n in ast.walk(other.tree)
                   if isinstance(n, ast.Constant)):
                usage.name_refs.append(other.rel)
        usage.importers.sort()
        usage.name_refs.sort()
        out.append(usage)
    return out


def format_config_usage(usages: List[ConfigUsage]) -> str:
    lines = []
    for u in usages:
        status = "DEAD" if u.dead else "used"
        lines.append(f"{u.module} [{status}] names={u.arch_names}")
        if u.importers:
            lines.append(f"  importers (beyond archs.py): {u.importers}")
        if u.name_refs:
            lines.append(f"  name references: {u.name_refs}")
    return "\n".join(lines)
