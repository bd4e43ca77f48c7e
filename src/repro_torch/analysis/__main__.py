"""CLI: `python -m repro_torch.analysis src/repro_torch` — exit 1 on
unsuppressed findings, 0 otherwise.  `--list-rules` prints the rule table,
`--config-usage` prints the config-registry liveness report,
`--format github` emits workflow annotations, and
`--baseline FILE` fails only on findings NOT recorded in the baseline
(refresh it with `--update-baseline`).  The reference's CLI, with the
same flags and exit codes."""
from __future__ import annotations

import argparse
import collections
import json
import pathlib
import sys

from repro_torch.analysis.core import (Finding, RULE_DOCS, find_repo_root,
                                       run_paths)


def _gh_escape(text: str) -> str:
    return (text.replace("%", "%25").replace("\r", "%0D")
            .replace("\n", "%0A"))


def format_finding(f: Finding, fmt: str, tag: str = None) -> str:
    """`tag` marks a non-gating finding ('suppressed' / 'baseline'):
    text mode prefixes it, github mode demotes ::error to ::notice."""
    if fmt == "github":
        level = "notice" if tag else "error"
        title = f"repro-lint {f.code}" + (f" ({tag})" if tag else "")
        return (f"::{level} file={f.path},line={f.line},"
                f"col={f.col + 1},title={_gh_escape(title)}::"
                f"{f.code} {_gh_escape(f.message)}")
    prefix = f"[{tag}] " if tag else ""
    return prefix + f.format()


def _baseline_key(f: Finding):
    # line numbers drift with unrelated edits; (path, code, message)
    # identifies a triaged finding robustly
    return (f.path, f.code, f.message)


def load_baseline(path: pathlib.Path):
    data = json.loads(path.read_text())
    counts: collections.Counter = collections.Counter()
    for row in data.get("findings", []):
        counts[(row["path"], row["code"], row["message"])] += 1
    return counts


def write_baseline(path: pathlib.Path, findings) -> None:
    rows = [{"path": f.path, "line": f.line, "code": f.code,
             "message": f.message}
            for f in findings]
    path.write_text(json.dumps({"findings": rows}, indent=2,
                               sort_keys=True) + "\n")


def split_against_baseline(findings, counts):
    """(new, baselined): a finding is baselined while its
    (path, code, message) key still has budget in the baseline —
    duplicates beyond the recorded count become new findings."""
    budget = collections.Counter(counts)
    new, baselined = [], []
    for f in findings:
        key = _baseline_key(f)
        if budget[key] > 0:
            budget[key] -= 1
            baselined.append(f)
        else:
            new.append(f)
    return new, baselined


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="repro-lint for the PyTorch/CUDA port: repo-specific "
                    "static analysis")
    ap.add_argument("paths", nargs="*", default=["src/repro_torch"],
                    help="files or directories to analyze (default: "
                         "src/repro_torch)")
    ap.add_argument("--rules", default=None,
                    help="comma-separated subset of rule codes to run")
    ap.add_argument("--list-rules", action="store_true",
                    help="print the rule table and exit")
    ap.add_argument("--config-usage", action="store_true",
                    help="print the config-registry liveness report")
    ap.add_argument("--show-suppressed", action="store_true",
                    help="also print findings silenced by repro-lint "
                         "disable comments")
    ap.add_argument("--format", choices=("text", "github"),
                    default="text", dest="fmt",
                    help="'github' emits ::error workflow annotations "
                         "that land on the PR diff")
    ap.add_argument("--baseline", default=None, metavar="FILE",
                    help="JSON baseline of accepted findings: only NEW "
                         "findings fail the run")
    ap.add_argument("--update-baseline", action="store_true",
                    help="rewrite --baseline with the current findings "
                         "and exit 0")
    args = ap.parse_args(argv)

    if args.list_rules:
        for code, doc in sorted(RULE_DOCS.items()):
            print(f"{code}  {doc}")
        return 0

    if args.config_usage:
        from repro_torch.analysis.imports import (config_usage,
                                                  format_config_usage)
        root = find_repo_root(pathlib.Path(args.paths[0]
                                           if args.paths else "."))
        print(format_config_usage(config_usage(root)))
        return 0

    if args.update_baseline and not args.baseline:
        ap.error("--update-baseline requires --baseline FILE")

    rules = args.rules.split(",") if args.rules else None
    paths = args.paths or ["src/repro_torch"]
    findings, suppressed = run_paths(paths, rules=rules)

    if args.update_baseline:
        write_baseline(pathlib.Path(args.baseline), findings)
        print(f"baseline updated: {len(findings)} finding(s) recorded "
              f"in {args.baseline}")
        return 0

    baselined = []
    if args.baseline and pathlib.Path(args.baseline).exists():
        findings, baselined = split_against_baseline(
            findings, load_baseline(pathlib.Path(args.baseline)))

    for f in findings:
        print(format_finding(f, args.fmt))
    for f in baselined:
        print(format_finding(f, args.fmt, tag="baseline"))
    if args.show_suppressed:
        for f in suppressed:
            print(format_finding(f, args.fmt, tag="suppressed"))
    tail = (f"{len(findings)} finding(s), {len(baselined)} baselined, "
            f"{len(suppressed)} suppressed")
    print(tail if findings or baselined or suppressed
          else f"repro-lint clean ({tail})")
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
