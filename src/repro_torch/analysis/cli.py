"""``python -m repro_torch.analysis``: run the linter (the port of
``repro.analysis.cli``).

Exit status is 0 iff every finding is either inline-suppressed (with a
justification) or fingerprint-matched in the committed baseline.  Stale
baseline entries never fail the run but are always reported.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.analysis import baseline as bl
from repro_torch.analysis.core import Finding, Module, Suppression, all_rules
from repro_torch.analysis.rules import NOT_PORTED
from repro_torch.analysis.scopes import ScopeGraph

DEFAULT_PATHS = ["src/repro_torch", "examples_torch"]


def collect_files(paths: Sequence[str]) -> List[Path]:
    files: List[Path] = []
    for p in paths:
        path = Path(p)
        if path.is_dir():
            files.extend(sorted(
                f for f in path.rglob("*.py")
                if "__pycache__" not in f.parts
                and not any(part.startswith(".") for part in f.parts)))
        elif path.suffix == ".py":
            files.append(path)
    return files


def _rel(path: Path) -> str:
    try:
        return path.resolve().relative_to(Path.cwd()).as_posix()
    except ValueError:
        return path.as_posix()


def parse_modules(files: Sequence[Path]) -> Tuple[List[Module], List[str]]:
    modules: List[Module] = []
    errors: List[str] = []
    for f in files:
        try:
            modules.append(Module.parse(f, rel=_rel(f)))
        except SyntaxError as e:                      # pragma: no cover
            errors.append(f"{f}: {e}")
    return modules, errors


def run_modules(modules: Sequence[Module]
                ) -> Tuple[List[Finding], List[Finding], ScopeGraph]:
    """(reportable, suppressed, graph) over already-parsed modules."""
    graph = ScopeGraph(modules)
    sup_by_rel: Dict[str, List[Suppression]] = {
        m.rel: m.suppressions for m in modules}
    reportable: List[Finding] = []
    suppressed: List[Finding] = []
    for mod in modules:
        for rule in all_rules():
            for finding in rule.check(mod, graph):
                if any(s.covers(finding)
                       for s in sup_by_rel.get(finding.path, [])):
                    suppressed.append(finding)
                else:
                    reportable.append(finding)
    reportable.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    suppressed.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return reportable, suppressed, graph


def run_paths(paths: Sequence[str]
              ) -> Tuple[List[Finding], List[Finding], ScopeGraph]:
    """Convenience for tests: lint ``paths``, return (reportable,
    suppressed, graph)."""
    modules, _ = parse_modules(collect_files(paths))
    return run_modules(modules)


def _print_catalog() -> None:
    for rule in all_rules():
        print(f"{rule.id} {rule.name}")
        print(f"     {rule.rationale}")
    for rid, (name, why) in sorted(NOT_PORTED.items()):
        print(f"{rid} {name} (the JAX package's; no port rule)")
        print(f"     {why}")


def _print_suppressions(modules: Sequence[Module]) -> int:
    n = 0
    for mod in modules:
        for s in mod.suppressions:
            n += 1
            rules = ",".join(s.rules) or "<none>"
            reason = s.reason or "<MISSING JUSTIFICATION>"
            print(f"{mod.rel}:{s.line}: {rules} — {reason}")
    print(f"{n} suppression(s)")
    return 0


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="torchlint: static analysis of the PyTorch port for "
                    "this repo's bug classes (stdlib-only, no torch import)")
    ap.add_argument("paths", nargs="*", default=None,
                    help=f"files/dirs to lint (default: {DEFAULT_PATHS})")
    ap.add_argument("--format", choices=("text", "json"), default="text")
    ap.add_argument("--baseline", default=bl.DEFAULT_BASELINE,
                    help="baseline file of accepted findings")
    ap.add_argument("--no-baseline", action="store_true",
                    help="ignore the baseline file entirely")
    ap.add_argument("--update-baseline", action="store_true",
                    help="accept all current findings into the baseline")
    ap.add_argument("--list-suppressions", action="store_true",
                    help="list every inline suppression and exit")
    ap.add_argument("--catalog", action="store_true",
                    help="print the rule catalog and exit")
    args = ap.parse_args(argv)

    if args.catalog:
        _print_catalog()
        return 0

    t0 = time.monotonic()
    modules, errors = parse_modules(
        collect_files(args.paths or DEFAULT_PATHS))
    for e in errors:
        print(f"parse error: {e}", file=sys.stderr)

    if args.list_suppressions:
        return _print_suppressions(modules)

    findings, suppressed, _ = run_modules(modules)

    base_path = Path(args.baseline)
    if args.update_baseline:
        n = bl.save(base_path, findings)
        print(f"wrote {n} finding(s) to {base_path}")
        return 0

    base = {} if args.no_baseline else bl.load(base_path)
    new, matched, stale = bl.split(findings, base)

    dt = time.monotonic() - t0
    if args.format == "json":
        print(json.dumps({
            "new": [f.to_dict() for f in new],
            "baselined": [f.to_dict() for f in matched],
            "suppressed": [f.to_dict() for f in suppressed],
            "stale_baseline": stale,
            "files": len(modules),
            "seconds": round(dt, 3),
        }, indent=2))
    else:
        for f in new:
            print(f"{f.location()}: {f.rule} [{_rule_name(f.rule)}] "
                  f"{f.message}")
            if f.snippet:
                print(f"    {f.snippet}")
        for e in stale:
            print(f"stale baseline entry: {e['rule']} {e['path']} "
                  f"`{e['snippet']}` — no longer found, prune with "
                  "--update-baseline")
        print(f"torchlint: {len(modules)} file(s), {len(new)} new, "
              f"{len(matched)} baselined, {len(suppressed)} suppressed, "
              f"{len(stale)} stale baseline entr(ies) [{dt:.2f}s]")
    return 1 if new else 0


def _rule_name(rule_id: str) -> str:
    for rule in all_rules():
        if rule.id == rule_id:
            return rule.name
    return "?"


if __name__ == "__main__":                            # pragma: no cover
    raise SystemExit(main())
