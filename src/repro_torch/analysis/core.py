"""Shared plumbing for the ``torchlint`` static analyzer (the port of
``repro.analysis.core``).

Stdlib only (``ast``/``re``/``dataclasses``): this module must import on a
bare interpreter with torch and numpy blocked, so linting never pays
torch's import or a device's start-up.

Pieces:

- :class:`Finding`: one diagnostic (rule id, location, message, snippet).
- :class:`Rule` + :func:`register_rule`: the rule registry.  A rule
  registers itself by id and the CLI discovers it; adding a rule never
  touches the CLI.
- :class:`Suppression` / :func:`parse_suppressions`: inline
  ``# torchlint: disable=R00x — <why>`` comments.  A justification is
  required: a bare ``disable=`` is itself reported (rule R000), so accepted
  risk always carries its rationale in the diff.  The marker word differs
  from the JAX package's linter, so neither linter honours the other's
  suppressions.
- :class:`Module`: one parsed source file (ast, raw lines, its
  suppressions), the unit every rule's ``check`` receives.
"""
from __future__ import annotations

import ast
import io
import re
import tokenize
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Tuple

MARKER = "torchlint"


@dataclass(frozen=True)
class Finding:
    rule: str          # "R002"
    path: str          # display path (relative to the lint root)
    line: int          # 1-based
    col: int           # 0-based
    message: str
    snippet: str = ""  # stripped source line, for fingerprints + review

    def location(self) -> str:
        return f"{self.path}:{self.line}:{self.col}"

    def to_dict(self) -> Dict:
        return {"rule": self.rule, "path": self.path, "line": self.line,
                "col": self.col, "message": self.message,
                "snippet": self.snippet}


@dataclass(frozen=True)
class Suppression:
    path: str
    line: int            # line the comment sits on
    applies_to: int      # line the suppression covers (the next code line
                         # if the comment stands alone)
    rules: Tuple[str, ...]
    reason: str          # "" == unjustified -> R000

    def covers(self, finding: Finding) -> bool:
        return (finding.path == self.path
                and finding.line == self.applies_to
                and finding.rule in self.rules
                and bool(self.reason))


# --------------------------------------------------------------------- rules

class Rule:
    """Subclass contract: set ``id`` (R0xx), ``name`` (kebab-case) and
    ``rationale`` (one line, shown by ``--catalog``), and implement
    ``check(module, graph)`` yielding :class:`Finding` s.  Register with
    ``@register_rule``: the CLI picks it up automatically."""

    id: str = ""
    name: str = ""
    rationale: str = ""

    def check(self, module: "Module", graph) -> Iterator[Finding]:
        raise NotImplementedError

    def finding(self, module: "Module", node: ast.AST, message: str
                ) -> Finding:
        line = getattr(node, "lineno", 1)
        col = getattr(node, "col_offset", 0)
        snippet = ""
        if 1 <= line <= len(module.lines):
            snippet = module.lines[line - 1].strip()
        return Finding(self.id, module.rel, line, col, message, snippet)


_RULES: Dict[str, Rule] = {}
_ID_RE = re.compile(r"^R\d{3}$")


def register_rule(cls):
    """Class decorator: instantiate and register a :class:`Rule` by id."""
    inst = cls()
    if not _ID_RE.match(inst.id or ""):
        raise ValueError(f"rule id must match R\\d{{3}}, got {inst.id!r}")
    if not inst.name or not inst.rationale:
        raise ValueError(f"rule {inst.id} needs a name and a rationale")
    if inst.id in _RULES and type(_RULES[inst.id]) is not cls:
        raise ValueError(f"rule {inst.id} already registered")
    _RULES[inst.id] = inst
    return cls


def all_rules() -> List[Rule]:
    return [_RULES[rid] for rid in sorted(_RULES)]


def rule_ids() -> Tuple[str, ...]:
    return tuple(sorted(_RULES))


# -------------------------------------------------------------- suppressions

# Format: a hash, then ``torchlint: disable=R001,R002 — reason`` ("--",
# "-" and ":" also accepted as the separator; the reason may not be
# empty).  Real COMMENT tokens only (via ``tokenize``): the same text
# inside a docstring is prose.
_SUPPRESS_RE = re.compile(
    r"#\s*" + MARKER + r":\s*disable=\s*([A-Za-z0-9,\s]*?)\s*"
    r"(?:(?:—|--|-|:)\s*(.*))?$")


def parse_suppressions(rel: str, source: str,
                       lines: List[str]) -> List[Suppression]:
    out: List[Suppression] = []
    try:
        tokens = list(tokenize.generate_tokens(
            io.StringIO(source).readline))
    except (tokenize.TokenError, IndentationError):  # pragma: no cover
        return out
    for tok in tokens:
        if tok.type != tokenize.COMMENT or MARKER not in tok.string:
            continue
        m = _SUPPRESS_RE.search(tok.string)
        if not m:
            continue
        rules = tuple(r.strip() for r in m.group(1).split(",") if r.strip())
        reason = (m.group(2) or "").strip()
        line, col = tok.start
        standalone = not lines[line - 1][:col].strip() \
            if line <= len(lines) else False
        applies = line
        if standalone:
            # a standalone suppression covers the next CODE line, so the
            # justification may wrap over several comment lines
            applies = line + 1
            while applies <= len(lines) and (
                    not lines[applies - 1].strip()
                    or lines[applies - 1].lstrip().startswith("#")):
                applies += 1
        out.append(Suppression(rel, line, applies, rules, reason))
    return out


# ------------------------------------------------------------------- modules

@dataclass
class Module:
    path: Path
    rel: str
    source: str
    lines: List[str]
    tree: ast.Module
    suppressions: List[Suppression] = field(default_factory=list)
    dotted: str = ""     # "repro_torch.core.rollout" when under a src root

    @classmethod
    def parse(cls, path: Path, rel: Optional[str] = None) -> "Module":
        src = path.read_text()
        rel = rel or str(path)
        tree = ast.parse(src, filename=rel)
        lines = src.splitlines()
        return cls(path=path, rel=rel, source=src, lines=lines, tree=tree,
                   suppressions=parse_suppressions(rel, src, lines),
                   dotted=_dotted_name(path))


def _dotted_name(path: Path) -> str:
    """Best-effort module path ("repro_torch.core.rollout") for import
    resolution: the parts after a ``src`` dir, else the stem."""
    parts = list(path.with_suffix("").parts)
    if "src" in parts:
        parts = parts[parts.index("src") + 1:]
    else:
        parts = parts[-1:]
    if parts and parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(parts)
