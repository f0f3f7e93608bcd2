"""Baseline file: accepted pre-existing findings that don't block a run
(the port of ``repro.analysis.baseline``).

A finding's fingerprint is ``sha1(rule | path | normalized snippet |
occurrence-index)``: line numbers are deliberately left out, so unrelated
edits above a finding don't invalidate the baseline, while the occurrence
index keeps two identical snippets in one file distinct.

Workflow: ``python -m repro_torch.analysis --update-baseline`` writes the
file; a clean run is "every finding is either suppressed inline (with a
reason) or fingerprint-matched here"; stale entries (baselined but no
longer found) are reported so the file shrinks as debt is paid.  The file
is the port's own (``.torchlint-baseline.json``), never the JAX package's.
"""
from __future__ import annotations

import hashlib
import json
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

from repro_torch.analysis.core import Finding

DEFAULT_BASELINE = ".torchlint-baseline.json"


def _normalize(snippet: str) -> str:
    return " ".join(snippet.split())


def fingerprints(findings: Sequence[Finding]) -> List[Tuple[Finding, str]]:
    """Stable per-finding fingerprints (occurrence-indexed)."""
    seen: Dict[Tuple[str, str, str], int] = {}
    out: List[Tuple[Finding, str]] = []
    for f in sorted(findings, key=lambda f: (f.path, f.line, f.col, f.rule)):
        key = (f.rule, f.path, _normalize(f.snippet))
        idx = seen.get(key, 0)
        seen[key] = idx + 1
        digest = hashlib.sha1(
            "|".join([*key, str(idx)]).encode()).hexdigest()[:16]
        out.append((f, digest))
    return out


def load(path: Path) -> Dict[str, Dict]:
    """fingerprint -> entry ({rule, path, snippet})."""
    if not path.exists():
        return {}
    data = json.loads(path.read_text())
    return {e["fingerprint"]: e for e in data.get("findings", [])}


def save(path: Path, findings: Sequence[Finding]) -> int:
    entries = [{"fingerprint": fp, "rule": f.rule, "path": f.path,
                "snippet": _normalize(f.snippet)}
               for f, fp in fingerprints(findings)]
    path.write_text(json.dumps(
        {"comment": "accepted pre-existing torchlint findings; regenerate "
                    "with `python -m repro_torch.analysis "
                    "--update-baseline`",
         "findings": entries}, indent=2) + "\n")
    return len(entries)


def split(findings: Sequence[Finding], baseline: Dict[str, Dict]
          ) -> Tuple[List[Finding], List[Finding], List[Dict]]:
    """(new, baselined, stale-entries)."""
    new: List[Finding] = []
    matched: List[Finding] = []
    used: set = set()
    for f, fp in fingerprints(findings):
        if fp in baseline:
            matched.append(f)
            used.add(fp)
        else:
            new.append(f)
    stale = [e for fp, e in baseline.items() if fp not in used]
    return new, matched, stale
