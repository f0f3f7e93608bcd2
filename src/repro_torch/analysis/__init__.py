"""torchlint: static analysis of the PyTorch port for this repo's bug
classes (the port of ``repro.analysis``).

Run it::

    python -m repro_torch.analysis             # src/repro_torch, examples_torch
    python -m repro_torch.analysis --catalog   # rule catalog
    python -m repro_torch.analysis --format json src/repro_torch

Everything here is stdlib-only (``ast``, ``re``, ``json``, ``pathlib``):
importing this package never pulls in torch or numpy (nor jax, nor the JAX
package ``repro``), so linting costs milliseconds and needs no device.
Its suppression marker (``# torchlint: disable=R00x — why``) and baseline
(``.torchlint-baseline.json``) are its own: neither linter honours the
other's.

Why a bespoke linter: generic tools can't know that ``self.<attr>`` read
inside a step body captured into a CUDA graph is a frozen tensor once a
method outside the capture rebinds the attribute (the frozen-reference
class), or that eight ``.item()`` calls per train step are eight device
round-trips (the per-metric sync class).  Those classes are mechanical
given two repo-specific facts the :class:`~repro_torch.analysis.scopes
.ScopeGraph` recovers from source: which functions run inside a capture
(``with torch.cuda.graph``, ``make_graphed_callables``) or again in a
checkpoint's backward, including through wrapper functions, and which
``self.<attr>`` s each class family rebinds.

Adding a rule (registry-style, like every other component)::

    # src/repro_torch/analysis/rules.py
    @register_rule
    class R008MyRule(Rule):
        id = "R008"                      # unique, R\\d{3}
        name = "my-rule"                 # kebab-case, shown in reports
        rationale = "one line: the bug class and why it matters"

        def check(self, module, graph):  # yield Finding objects
            for fi in graph.module_functions(module):
                if graph.is_captured(fi) and _looks_wrong(fi):
                    yield self.finding(module, fi.node, "explain the fix")

The CLI discovers rules through the registry, suppressions and the
baseline work immediately, and ``--catalog`` picks up the rationale.  Add
flagged and clean fixtures in ``tests/test_torch_analysis.py``.
"""
from repro_torch.analysis.core import Finding, Module, Rule, Suppression, \
    all_rules, register_rule, rule_ids
from repro_torch.analysis.scopes import ScopeGraph

# rule modules register on import
from repro_torch.analysis import rules as _rules  # noqa: F401  (side effect)

__all__ = ["Finding", "Module", "Rule", "Suppression", "all_rules",
           "register_rule", "rule_ids", "ScopeGraph"]
