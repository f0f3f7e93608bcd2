"""repro_torch.analysis (torchlint): the port's bug-class linter, held
against the JAX package's linter (``repro.analysis``, jaxlint) where the
two share a rule, and on fixtures of its own where the port's PyTorch
shapes differ.

* Every port rule (R000, R001, R002, R003, R007) has flagged and clean
  fixtures, including the two ``BaseTrainer`` attribute shapes in
  miniature (``_draw_rows``: rebound only inside the captured step, clean;
  ``_reward_prefetch``: rebound outside it too, flagged).
* Parity: the reference's R002, R003 and R007 fixtures
  (``tests/test_analysis.py``), translated line for line to PyTorch, get
  the reference's verdict at the same lines; ``parse_suppressions`` gives
  the same records with only the marker word swapped; the baseline's
  fingerprints and split give the same records.
* The scope graph on the repository itself: ``FusedStep``'s capture of
  ``tr._step_body`` resolves to ``BaseTrainer._step_body`` and marks the
  rollout, the rewards, the update and every trainer's ``loss_fn``
  captured; the two ``checkpoint`` sites mark their functions recomputed.
* The self-run over ``src/repro_torch`` is clean, and the package imports
  and runs with torch, numpy, jax and repro blocked.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro.analysis import baseline as ref_bl
from repro.analysis.cli import run_paths as ref_run_paths
from repro.analysis.core import Finding as RefFinding
from repro.analysis.core import parse_suppressions as ref_parse_suppressions
from repro_torch.analysis import ScopeGraph, rule_ids
from repro_torch.analysis import baseline as bl
from repro_torch.analysis.cli import main as cli_main, run_paths
from repro_torch.analysis.core import Finding, Module, parse_suppressions
from repro_torch.analysis.rules import NOT_PORTED
from repro_torch.analysis.scopes import CAPTURED, RECOMPUTED

ROOT = Path(__file__).resolve().parent.parent
PORT_IDS = {"R000", "R001", "R002", "R003", "R007"}
REFERENCE_IDS = {f"R00{i}" for i in range(8)}


def lint(tmp_path: Path, source: str, name: str = "mod.py"):
    """Write one fixture module, lint it, return reportable findings."""
    f = tmp_path / name
    f.write_text(source)
    findings, _, _ = run_paths([str(f)])
    return findings


def verdict(findings):
    return sorted({(f.rule, f.line) for f in findings})


def graph_of(tmp_path: Path, source: str):
    f = tmp_path / "mod.py"
    f.write_text(source)
    mod = Module.parse(f)
    graph = ScopeGraph([mod])
    return graph, {fi.qualname: fi for fi in graph.module_functions(mod)}


# ------------------------------------------------------------------- R001

R001_FLAGGED = {
    "two_generators_one_seed": ("""\
import torch

def sample(seed):
    g1 = torch.Generator().manual_seed(seed)
    g2 = torch.Generator().manual_seed(seed)
    return torch.randn(3, generator=g1) + torch.rand(3, generator=g2)
""", [5]),
    "reseeded_generator": ("""\
import torch

def sample(seed):
    g = torch.Generator()
    g.manual_seed(seed)
    a = torch.randn(3, generator=g)
    g.manual_seed(seed)
    return a + torch.randn(3, generator=g)
""", [7]),
    "loop_reuse": ("""\
import torch

def noisy(seed, n):
    out = []
    for i in range(n):
        g = torch.Generator().manual_seed(seed)
        out.append(torch.randn(3, generator=g))
    return out
""", [6]),
    "comprehension_reuse": ("""\
import torch

def gens(seed, k):
    return [torch.Generator().manual_seed(seed) for _ in range(k)]
""", [4]),
    "global_generator": ("""\
import torch

def twice(seed):
    torch.manual_seed(seed)
    a = torch.randn(3)
    torch.manual_seed(seed)
    return a, torch.randn(3)
""", [6]),
}

R001_CLEAN = {
    "fold_seed_distinct_i": """\
import torch
from repro_torch.core.rollout import fold_seed

def sample(seed):
    g1 = torch.Generator().manual_seed(fold_seed(seed, 0))
    g2 = torch.Generator().manual_seed(fold_seed(seed, 1))
    return torch.randn(3, generator=g1) + torch.rand(3, generator=g2)
""",
    "fold_seed_loop_index": """\
import torch
from repro_torch.core.rollout import fold_seed

def noisy(seed, n):
    out = []
    for i in range(n):
        g = torch.Generator().manual_seed(fold_seed(seed, i))
        out.append(torch.randn(3, generator=g))
    return out
""",
    "comprehension_over_seeds": """\
import torch

def gens(seeds):
    return [torch.Generator().manual_seed(s) for s in seeds]
""",
    "exclusive_branches": """\
import torch

def sample(seed, how):
    if how == "uniform":
        g = torch.Generator().manual_seed(seed)
        return torch.rand(3, generator=g)
    if how == "normal":
        g = torch.Generator().manual_seed(seed)
        return torch.randn(3, generator=g)
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, 4, (3,), generator=g)
""",
    "if_else_branches": """\
import torch

def sample(seed, fast):
    if fast:
        g = torch.Generator().manual_seed(seed)
    else:
        g = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn(3, generator=g)
""",
    "seed_rebound_between": """\
import torch

def sample(seed):
    g1 = torch.Generator().manual_seed(seed)
    seed = seed + 1
    g2 = torch.Generator().manual_seed(seed)
    return torch.randn(3, generator=g1) + torch.rand(3, generator=g2)
""",
    "one_generator_never_drawn": """\
import torch

def sample(seed):
    spare = torch.Generator().manual_seed(seed)
    g = torch.Generator().manual_seed(seed)
    return torch.randn(3, generator=g)
""",
}


@pytest.mark.parametrize("case", sorted(R001_FLAGGED))
def test_r001_seed_reuse_flagged(tmp_path, case):
    src, lines = R001_FLAGGED[case]
    assert verdict(lint(tmp_path, src)) == [("R001", ln) for ln in lines]


@pytest.mark.parametrize("case", sorted(R001_CLEAN))
def test_r001_clean(tmp_path, case):
    assert lint(tmp_path, R001_CLEAN[case]) == []


# ------------------------------------------------- reference fixture pairs
# (JAX fixture from tests/test_analysis.py verbatim, its PyTorch
# translation line for line)

PAIRS = {
    "r002_pr5_per_metric_sync_loop": ("""\
import jax

def run(trainer, steps):
    history = []
    for it in range(steps):
        m = jax.device_get(trainer.step(it))
        history.append({
            "reward": float(m["reward_mean"]),
            "loss": float(m["loss"]),
            "grad_norm": float(m["grad_norm"]),
        })
    return history
""", """\
import torch

def run(trainer, steps):
    history = []
    for it in range(steps):
        m = torch.stack(list(trainer.step(it).values())).cpu()
        history.append({
            "reward": float(m[0]),
            "loss": float(m[1]),
            "grad_norm": float(m[2]),
        })
    return history
"""),
    "r002_convert_at_transfer_site": ("""\
import jax

def run(trainer, steps):
    history = []
    for it in range(steps):
        m = jax.tree.map(float, jax.device_get(trainer.step(it)))
        history.append({"reward": m["reward_mean"], "loss": m["loss"]})
    return history
""", """\
import torch

def run(trainer, steps):
    history = []
    for it in range(steps):
        m = dict(zip(trainer.names, torch.stack(list(trainer.step(it).values())).cpu().tolist()))
        history.append({"reward": m["reward_mean"], "loss": m["loss"]})
    return history
"""),
    "r002_sync_on_fresh_device_compute": ("""\
import jax.numpy as jnp

def report(latents):
    return float(jnp.sqrt((latents ** 2).mean()))
""", """\
import torch

def report(latents):
    return float(torch.sqrt((latents ** 2).mean()))
"""),
    "r002_host_floats": ("""\
def run(rows):
    out = []
    for r in rows:
        out.append({"a": float(r["a"]), "b": float(r["b"])})
    return out
""", """\
def run(rows):
    out = []
    for r in rows:
        out.append({"a": float(r["a"]), "b": float(r["b"])})
    return out
"""),
    "r003_pr2_nft_closure_capture": ("""\
import jax

class Trainer:
    def __init__(self):
        self.ref_params = {"w": 1.0}
        self._update_jit = jax.jit(self.loss_fn)

    def update_extras(self):
        self.ref_params = {"w": 2.0}   # refresh the reference policy

    def loss_fn(self, params):
        ref = self.ref_params
        return params["w"] - ref["w"]
""", """\
import torch

class Trainer:
    def __init__(self):
        self.ref_params = {"w": torch.ones(())}
        self._update = torch.cuda.make_graphed_callables(self.loss_fn, (torch.ones(()),))

    def update_extras(self):
        self.ref_params = {"w": 2 * torch.ones(())}   # refresh the reference policy

    def loss_fn(self, params):
        ref = self.ref_params
        return params["w"] - ref["w"]
"""),
    "r003_init_only_attr": ("""\
import jax

class Trainer:
    def __init__(self):
        self.scale = 2.0
        self._fn = jax.jit(self.loss_fn)

    def loss_fn(self, params):
        return params["w"] * self.scale
""", """\
import torch

class Trainer:
    def __init__(self):
        self.scale = 2.0
        self._fn = torch.cuda.make_graphed_callables(self.loss_fn, (torch.ones(()),))

    def loss_fn(self, params):
        return params["w"] * self.scale
"""),
    "r003_nonlocal_rebind_after_def": ("""\
import jax

def build(scale):
    def body(x):
        return x * scale
    scale = scale * 2
    return jax.jit(body)
""", """\
import torch

def build(scale, example):
    def body(x):
        return x * scale
    scale = scale * 2
    return torch.cuda.make_graphed_callables(body, (example,))
"""),
    "r007_pre_pipeline_loop": ("""\
import jax

class Loop:
    def __init__(self, fn, state):
        self._step_jit = jax.jit(fn)
        self.state = state

    def run(self, batches, key):
        history = []
        for it, batch in enumerate(batches):
            self.state, metrics = self._step_jit(self.state, batch, key)
            m = jax.device_get(metrics)
            history.append(m)
        return history
""", """\
import torch

class Loop:
    def __init__(self, fn, state):
        self._step = torch.cuda.make_graphed_callables(fn, (state,))
        self.state = state

    def run(self, batches, seed):
        history = []
        for it, batch in enumerate(batches):
            self.state, metrics = self._step(self.state, batch, seed)
            m = metrics.cpu()
            history.append(m)
        return history
"""),
    "r007_float_on_dispatched_output": ("""\
import jax

def run(step, xs, state):
    step_jit = jax.jit(step)
    losses = []
    for x in xs:
        state, loss = step_jit(state, x)
        losses.append(float(loss))
    return losses
""", """\
import torch

def run(step, xs, state):
    step_fn = torch.cuda.make_graphed_callables(step, (state, xs[0]))
    losses = []
    for x in xs:
        state, loss = step_fn(state, x)
        losses.append(float(loss))
    return losses
"""),
    "r007_lagged_deque_drain": ("""\
import collections
import jax

def run(step, xs, state):
    step_jit = jax.jit(step)
    pending = collections.deque()
    out = []
    for x in xs:
        state, loss = step_jit(state, x)
        pending.append(loss)
        if len(pending) > 1:
            out.append(float(jax.device_get(pending.popleft())))
    while pending:
        out.append(float(jax.device_get(pending.popleft())))
    return out
""", """\
import collections
import torch

def run(step, xs, state):
    step_fn = torch.cuda.make_graphed_callables(step, (state, xs[0]))
    pending = collections.deque()
    out = []
    for x in xs:
        state, loss = step_fn(state, x)
        pending.append(loss)
        if len(pending) > 1:
            out.append(float(pending.popleft().cpu()))
    while pending:
        out.append(float(pending.popleft().cpu()))
    return out
"""),
    "r007_drain_after_loop": ("""\
import jax

def run(step, xs, state):
    step_jit = jax.jit(step)
    losses = []
    for x in xs:
        state, loss = step_jit(state, x)
        losses.append(loss)
    return [float(v) for v in jax.device_get(losses)]
""", """\
import torch

def run(step, xs, state):
    step_fn = torch.cuda.make_graphed_callables(step, (state, xs[0]))
    losses = []
    for x in xs:
        state, loss = step_fn(state, x)
        losses.append(loss)
    return torch.stack(losses).cpu().tolist()
"""),
}

# the reference's verdict on each JAX fixture, as its own test asserts it
PAIR_VERDICTS = {
    "r002_pr5_per_metric_sync_loop": [("R002", 8), ("R002", 9),
                                      ("R002", 10)],
    "r002_convert_at_transfer_site": [],
    "r002_sync_on_fresh_device_compute": [("R002", 4)],
    "r002_host_floats": [],
    "r003_pr2_nft_closure_capture": [("R003", 12)],
    "r003_init_only_attr": [],
    "r003_nonlocal_rebind_after_def": [("R003", 5)],
    "r007_pre_pipeline_loop": [("R007", 12)],
    "r007_float_on_dispatched_output": [("R007", 8)],
    "r007_lagged_deque_drain": [],
    "r007_drain_after_loop": [],
}


@pytest.mark.parametrize("case", sorted(PAIRS))
def test_reference_fixture_same_verdict_same_line(tmp_path, case):
    jax_src, torch_src = PAIRS[case]
    assert len(jax_src.splitlines()) == len(torch_src.splitlines())
    (tmp_path / "jax").mkdir()
    (tmp_path / "torch").mkdir()
    ref_file = tmp_path / "jax" / "mod.py"
    ref_file.write_text(jax_src)
    ref = verdict(ref_run_paths([str(ref_file)])[0])
    assert ref == PAIR_VERDICTS[case]
    assert verdict(lint(tmp_path / "torch", torch_src)) == ref


# ------------------------------------------------------ port R002 fixtures

R002_FLAGGED = {
    "two_items_per_iteration": ("""\
import torch

def report(xs):
    out = []
    for x in xs:
        y = torch.relu(x)
        out.append((y.sum().item(), y.mean().item()))
    return out
""", [7]),
    "two_transfers_per_iteration": ("""\
import torch

def dump(xs):
    out = []
    for x in xs:
        a = torch.relu(x).cpu()
        b = torch.tanh(x).numpy()
        out.append((a, b))
    return out
""", [6, 7]),
}

R002_CLEAN = {
    # one stacked fetch an iteration (api/loop.py's _drain_one)
    "one_stacked_fetch": """\
import torch

def report(xs):
    out = []
    for x in xs:
        vals = torch.stack([torch.relu(x).sum(), torch.tanh(x).sum()]).cpu().tolist()
        out.append((float(vals[0]), float(vals[1])))
    return out
""",
    # float() of values already on the host (api/loop.py's EarlyStop)
    "host_metrics": """\
def on_steps(rows, key):
    best = None
    for metrics in rows:
        val = float(metrics[key])
        best = val if best is None else max(best, float(metrics["loss"]))
    return best
""",
    # a factory without a device is a host tensor
    "host_tensor_factory": """\
import torch

def sizes(shapes):
    return [int(torch.tensor(s).prod()) for s in shapes]
""",
}


@pytest.mark.parametrize("case", sorted(R002_FLAGGED))
def test_r002_port_flagged(tmp_path, case):
    src, lines = R002_FLAGGED[case]
    assert verdict(lint(tmp_path, src)) == [("R002", ln) for ln in lines]


@pytest.mark.parametrize("case", sorted(R002_CLEAN))
def test_r002_port_clean(tmp_path, case):
    assert lint(tmp_path, R002_CLEAN[case]) == []


# ------------------------------------------------------ port R003 fixtures

R003_FLAGGED = {
    "rebound_attr_in_graph_block": ("""\
import torch

class Opt:
    def __init__(self):
        self.lr = torch.zeros(())
        self.graph = torch.cuda.CUDAGraph()

    def set_lr(self, lr):
        self.lr = torch.full((), lr)

    def body(self, x):
        return x * self.lr

    def capture(self, x):
        with torch.cuda.graph(self.graph):
            self.out = self.body(x)
""", [12]),
    # BaseTrainer._reward_prefetch in miniature: read and rebound inside
    # the captured step, and also rebound by a method outside it
    "reward_prefetch_shape": ("""\
import torch

class Trainer:
    def __init__(self):
        self._prefetch = None
        self.graph = torch.cuda.CUDAGraph()

    def prefetch(self, store):
        if self._prefetch is None:
            self._prefetch = [t.to("cuda", non_blocking=True) for t in store]

    def _take(self, store):
        pre, self._prefetch = self._prefetch, None
        return pre if pre is not None else [t.to("cuda") for t in store]

    def _step_body(self, store):
        return self._take(store)

    def capture(self, store):
        with torch.cuda.graph(self.graph):
            self.out = self._step_body(store)
""", [13]),
    "recomputed_checkpoint": ("""\
from torch.utils.checkpoint import checkpoint

class Block:
    def __init__(self):
        self.scale = 1.0

    def set_scale(self, s):
        self.scale = s

    def inner(self, x):
        return x * self.scale

    def forward(self, x):
        return checkpoint(self.inner, x, use_reentrant=False)
""", [11]),
    "nonlocal_in_graph_block": ("""\
import torch

def build(scale, x, graph):
    def body():
        return x * scale
    scale = scale * 2
    with torch.cuda.graph(graph):
        out = body()
    return out
""", [5]),
}

R003_CLEAN = {
    # in-place writes: the captured tensors stay the live ones
    "in_place_writes": """\
import torch

class Opt:
    def __init__(self):
        self.lr = torch.zeros(())
        self.step = torch.zeros((), dtype=torch.int64)
        self.buf = torch.zeros(4)
        self.table = {}
        self.graph = torch.cuda.CUDAGraph()

    def set_lr(self, lr):
        self.lr.fill_(lr)
        self.buf.copy_(torch.ones(4))
        self.buf.zero_()
        self.table["k"] = lr

    def end(self):
        self.step.add_(1)

    def body(self, x):
        return x * self.lr + self.buf + self.step + self.table["k"]

    def capture(self, x):
        with torch.cuda.graph(self.graph):
            self.out = self.body(x)
""",
    # BaseTrainer._draw_rows in miniature: rebound only inside the
    # captured step itself (set and cleared around the loss)
    "draw_rows_shape": """\
import torch

class Trainer:
    def __init__(self):
        self._draw_rows = None
        self.graph = torch.cuda.CUDAGraph()

    def forward_draws(self, x):
        rows = self._draw_rows
        return x if rows is None else x[rows]

    def backward(self, x):
        self._draw_rows = torch.arange(2)
        try:
            return self.forward_draws(x)
        finally:
            self._draw_rows = None

    def _step_body(self, x):
        return self.backward(x)

    def capture(self, x):
        with torch.cuda.graph(self.graph):
            self.out = self._step_body(x)
""",
    "rebound_attr_outside_any_capture": """\
import torch

class Opt:
    def __init__(self):
        self.lr = torch.zeros(())

    def set_lr(self, lr):
        self.lr = torch.full((), lr)

    def body(self, x):
        return x * self.lr
""",
}


@pytest.mark.parametrize("case", sorted(R003_FLAGGED))
def test_r003_port_flagged(tmp_path, case):
    src, lines = R003_FLAGGED[case]
    found = lint(tmp_path, src)
    assert verdict(found) == [("R003", ln) for ln in lines]
    kind = RECOMPUTED if case == "recomputed_checkpoint" else CAPTURED
    assert all(f.message.startswith(kind) for f in found)


@pytest.mark.parametrize("case", sorted(R003_CLEAN))
def test_r003_port_clean(tmp_path, case):
    assert lint(tmp_path, R003_CLEAN[case]) == []


# ------------------------------------------------------ port R007 fixtures

TRAINER = """\
import collections
import torch

class Trainer:
    def __init__(self):
        self.graph = torch.cuda.CUDAGraph()

    def _step_body(self, cond):
        return {"loss": cond.sum()}

    def capture(self, cond):
        with torch.cuda.graph(self.graph):
            self.out = self._step_body(cond)

    def step(self, cond, seed, it=0):
        return self._step_body(cond)

"""
N_TRAINER = len(TRAINER.splitlines())

R007_FLAGGED = {
    "trainer_step_item": ("""\
def run(trainer, conds):
    rows = []
    for it, cond in enumerate(conds):
        m = trainer.step(cond, 0, it=it)
        rows.append(m["loss"].item())
    return rows
""", [5]),
    "synchronize_after_dispatch": ("""\
def run(trainer, conds):
    pending = []
    for it, cond in enumerate(conds):
        pending.append(trainer.step(cond, 0, it=it))
        torch.cuda.synchronize()
    return pending
""", [5]),
    "fused_step_attribute": ("""\
class Fused:
    def __init__(self, trainer):
        self.trainer = trainer
        self.graph = torch.cuda.CUDAGraph()

    def __call__(self, cond):
        with torch.cuda.graph(self.graph):
            return self.trainer._step_body(cond)


class Owner:
    def __init__(self, trainer):
        self._fused = Fused(trainer)

    def run(self, conds):
        out = []
        for cond in conds:
            m = self._fused(cond)
            out.append(m["loss"].cpu())
        return out
""", [19]),
}

R007_CLEAN = {
    # api/loop.py's lagged deque drain: the oldest in-flight step's metrics,
    # stacked and fetched once
    "lagged_deque": """\
def run(trainer, conds, depth):
    pending = collections.deque()
    rows = []
    for it, cond in enumerate(conds):
        pending.append(trainer.step(cond, 0, it=it))
        while len(pending) >= depth:
            m = pending.popleft()
            rows.append(torch.stack(list(m.values())).cpu().tolist())
    while pending:
        rows.append(torch.stack(list(pending.popleft().values())).cpu().tolist())
    return rows
""",
    "drain_after_loop": """\
def run(trainer, conds):
    out = []
    for it, cond in enumerate(conds):
        out.append(trainer.step(cond, 0, it=it)["loss"])
    torch.cuda.synchronize()
    return torch.stack(out).cpu().tolist()
""",
}


@pytest.mark.parametrize("case", sorted(R007_FLAGGED))
def test_r007_port_flagged(tmp_path, case):
    src, lines = R007_FLAGGED[case]
    assert verdict(lint(tmp_path, TRAINER + src)) == [
        ("R007", N_TRAINER + ln) for ln in lines]


@pytest.mark.parametrize("case", sorted(R007_CLEAN))
def test_r007_port_clean(tmp_path, case):
    assert lint(tmp_path, TRAINER + R007_CLEAN[case]) == []


# ----------------------------------------------------- suppressions / R000

REUSE = """\
import torch

def sample(seed):
    a = torch.randn(3, generator=torch.Generator().manual_seed(seed))
    {comment_line}
    b = torch.randn(3, generator=torch.Generator().manual_seed(seed)){trailing}
    return a + b
"""


def test_r000_suppression_with_reason_honored(tmp_path):
    src = REUSE.format(comment_line="# torchlint: disable=R001 — deliberate "
                                    "common random numbers", trailing="")
    findings, suppressed, _ = run_paths([str(_write(tmp_path, src))])
    assert findings == [] and verdict(suppressed) == [("R001", 6)]


def test_r000_suppression_without_reason_is_a_finding(tmp_path):
    src = REUSE.format(comment_line="",
                       trailing="  # torchlint: disable=R001")
    # the bare disable= is itself flagged AND does not suppress
    assert verdict(lint(tmp_path, src)) == [("R000", 6), ("R001", 6)]


def test_r000_suppression_in_docstring_is_prose(tmp_path):
    findings = lint(tmp_path, '''\
def helper():
    """Mentions `# torchlint: disable=R001` as documentation only."""
    return 1
''')
    assert findings == []
    assert Module.parse(tmp_path / "mod.py").suppressions == []


def test_r000_multiline_standalone_suppression(tmp_path):
    src = REUSE.format(
        comment_line="# torchlint: disable=R001 — first half of the why,\n"
                     "    # wrapped onto a continuation comment line",
        trailing="")
    assert lint(tmp_path, src) == []


@pytest.mark.parametrize("rid", ["R999", "R004"])
def test_r000_unknown_rule_id_flagged(tmp_path, rid):
    # R004 is the JAX package's rule: the port has none to suppress
    findings = lint(tmp_path, f"x = 1  # torchlint: disable={rid} — why\n")
    assert verdict(findings) == [("R000", 1)]


def test_r000_markers_do_not_cross(tmp_path):
    """Neither linter honours the other's suppression marker."""
    src = REUSE.format(comment_line="# jaxlint: disable=R001 — not ours",
                       trailing="")
    assert verdict(lint(tmp_path, src)) == [("R001", 6)]
    ref_src = ("import jax\n\ndef sample(key):\n"
               "    a = jax.random.normal(key, (3,))\n"
               "    # torchlint: disable=R001 — not the reference's\n"
               "    b = jax.random.normal(key, (3,))\n    return a + b\n")
    ref_file = _write(tmp_path, ref_src, "ref.py")
    assert verdict(ref_run_paths([str(ref_file)])[0]) == [("R001", 6)]


def test_list_suppressions_mode(tmp_path, capsys):
    f = _write(tmp_path, REUSE.format(
        comment_line="# torchlint: disable=R001 — audit me", trailing=""))
    rc = cli_main(["--list-suppressions", str(f)])
    out = capsys.readouterr().out
    assert rc == 0
    assert "R001" in out and "audit me" in out and "1 suppression(s)" in out


def _write(tmp_path: Path, src: str, name: str = "mod.py") -> Path:
    f = tmp_path / name
    f.write_text(src)
    return f


# ------------------------------------------ parity: suppressions, baseline

SUPPRESSION_SOURCES = [
    "x = 1  # {m}: disable=R001 — trailing, with a reason\n",
    "x = 1  # {m}: disable=R001,R002 -- two ids\n",
    "x = 1  # {m}: disable=R003: colon separator\n",
    "x = 1  # {m}: disable=R002\n",
    "x = 1  # {m}: disable=\n",
    "def f():\n    # {m}: disable=R001 — standalone,\n"
    "    # continued\n\n    return 1\n",
    'def g():\n    """# {m}: disable=R001 — in a docstring"""\n',
]


@pytest.mark.parametrize("i", range(len(SUPPRESSION_SOURCES)))
def test_parse_suppressions_matches_reference(i):
    def records(parse, marker):
        src = SUPPRESSION_SOURCES[i].format(m=marker)
        return [(s.path, s.line, s.applies_to, s.rules, s.reason)
                for s in parse("mod.py", src, src.splitlines())]

    assert records(parse_suppressions, "torchlint") == records(
        ref_parse_suppressions, "jaxlint")


FINDING_FIELDS = [
    ("R002", "a.py", 8, 4, "m", "float(m[0])"),
    ("R002", "a.py", 9, 4, "m", "float(m[0])"),      # same snippet: idx 1
    ("R003", "b.py", 12, 14, "m", "ref  =  self.ref_params"),
    ("R007", "a.py", 3, 0, "m", ""),
]


def test_baseline_fingerprints_and_split_match_reference(tmp_path):
    mine = [Finding(*f) for f in FINDING_FIELDS]
    ref = [RefFinding(*f) for f in FINDING_FIELDS]
    assert [fp for _, fp in bl.fingerprints(mine)] == \
        [fp for _, fp in ref_bl.fingerprints(ref)]
    # a baseline of the first two, written by each package
    bl.save(tmp_path / "mine.json", mine[:2])
    ref_bl.save(tmp_path / "ref.json", ref[:2])
    base, ref_base = (bl.load(tmp_path / "mine.json"),
                      ref_bl.load(tmp_path / "ref.json"))
    assert set(base) == set(ref_base)
    got = bl.split(mine[1:], base)
    want = ref_bl.split(ref[1:], ref_base)
    assert [[f.to_dict() for f in part] for part in got[:2]] == \
        [[f.to_dict() for f in part] for part in want[:2]]
    assert got[2] == want[2] and len(got[2]) == 1


# ---------------------------------------------------------------- baseline

def test_baseline_roundtrip_and_staleness(tmp_path):
    src = PAIRS["r002_pr5_per_metric_sync_loop"][1]
    f = _write(tmp_path, src)
    findings, _, _ = run_paths([str(f)])
    assert len(findings) == 3
    base_file = tmp_path / "base.json"
    bl.save(base_file, findings)
    base = bl.load(base_file)
    new, matched, stale = bl.split(findings, base)
    assert new == [] and len(matched) == len(findings) and stale == []
    # fingerprints survive a pure line shift
    f.write_text("# a new leading comment\n" + src)
    shifted, _, _ = run_paths([str(f)])
    new, matched, stale = bl.split(shifted, base)
    assert new == [] and len(matched) == len(findings) and stale == []
    # fixing the bug makes the entries stale, not failing
    f.write_text("def run():\n    return []\n")
    fixed, _, _ = run_paths([str(f)])
    new, matched, stale = bl.split(fixed, base)
    assert new == [] and matched == [] and len(stale) == len(findings)


def test_cli_json_format_and_exit_codes(tmp_path, capsys, monkeypatch):
    f = _write(tmp_path, PAIRS["r002_pr5_per_metric_sync_loop"][1])
    monkeypatch.chdir(tmp_path)
    rc = cli_main(["--format", "json", "--no-baseline", str(f)])
    payload = json.loads(capsys.readouterr().out)
    assert rc == 1
    assert set(payload) == {"new", "baselined", "suppressed",
                            "stale_baseline", "files", "seconds"}
    assert {x["rule"] for x in payload["new"]} == {"R002"}
    assert payload["files"] == 1
    # accept into a baseline (the port's own file) -> clean exit
    rc = cli_main(["--update-baseline", str(f)])
    capsys.readouterr()
    assert rc == 0 and (tmp_path / ".torchlint-baseline.json").exists()
    rc = cli_main([str(f)])
    out = capsys.readouterr().out
    assert rc == 0 and "0 new, 3 baselined" in out
    rc = cli_main(["--format", "json", str(f)])
    payload = json.loads(capsys.readouterr().out)
    assert rc == 0 and len(payload["baselined"]) == 3


# -------------------------------------------------------- scope graph unit

def test_wrapper_layer_graph_block_through_helper(tmp_path):
    """A parameter that flows into ``torch.cuda.graph`` through a helper:
    both layers become wrappers, and their call sites capture the
    argument."""
    graph, fns = graph_of(tmp_path, """\
import torch

def _capture(fn, graph, pool=None):
    with torch.cuda.graph(graph, pool=pool):
        out = fn()
    return out

def capture_step(fn, graph):
    return _capture(fn, graph)

def _body():
    return torch.ones(())

def host_side(rows):
    return len(rows)

def build(graph):
    return capture_step(_body, graph)
""")
    assert graph.is_captured(fns["_body"])
    assert not graph.is_captured(fns["host_side"])
    assert not graph.is_captured(fns["build"])
    for name in ("_capture", "capture_step"):
        assert graph.wrapper_positions[id(fns[name].node)] == {CAPTURED: {0}}


def test_wrapper_layer_checkpoint_and_local_binding(tmp_path):
    """``checkpoint`` of a parameter makes a recompute wrapper, and a local
    name bound through ``for fn, args in units`` (the backbone's shape)
    resolves to what the list holds, ``functools.partial`` included."""
    graph, fns = graph_of(tmp_path, """\
import functools
from torch.utils.checkpoint import checkpoint

def remat(fn, *args):
    return checkpoint(fn, *args, use_reentrant=False)

def _layer(p, x):
    return x * p

def _other(p, x):
    return x + p

def _plain(x):
    return x

def forward(ps, x):
    units = [(_layer, (p,)) for p in ps]
    units += [(functools.partial(_other, 1.0), ())]
    for fn, args in units:
        x = checkpoint(fn, *args, x)
    return remat(_plain, x)
""")
    assert graph.wrapper_positions[id(fns["remat"].node)] == {RECOMPUTED: {0}}
    for name in ("_layer", "_other", "_plain"):
        assert graph.is_recomputed(fns[name]) and not graph.is_captured(
            fns[name])
    assert not graph.is_recomputed(fns["forward"])


def test_wrapper_reached_through_a_held_object_and_a_factory(tmp_path):
    """The serving engine's shape: a capture wrapper reached as a method of
    an object held in ``self`` (bound in a conditional expression), its
    function argument a local bound to what a method returns, which is
    what a factory returns (its nested ``run``), stored in and read back
    from a dict on ``self``.  The factory's ``run`` and what it calls are
    captured; the host side is not."""
    graph, fns = graph_of(tmp_path, """\
import torch

class GraphCache:
    def __init__(self, device):
        self.device = device

    def capture(self, key, static, fn, *args, **kwargs):
        with torch.cuda.graph(torch.cuda.CUDAGraph()):
            out = fn(*args, **kwargs)
        return out

def rollout_keyed(params, cond):
    return cond * params

def make_rollout(mesh):
    def run(params, cond):
        return rollout_keyed(params, cond)
    return run

def host_side(rows):
    return len(rows)

class Engine:
    def __init__(self, device):
        self._graphs = GraphCache(device) if device == "cuda" else None
        self._fns = {}

    def _fn(self, steps):
        fn = self._fns.get(steps)
        if fn is None:
            fn = self._fns[steps] = make_rollout(None)
        return fn

    def _run(self, params, cond, steps):
        fn = self._fn(steps)
        host_side([cond])
        return self._graphs.capture((steps,), {}, fn, params, cond)
""")
    assert graph.wrapper_positions[id(fns["GraphCache.capture"].node)] == \
        {CAPTURED: {2}}
    for name in ("make_rollout.run", "rollout_keyed"):
        assert graph.is_captured(fns[name]), name
    for name in ("host_side", "make_rollout", "Engine._fn"):
        assert not graph.is_captured(fns[name]), name


@pytest.fixture(scope="module")
def repo_graph():
    old = Path.cwd()
    try:
        os.chdir(ROOT)
        return run_paths(["src/repro_torch"])[2]
    finally:
        os.chdir(old)


def _qual(graph, ids):
    return {f"{graph.functions[i].module.rel}:{graph.functions[i].qualname}"
            for i in ids}


def test_repo_fused_step_captures_the_step_body(repo_graph):
    """perf/fused.py's ``tr._step_body`` inside ``torch.cuda.graph``
    resolves to ``BaseTrainer._step_body``, which reaches the rollout, the
    rewards, the update and the loss of each of the five trainers."""
    g = repo_graph
    base = "src/repro_torch/core/trainers/"
    assert _qual(g, g.roots[CAPTURED]) == {
        base + "base.py:BaseTrainer._step_body",
        "src/repro_torch/distributed/shard.py:"
        "make_rollout_keyed_sharded.run"}
    captured = _qual(g, g.reached[CAPTURED])
    for name in ("_sample", "_rewards", "_update", "backward", "apply_grads"):
        assert f"{base}base.py:BaseTrainer.{name}" in captured
    trainers = {"FlowGRPOTrainer": "grpo", "MixGRPOTrainer": "mix_grpo",
                "GRPOGuardTrainer": "grpo_guard",
                "DiffusionNFTTrainer": "nft", "AWMTrainer": "awm"}
    for cls in trainers:
        (ci,) = g.classes[cls]
        owner = ci if "loss_fn" in ci.methods else g.classes[ci.bases[0]][0]
        assert id(owner.methods["loss_fn"].node) in g.reached[CAPTURED], cls


def test_repo_engine_rollout_is_captured(repo_graph):
    """serving/engine.py captures its executor through ``GraphCache.capture``
    (perf/graphs.py): ``self._graphs.capture(key, static, fn, ...)`` with
    ``fn = self._fn(...)``, the value of ``distributed
    .make_rollout_keyed_sharded``, whose nested ``run`` calls
    ``rollout_keyed``.  The port's graph marks both captured, as the
    reference's marks ``rollout_keyed`` traced."""
    g = repo_graph
    captured = _qual(g, g.reached[CAPTURED])
    assert "src/repro_torch/core/rollout.py:rollout_keyed" in captured
    assert "src/repro_torch/distributed/shard.py:" \
        "make_rollout_keyed_sharded.run" in captured
    assert "src/repro_torch/models/flow.py:FlowAdapter.velocity" in captured
    old = Path.cwd()
    try:
        os.chdir(ROOT)
        ref = ref_run_paths(["src/repro"])[2]
    finally:
        os.chdir(old)
    (fi,) = [f for f in ref.functions.values()
             if f.module.rel == "src/repro/core/rollout.py"
             and f.qualname == "rollout_keyed"]
    assert ref.is_traced(fi)


def test_repo_checkpoint_sites_are_recomputed(repo_graph):
    """models/backbone.py's ``checkpoint(fn, ...)`` (``fn`` from the
    ``units`` list) and models/layers.py's ``checkpoint(_chunk_ce, ...)``."""
    g = repo_graph
    roots = _qual(g, g.roots[RECOMPUTED])
    assert {"src/repro_torch/models/backbone.py:Backbone.forward_embeds.run",
            "src/repro_torch/models/backbone.py:"
            "Backbone.forward_embeds.run_group",
            "src/repro_torch/models/layers.py:_chunk_ce"} <= roots
    reached = _qual(g, g.reached[RECOMPUTED])
    assert "src/repro_torch/models/backbone.py:Backbone._dense_block" in \
        reached


# ------------------------------------------------------- catalog / imports

def test_every_port_rule_has_fixture_coverage():
    assert set(rule_ids()) == PORT_IDS, (
        "rule registered or removed: add flagged and clean fixtures for it "
        "in this file and update PORT_IDS")
    assert set(NOT_PORTED) == REFERENCE_IDS - PORT_IDS


def test_catalog_lists_every_reference_id(capsys):
    assert cli_main(["--catalog"]) == 0
    out = capsys.readouterr().out
    listed = {line.split()[0] for line in out.splitlines()
              if line.startswith("R")}
    assert listed == REFERENCE_IDS
    for rid in NOT_PORTED:
        assert f"{rid} {NOT_PORTED[rid][0]} (the JAX package's; no port " \
               "rule)" in out


def test_repo_is_clean_modulo_baseline(monkeypatch, capsys):
    """Any future change reintroducing a linted bug class fails here."""
    monkeypatch.chdir(ROOT)
    rc = cli_main(["--format", "json"])
    payload = json.loads(capsys.readouterr().out)
    assert rc == 0, f"torchlint found new violations: {payload['new']}"
    assert payload["files"] == sum(
        len(list((ROOT / d).rglob("*.py")))
        for d in ("src/repro_torch", "examples_torch"))


def test_analysis_runs_with_torch_numpy_jax_repro_blocked():
    """``python -m repro_torch.analysis`` needs no third-party module and
    nothing of the JAX package."""
    code = (
        "import sys\n"
        "for m in ('torch', 'numpy', 'jax', 'repro'):\n"
        "    sys.modules[m] = None\n"
        "import repro_torch.analysis\n"
        "from repro_torch.analysis.cli import main\n"
        "rc = main(['src/repro_torch'])\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('torch', 'numpy', 'jax', 'repro') and sys.modules[m] is not None)\n"
        "assert not bad, bad\n"
        "print('rc', rc)\n")
    proc = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        cwd=str(ROOT), timeout=120,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"})
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "rc 0"
