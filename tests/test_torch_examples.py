"""The reference's examples on the port (``examples_torch/``), on the CPU.

Each example of ``examples/`` has a counterpart of the same name that runs
the same ``RunConfig`` through ``repro_torch.api.Experiment``.  Here: the
configs equal the reference's field by field (the e2e's through its
``build_config``, the others' module-level constants read with ``ast``
from the reference's files, which run their work at import); every
example runs through its ``main`` with ``--device cpu`` and raises without
a CUDA device otherwise; the e2e ``--small`` run resumed from a step-2
checkpoint equals an uninterrupted one bitwise, reward log included; its
first ``trainer.step`` equals the reference's on carried params and
injected draws; and ``multi_reward``'s deduplication loads what the
reference's does.  The runs override ``data.encoder`` with a tiny frozen
encoder (the default one is ≈67M parameters), after the config equality
is held on the unmodified configs.  ``chip_smoke.py`` phase 46 runs the
examples at their own sizes on the card.
"""
import argparse
import ast
import dataclasses
import importlib.util
import json
import math
import os
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.config as jconfig
from repro.api import Experiment as JExperiment
from repro_torch.api import Experiment, apply_overrides
from repro_torch.core.trainers import RLState as TRLState
from repro_torch.models import params as tparams
from repro_torch.optim import adamw_init

from torch_parity import to_torch
from torch_parity import one_torch_thread  # noqa: F401  (autouse fixture)

ROOT = Path(__file__).resolve().parents[1]
REF_DIR, PORT_DIR = ROOT / "examples", ROOT / "examples_torch"
NAMES = ("quickstart", "train_grpo_e2e", "multi_reward", "serve_flow")
TINY_ENCODER = json.dumps({"cond_dim": 32, "cond_len": 4, "vocab": 256,
                           "hidden": 64})
# weighted_sum and gdpo each load pickscore and pref_group's shared tower
# once, text_render's and latent_norm's: the count chip_smoke.py holds
# the card's run to (MULTI_REWARD_UNIQUE_LOADS)
UNIQUE_LOADS = 3


def load(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def port_example(name: str):
    return load(PORT_DIR / f"{name}.py", f"port_example_{name}")


def ref_constant(name: str, target: str):
    """The value of ``target = ...`` at the top of the reference's
    ``examples/<name>.py``, evaluated alone over ``repro.config`` (the
    file itself runs its training when imported)."""
    tree = ast.parse((REF_DIR / f"{name}.py").read_text())
    (node,) = [n for n in tree.body if isinstance(n, ast.Assign)
               and any(isinstance(t, ast.Name) and t.id == target
                       for t in n.targets)]
    return eval(compile(ast.Expression(node.value), name, "eval"),
                dict(vars(jconfig)))


def ref_serve_config(arch_name: str, sde: str):
    """The RunConfig the reference's ``serve_flow.make_exp(arch_name,
    sde)`` hands ``Experiment.from_config``."""
    tree = ast.parse((REF_DIR / "serve_flow.py").read_text())
    (fn,) = [n for n in tree.body if isinstance(n, ast.FunctionDef)
             and n.name == "make_exp"]
    (ret,) = [n for n in ast.walk(fn) if isinstance(n, ast.Return)]
    call = ret.value.args[0]
    return eval(compile(ast.Expression(call), "serve_flow", "eval"),
                {**vars(jconfig), "arch_name": arch_name, "sde": sde,
                 "ENCODER": ref_constant("serve_flow", "ENCODER")})


def as_dict(cfg) -> dict:
    return dataclasses.asdict(cfg)


def test_every_reference_example_has_a_port():
    assert sorted(p.name for p in REF_DIR.glob("*.py")) == sorted(
        p.name for p in PORT_DIR.glob("*.py")) == sorted(
        f"{n}.py" for n in NAMES)


@pytest.mark.parametrize("small,steps", [(False, 200), (True, 10),
                                         (True, 4)])
def test_e2e_config_equals_the_reference(small, steps):
    ref = load(REF_DIR / "train_grpo_e2e.py", "ref_train_grpo_e2e")
    port = port_example("train_grpo_e2e")
    args = argparse.Namespace(small=small, steps=steps, out="out/e2e")
    assert as_dict(port.build_config(args)) == as_dict(ref.build_config(args))
    assert port.MODEL_100M == ref.MODEL_100M
    # the CLI's own defaults are the reference's (--device aside)
    ns = vars(port.parse_args([]))
    assert ns.pop("device") == "cuda"
    assert ns == {"steps": 200, "small": False, "out": "experiments/e2e"}


@pytest.mark.parametrize("name,target,port_name", [
    ("quickstart", "cfg", "CONFIG"), ("multi_reward", "BASE", "BASE")])
def test_module_config_equals_the_reference(name, target, port_name):
    assert as_dict(getattr(port_example(name), port_name)) == as_dict(
        ref_constant(name, target))


def test_serve_flow_configs_equal_the_reference():
    port = port_example("serve_flow")
    assert port.ENCODER == ref_constant("serve_flow", "ENCODER")
    for arch_name in port.ARCHS:
        for sde in port.SOLVERS:
            assert as_dict(port.make_config(arch_name, sde)) == as_dict(
                ref_serve_config(arch_name, sde))
    # the reference's loops, prompts and engine size
    src = (REF_DIR / "serve_flow.py").read_text()
    assert 'for arch_name in ("flux_dit", "mamba2-370m")' in src
    assert 'for sde in ("ode", "dance_sde")' in src
    assert port.ARCHS == ("flux_dit", "mamba2-370m")
    assert port.SOLVERS == ("ode", "dance_sde")


def _small_e2e(monkeypatch, *overrides):
    """The e2e example with each config it builds given the tiny encoder
    (and ``overrides``)."""
    mod = port_example("train_grpo_e2e")
    build = mod.build_config
    monkeypatch.setattr(mod, "build_config", lambda args: apply_overrides(
        build(args), ["data.encoder=" + TINY_ENCODER, *overrides]))
    return mod


def _finite(hist) -> bool:
    return all(math.isfinite(v) for r in hist for v in r.values()
               if isinstance(v, float))


def test_e2e_runs_on_cpu(tmp_path, monkeypatch, capsys):
    mod = _small_e2e(monkeypatch)
    out = mod.main(["--device", "cpu", "--small", "--steps", "4",
                    "--out", str(tmp_path)])
    text = capsys.readouterr().out
    assert "[e2e] flow_grpo on flux_dit-reduced (2.4M params), rewards=" \
           "['text_render', 'pickscore', 'latent_norm']" in text
    assert "[done] reward " in text
    hist = out["history"]
    assert [r["step"] for r in hist] == [0, 1, 2, 3] and _finite(hist)
    assert out["experiment"].device.type == "cpu"
    rows = json.loads((tmp_path / "reward_log.json").read_text())
    assert [r["step"] for r in rows] == [0, 1, 2, 3]


def test_e2e_resume_is_bitwise(tmp_path, monkeypatch):
    """The check chip_smoke.py makes at step 100 of 200, at the --small
    size: a second run resumed from a copy of the first run's step-2
    checkpoint (and its reward log as it stood there) ends with the
    params, AdamW moments and step, the rows of steps 2-3 and the reward
    log of the uninterrupted run, bitwise."""
    mod = _small_e2e(monkeypatch, "loop.save_every=2")
    argv = ["--device", "cpu", "--small", "--steps", "4", "--out"]
    a, b = tmp_path / "a", tmp_path / "b"
    ra = mod.main(argv + [str(a)])
    (b / "ckpt").mkdir(parents=True)
    for f in os.listdir(a / "ckpt"):
        if f.startswith("step_00000002"):
            shutil.copy(a / "ckpt" / f, b / "ckpt" / f)
    shutil.copytree(a / "cache", b / "cache")
    log_a = json.loads((a / "reward_log.json").read_text())
    (b / "reward_log.json").write_text(json.dumps(
        [r for r in log_a if r["step"] < 2]))
    rb = mod.main(argv + [str(b)])
    assert rb["start_step"] == 2 and len(rb["history"]) == 2
    sa, sb = ra["state"], rb["state"]
    for ta, tb in ((sa.params, sb.params), (sa.opt.mu, sb.opt.mu),
                   (sa.opt.nu, sb.opt.nu)):
        la, lb = list(tparams.leaves(ta)), list(tparams.leaves(tb))
        assert [p for p, _ in la] == [p for p, _ in lb]
        for (path, x), (_, y) in zip(la, lb):
            assert torch.equal(x, y), path
    assert torch.equal(sa.opt.step, sb.opt.step) and int(sa.opt.step) == 4

    def metrics(rows):
        return [{k: v for k, v in r.items() if k not in ("dt",
                                                         "steps_per_s")}
                for r in rows]

    assert metrics(ra["history"][2:]) == metrics(rb["history"])
    log_b = json.loads((b / "reward_log.json").read_text())
    assert [r["step"] for r in log_b] == [0, 1, 2, 3]
    assert metrics(log_b) == metrics(log_a)


def test_e2e_under_the_captured_step_equals_eager(tmp_path, monkeypatch):
    """chip_smoke.py phase 46 runs the e2e's 200 steps under
    ``perf.fuse_step`` (a replayed CUDA graph a step on the card) and holds
    their first rows against the example's eager steps.  On the CPU the
    fused step runs its body eagerly, from persistent generators re-seeded
    each step: the rows and the final state equal the eager run's
    bitwise."""
    mod = _small_e2e(monkeypatch)
    args = mod.parse_args(["--small", "--steps", "3"])
    runs = []
    for tag, ov in (("eager", []), ("fused", ["perf.fuse_step=true"])):
        args.out = str(tmp_path / tag)
        runs.append(mod.run(apply_overrides(mod.build_config(args), ov),
                            "cpu"))
    (ea, fu) = runs
    assert fu["experiment"].build_trainer()._fused is not None

    def metrics(rows):
        return [{k: v for k, v in r.items() if k not in ("dt",
                                                         "steps_per_s")}
                for r in rows]

    assert len(ea["history"]) == 3
    assert metrics(ea["history"]) == metrics(fu["history"])
    for ta, tb in ((ea["state"].params, fu["state"].params),
                   (ea["state"].opt.mu, fu["state"].opt.mu)):
        for (path, x), (_, y) in zip(tparams.leaves(ta), tparams.leaves(tb)):
            assert torch.equal(x, y), path


@pytest.mark.parametrize("name", ["quickstart", "multi_reward"])
def test_training_example_runs_on_cpu(name, tmp_path, capsys):
    out = port_example(name).main(["--device", "cpu", "--out",
                                   str(tmp_path)])
    text = capsys.readouterr().out
    if name == "quickstart":
        assert set(out) == {"flow_grpo", "awm"}
        for r in out.values():
            assert len(r["history"]) == 10 and _finite(r["history"])
        assert "swap the algorithm with ONE override:" in text
        assert f"awm final step: reward=" \
               f"{out['awm']['history'][-1]['reward']:+.4f}" in text
    else:
        assert set(out) == {"weighted_sum", "gdpo"}
        for agg, r in out.items():
            assert r["unique_loads"] == UNIQUE_LOADS
            assert len(r["history"]) == 15 and _finite(r["history"])
            assert f"[{agg}] 4 reward configs -> {UNIQUE_LOADS} unique " \
                   "frozen models loaded (deduplication)" in text
        assert text.count("  gain: ") == 2
    assert (tmp_path / "cache" / name).is_dir()


def test_serve_flow_runs_on_cpu(capsys):
    out = port_example("serve_flow").main(["--device", "cpu"])
    text = capsys.readouterr().out
    assert len(out) == 4
    for (arch, sde), r in out.items():
        st = r["stats"]
        assert st["cold_dispatches"] == 0 and st["dispatches"] == {
            "b4/s6": 2}
        # two repeated prompts at the priming encode, then all 8 served
        assert st["cond_cache"]["hits"] == 10
        assert tuple(r["latents"].shape) == (8, 8, 8)
        assert bool(torch.isfinite(r["latents"]).all())
        assert f"{arch:14s} solver={sde:10s} " in text
    assert text.count("cache_hits=10") == 4


@pytest.mark.parametrize("name", NAMES)
def test_examples_default_to_cuda_and_raise_without_it(name, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs on it")
    argv = {"train_grpo_e2e": ["--small", "--steps", "1"],
            "serve_flow": []}.get(name, [])
    if name != "serve_flow":
        argv += ["--out", str(tmp_path)]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_example(name).main(argv)


def test_e2e_first_step_matches_the_reference():
    """The e2e ``--small`` config's first ``trainer.step`` in both
    packages, each trainer as its Experiment builds it (bf16 params, the
    trainers' default): the reference's initial params and reward towers
    carried across, the rollout's draws recomputed as the reference makes
    them and injected; the metrics at tests/test_torch_training.py's
    step-parity tolerances, then the params after AdamW."""
    args = argparse.Namespace(small=True, steps=4, out="unused")
    ref = load(REF_DIR / "train_grpo_e2e.py", "ref_train_grpo_e2e")
    jcfg = ref.build_config(args)
    tcfg = port_example("train_grpo_e2e").build_config(args)
    jtr = JExperiment.from_config(jcfg).build_trainer()
    texp = Experiment.from_config(tcfg, device="cpu")
    tree = jax.tree.map(np.asarray, jtr.state.params)
    ttr = texp.build_trainer()
    tp = tparams.from_numpy(tree, "cpu")
    ttr.state = TRLState(tp, adamw_init(tp))
    ttr.loader.bind({mid: None if p is None else tparams.from_numpy(
        jax.tree.map(np.asarray, p), "cpu")
        for mid, p in jtr.loader.param_store().items()})
    P, fl = tcfg.data.batch_prompts, tcfg.flow
    cond = np.random.default_rng(7).standard_normal(
        (P, texp.cond_len, texp.cond_dim)).astype(np.float32)
    key = jax.random.PRNGKey(4)
    # the draws BaseTrainer.step makes (base.py:334-335, rollout.py:91-126)
    k_s, _ = jax.random.split(jax.random.fold_in(key, 0))
    k_init, k_steps = jax.random.split(k_s)
    B = P * fl.group_size
    x_init = np.asarray(jtr.adapter.init_latent(k_init, B))
    eps = np.stack([np.asarray(jax.random.normal(
        k, (B, fl.latent_tokens, fl.latent_dim), jnp.float32))
        for k in jax.random.split(k_steps, fl.num_steps)])
    jm = jax.device_get(jtr.step(jnp.asarray(cond), key, it=0))
    tm = ttr.step(to_torch(cond), 0, it=0, x_init=to_torch(x_init),
                  eps=to_torch(eps))
    np.testing.assert_allclose(float(tm["reward_mean"]),
                               float(jm["reward_mean"]), atol=1e-4)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               atol=1e-4)
    assert float(tm["clip_frac"]) == float(jm["clip_frac"])
    # the gradient sums T = 4 per-step backward passes through bf16 params
    # against one value_and_grad: measured 1.75e-4 relative here (7e-5 to
    # 1.8e-4 over T 3-4, group 2-4, cond_len 4-16; 1.6e-5 in f32 at
    # test_flow_grpo_step_matches_jax's smaller cell, held to 1e-4)
    np.testing.assert_allclose(float(tm["grad_norm"]),
                               float(jm["grad_norm"]), rtol=5e-4)
    np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]), rtol=1e-7)
    # AdamW's first step moves each param by ~lr * sign(grad): as
    # test_flow_grpo_step_matches_jax holds them
    lr = float(jm["lr"])
    flat = np.concatenate([np.abs(t.float().numpy()
                                  - np.asarray(j, np.float32)).ravel()
                           for (_, t), (_, j) in zip(
                               tparams.leaves(ttr.state.params),
                               tparams.leaves(jax.tree.map(
                                   np.asarray, jtr.state.params)))])
    assert flat.max() <= 4 * lr
    assert np.mean(flat > lr / 10) < 1e-3


def test_multi_reward_unique_loads_match_the_reference():
    """The reference's trainer for ``multi_reward``'s BASE loads as many
    frozen towers as the port's, under both aggregations."""
    port = port_example("multi_reward")
    base = ref_constant("multi_reward", "BASE")
    for agg in port.AGGREGATIONS:
        jtr = JExperiment.from_config(dataclasses.replace(
            base, flow=dataclasses.replace(base.flow, advantage_agg=agg))
        ).build_trainer()
        ttr = Experiment.from_config(apply_overrides(
            port.BASE, [f"flow.advantage_agg={agg}"]),
            device="cpu").build_trainer()
        assert ttr.loader.unique_loads == jtr.loader.unique_loads == \
            UNIQUE_LOADS
