"""The port's pipelined TrainLoop against the contracts of
``tests/test_pipeline.py`` that need no mesh, on the CPU.

* ``pipeline=1`` is bitwise the sequential dispatch→drain loop: the same
  params after N AdamW steps and the same metric rows.
* ``pipeline=K>1`` changes only when metrics are observed (rows arrive up
  to K-1 steps after their dispatch), never what is computed: params and
  metric values are bitwise equal across K.
* A checkpoint taken mid-pipeline sees the state exactly as of its step
  (the ``wants_sync`` drain), so a resumed run is bitwise an uninterrupted
  one.
* The fused step with offloaded reward towers composes with the pipeline.
"""
import numpy as np
import pytest
import torch

from repro_torch import configs, registry
from repro_torch.api import Experiment, loop as loop_lib
from repro_torch.config import (DataConfig, FlowRLConfig, LoopConfig,
                                OptimConfig, PerfConfig, RewardSpec,
                                RunConfig)
from repro_torch.core.preprocess import ConditionProvider
from repro_torch.data.prompts import PromptDataset, synthetic_prompts
from repro_torch.models import params as params_lib

from torch_parity import one_torch_thread  # noqa: F401  (autouse fixture)

TINY_ENCODER = dict(cond_dim=32, cond_len=4, vocab=256, hidden=64)
SEED = 7

TINY_FLOW = FlowRLConfig(
    num_steps=2, group_size=2, latent_tokens=4, latent_dim=4,
    rewards=(RewardSpec("text_render", 1.0,
                        args={"latent_dim": 4, "latent_tokens": 4,
                              "cond_dim": 32}),))
TINY_OPT = OptimConfig(lr=1e-3, total_steps=64, warmup_steps=2)


def _trainer(perf=None):
    return registry.build("trainer", "flow_grpo",
                          configs.get_reduced("flux_dit"), TINY_FLOW,
                          TINY_OPT, cond_dim=32, device="cpu", perf=perf)


def _provider():
    return ConditionProvider(preprocessing=False, encoder_kw=TINY_ENCODER,
                             device="cpu")


def _dataset():
    return PromptDataset(synthetic_prompts(16), batch_size=4, seed=0)


def _loop(trainer, steps=6, pipeline=1, start_step=0, callbacks=()):
    return loop_lib.TrainLoop(trainer, _provider(), _dataset(), steps=steps,
                              seed=SEED, start_step=start_step,
                              callbacks=callbacks, pipeline=pipeline)


def _bits(tree):
    return [t.view(torch.int16) if t.dtype == torch.bfloat16 else t
            for _, t in params_lib.leaves(tree)]


def _rows(history):
    """History minus the wall-clock keys (the only K-dependent fields)."""
    return [{k: v for k, v in r.items() if k not in ("dt", "steps_per_s")}
            for r in history]


def _assert_same_params(tr_a, tr_b):
    la, lb = _bits(tr_a.state.params), _bits(tr_b.state.params)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert torch.equal(x, y)


def _sequential_reference(trainer, steps):
    """The sequential loop, hand-rolled: dispatch one step, fetch its
    metrics at once, repeat."""
    provider, stream = _provider(), _dataset().infinite(0)
    history = []
    for it in range(steps):
        cond = provider.get(next(stream))["cond"]
        m = {k: float(v) for k, v in trainer.step(cond, SEED, it=it).items()}
        row = {"step": it, "reward": m.pop("reward_mean"),
               "loss": m.pop("loss"), "grad_norm": m.pop("grad_norm"),
               "encode_resident": provider.encoder_resident}
        row.update(m)
        history.append(row)
    return history


def test_pipeline1_bitwise_equals_sequential_reference():
    ref_tr = _trainer()
    ref_hist = _sequential_reference(ref_tr, 6)
    tr = _trainer()
    hist = _loop(tr, steps=6, pipeline=1).run()
    _assert_same_params(ref_tr, tr)
    assert _rows(hist) == ref_hist


def test_pipeline4_same_math_lagged_observation():
    tr1 = _trainer()
    h1 = _loop(tr1, steps=6, pipeline=1).run()
    tr4 = _trainer()
    dispatched = []
    orig_step = tr4.step

    def counting_step(cond, seed, *, it):
        dispatched.append(it)
        return orig_step(cond, seed, it=it)

    tr4.step = counting_step
    lags = []

    class Lag(loop_lib.Callback):
        def on_step(self, loop, step, metrics):
            lags.append(max(dispatched) - step)

    h4 = _loop(tr4, steps=6, pipeline=4, callbacks=[Lag()]).run()
    _assert_same_params(tr1, tr4)
    assert _rows(h4) == _rows(h1)            # same values, same order
    # ...but observed late: when step 0's row lands, steps 1..3 were
    # already dispatched (a depth-K lag, at most K-1)
    assert max(lags) == 3
    assert all(0 <= lag <= 3 for lag in lags)


def test_pipeline_depth_validated():
    with pytest.raises(ValueError, match="pipeline"):
        _loop(_trainer(), pipeline=0)


def _tiny_cfg(tmp_path, steps, save_every=0, **loop_kw):
    return RunConfig(
        arch="flux_dit", reduced=True,
        flow=FlowRLConfig(num_steps=2, group_size=2, latent_tokens=4,
                          latent_dim=4, rewards=(),
                          cache_dir=str(tmp_path / "cache")),
        optim=OptimConfig(lr=1e-3, total_steps=8, warmup_steps=1),
        data=DataConfig(n_prompts=8, batch_prompts=2, encoder=TINY_ENCODER),
        loop=LoopConfig(steps=steps, save_every=save_every, log_every=0,
                        ckpt_dir=str(tmp_path / "ckpt"), **loop_kw))


def test_checkpoint_resume_mid_pipeline_bitwise(tmp_path):
    """A K=4 run interrupted at its step-2 checkpoint and resumed equals an
    uninterrupted K=1 run."""
    straight = Experiment.from_config(
        _tiny_cfg(tmp_path / "a", steps=4, save_every=2),
        device="cpu").train()
    Experiment.from_config(
        _tiny_cfg(tmp_path / "b", steps=2, save_every=2, pipeline=4),
        device="cpu").train()
    resumed = Experiment.from_config(
        _tiny_cfg(tmp_path / "b", steps=4, save_every=2, pipeline=4),
        device="cpu").train()
    assert resumed["start_step"] == 2
    _assert_same_params(type("T", (), {"state": straight["state"]}),
                        type("T", (), {"state": resumed["state"]}))
    assert int(resumed["state"].opt.step) == 4
    for (_, a), (_, b) in zip(params_lib.leaves(straight["state"].opt.nu),
                              params_lib.leaves(resumed["state"].opt.nu)):
        assert torch.equal(a, b)


def test_pipeline_composes_with_fused_step_and_offloaded_rewards():
    perf = PerfConfig(fuse_step=True, offload_rewards=True, remat="block")
    tr1 = _trainer()
    h1 = _loop(tr1, steps=4, pipeline=1).run()
    tr4 = _trainer(perf=perf)
    h4 = _loop(tr4, steps=4, pipeline=4).run()
    assert tr4.offloads_rewards and tr4._fused is not None
    _assert_same_params(tr1, tr4)
    assert _rows(h4) == _rows(h1)
    assert np.isfinite([r["loss"] for r in h4]).all()
