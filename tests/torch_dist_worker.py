"""Multi-rank scenarios of ``tests/test_torch_distributed.py``, run in
spawned processes joined by a gloo group (``file://`` store).

Imports only torch and the port: spawned children import this module, not
the test file (which imports JAX).  Each scenario returns a dict of numpy
arrays and floats; rank 0's is pickled to ``out``.
"""
import dataclasses
import os
import pickle
import tempfile
import traceback

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import checkpoint, configs, distributed, registry
from repro_torch.config import (DistConfig, FlowRLConfig, OptimConfig,
                                RewardSpec)
from repro_torch.models import params as tparams

COND_LEN, COND_DIM = 4, 32
FLOW = dict(num_steps=3, group_size=4, latent_tokens=8, latent_dim=8,
            clip_range=0.2, advantage_agg="gdpo")
REWARDS = (RewardSpec("text_render", 1.0,
                      args={"latent_dim": 8, "latent_tokens": 8,
                            "cond_dim": COND_DIM}),
           RewardSpec("latent_norm", 0.5))
# pref_group is groupwise: it scores a sample against the rest of its group
GROUP_REWARDS = REWARDS + (RewardSpec("pref_group", 0.5,
                                      args={"latent_dim": 8, "hidden": 16,
                                            "cond_dim": COND_DIM}),)
OPT = OptimConfig(lr=1e-3, total_steps=20, warmup_steps=2)
METRICS = ("reward_mean", "loss", "grad_norm")


def arch():
    """flux_dit narrowed for the CPU: 2 blocks of width 64."""
    return dataclasses.replace(configs.get_reduced("flux_dit"), d_model=64,
                               n_heads=4, n_kv_heads=4, head_dim=16,
                               d_ff=128, vocab_size=64)


def build(tname, dist_cfg=None, mesh=None, rewards=REWARDS, **flow_kw):
    flow = FlowRLConfig(**{**FLOW, **flow_kw}, rewards=rewards)
    return registry.build("trainer", tname, arch(), flow, OPT, seed=0,
                          cond_dim=COND_DIM, dtype=torch.float32,
                          device="cpu", dist=dist_cfg, mesh=mesh)


def cond_batch(P=2, seed=1):
    g = torch.Generator().manual_seed(seed)
    return torch.randn((P, COND_LEN, COND_DIM), generator=g)


def train(tname, dist_cfg=None, mesh=None, steps=2, prompts=2, **kw):
    """(trainer, per-step metrics) of ``steps`` steps on one batch of
    ``prompts`` prompts."""
    tr = build(tname, dist_cfg, mesh, **kw)
    cond = cond_batch(prompts)
    hist = []
    for it in range(steps):
        m = tr.step(cond, 7, it=it)
        hist.append({k: float(v) for k, v in m.items()})
    return tr, hist


def canonical_params(tr):
    st = tr.canonical_state()
    return {k: v.detach().numpy().copy()
            for k, v in tparams.state_dict(st.params).items()}


# ----------------------------------------------------------- scenarios

def two_ranks(tmp):
    """dp=2, mp=2 and dp=2 + microbatch=2 against one device, for the four
    trainer families; dp=2 serving; the straddling-group statistics; the
    sharded global norm."""
    out = {}
    for tname in ("flow_grpo", "grpo_guard", "nft", "awm"):
        ref, h_ref = train(tname, mesh=None, dist_cfg=DistConfig())
        out[f"{tname}/single"] = (h_ref, canonical_params(ref))
        layouts = {"dp2": DistConfig(data_parallel=2),
                   "mp2": DistConfig(model_parallel=2)}
        if tname != "grpo_guard":
            layouts["dp2_mb2"] = DistConfig(data_parallel=2, microbatch=2)
            # the one-device run with the same chunks: NFT/AWM draw per
            # chunk, so microbatching changes their draws, not the layout
            ref, h_ref = train(tname, mesh=None,
                               dist_cfg=DistConfig(microbatch=2))
            out[f"{tname}/single_mb2"] = (h_ref, canonical_params(ref))
        for name, dc in layouts.items():
            tr, h = train(tname, dc)
            out[f"{tname}/{name}"] = (h, canonical_params(tr))
            if name == "mp2":
                out[f"{tname}/mp2/bytes"] = tr.plan.bytes_report(tr.state)
    # straddling groups: 3 prompts x groups of 4 over two ranks of 6 rows,
    # so prompt 1's group is split 2 + 2; a groupwise reward and gdpo
    ref, h_ref = train("flow_grpo", mesh=None, dist_cfg=DistConfig(),
                       rewards=GROUP_REWARDS, steps=1, prompts=3)
    tr, h = train("flow_grpo", DistConfig(data_parallel=2),
                  rewards=GROUP_REWARDS, steps=1, prompts=3)
    out["straddle"] = (h_ref, h, tr._layout(12)[0].tolist())
    out["norm"] = sharded_norm()
    out["serve"] = serve_dp2()
    out["rollout_sharded"] = sharded_rollout()
    out["engine"] = engine_dp2()
    return out


def engine_dp2():
    """flow_grpo with an attached engine (``max_batch`` 4 below the batch
    of 2 prompts x 4): dp = 2 and mp = 2 (the trainer's shards passed
    to the engine as they are) against dp = 1, 2 steps; and each rank's
    sampled rows against the one-device engine's rows that ``_layout``
    gives that rank (max |xs gap|, max relative logps gap, cond equal;
    gathered from both ranks)."""
    from repro_torch.serving import ServingEngine
    res = {}
    for name, dc in (("dp1", DistConfig()),
                     ("dp2", DistConfig(data_parallel=2)),
                     ("mp2", DistConfig(model_parallel=2))):
        tr = build("flow_grpo", dc, mesh=None)
        eng = ServingEngine.for_trainer(tr, max_batch=4, cond_len=COND_LEN)
        tr.attach_engine(eng)
        gen = torch.Generator().manual_seed(11)
        traj = tr.sample(tr.state.params, cond_batch(), gen)
        hist = []
        for it in range(2):
            m = tr.step(cond_batch(), 7, it=it)
            hist.append({k: float(v) for k, v in m.items()})
        res[name] = (hist, canonical_params(tr))
        res[name + "/traj"] = traj
        res[name + "/stats"] = {k: eng.stats[k] for k in
                                ("buckets", "data_parallel", "dispatches",
                                 "padded_lanes")}
        res[name + "/rows"] = tr._layout(8)[0].tolist()
    one, mine = res.pop("dp1/traj"), res.pop("dp2/traj")
    res["mp2/xs_gap"] = float((res.pop("mp2/traj").xs - one.xs).abs().max())
    rows = res["dp2/rows"]
    gaps = (float((mine.xs - one.xs[:, rows]).abs().max()),
            float(((mine.logps - one.logps[:, rows]).abs()
                   / one.logps[:, rows].abs()).max()),
            torch.equal(mine.cond, one.cond[rows]))
    flags = [None] * dist.get_world_size()
    dist.all_gather_object(flags, (rows, gaps))
    res["own_rows"] = flags
    return res


def sharded_rollout():
    """``distributed.rollout_sharded`` on a (2, 1) mesh: the whole batch's
    trajectory, data rank r's rows rolled out from ``fold_seed(seed, r)``;
    against each rank's rows rolled out alone."""
    from repro_torch.core.rollout import fold_seed, group_repeat, rollout
    tr = build("flow_grpo", DistConfig(), mesh=None)
    mesh = distributed.build_mesh(2, 1, "cpu")
    cond = group_repeat(cond_batch(), 4)
    traj = distributed.rollout_sharded(tr.adapter, tr.state.params, cond, 5,
                                       tr.scheduler, 3, mesh)
    same = []
    for r in range(2):
        gen = torch.Generator().manual_seed(fold_seed(5, r))
        own = rollout(tr.adapter, tr.state.params, cond[4 * r:4 * r + 4],
                      gen, tr.scheduler, 3)
        same.append(torch.equal(traj.xs[:, 4 * r:4 * r + 4], own.xs)
                    and torch.equal(traj.logps[:, 4 * r:4 * r + 4],
                                    own.logps))
    return tuple(traj.xs.shape), same, torch.equal(traj.cond, cond)


def sharded_norm():
    """The global norm of gradients sharded over "model" against the
    canonical tree's."""
    tr = build("flow_grpo", DistConfig(model_parallel=2))
    g = torch.Generator().manual_seed(5)
    full = {k: torch.randn(v.shape, generator=g) for k, v in
            tparams.state_dict(tr.canonical_state().params).items()}
    tree = {}
    for k, v in full.items():
        tparams._set(tree, tuple(k.split(".")), v.clone())
    local = tr.plan.shard_state(tree)
    from repro_torch.optim import global_norm
    got = global_norm(local, sharded=tr._sharded, group=tr._mgroup)
    want = global_norm(tree)
    return float(got), float(want), len(tr._sharded)


def serve_dp2():
    """Per-request latents of a dp=2 engine, an mp=2 engine (params
    sharded, each layer gathered) and a one-device engine on the same
    params and seeds (a bucket of 4, and 3 requests padded)."""
    from repro_torch.api.serving import FlowSampler
    flow = FlowRLConfig(**{**FLOW, "sde_type": "flow_sde"})
    g = torch.Generator().manual_seed(3)
    cond = torch.randn((3, COND_LEN, COND_DIM), generator=g).numpy()
    res = {}
    for name, dc in (("dp1", None), ("dp2", DistConfig(data_parallel=2)),
                     ("mp2", DistConfig(model_parallel=2))):
        s = FlowSampler(arch(), flow, seed=0, device="cpu",
                        param_dtype="float32", max_batch=4,
                        cond_dim=COND_DIM, cond_len=COND_LEN, dist=dc)
        res[name] = s.serve(cond, seed=9).numpy()
        res[name + "/stats"] = {k: s.engine.stats[k] for k in
                                ("buckets", "data_parallel",
                                 "model_parallel", "dispatches")}
    return res


def four_ranks(tmp):
    """dp=2 x mp=2 against one device for the four trainer families; a
    dp=2 x mp=2 checkpoint restored at dp=1 and at mp=4."""
    out = {}
    for tname in ("flow_grpo", "grpo_guard", "nft", "awm"):
        ref, h_ref = train(tname, mesh=None, dist_cfg=DistConfig())
        tr, h = train(tname, DistConfig(data_parallel=2, model_parallel=2))
        out[tname] = (h_ref, h, canonical_params(ref), canonical_params(tr),
                      tr.plan.bytes_report(tr.state))
        if tname == "flow_grpo":
            ckpt = os.path.join(tmp, "ckpt")
            state = tr.canonical_state()
            if dist.get_rank() == 0:
                checkpoint.save_checkpoint(ckpt, 2, state)
            dist.barrier()
            out["ckpt"] = restore_layouts(ckpt, state)
    return out


def _flat(state):
    return [(k, v) for k, v in checkpoint.io._flatten(state)]


def restore_layouts(ckpt, saved):
    """Restore ``ckpt`` at dp=1 (no mesh) and at mp=4: bitwise the saved
    canonical state, leaf by leaf (at mp=4 each rank's shards against the
    saved leaves' slices, then gathered back whole)."""
    res = {}
    one = build("flow_grpo", DistConfig(), mesh=None)
    step, st = checkpoint.restore_latest(ckpt, one.state, one.state_slicer())
    res["dp1"] = (step, all(torch.equal(a, b) for (_, a), (_, b) in
                            zip(_flat(st), _flat(saved))))
    mp4 = build("flow_grpo", DistConfig(model_parallel=4))
    step, st = checkpoint.restore_latest(ckpt, mp4.state, mp4.state_slicer())
    placed = mp4.place_state(saved)
    mp4.state = st
    back = mp4.canonical_state()
    res["mp4"] = (step,
                  all(torch.equal(a, b) for (_, a), (_, b) in
                      zip(_flat(st), _flat(placed))),
                  all(torch.equal(a, b) for (_, a), (_, b) in
                      zip(_flat(back), _flat(saved))),
                  mp4.plan.bytes_report(st))
    m = mp4.step(cond_batch(), 7, it=2)
    res["mp4_continues"] = float(m["loss"])
    return res


SCENARIOS = {"two_ranks": two_ranks, "four_ranks": four_ranks}


def run(rank, world, store, scenario, out):
    """Entry point of one spawned rank."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    try:
        with tempfile.TemporaryDirectory() as tmp:
            shared = os.path.join(os.path.dirname(out), "shared")
            os.makedirs(shared, exist_ok=True)
            res = SCENARIOS[scenario](shared if scenario == "four_ranks"
                                      else tmp)
        if rank == 0:
            with open(out, "wb") as f:
                pickle.dump(res, f)
    except BaseException:
        with open(f"{out}.err{rank}", "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        dist.destroy_process_group()


def spawn(world, scenario, tmp_path, timeout):
    """Run ``scenario`` on ``world`` spawned gloo ranks; its rank-0 result,
    or an AssertionError with the ranks' tracebacks on a failure or after
    ``timeout`` seconds."""
    import multiprocessing as mp
    ctx = mp.get_context("spawn")
    store = os.path.join(str(tmp_path), f"{scenario}.store")
    out = os.path.join(str(tmp_path), f"{scenario}.pkl")
    procs = [ctx.Process(target=run, args=(r, world, store, scenario, out))
             for r in range(world)]
    for p in procs:
        p.start()
    import time
    deadline = time.monotonic() + timeout
    for p in procs:
        p.join(max(deadline - time.monotonic(), 0.1))
    hung = [p for p in procs if p.is_alive()]
    for p in hung:
        p.kill()
        p.join()
    errs = ""
    for r in range(world):
        path = f"{out}.err{r}"
        if os.path.exists(path):
            errs += f"--- rank {r}\n" + open(path).read()
    if hung:
        raise AssertionError(f"{scenario}: {len(hung)} rank(s) still running "
                             f"after {timeout} s\n{errs}")
    if errs or any(p.exitcode for p in procs):
        raise AssertionError(f"{scenario} failed (exit codes "
                             f"{[p.exitcode for p in procs]})\n{errs}")
    with open(out, "rb") as f:
        return pickle.load(f)
