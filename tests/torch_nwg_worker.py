"""The activation-gathered route's multi-rank cases of
``tests/test_torch_no_weight_gather.py``, run on four spawned gloo ranks
(``file://`` store).

Imports only torch and the port (spawned children import this module and
``torch_layout_worker``, not the test file, which imports JAX).  Every
case runs under ``REPRO_NO_WEIGHT_GATHER=1``: the rules come from
``sharding.production_rules(mesh, activations=sharding.no_weight_gather())``
and a rules trainer reads the switch itself (``BaseTrainer.layout_plan``).
Each LM case takes a reduced arch in f32 (the projections drawn as
``torch_layout_worker._fresh`` draws them) and holds, against one device
on the whole batch: the first step's gradients (each leaf's gap), two LM
train steps, then the trained params' prefill and four decode steps; it
records the collectives by (kind, axis) and every leaf all-gathered over
"data" by ``sharding.GatherParam`` (its dims).  ``JAX_CASE`` also returns
its canonical initial params, batch and the route's first-step gradients
as numpy arrays, for the test to hold against the JAX package.  The flow
cases run ``flow_grpo`` under ``rules=True`` (``torch_layout_worker.
flow_case``) on the narrowed ``flux_dit``.  Rank 0 pickles the results to
``out``.
"""
import contextlib
import os
import pickle
import traceback

import torch
import torch.distributed as dist

import torch_layout_worker as lw
from repro_torch import configs, optim, sharding as sh
from repro_torch.distributed import RulePlan, build_mesh
from repro_torch.models import tasks
from repro_torch.models.backbone import Backbone
from repro_torch.models.params import leaves

# (name, arch, (dp, mp), REPRO_MOE_MODE): every family the route runs, at
# (2, 2) (the route beside tensor parallelism) and (4, 1) (the data axis
# alone)
CASES = tuple((f"{tag}_{dp}x{mp}", arch, (dp, mp), mode)
              for tag, arch, mode in (
                  ("qwen3", "qwen3-32b", None),
                  ("mamba2", "mamba2-370m", None),
                  ("zamba2", "zamba2-2.7b", None),
                  ("deepseek", "deepseek-v2-236b", None),
                  ("deepseek_ep", "deepseek-v2-236b", "ep_model"),
                  ("grok", "grok-1-314b", None),
                  ("internvl2", "internvl2-1b", None))
              for dp, mp in ((2, 2), (4, 1)))
# (name, arch, (dp, mp)): every data rank holding the whole batch (the
# rules' batch entry dropped, as ``launch.specs.cache_rules`` drops it
# where the axis does not divide the batch): the d-partials all-reduced
# over "data", the columns gathered home
WHOLE_CASES = (("qwen3_whole_4x1", "qwen3-32b", (4, 1)),
               ("deepseek_whole_2x2", "deepseek-v2-236b", (2, 2)))
# the case whose params, batch and gradients go back as numpy arrays
JAX_CASE = "qwen3_2x2"
FLOW_CASES = (("flow_grpo_flux_2x2", (2, 2)), ("flow_grpo_flux_4x1", (4, 1)))


@contextlib.contextmanager
def switch(value="1"):
    """``REPRO_NO_WEIGHT_GATHER`` set to ``value`` in the body."""
    prev = os.environ.get("REPRO_NO_WEIGHT_GATHER")
    os.environ["REPRO_NO_WEIGHT_GATHER"] = value
    try:
        yield
    finally:
        if prev is None:
            os.environ.pop("REPRO_NO_WEIGHT_GATHER")
        else:
            os.environ["REPRO_NO_WEIGHT_GATHER"] = prev


@contextlib.contextmanager
def data_gathers(mesh, log: set):
    """Each ``sharding.GatherParam`` over the "data" group in the body,
    its leaf's (number of dims, shape) added to ``log``."""
    data = tuple(dist.get_process_group_ranks(mesh.get_group("data")))
    orig = sh.GatherParam.apply

    def apply(p, dim, group, n):
        if tuple(dist.get_process_group_ranks(group)) == data:
            log.add((p.ndim, tuple(p.shape)))
        return orig(p, dim, group, n)

    sh.GatherParam.apply = apply
    try:
        yield
    finally:
        sh.GatherParam.apply = orig


def _np(tree):
    return {"/".join(path): t.detach().numpy().copy()
            for path, t in leaves(tree)}


def case(name, arch, dp, mp):
    """One device against the (dp, mp) mesh on the route: the first
    step's gradients, two LM train steps, then the trained params' prefill
    and decode steps."""
    cfg = configs.get_reduced(arch)
    spec = Backbone(cfg).spec()
    batch = tasks.synthetic_batch(cfg, lw.BATCH, lw.SEQ, seed=1,
                                  device="cpu")
    step = tasks.make_train_step(cfg, lw.OPT)
    one = lw._fresh(cfg)
    start = _np(one.params) if name == JAX_CASE else None
    g_one = lw._grads(step, one.params, batch)
    m_one = [step(one, batch)[1] for _ in range(lw.STEPS)]
    zeros = torch.zeros((lw.BATCH, lw.DECODES), dtype=torch.int32)
    tokens = torch.stack([g.argmax(-1) for g in lw._serve(
        cfg, one.params, batch, zeros)[:lw.DECODES]], 1).to(torch.int32)
    lg_one = lw._serve(cfg, one.params, batch, tokens)

    mesh, r, n, rows = lw._mesh_and_rows(batch, dp, mp)
    rules = sh.production_rules(mesh, activations=sh.no_weight_gather())
    rec = lw.Recorder()
    for axis in ("data", "model"):
        rec.axes[tuple(dist.get_process_group_ranks(
            mesh.get_group(axis)))] = axis
    plan = RulePlan(mesh, spec, rules)
    local = plan.shard_state(lw._fresh(cfg).params)
    state = tasks.TrainState(local, optim.adamw_init(local))
    gathered = set()
    with sh.param_gather(mesh, rules), data_gathers(mesh, gathered):
        g_two = lw._grads(step, local, rows)
        with rec:
            m_two = [step(state, rows)[1] for _ in range(lw.STEPS)]
        train_log, rec.log = rec.log, set()
        with rec:
            lg_two = lw._serve(cfg, plan.shard_state(one.params), rows,
                               tokens[r * n:(r + 1) * n])
    lg_gap = torch.tensor(max(
        float((a[r * n:(r + 1) * n] - b).abs().max() / a.abs().max())
        for a, b in zip(lg_one, lg_two)))
    dist.all_reduce(lg_gap, op=dist.ReduceOp.MAX)
    g_two = plan.gather_state(sh.mesh_grads(g_two, spec, mesh, rules)[0])
    g_gaps = lw._leaf_gaps(g_one, g_two)
    whole = plan.gather_state(state.params)
    out = {"route": rules.route,
           "grad_gap": max(g_gaps.values()), "grad_gaps": g_gaps,
           "loss": [[float(m["loss"]) for m in ms] for ms in (m_one, m_two)],
           "gnorm": [[float(m["grad_norm"]) for m in ms]
                     for ms in (m_one, m_two)],
           "param_gap": max(float((a - b).abs().max()) for (_, a), (_, b)
                            in zip(leaves(one.params), leaves(whole))),
           "logit_gap": float(lg_gap),
           "logits_shape": tuple(lg_two[0].shape),
           "data_gathers": sorted(gathered),
           "train_collectives": sorted(train_log),
           "serve_collectives": sorted(rec.log)}
    if start is not None:
        out.update(params=start, grads=_np(g_two),
                   batch={k: v.numpy() for k, v in batch.items()})
    return out


def whole_case(arch, dp, mp):
    """One device against the (dp, mp) mesh with every data rank on the
    whole batch: the first step's gradients, then the prefill and decode
    steps on the initial params."""
    cfg = configs.get_reduced(arch)
    spec = Backbone(cfg).spec()
    batch = tasks.synthetic_batch(cfg, lw.BATCH, lw.SEQ, seed=1,
                                  device="cpu")
    step = tasks.make_train_step(cfg, lw.OPT)
    one = lw._fresh(cfg)
    g_one = lw._grads(step, one.params, batch)
    tokens = torch.ones((lw.BATCH, lw.DECODES), dtype=torch.int32)
    lg_one = lw._serve(cfg, one.params, batch, tokens)
    mesh = build_mesh(dp, mp, "cpu")
    rules = sh.production_rules(mesh, activations=True)
    rules.arules["batch"] = None
    plan = RulePlan(mesh, spec, rules)
    with sh.param_gather(mesh, rules):
        rows = sh.current_rows()
        g_two = lw._grads(step, plan.shard_state(lw._fresh(cfg).params),
                          batch)
        lg_two = lw._serve(cfg, plan.shard_state(one.params), batch, tokens)
    g_two = plan.gather_state(sh.mesh_grads(g_two, spec, mesh, rules)[0])
    return {"split": rows.split,
            "grad_gap": max(lw._leaf_gaps(g_one, g_two).values()),
            "logit_gap": max(float((a - b).abs().max() / a.abs().max())
                             for a, b in zip(lg_one, lg_two))}


def flow(dp, mp):
    """``torch_layout_worker.flow_case`` on the route, with the leaves
    all-gathered over "data"."""
    gathered = set()
    mesh = build_mesh(dp, mp, "cpu")
    with data_gathers(mesh, gathered):
        out = lw.flow_case(dp, mp)
    out["data_gathers"] = sorted(gathered)
    return out


def run(rank, world, store, out):
    """Entry point of one spawned rank: every case in turn."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    try:
        res = {}
        with switch():
            for name, arch, shape, mode in CASES:
                with lw.moe_mode(mode):
                    res[name] = case(name, arch, *shape)
            for name, arch, shape in WHOLE_CASES:
                res[name] = whole_case(arch, *shape)
            for name, shape in FLOW_CASES:
                res[name] = flow(*shape)
        if rank == 0:
            with open(out, "wb") as f:
                pickle.dump(res, f)
    except BaseException:
        with open(f"{out}.err{rank}", "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        dist.destroy_process_group()


def spawn(tmp_path, timeout):
    """Every case on four spawned gloo ranks: rank 0's results, or an
    AssertionError with the ranks' tracebacks."""
    import multiprocessing as mp
    import time
    ctx = mp.get_context("spawn")
    store = os.path.join(str(tmp_path), "nwg.store")
    out = os.path.join(str(tmp_path), "nwg.pkl")
    procs = [ctx.Process(target=run, args=(r, 4, store, out))
             for r in range(4)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    for p in procs:
        p.join(max(deadline - time.monotonic(), 0.1))
    hung = [p for p in procs if p.is_alive()]
    for p in hung:
        p.kill()
        p.join()
    errs = "".join(f"--- rank {r}\n" + open(f"{out}.err{r}").read()
                   for r in range(4) if os.path.exists(f"{out}.err{r}"))
    if hung or errs or any(p.exitcode for p in procs):
        raise AssertionError(f"route cases failed or hung (exit codes "
                             f"{[p.exitcode for p in procs]})\n{errs}")
    with open(out, "rb") as f:
        return pickle.load(f)


if __name__ == "__main__":
    import json
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        res = spawn(tmp, 600)
    for k, v in res.items():
        print(k, json.dumps({f: v[f] for f in v
                             if f not in ("params", "grads", "batch")},
                            default=str))
