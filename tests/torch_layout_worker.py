"""The production layout's multi-rank cases of
``tests/test_torch_layout.py``, run on four spawned gloo ranks
(``file://`` store).

Imports only torch and the port (spawned children import this module, not
the test file, which imports JAX).  Each case takes a reduced arch in f32
(wq / wk drawn at 1/sqrt(d_model), MLA's w_uq / w_uk at 1/sqrt(their
latent rank): the repository's init is chaotic, see
``tests/test_torch_dense.py`` and ``tests/test_torch_moe.py``) and, on one
device (every rank, the whole batch) and on a (data, model) mesh under
``sharding.production_rules`` (this rank's rows, its shards of the params
and moments): the first step's gradients (each leaf's gap), two LM train
steps, then the one-device trained params' prefill and four decode
steps, recording the collectives by (kind, axis) and the shapes that are
all-gathered over "model".  ``GRAD_CASES`` take the first step's
gradients alone.
``flow_case``: two ``flow_grpo`` steps (rollout, rewards, update) of the
narrowed ``flux_dit`` of ``torch_dist_worker`` (``FLOW_CASES``: and of its
narrowed MoE archs and a narrowed ``mamba2-370m``) laid out by the rules
(``BaseTrainer(..., rules=True)``: the dry run's flow step) against one
device, the trainer's canonical state, checkpoint slicer and byte report
under them, and for the ``FLOW_CASES`` a checkpoint of the two steps
resumed by a new trainer, whose third step must equal the first
trainer's.  Rank 0
pickles the gaps to ``out``.
"""
import contextlib
import os
import pickle
import tempfile
import traceback

import torch
import torch.distributed as dist

from repro_torch import configs, optim, sharding as sh
from repro_torch.config import OptimConfig
from repro_torch.distributed import RulePlan, build_mesh
from repro_torch.perf import memory
from repro_torch.serving import ServingEngine
from repro_torch.models import moe, tasks
from repro_torch.models.backbone import Backbone
from repro_torch.models.params import leaves

# a Mamba-2 block whose 6 SSD heads 4 "model" ranks do not divide: gathered
# whole at use (``GATHERED_WHOLE["ssm_undivided"]``), its conv still stored
# by component
UNDIVIDED = "mamba2-370m@6heads"
# (name, arch, (dp, mp), REPRO_MOE_MODE): q and kv heads sharded; q heads
# sharded over whole kv heads; heads whole with the MLP and vocabulary
# parallel and the vision prefix; the SSM blocks' heads and the shared
# attention parallel; MLA's heads and the routed and shared experts'
# hidden dim parallel (a dense first layer); grok's experts at f / 4 with
# 2 kv heads over 4 ranks; grok's experts in dense mode; Mamba-2's heads
# at 4 of 16 a rank; then expert parallel (ep_model): deepseek's 4
# experts two a rank beside its shared experts' hidden dim, grok's 4
# experts one a rank
CASES = (("qwen3_2x2", "qwen3-32b", (2, 2), None),
         ("qwen3_1x4", "qwen3-32b", (1, 4), None),
         ("internvl2_2x2", "internvl2-1b", (2, 2), None),
         ("zamba2_2x2", "zamba2-2.7b", (2, 2), None),
         ("deepseek_2x2", "deepseek-v2-236b", (2, 2), None),
         ("grok_1x4", "grok-1-314b", (1, 4), None),
         ("grok_dense_2x2", "grok-1-314b", (2, 2), "dense"),
         ("mamba2_1x4", "mamba2-370m", (1, 4), None),
         ("deepseek_ep_2x2", "deepseek-v2-236b", (2, 2), "ep_model"),
         ("grok_ep_1x4", "grok-1-314b", (1, 4), "ep_model"))
# three ranks (``spawn(..., world=3)``): ep_model where the "model" axis
# does not divide the reduced 4 experts, gathered whole
# (``GATHERED_WHOLE["experts_undivided"]``)
UNDIVIDED_CASES = (("deepseek_ep_1x3", "deepseek-v2-236b", (1, 3),
                    "ep_model"),)
# the serving steps alone (``case(..., train=False)``), merged into the
# GRAD_CASES result of the same name: ep_model's prefill and decode at
# (1, 4)
SERVE_CASES = (("deepseek_ep_1x4", "deepseek-v2-236b", (1, 4), "ep_model"),)
# the first step's gradients only: MLA's latent projections and the router
# at mp 4, in tensor mode and under ep_model (one expert a rank); the
# SSM blocks at the mp the CASES above leave out.  The two LM train steps
# are not held at deepseek's mp 4: one element of w_dkv, whose first
# gradient is 2.2e-7 of its leaf's max, moves by reordering noise alone,
# which AdamW scales to the step size (9.7e-5 of the params' 1e-4 band in
# tensor mode, 1.4e-4 under ep_model, where every gradient is within
# 1.6e-6 of its leaf's max)
GRAD_CASES = (("deepseek_1x4", "deepseek-v2-236b", (1, 4), None),
              ("deepseek_ep_1x4", "deepseek-v2-236b", (1, 4), "ep_model"),
              ("zamba2_1x4", "zamba2-2.7b", (1, 4), None),
              ("mamba2_2x2", "mamba2-370m", (2, 2), None),
              ("mamba2_h6_1x4", UNDIVIDED, (1, 4), None))
BATCH, SEQ, STEPS, DECODES = 4, 32, 2, 4
OPT = OptimConfig(lr=1e-3, total_steps=10, warmup_steps=1)
_COLL = {"all_reduce": "all-reduce",
         "all_gather_into_tensor": "all-gather",
         "all_gather_single": "all-gather",
         "reduce_scatter_tensor": "reduce-scatter",
         "reduce_scatter_single": "reduce-scatter",
         "all_to_all": "all-to-all",
         "all_to_all_single": "all-to-all"}


class Recorder:
    """Wraps ``torch.distributed``'s collectives to record each call's
    kind and the mesh axis of its group ("data", "model" or "world"), and
    the output shape of each all-gather over "model" (``model_gathers``);
    and the routed expert tables' shapes each MoE call runs on
    (``expert_uses``: ``moe.apply``'s ``w_gate``, ``w_up`` and
    ``w_down``)."""

    def __init__(self):
        self.log, self.axes, self._orig = set(), {}, {}
        self.model_gathers, self.expert_uses = set(), set()

    def __enter__(self):
        apply = self._orig["moe.apply"] = moe.apply

        def moe_apply(p, *a, **k):
            self.expert_uses.update(tuple(p[n].shape) for n in
                                    ("w_gate", "w_up", "w_down"))
            return apply(p, *a, **k)
        moe.apply = moe_apply
        for name, kind in _COLL.items():
            fn = getattr(dist, name, None)
            if fn is None:
                continue
            self._orig[name] = fn

            def wrapped(*a, _fn=fn, _kind=kind, group=None, **k):
                ranks = tuple(dist.get_process_group_ranks(group)
                              if group is not None else
                              range(dist.get_world_size()))
                axis = self.axes.get(ranks, "world")
                self.log.add((_kind, axis))
                if _kind == "all-gather" and axis == "model":
                    self.model_gathers.add(tuple(a[0].shape))
                return _fn(*a, group=group, **k)
            setattr(dist, name, wrapped)
        return self

    def __exit__(self, *exc):
        moe.apply = self._orig.pop("moe.apply")
        for name, fn in self._orig.items():
            setattr(dist, name, fn)


# the seed of the drawn projections, by reduced arch (1 elsewhere).  At
# seed 1 deepseek's dense_blocks/ln1 has an element whose gradient is
# 7.3e-9 in f64, under f32's reordering noise (one device gives -1.2e-9,
# the mesh -9.5e-9): AdamW (eps 1e-8) turns such an element's update into
# noise, 0.1 to 0.5 of the step, past the params' band by reordering alone
DRAW_SEEDS = {"deepseek-v2-236b-reduced": 2}


def _fresh(cfg):
    p = tasks.init_params(cfg, torch.Generator().manual_seed(0),
                          torch.float32, "cpu")
    gen = torch.Generator().manual_seed(DRAW_SEEDS.get(cfg.name, 1))
    for blk in (p.get("dense_blocks", {}), p["blocks"],
                p.get("shared_attn", {})):
        for k in ("wq", "wk", "w_uq", "w_uk"):
            if k in blk.get("attn", {}):
                w = blk["attn"][k]
                fan_in = cfg.d_model if k in ("wq", "wk") else w.shape[-3]
                w.copy_(torch.randn(w.shape, generator=gen) / fan_in ** 0.5)
    return tasks.TrainState(p, optim.adamw_init(p))


def tp_leaves(spec):
    """The paths of the leaves that run tensor-parallel over "model" since
    MLA and the routed experts left ``GATHERED_WHOLE``: every leaf of an
    MLA block, and the expert tables under a router (the routed experts'
    and the shared ones'; not the router)."""
    out = []
    for path, _ in leaves(spec):
        for i, k in enumerate(path[:-1]):
            node = _at(spec, path[:i + 1])
            if (k == "attn" and "w_dq" in node) or (
                    k == "ffn" and "router" in node
                    and path[-1] != "router"):
                out.append(path)
                break
    return out


def expert_tables(spec):
    """The paths of the routed expert tables (``w_gate``, ``w_up``,
    ``w_down`` beside a router)."""
    return {path for path, _ in leaves(spec)
            if path[-1] in ("w_gate", "w_up", "w_down")
            and "router" in _at(spec, path[:-1])}


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def gathered_shape(shape, dim):
    """The output shape of an all-gather of a leaf of canonical ``shape``
    along ``dim`` (``sharding.gather_dim`` gathers it as dim 0)."""
    return (shape[dim],) + tuple(shape[:dim]) + tuple(shape[dim + 1:])


def _grads(step, params, batch):
    """The loss's gradients at ``params`` (no optimizer step)."""
    lv = [t for _, t in leaves(params)]
    for t in lv:
        t.requires_grad_(True)
    try:
        step.loss_fn(params, batch)[0].backward()
    finally:
        for t in lv:
            t.requires_grad_(False)
    return tasks._grads(params)


def _serve(cfg, params, batch, tokens):
    """Prefill logits and the logits of ``DECODES`` decode steps fed
    ``tokens`` (B, DECODES)."""
    prefill = tasks.make_prefill_step(cfg)
    decode = tasks.make_decode_step(cfg)
    lg, caches = prefill(params, {k: v for k, v in batch.items()
                                  if k != "labels"})
    out = [lg]
    pos = SEQ + cfg.frontend.n_tokens
    for i in range(DECODES):
        lg, caches = decode(params, caches, tokens[:, i:i + 1], pos + i)
        out.append(lg)
    return out


def _mesh_and_rows(batch, dp, mp):
    mesh = build_mesh(dp, mp, "cpu")
    r = mesh.get_coordinate()[0]
    n = BATCH // dp
    return mesh, r, n, {k: v[r * n:(r + 1) * n] for k, v in batch.items()}


def _leaf_gaps(g_one, g_two):
    """Each leaf's max |one - two| over the one-device max |grad|."""
    return {"/".join(path): float((a - b).abs().max()
                                  / a.abs().max().clamp_min(1e-30))
            for (path, a), (_, b) in zip(leaves(g_one), leaves(g_two))}


def config(arch):
    """A case's reduced config; ``UNDIVIDED``: mamba2-370m's at width 192,
    6 SSD heads of 64."""
    if arch != UNDIVIDED:
        return configs.get_reduced(arch)
    import dataclasses
    from repro_torch.config import SSMConfig
    return dataclasses.replace(
        configs.get_reduced("mamba2-370m"), d_model=192,
        ssm=SSMConfig(d_state=32, expand=2, head_dim=64, chunk=32, d_conv=4))


def grad_case(arch, dp, mp):
    """The first step's gradients alone, one device against the mesh."""
    cfg = config(arch)
    spec = Backbone(cfg).spec()
    batch = tasks.synthetic_batch(cfg, BATCH, SEQ, seed=1, device="cpu")
    step = tasks.make_train_step(cfg, OPT)
    g_one = _grads(step, _fresh(cfg).params, batch)
    mesh, r, n, rows = _mesh_and_rows(batch, dp, mp)
    rules = sh.production_rules(mesh)
    plan = RulePlan(mesh, spec, rules)
    with sh.param_gather(mesh, rules):
        g_two = _grads(step, plan.shard_state(_fresh(cfg).params), rows)
    g_two = plan.gather_state(sh.mesh_grads(g_two, spec, mesh, rules)[0])
    return {"grad_gaps": _leaf_gaps(g_one, g_two)}


def case(arch, dp, mp, train=True):
    """One device against the (dp, mp) mesh: the first step's gradients,
    two LM train steps, then the trained params' prefill and decode steps;
    with ``train=False`` the serving steps alone, on the initial params."""
    cfg = configs.get_reduced(arch)
    spec = Backbone(cfg).spec()
    batch = tasks.synthetic_batch(cfg, BATCH, SEQ, seed=1, device="cpu")
    step = tasks.make_train_step(cfg, OPT)
    one = _fresh(cfg)
    if train:
        g_one = _grads(step, one.params, batch)
        m_one = [step(one, batch)[1] for _ in range(STEPS)]
    lg_one = _serve(cfg, one.params, batch, torch.zeros(
        (BATCH, DECODES), dtype=torch.int32))
    tokens = torch.stack([g.argmax(-1) for g in lg_one[:DECODES]],
                         1).to(torch.int32)
    lg_one = _serve(cfg, one.params, batch, tokens)

    mesh, r, n, rows = _mesh_and_rows(batch, dp, mp)
    rules = sh.production_rules(mesh)
    rec = Recorder()
    for axis in ("data", "model"):
        rec.axes[tuple(dist.get_process_group_ranks(
            mesh.get_group(axis)))] = axis
    plan = RulePlan(mesh, spec, rules)
    local = plan.shard_state(_fresh(cfg).params)
    state = tasks.TrainState(local, optim.adamw_init(local))
    with sh.param_gather(mesh, rules):
        if train:
            g_two = _grads(step, local, rows)
            with rec:
                m_two = [step(state, rows)[1] for _ in range(STEPS)]
        train_log, rec.log = rec.log, set()
        with rec:
            lg_two = _serve(cfg, plan.shard_state(one.params),
                            rows, tokens[r * n:(r + 1) * n])
    lg_gap = torch.tensor(max(
        float((a[r * n:(r + 1) * n] - b).abs().max() / a.abs().max())
        for a, b in zip(lg_one, lg_two)))
    dist.all_reduce(lg_gap, op=dist.ReduceOp.MAX)
    experts = expert_tables(spec)
    out = {"local_experts": sorted({tuple(t.shape) for path, t in
                                    leaves(local) if path in experts}),
           "expert_uses": sorted(rec.expert_uses),
           "logit_gap": float(lg_gap),
           "logits_shape": tuple(lg_two[0].shape),
           "serve_collectives": sorted(rec.log),
           "model_gathers": sorted(rec.model_gathers),
           "tp_leaf_gathers": _gather_shapes(spec, rules, mesh,
                                             tp_leaves(spec)),
           "ssm_leaf_gathers": _gather_shapes(
               spec, rules, mesh,
               [p for p, _ in leaves(spec) if "ssm" in p]),
           "ssm_bc_gather": _bc_gather_shape(cfg, mp)}
    if not train:
        return out
    g_two = plan.gather_state(sh.mesh_grads(g_two, spec, mesh, rules)[0])
    g_gaps = _leaf_gaps(g_one, g_two)
    whole = plan.gather_state(state.params)
    gap = max(float((a - b).abs().max()) for (_, a), (_, b) in zip(
        leaves(one.params), leaves(whole)))
    out.update(
        loss=[[float(m["loss"]) for m in ms] for ms in (m_one, m_two)],
        gnorm=[[float(m["grad_norm"]) for m in ms] for ms in (m_one, m_two)],
        grad_gap=max(g_gaps.values()), grad_gaps=g_gaps, param_gap=gap,
        train_collectives=sorted(train_log))
    return out


def _bc_gather_shape(cfg, mp):
    """The output shape of a Mamba-2 block's one all-gather over "model"
    in training (route (a), ``models/ssm.py``: the B and C columns of
    in_proj, conv_w and conv_b, d_model + d_conv + 1 rows of 2N / mp a
    rank, gathered as dim 0), or None for an arch without one."""
    if cfg.ssm is None or cfg.family not in ("ssm", "hybrid"):
        return None
    return (2 * cfg.ssm.d_state, cfg.d_model + cfg.ssm.d_conv + 1)


def _gather_shapes(spec, rules, mesh, paths):
    """Each stored "model" shard of the leaves at ``paths`` (a layer's
    slice of the stacked leaf) as an all-gather over "model" would output
    it."""
    out = {}
    for path in paths:
        s = _at(spec, path)
        # the stacking dims: (layers,), or the hybrid's (groups, every)
        lead = 2 if s.axes[:2] == ("groups", None) else 1
        shape, axes = s.shape[lead:], s.axes[lead:]
        m = sh.stored_layout(shape, axes, rules.stored, mesh)[1]
        if m is not None:
            out["/".join(path)] = gathered_shape(shape, m)
    return out


# (name, narrowed arch, (dp, mp), REPRO_MOE_MODE): MLA's heads and the
# experts' hidden dim over "model" (torch_dist_worker's MoE archs),
# Mamba-2's SSD heads (``narrow``; the flux case is flow_grpo_2x2), and
# the experts over "model" (ep_model)
FLOW_CASES = (("flow_grpo_deepseek_2x2", "deepseek-v2-236b", (2, 2), None),
              ("flow_grpo_grok_1x4", "grok-1-314b", (1, 4), None),
              ("flow_grpo_mamba2_2x2", "mamba2-370m", (2, 2), None),
              ("flow_grpo_deepseek_ep_2x2", "deepseek-v2-236b", (2, 2),
               "ep_model"))
# a checkpoint of the first FLOW_CASES case (tensor mode at (2, 2)),
# restored under ep_model at (1, 4)
CROSS = ("flow_grpo_deepseek_2x2", "deepseek-v2-236b", (1, 4), "ep_model")


def narrow(dw, arch):
    """A flow case's arch narrowed for the CPU: torch_dist_worker's MoE
    archs, or mamba2-370m's reduced config at width 64 (2 layers, 8 SSD
    heads of 16, state 16, chunk 16)."""
    if arch != "mamba2-370m":
        return dw.moe_arch(arch)
    import dataclasses
    from repro_torch.config import SSMConfig
    return dataclasses.replace(
        configs.get_reduced(arch), d_model=64, vocab_size=64,
        ssm=SSMConfig(d_state=16, expand=2, head_dim=16, chunk=16, d_conv=4))


def _rules_trainer(dw, cfg, dp, mp, mesh):
    from repro_torch import registry
    from repro_torch.config import DistConfig, FlowRLConfig
    return registry.build(
        "trainer", "flow_grpo", cfg,
        FlowRLConfig(**dw.FLOW, rewards=dw.REWARDS), dw.OPT, seed=0,
        cond_dim=dw.COND_DIM, dtype=torch.float32, device="cpu",
        dist=DistConfig(data_parallel=dp, model_parallel=mp), mesh=mesh,
        rules=True)


def flow_case(dp=2, mp=2, arch=None, tmp=None, name=None):
    """``flow_grpo``, two steps, f32: one device against the (dp, mp) mesh
    under the production rules (every rank builds the canonical params
    from the same seed, then keeps its shards); ``arch`` narrowed by
    ``narrow`` (the narrowed ``flux_dit`` without).
    With ``tmp`` the two steps' canonical state is checkpointed there
    (under ``name``), restored by a new trainer under the rules and both
    take a third step."""
    import torch_dist_worker as dw
    from repro_torch import checkpoint
    from repro_torch.config import DistConfig
    cfg = narrow(dw, arch) if arch else dw.arch()
    ref, h_ref = dw.train("flow_grpo", mesh=None, dist_cfg=DistConfig(),
                          arch_cfg=cfg)
    mesh = build_mesh(dp, mp, "cpu")
    tr = _rules_trainer(dw, cfg, dp, mp, mesh)
    canonical = dw.build("flow_grpo", mesh=None, dist_cfg=DistConfig(),
                         arch_cfg=cfg).state.params
    # the layout's own round trips, before any step: the canonical state
    # (the one-device params, the same seed), the checkpoint slicer and
    # the byte report
    back = tr.canonical_state()
    canon_equal = all(torch.equal(a, b) for (_, a), (_, b) in zip(
        leaves(canonical), leaves(back.params)))
    cut = tr.state_slicer()
    sliced_equal = all(
        torch.equal(torch.as_tensor(cut("params/" + "/".join(path),
                                        a.numpy())), b)
        for (path, a), (_, b) in zip(leaves(canonical),
                                     leaves(tr.state.params)))
    report = memory.state_bytes(tr)
    try:
        ServingEngine.for_trainer(tr)
        engine_refused = False
    except ValueError:
        engine_refused = True
    cond = dw.cond_batch(2)
    hist = [{k: float(v) for k, v in tr.step(cond, 7, it=it).items()}
            for it in range(2)]
    whole = tr.canonical_state()
    gap = max(float((a - b).abs().max()) for (_, a), (_, b) in zip(
        leaves(ref.state.params), leaves(whole.params)))
    moments = max(float((a - b).abs().max() / a.abs().max())
                  for (_, a), (_, b) in zip(leaves(ref.state.opt.mu),
                                            leaves(whole.opt.mu)))
    out = {"metrics": [h_ref, hist], "param_gap": gap, "mu_gap": moments,
           "canonical_equal": canon_equal, "sliced_equal": sliced_equal,
           "bytes": report, "bytes_one": memory.state_bytes(ref),
           "engine_refused": engine_refused}
    if tmp is not None:
        ckpt = os.path.join(tmp, f"ckpt_{name}")
        if dist.get_rank() == 0:
            checkpoint.save_checkpoint(ckpt, 2, whole)
        dist.barrier()
        back = _rules_trainer(dw, cfg, dp, mp, mesh)
        step, back.state = checkpoint.restore_latest(ckpt, back.state,
                                                     back.state_slicer())
        restored = all(torch.equal(a, b) for (_, a), (_, b) in zip(
            leaves(tr.state.params), leaves(back.state.params))) and all(
            torch.equal(a, b) for (_, a), (_, b) in zip(
                leaves(tr.state.opt.mu), leaves(back.state.opt.mu)))
        third = [{k: float(v) for k, v in t.step(cond, 7, it=2).items()}
                 for t in (tr, back)]
        out["resume"] = {
            "step": step, "restored_equal": restored,
            "third_step": third,
            "params_equal": all(torch.equal(a, b) for (_, a), (_, b) in zip(
                leaves(tr.state.params), leaves(back.state.params)))}
    return out


@contextlib.contextmanager
def moe_mode(mode):
    """``REPRO_MOE_MODE`` set to ``mode`` (None: as it was) in the body."""
    prev = os.environ.get("REPRO_MOE_MODE")
    if mode is not None:
        os.environ["REPRO_MOE_MODE"] = mode
    try:
        yield
    finally:
        if prev is None:
            os.environ.pop("REPRO_MOE_MODE", None)
        else:
            os.environ["REPRO_MOE_MODE"] = prev


def cross_mode_resume(tmp, name, arch, dp, mp):
    """A rules trainer built at (dp, mp) under the current
    ``REPRO_MOE_MODE`` restores the checkpoint the case ``name`` saved
    (another mode, another mesh): its canonical state against the
    checkpoint restored on one device, bitwise (params and AdamW
    moments), and the routed expert tables' shapes this rank holds."""
    import torch_dist_worker as dw
    from repro_torch import checkpoint
    from repro_torch.config import DistConfig
    cfg = narrow(dw, arch)
    ckpt = os.path.join(tmp, f"ckpt_{name}")
    one = dw.build("flow_grpo", mesh=None, dist_cfg=DistConfig(),
                   arch_cfg=cfg)
    _, one.state = checkpoint.restore_latest(ckpt, one.state)
    tr = _rules_trainer(dw, cfg, dp, mp, build_mesh(dp, mp, "cpu"))
    step, tr.state = checkpoint.restore_latest(ckpt, tr.state,
                                               tr.state_slicer())
    back = tr.canonical_state()
    experts = sorted({tuple(t.shape) for path, t in leaves(tr.state.params)
                      if path[-1] in ("w_gate", "w_up", "w_down")
                      and "router" in _at(tr.state.params, path[:-1])})
    return {"step": step, "experts": experts,
            "params_equal": all(torch.equal(a, b) for (_, a), (_, b) in zip(
                leaves(one.state.params), leaves(back.params))),
            "mu_equal": all(torch.equal(a, b) for (_, a), (_, b) in zip(
                leaves(one.state.opt.mu), leaves(back.opt.mu)))}


def run(rank, world, store, out):
    """Entry point of one spawned rank: every case in turn (four ranks),
    or the ``UNDIVIDED_CASES`` (three)."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    try:
        res = {}
        if world == 3:
            for name, arch, shape, mode in UNDIVIDED_CASES:
                with moe_mode(mode):
                    res[name] = case(arch, *shape)
            if rank == 0:
                with open(out, "wb") as f:
                    pickle.dump(res, f)
            return
        for cases, fn in ((CASES, case), (GRAD_CASES, grad_case)):
            for name, arch, shape, mode in cases:
                with moe_mode(mode):
                    res[name] = fn(arch, *shape)
        for name, arch, shape, mode in SERVE_CASES:
            with moe_mode(mode):
                res[name].update(case(arch, *shape, train=False))
        res["flow_grpo_2x2"] = flow_case()
        for name, arch, shape, mode in FLOW_CASES:
            with moe_mode(mode):
                res[name] = flow_case(*shape, arch=arch,
                                      tmp=os.path.dirname(out), name=name)
        name, arch, shape, mode = CROSS
        with moe_mode(mode):
            res["cross_mode_resume"] = cross_mode_resume(
                os.path.dirname(out), name, arch, *shape)
        if rank == 0:
            with open(out, "wb") as f:
                pickle.dump(res, f)
    except BaseException:
        with open(f"{out}.err{rank}", "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        dist.destroy_process_group()


def spawn(tmp_path, timeout, world=4):
    """Every case on ``world`` spawned gloo ranks; rank 0's results, or an
    AssertionError with the ranks' tracebacks on a failure or after
    ``timeout`` seconds."""
    import multiprocessing as mp
    import time
    ctx = mp.get_context("spawn")
    store = os.path.join(str(tmp_path), "layout.store")
    out = os.path.join(str(tmp_path), "layout.pkl")
    procs = [ctx.Process(target=run, args=(r, world, store, out))
             for r in range(world)]
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
                   for r in range(world) if os.path.exists(f"{out}.err{r}"))
    if hung or errs or any(p.exitcode for p in procs):
        raise AssertionError(f"layout cases failed or hung (exit codes "
                             f"{[p.exitcode for p in procs]})\n{errs}")
    with open(out, "rb") as f:
        return pickle.load(f)


if __name__ == "__main__":
    import json
    with tempfile.TemporaryDirectory() as tmp:
        res = spawn(tmp, 600)
    for k, v in res.items():
        print(k, json.dumps(v))
