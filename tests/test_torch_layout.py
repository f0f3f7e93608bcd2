"""The reference's production layout on the port (``repro_torch.sharding``'s
rule tables, ``launch.specs``, tensor parallelism over "model", ZeRO-3
over "data"), against the JAX package, on the CPU.

* The rule tables (``batch_axes``, ``param_rules``, ``act_rules``,
  ``gathered_param_rules``, ``pspec``) equal the reference's key for key,
  under both MoE modes, on duck-typed meshes.
* At (data, model) = (4, 2): the per-leaf shard shapes of ``param_specs``
  (train; inference with and without FSDP), ``train_state_specs``,
  ``cache_specs`` at a divisible batch and the flow step's state equal the
  reference's ``NamedSharding(...).shard_shape`` (a JAX subprocess on 8
  faked CPU devices) for every reduced arch, exactly (the SSM caches by
  SSD head and conv channel too), and a param the reference keeps whole
  on every rank is split over "model" as its trainers' ``PartitionPlan``
  splits it (``sharding.stored_layout``).
* At use (``sharding.use_layout``), every MLA and expert leaf keeps the
  "model" dim of the reference's ``gathered_param_rules`` in tensor and
  dense modes, and its "data" dim except the expert tables' ``moe_in`` /
  ``moe_out``, which the port gathers (``DATA_GATHERED_AXES``); under
  ``ep_model`` every expert table has the reference's at-use layout
  exactly (experts over "model", ``moe_in`` / ``moe_out`` gathered),
  and is gathered whole where the axis does not divide E
  (``GATHERED_WHOLE["experts_undivided"]``).
* The inference-FSDP decision equals the reference's for the 11 full
  archs at mp 16.
* Four gloo ranks, f32, against one device (``tests/torch_layout_worker``,
  one spawn for every case): the first step's gradients, two LM train
  steps, the prefill and four decode steps, and the collectives each
  runs by kind and mesh axis, and the leaves all-gathered over "model"
  (none of MLA's, the experts' or the Mamba-2 blocks'); the router's,
  MLA's latent projections' and the Mamba-2 blocks' gradients at mp 2
  and 4; two ``flow_grpo`` steps laid out by the rules
  (``BaseTrainer(..., rules=True)``, the dry run's flow step), and that
  trainer's canonical state, checkpoint slicer and byte report, on the
  narrowed ``flux_dit``, the two MoE archs and ``mamba2-370m``, whose
  checkpoints resume exactly.
* Expert parallelism (``REPRO_MOE_MODE=ep_model``) on the same ranks:
  deepseek at (2, 2) and (1, 4), grok at (1, 4), each rank holding and
  using E / mp experts at the whole hidden dim, with tensor mode's
  collectives; the undivided deepseek at (1, 3) on three ranks, gathered
  whole; a ``flow_grpo`` trainer under it, and a tensor-mode checkpoint
  resumed under it; and ``chip_smoke.py``'s phase 42 on 4 host threads.
"""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro import sharding as jsh
from repro.launch import specs as jspecs
from repro_torch import configs as tconfigs
from repro_torch import sharding as tsh
from repro_torch.config import InputShape
from repro_torch.launch import specs as tspecs
from repro_torch.models import params as tparams
from repro_torch.models.backbone import Backbone, _parts

import torch_layout_worker as worker
from torch_parity import one_torch_thread  # noqa: F401  (autouse fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")
REDUCED = tconfigs.ARCH_IDS + tconfigs.PAPER_ARCHS
DECODE = ("d", 64, 8, "decode")


class DuckMesh:
    """What the rule tables and the shard shapes read of a mesh: axis
    names and sizes (the reference's ``axis_names`` / ``shape``, the
    port's ``size``), rank 0's coordinate and no groups."""

    def __init__(self, names, sizes):
        self.axis_names = tuple(names)
        self.shape = dict(zip(names, sizes))

    def size(self, dim):
        return list(self.shape.values())[dim]

    def get_coordinate(self):
        return [0] * len(self.axis_names)

    def get_group(self, name):
        return None


MESHES = [(("data", "model"), (4, 2)), (("pod", "data", "model"), (2, 4, 2)),
          (("model",), (2,))]


# ----------------------------------------------------------- rule tables
@pytest.mark.parametrize("moe_mode", ["tensor", "ep_model"])
@pytest.mark.parametrize("names,sizes", MESHES)
def test_rule_tables_equal_reference(names, sizes, moe_mode, monkeypatch):
    """Every table for every switch, equal key for key (exact); ``pspec``
    over the logical axes of every reduced arch's leaves."""
    monkeypatch.setenv("REPRO_MOE_MODE", moe_mode)
    mesh = DuckMesh(names, sizes)
    assert tsh.batch_axes(mesh) == jsh.batch_axes(mesh)
    for fsdp in (True, False):
        for train in (True, False):
            assert tsh.param_rules(mesh, fsdp=fsdp, train=train) == \
                jsh.param_rules(mesh, fsdp=fsdp, train=train)
    for seq in (True, False):
        assert tsh.act_rules(mesh, seq_shard=seq) == \
            jsh.act_rules(mesh, seq_shard=seq)
    assert tsh.gathered_param_rules(mesh) == jsh.gathered_param_rules(mesh)
    rules = [tsh.param_rules(mesh), tsh.act_rules(mesh),
             tsh.gathered_param_rules(mesh)]
    for a in REDUCED:
        for _, p in tparams.leaves(Backbone(
                tconfigs.get_reduced(a)).spec()):
            for r in rules:
                assert tsh.pspec(p.axes, r) == tuple(jsh.pspec(p.axes, r))


def test_production_rules_are_the_reference_defaults():
    """``production_rules``: what the reference's ``set_param_gather(mesh)``
    installs for training (``gathered_param_rules``, ``act_rules``) over
    storage by ``param_rules``; every ``GATHERED_WHOLE`` entry gives its
    reason."""
    mesh = DuckMesh(("data", "model"), (4, 2))
    r = tsh.production_rules(mesh)
    assert r.prules == jsh.gathered_param_rules(mesh)
    assert r.arules == jsh.act_rules(mesh)
    assert r.stored == jsh.param_rules(mesh, fsdp=True)
    assert tsh.production_rules(mesh, fsdp=False).stored == \
        jsh.param_rules(mesh, fsdp=False)
    assert set(tsh.GATHERED_WHOLE) == {"ssm_undivided", "experts_undivided"}
    assert all(len(why) > 40 for why in tsh.GATHERED_WHOLE.values())


@pytest.mark.parametrize("moe_mode", ["tensor", "dense", "ep_model"])
def test_parts_gather_experts_whole_under_ep_model_only(moe_mode,
                                                        monkeypatch):
    """``_parts`` names no MLA part, and the routed experts' tables
    ("experts_undivided") under ``ep_model`` only, and there only where
    the "model" axis does not divide E (the reduced 4 experts over 3;
    over 2 and 4 each rank runs its own experts, expert-parallel); the
    SSM blocks in no mode where the "model" axis divides their heads and
    state (16 and 32 in the reduced zamba2: mp 2 and 4), and as
    "ssm_undivided" where it does not (mp 3)."""
    monkeypatch.setenv("REPRO_MOE_MODE", moe_mode)
    for arch in ("deepseek-v2-236b", "grok-1-314b", "zamba2-2.7b"):
        bb = Backbone(tconfigs.get_reduced(arch))
        parts = _parts(bb.cfg, bb._block_spec)
        if arch == "zamba2-2.7b":
            assert parts is None
            assert all(_parts(bb.cfg, bb._block_spec, mp) is None
                       for mp in (2, 4, 16))
            assert _parts(bb.cfg, bb._block_spec, 3) == {
                "ssm": "ssm_undivided"}
            continue
        assert parts is None
        assert all(_parts(bb.cfg, bb._block_spec, mp) is None
                   for mp in (2, 4))
        if moe_mode == "ep_model":
            assert _parts(bb.cfg, bb._block_spec, 3) == {
                "ffn": {k: "experts_undivided" for k in
                        ("w_gate", "w_up", "w_down")}}
        else:
            assert _parts(bb.cfg, bb._block_spec, 3) is None
    assert _parts(bb.cfg, Backbone(tconfigs.get_reduced(
        "deepseek-v2-236b"))._dense_spec) is None


def _ref_use(shape, axes, rules, mesh):
    """The reference's at-use (data dim, model dim) of a leaf: its
    ``pspec`` under ``gathered_param_rules``, a sharding dropped where the
    axis does not divide the dim (``repro/launch/specs.py:66-72``)."""
    data = model = None
    for i, (n, m) in enumerate(zip(shape, jsh.pspec(axes, rules))):
        if m is None or n % mesh.shape[m]:
            continue
        if m == "data":
            data = i
        if m == "model":
            model = i
    return data, model


@pytest.mark.parametrize("moe_mode", ["tensor", "dense", "ep_model"])
@pytest.mark.parametrize("arch", ["deepseek-v2-236b", "grok-1-314b"])
def test_mla_and_expert_use_layout_equals_reference(arch, moe_mode,
                                                     monkeypatch):
    """At (4, 2), each leaf of an MLA block and each expert table at use
    (``sharding.use_layout`` with the block's ``_parts``): its "model" dim
    is the reference's ``gathered_param_rules`` one (tensor and dense
    modes; the experts' hidden dim, MLA's heads); its "data" dim too,
    except ``moe_in`` / ``moe_out``, which the reference keeps over
    "data" and the port gathers (a difference by construction); under
    ``ep_model`` the expert tables' layout is the reference's exactly,
    both dims (experts over "model", ``moe_in`` / ``moe_out`` gathered
    over "data"), at the mesh's 2 "model" ranks and, gathered whole as
    the reference keeps them, at 3, which does not divide E."""
    monkeypatch.setenv("REPRO_MOE_MODE", moe_mode)
    ref_rules = jsh.gathered_param_rules(MESH)
    rules = tsh.production_rules(MESH)
    assert rules.prules == ref_rules
    bb = Backbone(tconfigs.get_reduced(arch))
    seen = 0
    for spec in (bb._block_spec, getattr(bb, "_dense_spec", None)):
        if spec is None:
            continue
        parts = _parts(bb.cfg, spec) or {}
        for path, p in tparams.leaves(spec):
            expert = path[0] == "ffn" and "router" in spec["ffn"] and \
                path[1] in ("w_gate", "w_up", "w_down")
            if not (expert or (path[0] == "attn" and bb.cfg.mla)):
                continue
            part = parts.get("ffn", {}).get(path[1]) if expert else None
            got = tsh.use_layout(p.shape, p.axes, rules, MESH, part)
            want = _ref_use(p.shape, p.axes, ref_rules, MESH)
            if expert and moe_mode == "ep_model":
                assert part is None
                assert got == want, path
                assert p.axes[want[1]] == "experts_mdl", path
                assert want[0] is None, path
                part3 = (_parts(bb.cfg, spec, 3) or {})["ffn"][path[1]]
                assert tsh.use_layout(p.shape, p.axes, rules, MESH3,
                                      part3) == (None, None) == _ref_use(
                    p.shape, p.axes, jsh.gathered_param_rules(MESH3),
                    MESH3), path
            else:
                assert got[1] == want[1], path
                gathered = want[0] is not None and \
                    p.axes[want[0]] in ("moe_in", "moe_out")
                assert got[0] == (None if gathered else want[0]), path
                assert gathered == (expert and want[0] is not None)
            seen += 1
    assert seen >= (11 if arch == "deepseek-v2-236b" else 3)


# ------------------------------------------------------ shard shapes
_REF_SHARDS = """
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import json
    import jax, numpy as np
    from jax.sharding import NamedSharding, PartitionSpec
    from repro import configs, sharding as shlib
    from repro.config import FlowRLConfig, InputShape
    from repro.launch import specs
    from repro.models import params as params_lib
    from repro.models.flow import FlowAdapter
    from repro.models.backbone import Backbone
    mesh = jax.sharding.Mesh(np.array(jax.devices()).reshape(4, 2),
                             ("data", "model"))
    is_ax = lambda x: isinstance(x, tuple) and all(
        isinstance(e, (str, type(None))) for e in x)

    def name(path):
        return ".".join(str(getattr(k, "key", getattr(k, "name", k)))
                        for k in path)

    def flat(shapes, shards):
        out = {}
        for (path, s), sh in zip(
                jax.tree_util.tree_flatten_with_path(shapes)[0],
                jax.tree.leaves(shards)):
            out[name(path)] = list(sh.shard_shape(s.shape))
        return out

    def plan(spec):
        # each param's whole shape and the reference trainers'
        # PartitionPlan dim over a "model" axis of 2
        axes = jax.tree_util.tree_flatten_with_path(
            params_lib.axes_tree(spec), is_leaf=is_ax)[0]
        shapes = jax.tree.leaves(params_lib.shape_tree(spec,
                                                       jax.numpy.bfloat16))
        return {name(path): [list(s.shape),
                             params_lib.model_shard_dim(s.shape, ax, 2)]
                for (path, ax), s in zip(axes, shapes)}

    out = {}
    for a in configs.ARCH_IDS + configs.PAPER_ARCHS:
        cfg = configs.get_reduced(a)
        rec = {"plan": plan(Backbone(cfg).spec()),
               "train": flat(*specs.param_specs(cfg, mesh, train=True)),
               "serve": flat(*specs.param_specs(cfg, mesh, train=False,
                                                fsdp=False)),
               "serve_fsdp": flat(*specs.param_specs(cfg, mesh, train=False,
                                                     fsdp=True))}
        st, sts = specs.train_state_specs(cfg, mesh)
        rec["state"] = flat(st, sts)
        cs, css = specs.cache_specs(cfg, InputShape(*%r), mesh)
        rec["caches"] = [[list(s.shape), list(sh.shard_shape(s.shape)),
                          [e for e in sh.spec] + [None] * (
                              len(s.shape) - len(sh.spec))]
                         for s, sh in zip(jax.tree.leaves(cs),
                                          jax.tree.leaves(css))]
        # the flow step's state: build_flow_step's rules (specs.py:257)
        spec = FlowAdapter(cfg, FlowRLConfig(
            num_steps=10, group_size=8, latent_tokens=1024, latent_dim=16),
            512).spec()
        rules = shlib.param_rules(mesh, fsdp=True, train=True)
        shapes = params_lib.shape_tree(spec, jax.numpy.bfloat16)
        axes = params_lib.axes_tree(spec)
        rec["flow_plan"] = plan(spec)

        def to_shard(ax, s):
            sp = []
            for n, dim in zip(ax, s.shape):
                m = rules.get(n) if n else None
                if m is not None and not specs._divisible(dim, mesh, m):
                    m = None
                sp.append(m)
            return NamedSharding(mesh, PartitionSpec(*sp))
        rec["flow"] = flat(shapes, jax.tree.map(to_shard, axes, shapes,
                                                is_leaf=is_ax))
        out[a] = rec
    print(json.dumps(out))
""" % (DECODE,)


def _run(code: str, timeout: int = 300) -> str:
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                       capture_output=True, text=True, timeout=timeout,
                       env={**os.environ, "PYTHONPATH": SRC,
                            "OMP_NUM_THREADS": "1"}, cwd=ROOT)
    assert r.returncode == 0, r.stderr[-3000:]
    return r.stdout


@pytest.fixture(scope="module")
def ref_shards():
    return json.loads(_run(_REF_SHARDS).strip().splitlines()[-1])


def _shapes(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_shapes(tree[k], f"{prefix}{k}."))
        return out
    if isinstance(tree, tuple):
        out = {}
        for name, v in zip(getattr(tree, "_fields", range(len(tree))), tree):
            out.update(_shapes(v, f"{prefix}{name}."))
        return out
    return {prefix[:-1]: list(tree.shape)}


MESH = DuckMesh(("data", "model"), (4, 2))
# a "model" axis that does not divide the reduced MoE archs' 4 experts
MESH3 = DuckMesh(("data", "model"), (4, 3))


def _stored(ref, plan):
    """The reference's shard shapes, except that a leaf the reference
    keeps whole on every rank is split over "model" (2 ranks) on the dim
    of the reference trainers' ``PartitionPlan``
    (``repro.models.params.model_shard_dim``; ``plan``: each param's whole
    shape and that dim): the port's storage of such leaves
    (``sharding.stored_layout``, a difference by construction)."""
    out = {}
    for key, shard in ref.items():
        p = max((k for k in plan if key == k or key.endswith("." + k)),
                key=len, default=None)
        if p is not None and shard == plan[p][0] and plan[p][1] is not None:
            shard = list(shard)
            shard[plan[p][1]] //= 2
        out[key] = shard
    return out


@pytest.mark.parametrize("arch", REDUCED)
def test_param_shards_equal_reference(ref_shards, arch):
    """``param_specs`` for training and for serving (the threshold's
    choice, and FSDP forced), and ``train_state_specs`` (params and both
    moments; the step counter a scalar): this rank's shard of every leaf
    is the reference's ``shard_shape``, exactly, where a leaf the
    reference keeps whole on every rank is split over "model" as its
    ``PartitionPlan`` splits it (``_stored``)."""
    cfg = tconfigs.get_reduced(arch)
    ref = ref_shards[arch]
    plan = ref["plan"]
    assert _shapes(tspecs.param_specs(cfg, MESH, train=True)[0]) == \
        _stored(ref["train"], plan)
    assert _shapes(tspecs.param_specs(cfg, MESH, train=False,
                                      fsdp=False)[0]) == \
        _stored(ref["serve"], plan)
    assert _shapes(tspecs.param_specs(cfg, MESH, train=False,
                                      fsdp=True)[0]) == \
        _stored(ref["serve_fsdp"], plan)
    st, _ = tspecs.train_state_specs(cfg, MESH)
    assert _shapes(st) == _stored(ref["state"], plan)


@pytest.mark.parametrize("arch", REDUCED)
def test_cache_and_flow_shards_equal_reference(ref_shards, arch):
    """``cache_specs`` at batch 8 (divisible by the data axis) and the
    flow update's state (``build_flow_step``): the reference's shard
    shapes, exactly; kv heads over "model" where 2 divides them, and the
    SSM caches' conv channels (``inner``) and states (``ssm_heads``)
    too: the Mamba-2 blocks run tensor-parallel over their heads."""
    cfg = tconfigs.get_reduced(arch)
    ref = ref_shards[arch]
    caches = tspecs.cache_specs(cfg, InputShape(*DECODE), MESH)
    got = list(_shapes(caches).items())
    assert len(got) == len(ref["caches"])
    for (name, shape), (whole, shard, spec) in zip(got, ref["caches"]):
        assert shape == shard, name
    _, (state, _, _) = tspecs.build_flow_step(cfg, MESH)
    flow = _stored(ref["flow"], ref["flow_plan"])
    assert _shapes(state.params) == flow
    assert _shapes(state.opt.mu) == flow


@pytest.mark.parametrize("arch", tconfigs.ARCH_IDS + tconfigs.PAPER_ARCHS)
def test_inference_fsdp_decision_equals_reference(arch):
    """At mp 16 serving weights shard over "data" exactly where the
    reference's ``param_specs(train=False, fsdp=False)`` would: bf16
    weights over "model" alone above 10e9 bytes a rank."""
    cfg = tconfigs.get(arch)
    want = (2.0 * jconfigs.get(arch).n_params() / 16
            > jspecs.INFERENCE_FSDP_THRESHOLD)
    assert tspecs.INFERENCE_FSDP_THRESHOLD == jspecs.INFERENCE_FSDP_THRESHOLD
    assert tspecs.inference_fsdp(cfg, DuckMesh(("data", "model"),
                                               (16, 16))) == want


# ------------------------------------------------- four gloo ranks
@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    return worker.spawn(tmp_path_factory.mktemp("layout"), 240)


CASES = [c[0] for c in worker.CASES]


@pytest.mark.parametrize("case", CASES)
def test_layout_train_steps_match_one_device(four_ranks, case):
    """Two LM train steps on the mesh against one device on the whole
    batch, f32.  The first step's gradients (before the clip) to 1e-5 of
    each leaf's max |grad| (measured ≤ 2.0e-6): every matmul's partial
    sums reduce in another order under tensor parallelism.  Loss and grad
    norm of both steps to 1e-5 relative.  Params after the two AdamW
    steps at lr 1e-3 to 1e-4 absolute (measured 1.3e-5 – 4.6e-5): AdamW's
    first steps divide each gradient by its own magnitude, so the
    reordering noise of a near-zero gradient shows at a few % of the step
    size; a wrong reduction moves the gradients by O(1) of their max."""
    r = four_ranks[case]
    assert r["grad_gap"] < 1e-5
    np.testing.assert_allclose(r["loss"][1], r["loss"][0], rtol=1e-5)
    np.testing.assert_allclose(r["gnorm"][1], r["gnorm"][0], rtol=1e-5)
    assert r["param_gap"] < 1e-4


@pytest.mark.parametrize("case", CASES + [c[0] for c in
                                         worker.SERVE_CASES])
def test_layout_prefill_and_decode_match_one_device(four_ranks, case):
    """The prefill's last logits and four decode steps (the one-device
    trained params, this rank's rows; the initial ones for the
    ``SERVE_CASES``): within 1e-5 of max |logits| of one device, and
    gathered over "model" to the whole vocabulary."""
    r = four_ranks[case]
    serving = worker.CASES + worker.SERVE_CASES
    cfg = tconfigs.get_reduced(dict((c[0], c[1]) for c in serving)[case])
    dp = dict((c[0], c[2]) for c in serving)[case][0]
    assert r["logit_gap"] < 1e-5
    assert tuple(r["logits_shape"]) == (worker.BATCH // dp, cfg.vocab_size)


# collectives a case issues, by (kind, mesh axis): the data shards'
# gathers and reduce-scatters, the tensor-parallel all-reduces over
# "model", the gradients' means over "data" (and the load-balance loss's
# means over every data rank's rows); the SSM blocks' B and C columns
# gathered over "model" and their gradients reduce-scattered back (route
# (a), ``models/ssm.py``), and at (1, 4) qwen3's and grok's wk / wv (2 kv
# heads over 4 ranks, no "data" shard at dp 1: stored over "model" on
# embed, ``stored_layout``; grok's router likewise); serving gathers the
# logits over "model" (and the SSM decode its B and C channels)
_TRAIN = {("all-gather", "data"), ("reduce-scatter", "data"),
          ("all-reduce", "model"), ("all-reduce", "data")}
_SERVE = {("all-gather", "data"), ("all-gather", "model"),
          ("all-reduce", "model")}
_TRAIN_1X4 = ({("all-reduce", "model"), ("all-reduce", "data"),
               ("all-gather", "model"), ("reduce-scatter", "model")},
              {("all-gather", "model"), ("all-reduce", "model")})
WANT = {"qwen3_2x2": (_TRAIN, _SERVE),
        "qwen3_1x4": _TRAIN_1X4,
        "internvl2_2x2": (_TRAIN, _SERVE),
        "zamba2_2x2": (_TRAIN | {("all-gather", "model"),
                                 ("reduce-scatter", "model")}, _SERVE),
        "deepseek_2x2": (_TRAIN, _SERVE),
        "grok_1x4": _TRAIN_1X4,
        "grok_dense_2x2": (_TRAIN, _SERVE),
        "mamba2_1x4": _TRAIN_1X4,
        "deepseek_ep_2x2": (_TRAIN, _SERVE),
        "grok_ep_1x4": _TRAIN_1X4}


@pytest.mark.parametrize("case", CASES)
def test_layout_collectives_by_axis(four_ranks, case):
    """Every collective the train steps and the serving steps issue, by
    kind and mesh axis, is what the layout calls for (exact sets)."""
    r = four_ranks[case]
    train, serve = WANT[case]
    assert {tuple(c) for c in r["train_collectives"]} == train
    assert {tuple(c) for c in r["serve_collectives"]} == serve


MOE_CASES = [c[0] for c in worker.CASES if c[1] in ("deepseek-v2-236b",
                                                     "grok-1-314b")]


@pytest.mark.parametrize("case", MOE_CASES)
def test_layout_keeps_mla_and_experts_sharded(four_ranks, case):
    """Under the MoE cases no MLA leaf and no expert table (routed or
    shared) is all-gathered over "model", in training or serving: no
    output shape of the recorder's all-gathers over "model" is one of
    theirs gathered.  Under zamba2 and mamba2 no SSM leaf is: the only
    gather of theirs is the B and C columns of in_proj, conv_w and conv_b
    (route (a), ``models/ssm.py``), whose output shape is seen."""
    r = four_ranks[case]
    assert r["tp_leaf_gathers"]
    gathered = {tuple(s) for s in r["model_gathers"]}
    hit = {k: v for k, v in r["tp_leaf_gathers"].items()
           if tuple(v) in gathered}
    assert not hit
    for ssm_case in ("zamba2_2x2", "mamba2_1x4"):
        z = four_ranks[ssm_case]
        assert z["ssm_leaf_gathers"]
        gathered = {tuple(s) for s in z["model_gathers"]}
        assert not {tuple(v) for v in z["ssm_leaf_gathers"].values()} & \
            gathered, ssm_case
        assert tuple(z["ssm_bc_gather"]) in gathered, ssm_case


# the router at mp 2 and 4, and MLA's latent projections and norms
_ROUTER_CASES = {"deepseek_2x2": 2, "grok_dense_2x2": 2, "grok_1x4": 4,
                 "deepseek_1x4": 4, "deepseek_ep_1x4": 4,
                 "deepseek_ep_2x2": 2, "grok_ep_1x4": 4}


@pytest.mark.parametrize("case", sorted(_ROUTER_CASES))
def test_router_and_latent_gradients_match_one_device(four_ranks, case):
    """The first step's gradient of every layer's router (its gates
    multiply the experts' partial results, and the auxiliary losses are
    computed the same on every "model" rank) and of MLA's latent
    projections and norms (``w_dq``, ``q_norm``, ``w_dkv``, ``kv_norm``:
    whole on every rank, each rank's heads adding a part) at mp 2 and 4,
    within 1e-5 of the leaf's max |grad| of one device: a gradient counted
    mp times, or a part missing, is off by O(1) of it."""
    gaps = four_ranks[case]["grad_gaps"]
    keys = [k for k in gaps if k.endswith(("/router", "/w_dq", "/q_norm",
                                           "/w_dkv", "/kv_norm"))]
    assert any(k.endswith("/router") for k in keys)
    if case.startswith("deepseek"):
        assert sum(k.endswith("/w_dq") for k in keys) == 2
    for k in keys:
        assert gaps[k] < 1e-5, k
    mesh = dict((c[0], c[2]) for c in worker.CASES + worker.GRAD_CASES)
    assert mesh[case][1] == _ROUTER_CASES[case]


# expert parallel (ep_model) and the tensor-mode case of the same arch
# whose collectives it must equal
_EP_CASES = {"deepseek_ep_1x4": None, "deepseek_ep_2x2": "deepseek_2x2",
             "grok_ep_1x4": "grok_1x4"}


def _expert_shapes(cfg, dp, mp, stored):
    """The routed expert tables' shapes a rank holds under ep_model:
    E / mp experts at the whole hidden dim, d_model over "data" in
    storage (``stored``, with the stacked layers' dim) and whole at use."""
    m = cfg.moe
    e, f = m.n_experts // mp, m.expert_d_ff
    d = cfg.d_model // dp if stored else cfg.d_model
    lead = (cfg.n_layers - m.first_k_dense,) if stored else ()
    return sorted({lead + (e, d, f), lead + (e, f, d)})


@pytest.mark.parametrize("case", sorted(_EP_CASES))
def test_ep_model_ranks_run_their_own_experts(four_ranks, case):
    """Under ``REPRO_MOE_MODE=ep_model`` each rank stores its E / mp
    experts at the whole hidden dim (their d_model dim over "data") and
    every MoE call, in training and serving, runs on exactly those, with
    d_model gathered: no rank holds more than E / mp experts at use.  The
    first step's gradient of every leaf is within 1e-5 of its max of one
    device (the tensor-mode cases' band).  The collectives by kind and
    axis are tensor mode's on the same arch and mesh (no all-to-all: the
    rows are replicated over "model", and the routed partials join the
    shared experts' in the one *g*)."""
    r = four_ranks[case]
    arch, (dp, mp), mode = {c[0]: c[1:] for c in
                            worker.CASES + worker.SERVE_CASES}[case]
    assert mode == "ep_model"
    cfg = tconfigs.get_reduced(arch)
    assert [tuple(s) for s in r["local_experts"]] == _expert_shapes(
        cfg, dp, mp, True)
    assert [tuple(s) for s in r["expert_uses"]] == _expert_shapes(
        cfg, dp, mp, False)
    assert max(r["grad_gaps"].values()) < 1e-5
    twin = _EP_CASES[case]
    if twin is not None:
        for k in ("train_collectives", "serve_collectives"):
            assert r[k] == four_ranks[twin][k], k
    assert not any(c[0] == "all-to-all" for k in (
        "train_collectives", "serve_collectives") for c in r.get(k, ()))
    assert r["serve_collectives"]


@pytest.fixture(scope="module")
def three_ranks(tmp_path_factory):
    return worker.spawn(tmp_path_factory.mktemp("layout3"), 120, world=3)


def test_ep_model_undivided_experts_are_gathered_whole(three_ranks):
    """Under ``ep_model`` on a "model" axis of 3, which does not divide
    the reduced deepseek's 4 experts, the routed experts are gathered
    whole (``GATHERED_WHOLE["experts_undivided"]``, the reference's
    layout, which drops the sharding; at dp 1 no dim of theirs divides 3,
    so each rank stores them whole): every MoE call runs all 4 at the
    whole hidden dim, and the case holds one device within the
    tensor-mode cases' bands: gradients to 1e-5 of each leaf's max,
    loss and grad norm to 1e-5 relative, params to 1e-4, logits to
    1e-5."""
    name, arch, (dp, mp), _ = worker.UNDIVIDED_CASES[0]
    r = three_ranks[name]
    cfg = tconfigs.get_reduced(arch)
    m = cfg.moe
    assert [tuple(s) for s in r["expert_uses"]] == sorted(
        {(m.n_experts, cfg.d_model, m.expert_d_ff),
         (m.n_experts, m.expert_d_ff, cfg.d_model)})
    n_moe = cfg.n_layers - m.first_k_dense
    assert [tuple(s) for s in r["local_experts"]] == [
        (n_moe,) + s for s in map(tuple, r["expert_uses"])]
    assert r["grad_gap"] < 1e-5
    np.testing.assert_allclose(r["loss"][1], r["loss"][0], rtol=1e-5)
    np.testing.assert_allclose(r["gnorm"][1], r["gnorm"][0], rtol=1e-5)
    assert r["param_gap"] < 1e-4
    assert r["logit_gap"] < 1e-5


def test_tensor_mode_checkpoint_resumes_under_ep_model(four_ranks):
    """A checkpoint of the narrowed deepseek's two ``flow_grpo`` steps in
    tensor mode at (2, 2), restored by a rules trainer under
    ``ep_model`` at (1, 4): its canonical params and AdamW first moments
    are the checkpoint's, bitwise, while the rank holds one of the 4
    experts at the whole hidden dim."""
    import torch_dist_worker as dw
    r = four_ranks["cross_mode_resume"]
    assert r["step"] == 2
    assert r["params_equal"] and r["mu_equal"]
    _, arch, (dp, mp), _ = worker.CROSS
    cfg = worker.narrow(dw, arch)
    m = cfg.moe
    lead = (cfg.n_layers - m.first_k_dense, m.n_experts // mp)
    assert [tuple(s) for s in r["experts"]] == sorted(
        {lead + (cfg.d_model, m.expert_d_ff),
         lead + (m.expert_d_ff, cfg.d_model)})


# the Mamba-2 blocks at mp 2 and 4, each arch at both
_SSM_CASES = {"zamba2_2x2": 2, "zamba2_1x4": 4, "mamba2_1x4": 4,
              "mamba2_2x2": 2}


@pytest.mark.parametrize("case", sorted(_SSM_CASES))
def test_ssm_gradients_match_one_device(four_ranks, case):
    """The first step's gradient of every Mamba-2 layer's ``in_proj``,
    ``conv_w``, ``conv_b`` and ``norm`` at mp 2 and 4 (the B and C
    columns gathered from every rank, each rank's gradient of them its
    heads' part; the gated norm's statistic summed over the ranks),
    within 1e-5 of the leaf's max |grad| of one device: a 1/mp mean of
    the B and C columns' gradient, or a norm statistic that is only a
    rank's, is off by O(1) of it."""
    gaps = four_ranks[case]["grad_gaps"]
    keys = [k for k in gaps if k.endswith(("/ssm/in_proj", "/ssm/conv_w",
                                           "/ssm/conv_b", "/ssm/norm"))]
    assert len(keys) == 4
    for k in keys:
        assert gaps[k] < 1e-5, k
    mesh = dict((c[0], c[2]) for c in worker.CASES + worker.GRAD_CASES)
    assert mesh[case][1] == _SSM_CASES[case]


def test_undivided_ssm_is_gathered_whole_and_matches_one_device(
        four_ranks):
    """A Mamba-2 block whose heads the "model" axis does not divide (6
    over 4 ranks) runs whole on every rank (``_parts``:
    ``GATHERED_WHOLE["ssm_undivided"]``), its conv stored component by
    component and put back in canonical order when gathered
    (``sharding.unpack``): the first step's gradient of every leaf within
    1e-5 of its max |grad| of one device."""
    cfg = worker.config(worker.UNDIVIDED)
    bb = Backbone(cfg)
    assert _parts(cfg, bb._block_spec, 4) == {"ssm": "ssm_undivided"}
    conv = bb._block_spec["ssm"]["conv_w"]
    assert tsh.packed(conv.parts, conv.shape, 1, 4)
    gaps = four_ranks["mamba2_h6_1x4"]["grad_gaps"]
    assert sum("/ssm/" in k for k in gaps) == 8
    for k, v in gaps.items():
        assert v < 1e-5, k


@pytest.mark.parametrize("n", [2, 4])
def test_packed_cut_round_trips(n):
    """``pack_cut`` takes each component's r-th slice (the indices
    ``pack_columns`` names), and ``unpack`` of the ranks' shards in rank
    order is the canonical tensor, bitwise; ``packed`` holds where every
    width divides and the packed dim is the last."""
    parts = (8, 8, 4, 4, 12)
    t = torch.arange(3 * sum(parts), dtype=torch.float32).reshape(3, -1)
    shards = [tsh.pack_cut(t, 1, parts, n, r) for r in range(n)]
    for r, sh in enumerate(shards):
        assert torch.equal(sh, t[:, tsh.pack_columns(parts, n, r)])
    assert torch.equal(tsh.unpack(torch.cat(shards, 1), 1, parts, n), t)
    assert tsh.packed(parts, tuple(t.shape), 1, n)
    assert not tsh.packed(parts, tuple(t.shape), 0, n)
    assert not tsh.packed(parts, tuple(t.shape), 1, 3)
    assert not tsh.packed((), tuple(t.shape), 1, n)


def test_flow_grpo_under_rules_matches_one_device(four_ranks):
    """Two ``flow_grpo`` steps (rollout, rewards, update) of a narrowed
    ``flux_dit`` laid out by the production rules at (2, 2)
    (``BaseTrainer(..., rules=True)``, as ``build_flow_step``) against one
    device, f32: every metric but the loss to 1e-5 relative (the loss is a
    residue of order 1e-8, to 1e-10 absolute), params to 1e-5 absolute
    (measured 8.0e-7), read back through ``canonical_state``."""
    r = four_ranks["flow_grpo_2x2"]
    for one, two in zip(*r["metrics"]):
        assert set(one) == set(two)
        for k in one:
            if k == "loss":
                assert abs(one[k] - two[k]) < 1e-10
            else:
                np.testing.assert_allclose(two[k], one[k], rtol=1e-5,
                                           atol=1e-7, err_msg=k)
    assert r["param_gap"] < 1e-5


def test_rules_trainer_keeps_checkpoints_canonical(four_ranks):
    """A trainer built with ``rules=True`` has the rules' layout as its
    plan: ``canonical_state()`` gives back the one-device params bitwise
    (the same seed), the
    checkpoint slicer cuts each canonical leaf to this rank's shard
    bitwise, the byte report's total is the one-device state's while a
    rank holds less of it, and after two steps the gathered AdamW first
    moments are the one-device ones to 1e-5 of each leaf's max (they are
    the gradients' average, which the params' band above bounds).  A
    serving engine for it is refused: its rollouts run the
    ``PartitionPlan``'s layout."""
    r = four_ranks["flow_grpo_2x2"]
    assert r["canonical_equal"] and r["sliced_equal"]
    assert r["engine_refused"]
    assert r["bytes"]["total_bytes"] == r["bytes_one"]["total_bytes"]
    assert 0 < r["bytes"]["per_device_bytes"] < r["bytes"]["total_bytes"]
    assert r["bytes"]["sharded_leaves"] > 0
    assert r["mu_gap"] < 1e-5


@pytest.mark.parametrize("case", [c[0] for c in worker.FLOW_CASES])
def test_moe_rules_trainer_matches_one_device_and_resumes(four_ranks, case):
    """``flow_grpo`` on the narrowed ``deepseek-v2-236b`` at (2, 2),
    ``grok-1-314b`` at (1, 4) and ``mamba2-370m`` at (2, 2) built with
    ``rules=True`` (MLA's heads, the experts' hidden dim and the SSD heads
    over "model"), two steps against one device,
    f32: every metric but the loss to 1e-5 relative (the loss, a residue of
    order 1e-8, to 1e-7 absolute), params to the LM cases' 1e-4 absolute
    (measured ≤ 1.0e-5) and the gathered AdamW first moments to 1e-4 of
    each leaf's max (measured ≤ 3.7e-5); its canonical state, slicer and
    byte report as the flux case's.  A checkpoint of the two steps,
    restored by a new trainer under the rules, is the first trainer's
    state bitwise, and the two take the same third step bitwise (metrics
    and params)."""
    r = four_ranks[case]
    for one, two in zip(*r["metrics"]):
        assert set(one) == set(two)
        for k in one:
            if k == "loss":
                assert abs(one[k] - two[k]) < 1e-7
            else:
                np.testing.assert_allclose(two[k], one[k], rtol=1e-5,
                                           atol=1e-7, err_msg=k)
    assert r["param_gap"] < 1e-4 and r["mu_gap"] < 1e-4
    assert r["canonical_equal"] and r["sliced_equal"]
    assert r["bytes"]["total_bytes"] == r["bytes_one"]["total_bytes"]
    assert 0 < r["bytes"]["per_device_bytes"] < r["bytes"]["total_bytes"]
    res = r["resume"]
    assert res["step"] == 2 and res["restored_equal"]
    assert res["third_step"][0] == res["third_step"][1]
    assert res["params_equal"]


def test_rules_trainer_needs_a_mesh():
    """``rules=True`` lays out a mesh: without one the trainer refuses."""
    import torch
    import torch_dist_worker as dw
    from repro_torch import registry
    from repro_torch.config import FlowRLConfig
    with pytest.raises(ValueError, match="production rules"):
        registry.build("trainer", "flow_grpo", dw.arch(),
                       FlowRLConfig(**dw.FLOW, rewards=dw.REWARDS), dw.OPT,
                       cond_dim=dw.COND_DIM, dtype=torch.float32,
                       device="cpu", rules=True)


def test_card_ep_phase_runs_its_ranks_on_the_cpu(monkeypatch):
    """``chip_smoke.py``'s phase 42 (``ep_layer_ranks``) on the CPU at the
    reduced deepseek, mp 4, 2 x 64 rows: the 4 ranks at once on host
    threads over its ``ThreadGroup`` under ``ep_model``, each MoE call on
    one of the 4 experts at the whole hidden dim, the forwards' *g*
    handed f32 (bf16 under ``REPRO_BF16_REDUCE``), every output,
    summed input gradient and weight gradient within the card's 3e-2
    of the whole layer's max; and one rank's routed experts run in
    tensor mode and ep_model with the same products counted."""
    import importlib.util
    path = os.path.join(ROOT, "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke_ep", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    monkeypatch.setattr(cs, "HY_SEQ", 64)
    monkeypatch.setattr(cs, "B_SERVE", 2)
    monkeypatch.setattr(cs, "cuda_ms", lambda fn, iters, warmup=2: (
        fn(), 0.0)[1])
    cfg = tconfigs.get_reduced("deepseek-v2-236b")
    res = cs.ep_layer_ranks(torch.device("cpu"), cfg=cfg, mp=4)
    m, shape = cfg.moe, [2, 64, cfg.d_model]
    for tag, bf16 in cs.EP_PASSES:
        dtype = "torch.bfloat16" if bf16 else "torch.float32"
        for name in ("attn", "ffn"):
            r = res[tag][name]
            assert max(r["gaps"].values()) <= cs.LAYER_RANK_BAND, (tag, name)
            assert r["g_all_reduces"] == [[dtype, shape]], (tag, name)
        assert [tuple(s) for s in res[tag]["ffn"]["expert_uses"]] == sorted(
            {(1, cfg.d_model, m.expert_d_ff),
             (1, m.expert_d_ff, cfg.d_model)})
        assert res[tag]["attn"]["q_calls"] == 4
    t = res["expert_times"]
    assert (t["tensor"]["experts"], t["tensor"]["f"]) == (4, 32)
    assert (t["ep_model"]["experts"], t["ep_model"]["f"]) == (1, 128)
    assert t["tensor"]["mbytes"] == t["ep_model"]["mbytes"]
