"""The port's launch tooling (``repro_torch.launch``: ``mesh``, ``costs``,
``hlo_stats``, ``specs``, ``dryrun``, ``sweep``) and the ``RunConfig``
fields it reads, against the JAX package, on the CPU.

* ``RunConfig`` with the reference's ``shape``, ``mesh``, ``sharding`` and
  ``activ_dtype`` round-trips between the packages, equal.
* ``costs.step_costs`` and ``matmul_params_active`` equal the reference's
  exactly (``==``) for every arch and input shape.
* The collective log's bytes equal the reference's ``collective_bytes`` on
  the reference test's synthetic HLO, fed as the same 13 records.
* On a ``fake`` process group of 8 ranks (4 x 2), in a subprocess (the
  group is global to its process): the reduced ``qwen3-32b`` train step
  logs collectives, three archs' decode steps run on meta, and the flow
  state's per-rank bytes equal those of the reference's
  ``build_flow_step`` layout (its FSDP rule tables), and at ``fsdp=False``
  the reference ``PartitionPlan``'s ``bytes_report`` (a JAX subprocess on
  8 host devices), for every reduced arch, exactly.
* The kernel wrappers' meta route: hand-kernel shapes and dtypes, no
  build, no launch, no capability check.
* The LM train step on a 2-rank gloo mesh (dp = 2) against one device.
* ``sweep``'s grid against the reference's, and a CPU sweep of two combos
  that a rerun skips.
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
from repro import config as jconfig
from repro.launch import costs as jcosts
from repro.launch import hlo_stats as jhlo
from repro_torch import config as tconfig
from repro_torch import configs as tconfigs
from repro_torch.kernels import _build, ops
from repro_torch.kernels import counts as kcounts
from repro_torch.kernels import ref
from repro_torch.launch import costs as tcosts
from repro_torch.launch import hlo_stats as thlo
from repro_torch.launch import sweep as tsweep

from torch_parity import one_torch_thread  # noqa: F401  (autouse fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")
ARCHS = tconfigs.ARCH_IDS + tconfigs.PAPER_ARCHS


def _run(code: str, timeout: int = 240, env=None) -> str:
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                       capture_output=True, text=True, timeout=timeout,
                       env={**os.environ, "PYTHONPATH": SRC,
                            "OMP_NUM_THREADS": "1", **(env or {})},
                       cwd=ROOT)
    assert r.returncode == 0, r.stderr[-3000:]
    return r.stdout


# ----------------------------------------------------------- RunConfig
def test_runconfig_round_trips_reference_fields():
    """A reference run file with non-default shape, mesh, sharding and
    activ_dtype loads in the port and comes back equal (exact)."""
    jcfg = jconfig.RunConfig(
        arch="yi-9b", shape="decode_32k",
        mesh=jconfig.MeshConfig(data=4, model=8, pods=2),
        sharding=jconfig.ShardingConfig(fsdp=False, seq_shard_decode=False,
                                        remat="none"),
        activ_dtype="float32")
    d = jconfig.to_dict(jcfg)
    tcfg = tconfig.from_dict(tconfig.RunConfig, d)
    assert tconfig.to_dict(tcfg) == d
    assert list(tconfig.to_dict(tcfg)) == list(d)       # the field order
    assert tcfg.mesh.n_devices == jcfg.mesh.n_devices == 64
    assert list(tconfig.to_dict(tconfig.RunConfig())) == list(
        jconfig.to_dict(jconfig.RunConfig()))


# --------------------------------------------------------------- costs
@pytest.mark.parametrize("arch", ARCHS)
def test_step_costs_equal_reference(arch):
    """Every input shape's costs and the active matmul params: ``==``."""
    jcfg, tcfg = jconfigs.get(arch), tconfigs.get(arch)
    assert tcosts.matmul_params_active(tcfg) == \
        jcosts.matmul_params_active(jcfg)
    for name, shape in tconfig.INPUT_SHAPES.items():
        got = tcosts.step_costs(tcfg, shape).asdict()
        want = jcosts.step_costs(jcfg, jconfig.INPUT_SHAPES[name]).asdict()
        assert got == want, (arch, name)


def test_costs_model_consistency():
    """The reference's ``test_costs_model_consistency`` on the port: train >
    prefill > decode FLOPs; MoE active << total; long-context decode uses
    the window."""
    cfg = tconfigs.get("yi-9b")
    shapes = tconfig.INPUT_SHAPES
    tr = tcosts.step_costs(cfg, shapes["train_4k"])
    pf = tcosts.step_costs(cfg, shapes["prefill_32k"])
    dc = tcosts.step_costs(cfg, shapes["decode_32k"])
    assert tr.flops > pf.flops > dc.flops
    assert tr.flops_kernel < tr.flops
    moe = tconfigs.get("deepseek-v2-236b")
    assert moe.n_active_params() < 0.2 * moe.n_params()
    lk = tcosts.step_costs(tconfigs.get("yi-34b"), shapes["long_500k"])
    assert "window" in lk.notes


# ----------------------------------------------------------- hlo_stats
_HLO = """
HloModule test

%body (p: (s32[], f32[8])) -> (s32[], f32[8]) {
  %ar = f32[8]{0} all-reduce(f32[8]{0} %x), replica_groups=[1,4]<=[4]
}

%cond (p: (s32[], f32[8])) -> pred[] {
  %c = s32[] constant(12)
  %cmp = pred[] compare(s32[] %i, s32[] %c), direction=LT
}

ENTRY %main () -> f32[8] {
  %w = (s32[], f32[8]) while((s32[], f32[8]) %init), condition=%cond, body=%body
  %ag = f32[16]{0} all-gather(f32[8]{0} %y), replica_groups=[2,2]<=[4]
}
"""


def test_collective_log_matches_reference_hlo():
    """The reference test's HLO (12 all-reduces of f32[8] over 4 in a loop,
    one all-gather to f32[16] over 2) as the 13 records the port would log:
    every count and byte total equal (exact)."""
    records = [("all-reduce", 32, 4)] * 12 + [("all-gather", 64, 2)]
    assert thlo.collective_bytes(records) == jhlo.collective_bytes(_HLO)
    for kind in thlo.COLLECTIVES:
        for g, rb in ((1, 64), (2, 64), (8, 4096)):
            assert thlo._moved_bytes(kind, rb, g) == \
                jhlo._moved_bytes(kind, rb, g)


def test_record_collectives_sees_the_sharding_calls():
    """A one-rank gloo group in a subprocess: every collective function of
    ``repro_torch.sharding`` (and the clip's) is logged with its kind,
    result bytes and group size, and nothing is logged outside the
    context."""
    out = _run("""
        import json, tempfile, os, torch, torch.distributed as dist
        from repro_torch import sharding as sh
        from repro_torch.optim import clip
        from repro_torch.launch import hlo_stats
        store = os.path.join(tempfile.mkdtemp(), "store")
        dist.init_process_group("gloo", init_method="file://" + store,
                                rank=0, world_size=1)
        g = dist.group.WORLD
        x = torch.ones(4, 6)
        sh.gather_dim(x, 1, g, 1)
        with hlo_stats.record_collectives() as rec:
            sh.gather_dim(x, 1, g, 1)
            sh.scatter_mean_dim(x, 0, g, 1)
            sh.all_gather_rows(x[:2], g, 1)
            sh.all_reduce_mean(x.to(torch.bfloat16), g, 1)
            sh.all_reduce_max(x, g)
            clip.global_norm({"a": x}, sharded={("a",)}, group=g)
        sh.all_reduce_max(x, g)
        print(json.dumps(rec))
        dist.destroy_process_group()
    """)
    rec = [tuple(r) for r in json.loads(out.strip().splitlines()[-1])]
    assert rec == [("all-gather", 96, 1), ("reduce-scatter", 96, 1),
                   ("all-gather", 48, 1), ("all-reduce", 96, 1),
                   ("all-reduce", 96, 1), ("all-reduce", 4, 1)]


# ------------------------------------------------- dry run on a fake group
_FAKE = """
    import json, torch
    from repro_torch import configs
    from repro_torch.config import InputShape
    from repro_torch.launch import dryrun, specs, mesh as mesh_lib
    mesh_lib.fake_group(8)
    mesh = mesh_lib.make_local_mesh(4, 2, device_type="cpu")
    out = {}
    cfg = configs.get_reduced("qwen3-32b")
    fn, args = specs.build_step(cfg, InputShape("t", 128, 8, "train"), mesh)
    out["train"] = dryrun.measure(fn, args)
    out["train_state_bytes"] = dryrun._nbytes(args[0])
    for arch in ("mamba2-370m", "zamba2-2.7b", "deepseek-v2-236b"):
        cfg = configs.get_reduced(arch)
        fn, args = specs.build_step(cfg, InputShape("d", 256, 8, "decode"),
                                    mesh)
        res = dryrun.measure(fn, args)
        out["decode/" + arch] = {"memory": res["memory"],
                                 "logits": list(fn(*args)[0].shape)}
    out["flow_state_bytes"] = {
        str(fsdp): {a: dryrun._nbytes(specs.build_flow_step(
            configs.get_reduced(a), mesh, fsdp=fsdp)[1][0])
            for a in configs.ARCH_IDS + configs.PAPER_ARCHS}
        for fsdp in (True, False)}
    print(json.dumps(out))
"""

_REF_BYTES = """
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import json
    import jax, jax.numpy as jnp, numpy as np
    from repro import configs, optim
    from repro.config import FlowRLConfig
    from repro.core.trainers.base import RLState
    from jax.sharding import NamedSharding, PartitionSpec
    from repro import sharding as shlib
    from repro.distributed.sharding import PartitionPlan
    from repro.launch import specs
    from repro.models import params as params_lib
    from repro.models.flow import FlowAdapter
    mesh = jax.sharding.Mesh(np.array(jax.devices()).reshape(4, 2),
                             ("data", "model"))
    flow = FlowRLConfig(num_steps=10, group_size=8, latent_tokens=1024,
                        latent_dim=16)
    out = {"True": {}, "False": {}}
    for a in configs.ARCH_IDS + configs.PAPER_ARCHS:
        cfg = configs.get_reduced(a)
        spec = FlowAdapter(cfg, flow, 512).spec()
        p = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype),
                         params_lib.shape_tree(spec, jnp.bfloat16))
        f32 = lambda t: jnp.zeros(t.shape, jnp.float32)
        st = RLState(params=p, opt=optim.AdamWState(
            step=jnp.zeros((), jnp.int32), mu=jax.tree.map(f32, p),
            nu=jax.tree.map(f32, p)))
        out["False"][a] = PartitionPlan(mesh, spec).bytes_report(st)[
            "per_device_bytes"]
        # the reference's build_flow_step layout (specs.py:254-268): its
        # FSDP rule tables, a sharding dropped where it does not divide;
        # bf16 params, f32 moments mirroring them, the int32 step
        rules = shlib.param_rules(mesh, fsdp=True, train=True)
        axes = params_lib.axes_tree(spec)
        shapes = params_lib.shape_tree(spec, jnp.bfloat16)
        is_ax = lambda x: isinstance(x, tuple) and all(
            isinstance(e, (str, type(None))) for e in x)

        def n_local(ax, s):
            sp = [rules.get(n) if n else None for n in ax]
            sp = [m if m is None or specs._divisible(d, mesh, m) else None
                  for m, d in zip(sp, s.shape)]
            return int(np.prod(NamedSharding(mesh, PartitionSpec(*sp))
                               .shard_shape(s.shape)))
        n = sum(jax.tree.leaves(jax.tree.map(n_local, axes, shapes,
                                             is_leaf=is_ax)))
        out["True"][a] = n * (2 + 4 + 4) + 4
    print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def fake_group_run():
    return json.loads(_run(_FAKE, timeout=300).strip().splitlines()[-1])


def test_dryrun_train_step_logs_collectives(fake_group_run):
    """The reduced qwen3-32b train step at (4, 2) under the production
    layout: the ZeRO-3 gathers and reduce-scatters over "data" (one pair
    per data-sharded leaf of every layer, the remat's recompute gathering
    again), the tensor-parallel and gradient all-reduces; argument bytes
    above 0 and at least the state's."""
    res = fake_group_run["train"]
    coll = res["collectives"]
    assert coll["_total"]["count"] > 0
    assert coll["all-gather"]["count"] > coll["reduce-scatter"]["count"] > 0
    assert coll["all-reduce"]["count"] > 0
    assert coll["_total"]["moved_bytes"] > 0
    mem = res["memory"]
    assert mem["argument_bytes"] > 0
    assert mem["argument_bytes"] >= fake_group_run["train_state_bytes"] - 4
    assert mem["peak_bytes"] == mem["argument_bytes"] + mem["temp_bytes"]
    assert mem["temp_bytes"] > 0
    assert res["op_histogram"]["mm"] > 0


def test_dryrun_decode_steps_run_on_meta(fake_group_run):
    """The reference's ``test_dryrun_decode_small_mesh_subprocess`` on the
    port: the decode step of three families at (4, 2), batch 8 split over
    "data" (2 rows a rank), logits over the vocabulary."""
    for arch in ("mamba2-370m", "zamba2-2.7b", "deepseek-v2-236b"):
        r = fake_group_run["decode/" + arch]
        assert r["logits"] == [2, tconfigs.get_reduced(arch).vocab_size]
        assert r["memory"]["peak_bytes"] >= r["memory"]["argument_bytes"] > 0


@pytest.fixture(scope="module")
def ref_flow_bytes():
    return json.loads(_run(_REF_BYTES, timeout=300).strip().splitlines()[-1])


@pytest.mark.parametrize("fsdp", [True, False])
def test_dryrun_flow_state_bytes_equal_reference_plan(fake_group_run,
                                                      ref_flow_bytes, fsdp):
    """Per-rank bytes of the flow update's state (bf16 params, f32 AdamW
    moments, the step counter) at (dp, mp) = (4, 2), every reduced arch,
    exactly: under the reference's ``build_flow_step`` layout (its FSDP
    rule tables, ``repro/launch/specs.py:257``) by default, and at
    ``fsdp=False`` (the trainers' own layout) the reference
    ``PartitionPlan``'s ``per_device_bytes``."""
    assert fake_group_run["flow_state_bytes"][str(fsdp)] == \
        ref_flow_bytes[str(fsdp)]


def test_dryrun_cli_production_mesh(tmp_path):
    """``python -m repro_torch.launch.dryrun`` at 16 x 16 (a fake group of
    256 ranks): the record at the reference's path with memory per rank,
    the analytic costs and the logged collectives."""
    subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "smollm-360m", "--shape", "decode_32k", "--out-dir",
         str(tmp_path)], check=True, capture_output=True, timeout=240,
        env={**os.environ, "PYTHONPATH": SRC, "OMP_NUM_THREADS": "1"})
    rec = json.loads((tmp_path / "smollm-360m__decode_32k__pod16x16.json")
                     .read_text())
    assert rec["n_devices"] == 256 and rec["mesh"] == "pod16x16"
    assert rec["analytic"] == tcosts.step_costs(
        tconfigs.get("smollm-360m"), tconfig.INPUT_SHAPES["decode_32k"]
    ).asdict()
    assert rec["memory"]["peak_bytes"] > rec["memory"]["argument_bytes"] > 0
    assert rec["collectives"]["all-gather"]["count"] > 0
    assert rec["fits_80gb"] and "ZeRO-3" in rec["layout"]


# ------------------------------------------------------- the meta route
@pytest.fixture
def no_card(monkeypatch):
    """Building, loading or asking the card's capability fails the test."""
    def boom(*a, **k):
        raise AssertionError("the meta route reached the kernel build or the "
                             "card")
    monkeypatch.setattr(_build, "load", boom)
    monkeypatch.setattr(_build, "build_all", boom)
    monkeypatch.setattr(torch.cuda, "get_device_capability", boom)
    before = kcounts.read()
    yield
    assert kcounts.read() == before            # nothing counted a launch


def _pair(*shapes_dtypes):
    g = torch.Generator().manual_seed(0)
    cpu = [torch.randn(s, generator=g).to(d) for s, d in shapes_dtypes]
    return cpu, [t.to("meta") for t in cpu]


def _same(meta_out, cpu_out):
    for m, c in zip(meta_out, cpu_out):
        assert m.device.type == "meta"
        assert (tuple(m.shape), m.dtype) == (tuple(c.shape), c.dtype)


@pytest.mark.parametrize("dims", [(64, 64), (192, 128)])
def test_meta_route_flash_attention(no_card, dims):
    """Forward (with and without the LSE) and backward through
    ``FlashAttentionFn`` on meta: the plain versions' shapes and dtypes
    (bf16 out, f32 LSE; exact)."""
    D, Dv = dims
    bf = torch.bfloat16
    cpu, meta = _pair(((2, 33, 4, D), bf), ((2, 33, 2, D), bf),
                      ((2, 33, 2, Dv), bf))
    _same([ops.flash_attention(*meta)], [ref.flash_attention_ref(*cpu)])
    from repro_torch.kernels.flash_attention import flash_attention
    _same(flash_attention(*meta, return_lse=True),
          ref.flash_attention_fwd_ref(*cpu, causal=True, window=0))
    for t in meta:
        t.requires_grad_(True)
    o = ops.flash_attention(*meta)
    grads = torch.autograd.grad(o.float().sum(), meta)
    _same(grads, cpu)


@pytest.mark.parametrize("kind", ["tensor_core", "fma"])
def test_meta_route_ssd_scan(no_card, kind):
    """The scan forward and backward (``SSDScanFn``) on meta, on the
    variant the card would pick (bf16 at Mamba-2's shape, f32 otherwise):
    y and the final state, and the five gradients, in the plain versions'
    shapes and dtypes (exact)."""
    dt_ = torch.bfloat16 if kind == "tensor_core" else torch.float32
    B, L, H, P, N = 1, 256, 2, 64, 128
    f = torch.float32
    cpu, meta = _pair(((B, L, H, P), dt_), ((B, L, H), f), ((H,), f),
                      ((B, L, N), dt_), ((B, L, N), dt_))
    from repro_torch.kernels.ssd_scan import tensor_core_route
    assert tensor_core_route(meta[0], meta[3], meta[4], 128) == (
        kind == "tensor_core")
    _same(ops.ssd_scan(*meta), ref.ssd_chunked_ref(*cpu, 128))
    for t in meta:
        t.requires_grad_(True)
    y, h = ops.ssd_scan(*meta)
    _same(torch.autograd.grad(y.float().sum() + h.sum(), meta), cpu)


def test_meta_route_sde_step_and_grpo_loss(no_card):
    """``sde_step``, ``grpo_loss`` (guarded too) and the trainable GRPO loss
    with its backward on meta: the plain versions' shapes and dtypes."""
    bf, f = torch.bfloat16, torch.float32
    cpu, meta = _pair(((4, 16, 8), bf), ((4, 16, 8), bf), ((4, 16, 8), bf))
    _same(ops.sde_step(*meta, 0.9, 0.8),
          ref.sde_step_ref(cpu[0], cpu[1], 0.9, 0.8, cpu[2], eta=0.7))
    cpu, meta = _pair(((8,), f), ((8,), f), ((8,), f), ((1,), f))
    _same(ops.grpo_loss(*meta[:3]), ref.grpo_loss_ref(*cpu[:3], clip=0.2))
    _same(ops.grpo_loss(*meta, guard=True),
          ref.grpo_loss_ref(*cpu[:3], clip=0.2, guard=True,
                            ratio_mean=cpu[3]))
    lp = meta[0].requires_grad_(True)
    loss, frac = ops.grpo_loss_trainable(lp, meta[1], meta[2])
    (g,) = torch.autograd.grad(loss.sum(), [lp])
    _same([loss, frac, g], cpu[:3])


def test_cpu_and_cuda_routes_unchanged():
    """The capability check still refuses a CPU device, and CPU tensors
    still take the plain versions (bitwise)."""
    from repro_torch.kernels.sde_step import require_sm90
    with pytest.raises(ValueError, match="CUDA tensors"):
        require_sm90(torch.device("cpu"))
    cpu, _ = _pair(((1, 16, 2, 64), torch.float32),
                   ((1, 16, 2, 64), torch.float32),
                   ((1, 16, 2, 64), torch.float32))
    assert torch.equal(ops.flash_attention(*cpu),
                       ref.flash_attention_ref(*cpu))


# ----------------------------------------------------- LM step on a mesh
_DP2 = """
    import os, sys, json, torch, torch.distributed as dist
    from repro_torch import configs, optim
    from repro_torch import sharding as sh
    from repro_torch.config import OptimConfig
    from repro_torch.distributed import build_mesh
    from repro_torch.launch import hlo_stats
    from repro_torch.models import tasks
    from repro_torch.models.params import leaves
    rank, store, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method="file://" + store,
                            rank=rank, world_size=2)
    mesh = build_mesh(2, 1, "cpu")
    cfg = configs.get_reduced("smollm-360m")
    opt = OptimConfig(lr=1e-3, total_steps=10, warmup_steps=1)

    def fresh():
        p = tasks.init_params(cfg, torch.Generator().manual_seed(0),
                              torch.float32, "cpu")
        return tasks.TrainState(p, optim.adamw_init(p))

    batch = tasks.synthetic_batch(cfg, 4, 32, seed=1, device="cpu")
    step = tasks.make_train_step(cfg, opt)
    one, m1 = step(fresh(), batch)
    mine = {k: v[2 * rank:2 * rank + 2] for k, v in batch.items()}
    with sh.param_gather(mesh), hlo_stats.record_collectives() as rec:
        two, m2 = step(fresh(), mine)
    gap = max(float((a - b).abs().max()) for (_, a), (_, b) in zip(
        leaves(one.params), leaves(two.params)))
    if rank == 0:
        json.dump({"gap": gap, "loss": [float(m1["loss"]), float(m2["loss"])],
                   "gnorm": [float(m1["grad_norm"]), float(m2["grad_norm"])],
                   "kinds": sorted({r[0] for r in rec})}, open(out, "w"))
    dist.destroy_process_group()
"""


def test_lm_train_step_on_data_mesh_matches_one_device(tmp_path):
    """The LM train step with the batch split over 2 gloo ranks (dp = 2,
    the gradients averaged over "data") against the one-device step on the
    whole batch, f32: loss and grad norm to 1e-5 relative, every param to
    1e-5 absolute (1 % of the step size) after one AdamW step at lr 1e-3:
    AdamW's first step divides each gradient by its own magnitude, so a
    near-zero gradient's f32 summation order shows in its sign."""
    code = os.path.join(tmp_path, "dp2.py")
    with open(code, "w") as f:
        f.write(textwrap.dedent(_DP2))
    store, out = str(tmp_path / "store"), str(tmp_path / "out.json")
    env = {**os.environ, "PYTHONPATH": SRC, "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen([sys.executable, code, str(r), store, out],
                              env=env, stderr=subprocess.PIPE, text=True)
             for r in range(2)]
    errs = [p.communicate(timeout=240)[1] for p in procs]
    assert all(p.returncode == 0 for p in procs), errs
    res = json.loads(open(out).read())
    assert res["kinds"] == ["all-reduce"]
    np.testing.assert_allclose(res["loss"][1], res["loss"][0], rtol=1e-5)
    np.testing.assert_allclose(res["gnorm"][1], res["gnorm"][0], rtol=1e-5)
    assert res["gap"] < 1e-5


# ---------------------------------------------------------------- sweep
@pytest.mark.parametrize("grid", [
    [], ["flow.trainer_type=flow_grpo,awm"],
    ["flow.eta=0.3,0.7", "flow.trainer_type=nft,awm", "seed=1"]])
def test_sweep_grid_matches_reference(grid):
    """``grid_combos`` and ``combo_slug`` equal the reference's (exact)."""
    from repro.launch import sweep as jsweep
    assert tsweep.grid_combos(grid) == jsweep.grid_combos(grid)
    assert [tsweep.combo_slug(c) for c in tsweep.grid_combos(grid)] == \
        [jsweep.combo_slug(c) for c in jsweep.grid_combos(grid)]


def test_sweep_refuses_duplicate_axis_and_bad_spec():
    from repro.launch import sweep as jsweep
    for bad in (["a=1", "a=2"], ["a"]):
        with pytest.raises(SystemExit) as t:
            tsweep.grid_combos(bad)
        with pytest.raises(SystemExit) as j:
            jsweep.grid_combos(bad)
        assert str(t.value) == str(j.value)


def test_cpu_sweep_trains_then_skips(tmp_path):
    """Two combos of the reduced flux_dit through ``launch.train`` on the
    CPU, one step each: both artifacts hold one finite history row; the
    rerun skips both."""
    base = tmp_path / "base.json"
    base.write_text(json.dumps({
        "flow": {"num_steps": 2, "group_size": 2},
        "data": {"encoder": {"cond_dim": 32, "cond_len": 4, "vocab": 256,
                             "hidden": 64}}}))
    cmd = [sys.executable, "-m", "repro_torch.launch.sweep", "--config",
           str(base), "--reduced", "--steps", "1", "--device", "cpu",
           "--grid", "flow.trainer_type=flow_grpo,awm"]
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    env.pop("PYTHONPATH", None)       # the sweep sets the children's own
    first = subprocess.run(cmd, capture_output=True, text=True, timeout=240,
                           cwd=tmp_path, env={**env, "PYTHONPATH": SRC})
    assert first.returncode == 0, first.stdout + first.stderr
    assert first.stdout.count("[ok]") == 2
    for t in ("flow_grpo", "awm"):
        rows = json.loads((tmp_path / "experiments" / "sweep" /
                           f"flow_trainer_type={t}.json").read_text())
        assert len(rows) == 1
        assert all(np.isfinite(v) for v in rows[0].values()
                   if isinstance(v, float))
    again = subprocess.run(cmd, capture_output=True, text=True, timeout=60,
                           cwd=tmp_path, env={**env, "PYTHONPATH": SRC})
    assert again.returncode == 0 and again.stdout.count("[skip]") == 2
