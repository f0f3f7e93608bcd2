"""The activation-gathered route (``REPRO_NO_WEIGHT_GATHER``, and every
decode step) on the port, on the CPU.

Under the production rules each matrix keeps its "data" shard at use
(``sharding.use_layout`` on ``Rules(route="activations")``) and each
product moves rows instead: the input side (``layers.dense``:
``sharding.rows_in``) gathers the rows over "data", multiplies this
rank's d-columns by its shard and reduce-scatters the d-partial back onto
its rows; the output side (``layers.row_parallel`` with the canonical
width: ``sharding.rows_out``) multiplies the gathered rows by its shard
and sends each row's columns home by one all-to-all; the MoE slots, the
embedding lookup and MLA's absorbed decode the same way.

* Four gloo ranks (``tests/torch_nwg_worker``, one spawn), f32, under
  ``REPRO_NO_WEIGHT_GATHER=1``: ``qwen3-32b``, ``mamba2-370m``,
  ``zamba2-2.7b``, ``deepseek-v2-236b`` (tensor and ``ep_model``),
  ``grok-1-314b`` and ``internvl2-1b`` at (2, 2) and (4, 1): the first
  step's gradients, two LM train steps, the prefill and four decode steps
  against one device, in ``test_torch_layout``'s bands; every data rank
  on the whole batch (d-partials all-reduced); two ``flow_grpo`` steps of
  the narrowed ``flux_dit`` under ``rules=True``; no leaf of two dims or
  more all-gathered over "data"; and one case's gradients against the
  JAX package's ``jax.grad`` of its train loss on the same params.
* The switch's truthiness ("0" selects the route, as in the reference)
  and the decode's route by default: ``specs.build_step`` at
  ``decode_32k`` for ``deepseek-v2-236b`` and ``grok-1-314b`` on the
  16 x 16 fake mesh (meta tensors) gathers no matrix over "data".
* ``chip_smoke.py``'s phase 43 on host threads at the reduced configs.
"""
import json
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models.backbone import Backbone as JBackbone
from repro.models.layers import chunked_ce_loss as jce
from repro_torch import configs as tconfigs
from repro_torch import sharding as tsh
from repro_torch.config import INPUT_SHAPES
from repro_torch.launch import specs as tspecs

import torch_nwg_worker as worker
from torch_parity import one_torch_thread  # noqa: F401  (autouse fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")
CASES = [c[0] for c in worker.CASES]


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    return worker.spawn(tmp_path_factory.mktemp("nwg"), 240)


@pytest.mark.parametrize("case", CASES)
def test_route_train_steps_match_one_device(four_ranks, case):
    """Two LM train steps on the route against one device on the whole
    batch, f32, in ``test_layout_train_steps_match_one_device``'s bands:
    the first step's gradients to 1e-5 of each leaf's max (measured ≤
    4.0e-6: the d-partials add in another order), loss and grad norm to
    1e-5 relative, params after two AdamW steps to 1e-4 (measured ≤
    7.7e-5).  A weight gradient whose data-parallel mean were missing or
    taken twice would be off by a factor of the data ranks."""
    r = four_ranks[case]
    assert r["route"] == "activations"
    assert r["grad_gap"] < 1e-5
    np.testing.assert_allclose(r["loss"][1], r["loss"][0], rtol=1e-5)
    np.testing.assert_allclose(r["gnorm"][1], r["gnorm"][0], rtol=1e-5)
    assert r["param_gap"] < 1e-4


@pytest.mark.parametrize("case", CASES)
def test_route_prefill_and_decode_match_one_device(four_ranks, case):
    """The prefill's last logits and four decode steps on the route
    (the one-device trained params, this rank's rows): within 1e-5 of max
    |logits| of one device, gathered over "model" to the vocabulary."""
    r = four_ranks[case]
    arch, (dp, _) = dict((c[0], (c[1], c[2])) for c in worker.CASES)[case]
    assert r["logit_gap"] < 1e-5
    assert tuple(r["logits_shape"]) == (worker.lw.BATCH // dp,
                                        tconfigs.get_reduced(arch).vocab_size)


@pytest.mark.parametrize("case", CASES)
def test_route_gathers_no_matrix_over_data(four_ranks, case):
    """No leaf of two dims or more is all-gathered over "data" in the
    train or serving steps (the norm scales still are, where a rank holds
    a piece of them); the rows move instead: all-gathers, reduce-scatters
    and all-to-alls over "data" in both."""
    r = four_ranks[case]
    assert all(ndim == 1 for ndim, _ in r["data_gathers"]), \
        r["data_gathers"]
    for log in ("train_collectives", "serve_collectives"):
        kinds = {tuple(k) for k in r[log]}
        assert {("all-gather", "data"), ("reduce-scatter", "data"),
                ("all-to-all", "data")} <= kinds, (log, kinds)


@pytest.mark.parametrize("case", [c[0] for c in worker.WHOLE_CASES])
def test_route_on_a_whole_batch_matches_one_device(four_ranks, case):
    """Every data rank on the whole batch (a batch the data axis does not
    divide, as ``long_500k``'s): the d-partials all-reduced over "data"
    and the columns all-gathered home; the first step's gradients to
    1e-5 of each leaf's max (no data-parallel mean: every rank's loss is
    the whole batch's) and the prefill and decode logits to 1e-5."""
    r = four_ranks[case]
    assert r["split"] is False
    assert r["grad_gap"] < 1e-5
    assert r["logit_gap"] < 1e-5


@pytest.mark.parametrize("case", [c[0] for c in worker.FLOW_CASES])
def test_flow_grpo_on_route_matches_one_device(four_ranks, case):
    """Two ``flow_grpo`` steps of the narrowed ``flux_dit`` under
    ``rules=True`` with the switch set (the flow-RL dry run's step)
    against one device, f32, in
    ``test_flow_grpo_under_rules_matches_one_device``'s bands: every
    metric but the loss to 1e-5 relative (the loss, a residue of order
    1e-8, to 1e-7 absolute), params to 1e-4 and the AdamW moments to 1e-4
    of their max (measured 1.2e-5 and 5.0e-5), read back through
    ``canonical_state``; no matrix all-gathered over "data"."""
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
    assert r["canonical_equal"]
    assert all(ndim == 1 for ndim, _ in r["data_gathers"])


def test_route_gradients_match_the_jax_package(four_ranks):
    """The route's first-step gradients of ``qwen3-32b`` at (2, 2),
    reduced over the mesh and gathered, against ``jax.grad`` of the JAX
    package's train loss (``tasks.make_train_step``'s) on the same f32
    params and batch: each leaf to ``test_torch_tasks``' band, 3e-3 of
    its max (both packages' f32 gradients lie ~1e-3 of their max from an
    f64 run at the repository's init)."""
    r = four_ranks[worker.JAX_CASE]
    cfg = jconfigs.get_reduced("qwen3-32b")
    model = JBackbone(cfg)

    def loss(p, batch):
        x = model.embed_inputs(p, batch["tokens"])
        hidden, _, aux = model.forward_embeds(p, x, causal=True, remat=True)
        return jce(hidden, model.head_matrix(p), batch["labels"])

    def tree(flat):
        out = {}
        for path, a in flat.items():
            node = out
            *head, last = path.split("/")
            for k in head:
                node = node.setdefault(k, {})
            node[last] = jnp.asarray(a)
        return out

    batch = {k: jnp.asarray(v) for k, v in r["batch"].items()}
    want = jax.jit(jax.grad(loss))(tree(r["params"]), batch)
    flat = {"/".join(str(k.key) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_leaves_with_path(want)}
    assert set(flat) == set(r["grads"])
    for path, g in flat.items():
        np.testing.assert_allclose(r["grads"][path], g, rtol=0,
                                   atol=3e-3 * float(np.abs(g).max()),
                                   err_msg=path)


def test_zero_selects_the_route(monkeypatch):
    """The reference's truthiness: any non-empty value of
    ``REPRO_NO_WEIGHT_GATHER``, "0" too, selects the activation-gathered
    route for train and prefill; unset or empty keeps the weights'
    gather; decode takes the route either way."""
    shapes = {k: INPUT_SHAPES[k] for k in ("train_4k", "prefill_32k",
                                           "decode_32k")}
    for value, want in (("0", "activations"), ("1", "activations"),
                        ("", "weights"), (None, "weights")):
        if value is None:
            monkeypatch.delenv("REPRO_NO_WEIGHT_GATHER", raising=False)
        else:
            monkeypatch.setenv("REPRO_NO_WEIGHT_GATHER", value)
        assert tsh.no_weight_gather() is (want == "activations")
        for name, shape in shapes.items():
            assert tspecs.step_route(shape) == (
                "activations" if name == "decode_32k" else want), (value,
                                                                   name)


DECODE_PROBE = textwrap.dedent("""
    import json
    import torch.distributed as dist
    from repro_torch import configs, sharding as shlib
    from repro_torch.config import INPUT_SHAPES
    from repro_torch.launch import dryrun, hlo_stats, specs
    mesh, _, _ = dryrun._mesh(False, False)
    data = id(mesh.get_group("data"))
    out = {}
    for arch in ("deepseek-v2-236b", "grok-1-314b"):
        seen, routes = [], set()
        gather, install = shlib.GatherParam.apply, shlib.set_param_gather
        def apply(p, dim, group, n):
            if id(group) == data:
                seen.append(list(p.shape))
            return gather(p, dim, group, n)
        def set_param_gather(mesh, rules=None):
            routes.add(None if rules is None else rules.route)
            return install(mesh, rules)
        shlib.GatherParam.apply = apply
        shlib.set_param_gather = set_param_gather
        fn, args = specs.build_step(configs.get(arch),
                                    INPUT_SHAPES["decode_32k"], mesh)
        rec = dryrun.measure(fn, args)
        shlib.GatherParam.apply, shlib.set_param_gather = gather, install
        out[arch] = {"gathered": seen, "routes": sorted(routes),
                     "all_to_all": rec["collectives"]["all-to-all"]["count"]}
    print(json.dumps(out))
""")


def test_default_decode_gathers_no_matrix_over_data():
    """``specs.build_step`` at ``decode_32k`` with the switch unset, on
    the 16 x 16 fake mesh over meta tensors (as
    ``scripts/layout_collectives.py`` runs it), for the two archs whose
    serving weights shard over "data" (``inference_fsdp``): the step
    takes the activation-gathered route, all-gathers no leaf of two dims
    or more over "data", and moves rows by all-to-all.  (The reduced
    configs shard nothing over "data" at inference, so they would show
    nothing here.)"""
    env = dict(os.environ, PYTHONPATH=SRC)
    env.pop("REPRO_NO_WEIGHT_GATHER", None)
    proc = subprocess.run([sys.executable, "-c", DECODE_PROBE], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    for arch, r in res.items():
        assert r["routes"] == ["activations"], arch
        assert all(len(s) == 1 for s in r["gathered"]), (arch, r["gathered"])
        assert r["all_to_all"] > 0, arch


def _chip_smoke():
    import importlib.util
    path = os.path.join(ROOT, "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke_nwg", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


@pytest.mark.parametrize("arch", ["smollm-360m", "mamba2-370m"])
def test_card_route_phase_runs_its_ranks_on_the_cpu(arch):
    """``chip_smoke.py``'s phase 43 (``route_layer_ranks``) on the CPU at
    the reduced config, dp 4, 4 rows of 64 tokens: the 4 ranks' forwards
    at once on host threads over its ``ThreadGroup`` (all-gathers,
    reduce-scatters and all-to-alls), their backwards in rounds, each
    rank's attention or scan on its own row; the outputs, the input
    gradients, each matrix's shard gradient times 4 and the whole leaves'
    summed gradients within the card's 3e-2 of the whole block's max."""
    cs = _chip_smoke()
    cfg = tconfigs.get_reduced(arch)
    res = cs.route_layer_ranks(torch.device("cpu"), arch, dp=4, cfg=cfg,
                               seq=64)
    assert max(res["gaps"].values()) <= cs.LAYER_RANK_BAND, res["gaps"]
    assert res["rounds"] > 1
    kernel = "flash_attention" if cfg.ssm is None else "ssd_scan"
    assert [s.split(" ")[0] for s in res["shapes"]] == [kernel]
    assert res["kernel_calls"] == 4
    assert any(k.endswith("(shard x dp)") for k in res["gaps"])


def test_card_route_decode_runs_its_ranks_on_the_cpu():
    """Phase 43's decode (``route_decode_ranks``) on the CPU at the reduced
    ``deepseek-v2-236b``, dp 4, 8 rows over a 64-entry cache: the ranks'
    MLA and MoE decode on the route against one device within 3e-2, the
    rolled latent caches too."""
    cs = _chip_smoke()
    res = cs.route_decode_ranks(
        torch.device("cpu"), dp=4, rows=8, cache_len=64,
        cfg=tconfigs.get_reduced("deepseek-v2-236b"))
    assert res["rows_a_rank"] == 2
    assert max(res["gaps"].values()) <= cs.LAYER_RANK_BAND, res["gaps"]
