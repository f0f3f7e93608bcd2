"""Sequence-sharded decode caches (the reference's ``cache_seq`` rule) and
the f32 partial sums of the tensor-parallel layout, on the CPU.

* The rule: ``launch.specs.cache_rules`` / ``cache_specs`` against the
  reference's ``launch.specs.cache_specs`` for every reduced arch on a
  (data, model) = (2, 4) mesh, at a batch the data axis divides and at
  batch 1, at a cache length both axes divide and one that 4 does not,
  each with ``REPRO_CACHE_SEQ_SHARD`` unset, ``model`` and ``data``: this
  rank's shard of every cache leaf equals the reference's
  ``NamedSharding(...).shard_shape`` (a JAX subprocess on 8 faked CPU
  devices), or both refuse the layout (the reference's
  ``DuplicateSpecError``, the port's ``CacheLayoutError``).
* Four gloo ranks in one spawn (``tests/torch_seq_worker.py``, its own
  time limit): prefill and four decode steps with the sequence split over
  "model" (attention whole on every rank, q heads tensor-parallel over
  whole kv heads, MLA) and over "data" at a batch the data axis does not
  divide (the reference's default; tensor-parallel heads, MLA, the
  hybrid) against one device, f32: logits and caches within 1e-5 of
  their max, each step's rolled segments the previous step's shifted by
  one entry, exactly; and the row-parallel sites' bf16 outputs at mp 4
  within one bf16 ulp of one device's.
"""
import json
import os
import subprocess
import sys
import textwrap

import pytest
import torch

from repro_torch import configs as tconfigs
from repro_torch import sharding as tsh
from repro_torch.config import InputShape
from repro_torch.launch import specs as tspecs

import torch_seq_worker as worker
from torch_parity import one_torch_thread  # noqa: F401  (autouse fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")
REDUCED = tconfigs.ARCH_IDS + tconfigs.PAPER_ARCHS
# (name, seq_len, batch, kind): a batch "data" (2) divides and one it does
# not; a cache length 4 does not divide ("model"'s rule dropped)
SHAPES = (("d", 64, 8, "decode"), ("d", 64, 1, "decode"),
          ("d", 66, 1, "decode"))
KNOBS = (None, "model", "data")


class DuckMesh:
    """Axis names and sizes, rank 0's coordinate and no groups: what the
    rule tables and the shard shapes read of a mesh."""

    def __init__(self, names, sizes):
        self.axis_names = tuple(names)
        self.shape = dict(zip(names, sizes))

    def size(self, dim):
        return list(self.shape.values())[dim]

    def get_coordinate(self):
        return [0] * len(self.axis_names)

    def get_group(self, name):
        return None


MESH = DuckMesh(("data", "model"), (2, 4))

_REF = """
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import json
    import jax, numpy as np
    from repro import configs
    from repro.config import InputShape
    from repro.launch import specs
    mesh = jax.sharding.Mesh(np.array(jax.devices()).reshape(2, 4),
                             ("data", "model"))
    out = {}
    for a in configs.ARCH_IDS + configs.PAPER_ARCHS:
        cfg = configs.get_reduced(a)
        for shape in %r:
            for knob in %r:
                os.environ.pop("REPRO_CACHE_SEQ_SHARD", None)
                if knob:
                    os.environ["REPRO_CACHE_SEQ_SHARD"] = knob
                key = f"{a}|{shape[1]}|{shape[2]}|{knob}"
                try:
                    cs, css = specs.cache_specs(cfg, InputShape(*shape), mesh)
                    out[key] = [list(sh.shard_shape(s.shape)) for s, sh in
                                zip(jax.tree.leaves(cs), jax.tree.leaves(css))]
                except Exception as e:
                    out[key] = type(e).__name__
    print(json.dumps(out))
""" % (SHAPES, KNOBS)


@pytest.fixture(scope="module")
def ref_caches():
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(_REF)],
                       capture_output=True, text=True, timeout=300,
                       env={**os.environ, "PYTHONPATH": SRC,
                            "OMP_NUM_THREADS": "1"}, cwd=ROOT)
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


def _port(cfg, shape, knob, monkeypatch):
    monkeypatch.delenv("REPRO_CACHE_SEQ_SHARD", raising=False)
    if knob:
        monkeypatch.setenv("REPRO_CACHE_SEQ_SHARD", knob)
    try:
        caches = tspecs.cache_specs(cfg, InputShape(*shape), MESH)
    except tsh.CacheLayoutError as e:
        return e
    return [list(t.shape) for t in worker._flat(caches)]


@pytest.mark.parametrize("knob", KNOBS)
@pytest.mark.parametrize("arch", REDUCED)
def test_cache_seq_shards_equal_reference(ref_caches, arch, knob,
                                          monkeypatch):
    """For every shape: this rank's shard of each cache leaf is the
    reference's ``shard_shape`` (the batch over "data" where it divides,
    the sequence over "data" where it does not or over the knob's axis,
    kv heads and SSM heads over "model", each dropped where the axis does
    not divide), or both packages refuse the layout: one mesh axis on two
    dims of a leaf (kv heads the 4 "model" ranks divide under ``model``;
    a batch the 2 "data" ranks divide under ``data``)."""
    cfg = tconfigs.get_reduced(arch)
    for shape in SHAPES:
        want = ref_caches[f"{arch}|{shape[1]}|{shape[2]}|{knob}"]
        got = _port(cfg, shape, knob, monkeypatch)
        if isinstance(want, str):
            assert want == "DuplicateSpecError", (shape, want)
            assert isinstance(got, tsh.CacheLayoutError), (shape, got)
        else:
            assert got == want, shape


def test_refusal_names_the_leaf_and_the_axis(monkeypatch):
    """``model`` with kv heads the "model" axis divides, and ``data`` at a
    batch the data axis divides: ``CacheLayoutError`` names the cache leaf,
    the mesh axis and both logical dims."""
    monkeypatch.setenv("REPRO_CACHE_SEQ_SHARD", "model")
    with pytest.raises(tsh.CacheLayoutError,
                       match=r"cache leaf 'k'.*'model'.*cache_seq.*kv_heads"):
        tspecs.cache_rules(tconfigs.get_reduced("zamba2-2.7b"),
                           InputShape(*SHAPES[0]), MESH)
    monkeypatch.setenv("REPRO_CACHE_SEQ_SHARD", "data")
    with pytest.raises(tsh.CacheLayoutError,
                       match=r"'data'.*batch.*cache_seq"):
        tspecs.cache_rules(tconfigs.get_reduced("qwen3-32b"),
                           InputShape(*SHAPES[0]), MESH)


def test_cache_rules_follow_the_reference(monkeypatch):
    """The decode rules: no sequence split when the batch uses the data
    axis; over "data" (and the batch rule dropped) when it cannot; the
    knob's axis over that; dropped where the axis does not divide the
    cache length; the window-sized cache of a ``long_500k`` shape split
    too.  ``production_rules(seq_shard=True)`` is the reference's
    ``act_rules(seq_shard=True)``."""
    from repro import sharding as jsh
    monkeypatch.delenv("REPRO_CACHE_SEQ_SHARD", raising=False)
    cfg = tconfigs.get_reduced("qwen3-32b")
    seq = lambda s: tspecs.cache_rules(cfg, InputShape(*s), MESH).arules
    assert seq(SHAPES[0])["cache_seq"] is None
    assert seq(SHAPES[0])["batch"] == ("data",)
    assert seq(SHAPES[1])["cache_seq"] == "data"
    assert seq(SHAPES[1])["batch"] is None
    monkeypatch.setenv("REPRO_CACHE_SEQ_SHARD", "model")
    assert seq(SHAPES[0])["cache_seq"] == "model"
    assert seq(SHAPES[2])["cache_seq"] is None
    monkeypatch.delenv("REPRO_CACHE_SEQ_SHARD")
    big = DuckMesh(("data", "model"), (16, 16))
    r = tspecs.cache_rules(tconfigs.get("qwen3-32b"),
                           InputShape("long_500k", 524_288, 1, "decode"), big)
    assert r.arules["cache_seq"] == "data"
    assert tsh.production_rules(MESH, seq_shard=True).arules == \
        jsh.act_rules(MESH, seq_shard=True)
    assert tspecs.cache_rules(cfg, InputShape(*SHAPES[1]), None) is None


# ------------------------------------------------- four gloo ranks
@pytest.fixture(scope="module")
def seq_ranks(tmp_path_factory):
    return worker.spawn(tmp_path_factory.mktemp("seq"), 180)


@pytest.mark.parametrize("case", [c[0] for c in worker.SEQ_CASES])
def test_seq_sharded_decode_matches_one_device(seq_ranks, case):
    """Prefill then four decode steps, f32: the logits within 1e-5 of max
    |logits| of one device (measured ≤ 8.2e-7: the merge adds the
    segments' sums in another order, and tensor parallelism its partial
    sums); the prefill's segments and the rolled ones, gathered over the
    sequence axis, within 1e-5 of one device's caches (the new entries
    carry the same reordering); and each step's gathered segments the
    step before's without its oldest entry, exactly: the roll moves
    entries, it computes none.  Each rank holds T / n entries."""
    r = seq_ranks[case]
    _, arch, (dp, mp), knob, _ = dict((c[0], c) for c in
                                      worker.SEQ_CASES)[case]
    assert r["axis"] == (knob or "data")
    assert r["seq_size"] == (mp if knob == "model" else dp)
    assert r["n_seq_leaves"] >= 2
    assert all(n * r["seq_size"] == r["cache_len"] for n in r["segment"])
    assert r["logit_gap"] < 1e-5
    assert r["prefill_cache_gap"] < 1e-5
    assert r["cache_gap"] < 1e-5
    assert r["roll_mismatches"] == 0


def _partials(r):
    """A site's all-reduces over "model" of its output's shape: the *g*
    of its row-parallel partials (the gated norm's statistic is
    another)."""
    return [a for a in r["all_reduces"] if tuple(a[1]) == tuple(
        r["out_shape"])]


@pytest.mark.parametrize("bf16_reduce", [None, "1"])
@pytest.mark.parametrize("site", [s[0] for s in worker._sites()])
def test_row_parallel_sums_round_once(seq_ranks, site, bf16_reduce):
    """At (1, 4) in bf16 each row-parallel site's output is the ranks' f32
    partials summed and rounded once: within one bf16 ulp of one device's
    output (``worker._ulps``; the MoE slot route, tensor- and
    expert-parallel, against one device's products summed in f32 and
    rounded once, since one device rounds each expert's product and
    gated value first).  Rounding each rank's partial to bf16 before the
    sum was 12–34 ulps off.  Under ``REPRO_BF16_REDUCE`` every site hands
    *g* its partial in bf16: each all-reduce of a partial carries bf16,
    at half the bytes of the f32 one, and the output is within 2e-2 of
    max |one device's| (4 partials each rounded to bf16, 2^-9 of a
    partial up to max |output|, and three bf16 additions: 7 x 2^-9 =
    1.4e-2, beside one device's own rounding; measured ≤ 7.7e-3)."""
    r = seq_ranks["reduce" if bf16_reduce is None else "reduce_bf16"][site]
    assert r["dtype"] == "torch.bfloat16"
    partials = _partials(r)
    assert len(partials) == 1
    if bf16_reduce is None:
        assert r["ulps"] <= 1.0
        assert partials[0][0] == "torch.float32"
        return
    f32 = _partials(seq_ranks["reduce"][site])
    assert partials[0][0] == "torch.bfloat16"
    assert 2 * partials[0][2] == f32[0][2]
    assert r["rel"] <= 2e-2
    others = [a for a in r["all_reduces"] if a not in partials]
    assert others == [a for a in seq_ranks["reduce"][site]["all_reduces"]
                      if a not in f32]


def test_row_parallel_gradients_are_the_bf16_products(seq_ranks):
    """The f32 partial enters *g* beside a carrier in the activation
    dtype, so the product's backward sees the bf16 gradient: both
    operands' gradients are bitwise those of the bf16 product summed by
    *g* as a tensor, in bf16."""
    r = seq_ranks["grads"]
    assert r["bitwise"]
    assert r["dtypes"] == ["torch.bfloat16"] * 3


@pytest.mark.parametrize("value", [None, "", "1", "0", "true"])
def test_reduce_dtype_follows_the_reference(value, monkeypatch):
    """``layers.reduce_dtype()`` is the reference's ``reduce_dtype()``
    (bf16 when ``REPRO_BF16_REDUCE`` is set and non-empty, f32 otherwise),
    read at call time."""
    import jax.numpy as jnp
    from repro.models import layers as jlayers
    from repro_torch.models import layers as tlayers
    if value is None:
        monkeypatch.delenv("REPRO_BF16_REDUCE", raising=False)
    else:
        monkeypatch.setenv("REPRO_BF16_REDUCE", value)
    want = {jnp.bfloat16: torch.bfloat16,
            jnp.float32: torch.float32}[jlayers.reduce_dtype()]
    assert tlayers.reduce_dtype() == want


@pytest.mark.parametrize("arch,mode", [("qwen3-32b", None),
                                       ("deepseek-v2-236b", None),
                                       ("grok-1-314b", "dense"),
                                       ("mamba2-370m", None)])
def test_bf16_reduce_is_bitwise_neutral_without_a_mesh(arch, mode,
                                                       monkeypatch):
    """With no mesh ``REPRO_BF16_REDUCE`` changes no bit: the LM loss and
    every gradient of a reduced arch in bf16, and the prefill's and a
    decode step's logits, equal the switch unset exactly (a whole
    product is rounded once either way)."""
    from repro_torch.models import tasks
    from repro_torch.models.params import leaves
    if mode is not None:
        monkeypatch.setenv("REPRO_MOE_MODE", mode)
    cfg = tconfigs.get_reduced(arch)
    batch = tasks.synthetic_batch(cfg, 2, 32, seed=3, device="cpu")
    runs = []
    for value in (None, "1"):
        if value is None:
            monkeypatch.delenv("REPRO_BF16_REDUCE", raising=False)
        else:
            monkeypatch.setenv("REPRO_BF16_REDUCE", value)
        p = tasks.init_params(cfg, torch.Generator().manual_seed(0),
                              torch.bfloat16, "cpu")
        for _, t in leaves(p):
            t.requires_grad_(True)
        step = tasks.make_train_step(cfg, tasks_opt())
        loss = step.loss_fn(p, batch)[0]
        loss.backward()
        with torch.no_grad():
            lg, caches = tasks.make_prefill_step(cfg)(p, {
                k: v for k, v in batch.items() if k != "labels"})
            lg2, _ = tasks.make_decode_step(cfg)(
                p, caches, lg.argmax(-1)[:, None].to(torch.int32),
                32 + cfg.frontend.n_tokens)
        runs.append([loss.detach(), lg, lg2] + [t.grad for _, t in
                                                leaves(p)])
    assert all(torch.equal(a, b) for a, b in zip(*runs))


def tasks_opt():
    from repro_torch.config import OptimConfig
    return OptimConfig(lr=1e-3, total_steps=10, warmup_steps=1)
