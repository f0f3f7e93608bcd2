"""The multi-rank cases of ``tests/test_torch_seq_decode.py``, run on four
spawned gloo ranks (``file://`` store).

Imports only torch and the port (spawned children import this module, not
the test file, which imports JAX).

``seq_case``: a reduced arch in f32 (the projections drawn as in
``torch_layout_worker``) prefilled and decoded ``DECODES`` steps on one
device (every rank, the whole batch) and on a (data, model) mesh under the
decode rules of ``launch.specs.cache_rules``, with the decode caches'
sequence split over "model" (``REPRO_CACHE_SEQ_SHARD=model``) or over
"data" (the reference's default when the data axis does not divide the
batch).  Each rank records: the logits' gap to one device's; the prefill's
segments and the rolled segments, gathered over the sequence axis, against
one device's caches; and whether each step's gathered segments are the
step before's shifted by one entry, exactly (the roll copies).

``reduce_case``: the tensor-parallel layout in bf16 at mp 4: the outputs
of the row-parallel sites (attention's ``wo``, SwiGLU's ``w_down``, MLA's
``wo``, the MoE layer's slot and dense routes with its shared experts,
Mamba-2's ``out_proj``), each the *g* sum of the ranks' partials, in bf16
ulps of one device's output; ``grad_case``: a row-parallel product's
gradients through its f32 partial against the bf16 product's.

Rank 0 pickles the results to ``out``.
"""
import contextlib
import os
import pickle
import tempfile
import traceback

import torch
import torch.distributed as dist

from repro_torch import configs, sharding as sh
from repro_torch.config import InputShape
from repro_torch.distributed import RulePlan, build_mesh
from repro_torch.launch import specs
from repro_torch.models import attention, layers, mla, moe, ssm, tasks
from repro_torch.models.backbone import Backbone, map_cache_spec

from torch_layout_worker import _fresh, moe_mode

SEQ, DECODES = 32, 4
# (name, arch, (dp, mp), REPRO_CACHE_SEQ_SHARD, batch): attention whole on
# every rank (6 heads over 4, as flux_dit's 24 over 16); q heads
# tensor-parallel over whole kv heads (q gathered over "model"); MLA's
# latent cache; then the data-axis default at a batch that 2 "data" ranks
# do not divide, with q and kv heads tensor-parallel, MLA, and the
# hybrid's shared attention beside its SSM caches
SEQ_CASES = (("smollm_model_1x4", "smollm-360m", (1, 4), "model", 4),
             ("qwen3_model_1x4", "qwen3-32b", (1, 4), "model", 4),
             ("deepseek_model_1x4", "deepseek-v2-236b", (1, 4), "model", 4),
             ("qwen3_data_2x2", "qwen3-32b", (2, 2), None, 3),
             ("deepseek_data_2x2", "deepseek-v2-236b", (2, 2), None, 1),
             ("zamba2_data_2x2", "zamba2-2.7b", (2, 2), None, 1))


@contextlib.contextmanager
def env_var(name, value):
    """The environment variable ``name`` set to ``value`` (None: unset) in
    the body."""
    prev = os.environ.pop(name, None)
    if value is not None:
        os.environ[name] = value
    try:
        yield
    finally:
        os.environ.pop(name, None)
        if prev is not None:
            os.environ[name] = prev


def cache_seq_knob(value):
    """``REPRO_CACHE_SEQ_SHARD`` set to ``value`` (None: unset) in the
    body."""
    return env_var("REPRO_CACHE_SEQ_SHARD", value)


@contextlib.contextmanager
def model_all_reduces(group):
    """The (dtype, shape) of each ``dist.all_reduce`` over ``group``
    made in the body, appended to the list it yields."""
    seen, saved = [], dist.all_reduce

    def all_reduce(x, *a, group=None, **k):
        if group is not None and dist.get_process_group_ranks(group) == \
                dist.get_process_group_ranks(want):
            seen.append((str(x.dtype), tuple(x.shape),
                         x.numel() * x.element_size()))
        return saved(x, *a, group=group, **k)
    want = group
    dist.all_reduce = all_reduce
    try:
        yield seen
    finally:
        dist.all_reduce = saved


def _flat(tree):
    if hasattr(tree, "_fields") or isinstance(tree, tuple):
        return [t for v in tree for t in _flat(v)]
    return [tree]


def seq_leaves(cfg, batch, cache_len):
    """Each cache leaf's (seq dim, kv-head dim) in the order of
    ``_flat`` over a cache tree (None where the leaf has no such dim)."""
    def dims(sa, name):
        axes = sa[1]
        return [axes.index(a) if a in axes else None
                for a in ("cache_seq", "kv_heads")]
    return _flat(map_cache_spec(dims, Backbone(cfg).cache_specs(
        batch, cache_len)))


def _gather(t, dim, seq):
    parts = [torch.empty_like(t) for _ in range(seq.size)]
    dist.all_gather(parts, t.contiguous(), group=seq.group)
    return torch.cat(parts, dim)


def _gathered(caches, dims, seq):
    """The attention / latent leaves of ``caches`` gathered over the
    sequence axis (the SSM leaves left out)."""
    return [_gather(t, d, seq) for t, (d, _) in zip(_flat(caches), dims)
            if d is not None]


def _as_local(whole, dims, mesh, caches):
    """One device's attention / latent leaves cut to this rank's kv heads
    (where the rank holds a shard of them)."""
    out = []
    for w, t, (d, k) in zip(_flat(whole), _flat(caches), dims):
        if d is None:
            continue
        if k is not None and t.shape[k] != w.shape[k]:
            r = mesh.get_coordinate()[1]
            w = w.narrow(k, r * t.shape[k], t.shape[k])
        out.append(w)
    return out


def _gap(a, b):
    return max(float((x - y).abs().max() / x.abs().max().clamp_min(1e-30))
               for x, y in zip(a, b))


def _clone(caches):
    return tuple(t.clone() for t in _flat(caches))


def seq_case(arch, dp, mp, knob, batch):
    cfg = configs.get_reduced(arch)
    spec = Backbone(cfg).spec()
    params = _fresh(cfg).params
    rows = tasks.synthetic_batch(cfg, batch, SEQ, seed=1, device="cpu")
    rows.pop("labels")
    gen = torch.Generator().manual_seed(3)
    tokens = torch.randint(0, cfg.vocab_size, (batch, DECODES),
                           generator=gen, dtype=torch.int32)
    T = SEQ + cfg.frontend.n_tokens
    prefill = tasks.make_prefill_step(cfg)
    decode = tasks.make_decode_step(cfg)

    lg, c_one = prefill(params, rows)
    lg_one, pre_one = [lg], _clone(c_one)
    for i in range(DECODES):
        lg, c_one = decode(params, c_one, tokens[:, i:i + 1], T + i)
        lg_one.append(lg)

    mesh = build_mesh(dp, mp, "cpu")
    with cache_seq_knob(knob):
        rules = specs.cache_rules(cfg, InputShape("d", T, batch, "decode"),
                                  mesh, fsdp=True)
    plan = RulePlan(mesh, spec, rules)
    dims = seq_leaves(cfg, batch, T)
    with sh.param_gather(mesh, rules):
        seq = sh.current_seq()
        local = plan.shard_state(params)
        lg, caches = prefill(local, rows)
        lg_two = [lg]
        segment = [t.shape[d] for t, (d, _) in zip(_flat(caches), dims)
                   if d is not None]
        pre = _gathered(caches, dims, seq)
        roll_bad, before = 0, pre
        for i in range(DECODES):
            lg, caches = decode(local, caches, tokens[:, i:i + 1], T + i)
            lg_two.append(lg)
            after = _gathered(caches, dims, seq)
            roll_bad += sum(int((a.narrow(d, 0, a.shape[d] - 1)
                                 != b.narrow(d, 1, b.shape[d] - 1)).sum())
                            for a, b, d in zip(after, before, [
                                d for d, _ in dims if d is not None]))
            before = after
    lg_gap = max(float((a - b).abs().max() / a.abs().max())
                 for a, b in zip(lg_one, lg_two))
    return {"axis": seq.axis, "seq_size": seq.size, "segment": segment,
            "cache_len": T,
            "logit_gap": lg_gap,
            "prefill_cache_gap": _gap(_as_local(pre_one, dims, mesh,
                                                caches), pre),
            "cache_gap": _gap(_as_local(c_one, dims, mesh, caches), before),
            "roll_mismatches": roll_bad,
            "n_seq_leaves": len(segment)}


# ------------------------------------------------------------ Part A

def _ulps(one, two, floor=2.0 ** -6):
    """The largest |two - one| in bf16 ulps of |one| (the spacing of bf16
    numbers at |one|: 2^(e - 8) for |one| = m 2^e, m in [0.5, 1)), |one|
    taken at least ``floor`` of max |one|: below it a sum's f32 rounding
    noise (2^-24 of its terms' sizes, which a near-cancelling element's
    can dwarf) would count, whatever the route."""
    one, two = one.float(), two.float()
    mag = one.abs().clamp_min(floor * float(one.abs().max()))
    _, e = torch.frexp(mag)
    return float(((two - one).abs() / torch.ldexp(torch.ones_like(one),
                                                  e - 8)).max())


def _cast(tree):
    if isinstance(tree, dict):
        return {k: _cast(v) for k, v in tree.items()}
    return tree.to(torch.bfloat16)


def _index(tree, i):
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


def _sites():
    """(site name, arch, fn(p_block, cfg, x) -> output, the one-device
    reference's fn, REPRO_MOE_MODE)."""
    def attn(p, cfg, x):
        return attention.apply_full(p["attn"], cfg, x)[0]

    def mlp(p, cfg, x):
        return layers.mlp(p["ffn"], x, cfg.d_ff)

    def latent(p, cfg, x):
        return mla.apply_full(p["attn"], cfg, x)[0]

    def experts(p, cfg, x):
        return moe.apply(p["ffn"], cfg, x, aux=False)[0]

    def routed_sum(p, cfg, x):
        # one device's slot route with its products, their gated top-k sum
        # and the shared experts' output kept f32 and rounded once: the
        # products a rank splits, unsplit (one device's own output rounds
        # each expert's product and gated value before the sum)
        f, one_rank = p["ffn"], sh.TP(None, 1, 0)
        gates, idx = moe.route(f, cfg, x)[2:]
        out = moe._slot_dispatch(f, cfg, x, gates, idx,
                                 moe.capacity(x.shape[1], cfg), one_rank)
        shared = layers.swiglu(f["shared"], x, one_rank)
        return (out.tensor() + shared.tensor()).to(x.dtype)

    def out_proj(p, cfg, x):
        return ssm.apply_full(p["ssm"], cfg, x)[0]
    return (("attention_wo", "qwen3-32b", attn, attn, None),
            ("swiglu_w_down", "qwen3-32b", mlp, mlp, None),
            ("mla_wo", "deepseek-v2-236b", latent, latent, None),
            ("moe_slot", "deepseek-v2-236b", experts, routed_sum, None),
            ("moe_dense", "grok-1-314b", experts, experts, "dense"),
            ("ssm_out_proj", "mamba2-370m", out_proj, out_proj, None),
            ("moe_slot_ep", "deepseek-v2-236b", experts, routed_sum,
             "ep_model"))


def reduce_case(mp=4, bf16_reduce=None):
    """Each row-parallel site's output under tensor (or, ``moe_slot_ep``,
    expert) parallelism at mp, in bf16, against one device's (the slot
    route's: its products' sum in the reduce dtype, ``_sites``), in bf16
    ulps (``_ulps``); and the (dtype, shape, bytes) of each all-reduce
    over "model" the site made, with ``REPRO_BF16_REDUCE`` set to
    ``bf16_reduce``."""
    out = {}
    mesh = build_mesh(1, mp, "cpu")
    rules = sh.production_rules(mesh)
    for name, arch, fn, ref, mode in _sites():
        with moe_mode(mode), env_var("REPRO_BF16_REDUCE", bf16_reduce):
            cfg = configs.get_reduced(arch)
            bb = Backbone(cfg)
            params = _cast(tasks.init_params(
                cfg, torch.Generator().manual_seed(0), torch.float32,
                "cpu"))
            p = _index(params["blocks"], cfg.n_layers - 1 -
                       bb._first_dense)
            spec = bb._block_spec
            gen = torch.Generator().manual_seed(5)
            x = torch.randn((2, 32, cfg.d_model), generator=gen
                            ).to(torch.bfloat16)
            with torch.no_grad():
                one = ref(p, cfg, x)
                plan = RulePlan(mesh, spec, rules)
                with sh.param_gather(mesh, rules), model_all_reduces(
                        mesh.get_group("model")) as seen:
                    two = fn(sh.constrain_params(plan.shard_state(p), spec),
                             cfg, x)
            out[name] = {"ulps": _ulps(one, two),
                         "max_abs": float((one.float() - two.float())
                                          .abs().max()),
                         "rel": float((one.float() - two.float()).abs().max()
                                      / one.float().abs().max()),
                         "dtype": str(two.dtype), "out_shape": tuple(
                             two.shape), "all_reduces": seen}
    return out


def grad_case(mp=4):
    """The gradients of a row-parallel product through *g* in bf16 at mp:
    the f32 partial and its carrier (``layers.row_parallel``) against the
    bf16 product summed by *g* as a tensor, for one upstream gradient:
    whether the gradients of both operands are bitwise equal."""
    mesh = build_mesh(1, mp, "cpu")
    rules = sh.production_rules(mesh)
    gen = torch.Generator().manual_seed(7)
    h, w, dy = (torch.randn(s, generator=gen).to(torch.bfloat16)
                for s in ((2, 16, 64), (64, 96), (2, 16, 96)))
    grads = []
    with sh.param_gather(mesh, rules):
        tp = sh.current_tp()
        for route in ("partial", "tensor"):
            a, b = (t.clone().requires_grad_() for t in (h, w))
            if route == "partial":
                y = sh.reduce_from_model(layers.row_parallel(a, b, tp), tp)
            else:
                y = sh.reduce_from_model(torch.matmul(a, b).to(a.dtype), tp)
            y.backward(dy)
            grads.append((a.grad, b.grad, y.dtype))
    (da, dw, dt), (da0, dw0, dt0) = grads
    return {"bitwise": bool(torch.equal(da, da0) and torch.equal(dw, dw0)),
            "dtypes": [str(dt), str(da.dtype), str(dw.dtype)]}


def run(rank, world, store, out):
    """Entry point of one spawned rank: every case in turn."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    try:
        res = {"reduce": reduce_case(), "grads": grad_case(),
               "reduce_bf16": reduce_case(bf16_reduce="1")}
        for name, arch, shape, knob, batch in SEQ_CASES:
            res[name] = seq_case(arch, *shape, knob, batch)
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
    store = os.path.join(str(tmp_path), "seq.store")
    out = os.path.join(str(tmp_path), "seq.pkl")
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
        raise AssertionError(f"sequence-sharded cases failed or hung (exit "
                             f"codes {[p.exitcode for p in procs]})\n{errs}")
    with open(out, "rb") as f:
        return pickle.load(f)


if __name__ == "__main__":
    import json
    with tempfile.TemporaryDirectory() as tmp:
        res = spawn(tmp, 600)
    for k, v in res.items():
        print(k, json.dumps(v))
