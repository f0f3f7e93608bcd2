"""Parity of the port's serving slice with the JAX package, on the CPU: the
four schedulers, the per-request-seeded rollout end to end on replayed
draws, the frozen text encoder, the engine's per-request determinism and
the serve CLI."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import schedulers as jsched
from repro.core.preprocess import FrozenTextEncoder as JEncoder
from repro.core.rollout import request_keys
from repro.core.rollout import rollout_keyed as jrollout_keyed
from repro_torch.core import schedulers as tsched
from repro_torch.core.preprocess import FrozenTextEncoder as TEncoder
from repro_torch.core.rollout import request_draws
from repro_torch.core.rollout import rollout_keyed as trollout_keyed
from repro_torch.launch import serve as tserve
from repro_torch.serving import ServingEngine

from torch_parity import (COND_DIM, COND_LEN, LATENT_DIM, LATENT_TOKENS,
                          adapters, normal, params_pair, to_torch)

SCHEDULERS = [("flow_sde", 0.7), ("dance_sde", 0.3), ("cps", 0.5),
              ("ode", 0.0)]
TINY_ENCODER = {"cond_dim": COND_DIM, "cond_len": COND_LEN, "vocab": 256,
                "hidden": 64}


# --------------------------------------------------------------- schedulers
@pytest.mark.parametrize("name,eta", SCHEDULERS)
@pytest.mark.parametrize("i", [0, 2, 4])
def test_scheduler_step_with_eps_matches_jax(name, eta, i):
    js = jsched.build(name, eta)
    ts_ = tsched.build(name, eta)
    jts = np.asarray(js.timesteps(5))
    tts = ts_.timesteps(5)
    # the f32 grid: numpy's linspace and jnp's agree to an f32 ulp
    np.testing.assert_allclose(tts, jts, rtol=1e-7, atol=0)
    t, t_next = tts[i], tts[i + 1]
    v, x, eps = normal(10 + i, *[(3, 16, 8)] * 3)
    xj, lj = js.step_with_eps(jnp.asarray(v), jnp.asarray(x),
                              jnp.float32(t), jnp.float32(t_next),
                              jnp.asarray(eps))
    xt, lt = ts_.step_with_eps(to_torch(v), to_torch(x), float(t),
                               float(t_next), to_torch(eps))
    # f32 elementwise arithmetic: 1e-5; logp a sum over 128 terms
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=1e-4,
                               rtol=1e-5)
    xo = ts_.step_ode(to_torch(v), to_torch(x), float(t), float(t_next))
    np.testing.assert_allclose(
        xo.numpy(), np.asarray(js.step_ode(jnp.asarray(v), jnp.asarray(x),
                                           jnp.float32(t),
                                           jnp.float32(t_next))),
        atol=1e-6, rtol=1e-6)


# ------------------------------------------------------ the slice as a whole
def _jax_draws(ja, keys, num_steps):
    """The draws ``repro.core.rollout.rollout_keyed`` makes, recomputed as
    it makes them (rollout.py:171-186)."""
    shape = (LATENT_TOKENS, LATENT_DIM)
    k2 = jax.vmap(jax.random.split)(keys)
    k_init, k_step = k2[:, 0], k2[:, 1]
    x_init = jax.vmap(lambda k: ja.init_latent(k, 1)[0])(k_init)
    eps = jnp.stack([jax.vmap(lambda k: jax.random.normal(
        jax.random.fold_in(k, i), shape, jnp.float32))(k_step)
        for i in range(num_steps)])
    return np.asarray(x_init), np.asarray(eps)


@pytest.mark.parametrize("mask", [None, (True, False, True)])
def test_rollout_keyed_matches_jax_on_replayed_draws(mask):
    ja, ta = adapters("flow_sde", 0.7, num_steps=3)
    jp, tp = params_pair(ja, jnp.float32)
    (cond,) = normal(4, (3, COND_LEN, COND_DIM))
    keys = request_keys(jax.random.PRNGKey(0), 3)
    js, ts_ = jsched.build("flow_sde", 0.7), tsched.build("flow_sde", 0.7)
    jmask = None if mask is None else jnp.asarray(mask)
    want = jrollout_keyed(ja, jp, jnp.asarray(cond), keys, js, 3, jmask)
    x_init, eps = _jax_draws(ja, keys, 3)
    np.testing.assert_array_equal(x_init, np.asarray(want.xs[0]))
    got = trollout_keyed(ta, tp, to_torch(cond), [0, 1, 2], ts_, 3, mask,
                         x_init=to_torch(x_init), eps=to_torch(eps))
    assert tuple(got.xs.shape) == (4, 3, LATENT_TOKENS, LATENT_DIM)
    # f32 through three velocity evaluations of two blocks each and three
    # SDE steps: 2e-4 on latents of |x| ~ 1
    np.testing.assert_allclose(got.x0.numpy(), np.asarray(want.x0),
                               atol=2e-4, rtol=2e-4)
    # logp sums 1024 terms per row and carries feat * log(std): rtol 1e-5
    np.testing.assert_allclose(got.logps.numpy(), np.asarray(want.logps),
                               rtol=1e-5)
    if mask is not None:
        assert float(got.logps[1].abs().max()) == 0.0
    np.testing.assert_array_equal(got.sde_mask.numpy(),
                                  np.asarray(want.sde_mask))


def test_rollout_draws_depend_on_the_request_seed_alone():
    _, ta = adapters(num_steps=2)
    a = request_draws(ta, 1234, 2, "cpu")
    b = request_draws(ta, 1234, 2, "cpu")
    c = request_draws(ta, 1235, 2, "cpu")
    assert all(torch.equal(u, w) for u, w in zip(a, b))
    assert not torch.equal(a[0], c[0])
    assert tuple(a[1].shape) == (2, LATENT_TOKENS, LATENT_DIM)


# ------------------------------------------------------------ text encoder
def test_frozen_text_encoder_matches_jax_on_carried_weights():
    je = JEncoder(**TINY_ENCODER, depth=2, seed=3)
    weights = {"embed": np.asarray(je.embed), "w_out": np.asarray(je.w_out),
               "layers": {str(i): np.asarray(w)
                          for i, w in enumerate(je.layers)}}
    te = TEncoder(**TINY_ENCODER, depth=2, device="cpu", weights=weights)
    prompts = ["a fox in watercolor", "A ROBOT as pixel art at golden hour"]
    for p in prompts:
        np.testing.assert_array_equal(te.tokenize(p), je.tokenize(p))
    want = je.encode(prompts)
    got = te.encode(prompts)
    # f32 tanh/matmul chain of hidden 64 in another order
    for k in ("cond", "pooled"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=1e-5, rtol=1e-5)


# ------------------------------------------------------------------ engine
def _engine(ta, tp, **kw):
    return ServingEngine(ta, tsched.build("flow_sde", 0.7), tp,
                         num_steps=2, device="cpu", cond_len=COND_LEN, **kw)


def test_engine_request_latent_is_independent_of_its_batch():
    ja, ta = adapters(num_steps=2)
    _, tp = params_pair(ja, jnp.float32)
    conds = normal(8, *[(COND_LEN, COND_DIM)] * 3)
    seeds = [11, 22, 33]

    alone = _engine(ta, tp, max_batch=4)
    h = alone.submit(cond=conds[1], seed=seeds[1])
    alone.drain()
    x_alone = h.result()
    assert alone.stats["dispatches"] == {"b1/s2": 1}

    padded = _engine(ta, tp, max_batch=4)            # 3 requests -> bucket 4
    hs = [padded.submit(cond=c, seed=s) for c, s in zip(conds, seeds)]
    padded.drain()
    assert padded.stats["dispatches"] == {"b4/s2": 1}
    assert padded.stats["padded_lanes"] == 1

    small = _engine(ta, tp, max_batch=2)             # 2 + 1
    hs2 = [small.submit(cond=c, seed=s) for c, s in zip(conds, seeds)]
    small.drain()
    assert small.stats["dispatches"] == {"b1/s2": 1, "b2/s2": 1}

    # the draws are bitwise the request's own (one generator per seed); the
    # latents agree to f32 rounding, since matmuls may sum in another order
    # at another batch size
    for other in (hs[1].result(), hs2[1].result()):
        np.testing.assert_allclose(other, x_alone, atol=1e-5, rtol=1e-5)
    assert not np.allclose(hs[0].result(), hs[1].result())


def test_engine_queue_backpressure_and_stats_json():
    from repro_torch.serving import AdmissionConfig, PriorityClass, RetryAfter
    ja, ta = adapters(num_steps=2)
    _, tp = params_pair(ja, jnp.float32)
    adm = AdmissionConfig(classes=(PriorityClass("standard", max_depth=2),))
    eng = _engine(ta, tp, max_batch=2, max_inflight=1, admission=adm)
    (c,) = normal(9, (COND_LEN, COND_DIM))
    # handles are held: an abandoned batch would retire its slot on GC
    hs = [eng.submit(cond=c, seed=s) for s in (1, 2)]   # full: dispatched
    assert eng.stats["inflight"] == 1
    hs += [eng.submit(cond=c, seed=s) for s in (3, 4)]  # queued: cap holds
    with pytest.raises(RetryAfter) as e:
        eng.submit(cond=c, seed=5)
    assert e.value.to_json()["error"] == "over_capacity"
    with pytest.raises(ValueError, match="step-tier"):
        eng.submit(cond=c, seed=6, num_steps=3)
    with pytest.raises(ValueError, match="cond must be"):
        eng.submit(cond=np.zeros((COND_LEN + 1, COND_DIM)), seed=6)
    s = json.loads(json.dumps(eng.stats))
    assert s["pending"] == 2 and s["priorities"]["standard"]["rejected"] == 1
    hs[0].result()                          # fetching retires the slot ...
    assert eng.stats["inflight"] == 1       # ... and the queued pair runs
    assert eng.stats["pending"] == 0 and hs[3].done
    for gone in ("compiles", "cold_dispatches", "compiled_shapes"):
        assert gone not in s


def test_engine_refuses_sharded_layouts():
    """A sharded layout larger than the process group (here none: one
    device) is refused with the reference's ``resolve_axes`` error."""
    from repro_torch.config import DistConfig
    ja, ta = adapters(num_steps=2)
    _, tp = params_pair(ja, jnp.float32)
    with pytest.raises(ValueError, match="dist.data_parallel=2 but only 1 "
                       "device"):
        _engine(ta, tp, dist=DistConfig(data_parallel=2))


# --------------------------------------------------------------------- CLI
def _cli(tmp_path, *extra):
    return ["--reduced", "--sde", "flow_sde", "--requests", "3",
            "--max-batch", "2", "--set", "flow.num_steps=2",
            "--set", "flow.latent_tokens=16", "--set", "flow.latent_dim=8",
            "--set", f"data.encoder={json.dumps(TINY_ENCODER)}",
            "--stats-json", str(tmp_path / "stats.json"), *extra]


def test_serve_cli_runs_end_to_end_on_cpu(tmp_path, capsys):
    out = tserve.main(_cli(tmp_path, "--device", "cpu"))
    lat = out["latents"]
    assert tuple(lat.shape) == (3, 16, 8) and torch.isfinite(lat).all()
    stats = json.loads((tmp_path / "stats.json").read_text())
    assert stats["requests"] == 3 and stats["device"] == "cpu"
    assert stats["dispatches"] == {"b1/s2": 1, "b2/s2": 1}
    assert stats["warmed_shapes"] == ["b1/s2", "b2/s2"]
    assert stats["cond_cache"]["misses"] == 3
    assert "req/s" in capsys.readouterr().out


def test_serve_cli_defaults_to_cuda_and_raises_without_it(tmp_path,
                                                          monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserve.main(_cli(tmp_path))
