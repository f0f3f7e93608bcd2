"""Shared set-up of the ``tests/test_torch_*.py`` parity tests: the reduced
``flux_dit`` in both packages and one parameter tree carried between them.

Parameters are made once, by the JAX package, and carried to the port
through ``repro_torch.models.params.from_numpy``; inputs are made with
numpy from a seed.  The adaLN-zero ``ada`` projections are zero at init,
which would make every block the identity, so the shared tree draws them
from a seeded normal instead: the blocks then really run.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.config import FlowRLConfig as JFlowRLConfig
from repro.models import params as jparams
from repro.models.flow import FlowAdapter as JFlowAdapter
from repro_torch import configs as tconfigs
from repro_torch.config import FlowRLConfig as TFlowRLConfig
from repro_torch.models import params as tparams
from repro_torch.models.flow import FlowAdapter as TFlowAdapter

LATENT_TOKENS, LATENT_DIM = 64, 16       # an 8x8 latent of 16 channels
COND_LEN, COND_DIM = 4, 32
ADA_STD = 0.05


def adapters(sde_type="flow_sde", eta=0.7, num_steps=3):
    """(JAX FlowAdapter, port FlowAdapter) over the reduced flux_dit."""
    kw = dict(sde_type=sde_type, eta=eta, num_steps=num_steps,
              latent_tokens=LATENT_TOKENS, latent_dim=LATENT_DIM)
    ja = JFlowAdapter(jconfigs.get_reduced("flux_dit"), JFlowRLConfig(**kw),
                      COND_DIM)
    ta = TFlowAdapter(tconfigs.get_reduced("flux_dit"), TFlowRLConfig(**kw),
                      COND_DIM)
    return ja, ta


def _randomize_ada(tree, rng):
    if isinstance(tree, dict):
        return {k: (rng.standard_normal(v.shape).astype(np.float32)
                    * ADA_STD).astype(v.dtype) if k == "ada"
                else _randomize_ada(v, rng) for k, v in tree.items()}
    return tree


def params_pair(ja, dtype=jnp.float32, seed=0):
    """The JAX params (with drawn ``ada``) and the same tree on the port's
    CPU, carried bit for bit."""
    p = jparams.init(ja.spec(), jax.random.PRNGKey(seed), dtype)
    tree = _randomize_ada(jax.tree.map(np.asarray, p),
                          np.random.default_rng(seed + 100))
    jp = jax.tree.map(jnp.asarray, tree)
    tp = tparams.from_numpy(tree, "cpu")
    return jp, tp


def normal(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def to_torch(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Run a test's torch CPU ops on one thread, as the test workers share
    the machine's cores (pytest-xdist); torch's default of one thread per
    core in every worker oversubscribes them many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)
