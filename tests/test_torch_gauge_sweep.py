"""The port's heat-bath and overrelaxation updates against those of
``mgpgcr_tpu.gauge`` in complex128, one (mu, parity) sublattice update at
a time, both parities in the order ``sweep`` runs them. JAX's random
draws are replayed through the port's ``sampler`` argument: for (mu,
parity) and subgroup idx, JAX draws from fold_in(fold_in(key, 2 mu +
parity), idx), split into the Kennedy--Pendleton key and the direction
key (``_kp_sample``, ``_random_su2_from_h0``). The port asks for each
draw with its own alpha; the result equals JAX's to 1e-10.
(4, 4, 2, 4) lattice, Haar-random start made with numpy from a seed.
JAX's whole jitted ``sweep`` compiles for ~20 s on one core, and each
direction's heat-bath update for ~4 s, so the heat bath is held in one
direction and the overrelaxation in all four; ``reunitarize`` is held in
test_torch_gauge.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mgpgcr_tpu import gauge as jgauge
from mgpgcr_tpu_torch import LatticeMesh, gauge
from mgpgcr_tpu_torch.ops.wilson import random_links_np

DIMS = (4, 4, 2, 4, 4, 3)
BETA = 6.0


def _replay(key):
    """A sampler that hands out JAX's draws of ``jgauge.sweep(key, ...)``."""
    kp = jax.jit(jgauge._kp_sample)
    su2 = jax.jit(jgauge._random_su2_from_h0, static_argnums=2)

    def sample(mu, parity, idx, alpha):
        sub = jax.random.fold_in(jax.random.fold_in(key, 2 * mu + parity), idx)
        k_h0, k_dir = jax.random.split(sub)
        h0, _ = kp(k_h0, jnp.asarray(alpha.numpy()))
        return torch.from_numpy(np.array(su2(k_dir, h0, jnp.complex128)))

    return sample


def _start():
    links = random_links_np(3, LatticeMesh(DIMS))
    return jnp.asarray(links), torch.as_tensor(links)


def _masks(shape):
    return ([jgauge._parity_mask(shape, p) for p in (0, 1)],
            [gauge.parity_mask(shape, p) for p in (0, 1)])


def test_heatbath_update_matches_jax():
    mu = 1
    want, got = _start()
    jmasks, masks = _masks(DIMS[:4])
    key = jax.random.PRNGKey(42)
    sampler = _replay(key)
    hb = jax.jit(jgauge._heatbath_mu_parity, static_argnames=("mu", "beta"))
    for p in (0, 1):
        want = hb(jax.random.fold_in(key, 2 * mu + p), want, mu=mu, parity_mask=jmasks[p],
                  beta=BETA)
        gauge._heatbath_mu_parity(got, mu, p, masks[p], BETA, sampler)
    assert not np.allclose(got.numpy(), random_links_np(3, LatticeMesh(DIMS)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-10)
    assert abs(gauge.plaquette(got) - float(jgauge.plaquette(want))) < 1e-12


@pytest.mark.parametrize("mu", range(4))
def test_overrelax_update_matches_jax(mu):
    want, got = _start()
    jmasks, masks = _masks(DIMS[:4])
    orx = jax.jit(jgauge._overrelax_mu_parity, static_argnames=("mu",))
    for p in (0, 1):
        want = orx(want, mu=mu, parity_mask=jmasks[p])
        gauge._overrelax_mu_parity(got, mu, masks[p])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-10)
