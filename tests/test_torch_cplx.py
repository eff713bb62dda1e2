"""Port parity: ``mgpgcr_tpu_torch.cplx`` / ``fields`` against the JAX
package's ``cplx`` / ``fields`` on the same numpy inputs (float64, exact
up to summation order: rtol 1e-12)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mgpgcr_tpu import cplx as jcplx
from mgpgcr_tpu import fields as jfields
from mgpgcr_tpu_torch import cplx, fields

SHAPE = (4, 3, 4, 4, 16)
S = 3


def _np_field(rng, shape):
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


def _jcf(z):
    return jcplx.CF(jnp.asarray(z.real, jnp.float64), jnp.asarray(z.imag, jnp.float64))


def _tcf(z):
    return cplx.from_numpy(z, torch.float64, "cpu")


def _jnp(x):
    if isinstance(x, jcplx.CF):
        return np.asarray(x.re) + 1j * np.asarray(x.im)
    return np.asarray(x)


def _tnp(x):
    return cplx.to_numpy(x)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(42)
    return {
        "a": _np_field(rng, SHAPE),
        "b": _np_field(rng, SHAPE),
        "stack": _np_field(rng, (S,) + SHAPE),
        "coeffs": _np_field(rng, (S,)),
        "mask": rng.random(SHAPE) > 0.5,
    }


CASES = {
    "vdot": (
        lambda d: jcplx.vdot(_jcf(d["a"]), _jcf(d["b"])),
        lambda d: cplx.vdot(_tcf(d["a"]), _tcf(d["b"])),
    ),
    "abs2_sum": (
        lambda d: jcplx.abs2_sum(_jcf(d["a"])),
        lambda d: cplx.abs2_sum(_tcf(d["a"])),
    ),
    "scale_real": (
        lambda d: jcplx.scale_real(_jcf(d["a"]), 0.37),
        lambda d: cplx.scale_real(_tcf(d["a"]), 0.37),
    ),
    "mul_add_sub": (
        lambda d: _jcf(d["a"]) * _jcf(d["b"]) - _jcf(d["b"]) + _jcf(d["a"]),
        lambda d: _tcf(d["a"]) * _tcf(d["b"]) - _tcf(d["b"]) + _tcf(d["a"]),
    ),
    "complex_scalar_mul": (
        lambda d: _jcf(d["a"]) * (0.3 - 0.7j),
        lambda d: _tcf(d["a"]) * torch.tensor(0.3 - 0.7j, dtype=torch.complex128),
    ),
    "where": (
        lambda d: jcplx.where(jnp.asarray(d["mask"]), _jcf(d["a"]), _jcf(d["b"])),
        lambda d: cplx.where(torch.as_tensor(d["mask"]), _tcf(d["a"]), _tcf(d["b"])),
    ),
    "stack_zeros": (
        lambda d: jcplx.stack_zeros(S, _jcf(d["a"])),
        lambda d: cplx.stack_zeros(S, _tcf(d["a"])),
    ),
    "conj_contract_stack": (
        lambda d: jcplx.conj_contract_stack(_jcf(d["stack"]), _jcf(d["b"])),
        lambda d: cplx.conj_contract_stack(_tcf(d["stack"]), _tcf(d["b"])),
    ),
    "weighted_stack_sum": (
        lambda d: jcplx.weighted_stack_sum(_jcf(d["coeffs"]), _jcf(d["stack"])),
        lambda d: cplx.weighted_stack_sum(
            torch.as_tensor(d["coeffs"]), _tcf(d["stack"])
        ),
    ),
    "roll": (
        lambda d: jcplx.roll(_jcf(d["a"]), -3, 4),
        lambda d: cplx.roll(_tcf(d["a"]), -3, 4),
    ),
    "take": (
        lambda d: jcplx.take(_jcf(d["a"]), jnp.array([2, 3, 0, 1]), 0),
        lambda d: cplx.take(_tcf(d["a"]), [2, 3, 0, 1], 0),
    ),
    "stack": (
        lambda d: jcplx.stack([_jcf(d["a"]), _jcf(d["b"])], axis=1),
        lambda d: cplx.stack([_tcf(d["a"]), _tcf(d["b"])], axis=1),
    ),
    "fields_dot": (
        lambda d: jfields.dot(jnp.asarray(d["a"]), jnp.asarray(d["b"])),
        lambda d: fields.dot(torch.as_tensor(d["a"]), torch.as_tensor(d["b"])),
    ),
    "fields_norm": (
        lambda d: jfields.norm(jnp.asarray(d["a"])),
        lambda d: fields.norm(torch.as_tensor(d["a"])),
    ),
    "fields_dot_cf": (
        lambda d: jcplx.vdot(_jcf(d["b"]), _jcf(d["a"])),
        lambda d: fields.dot(_tcf(d["b"]), _tcf(d["a"])),
    ),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_matches_jax(data, name):
    jfn, tfn = CASES[name]
    want = _jnp(jfn(data))
    got = _tnp(tfn(data))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


def test_numpy_round_trip(data):
    z = data["a"]
    assert np.array_equal(cplx.to_numpy(cplx.from_numpy(z, torch.float64, "cpu")), z)
    np.testing.assert_allclose(
        cplx.to_numpy(cplx.from_numpy(z, torch.float32, "cpu")),
        jcplx.to_numpy(jcplx.from_numpy(z, jnp.float32)),
        rtol=0,
        atol=0,
    )


def test_random_fields_are_uniform_and_seeded():
    g1 = torch.Generator().manual_seed(3)
    g2 = torch.Generator().manual_seed(3)
    x = cplx.random(g1, SHAPE, torch.float64, "cpu")
    y = cplx.random(g2, SHAPE, torch.float64, "cpu")
    assert torch.equal(x.re, y.re) and torch.equal(x.im, y.im)
    assert float(x.re.min()) >= -1 and float(x.re.max()) < 1
    f = fields.random_field(torch.Generator().manual_seed(3), 1000, device="cpu")
    assert f.dtype == torch.complex128 and f.shape == (1000,)
    assert abs(float(f.real.mean())) < 0.1 and abs(float(f.imag.mean())) < 0.1
