"""Run configs of the port (``mgpgcr_tpu_torch/config.py``) against the JAX
package's ``mgpgcr_tpu/config.py``: the same schema and defaults, and a
file written by either package loads in the other to the same config.

- Defaults: the port's default ``RunConfig`` is the JAX one, field for
  field, as dicts.
- JSON: a config saved by the port loads in JAX to the JAX config built
  from the same values, and a JAX-saved one loads in the port (equal
  dicts; the port's round trip equal dataclasses), with MG on and off and
  the smoother off (a None that is not the default).
- TOML: a config the port saves as TOML loads in both packages (JAX reads
  TOML through ``tomllib``); a None whose default is not None has no TOML
  form, and saving one raises rather than writing a file that loads as the
  default.
"""

import dataclasses
import tomllib

import pytest

from mgpgcr_tpu import config as jconfig
from mgpgcr_tpu.solvers.params import GCRParams as JGCRParams
from mgpgcr_tpu.solvers.params import MGParams as JMGParams
from mgpgcr_tpu_torch import config
from mgpgcr_tpu_torch.solvers.params import GCRParams, MGParams


def _pair(mg: dict | None, **run):
    """The same config in both packages."""
    problem = dict(lattice=(4, 4, 4, 4), k=0.12, dtype="cf64", antiperiodic=True, seed=5)
    gcr = dict(tol=1e-9, max_iter=300, restart=8, fused=True)

    def build(mod, gp, mp):
        m = None
        if mg is not None:
            kw = dict(mg)
            if "smoother_gcr" in kw and kw["smoother_gcr"] is not None:
                kw["smoother_gcr"] = gp(**kw["smoother_gcr"])
            m = mp(**kw)
        return mod.RunConfig(problem=mod.ProblemConfig(**problem), gcr=gp(**gcr), mg=m, **run)

    return build(config, GCRParams, MGParams), build(jconfig, JGCRParams, JMGParams)


CASES = [
    (None, {}),
    (dict(block=2, n_nullvecs=3, coarse_format="stencil", n_level=3), dict(eo=False, eager=True)),
    (dict(block=4, smoother_gcr=None, correction_damping=0.5), dict(eo=True, trace="t.npz")),
]


def test_defaults_match():
    assert config.config_to_dict(config.RunConfig()) == jconfig.config_to_dict(jconfig.RunConfig())


@pytest.mark.parametrize("mg,run", CASES)
def test_json_both_directions(tmp_path, mg, run):
    port, jax_cfg = _pair(mg, **run)
    assert config.config_to_dict(port) == jconfig.config_to_dict(jax_cfg)
    config.save_config(str(tmp_path / "port.json"), port)
    assert jconfig.load_config(str(tmp_path / "port.json")) == jax_cfg
    assert config.load_config(str(tmp_path / "port.json")) == port
    jconfig.save_config(str(tmp_path / "jax.json"), jax_cfg)
    assert config.load_config(str(tmp_path / "jax.json")) == port


@pytest.mark.parametrize("mg,run", CASES[:2])
def test_toml_both_directions(tmp_path, mg, run):
    port, jax_cfg = _pair(mg, **run)
    path = str(tmp_path / "port.toml")
    config.save_config(path, port)
    with open(path, "rb") as f:
        tomllib.load(f)  # valid TOML
    assert config.load_config(path) == port
    assert jconfig.load_config(path) == jax_cfg


def test_toml_refuses_an_unrepresentable_none(tmp_path):
    port, _ = _pair(dict(block=2, smoother_gcr=None))
    with pytest.raises(ValueError, match="no TOML form"):
        config.save_config(str(tmp_path / "x.toml"), port)
    # a None that is the default is left out and loads back as None
    plain = dataclasses.replace(port, mg=None)
    config.save_config(str(tmp_path / "y.toml"), plain)
    assert config.load_config(str(tmp_path / "y.toml")) == plain
