"""The port's command line (``python -m mgpgcr_tpu_torch``) against the JAX
package's (``mgpgcr_tpu/cli.py``), both run in-process on the CPU
(``--platform cpu``), float64 (``--dtype cf64``), 4^4 lattices.

- Parsers: the same subcommands, and each subcommand the same option
  strings and positionals.
- The plain solve, each CLI driven by a config file the OTHER package
  wrote (JSON): the same right-hand side on both sides (one numpy draw
  injected into both packages' ``cplx.random``), then the same iteration
  count, final relative residuals within 1e-10 of each other, independent
  residuals at the tolerance, and residual traces (the ``--trace`` files)
  equal to rtol 1e-8.
- Fixtures: ``generate`` writes byte-identical parsed.txt files from both
  CLIs (the same numpy links); ``parse`` converts a MatrixMarket file to
  byte-identical caches; ``solve --matrix`` detects the Wilson structure
  on both sides (``detected_wilson``) and takes the same iterations on the
  injected right-hand side.
- ``info`` reports the torch version, the device and ``native_io``.

The even-odd solve is in test_torch_cli_eo.py (its JAX run's compile is
most of that file's time); the MG solve is in test_torch_mg_dist.py, whose
JAX reference setup compiles the same programs as the JAX CLI's.
"""

import argparse

import numpy as np
import pytest
import torch
from torch_cli_helpers import inject_draws, run, run_both

from mgpgcr_tpu import cli as jcli
from mgpgcr_tpu import config as jconfig
from mgpgcr_tpu.io import native_parse as j_native_parse
from mgpgcr_tpu.solvers.params import GCRParams as JGCRParams
from mgpgcr_tpu.utils.trace import load_residual_trace as j_load_trace
from mgpgcr_tpu_torch import cli, config
from mgpgcr_tpu_torch.io import native_parse
from mgpgcr_tpu_torch.solvers.params import GCRParams

K = 0.12


class _Parsed(Exception):
    pass


def _options(parser: argparse.ArgumentParser) -> dict:
    """{subcommand: sorted option strings and positional names}."""
    sub = next(a for a in parser._actions if isinstance(a, argparse._SubParsersAction))
    return {name: sorted(s for act in p._actions
                         for s in (act.option_strings or [act.dest]))
            for name, p in sub.choices.items()}


def test_parsers_match(monkeypatch):
    captured = {}

    def capture(self, args=None, namespace=None):
        captured["parser"] = self
        raise _Parsed

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", capture)
    with pytest.raises(_Parsed):
        jcli.main(["info"])
    monkeypatch.undo()
    want = _options(captured["parser"])
    got = _options(cli.build_parser())
    assert set(got) == {"solve", "ksweep", "parse", "generate", "info"} == set(want)
    assert got == want
    assert "--mg-ckpt" not in got["solve"]


def test_plain_solve_from_each_others_config(tmp_path, capsys, monkeypatch):
    inject_draws(monkeypatch)
    problem = dict(lattice=(4, 4, 4, 4), k=K, dtype="cf64", antiperiodic=True, seed=2)
    gcr = dict(tol=1e-10, max_iter=400, restart=5)
    port_cfg = config.RunConfig(problem=config.ProblemConfig(**problem), gcr=GCRParams(**gcr),
                                trace=str(tmp_path / "port_trace.npz"))
    jax_cfg = jconfig.RunConfig(problem=jconfig.ProblemConfig(**problem),
                                gcr=JGCRParams(**gcr), trace=str(tmp_path / "jax_trace.npz"))
    jconfig.save_config(str(tmp_path / "by_jax.json"), jax_cfg)
    config.save_config(str(tmp_path / "by_port.json"), port_cfg)
    # each CLI reads the other package's file: the port's trace path is in
    # the JAX-written file and vice versa, so swap them by flag
    (rc_p, out_p), (rc_j, out_j) = run_both(
        ["solve", "--platform", "cpu", "--config", str(tmp_path / "by_jax.json"),
         "--trace", str(tmp_path / "port_trace.npz")],
        ["solve", "--platform", "cpu", "--config", str(tmp_path / "by_port.json"),
         "--trace", str(tmp_path / "jax_trace.npz")], capsys)
    assert rc_p == rc_j == 0
    assert out_p["converged"] and out_j["converged"]
    assert out_p["iters"] == out_j["iters"]
    assert abs(out_p["relres"] - out_j["relres"]) <= 1e-10
    assert out_p["indep_relres"] <= 1e-10 * 1.01 and out_j["indep_relres"] <= 1e-10 * 1.01
    assert set(out_p) == set(out_j)
    hp, mp = j_load_trace(str(tmp_path / "port_trace.npz"))
    hj, mj = j_load_trace(str(tmp_path / "jax_trace.npz"))
    assert mp == mj == {"k": K}
    np.testing.assert_allclose(hp, hj, rtol=1e-8)


def test_fixture_generate_parse_detect(tmp_path, capsys, monkeypatch):
    # the JAX package writes with the native library only where a built one
    # lies in native/ (git-ignored); the port builds it from source. The
    # two writers format numbers differently, so the port writes the way
    # the JAX package can
    if j_native_parse._lib() is None:
        monkeypatch.setattr(native_parse, "write_parsed_txt_native", lambda *args: False)
    gen = ["generate", "--lattice", "4", "4", "4", "4", "--seed", "4", "--antiperiodic"]
    (rc_p, out_p), (rc_j, out_j) = run_both(
        gen + [str(tmp_path / "port.txt"), "--platform", "cpu"],
        gen + [str(tmp_path / "jax.txt"), "--platform", "cpu"], capsys)
    assert rc_p == rc_j == 0 and out_p["nnz"] == out_j["nnz"] == 119808
    assert (tmp_path / "port.txt").read_bytes() == (tmp_path / "jax.txt").read_bytes()

    # parse: a small MatrixMarket file -> the same parsed.txt from both
    (tmp_path / "m.mtx").write_text(
        "%%MatrixMarket matrix coordinate complex general\n3 3 4\n"
        "1 1 1.0 0.5\n2 1 -2.0 0.0\n2 3 0.25 -1.5\n3 2 3.0 1.0\n")
    (rc_p, _), (rc_j, _) = run_both(
        ["parse", str(tmp_path / "m.mtx"), str(tmp_path / "mp.txt")],
        ["parse", str(tmp_path / "m.mtx"), str(tmp_path / "mj.txt")], capsys)
    assert rc_p == rc_j == 0
    assert (tmp_path / "mp.txt").read_bytes() == (tmp_path / "mj.txt").read_bytes()

    inject_draws(monkeypatch)
    solve = ["solve", "--platform", "cpu", "--dtype", "cf64", "--matrix",
             str(tmp_path / "port.txt"), "--k", str(K), "--tol", "1e-8"]
    (rc_p, out_p), (rc_j, out_j) = run_both(solve, solve, capsys)
    assert rc_p == rc_j == 0
    assert out_p["detected_wilson"] and out_j["detected_wilson"]
    assert out_p["iters"] == out_j["iters"]
    assert abs(out_p["relres"] - out_j["relres"]) <= 1e-10
    assert out_p["indep_relres"] <= 1e-8


def test_info(capsys):
    rc, out = run(cli.main, ["info", "--platform", "cpu"], capsys)
    assert rc == 0
    assert out["torch"] == torch.__version__ and out["backend"] == "cpu"
    assert out["device_kind"] == "cpu" and isinstance(out["native_io"], bool)


def test_solve_without_a_card_raises(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["solve", "--lattice", "4", "4", "4", "4", "--dtype", "cf32"])
