"""The port's ``solve --eo`` against the JAX CLI's (both in-process on the
CPU, float64, 4^4 lattice, k = 0.12, anti-periodic t; 3-row links, as
``--eo`` turns compression off): the same right-hand side on both sides
(one numpy draw injected into both packages' ``cplx.random``), then the
same Schur iteration count, final relative residuals within 1e-10 of each
other, ``eo`` in both results, and independent residuals of the
reconstructed x against the full operator at the tolerance (each x
reconstructed on its own side). The JAX Schur solve's compile is most of
the file's time."""

from torch_cli_helpers import inject_draws, run_both

K = 0.12


def test_eo_solve_matches_jax(capsys, monkeypatch):
    inject_draws(monkeypatch)
    argv = ["solve", "--platform", "cpu", "--dtype", "cf64", "--lattice", "4", "4", "4", "4",
            "--k", str(K), "--antiperiodic", "--tol", "1e-10", "--eo"]
    (rc_p, out_p), (rc_j, out_j) = run_both(argv, argv, capsys)
    assert rc_p == rc_j == 0
    assert out_p["eo"] and out_j["eo"]
    assert out_p["iters"] == out_j["iters"]
    assert abs(out_p["relres"] - out_j["relres"]) <= 1e-10
    assert out_p["indep_relres"] <= 2e-10 and out_j["indep_relres"] <= 2e-10
