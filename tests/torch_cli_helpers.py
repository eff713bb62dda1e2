"""Shared helpers of the CLI parity tests (test_torch_cli*.py): running
either package's CLI in-process, and one numpy draw sequence injected
into both packages' ``cplx.random``."""

import json

import jax.numpy as jnp
import numpy as np
import torch

from mgpgcr_tpu import cli as jcli
from mgpgcr_tpu import cplx as jcplx
from mgpgcr_tpu_torch import cli, cplx


class _Draws:
    """The n-th draw of either package: re, im ~ U[-1, 1) of the requested
    shape from numpy seed 1000 + n, whatever generator or key was passed."""

    def __init__(self):
        self.n = 0

    def __call__(self, shape):
        rng = np.random.default_rng(1000 + self.n)
        self.n += 1
        return rng.uniform(-1, 1, tuple(shape)), rng.uniform(-1, 1, tuple(shape))


def inject_draws(monkeypatch):
    """Replace both packages' random CF draws (right-hand sides, MG start
    vectors) by the same numpy sequence."""
    jdraw, pdraw = _Draws(), _Draws()

    def jrandom(key, shape, dtype=jnp.float32):
        re, im = jdraw(shape)
        return jcplx.CF(jnp.asarray(re, dtype), jnp.asarray(im, dtype))

    def prandom(generator, shape, dtype=torch.float32, device=None):
        re, im = pdraw(shape)
        dev = cplx.resolve_device(device)
        return cplx.CF(torch.as_tensor(re, dtype=dtype, device=dev),
                       torch.as_tensor(im, dtype=dtype, device=dev))

    monkeypatch.setattr(jcplx, "random", jrandom)
    monkeypatch.setattr(cplx, "random", prandom)
    return jdraw, pdraw


def run(main, argv, capsys):
    """(exit code, the last JSON line printed) of ``main(argv)``."""
    rc = main(argv)
    out = capsys.readouterr().out.strip().splitlines()
    return rc, json.loads(out[-1])


def run_both(argv_port, argv_jax, capsys):
    return run(cli.main, argv_port, capsys), run(jcli.main, argv_jax, capsys)
