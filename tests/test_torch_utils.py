"""The port's run utilities (``mgpgcr_tpu_torch/utils``) against the JAX
package's ``mgpgcr_tpu/utils``.

- Residual traces: a history saved by either package (.npz with its
  metadata, and the reference's one-per-line .txt) loads in the other to
  the same float64 values (exact), NaN slots past the last iteration
  dropped; the port saves from a tensor.
- Rooflines: ``roofline``, ``dslash_roofline`` and
  ``gcr_iteration_roofline`` give the same numbers as JAX's for the same
  inputs and bandwidth (the CPU entry, 5e10 B/s, on both sides); the
  port's rate table knows the H100 (3.35e12 B/s, 67e12 f32 flop/s,
  matched on the CUDA device name) and carries no TPU entry.
- ``RunLogger`` writes the JAX logger's JSON lines: the same keys for the
  same event, to a stream and to a file; ``Timer`` logs a "timer" event.
- ``is_transient``: network statuses are transient; a CUDA error, a CUDA
  out-of-memory (even one whose size reads "503") and a failed kernel
  launch as the port's kernel library reports it are not, so the retry
  re-raises them at once, while a transient failure is retried.
- ``annotate`` and ``trace`` run on the CPU; ``trace`` writes a Chrome
  trace.
"""

import io
import json
import os

import jax
import numpy as np
import pytest
import torch

from mgpgcr_tpu.mesh import LatticeMesh as JMesh
from mgpgcr_tpu.utils import logging as jlogging
from mgpgcr_tpu.utils import profiling as jprofiling
from mgpgcr_tpu.utils.trace import load_residual_trace as j_load_trace
from mgpgcr_tpu.utils.trace import save_residual_trace as j_save_trace
from mgpgcr_tpu_torch.mesh import LatticeMesh
from mgpgcr_tpu_torch.utils import logging, profiling, retry
from mgpgcr_tpu_torch.utils.trace import load_residual_trace, save_residual_trace

HISTORY = np.array([1.0, 0.31, 2.5e-3, 7.25e-7, 1.0e-11, np.nan, np.nan])


@pytest.mark.parametrize("suffix", [".npz", ".txt"])
def test_trace_files_both_directions(tmp_path, suffix):
    meta = {"k": 0.125, "lattice": [4, 4, 4, 4]} if suffix == ".npz" else {}
    want = HISTORY[~np.isnan(HISTORY)]
    port_path, jax_path = str(tmp_path / f"port{suffix}"), str(tmp_path / f"jax{suffix}")
    save_residual_trace(port_path, torch.tensor(HISTORY), meta=meta)
    h, m = j_load_trace(port_path)
    np.testing.assert_array_equal(h, want)
    assert m == meta
    j_save_trace(jax_path, HISTORY, meta=meta)
    h, m = load_residual_trace(jax_path)
    np.testing.assert_array_equal(h, want)
    assert m == meta
    with open(port_path, "rb") as f1, open(jax_path, "rb") as f2:
        if suffix == ".txt":
            assert f1.read() == f2.read()


def test_rooflines_match():
    jdev = jax.devices("cpu")[0]
    mesh, jmesh = LatticeMesh((8, 4, 4, 6, 4, 3)), JMesh((8, 4, 4, 6, 4, 3))
    pairs = [
        (profiling.roofline("k", 1.5e-3, 123456789, flops=987654, nnz=4321, device="cpu"),
         jprofiling.roofline("k", 1.5e-3, 123456789, flops=987654, nnz=4321, device=jdev)),
        (profiling.dslash_roofline(mesh, 2.5e-4, 4, 2, device="cpu"),
         jprofiling.dslash_roofline(jmesh, 2.5e-4, 4, 2, device=jdev)),
        (profiling.gcr_iteration_roofline(mesh, 7e-4, 5, 8, device="cpu"),
         jprofiling.gcr_iteration_roofline(jmesh, 7e-4, 5, 8, device=jdev)),
    ]
    for port, ref in pairs:
        assert port.asdict() == ref.asdict()
        assert port.bandwidth == ref.bandwidth == 5.0e10


def test_rate_table_is_the_h100s(monkeypatch):
    assert set(profiling.HBM_BW) == {"h100", "cpu"}
    monkeypatch.setattr(profiling, "_kind", lambda device=None: "nvidia h100 80gb hbm3")
    assert profiling.chip_bandwidth() == 3.35e12
    assert profiling.chip_flops() == 67e12
    assert profiling.roofline("k", 1.0, 3.35e12).vs_hbm_roofline == 1.0
    monkeypatch.setattr(profiling, "_kind", lambda device=None: "some other card")
    assert profiling.chip_flops() is None
    assert profiling.chip_bandwidth() is None
    rl = profiling.roofline("k", 1.0, 3.35e12)
    assert rl.vs_hbm_roofline is None and rl.asdict()["vs_hbm_roofline"] is None
    monkeypatch.setattr(profiling, "_kind", lambda device=None: "cpu")
    assert profiling.chip_bandwidth() == 5.0e10


def test_run_logger_keys(tmp_path):
    fields = dict(name="solve", iters=12, relres=np.float64(3e-7), arr=torch.tensor(2.5))
    lines = {}
    for tag, mod in (("port", logging), ("jax", jlogging)):
        stream = io.StringIO()
        path = str(tmp_path / f"{tag}.jsonl")
        with mod.RunLogger(stream=stream, path=path) as lg:
            lg.log("result", **fields)
            with mod.Timer(lg, "phase"):
                pass
        with open(path) as f:
            file_lines = [json.loads(x) for x in f.read().splitlines()]
        assert [json.loads(x) for x in stream.getvalue().splitlines()] == file_lines
        lines[tag] = file_lines
    for port, ref in zip(lines["port"], lines["jax"]):
        assert list(port) == list(ref)
        assert {k: v for k, v in port.items() if k not in ("ts", "seconds")} == \
            {k: v for k, v in ref.items() if k not in ("ts", "seconds")}
    assert lines["port"][1]["event"] == "timer" and lines["port"][1]["name"] == "phase"
    x = torch.ones(3)
    assert logging.Timer.block_on({"a": [x]})["a"][0] is x


@pytest.mark.parametrize("exc,transient", [
    (RuntimeError("CUDA error: an illegal memory access was encountered"), False),
    (torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 503.00 MiB"), False),
    (RuntimeError("dslash_apply: CUDA error 719 (unspecified launch failure)"), False),
    (RuntimeError("NCCL error: unhandled system error, 503 Service Unavailable"), False),
    (ValueError("kernel takes contiguous tensors"), False),
    (ConnectionError("Connection reset by peer"), True),
    (RuntimeError("HTTP 503 Service Unavailable"), True),
    (RuntimeError("UNAVAILABLE: Socket closed"), True),
])
def test_transient_markers(exc, transient):
    assert retry.is_transient(exc) is transient


def test_retry_reraises_a_device_failure_at_once():
    calls = []

    def failing(err):
        calls.append(1)
        raise err

    with pytest.raises(RuntimeError, match="CUDA error"):
        retry.with_tunnel_retry(failing, RuntimeError("CUDA error: unspecified launch failure"),
                                base_delay=0.0)
    assert len(calls) == 1
    attempts = iter([ConnectionError("Connection reset by peer"), None])

    def flaky():
        err = next(attempts)
        if err is not None:
            raise err
        return "ok"

    assert retry.with_tunnel_retry(flaky, base_delay=0.0) == "ok"


def test_annotate_and_trace_on_the_cpu(tmp_path):
    with profiling.trace(str(tmp_path / "prof")):
        with profiling.annotate("phase"):
            torch.ones(8).sum()
    assert os.path.getsize(tmp_path / "prof" / "trace.json") > 0
