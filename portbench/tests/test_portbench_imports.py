"""Isolation and the benchmark's own rules, on the CPU: nothing a run
loads is JAX or the JAX package (top-level names compared whole), the
reference loads nothing of the program, every name in BENCHMARK.json
finds its file, and a run without a card prints no result."""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
FORBIDDEN = {"jax", "jaxlib", "flax", "mgpgcr_tpu"}


def _top_levels(code: str) -> set[str]:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\n"
                          "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
                         cwd=ROOT, capture_output=True, text=True, check=True, timeout=600)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_neither_jax_nor_the_jax_package():
    """A whole small cell through the harness, every reader loaded."""
    loaded = _top_levels(
        "from portbench.tests.helpers import run_tiny\n"
        "from portbench import harness, run as r\n"
        "import portbench.controls\n"
        "res = run_tiny('mg32.noise', seconds=0.0)\n"
        "for m in harness.load_benchmark()['end_to_end']: r.reader('e2e', m['name'])(res)\n"
        "for m in harness.load_benchmark()['per_layer']: r.reader('metrics', m['name'])(res)\n"
        "assert not harness.forbidden_modules()\n")
    assert "mgpgcr_tpu_torch" in loaded  # the program was loaded, by its own name
    assert not loaded & FORBIDDEN


def test_a_reader_that_loads_the_jax_package_stops_the_result(tmp_path):
    """A metric reader that imports the JAX package's name, loaded after
    the window: exit 3, no result on standard output."""
    import shutil

    stub = tmp_path / "stub" / "mgpgcr_tpu"
    stub.mkdir(parents=True)
    (stub / "__init__.py").write_text("")
    shutil.copytree(ROOT / "portbench" / "e2e", tmp_path / "e2e")
    (tmp_path / "e2e" / "setup_s.py").write_text(
        "def read(run):\n    import mgpgcr_tpu  # noqa: F401\n    return run.setup_s\n")
    p = subprocess.run(
        [sys.executable, "-c",
         f"import sys; sys.path.insert(0, {str(tmp_path / 'stub')!r})\n"
         "from pathlib import Path\n"
         "from portbench import run as r\n"
         "from portbench.tests.helpers import run_tiny, tiny_spec\n"
         "res = run_tiny('gcr32.noise')\n"
         "device = {'platform': 'cpu', 'kind': 'cpu', 'count': 1, 'memory_peak_bytes': 0}\n"
         f"sys.exit(r.report(tiny_spec('gcr32.noise'), res, False, device, Path({str(tmp_path)!r})))\n"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert p.returncode == 3 and p.stdout.strip() == "", (p.returncode, p.stdout, p.stderr[-2000:])
    assert "mgpgcr_tpu" in p.stderr


def test_without_the_planted_reader_the_result_is_printed():
    p = subprocess.run(
        [sys.executable, "-c",
         "import sys\n"
         "from portbench import run as r\n"
         "from portbench.tests.helpers import run_tiny, tiny_spec\n"
         "res = run_tiny('gcr32.noise')\n"
         "device = {'platform': 'cpu', 'kind': 'cpu', 'count': 1, 'memory_peak_bytes': 0}\n"
         "sys.exit(r.report(tiny_spec('gcr32.noise'), res, False, device))\n"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    res = json.loads(p.stdout.strip().splitlines()[-1])
    assert res["correct"] and list(res)[-1] == "checks" and "setup_s" in res["metrics"]


def test_the_reference_loads_nothing_of_the_program():
    loaded = _top_levels("import portbench.reference.wilson, portbench.reference.roofline, "
                         "portbench.sources, portbench.timing, portbench.trace")
    assert not loaded & (FORBIDDEN | {"mgpgcr_tpu_torch"})


def test_forbidden_names_are_compared_whole():
    from portbench import harness

    assert "mgpgcr_tpu_torch" not in harness.forbidden_modules()
    sys.modules.setdefault("mgpgcr_tpu_fake_probe", sys)
    try:
        assert harness.forbidden_modules() == []
    finally:
        del sys.modules["mgpgcr_tpu_fake_probe"]


def test_every_name_finds_its_file():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for c in bench["configs"]:
        assert (ROOT / c["file"]).is_file()
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert set(c["reduced"]) <= set(cfg["reduced"]) and cfg["assumed"]
    cells = {w["name"] for w in bench["workloads"]}
    for w in bench["workloads"]:
        assert (ROOT / "portbench" / "traffic" / f"{w['traffic']}.json").is_file()
    for m in bench["end_to_end"]:
        assert (ROOT / "portbench" / "e2e" / f"{m['name']}.py").is_file()
        assert set(m.get("workloads", cells)) <= cells
    for m in bench["per_layer"]:
        assert (ROOT / "portbench" / "metrics" / f"{m['name']}.py").is_file()
        assert set(m["workloads"]) <= cells
        moved = {e["name"]: e for e in bench["end_to_end"]}[m["moves"]]
        assert set(m["workloads"]) <= set(moved.get("workloads", cells))


def test_without_a_card_a_run_prints_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    p = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", "gcr32.noise",
                        "--seed", str(2**31 + 5), "--seconds", "1", "--trace", "0"],
                       cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert p.returncode != 0 and p.stdout.strip() == ""


@pytest.mark.cuda
def test_one_short_run_on_the_card():
    """On the card: one short run of the plain cell prints a correct
    result as its last line."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    p = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", "gcr32.noise",
                        "--seed", str(2**31 + 7), "--seconds", "2", "--trace", "0"],
                       cwd=ROOT, capture_output=True, text=True, timeout=1200)
    assert p.returncode == 0, p.stderr[-2000:]
    res = json.loads(p.stdout.strip().splitlines()[-1])
    assert res["correct"] and list(res)[-1] == "checks"
