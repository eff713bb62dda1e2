"""Run one cell of the benchmark once and print its result line.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer metrics), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number compared with its limit,
also printed as the last lines of standard error. Exits 2, printing no
result, without enough CUDA devices; 3 when JAX or the JAX package is
loaded by the time the result would be printed (the metric readers
included), or the program is not the checkout's own.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
if str(HERE.parent) not in sys.path:
    sys.path.insert(0, str(HERE.parent))


def reader(kind: str, name: str, here: Path = HERE):
    """The ``read`` function of ``portbench/<kind>/<name>.py``."""
    path = here / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_{kind}_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def read_metrics(entries, kind: str, run, here: Path = HERE) -> dict:
    out = {}
    for m in entries:
        value = reader(kind, m["name"], here)(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e})"


def report(spec: dict, run, trace: bool, device: dict, here: Path = HERE) -> int:
    """Read the run's metrics and print its result line; print nothing and
    return 3 where JAX or the JAX package is loaded by then."""
    from portbench import harness

    if trace:
        metrics = read_metrics(spec["per_layer"], "metrics", run, here)
    else:
        metrics = read_metrics(spec["end_to_end"], "e2e", run, here)
    result = {"correct": run.correct, "attempted": len(run.solves),
              "failed": len(run.solves) - run.solved, "metrics": metrics, "device": device}
    if trace:
        device["busy_s"] = run.trace.busy_s()
        device["window_s"] = run.trace.window_s
        result["breakdown"] = {"device_ops": run.trace.device_ops(),
                               "idle_gaps": run.trace.idle_gaps()}
    result["checks"] = run.checks
    bad = harness.forbidden_modules()
    if bad:
        print(f"portbench: forbidden modules loaded: {', '.join(bad)}", file=sys.stderr)
        return 3
    for name, c in run.checks.items():
        print(f"portbench check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(result))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from portbench import harness

    spec = harness.load_cell(args.workload)
    import torch

    chips = int(spec["cell"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: the cell needs {chips} CUDA device(s), found {n}", file=sys.stderr)
        return 2
    import mgpgcr_tpu_torch

    if HERE.parent not in Path(mgpgcr_tpu_torch.__file__).resolve().parents:
        print(f"portbench: the program was imported from {mgpgcr_tpu_torch.__file__}, "
              "not from this checkout", file=sys.stderr)
        return 3

    t_cell = time.perf_counter()
    cell = harness.Cell(spec, args.seed, device="cuda")
    run = cell.run
    run.setup_s = time.perf_counter() - T_START
    steps = {"start_to_cell": t_cell - T_START, **run.setup_phases}
    print("portbench setup: " + ", ".join(f"{k} {v:.3f} s" for k, v in steps.items()),
          file=sys.stderr)
    mg = "mg" in spec["config"]
    cell.window(args.seconds, sync_spans=bool(args.trace) and mg)
    if args.trace:
        cell.traced(int(spec["traffic"]["trace_solves"]))
    run.memory_peak_bytes = int(torch.cuda.max_memory_allocated())
    cell.release()
    cell.judge()

    print(f"portbench: {power_limit()}", file=sys.stderr)
    ms = sorted(s["ms"] for s in run.solves)
    print(f"portbench window: {run.window_s:.3f} s, {len(ms)} solves, ms min {ms[0]:.1f} "
          f"median {ms[len(ms) // 2]:.1f} max {ms[-1]:.1f}, iterations "
          f"{sum(s['iters'] for s in run.solves)}, MG setups (s) "
          f"{[round(sum(t.values()), 3) for t in run.setups]}", file=sys.stderr)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
              "memory_peak_bytes": run.memory_peak_bytes}
    return report(spec, run, bool(args.trace), device)


if __name__ == "__main__":
    sys.exit(main())
