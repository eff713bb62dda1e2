"""Small cells for the CPU tests: the real cell's files with the lattice
cut to 4^4, Haar-random links drawn from the seed, and MG blocks of 2^4."""

from __future__ import annotations

import copy

from portbench import harness


def tiny_spec(name: str, configurations: int = 2) -> dict:
    spec = copy.deepcopy(harness.load_cell(name))
    cfg, tr = spec["config"], spec["traffic"]
    cfg["lattice"] = [4, 4, 4, 4]
    cfg["field"] = {"haar": True}
    if "mg" in cfg:
        cfg["mg"]["block"] = 2
        cfg["mg"]["n_nullvecs"] = 4
    if tr.get("configurations"):
        tr["configurations"] = configurations
    if tr.get("min_units"):
        tr["min_units"] = configurations  # the pool once over
    return spec


def run_tiny(name: str, seed: int = 12345, seconds: float = 0.0, **kw):
    cell = harness.Cell(tiny_spec(name), seed, device="cpu", **kw)
    cell.window(seconds)
    cell.release()
    cell.judge()
    return cell.run
