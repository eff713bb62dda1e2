"""Run configuration: dataclasses, JSON and TOML files, CLI overlay.

Counterpart of ``mgpgcr_tpu/config.py`` (the reference chooses an
experiment by editing ``main()`` and recompiling, main.cpp:29-57). A run is
a ``RunConfig`` built from a JSON or TOML file and/or CLI flags; it maps
onto the port's ``GCRParams`` / ``MGParams``. The schema and defaults are
the JAX package's, so a file written by either package loads in the other.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Optional

from mgpgcr_tpu_torch.solvers.params import GCRParams, MGParams


@dataclass(frozen=True)
class ProblemConfig:
    """What system to solve: an ingested matrix or a synthetic lattice."""

    matrix: Optional[str] = None  # parsed.txt / .mtx / .npz path
    lattice: tuple[int, ...] = ()  # synthetic Wilson-Dirac spacetime dims
    k: float = 0.1  # hopping parameter in A = I - kD
    seed: int = 0
    dtype: str = "complex128"  # complex128 | complex64 | cf32 | cf64
    antiperiodic: bool = False  # anti-periodic temporal BC (synthetic only)
    compress: bool = True  # two-row SU(3) link storage on the card's Dslash
    # (exact reconstruction); off for eo (the parity split wants 3-row links)
    detect: bool = True  # factorise ingested Wilson matrices back into
    # links + projectors (ops/ingest.py) and route the solve through the
    # Dslash kernel; the generic ingested formats when the matrix does not
    # verify (cf dtypes only)


@dataclass(frozen=True)
class RunConfig:
    problem: ProblemConfig = field(default_factory=ProblemConfig)
    gcr: GCRParams = field(default_factory=lambda: GCRParams(tol=1e-11, max_iter=4000, restart=5))
    mg: Optional[MGParams] = None  # None = unpreconditioned
    eager: bool = False  # host-driven outer loop (gcr_solve_eager)
    eo: bool = False  # even-odd (Schur) reduction: solve S x_e = b'_e on
    # the even sites, back-substitute the odd half (solvers/eo.py); lattice
    # cf problems only. With mg set, the hierarchy is built over the Schur
    # operator (setup_eo_mg)
    trace: Optional[str] = None  # residual trace artifact path
    log: Optional[str] = None  # JSON-lines run log path


def _dataclass_from_dict(cls, d: dict):
    if d is None:
        return None
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name not in d:
            continue
        v = d[f.name]
        if f.name == "problem":
            v = _dataclass_from_dict(ProblemConfig, v)
        elif f.name == "gcr" or f.name in ("setup_gcr", "coarse_gcr", "smoother_gcr"):
            v = _dataclass_from_dict(GCRParams, v) if v is not None else None
        elif f.name == "mg":
            v = _dataclass_from_dict(MGParams, v) if v is not None else None
        elif f.name == "lattice":
            v = tuple(v)
        kwargs[f.name] = v
    return cls(**kwargs)


def _to_dict(obj):
    if dataclasses.is_dataclass(obj):
        return {
            f.name: _to_dict(getattr(obj, f.name)) for f in dataclasses.fields(obj)
        }
    if isinstance(obj, (list, tuple)):
        return list(obj)
    return obj


def config_to_dict(cfg: RunConfig) -> dict:
    return _to_dict(cfg)


def config_from_dict(d: dict) -> RunConfig:
    return _dataclass_from_dict(RunConfig, d)


def load_config(path: str) -> RunConfig:
    """JSON (.json) or TOML (.toml) run config."""
    if path.endswith(".toml"):
        import tomllib

        with open(path, "rb") as f:
            return config_from_dict(tomllib.load(f))
    with open(path) as f:
        return config_from_dict(json.load(f))


def _toml_value(v) -> str:
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, (int, float)):
        return repr(v)
    if isinstance(v, str):
        return json.dumps(v)  # a TOML basic string
    if isinstance(v, list):
        return "[" + ", ".join(_toml_value(x) for x in v) + "]"
    raise TypeError(f"no TOML form for {v!r}")


def _toml_table(obj, prefix: str, lines: list) -> None:
    """Append the TOML of dataclass ``obj`` under table ``prefix``. A field
    that is None is left out, so it loads as its default; where that
    default is not None the file could not say the same thing, and this
    raises."""
    scalars, tables = [], []
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if v is None:
            default = f.default_factory() if f.default_factory is not dataclasses.MISSING \
                else f.default
            if default is not None:
                raise ValueError(f"{prefix + f.name} = None has no TOML form (TOML has no "
                                 "null and the field's default is not None); save as JSON")
        elif dataclasses.is_dataclass(v):
            tables.append((f.name, v))
        else:
            scalars.append(f"{f.name} = {_toml_value(_to_dict(v))}")
    if prefix and (scalars or not tables):
        lines.append(f"[{prefix[:-1]}]")
    lines.extend(scalars)
    for name, v in tables:
        _toml_table(v, f"{prefix}{name}.", lines)


def save_config(path: str, cfg: RunConfig) -> None:
    """JSON, or TOML when ``path`` ends in .toml."""
    if path.endswith(".toml"):
        lines: list[str] = []
        _toml_table(cfg, "", lines)
        with open(path, "w") as f:
            f.write("\n".join(lines) + "\n")
        return
    with open(path, "w") as f:
        json.dump(config_to_dict(cfg), f, indent=2)
