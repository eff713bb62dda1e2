"""Structured logging: JSON-lines events and phase timers.

Counterpart of ``mgpgcr_tpu/utils/logging.py`` (the reference reports by
printf, GCR.h:213-216, MG.h:139-284): one JSON object per event, with the
JAX package's event names and keys, that a run archives beside its results.
"""

from __future__ import annotations

import json
import time
from typing import IO, Optional

import torch


class RunLogger:
    """Emit one JSON object per line: {"ts", "event", **fields}."""

    def __init__(self, stream: Optional[IO[str]] = None, path: Optional[str] = None):
        self._stream = stream
        self._file = open(path, "a") if path else None

    def log(self, event: str, **fields) -> None:
        rec = {"ts": round(time.time(), 3), "event": event, **fields}
        line = json.dumps(rec, default=_jsonable)
        if self._stream is not None:
            print(line, file=self._stream, flush=True)
        if self._file is not None:
            self._file.write(line + "\n")
            self._file.flush()

    def close(self) -> None:
        if self._file is not None:
            self._file.close()
            self._file = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _jsonable(o):
    try:
        return float(o)
    except Exception:
        return str(o)


def _tensors(x):
    """The tensors in ``x``: a tensor, a CF (anything with ``re`` and
    ``im``), or a list, tuple or dict of them."""
    if isinstance(x, torch.Tensor):
        yield x
    elif hasattr(x, "re") and hasattr(x, "im"):
        yield x.re
        yield x.im
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)


class Timer:
    """Phase timer; use as context manager, read ``.elapsed`` (seconds).

    Kernel launches return before the card has run them: pass the phase's
    outputs through ``block_on`` inside the block, so that the time is the
    card's as well as the host's."""

    def __init__(self, logger: Optional[RunLogger] = None, name: str = ""):
        self._logger = logger
        self._name = name
        self.elapsed = 0.0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed = time.perf_counter() - self._t0
        if self._logger is not None:
            self._logger.log("timer", name=self._name, seconds=round(self.elapsed, 6))

    @staticmethod
    def block_on(x):
        """Wait for the CUDA devices of the tensors in ``x``; return ``x``."""
        for dev in {t.device for t in _tensors(x) if t.device.type == "cuda"}:
            torch.cuda.synchronize(dev)
        return x
