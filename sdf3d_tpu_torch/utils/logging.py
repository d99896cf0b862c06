"""Structured metrics logging (JSONL + stdout), copied from
``sdf3d_tpu/utils/logging.py`` (standard library only).

Fits emit one JSON object per event: machine-parseable, append-only,
crash-safe.
"""

from __future__ import annotations

import json
import sys
import time
from typing import IO


class MetricsLogger:
    """Append JSON lines to a file and/or stdout.

    >>> log = MetricsLogger("metrics.jsonl")
    >>> log.log(step=0, loss=1.23)
    """

    def __init__(self, path: str | None = None, echo: bool = True, stream: IO | None = None):
        self._fh = open(path, "a") if path else None
        self._echo = echo
        self._stream = stream or sys.stdout

    def log(self, **fields) -> None:
        record = {"time": time.time(), **fields}
        line = json.dumps(record)
        if self._fh is not None:
            self._fh.write(line + "\n")
            self._fh.flush()
        if self._echo:
            print(line, file=self._stream)

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
