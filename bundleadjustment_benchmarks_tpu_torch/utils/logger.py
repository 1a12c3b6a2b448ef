"""File logger with levels and timestamps (reference Logger.{h,cpp}).

Writes ``[HH:MM:SS] Level: message`` lines to a file through Python's
``logging``, with the reference's singleton access (``create_logger``,
``instance``) and numpy matrix dumps for offline comparison.
"""

from __future__ import annotations

import logging
import threading
from typing import Optional

import numpy as np

INFO = "Info"
WARNING = "Warning"
ERROR = "Error"
DEBUG = "Debug"

_LEVELS = {INFO: logging.INFO, WARNING: logging.WARNING, ERROR: logging.ERROR,
           DEBUG: logging.DEBUG}

_instance: Optional["Logger"] = None
_lock = threading.Lock()


class Logger:
    """Timestamped file logger (reference Logger.h:12-19, Logger.cpp:15-33)."""

    def __init__(self, filename: str = "output.log"):
        self.filename = filename
        self._logger = logging.getLogger(f"batorch.{filename}")
        self._logger.setLevel(logging.DEBUG)
        self._logger.propagate = False
        self.close()
        handler = logging.FileHandler(filename)
        handler.setFormatter(logging.Formatter("[%(asctime)s] %(message)s",
                                               "%H:%M:%S"))
        self._logger.addHandler(handler)

    def log(self, level: str, message: str) -> None:
        self._logger.log(_LEVELS.get(level, logging.INFO), f"{level}: {message}")

    def close(self) -> None:
        """Close the file; a later ``log`` writes nothing."""
        for h in list(self._logger.handlers):
            self._logger.removeHandler(h)
            h.close()

    # Matrix dumps (reference Logger.h:46-94).
    def log_matrix(self, name: str, mat) -> None:
        arr = np.asarray(mat)
        self.log(DEBUG, f"Matrix {name} ({arr.shape}):\n{np.array2string(arr)}")

    def log_matrix_csv(self, path: str, mat) -> None:
        np.savetxt(path, np.asarray(mat), delimiter=",")

    def log_sparse_matrix(self, name: str, rows, cols, vals) -> None:
        lines = "\n".join(f"{int(r)} {int(c)} {v:.17g}"
                          for r, c, v in zip(rows, cols, vals))
        self.log(DEBUG, f"SparseMatrix {name} (triplets):\n{lines}")


def create_logger(filename: str = "output.log") -> Logger:
    """Create or replace the singleton (reference Logger.cpp:35-39); the
    replaced logger's file is closed."""
    global _instance
    with _lock:
        if _instance is not None:
            _instance.close()
        _instance = Logger(filename)
    return _instance


def instance() -> Logger:
    """The singleton, on ``output.log`` if none was created (Logger.cpp:42-47)."""
    global _instance
    with _lock:
        if _instance is None:
            _instance = Logger("output.log")
        return _instance
