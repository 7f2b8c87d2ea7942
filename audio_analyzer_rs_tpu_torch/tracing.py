"""Tracing / logging — the reference's tracing-subscriber equivalent.

The reference initializes dual fmt layers (file `output.log` + stderr, with
thread names and levels) in debug builds (ref src/main.rs:2-27) and logs at
decision points throughout (onset decisions, synth voice transitions, slot
underflows, calibration residuals).  This module configures the same
dual-sink layout on Python logging and provides the shared logger handles.
"""

from __future__ import annotations

import logging
import sys
from typing import Optional

_FORMAT = ("%(asctime)s %(levelname)5s %(threadName)s "
           "%(name)s: %(message)s")

_initialized = False


def init_tracing(log_file: Optional[str] = "output.log",
                 stderr_level: int = logging.INFO,
                 file_level: int = logging.DEBUG) -> logging.Logger:
    """Install the dual file+stderr layers (ref main.rs:6-27).  Idempotent."""
    global _initialized
    root = logging.getLogger("audio_analyzer_rs_tpu")
    if _initialized:
        return root
    root.setLevel(logging.DEBUG)
    fmt = logging.Formatter(_FORMAT)
    stderr_handler = logging.StreamHandler(sys.stderr)
    stderr_handler.setLevel(stderr_level)
    stderr_handler.setFormatter(fmt)
    root.addHandler(stderr_handler)
    if log_file:
        file_handler = logging.FileHandler(log_file)
        file_handler.setLevel(file_level)
        file_handler.setFormatter(fmt)
        root.addHandler(file_handler)
    root.propagate = False
    _initialized = True
    return root


def get_logger(name: str) -> logging.Logger:
    """Module logger under the framework root (works without init too)."""
    return logging.getLogger(f"audio_analyzer_rs_tpu.{name}")
