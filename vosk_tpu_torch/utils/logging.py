"""Log handling, mirroring the reference's pluggable handler semantics.

Copy of `vosk_tpu/utils/logging.py` (numpy only), kept in the port because
nothing under `vosk_tpu` imports without jax; tests/test_torch_copies.py
holds it to its source.

Reference: vosk_api.h:287-294 (vosk_set_log_level), model.cc:69-104 (severity
mapped handler). Level semantics: 0 = info+error, <0 = errors only, >0 = more
verbose debug output.
"""
from __future__ import annotations

import sys
import threading

_lock = threading.Lock()
_log_level = 0


def set_log_level(level: int) -> None:
    global _log_level
    with _lock:
        _log_level = int(level)


def get_log_level() -> int:
    return _log_level


def _emit(severity: str, msg: str) -> None:
    sys.stderr.write(f"{severity} [vosk_tpu] {msg}\n")


def log_error(msg: str) -> None:
    _emit("ERROR", msg)


def log_warn(msg: str) -> None:
    if _log_level >= 0:
        _emit("WARNING", msg)


def log_info(msg: str) -> None:
    if _log_level >= 0:
        _emit("LOG", msg)


def log_debug(msg: str, verbosity: int = 1) -> None:
    if _log_level >= verbosity:
        _emit("VLOG", msg)
