"""Kaldi-style option parsing.

Copy of `vosk_tpu/utils/config.py` (no jax), kept in the port because
nothing under `vosk_tpu` imports without jax; tests/test_torch_copies.py
holds it to its source.

The reference registers typed options and reads them either from hardcoded
argv-style defaults (model.cc:132-158) or from ``conf/model.conf`` /
``mfcc.conf`` files (model.cc:180-186, 218-228).  Config files contain one
``--key=value`` (or ``key=value``) per line; ``#`` starts a comment.

We reproduce that: an ``OptionRegistry`` holds typed defaults; ``read_config``
parses a file into it.  Dataclass-based option groups register themselves with
a prefix (e.g. ``endpoint.rule2.min-trailing-silence``).
"""
from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Any, Dict


def _parse_value(current: Any, raw: str) -> Any:
    if isinstance(current, bool):
        return raw.strip().lower() in ("true", "1", "yes")
    if isinstance(current, int):
        return int(raw)
    if isinstance(current, float):
        return float(raw)
    return raw


def parse_config_lines(text: str) -> Dict[str, str]:
    """Parse ``--key=value`` lines into a dict (keys without leading dashes)."""
    out: Dict[str, str] = {}
    for line in text.splitlines():
        line = line.split("#", 1)[0].strip()
        if not line:
            continue
        if line.startswith("--"):
            line = line[2:]
        if "=" in line:
            key, val = line.split("=", 1)
        else:
            # bare flag means boolean true
            key, val = line, "true"
        out[key.strip()] = val.strip()
    return out


def read_config_file(path: str | Path) -> Dict[str, str]:
    return parse_config_lines(Path(path).read_text())


def apply_options(obj: Any, opts: Dict[str, str], prefix: str = "") -> None:
    """Apply string options to a dataclass instance.

    Field names use underscores; option keys use dashes.  ``prefix`` narrows to
    options like ``endpoint.xxx`` when the same file configures several groups
    (conf/model.conf style).
    """
    for f in dataclasses.fields(obj):
        key = (prefix + f.name).replace("_", "-")
        if key in opts:
            cur = getattr(obj, f.name)
            setattr(obj, f.name, _parse_value(cur, opts[key]))
