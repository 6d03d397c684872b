"""The port's kernel library: every csrc/*.cu in one shared object.

At first use every `csrc/*.cu` is compiled by its own nvcc process, all
started together, and linked into one
`vosk_tpu_torch/_build/libvt_kernels-<hash>.so` with a plain C interface,
loaded with ctypes; the hash covers every source, every shared header
(`csrc/*.cuh`) and the flags, so a fresh checkout builds it on its own.
ptxas's report (registers, shared memory, spills per kernel) is kept
beside the library (`build_log()`).  The wrappers (ops/gather.py,
ops/frame_step.py) take their entry points from `function`.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
_CSRC = _PKG / "csrc"
_BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lib = None
_fns: dict = {}
_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin): the kernels are built from "
        "vosk_tpu_torch/csrc/ at first use on a CUDA tensor"
    )


def sources() -> list[Path]:
    """The translation units, one nvcc each."""
    return sorted(_CSRC.glob("*.cu"))


def headers() -> list[Path]:
    """The headers they share (csrc/*.cuh)."""
    return sorted(_CSRC.glob("*.cuh"))


def library_path() -> Path:
    """Where the built kernel library lives, keyed by sources, headers and
    flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources() + headers():
        h.update(src.name.encode() + b"\0" + src.read_bytes())
    return _BUILD_DIR / f"libvt_kernels-{h.hexdigest()[:16]}.so"


def build_log() -> str:
    """ptxas's report from the build of the current library ("" if none)."""
    log = library_path().with_suffix(".log")
    return log.read_text() if log.exists() else ""


def build() -> Path:
    """Compile every csrc/*.cu (one nvcc per source, in parallel) and link
    them into one library, unless a build of these exact sources exists.
    Raises with nvcc's output when a step fails."""
    out = library_path()
    if out.exists():
        return out
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=_BUILD_DIR) as tmp:
        objs = [Path(tmp) / f"{src.stem}.o" for src in sources()]
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(src)],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for src, o in zip(sources(), objs)]
        logs = [(src, p.communicate()[0], p.returncode) for src, p in zip(sources(), procs)]
        for src, text, rc in logs:
            if rc != 0:
                raise RuntimeError(f"nvcc failed on {src} (exit {rc}):\n{text}")
        so = Path(tmp) / "lib.so"
        proc = subprocess.run([nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(so),
                               *map(str, objs)], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed (exit {proc.returncode}):\n"
                               f"{proc.stdout}{proc.stderr}")
        log = Path(tmp) / "lib.log"
        log.write_text("".join(f"== {src.name}\n{text}" for src, text, _ in logs))
        os.replace(log, out.with_suffix(".log"))
        os.replace(so, out)  # atomic: a concurrent build never sees a partial file
    return out


def function(name: str, argtypes: list):
    """The C entry point `name` of the library (built on first call), typed
    with `argtypes`; every entry point returns a cudaError_t as int."""
    global _lib
    with _lock:
        if name not in _fns:
            if _lib is None:
                _lib = ctypes.CDLL(str(build()))
            fn = getattr(_lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _fns[name] = fn
        return _fns[name]
