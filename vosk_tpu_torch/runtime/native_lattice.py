"""ctypes binding for the native lattice finishing library
(core/libvosk_tpu_core.so, built from core/src/lattice.cc with
`make -C core libvosk_tpu_core.so` or `build_library()`).

Copy of `vosk_tpu/runtime/native_lattice.py`: v4, v3 and CSR records, with
the padded layout's dense arc views or the CSR arc tables.  The port has
no Python lattice fallback: runtime/finishing.py raises when the library is
missing.  Records may be torch tensors on any device; the v4 adapter
(graph/lattice.py) converts the one channel it needs, and v3 and CSR
records are marshalled as they are, that channel pulled to the host.
"""
from __future__ import annotations

import ctypes as C
import fcntl
import os
import subprocess
import time
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

_LIB: Optional[C.CDLL] = None
_CORE = Path(__file__).resolve().parents[2] / "core"
LIBRARY = _CORE / "libvosk_tpu_core.so"
# how long build_library waits for a library that another builder is
# still writing
_LOAD_WAIT_SECONDS = 120.0


class VtWord(C.Structure):
    _fields_ = [
        ("word", C.c_int32),
        ("start_frame", C.c_int32),
        ("end_frame", C.c_int32),
        ("conf", C.c_float),
    ]


class VtRecords(C.Structure):
    _fields_ = [
        ("T", C.c_int32),
        ("L", C.c_int32),
        ("K", C.c_int32),
        ("R", C.c_int32),
        ("f_state", C.POINTER(C.c_int32)),
        ("f_cost", C.POINTER(C.c_float)),
        ("pdf", C.POINTER(C.c_int32)),
        ("lat_ns", C.POINTER(C.c_int32)),
        ("lat_prev", C.POINTER(C.c_int32)),
        ("lat_arc", C.POINTER(C.c_int32)),
        ("lat_cost", C.POINTER(C.c_float)),
        ("num_states", C.c_int32),
        ("M", C.c_int32),
        ("dense_w", C.POINTER(C.c_float)),
        ("dense_olabel", C.POINTER(C.c_int32)),
        ("dense_pdf", C.POINTER(C.c_int32)),
        ("em_w", C.POINTER(C.c_float)),
        ("em_olabel", C.POINTER(C.c_int32)),
        ("em_pdf", C.POINTER(C.c_int32)),
        ("eps_w", C.POINTER(C.c_float)),
        ("eps_olabel", C.POINTER(C.c_int32)),
        ("final_cost", C.POINTER(C.c_float)),
        ("init_state", C.POINTER(C.c_int32)),
        ("init_cost", C.POINTER(C.c_float)),
        ("init_prefix_off", C.POINTER(C.c_int32)),
        ("init_prefix_data", C.POINTER(C.c_int32)),
        ("lattice_beam", C.c_float),
        ("graph_scale", C.c_float),
        ("use_final", C.c_int32),
        ("silence_pdfs", C.POINTER(C.c_int32)),
        ("num_silence_pdfs", C.c_int32),
    ]


def _load() -> Optional[C.CDLL]:
    """Load the native library. Only a successful load is cached: the
    library may be built after first import (tests build it on demand), so
    a missing file is re-probed on the next call."""
    global _LIB
    if _LIB is not None:
        return _LIB
    for cand in (LIBRARY, Path(__file__).parent / "libvosk_tpu_core.so"):
        if cand.exists():
            try:
                lib = C.CDLL(str(cand))
                lib.vt_lattice_build.restype = C.c_void_p
                lib.vt_lattice_build.argtypes = [C.POINTER(VtRecords)]
                lib.vt_lattice_free.argtypes = [C.c_void_p]
                lib.vt_lattice_nbest.restype = C.c_int32
                lib.vt_lattice_nbest.argtypes = [
                    C.c_void_p,
                    C.c_int32,
                    C.c_int32,
                    C.POINTER(VtWord),
                    C.c_int32,
                    C.POINTER(C.c_int32),
                    C.POINTER(C.c_float),
                    C.c_int32,
                ]
                lib.vt_lattice_mbr.restype = C.c_int32
                lib.vt_lattice_mbr.argtypes = [
                    C.c_void_p,
                    C.POINTER(VtWord),
                    C.c_int32,
                    C.POINTER(C.c_float),
                ]
                _LIB = lib
                break
            except (OSError, AttributeError):
                # AttributeError: a stale build without one of the symbols
                # above; skip it instead of failing every result later
                continue
    return _LIB


def available() -> bool:
    return _load() is not None


def build_library() -> Path:
    """Make sure core/libvosk_tpu_core.so exists and loads, compiling it if
    absent.  Concurrent callers serialise on an fcntl lock on
    core/.libvosk_tpu_core.lock; the library is compiled as core/Makefile
    does into a temporary name in core/ and moved into place with
    os.replace, so no loader sees a half-written file.  A `make` writing
    the same file without the lock is waited out: loading is retried for
    up to _LOAD_WAIT_SECONDS."""
    if available():
        return LIBRARY
    with open(_CORE / ".libvosk_tpu_core.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if not LIBRARY.exists():
                tmp = _CORE / f".libvosk_tpu_core.{os.getpid()}.tmp.so"
                cmd = [os.environ.get("CXX", "g++"), "-O3", "-g", "-fPIC",
                       "-std=c++17", "-Wall", "-Iinclude", "-shared",
                       "-o", tmp.name, "src/lattice.cc"]
                try:
                    proc = subprocess.run(cmd, cwd=_CORE, capture_output=True,
                                          text=True)
                    if proc.returncode != 0:
                        raise RuntimeError(
                            f"building {LIBRARY.name} failed (exit "
                            f"{proc.returncode}):\n{proc.stdout}{proc.stderr}")
                    os.replace(tmp, LIBRARY)
                finally:
                    if tmp.exists():
                        tmp.unlink()
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    deadline = time.monotonic() + _LOAD_WAIT_SECONDS
    while not available():
        if time.monotonic() > deadline:
            raise RuntimeError(f"{LIBRARY} exists but does not load")
        time.sleep(0.2)
    return LIBRARY


def _ptr(arr, ctype):
    return arr.ctypes.data_as(C.POINTER(ctype))


def nbest_native(
    records: List[dict],
    frontier,
    channel: int,
    dec,
    silence_pdfs,
    n: int,
    lattice_beam: float,
    graph_scale: float = 0.9,
    use_final: bool = True,
    distinct: bool = True,
    init_override=None,
) -> Optional[List[Tuple[float, List[Tuple[int, int, int, float]]]]]:
    """Native n-best: returns [(cost, [(wid, f0, f1, conf)])] or None when
    the library is unavailable.  init_override: optional (states, costs)
    anchoring the lattice at a fold boundary (see graph.lattice)."""
    lib = _load()
    if lib is None or not records:
        return None
    built = _marshal_and_build(
        records, frontier, channel, dec, silence_pdfs, lattice_beam,
        graph_scale, use_final, init_override,
    )
    if built is None:
        return None
    lat, holders = built
    try:
        max_paths = max(4 * n + 8, 8)
        cap = max_paths * 256
        words = (VtWord * cap)()
        sizes = (C.c_int32 * max_paths)()
        costs = (C.c_float * max_paths)()
        got = lib.vt_lattice_nbest(
            lat, n if not distinct else max_paths, 1 if distinct else 0,
            words, cap, sizes, costs, max_paths
        )
        out = []
        wi = 0
        for i in range(got):
            items = []
            for j in range(sizes[i]):
                w = words[wi]
                items.append((w.word, w.start_frame, w.end_frame, float(w.conf)))
                wi += 1
            out.append((float(costs[i]), items))
            if len(out) >= n:
                break
        return out
    finally:
        lib.vt_lattice_free(lat)


def mbr_native(
    records: List[dict],
    frontier,
    channel: int,
    dec,
    silence_pdfs,
    lattice_beam: float,
    graph_scale: float = 0.9,
    use_final: bool = True,
    init_override=None,
) -> Optional[Tuple[float, List[Tuple[int, int, int, float]]]]:
    """Native MBR sausage decode (vt_lattice_mbr): (cost, [(wid, f0, f1,
    conf)]) with sausage-expected frame spans, or None when the library is
    unavailable.  Python oracle: vosk_tpu/graph/mbr.py (parity-tested in
    tests/test_native_core.py)."""
    lib = _load()
    if lib is None or not records:
        return None
    built = _marshal_and_build(
        records, frontier, channel, dec, silence_pdfs, lattice_beam,
        graph_scale, use_final, init_override,
    )
    if built is None:
        return None
    lat, holders = built
    try:
        cap = 4096
        words = (VtWord * cap)()
        cost = C.c_float(0.0)
        got = lib.vt_lattice_mbr(lat, words, cap, C.byref(cost))
        if got < 0:
            return None
        items = [
            (words[i].word, words[i].start_frame, words[i].end_frame,
             float(words[i].conf))
            for i in range(got)
        ]
        return float(cost.value), items
    finally:
        lib.vt_lattice_free(lat)


def _marshal_and_build(
    records, frontier, channel, dec, silence_pdfs, lattice_beam,
    graph_scale, use_final, init_override,
):
    """Marshal decoder records + graph views into VtRecords and build the
    pruned native lattice; returns (lat, holders) or None."""
    lib = _load()
    if lib is None:
        return None
    from ..graph.lattice import convert_v4_records, to_host

    if "pm" in records[0]:
        records = convert_v4_records(
            dec, records, channel,
            init_states=None if init_override is None else init_override[0],
        )
        channel = 0

    dtypes = {
        "f_state": np.int32,
        "f_cost": np.float32,
        "pdf": np.int32,
        "lat_ns": np.int32,
        "lat_prev": np.int32,
        "lat_arc": np.int32,
        "lat_cost": np.float32,
    }
    cat = {
        k: np.ascontiguousarray(
            np.concatenate([to_host(r[k][channel]) for r in records], axis=0),
            dtype=dt,
        )
        for k, dt in dtypes.items()
    }
    T, L, K = cat["f_state"].shape
    R = cat["lat_ns"].shape[2]

    g = dec.graph
    rec = VtRecords()
    rec.T, rec.L, rec.K, rec.R = T, L, K, R
    rec.f_state = _ptr(cat["f_state"], C.c_int32)
    rec.f_cost = _ptr(cat["f_cost"], C.c_float)
    rec.pdf = _ptr(cat["pdf"], C.c_int32)
    rec.lat_ns = _ptr(cat["lat_ns"], C.c_int32)
    rec.lat_prev = _ptr(cat["lat_prev"], C.c_int32)
    rec.lat_arc = _ptr(cat["lat_arc"], C.c_int32)
    rec.lat_cost = _ptr(cat["lat_cost"], C.c_float)
    rec.num_states = dec.S
    holders = [cat]  # keep arrays alive for the duration of the call
    if dec.layout == "padded":
        if (dec.S + 1) * dec.M > 2**31:
            raise ValueError(
                f"core/src/lattice.cc indexes the dense arc views with int32 ids "
                f"(state * M + m); S={dec.S}, M={dec.M} overflow them")
        rec.M = dec.M
        # views of the decoder's tables where they are already so typed
        dw = np.ascontiguousarray(dec.dense_w, dtype=np.float32)
        do = np.ascontiguousarray(dec.dense_olabel, dtype=np.int32)
        dp = np.ascontiguousarray(dec.dense_pdf, dtype=np.int32)
        holders += [dw, do, dp]
        rec.dense_w = _ptr(dw, C.c_float)
        rec.dense_olabel = _ptr(do, C.c_int32)
        rec.dense_pdf = _ptr(dp, C.c_int32)
    else:
        rec.M = 0
        ew = np.ascontiguousarray(np.asarray(g.em_w, np.float32))
        eo = np.ascontiguousarray(np.asarray(g.em_olabel, np.int32))
        ep = np.ascontiguousarray(np.asarray(g.em_pdf, np.int32))
        holders += [ew, eo, ep]
        rec.em_w = _ptr(ew, C.c_float)
        rec.em_olabel = _ptr(eo, C.c_int32)
        rec.em_pdf = _ptr(ep, C.c_int32)
    if g.num_eps_arcs:
        xw = np.ascontiguousarray(np.asarray(g.eps_w, np.float32))
        xo = np.ascontiguousarray(np.asarray(g.eps_olabel, np.int32))
    else:
        xw = np.zeros(1, np.float32)
        xo = np.zeros(1, np.int32)
    holders += [xw, xo]
    rec.eps_w = _ptr(xw, C.c_float)
    rec.eps_olabel = _ptr(xo, C.c_int32)
    fc = np.ascontiguousarray(np.asarray(dec.final_cost, np.float32))
    holders.append(fc)
    rec.final_cost = _ptr(fc, C.c_float)
    if init_override is not None:
        i_states, i_costs = init_override
        i_prefixes = [[] for _ in range(len(i_states))]
    else:
        i_states, i_costs = dec._init_states, dec._init_costs
        i_prefixes = dec._init_prefixes
    ist = np.ascontiguousarray(np.asarray(i_states).astype(np.int32))
    ico = np.ascontiguousarray(np.asarray(i_costs).astype(np.float32))
    holders += [ist, ico]
    rec.init_state = _ptr(ist, C.c_int32)
    rec.init_cost = _ptr(ico, C.c_float)
    poff = np.zeros(len(i_prefixes) + 1, np.int32)
    pdata_list = []
    for i, pref in enumerate(i_prefixes):
        pdata_list.extend(pref)
        poff[i + 1] = len(pdata_list)
    pdata = np.ascontiguousarray(np.asarray(pdata_list or [0], np.int32))
    holders += [poff, pdata]
    rec.init_prefix_off = _ptr(poff, C.c_int32)
    rec.init_prefix_data = _ptr(pdata, C.c_int32)
    rec.lattice_beam = lattice_beam
    rec.graph_scale = graph_scale
    rec.use_final = 1 if use_final else 0
    sil = np.ascontiguousarray(np.asarray(silence_pdfs, np.int32))
    holders.append(sil)
    rec.silence_pdfs = _ptr(sil, C.c_int32)
    rec.num_silence_pdfs = len(sil)

    lat = lib.vt_lattice_build(C.byref(rec))
    if not lat:
        return None
    return lat, holders
