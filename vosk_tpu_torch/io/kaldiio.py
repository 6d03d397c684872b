"""Kaldi binary/text format I/O primitives — reader side for consuming
reference model directories (final.mdl, ivector extractors, CMVN stats,
CARPA, FSTs at src/model.cc:209-341) without linking Kaldi, plus a writer
used by round-trip tests and model-conversion tooling.

Format notes (Kaldi base/io-funcs + matrix/kaldi-matrix):
  - binary files start with "\\0B"
  - Token: ASCII string terminated by a single space
  - BasicType<T>: one byte sizeof(T), then raw little-endian value
  - IntegerVector<T>: one byte sizeof(T), int32 count, then count raw values
  - Vector<float>: token "FV" + BasicType<int32> dim + raw floats ("DV" doubles)
  - Matrix<float>: token "FM" + int32 rows + int32 cols + row-major floats
  - text mode: tokens/numbers separated by whitespace, vectors as "[ ... ]"

Copy of `vosk_tpu/io/kaldiio.py` (numpy only), kept in the port because
nothing under `vosk_tpu` imports without jax; tests/test_torch_copies.py
holds it to its source.
"""
from __future__ import annotations

import io
import struct
from pathlib import Path
from typing import BinaryIO, List, Optional

import numpy as np


class KaldiReadError(Exception):
    pass


# ---------------------------------------------------------------- binary IO


class BinaryReader:
    def __init__(self, stream: BinaryIO):
        self.s = stream

    def read_bytes(self, n: int) -> bytes:
        b = self.s.read(n)
        if len(b) != n:
            raise KaldiReadError(f"unexpected EOF (wanted {n} bytes)")
        return b

    def peek_byte(self) -> int:
        b = self.s.peek(1)[:1] if hasattr(self.s, "peek") else b""
        if not b:
            pos = self.s.tell()
            b = self.s.read(1)
            self.s.seek(pos)
        return b[0] if b else -1

    def read_token(self) -> str:
        out = bytearray()
        while True:
            c = self.s.read(1)
            if not c:
                if out:
                    break
                raise KaldiReadError("EOF reading token")
            if c == b" ":
                if out:
                    break
                continue
            out += c
        return out.decode("utf-8")

    def expect_token(self, tok: str) -> None:
        got = self.read_token()
        if got != tok:
            raise KaldiReadError(f"expected token {tok!r}, got {got!r}")

    def read_basic_int(self) -> int:
        size = self.read_bytes(1)[0]
        if size == 4:
            return struct.unpack("<i", self.read_bytes(4))[0]
        if size == 8:
            return struct.unpack("<q", self.read_bytes(8))[0]
        if size == 2:
            return struct.unpack("<h", self.read_bytes(2))[0]
        if size == 1:
            return struct.unpack("<b", self.read_bytes(1))[0]
        raise KaldiReadError(f"bad int size byte {size}")

    def read_basic_float(self) -> float:
        size = self.read_bytes(1)[0]
        if size == 4:
            return struct.unpack("<f", self.read_bytes(4))[0]
        if size == 8:
            return struct.unpack("<d", self.read_bytes(8))[0]
        raise KaldiReadError(f"bad float size byte {size}")

    def read_bool(self) -> bool:
        c = self.read_bytes(1)
        if c == b"T":
            return True
        if c == b"F":
            return False
        raise KaldiReadError(f"bad bool byte {c!r}")

    def read_int_vector(self) -> List[int]:
        size = self.read_bytes(1)[0]
        n = struct.unpack("<i", self.read_bytes(4))[0]
        if size == 4:
            return list(np.frombuffer(self.read_bytes(4 * n), dtype="<i4"))
        raise KaldiReadError(f"bad int vector elem size {size}")

    def read_vector(self) -> np.ndarray:
        tok = self.read_token()
        if tok == "FV":
            n = self.read_basic_int()
            return np.frombuffer(self.read_bytes(4 * n), dtype="<f4").copy()
        if tok == "DV":
            n = self.read_basic_int()
            return np.frombuffer(self.read_bytes(8 * n), dtype="<f8").astype(np.float32)
        raise KaldiReadError(f"expected vector header, got {tok!r}")

    def read_matrix(self) -> np.ndarray:
        tok = self.read_token()
        if tok == "FM":
            r = self.read_basic_int()
            c = self.read_basic_int()
            return np.frombuffer(self.read_bytes(4 * r * c), dtype="<f4").reshape(r, c).copy()
        if tok == "DM":
            r = self.read_basic_int()
            c = self.read_basic_int()
            return (
                np.frombuffer(self.read_bytes(8 * r * c), dtype="<f8")
                .reshape(r, c)
                .astype(np.float32)
            )
        if tok == "CM":
            return self._read_compressed_matrix(1)
        if tok in ("CM2", "CM3"):
            return self._read_compressed_matrix(int(tok[2]))
        raise KaldiReadError(f"expected matrix header, got {tok!r}")

    def _read_compressed_matrix(self, fmt: int) -> np.ndarray:
        """Kaldi CompressedMatrix (matrix/compressed-matrix.cc).

        Header: min_value f32, range f32, num_rows i32, num_cols i32 (raw,
        not size-prefixed).  Format 1: per-column percentiles (p0,p25,p75,
        p100 as uint16) + uint8 data.  Format 2: uint16 data.  Format 3:
        uint8 data scaled by min/range.
        """
        minv, rng_ = struct.unpack("<ff", self.read_bytes(8))
        rows, cols = struct.unpack("<ii", self.read_bytes(8))
        if fmt == 2:
            data = np.frombuffer(self.read_bytes(2 * rows * cols), dtype="<u2")
            return (minv + data.reshape(rows, cols) * (rng_ / 65535.0)).astype(np.float32)
        if fmt == 3:
            data = np.frombuffer(self.read_bytes(rows * cols), dtype=np.uint8)
            return (minv + data.reshape(rows, cols) * (rng_ / 255.0)).astype(np.float32)
        # format 1: per-column 4x uint16 percentile headers then uint8 rows
        heads = np.frombuffer(self.read_bytes(8 * cols), dtype="<u2").reshape(cols, 4)

        def u16_to_f(u):
            return minv + u.astype(np.float64) * (rng_ / 65535.0)

        p0, p25, p75, p100 = (u16_to_f(heads[:, i]) for i in range(4))
        data = np.frombuffer(self.read_bytes(rows * cols), dtype=np.uint8)
        data = data.reshape(cols, rows).astype(np.float64)  # column-major blocks
        out = np.zeros((cols, rows))
        lo = data <= 64
        mid = (data > 64) & (data <= 192)
        hi = data > 192
        for j in range(cols):
            d = data[j]
            out[j][lo[j]] = p0[j] + (p25[j] - p0[j]) * (d[lo[j]] / 64.0)
            out[j][mid[j]] = p25[j] + (p75[j] - p25[j]) * ((d[mid[j]] - 64) / 128.0)
            out[j][hi[j]] = p75[j] + (p100[j] - p75[j]) * ((d[hi[j]] - 192) / 63.0)
        return out.T.astype(np.float32)


class BinaryWriter:
    def __init__(self, stream: BinaryIO):
        self.s = stream

    def write_token(self, tok: str) -> None:
        self.s.write(tok.encode("utf-8") + b" ")

    def write_basic_int(self, v: int) -> None:
        self.s.write(bytes([4]) + struct.pack("<i", v))

    def write_basic_float(self, v: float) -> None:
        self.s.write(bytes([4]) + struct.pack("<f", v))

    def write_bool(self, v: bool) -> None:
        self.s.write(b"T" if v else b"F")

    def write_int_vector(self, v) -> None:
        self.s.write(bytes([4]) + struct.pack("<i", len(v)))
        self.s.write(np.asarray(v, dtype="<i4").tobytes())

    def write_vector(self, v: np.ndarray) -> None:
        self.write_token("FV")
        self.write_basic_int(len(v))
        self.s.write(np.asarray(v, dtype="<f4").tobytes())

    def write_matrix(self, m: np.ndarray) -> None:
        self.write_token("FM")
        self.write_basic_int(m.shape[0])
        self.write_basic_int(m.shape[1])
        self.s.write(np.asarray(m, dtype="<f4").tobytes())

    def write_compressed_matrix(self, m: np.ndarray, fmt: int = 0) -> None:
        """Kaldi CompressedMatrix writer (matrix/compressed-matrix.cc
        CompressedMatrix::CopyFromMat semantics; consumed by the reference
        via CMVN stats and compressed model matrices, model.cc:265-276).

        fmt: 1 = one-byte with per-column percentile headers ("CM"),
        2 = two-byte ("CM2"), 3 = one-byte scalar ("CM3"); 0 = automatic
        (Kaldi picks format 1 when num_rows > 8, else format 2).
        """
        m = np.asarray(m, np.float32)
        rows, cols = m.shape
        if fmt == 0:
            fmt = 1 if rows > 8 else 2
        minv = float(m.min()) if m.size else 0.0
        rng_ = (float(m.max()) - minv) if m.size else 1.0
        if rng_ <= 0.0:
            rng_ = 1.0e-5  # Kaldi guard for constant matrices
        self.write_token({1: "CM", 2: "CM2", 3: "CM3"}[fmt])
        self.s.write(struct.pack("<ffii", minv, rng_, rows, cols))

        def to_u16(v):
            f = np.clip((v - minv) / rng_, 0.0, 1.0)
            return np.minimum((f * 65535.0 + 0.499).astype(np.int64), 65535)

        if fmt == 2:
            self.s.write(to_u16(m).astype("<u2").tobytes())
            return
        if fmt == 3:
            f = np.clip((m - minv) / rng_, 0.0, 1.0)
            self.s.write(
                np.minimum((f * 255.0 + 0.499).astype(np.int64), 255)
                .astype(np.uint8).tobytes()
            )
            return
        # format 1: per-column percentile headers (uint16 x4), then uint8
        # data stored column-major.  Header ordering is strict (Kaldi
        # enforces p0 <= 65532, p25 in [p0+1, 65533], p75 in [p25+1, 65534],
        # p100 >= p75+1 so the interpolation denominators never vanish).
        q = max(rows // 4, 1)
        heads = np.zeros((cols, 4), np.uint16)
        data = np.zeros((cols, rows), np.uint8)
        for j in range(cols):
            col = np.sort(m[:, j])
            u = to_u16(
                np.array([col[0], col[min(q, rows - 1)],
                          col[min(3 * q, rows - 1)], col[rows - 1]])
            )
            p0 = min(int(u[0]), 65532)
            p25 = min(max(int(u[1]), p0 + 1), 65533)
            p75 = min(max(int(u[2]), p25 + 1), 65534)
            p100 = max(int(u[3]), p75 + 1)
            heads[j] = (p0, p25, p75, p100)
            f0, f25, f75, f100 = (
                minv + p * (rng_ / 65535.0) for p in (p0, p25, p75, p100)
            )
            c = m[:, j].astype(np.float64)
            lo = np.clip((c - f0) / (f25 - f0), 0.0, 1.0) * 64.0
            mid = 64.0 + np.clip((c - f25) / (f75 - f25), 0.0, 1.0) * 128.0
            hi = 192.0 + np.clip((c - f75) / (f100 - f75), 0.0, 1.0) * 63.0
            enc = np.where(c < f25, lo, np.where(c < f75, mid, hi))
            data[j] = np.minimum((enc + 0.499).astype(np.int64), 255).astype(
                np.uint8
            )
        self.s.write(heads.astype("<u2").tobytes())
        self.s.write(data.tobytes())


def open_kaldi(path) -> tuple[BinaryReader, bool]:
    """Open a Kaldi file; returns (reader, is_binary).  Text-mode files are
    handled by the text readers below."""
    f = open(path, "rb")
    head = f.read(2)
    if head == b"\x00B":
        return BinaryReader(f), True
    f.seek(0)
    return BinaryReader(f), False


def write_kaldi_object(path, write_fn) -> None:
    with open(path, "wb") as f:
        f.write(b"\x00B")
        write_fn(BinaryWriter(f))


def read_kaldi_matrix(path) -> np.ndarray:
    r, binary = open_kaldi(path)
    if binary:
        return r.read_matrix()
    return _read_text_matrix(r.s)


def read_kaldi_vector(path) -> np.ndarray:
    r, binary = open_kaldi(path)
    if binary:
        return r.read_vector()
    m = _read_text_matrix(r.s, vector=True)
    return m.reshape(-1)


def _read_text_matrix(stream, vector: bool = False) -> np.ndarray:
    text = stream.read().decode("utf-8")
    text = text.replace("[", " ").replace("]", " ")
    rows = [
        [float(x) for x in line.split()]
        for line in text.splitlines()
        if line.strip()
    ]
    rows = [row for row in rows if row]
    if vector:
        return np.asarray([x for row in rows for x in row], np.float32)
    return np.asarray(rows, np.float32)
