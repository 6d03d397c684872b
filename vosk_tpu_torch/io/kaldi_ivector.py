"""Kaldi i-vector extractor directory I/O (the reference's `ivector/` dir).

The reference configures an `OnlineIvectorExtractionInfo` from six files
(src/model.cc:247-263): splice.conf, online_cmvn.conf, final.mat (LDA),
global_cmvn.stats, final.dubm (diagonal UBM) and final.ie (the i-vector
extractor), with max_count=100.  This module reads (and, for test
fixtures, writes) those formats without linking Kaldi:

  * DiagGmm:          <DiagGMM> <GCONSTS> v <WEIGHTS> v
                      <MEANS_INVVARS> m <INV_VARS> m </DiagGMM>
  * IvectorExtractor: <IvectorExtractor> <w> m <w_vec> v <M> n m...
                      <SigmaInv> sp... <IvectorOffset> d </IvectorExtractor>
    (SpMatrix = packed lower triangle, token FP/DP)

Copy of `vosk_tpu/io/kaldi_ivector.py` (numpy only), kept in the port
because nothing under `vosk_tpu` imports without jax;
tests/test_torch_copies.py holds it to its source.
"""
from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Optional

import numpy as np

from .kaldiio import (
    BinaryReader,
    BinaryWriter,
    KaldiReadError,
    open_kaldi,
    read_kaldi_matrix,
)


def _read_sp_matrix(r: BinaryReader) -> np.ndarray:
    """Kaldi SpMatrix (symmetric packed, lower triangle row-major)."""
    tok = r.read_token()
    if tok not in ("FP", "DP"):
        raise KaldiReadError(f"expected packed-matrix token, got {tok!r}")
    dim = r.read_basic_int()
    n = dim * (dim + 1) // 2
    dt = np.float32 if tok == "FP" else np.float64
    data = np.frombuffer(r.read_bytes(n * dt().itemsize), dtype=dt)
    out = np.zeros((dim, dim), np.float64)
    k = 0
    for i in range(dim):
        out[i, : i + 1] = data[k : k + i + 1]
        k += i + 1
    out = out + np.tril(out, -1).T
    return out.astype(np.float32)


def _write_sp_matrix(w: BinaryWriter, m: np.ndarray) -> None:
    dim = m.shape[0]
    w.write_token("FP")
    w.write_basic_int(dim)
    rows = [m[i, : i + 1].astype(np.float32) for i in range(dim)]
    w.s.write(np.concatenate(rows).tobytes())


@dataclasses.dataclass
class DiagGmm:
    gconsts: np.ndarray        # [G]
    weights: np.ndarray        # [G]
    means_invvars: np.ndarray  # [G, D]   (mu / sigma^2)
    inv_vars: np.ndarray       # [G, D]   (1 / sigma^2)

    @property
    def num_gauss(self) -> int:
        return len(self.weights)

    @property
    def dim(self) -> int:
        return self.means_invvars.shape[1]

    def compute_gconsts(self) -> np.ndarray:
        """gconst_g = log w_g + 0.5 (sum log invvar - D log(2pi)
        - mu^T invvar mu); matches Kaldi DiagGmm::ComputeGconsts."""
        D = self.dim
        mu2 = (self.means_invvars ** 2) / np.maximum(self.inv_vars, 1e-20)
        return (
            np.log(np.maximum(self.weights, 1e-37))
            + 0.5 * (np.sum(np.log(self.inv_vars), axis=1)
                     - D * np.log(2 * np.pi)
                     - np.sum(mu2, axis=1))
        ).astype(np.float32)


def read_diag_gmm(path) -> DiagGmm:
    r, _ = open_kaldi(path)
    r.expect_token("<DiagGMM>")
    tok = r.read_token()
    gconsts = None
    if tok == "<GCONSTS>":
        gconsts = r.read_vector()
        tok = r.read_token()
    if tok != "<WEIGHTS>":
        raise KaldiReadError(f"expected <WEIGHTS>, got {tok!r}")
    weights = r.read_vector()
    r.expect_token("<MEANS_INVVARS>")
    miv = r.read_matrix()
    r.expect_token("<INV_VARS>")
    iv = r.read_matrix()
    r.expect_token("</DiagGMM>")
    g = DiagGmm(
        gconsts if gconsts is not None else np.zeros(len(weights), np.float32),
        weights.astype(np.float32),
        miv.astype(np.float32),
        iv.astype(np.float32),
    )
    if gconsts is None:
        g.gconsts = g.compute_gconsts()
    return g


def write_diag_gmm(path, g: DiagGmm) -> None:
    with open(path, "wb") as f:
        f.write(b"\0B")
        w = BinaryWriter(f)
        w.write_token("<DiagGMM>")
        w.write_token("<GCONSTS>")
        w.write_vector(g.gconsts)
        w.write_token("<WEIGHTS>")
        w.write_vector(g.weights)
        w.write_token("<MEANS_INVVARS>")
        w.write_matrix(g.means_invvars)
        w.write_token("<INV_VARS>")
        w.write_matrix(g.inv_vars)
        w.write_token("</DiagGMM>")


@dataclasses.dataclass
class IvectorExtractor:
    M: np.ndarray          # [G, D, I] projection per gaussian
    sigma_inv: np.ndarray  # [G, D, D] inverse covariances (symmetric)
    prior_offset: float
    w_vec: np.ndarray      # [G] gaussian weights

    @property
    def ivector_dim(self) -> int:
        return self.M.shape[2]

    @property
    def feat_dim(self) -> int:
        return self.M.shape[1]


def read_ivector_extractor(path) -> IvectorExtractor:
    r, _ = open_kaldi(path)
    r.expect_token("<IvectorExtractor>")
    r.expect_token("<w>")
    _w = r.read_matrix()  # weight-projection (unused online; often empty)
    r.expect_token("<w_vec>")
    w_vec = r.read_vector()
    r.expect_token("<M>")
    n = r.read_basic_int()
    Ms = [r.read_matrix() for _ in range(n)]
    r.expect_token("<SigmaInv>")
    sig = [_read_sp_matrix(r) for _ in range(n)]
    r.expect_token("<IvectorOffset>")
    prior_offset = r.read_basic_float()
    r.expect_token("</IvectorExtractor>")
    return IvectorExtractor(
        M=np.stack(Ms).astype(np.float32),
        sigma_inv=np.stack(sig).astype(np.float32),
        prior_offset=float(prior_offset),
        w_vec=w_vec.astype(np.float32),
    )


def write_ivector_extractor(path, ie: IvectorExtractor) -> None:
    with open(path, "wb") as f:
        f.write(b"\0B")
        w = BinaryWriter(f)
        w.write_token("<IvectorExtractor>")
        w.write_token("<w>")
        w.write_matrix(np.zeros((0, 0), np.float32))
        w.write_token("<w_vec>")
        w.write_vector(ie.w_vec)
        w.write_token("<M>")
        w.write_basic_int(ie.M.shape[0])
        for m in ie.M:
            w.write_matrix(m)
        w.write_token("<SigmaInv>")
        for s in ie.sigma_inv:
            _write_sp_matrix(w, s)
        w.write_token("<IvectorOffset>")
        w.write_basic_float(ie.prior_offset)
        w.write_token("</IvectorExtractor>")


@dataclasses.dataclass
class IvectorDirConfig:
    """Everything the online extractor needs, loaded from an ivector/ dir."""

    dubm: DiagGmm
    extractor: IvectorExtractor
    lda: np.ndarray            # [D_out, D_spliced(+1)]; last col = offset
    global_cmvn: np.ndarray    # [2, D+1] Kaldi CMVN stats
    splice_left: int = 3
    splice_right: int = 3
    num_gselect: int = 5
    min_post: float = 0.025
    posterior_scale: float = 0.1
    ivector_period: int = 10
    max_count: float = 100.0   # reference hardcodes 100 (model.cc:258)
    online_cmvn: bool = True


def _parse_splice_conf(path) -> tuple[int, int]:
    left = right = 3
    try:
        text = Path(path).read_text()
    except OSError:
        return left, right
    for tok in text.replace("\n", " ").split():
        if tok.startswith("--left-context="):
            left = int(tok.split("=", 1)[1])
        elif tok.startswith("--right-context="):
            right = int(tok.split("=", 1)[1])
    return left, right


def read_ivector_dir(path) -> IvectorDirConfig:
    """Load an `ivector/` directory in the reference's layout
    (src/model.cc:250-258)."""
    p = Path(path)
    dubm = read_diag_gmm(p / "final.dubm")
    ie = read_ivector_extractor(p / "final.ie")
    lda = read_kaldi_matrix(p / "final.mat")
    cmvn = read_kaldi_matrix(p / "global_cmvn.stats")
    left, right = _parse_splice_conf(p / "splice.conf")
    cfg = IvectorDirConfig(
        dubm=dubm,
        extractor=ie,
        lda=lda.astype(np.float32),
        global_cmvn=cmvn.astype(np.float64),
        splice_left=left,
        splice_right=right,
    )
    # optional ivector_extractor.conf overrides (num-gselect etc.)
    conf = p / "ivector_extractor.conf"
    if conf.exists():
        for tok in conf.read_text().replace("\n", " ").split():
            if tok.startswith("--num-gselect="):
                cfg.num_gselect = int(tok.split("=", 1)[1])
            elif tok.startswith("--min-post="):
                cfg.min_post = float(tok.split("=", 1)[1])
            elif tok.startswith("--posterior-scale="):
                cfg.posterior_scale = float(tok.split("=", 1)[1])
            elif tok.startswith("--ivector-period="):
                cfg.ivector_period = int(tok.split("=", 1)[1])
            elif tok.startswith("--max-count="):
                cfg.max_count = float(tok.split("=", 1)[1])
    return cfg


def write_ivector_dir(path, cfg: IvectorDirConfig) -> None:
    """Write an ivector/ directory in the reference layout (test fixtures
    and the native exporter)."""
    from .kaldiio import write_kaldi_object

    p = Path(path)
    p.mkdir(parents=True, exist_ok=True)
    write_diag_gmm(p / "final.dubm", cfg.dubm)
    write_ivector_extractor(p / "final.ie", cfg.extractor)
    write_kaldi_object(p / "final.mat", lambda w: w.write_matrix(cfg.lda))
    write_kaldi_object(
        p / "global_cmvn.stats",
        lambda w: w.write_matrix(cfg.global_cmvn.astype(np.float64)),
    )
    (p / "splice.conf").write_text(
        f"--left-context={cfg.splice_left} --right-context={cfg.splice_right}\n"
    )
    (p / "online_cmvn.conf").write_text("")
    (p / "ivector_extractor.conf").write_text(
        f"--num-gselect={cfg.num_gselect}\n--min-post={cfg.min_post}\n"
        f"--posterior-scale={cfg.posterior_scale}\n"
        f"--ivector-period={cfg.ivector_period}\n--max-count={cfg.max_count}\n"
    )
