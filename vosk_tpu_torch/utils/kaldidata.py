"""Seeded Kaldi-layout model directories for the port's smoke run and card
tests, written with the port's own exporter (io/kaldi_export.py), so a
machine with no jax can build them.

  * `one_phone_per_pdf`: give a native model one phone per pdf (phone 1 =
    silence = pdf 0), the layout `export_kaldi_dir` writes (pdf = phone-1).
  * `graft_ivector`: an i-vector input appended to the first affine layer
    through ReplaceIndex(ivector, t, 0), with seeded non-zero weights.
  * `make_ivector_config`: a seeded diagonal UBM + extractor + LDA.
  * `write_ivector_kaldi_dir`: a directory written by `export_kaldi_dir`
    turned into one whose AM reads i-vectors, with an `ivector/` dir and
    silence weighting on (the source directory stays as it was).
  * `make_lexicon_model`: a seeded lexicon over the AM's phones and a
    word-loop G for the split-graph (HCLr/Gr) exporter.
"""
from __future__ import annotations

import os
from pathlib import Path

import numpy as np

from ..graph.builder import Lexicon, Topology, build_decoding_graph
from ..graph.fst import SymbolTable
from ..graph.lm import grammar_to_fst
from ..io import nnet3 as n3
from ..io.kaldi_export import build_transition_model, tdnnf_to_nnet3
from ..io.kaldi_ivector import (
    DiagGmm,
    IvectorDirConfig,
    IvectorExtractor,
    write_ivector_dir,
)
from ..io.kaldiio import BinaryWriter


def one_phone_per_pdf(model) -> None:
    """Phones p1..pP for P pdfs, phone 1 (pdf 0) the silence phone."""
    P = model.am_config.num_pdfs
    model.phones = SymbolTable(["<eps>", "SIL"] + [f"p{i}" for i in range(2, P + 1)])
    model.phone_of_pdf = np.arange(1, P + 1, dtype=np.int32)
    model.silence_pdfs = np.array([0], np.int32)


def graft_ivector(net: n3.Nnet3, ivector_dim: int, seed: int = 0,
                  layer: str = "tdnn1.affine", scale: float = 0.05) -> n3.Nnet3:
    """Append an i-vector input to `layer`'s spliced input (the layout of
    Kaldi's run_tdnn.sh, ReplaceIndex(ivector, t, 0)); the new weight
    columns are seeded normal * `scale`, so the i-vector moves the output."""
    net._parse_config_line(f"input-node name=ivector dim={ivector_dim}")
    net._parse_config_line(
        f"component-node name={layer} component={layer} "
        "input=Append(Offset(input, -1), input, Offset(input, 1), "
        "ReplaceIndex(ivector, t, 0))")
    # the re-parsed layer keeps its place; the new input follows "input"
    order = [n for n in dict.fromkeys(net.node_order) if n != "ivector"]
    net.node_order = order[:1] + ["ivector"] + order[1:]
    aff = net.components[layer]
    rng = np.random.default_rng(seed)
    extra = (rng.standard_normal((aff.linear.shape[0], ivector_dim)) * scale).astype(np.float32)
    aff.linear = np.concatenate([aff.linear, extra], axis=1)
    return net


def make_ivector_config(feat_dim: int, num_gauss: int = 512, ubm_dim: int = 40,
                        ivector_dim: int = 100, splice: int = 3, seed: int = 0,
                        **opts) -> IvectorDirConfig:
    """A seeded extractor at the given dims (the defaults are those of
    Kaldi's egs/*/s5/local/nnet3/run_ivector_common.sh: 512 Gaussians,
    splice +-3 and LDA to 40, i-vector dim 100)."""
    rng = np.random.default_rng(seed)
    G, D, I = num_gauss, ubm_dim, ivector_dim
    gmm = DiagGmm(np.zeros(G, np.float32), np.full(G, 1.0 / G, np.float32),
                  rng.standard_normal((G, D)).astype(np.float32),
                  rng.uniform(0.5, 2.0, (G, D)).astype(np.float32))
    gmm.gconsts = gmm.compute_gconsts()
    A = (rng.standard_normal((G, D, D)) * (0.2 / np.sqrt(D))).astype(np.float32)
    sig = (np.einsum("gij,gkj->gik", A, A) + np.eye(D, dtype=np.float32)).astype(np.float32)
    ie = IvectorExtractor(M=(rng.standard_normal((G, D, I)) * 0.3).astype(np.float32),
                          sigma_inv=sig, prior_offset=100.0,
                          w_vec=np.full(G, 1.0 / G, np.float32))
    spliced = feat_dim * (2 * splice + 1)
    lda = (rng.standard_normal((D, spliced + 1)) / np.sqrt(spliced)).astype(np.float32)
    cmvn = np.zeros((2, feat_dim + 1), np.float64)
    cmvn[0, -1] = 1.0
    return IvectorDirConfig(dubm=gmm, extractor=ie, lda=lda, global_cmvn=cmvn,
                            splice_left=splice, splice_right=splice, **opts)


def write_ivector_kaldi_dir(model, src, out, ivector_cfg: IvectorDirConfig,
                            seed: int = 0, silence_weight: float = 0.001) -> None:
    """`out` = the exported Kaldi dir `src` (files hard-linked, not
    copied) with an AM that reads i-vectors, `ivector/`, and i-vector
    silence weighting in model.conf."""
    src, out = Path(src), Path(out)
    for d, _, files in os.walk(src):
        rel = Path(d).relative_to(src)
        (out / rel).mkdir(parents=True, exist_ok=True)
        for f in files:
            if rel / f not in (Path("am/final.mdl"), Path("conf/model.conf")):
                os.link(Path(d) / f, out / rel / f)
    tm = build_transition_model(len(model.phones) - 1, model.topology.self_loop_prob)
    net = graft_ivector(tdnnf_to_nnet3(model.am_config, model.am_params),
                        ivector_cfg.extractor.ivector_dim, seed=seed)
    with open(out / "am" / "final.mdl", "wb") as f:
        f.write(b"\x00B")
        w = BinaryWriter(f)
        tm.write(w)
        n3.AmNnetSimple(net, np.zeros(0, np.float32)).write(w)
    write_ivector_dir(out / "ivector", ivector_cfg)
    (out / "conf" / "model.conf").write_text(
        (src / "conf" / "model.conf").read_text()
        + f"--ivector-silence-weighting.silence-weight={silence_weight:g}\n")


def make_lexicon_model(model, num_words: int = 1000, min_phones: int = 2,
                       max_phones: int = 5, seed: int = 0):
    """`model` (one phone per pdf) given a seeded lexicon of `num_words`
    words w1.. of `min_phones`-`max_phones` phones drawn from phones 2..P,
    optional silence (phone 1) between words, a word-loop G (every word a
    one-word phrase of the grammar LM) and the HCLG built from both, so
    `export_kaldi_split_dir` can write it."""
    rng = np.random.default_rng(seed)
    P = len(model.phones) - 1
    words = SymbolTable(["<eps>"] + [f"w{i}" for i in range(1, num_words + 1)])
    prons = {
        w: [list(rng.integers(2, P + 1, rng.integers(min_phones, max_phones + 1)))]
        for w in range(1, num_words + 1)
    }
    prons = {w: [[int(p) for p in pr] for pr in ps] for w, ps in prons.items()}
    lex = Lexicon(words=words, phones=model.phones, prons=prons, silence_phone=1)
    topo = Topology()
    g = grammar_to_fst([words.name(w) for w in range(1, num_words + 1)], words.find)
    graph, _ = build_decoding_graph(lex, g, topo)
    model.graph = graph
    model.words = words
    model.lexicon = lex
    model.topology = topo
    model.g_fst = g
    return model
