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
  * `write_arpa` / `bigram_fst`: a seeded 3-gram ARPA LM over a word list
    and the word bigram acceptor (with eps backoff arcs) cut from it.
  * `write_rescore_dir`: a Kaldi `rescore/` (G.carpa built from that ARPA
    by the port's builder, G.fst the bigram).
  * `write_kaldi_rnnlm_dir`: a Kaldi `rnnlm/` whose final.raw is the node
    graph of Kaldi's TDNN-LSTM RNNLM recipe (fast-lstmp layers), with
    sparse word features and a feature embedding.
  * `write_native_rescoring`: a native dir's `g.npz`, `rescore.arpa` and
    GRU `rnnlm/`.
  * `write_pitch_conf`: a Kaldi V2 dir's conf/pitch.conf (online pitch).
  * `xvector_net` / `write_kaldi_xvector_dir`: a Kaldi speaker dir
    (final.ext.raw, mean.vec, transform.mat, mfcc.conf) whose net is the
    node graph of Kaldi's VoxCeleb x-vector recipe.
"""
from __future__ import annotations

import math
import os
from pathlib import Path

import numpy as np

from ..graph.builder import Lexicon, Topology, build_decoding_graph
from ..graph.fst import StdFst, SymbolTable
from ..graph.lm import grammar_to_fst
from ..io import nnet3 as n3
from ..io.kaldi_export import build_transition_model, tdnnf_to_nnet3, write_fst_vector
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


# ---------------------------------------------------------------- rescoring

LOG10 = math.log(10.0)


def _zipf_draw(rng, n: int, V: int) -> np.ndarray:
    """n word ids in 1..V, rank-frequency 1/rank (word 1 most frequent)."""
    cdf = np.cumsum(1.0 / np.arange(1, V + 1))
    return np.minimum(np.searchsorted(cdf, rng.random(n) * cdf[-1]), V - 1) + 1


def _ngram_model(V: int, seed: int, num_bigrams: int, num_trigrams: int):
    """Seeded 3-gram tables over word ids 1..V, <s> = V + 1, </s> = V + 2:
    (unigram log10 probs [V + 3], unigram backoffs [V + 3], {bigram: lp},
    {bigram: backoff}, {trigram: lp}), probabilities rounded as written."""
    rng = np.random.default_rng(seed)
    bos, eos = V + 1, V + 2
    p = 1.0 / np.arange(1, V + 1)
    uni = np.full(V + 3, -99.0)
    uni[1:V + 1] = np.log10(0.95 * p / p.sum())
    uni[eos] = np.log10(0.05)
    uni = np.round(uni, 6)
    uni_bo = np.round(rng.uniform(-0.8, -0.1, V + 3), 6)

    def nexts(n):
        w = _zipf_draw(rng, n, V)
        return np.where(rng.random(n) < 0.05, eos, w)

    n = int(num_bigrams * 1.3) + 16
    h = np.where(rng.random(n) < 0.1, bos, _zipf_draw(rng, n, V))
    drawn = h * (V + 3) + nexts(n)
    _, first = np.unique(drawn, return_index=True)
    keys = drawn[np.sort(first)][:num_bigrams]  # distinct, in draw order
    big = dict(zip(map(tuple, np.stack([keys // (V + 3), keys % (V + 3)], 1).tolist()),
                   np.round(rng.uniform(-3.0, -0.3, len(keys)), 6).tolist()))
    hist2 = [k for k in big if k[1] != eos]
    n = int(num_trigrams * 1.3) + 16
    pick = rng.integers(0, len(hist2), n)
    w3 = nexts(n)
    tri = {}
    for i, w in zip(pick.tolist(), w3.tolist()):
        if len(tri) == num_trigrams:
            break
        tri.setdefault(hist2[i] + (w,), None)
    tri = dict(zip(tri, np.round(rng.uniform(-2.5, -0.2, len(tri)), 6).tolist()))
    prefixes = sorted({k[:2] for k in tri})
    big_bo = dict(zip(prefixes, np.round(rng.uniform(-0.6, -0.05, len(prefixes)),
                                         6).tolist()))
    return uni, uni_bo, big, big_bo, tri


def write_arpa(path, words: SymbolTable, seed: int = 0, num_bigrams: int = 100_000,
               num_trigrams: int = 100_000) -> dict:
    """A seeded 3-gram ARPA LM over every word of `words` (ids 1..V):
    Zipf unigrams with </s> at 0.05, the distinct ones among 1.3 x
    `num_bigrams` Zipf-drawn bigrams (at most `num_bigrams`; a tenth after
    <s>) and `num_trigrams` trigrams extending them.  Returns the n-gram
    counts."""
    V = len(words) - 1
    uni, uni_bo, big, big_bo, tri = _ngram_model(V, seed, num_bigrams, num_trigrams)
    tok = [words.name(i) for i in range(V + 1)] + ["<s>", "</s>"]
    lines = ["\\data\\", f"ngram 1={V + 2}", f"ngram 2={len(big)}",
             f"ngram 3={len(tri)}", "", "\\1-grams:"]
    for w in list(range(1, V + 2)) + [V + 2]:
        bo = "" if w == V + 2 else f" {uni_bo[w]:.6f}"
        lines.append(f"{uni[w]:.6f} {tok[w]}{bo}")
    lines += ["", "\\2-grams:"]
    for (a, b), lp in big.items():
        bo = f" {big_bo[(a, b)]:.6f}" if (a, b) in big_bo else ""
        lines.append(f"{lp:.6f} {tok[a]} {tok[b]}{bo}")
    lines += ["", "\\3-grams:"]
    lines += [f"{lp:.6f} {tok[a]} {tok[b]} {tok[c]}" for (a, b, c), lp in tri.items()]
    lines += ["", "\\end\\", ""]
    Path(path).write_text("\n".join(lines), encoding="utf-8")
    return {"unigrams": V + 2, "bigrams": len(big), "trigrams": len(tri)}


def bigram_fst(words: SymbolTable, seed: int = 0, num_bigrams: int = 100_000,
               num_trigrams: int = 100_000) -> StdFst:
    """The bigram part of `write_arpa`'s LM (same seed and sizes) as a word
    acceptor with eps backoff arcs, the shape of Kaldi's G.fst: state 0
    backs off to unigrams and is final with </s>'s cost; every bigram
    history (and <s>, the start) has a state with its bigram arcs and an
    eps arc to state 0 carrying its backoff; costs -ln p."""
    V = len(words) - 1
    uni, uni_bo, big, _, _ = _ngram_model(V, seed, num_bigrams, num_trigrams)
    bos, eos = V + 1, V + 2
    hists = sorted({a for a, _ in big} | {bos})
    state = {h: i + 1 for i, h in enumerate(hists)}
    g = StdFst()
    g.add_states(len(hists) + 1)
    g.set_start(state[bos])
    g.set_final(0, float(-uni[eos] * LOG10))
    for w in range(1, V + 1):
        g.add_arc(0, w, w, float(-uni[w] * LOG10), state.get(w, 0))
    for h in hists:
        g.add_arc(state[h], 0, 0, float(-uni_bo[h] * LOG10), 0)
    for (a, b), lp in big.items():
        if b == eos:
            g.set_final(state[a], float(-lp * LOG10))
        else:
            g.add_arc(state[a], b, b, float(-lp * LOG10), state.get(b, 0))
    return g


def write_rescore_dir(model, out, seed: int = 0, **sizes) -> dict:
    """`out`/rescore/ for `model`'s words: G.carpa compiled by the port's
    `build_carpa_from_arpa` from `write_arpa`'s LM and G.fst, its bigram
    part.  Returns the n-gram counts and the G.fst's states and arcs."""
    import tempfile

    from ..io.kaldi_carpa import build_carpa_from_arpa, write_carpa

    d = Path(out) / "rescore"
    d.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=d) as tmp:
        arpa = Path(tmp) / "lm.arpa"
        counts = write_arpa(arpa, model.words, seed=seed, **sizes)
        write_carpa(build_carpa_from_arpa(arpa, model.words), d / "G.carpa")
    g = bigram_fst(model.words, seed=seed, **sizes)
    write_fst_vector(d / "G.fst", g)
    return {**counts, "g_states": g.num_states, "g_arcs": g.num_arcs}


def _rnnlm_net(rng, E: int, C: int, rpd: int, nrpd: int) -> n3.Nnet3:
    """The node graph Kaldi's xconfig emits for the TDNN-LSTM RNNLM recipe
    (relu layers over Append(0, IfDefined(-1)) / (0, IfDefined(-3)), two
    fast-lstmp layers, a linear output of the embedding dim), with ReLU
    layers in place of relu-renorm (no NormalizeComponent)."""
    net = n3.Nnet3()
    lines = [f"input-node name=input dim={E}"]
    comps, order = {}, []

    def affine(name, din, dout):
        comps[name] = n3.AffineComponent(
            (rng.standard_normal((dout, din)) / np.sqrt(din)).astype(np.float32),
            (rng.standard_normal(dout) * 0.1).astype(np.float32))
        order.append(name)

    def tdnn(name, src, delay, din):
        affine(f"{name}.affine", 2 * din, E)
        comps[f"{name}.relu"] = n3.NonlinComponent(E, "RectifiedLinearComponent")
        order.append(f"{name}.relu")
        lines.extend([
            f"component-node name={name}.affine component={name}.affine "
            f"input=Append({src}, IfDefined(Offset({src}, {delay})))",
            f"component-node name={name}.relu component={name}.relu input={name}.affine"])
        return f"{name}.relu"

    def lstm(name, src, din):
        affine(f"{name}.W_all", din + rpd, 4 * C)
        comps[f"{name}.lstm_nonlin"] = n3.LstmNonlinearityComponent(
            (rng.standard_normal((3, C)) * 0.1).astype(np.float32))
        order.append(f"{name}.lstm_nonlin")
        affine(f"{name}.W_rp", C, rpd + nrpd)
        comps[f"{name}.cr_trunc"] = n3.IdentityComponent(C + rpd,
                                                         "BackpropTruncationComponent")
        order.append(f"{name}.cr_trunc")
        lines.extend([
            f"component-node name={name}.four_parts component={name}.W_all "
            f"input=Append({src}, IfDefined(Offset({name}.r_trunc, -1)))",
            f"component-node name={name}.lstm_nonlin component={name}.lstm_nonlin "
            f"input=Append({name}.four_parts, IfDefined(Offset({name}.c_trunc, -1)))",
            f"dim-range-node name={name}.c input-node={name}.lstm_nonlin dim-offset=0 dim={C}",
            f"dim-range-node name={name}.m input-node={name}.lstm_nonlin "
            f"dim-offset={C} dim={C}",
            f"component-node name={name}.rp component={name}.W_rp input={name}.m",
            f"dim-range-node name={name}.r input-node={name}.rp dim-offset=0 dim={rpd}",
            f"component-node name={name}.cr_trunc component={name}.cr_trunc "
            f"input=Append({name}.c, {name}.r)",
            f"dim-range-node name={name}.c_trunc input-node={name}.cr_trunc "
            f"dim-offset=0 dim={C}",
            f"dim-range-node name={name}.r_trunc input-node={name}.cr_trunc "
            f"dim-offset={C} dim={rpd}"])
        return f"{name}.rp"

    x = tdnn("tdnn1", "input", -1, E)
    x = lstm("lstm1", x, E)
    x = tdnn("tdnn2", x, -3, rpd + nrpd)
    x = lstm("lstm2", x, E)
    x = tdnn("tdnn3", x, -3, rpd + nrpd)
    affine("output.affine", E, E)
    lines += [f"component-node name=output.affine component=output.affine input={x}",
              "output-node name=output input=output.affine objective=linear"]
    for line in lines:
        net._parse_config_line(line)
    net.components, net.component_order = comps, order
    return net


def write_kaldi_rnnlm_dir(out, words: SymbolTable, seed: int = 0, embedding_dim: int = 1024,
                          cell_dim: int = 1024, recurrent_dim: int = 256,
                          nonrecurrent_dim: int = 256, num_features: int = 20_000,
                          num_frequent: int = 5_000) -> dict:
    """A Kaldi `rnnlm/` dir over `words` (ids 0..V) plus <s>, </s>, <brk>
    at V+1..V+3: final.raw (`_rnnlm_net`), special_symbol_opts.conf, and
    sparse word features with their embedding [num_features,
    embedding_dim]: feature 0 a constant on every word, features
    1..num_frequent one each for the specials and the most frequent words,
    the rest letter trigrams of a seeded 3-6 letter spelling per word (2-6
    features a word).  Returns the dims and the feature count."""
    rng = np.random.default_rng(seed)
    d = Path(out)
    d.mkdir(parents=True, exist_ok=True)
    V = len(words) - 1
    bos, eos, brk = V + 1, V + 2, V + 3
    n_tri = num_features - 1 - num_frequent
    frequent = {w: 1 + i for i, w in enumerate([bos, eos, brk] + list(range(1, V + 1))
                                                [: num_frequent - 3])}
    lens = rng.integers(3, 7, V + 4)
    letters = rng.integers(0, 26, (V + 4, 6))
    vals = rng.uniform(0.1, 1.0, (V + 4, 6))
    rows, nnz = [], 0
    for w in range(V + 4):
        feats = {0: 1.0}
        if w in frequent:
            feats[frequent[w]] = 1.0
        sp = letters[w, : lens[w]]
        for i in range(lens[w] - 2):
            code = int(sp[i]) * 676 + int(sp[i + 1]) * 26 + int(sp[i + 2])
            feats.setdefault(1 + num_frequent + code % n_tri, float(vals[w, i]))
        nnz += len(feats)
        rows.append(f"{w}\t" + " ".join(f"{k} {v:.6g}" for k, v in feats.items()))
    (d / "word_feats.txt").write_text("\n".join(rows) + "\n")
    femb = (rng.standard_normal((num_features, embedding_dim)) * 0.1).astype(np.float32)
    with open(d / "feat_embedding.final.mat", "wb") as f:
        f.write(b"\x00B")
        BinaryWriter(f).write_matrix(femb)
    (d / "special_symbol_opts.conf").write_text(
        f"--bos-symbol={bos}\n--eos-symbol={eos}\n--brk-symbol={brk}\n")
    net = _rnnlm_net(rng, embedding_dim, cell_dim, recurrent_dim, nonrecurrent_dim)
    with open(d / "final.raw", "wb") as f:
        f.write(b"\x00B")
        net.write(BinaryWriter(f))
    params = sum(c.linear.size + c.bias.size if isinstance(c, n3.AffineComponent)
                 else c.params.size if isinstance(c, n3.LstmNonlinearityComponent) else 0
                 for c in net.components.values())
    return {"words": V + 4, "features": num_features, "nonzeros": nnz, "params": params}


def write_native_rescoring(model, out, seed: int = 0, rnnlm_dims=(1024, 1024),
                           **sizes) -> dict:
    """A native model dir's rescoring files for `model`'s words: `g.npz`
    (`bigram_fst`), `rescore.arpa` (`write_arpa`) and, unless `rnnlm_dims`
    is None, a GRU `rnnlm/` of (embedding, hidden) dims with seeded
    parameters, in the source's save layout.  Returns the n-gram counts."""
    from ..io.native import _save_std_fst
    from ..models.rnnlm import RnnlmConfig, init_rnnlm_params, save_rnnlm

    d = Path(out)
    counts = write_arpa(d / "rescore.arpa", model.words, seed=seed, **sizes)
    _save_std_fst(d / "g.npz", bigram_fst(model.words, seed=seed, **sizes))
    if rnnlm_dims is not None:
        cfg = RnnlmConfig(vocab_size=len(model.words), embed_dim=rnnlm_dims[0],
                          hidden_dim=rnnlm_dims[1])
        save_rnnlm(d / "rnnlm", cfg, init_rnnlm_params(cfg, seed=seed))
    return counts


# ------------------------------------------------------------ pitch, speaker


def write_pitch_conf(kaldi_dir, lines=("--sample-frequency=16000",)) -> None:
    """conf/pitch.conf of a Kaldi V2 dir (egs/aishell/s5's is the default:
    --sample-frequency=16000), which turns online pitch on."""
    (Path(kaldi_dir) / "conf" / "pitch.conf").write_text("\n".join(lines) + "\n")


XVECTOR_CONTEXTS = ((-2, -1, 0, 1, 2), (-2, 0, 2), (-3, 0, 3), (0,), (0,))


def xvector_net(rng, feat_dim: int = 30, layer_dims=(512, 512, 512, 512, 1500),
                embed_dim: int = 512) -> n3.Nnet3:
    """The node graph of Kaldi's VoxCeleb x-vector recipe
    (egs/voxceleb/v2/local/nnet3/xvector/tuning/run_xvector_1a.sh) as
    final.ext.raw holds it: relu-batchnorm layers (affine, ReLU,
    BatchNorm) over Append(-2..2), Append(-2,0,2), Append(-3,0,3), 0 and 0;
    `stats-layer mean+stddev(0:1:1:10000)` as a StatisticsExtraction +
    StatisticsPooling pair read through Round(., 1); the output at
    tdnn6.affine, where extraction truncates the net.  Seeded weights and
    batch-norm statistics."""
    net = n3.Nnet3()
    lines = [f"input-node name=input dim={feat_dim}"]
    comps = {}
    prev, din = "input", feat_dim
    for i, (ctx, dout) in enumerate(zip(XVECTOR_CONTEXTS, layer_dims), start=1):
        name = f"tdnn{i}"
        src = prev if ctx == (0,) else "Append(" + ", ".join(
            prev if o == 0 else f"Offset({prev}, {o})" for o in ctx) + ")"
        fan_in = din * len(ctx)
        comps[f"{name}.affine"] = n3.AffineComponent(
            (rng.standard_normal((dout, fan_in)) / np.sqrt(fan_in)).astype(np.float32),
            (rng.standard_normal(dout) * 0.1).astype(np.float32))
        comps[f"{name}.relu"] = n3.NonlinComponent(dout, "RectifiedLinearComponent")
        comps[f"{name}.batchnorm"] = n3.BatchNormComponent(
            dout, 1e-3, 1.0, rng.uniform(0.1, 0.5, dout).astype(np.float32),
            rng.uniform(0.2, 1.0, dout).astype(np.float32))
        lines += [
            f"component-node name={name}.affine component={name}.affine input={src}",
            f"component-node name={name}.relu component={name}.relu input={name}.affine",
            f"component-node name={name}.batchnorm component={name}.batchnorm "
            f"input={name}.relu"]
        prev, din = f"{name}.batchnorm", dout
    ex, pool = "stats-extraction-0-10000", "stats-pooling-0-10000"
    comps[ex] = n3.StatisticsExtractionComponent(din, 1, 1, True)
    comps[pool] = n3.StatisticsPoolingComponent(1 + 2 * din, 1, 0, 10000, 0, True)
    comps["tdnn6.affine"] = n3.AffineComponent(
        (rng.standard_normal((embed_dim, 2 * din)) / np.sqrt(2 * din)).astype(np.float32),
        (rng.standard_normal(embed_dim) * 0.1).astype(np.float32))
    lines += [f"component-node name={ex} component={ex} input={prev}",
              f"component-node name={pool} component={pool} input={ex}",
              f"component-node name=tdnn6.affine component=tdnn6.affine input=Round({pool}, 1)",
              "output-node name=output input=tdnn6.affine objective=linear"]
    for line in lines:
        net._parse_config_line(line)
    net.components, net.component_order = comps, list(comps)
    return net


def write_kaldi_xvector_dir(out, seed: int = 0, feat_dim: int = 30,
                            layer_dims=(512, 512, 512, 512, 1500), embed_dim: int = 512,
                            lda_dim: int = 200) -> dict:
    """A Kaldi speaker dir at the VoxCeleb recipe's widths by default:
    final.ext.raw (`xvector_net`), mean.vec [embed_dim], transform.mat
    [lda_dim, embed_dim] (egs/voxceleb/v2/run.sh, lda_dim=200) and the
    recipe's conf/mfcc.conf (30 ceps, 30 mel bins).  Returns the dims and
    the parameter count."""
    from ..io.kaldiio import write_kaldi_object

    rng = np.random.default_rng(seed)
    d = Path(out)
    d.mkdir(parents=True, exist_ok=True)
    net = xvector_net(rng, feat_dim, layer_dims, embed_dim)
    write_kaldi_object(d / "final.ext.raw", net.write)
    mean = (rng.standard_normal(embed_dim) * 0.1).astype(np.float32)
    transform = (rng.standard_normal((lda_dim, embed_dim)) / np.sqrt(embed_dim)).astype(np.float32)
    write_kaldi_object(d / "mean.vec", lambda w: w.write_vector(mean))
    write_kaldi_object(d / "transform.mat", lambda w: w.write_matrix(transform))
    (d / "mfcc.conf").write_text(
        f"--sample-frequency=16000\n--frame-length=25\n--low-freq=20\n--high-freq=7600\n"
        f"--num-mel-bins={feat_dim}\n--num-ceps={feat_dim}\n--snip-edges=false\n")
    params = sum(c.linear.size + c.bias.size for c in net.components.values()
                 if isinstance(c, n3.AffineComponent))
    return {"feat_dim": feat_dim, "layers": list(layer_dims), "embed_dim": embed_dim,
            "lda_dim": lda_dim, "params": params}
