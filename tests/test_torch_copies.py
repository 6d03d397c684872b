"""The port's numpy/host copies held to their JAX-package sources.

vosk_tpu_torch carries copies of host code it needs because nothing under
vosk_tpu imports without jax: graph tables and transforms, grammar graphs
(lexicon, topology, n-gram G), the v4 record adapter, the Python lattice
and MBR, the native lattice binding, word-boundary realignment, the
resampler, JSON output, endpoint rules, PCM conversion, the bench graph
and scores, and the native model-dir format; and, for Kaldi model
directories, option files, Kaldi binary I/O, OpenFST graphs (vector, const
and ngram), split-graph composition, the nnet3 parser/writer, the exporter
(byte-identical files) and the loader (equal graphs and maps).  The
i-vector dir reader/writer is held in tests/test_torch_ivector.py.  Each
must give exactly what its source gives on the same input.  The entry
points' copies (websocket protocol and server, transcriber and CLI, the C
ABI's vosk_api.cc) may differ from their sources only in the package they
import and the device of their models; the training path's copies (WER
scoring, the flat-start GMM aligner, the toy corpus synthesis) only where
stated (their behaviour: tests/test_torch_recipe.py); and no module of the
port imports jax or vosk_tpu.
"""
import ast
import asyncio
import dataclasses
import difflib
import io
import json
import re
import wave
from pathlib import Path

import numpy as np
import pytest
import torch

from vosk_tpu.graph import arrayopt as j_arrayopt
from vosk_tpu.graph import builder as j_builder
from vosk_tpu.graph import lattice as j_lattice
from vosk_tpu.graph import lm as j_lm
from vosk_tpu.graph import mbr as j_mbr
from vosk_tpu.graph.fst import SymbolTable as JSymbols
from vosk_tpu.io import native as j_native
from vosk_tpu.io.wav import pcm16_bytes_to_float as j_pcm
from vosk_tpu.ops import resample as j_resample
from vosk_tpu.ops.viterbi import BatchViterbi as JViterbi, DecodeParams as JParams
from vosk_tpu.runtime import endpoint as j_endpoint
from vosk_tpu.runtime import jsonout as j_jsonout
from vosk_tpu.runtime import native_lattice as j_native_lattice
from vosk_tpu.runtime import wordalign as j_wordalign
from vosk_tpu.utils import benchdata as j_bench
from vosk_tpu_torch.graph import arrayopt, builder, lattice, lm, mbr
from vosk_tpu_torch.graph.fst import SymbolTable
from vosk_tpu_torch.io import native
from vosk_tpu_torch.io.wav import pcm16_bytes_to_float
from vosk_tpu_torch.ops import resample
from vosk_tpu_torch.ops.viterbi import BatchViterbi, DecodeParams
from vosk_tpu_torch.runtime import endpoint, jsonout, native_lattice, wordalign
from vosk_tpu_torch.utils import benchdata

SIL = np.array([0, 1], np.int32)


@pytest.fixture(scope="module", autouse=True)
def native_library():
    """The native lattice copies load core/libvosk_tpu_core.so."""
    return native_lattice.build_library()


def _graphs_equal(a, b):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype, f.name
            np.testing.assert_array_equal(x, y, err_msg=f.name)
        else:
            assert x == y, f.name
    assert getattr(a, "init_entries", None) == getattr(b, "init_entries", None)


@pytest.fixture(scope="module")
def small_graph():
    return j_bench.make_realistic_graph(num_states=5000, num_pdfs=64, num_words=300, seed=5)


@pytest.fixture(scope="module")
def decoded(small_graph):
    """Both decoders over the same graph and scores: (jd, jrecs, jf, td,
    trecs, tf)."""
    params = dict(beam=10.0, max_active=128, lattice_beam=6.0)
    jd = JViterbi(small_graph, JParams(**params), lattice_records=True,
                  silence_pdfs=SIL, frame_step="auto", pack="packed16",
                  optimize_graph=True)
    td = BatchViterbi(small_graph, DecodeParams(**params), silence_pdfs=SIL,
                      optimize_graph=True, device="cpu")
    B, T = 2, 12
    ll = j_bench.make_plausible_loglikes(jd.graph, 64, B, T, seed=9).transpose(1, 0, 2)
    ll = np.ascontiguousarray(ll)
    valid = np.ones((B, T), bool)
    valid[1, 4] = False
    jf, jr, _, _ = jd.decode_chunk(jd.init_frontier(B), ll, valid)
    tf, tr, _, _ = td.decode_chunk(td.init_frontier(B), torch.from_numpy(ll),
                                   torch.from_numpy(valid))
    return jd, [jr], jf, td, [tr], tf


@pytest.mark.parametrize("seed", [0, 1])
def test_make_realistic_graph_seed_identical(seed):
    a = benchdata.make_realistic_graph(num_states=3000, num_pdfs=50, num_words=100, seed=seed)
    b = j_bench.make_realistic_graph(num_states=3000, num_pdfs=50, num_words=100, seed=seed)
    _graphs_equal(a, b)


@pytest.mark.parametrize("M", [4, 8])
def test_prepare_graph_v4_copy(small_graph, M):
    _graphs_equal(arrayopt.prepare_graph_v4(small_graph, M=M),
                  j_arrayopt.prepare_graph_v4(small_graph, M=M))


def test_convert_v4_records_copy(decoded):
    jd, jrecs, _, td, trecs, _ = decoded
    for ch in range(2):
        a = lattice.convert_v4_records(td, trecs, ch)
        b = j_lattice.convert_v4_records(jd, jrecs, ch)
        for ra, rb in zip(a, b):
            assert ra.keys() == rb.keys()
            for k in ra:
                np.testing.assert_array_equal(ra[k], rb[k], err_msg=k)


@pytest.mark.parametrize("n", [1, 3])
def test_native_lattice_copy(decoded, n):
    jd, jrecs, jf, td, trecs, tf = decoded
    assert native_lattice.available() and j_native_lattice.available()
    for ch in range(2):
        kw = dict(lattice_beam=6.0, graph_scale=0.9, use_final=True)
        if n == 1:
            a = native_lattice.mbr_native(trecs, tf, ch, td, SIL, **kw)
            b = j_native_lattice.mbr_native(jrecs, jf, ch, jd, SIL, **kw)
        else:
            a = native_lattice.nbest_native(trecs, tf, ch, td, SIL, n=n, **kw)
            b = j_native_lattice.nbest_native(jrecs, jf, ch, jd, SIL, n=n, **kw)
        assert a == b
        assert a[1] if n == 1 else a  # words found, paths found


def test_jsonout_copy():
    words = [(w, 0.03 * i, 0.03 * i + 0.27, c) for i, (w, c) in
             enumerate([("one", 1.0), ("twö", 0.5123456789), ("three", 0.0)])]
    tw = [jsonout.WordResult(*w) for w in words]
    jw = [j_jsonout.WordResult(*w) for w in words]
    for show in (True, False):
        assert jsonout.final_result(tw, show) == j_jsonout.final_result(jw, show)
        assert jsonout.partial_result(tw, show) == j_jsonout.partial_result(jw, show)
        assert (jsonout.nbest_result([(tw, 0.7), ([], 0.1)], show)
                == j_jsonout.nbest_result([(jw, 0.7), ([], 0.1)], show))
    assert jsonout.nlsml_result([(tw, 0.25)]) == j_jsonout.nlsml_result([(jw, 0.25)])
    assert jsonout.final_result([], True) == j_jsonout.final_result([], True)
    assert jsonout.empty_final() == j_jsonout.empty_final()
    assert jsonout.empty_partial() == j_jsonout.empty_partial()


def test_endpoint_copy():
    rules = native.default_endpoint_rules()
    jrules = j_native.default_endpoint_rules()
    assert [dataclasses.asdict(r) for r in rules] == [dataclasses.asdict(r) for r in jrules]
    for frames in (0, 10, 400, 800):
        for trail in (0, 20, 40, 200):
            for rel in (0.0, 1.5, 5.0, float("inf")):
                for speech in (False, True):
                    args = (frames, trail, rel, 0.03, speech)
                    assert (endpoint.endpoint_detected(rules, *args)
                            == j_endpoint.endpoint_detected(jrules, *args))
    ali = [3, 0, 1, 1, 0, 0]
    assert endpoint.trailing_silence(ali, SIL) == j_endpoint.trailing_silence(ali, SIL)


def test_pcm_and_symbols_copy(tmp_path):
    rng = np.random.default_rng(0)
    data = rng.integers(0, 256, 1001, dtype=np.uint8).tobytes()  # odd length
    np.testing.assert_array_equal(pcm16_bytes_to_float(data), j_pcm(data))
    syms = ["<eps>", "a", "bé", "c"]
    SymbolTable(syms).write_text(tmp_path / "t.txt")
    JSymbols(syms).write_text(tmp_path / "j.txt")
    assert (tmp_path / "t.txt").read_bytes() == (tmp_path / "j.txt").read_bytes()
    a, b = SymbolTable.read_text(tmp_path / "j.txt"), JSymbols.read_text(tmp_path / "t.txt")
    assert [a.name(i) for i in range(5)] == [b.name(i) for i in range(5)]
    assert a.find("bé") == b.find("bé") == 2


def test_native_dir_roundtrip_both_ways(tmp_path):
    m = benchdata.make_bench_model(num_states=2000, num_pdfs=40, hidden=32,
                                   max_active=500, num_words=50, device="cpu")
    native.save_model(tmp_path / "m", m.config, m.am_params, m.graph, m.words,
                      m.phones, m.phone_of_pdf, m.silence_pdfs)
    jm = j_native.load_model(tmp_path / "m")
    assert dataclasses.asdict(jm.config) == json.loads(json.dumps(
        dataclasses.asdict(m.config), default=float))
    _graphs_equal(jm.graph, m.graph)
    for k in m.am_params:
        np.testing.assert_array_equal(jm.am_params[k], m.am_params[k])
    j_native.save_model(tmp_path / "j", jm.config, jm.am_params, jm.graph,
                        jm.words, jm.phones, None, jm.phone_of_pdf, jm.silence_pdfs,
                        g_fst=None)
    back = native.load_model(tmp_path / "j", device="cpu")
    assert dataclasses.asdict(back.config) == dataclasses.asdict(jm.config)
    _graphs_equal(back.graph, jm.graph)
    np.testing.assert_array_equal(back.silence_pdfs, jm.silence_pdfs)


@pytest.mark.parametrize("extra", ["rescore.arpa", "rnnlm", "ivector"])
def test_unported_model_parts_raise(tmp_path, extra):
    """A native TDNN-F with an i-vector input (an `ivector/` dir beside it is
    not read, as in the source) raises when its AM is built.  Rescoring
    resources load as the source loads them (they raised before the
    rescoring slice): g.npz with rescore.arpa, or with a GRU rnnlm/.  Kaldi
    directories with i-vectors load (tests/test_torch_kaldi_e2e.py)."""
    from vosk_tpu.models.rnnlm import RnnlmModel as JRnnlm
    from vosk_tpu_torch.utils import kaldidata

    m = benchdata.make_bench_model(num_states=500, num_pdfs=20, hidden=16,
                                   max_active=100, num_words=10, device="cpu")
    if extra == "ivector":
        m.config.am["ivector_dim"] = 4
    native.save_model(tmp_path, m.config, m.am_params, m.graph, m.words,
                      m.phones, m.phone_of_pdf, m.silence_pdfs)
    if extra == "ivector":
        (tmp_path / extra).mkdir()
        with pytest.raises(NotImplementedError):
            native.load_model(tmp_path, device="cpu").make_am()
        return
    kaldidata.write_native_rescoring(m, tmp_path, seed=1, rnnlm_dims=(3, 4),
                                     num_bigrams=20, num_trigrams=10)
    (tmp_path / ("rnnlm" if extra == "rescore.arpa" else "rescore.arpa")).rename(
        tmp_path / "unused")
    t, j = native.load_model(tmp_path, device="cpu"), j_native.load_model(tmp_path)
    _fsts_equal(t.g_fst, j.g_fst)
    if extra == "rescore.arpa":
        assert t.rnnlm is None is j.rnnlm
        assert (t.rescore_lm.ngrams, t.rescore_lm.backoffs) == (j.rescore_lm.ngrams,
                                                                j.rescore_lm.backoffs)
    else:
        assert t.rescore_lm is None is j.rescore_lm
        assert t.rnnlm.cfg.vocab_size == j.rnnlm.cfg.vocab_size == len(m.words)
        for k, v in JRnnlm.load(tmp_path / "rnnlm").params.items():
            np.testing.assert_array_equal(t.rnnlm.params[k].numpy(), np.asarray(v))


def _lattices_equal(a, b):
    assert a.num_nodes == b.num_nodes
    assert a.final == b.final and a.node_frame == b.node_frame
    assert a.out == b.out and a.in_ == b.in_
    assert [dataclasses.astuple(x) for x in a.arcs] == [dataclasses.astuple(x) for x in b.arcs]


def _split_records(recs, t):
    """A [T, B, ...] record chunk cut at frame t: (head, tail)."""
    return [{k: v[:t] for k, v in recs.items()}], [{k: v[t:] for k, v in recs.items()}]


@pytest.fixture(scope="module")
def lattices(decoded):
    """Per channel, (port, source) lattice triples: the whole chunk, and
    its two halves spliced at a fold boundary after frame 5."""
    jd, jrecs, jf, td, trecs, tf = decoded
    out = []
    for ch in range(2):
        pair = []
        for mod, d, recs, fr in ((lattice, td, trecs, tf), (j_lattice, jd, jrecs, jf)):
            whole, _ = mod.build_lattice(recs, fr, ch, d)
            head, tail = _split_records(recs[0], 6)
            st = np.asarray(head[0]["state"][-1, ch]).copy()
            co = np.asarray(head[0]["f_cost"][-1, ch]).copy()
            pre, slots = mod.build_lattice(
                head, {"state": st[None], "cost": co[None]}, 0, d, use_final=False)
            init_map = {}
            post, _ = mod.build_lattice(tail, fr, ch, d, init_override=(st, co),
                                        init_map_out=init_map)
            spliced, nmap = mod.splice_lattices(pre, slots, post, init_map, frame_offset=6)
            pair.append((whole, spliced, nmap))
        out.append(pair)
    return out


def test_build_and_splice_lattice_copy(lattices):
    for (tw, ts, tmap), (jw, js, jmap) in lattices:
        _lattices_equal(tw, jw)
        _lattices_equal(ts, js)
        assert tmap == jmap
        assert tw.arcs and any(a.olabel for a in ts.arcs)


@pytest.mark.parametrize("which", [0, 1])
def test_lattice_algebra_copy(lattices, which):
    """prune, arc_posteriors, nbest, shortest, path_words and scale_graph
    of the copy on the whole and the spliced lattice."""
    for pair in lattices:
        t, j = pair[0][which].copy(), pair[1][which].copy()
        assert t.shortest() == j.shortest()
        tmap, jmap = [], []
        tp, jp = t.prune(2.0, node_map_out=tmap), j.prune(2.0, node_map_out=jmap)
        _lattices_equal(tp, jp)
        assert tmap == jmap
        np.testing.assert_array_equal(tp.arc_posteriors(), jp.arc_posteriors())
        np.testing.assert_array_equal(tp.arc_posteriors(0.5), jp.arc_posteriors(0.5))
        tn, jn = tp.nbest(5), jp.nbest(5)
        assert tn == jn and tn
        assert [tp.path_words(p) for _, p in tn] == [jp.path_words(p) for _, p in jn]
        _lattices_equal(tp.scale_graph(0.9), jp.scale_graph(0.9))


def test_mbr_decode_copy(lattices):
    for pair in lattices:
        for which in (0, 1):
            t = pair[0][which].copy().scale_graph(0.9).prune(6.0)
            j = pair[1][which].copy().scale_graph(0.9).prune(6.0)
            (tw, tbins), (jw, jbins) = mbr.mbr_decode(t), j_mbr.mbr_decode(j)
            assert tw == jw and tw
            assert ([dataclasses.astuple(x) for x in tbins]
                    == [dataclasses.astuple(x) for x in jbins])


def test_finish_lattice_matches_source(decoded, lattices):
    """The port's Python finishing on a built lattice gives the source's
    items (word-boundary realignment included)."""
    from types import SimpleNamespace

    from vosk_tpu.runtime.finishing import Finisher as JFinisher
    from vosk_tpu_torch.runtime.finishing import Finisher

    jd, _, _, td, _, _ = decoded
    wb = {1: "singleton"}
    tm = SimpleNamespace(config=SimpleNamespace(lattice_beam=6.0), silence_pdfs=SIL,
                         phone_of_pdf=np.arange(64) % 3, word_boundary=wb,
                         g_fst=None, rescore_lm=None, rnnlm=None, rnnlm_rescorer=None)
    jm = SimpleNamespace(config=SimpleNamespace(lattice_beam=6.0), silence_pdfs=SIL,
                         phone_of_pdf=np.arange(64) % 3, word_boundary=wb,
                         g_fst=None, rescore_lm=None, rnnlm=None)
    for pair in lattices:
        for which in (0, 1):
            for n in (1, 3):
                got = Finisher(tm, td).finish_lattice(pair[0][which].copy(), n)
                want = JFinisher(jm, jd).finish_lattice(pair[1][which].copy(), n)
                assert got == want and got


@pytest.mark.parametrize("chunk", [1, 37, 1600])
def test_resampler_copy(chunk):
    """Chunked streaming equals one shot, and both equal the source."""
    rng = np.random.default_rng(chunk)
    wave = (rng.standard_normal(8000) * 1000).astype(np.float32)
    for rin, rout in ((8000, 16000), (44100, 16000), (16000, 16000)):
        r = resample.StreamingResampler(rin, rout)
        parts = [r.process(wave[i: i + chunk]) for i in range(0, len(wave), chunk)]
        streamed = np.concatenate(parts + [r.flush()])
        one = resample.resample_offline(wave, rin, rout)
        np.testing.assert_array_equal(streamed, one)
        np.testing.assert_array_equal(one, j_resample.resample_offline(wave, rin, rout))


def test_realign_items_copy():
    phone_of_pdf = np.array([0, 1, 2, 3, 4, 5])
    wb = {1: "begin", 2: "internal", 3: "end", 4: "singleton", 0: "nonword"}
    items = [(7, 0, 3, 0.5), (8, 3, 9, 1.0)]
    for pdfs in ([0, 1, 2, 3, 3, 4, 4, 0, 0], [1, 1, 3, 0, 4, 0, 0, 0, 0],
                 [1, 2, 2, 3, 0, 0, 0, 0, 0], [4, 4, 1, 9, 3, 0, 0, 0, 0]):
        for w in (wb, None, {}):
            assert (wordalign.realign_items(items, pdfs, phone_of_pdf, w)
                    == j_wordalign.realign_items(items, pdfs, phone_of_pdf, w))
        assert (wordalign.word_spans(pdfs, phone_of_pdf, wb)
                == j_wordalign.word_spans(pdfs, phone_of_pdf, wb))


def _lexicon(mod_builder, mod_syms, label_last):
    words = mod_syms(["<eps>", "a", "b", "c", "d"])
    phones = mod_syms(["<eps>", "SIL", "p", "q", "r"])
    prons = {1: [[2, 3]], 2: [[3]], 3: [[4, 2], [4]], 4: [[2, 3, 4]]}
    return mod_builder.Lexicon(words=words, phones=phones, prons=prons,
                               silence_phone=1, label_last=label_last)


def _fsts_equal(a, b):
    assert (a.arcs, a.final, a.start) == (b.arcs, b.final, b.start)


@pytest.mark.parametrize("phrases", [["a b", "c d a"], ["a nosuch b"], ["d"]])
def test_grammar_to_fst_copy(phrases):
    find = SymbolTable(["<eps>", "a", "b", "c", "d"]).find
    _fsts_equal(lm.grammar_to_fst(phrases, find), j_lm.grammar_to_fst(phrases, find))


@pytest.mark.parametrize("label_last, states", [(False, 1), (True, 2)])
def test_build_decoding_graph_copy(label_last, states):
    from vosk_tpu.graph.fst import SymbolTable as JS

    phrases = ["a b", "c d a", "b"]
    find = SymbolTable(["<eps>", "a", "b", "c", "d"]).find
    g, info = builder.build_decoding_graph(
        _lexicon(builder, SymbolTable, label_last), lm.grammar_to_fst(phrases, find),
        builder.Topology(states_per_phone=states))
    jg, jinfo = j_builder.build_decoding_graph(
        _lexicon(j_builder, JS, label_last), j_lm.grammar_to_fst(phrases, find),
        j_builder.Topology(states_per_phone=states))
    _graphs_equal(g, jg)
    assert info == jinfo


@pytest.mark.parametrize("seed", [0, 3])
def test_make_plausible_loglikes_copy(small_graph, seed):
    a = benchdata.make_plausible_loglikes(small_graph, 64, 3, 40, snr=2.0, seed=seed)
    b = j_bench.make_plausible_loglikes(small_graph, 64, 3, 40, snr=2.0, seed=seed)
    assert a.dtype == b.dtype and a.shape == (40, 3, 64)
    np.testing.assert_array_equal(a, b)


def test_native_dir_with_lexicon_roundtrips_both_ways(tmp_path):
    from vosk_tpu.graph.fst import SymbolTable as JS

    m = benchdata.make_bench_model(num_states=500, num_pdfs=20, hidden=16,
                                   max_active=100, num_words=10, device="cpu")
    lex, topo = _lexicon(builder, SymbolTable, True), builder.Topology(2, 0.6)
    native.save_model(tmp_path / "m", m.config, m.am_params, m.graph, lex.words,
                      lex.phones, m.phone_of_pdf, m.silence_pdfs,
                      lexicon=lex, topology=topo)
    jm = j_native.load_model(tmp_path / "m")
    assert jm.lexicon.prons == lex.prons
    assert (jm.lexicon.silence_phone, jm.lexicon.silence_cost) == (1, lex.silence_cost)
    assert dataclasses.asdict(jm.topology) == dataclasses.asdict(topo)
    jlex = _lexicon(j_builder, JS, True)
    j_native.save_model(tmp_path / "j", jm.config, jm.am_params, jm.graph, jm.words,
                        jm.phones, jlex, jm.phone_of_pdf, jm.silence_pdfs,
                        topology=j_builder.Topology(2, 0.6))
    back = native.load_model(tmp_path / "j", device="cpu")
    assert back.lexicon.prons == jlex.prons
    assert dataclasses.asdict(back.topology) == dataclasses.asdict(topo)
    assert back.find_word("c") == jm.find_word("c") == 3
    assert native.load_any(tmp_path / "j", device="cpu").lexicon.prons == jlex.prons


def test_stage_timers_and_logging_copy(capsys):
    from vosk_tpu.utils import logging as j_logging
    from vosk_tpu_torch.utils import logging as t_logging
    from vosk_tpu_torch.utils.metrics import StageTimers

    t = StageTimers()
    with t.timer("decoder"):
        pass
    t.add_audio(0.2)
    rep = t.report()
    assert rep["stages"]["decoder"]["calls"] == 1 and rep["audio_seconds"] == 0.2
    for level in (0, -1):
        t_logging.set_log_level(level)
        j_logging.set_log_level(level)
        t_logging.log_warn("x")
        tw = capsys.readouterr().err
        j_logging.log_warn("x")
        assert tw == capsys.readouterr().err
    t_logging.set_log_level(0)
    j_logging.set_log_level(0)


# ---- the Kaldi model-directory slice: option files, Kaldi binary I/O,
# OpenFST graphs (vector, const, ngram), split-graph composition, the
# nnet3 parser/writer, the exporter and the loader


def test_config_copy():
    from vosk_tpu.utils import config as j_config
    from vosk_tpu_torch.utils import config

    text = ("# comment\n--beam=11.5  # trailing\nmax-active=300\n--flag\n"
            "--endpoint.silence-phones=1:2:3\n\n--frame-subsampling-factor=2\n")
    assert config.parse_config_lines(text) == j_config.parse_config_lines(text)
    raw = config.parse_config_lines(text)
    from vosk_tpu.io.kaldi_loader import DecodeOptions as JOpts
    from vosk_tpu_torch.io.kaldi_loader import DecodeOptions

    a, b = DecodeOptions(), JOpts()
    config.apply_options(a, raw)
    j_config.apply_options(b, raw)
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert (a.beam, a.max_active, a.frame_subsampling_factor) == (11.5, 300, 2)


def test_kaldiio_copy():
    import io as _io

    from vosk_tpu.io import kaldiio as j_kio
    from vosk_tpu_torch.io import kaldiio

    rng = np.random.default_rng(0)
    m = rng.standard_normal((12, 5)).astype(np.float32)
    bufs = []
    for mod in (kaldiio, j_kio):
        buf = _io.BytesIO()
        w = mod.BinaryWriter(buf)
        w.write_token("<T>")
        w.write_basic_int(-7)
        w.write_basic_float(0.125)
        w.write_bool(True)
        w.write_int_vector([3, -1, 9])
        w.write_vector(m[0])
        w.write_matrix(m)
        for fmt in (1, 2, 3):
            w.write_compressed_matrix(m, fmt)
        bufs.append(buf.getvalue())
    assert bufs[0] == bufs[1]
    reads = []
    for mod in (kaldiio, j_kio):
        r = mod.BinaryReader(_io.BufferedReader(_io.BytesIO(bufs[0])))
        reads.append([r.read_token(), r.read_basic_int(), r.read_basic_float(),
                      r.read_bool(), r.read_int_vector(), r.read_vector(),
                      r.read_matrix(), r.read_matrix(), r.read_matrix(), r.read_matrix()])
    for x, y in zip(*reads):
        if isinstance(y, np.ndarray):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)
        else:
            assert x == y


def _std_fst(mod, seed=0, states=6):
    rng = np.random.default_rng(seed)
    f = mod.StdFst()
    f.add_states(states)
    f.set_start(0)
    f.set_final(states - 1, 0.5)
    for s in range(states):
        for _ in range(int(rng.integers(0, 4))):
            f.add_arc(s, int(rng.integers(0, 9)), int(rng.integers(0, 5)),
                      float(np.float32(rng.uniform(0, 3))), int(rng.integers(0, states)))
    return f


def _write_const_fst(path, fst):
    """An OpenFST ConstFst over StdArc (16-byte aligned states then arcs)."""
    import struct

    arcs = [a for s in range(fst.num_states) for a in fst.arcs[s]]
    with open(path, "wb") as f:
        f.write(struct.pack("<i", 2125659606))
        for s in ("const", "standard"):
            f.write(struct.pack("<i", len(s)) + s.encode())
        f.write(struct.pack("<iiQqqq", 2, 0, 0, fst.start, fst.num_states, len(arcs)))
        f.write(b"\0" * (-f.tell() % 16))
        pos = 0
        for s in range(fst.num_states):
            f.write(struct.pack("<fiii", fst.final[s], pos, len(fst.arcs[s]), 0))
            pos += len(fst.arcs[s])
        f.write(b"\0" * (-f.tell() % 16))
        for il, ol, w, ns in arcs:
            f.write(struct.pack("<iifi", il, ol, w, ns))


def _write_ngram_fst(path):
    """A three-state NGramFst (the fixture of tests/test_ngram_fst.py)."""
    import struct

    def words(bits):
        b = np.concatenate([np.asarray(bits, np.uint8), np.zeros((-len(bits)) % 64, np.uint8)])
        return np.packbits(b, bitorder="little").view("<u8").tobytes()

    with open(path, "wb") as f:
        f.write(struct.pack("<i", 2125659606))
        for s in ("ngram", "standard"):
            f.write(struct.pack("<i", len(s)) + s.encode())
        f.write(struct.pack("<iiQqqq", 1, 0, 0, 0, 3, 0))
        f.write(struct.pack("<QQQ", 3, 3, 2))
        f.write(words([1, 0, 1, 1, 0, 0, 0]) + words([0, 1, 1, 0, 1, 0, 0])
                + words([0, 1, 1, 0]))
        f.write(np.asarray([0, 1, 2], "<i4").tobytes() + np.asarray([1, 2, 2], "<i4").tobytes())
        f.write(np.asarray([0.0, 0.5, 0.7, 0.9, 1.1, 0.1, 0.2, 0.3], "<f4").tobytes())


@pytest.mark.parametrize("kind", ["vector", "const", "ngram"])
def test_read_fst_copy(tmp_path, kind):
    from vosk_tpu.graph import fst as j_fst
    from vosk_tpu.io import kaldi_models as j_km
    from vosk_tpu_torch.graph import fst as t_fst
    from vosk_tpu_torch.io import kaldi_export, kaldi_models

    path = tmp_path / "g.fst"
    if kind == "vector":
        kaldi_export.write_fst_vector(path, _std_fst(t_fst))
    elif kind == "const":
        _write_const_fst(path, _std_fst(j_fst))
    else:
        _write_ngram_fst(path)
    a, b = kaldi_models.read_fst(path), j_km.read_fst(path)
    assert a.start == b.start
    np.testing.assert_array_equal(a.finals, b.finals)
    assert len(a.arcs_per_state) == len(b.arcs_per_state)
    for x, y in zip(a.arcs_per_state, b.arcs_per_state):
        np.testing.assert_array_equal(x, y)
    _fsts_equal(kaldi_models.raw_fst_to_std(a), j_km.raw_fst_to_std(b))
    assert sum(len(x) for x in a.arcs_per_state) > 0


def _lexicon_models(tmp_path):
    """The same small model in both packages (one phone per pdf, a lexicon,
    a phrase-list G and the decoding graph built from them), in the layout
    the Kaldi exporters take."""
    from vosk_tpu.graph.fst import SymbolTable as JS
    from vosk_tpu.models.tdnnf import TdnnfConfig as JCfg
    from vosk_tpu_torch.models.tdnnf import TdnnfConfig, init_params

    phrases = ["a b", "c d a", "b", "d c"]
    out = []
    for mb, mlm, mnat, Syms in ((builder, lm, native, SymbolTable),
                                (j_builder, j_lm, j_native, JS)):
        lex = _lexicon(mb, Syms, False)
        g = mlm.grammar_to_fst(phrases, lex.words.find)
        topo = mb.Topology(1, 0.6)
        graph, _ = mb.build_decoding_graph(lex, g, topo)
        P = len(lex.phones) - 1
        cfg = TdnnfConfig(feat_dim=13, hidden_dim=16, bottleneck_dim=8, prefinal_dim=8,
                          num_pdfs=P, time_strides=(1, 0, 3))
        params = init_params(cfg, seed=4)
        config = mnat.ModelConfig(am=dataclasses.asdict(cfg), beam=11.0, max_active=200,
                                  frame_opts={"dither": 0.0}, mfcc_opts={"num_ceps": 13})
        kw = dict(config=config, am_params=params, graph=graph, words=lex.words,
                  phones=lex.phones, lexicon=lex, phone_of_pdf=np.arange(1, P + 1),
                  silence_pdfs=np.array([0], np.int32), topology=topo)
        m = mnat.NativeModel(**kw, **({"device": "cpu"} if mnat is native else {}))
        if mnat is j_native:
            assert dataclasses.asdict(m.am_config) == dataclasses.asdict(JCfg(**config.am))
        m.g_fst = g
        m.word_boundary = {1: "nonword", 2: "singleton", 3: "singleton", 4: "singleton"}
        out.append(m)
    return out


@pytest.fixture(scope="module")
def kaldi_dirs(tmp_path_factory):
    """Both exporters' HCLG and split-graph directories of the same model."""
    from vosk_tpu.io import kaldi_export as j_export
    from vosk_tpu_torch.io import kaldi_export

    root = tmp_path_factory.mktemp("kaldi_copies")
    tm, jm = _lexicon_models(root)
    for name, mod, m in (("t", kaldi_export, tm), ("j", j_export, jm)):
        mod.export_kaldi_dir(m, root / f"{name}_hclg")
        mod.export_kaldi_split_dir(m, root / f"{name}_split")
    return root


def test_kaldi_export_copy_byte_identical(kaldi_dirs):
    for layout in ("hclg", "split"):
        t, j = kaldi_dirs / f"t_{layout}", kaldi_dirs / f"j_{layout}"
        files = sorted(p.relative_to(j) for p in j.rglob("*") if p.is_file())
        assert files == sorted(p.relative_to(t) for p in t.rglob("*") if p.is_file())
        assert len(files) >= 6
        for f in files:
            assert (t / f).read_bytes() == (j / f).read_bytes(), f


@pytest.mark.parametrize("layout", ["hclg", "split"])
def test_kaldi_loader_copy(kaldi_dirs, layout):
    from vosk_tpu.io.kaldi_loader import load_kaldi_model as j_load
    from vosk_tpu_torch.io.kaldi_loader import load_kaldi_model

    path = kaldi_dirs / f"j_{layout}"
    a, b = load_kaldi_model(path, device="cpu"), j_load(path)
    _graphs_equal(a.graph, b.graph)
    assert dataclasses.asdict(a.config) == dataclasses.asdict(b.config)
    np.testing.assert_array_equal(a.phone_of_pdf, b.phone_of_pdf)
    np.testing.assert_array_equal(a.silence_pdfs, b.silence_pdfs)
    np.testing.assert_array_equal(a.tid2pdf, b.tid2pdf)
    assert a.word_boundary == b.word_boundary and a.word_boundary
    assert a.disambig_tids == b.disambig_tids
    assert (a.silence_weight, a.silence_weight_phones) == (b.silence_weight,
                                                           b.silence_weight_phones)
    assert (a.hcl_fst is None) == (b.hcl_fst is None) == (layout == "hclg")
    am, jam = a.make_am(), b.make_am()
    assert (am.left_context, am.right_context, am.subsample) == (
        jam.left_context, jam.right_context, jam.subsample)
    assert am.net.node_order == jam.net.node_order
    for name, comp in jam.net.components.items():
        assert type(am.net.components[name]).__name__ == type(comp).__name__
        for k, v in vars(comp).items():
            if isinstance(v, np.ndarray):
                np.testing.assert_array_equal(getattr(am.net.components[name], k), v)
    if layout == "split":
        from vosk_tpu.graph import lookahead as j_la
        from vosk_tpu_torch.graph import lookahead

        for phrases in (["a b"], ["c", "d a b"]):
            g = lm.grammar_to_fst(phrases, a.words.find)
            jg = j_lm.grammar_to_fst(phrases, b.words.find)
            _graphs_equal(
                lookahead.prepare_decode_fst(
                    lookahead.lookahead_compose(a.hcl_fst, g, a.disambig_tids), a.tid2pdf),
                j_la.prepare_decode_fst(
                    j_la.lookahead_compose(b.hcl_fst, jg, b.disambig_tids), b.tid2pdf))


def test_kaldi_word_boundary_and_conf_copies(tmp_path):
    from vosk_tpu.io import kaldi_loader as j_kl
    from vosk_tpu_torch.io import kaldi_loader

    (tmp_path / "wb.int").write_text("1 nonword\n2 begin\n3 end\n\n4 singleton extra\n")
    assert kaldi_loader.read_word_boundary(tmp_path / "wb.int") == \
        j_kl.read_word_boundary(tmp_path / "wb.int")
    raw = {"dither": "0", "frame-length": "25", "frame-shift": "10",
           "preemphasis-coefficient": "0.97", "remove-dc-offset": "false",
           "window-type": "hamming", "snip-edges": "true", "num-mel-bins": "40",
           "low-freq": "20", "high-freq": "-400", "num-ceps": "40"}
    assert kaldi_loader._frame_opts(raw) == j_kl._frame_opts(raw)
    assert kaldi_loader._mel_opts(raw) == j_kl._mel_opts(raw)
    assert kaldi_loader.is_kaldi_model_dir(tmp_path) == j_kl.is_kaldi_model_dir(tmp_path)


# ---- the pitch and speaker slice: the pitch tables, the pitch-conf key
# map, the statistics components' readers and writers, the speaker-dir
# exporter


@pytest.mark.parametrize("opts", [{}, {"min_f0": 70.0, "max_f0": 330.0, "penalty_factor": 0.2},
                                  {"sample_rate": 8000.0, "mean_window": 51}])
def test_pitch_tables_copy(opts):
    from vosk_tpu.ops import pitch as j_pitch
    from vosk_tpu_torch.ops import pitch

    assert dataclasses.asdict(pitch.PitchOptions(**opts)) == dataclasses.asdict(
        j_pitch.PitchOptions(**opts))
    t = pitch.StreamingPitch(pitch.PitchOptions(**opts), device="cpu")
    j = j_pitch.StreamingPitch(j_pitch.PitchOptions(**opts))
    for k in ("R", "sh16", "ws16", "sh4", "ws4", "min_lag", "max_lag", "L", "MW", "W16", "la16"):
        assert getattr(t, k) == getattr(j, k), k
    for k in ("fir", "lags_s", "neg_log_lags", "trans", "lag_bias"):
        a, b = getattr(t, k), getattr(j, k)
        assert a.dtype == b.dtype, k
        np.testing.assert_array_equal(a, b, err_msg=k)
    np.testing.assert_array_equal(t._trans.numpy(), j.trans)


def test_pitch_conf_copy(kaldi_dirs, tmp_path):
    import shutil

    from vosk_tpu.io.kaldi_loader import load_kaldi_model as j_load
    from vosk_tpu_torch.io.kaldi_loader import load_kaldi_model

    path = tmp_path / "pitch"
    shutil.copytree(kaldi_dirs / "j_hclg", path)
    (path / "conf" / "pitch.conf").write_text(
        "--sample-frequency=16000\n--min-f0=60\n--max-f0=380\n--penalty-factor=0.05\n"
        "--nccf-ballast=5000\n--resample-frequency=4000\n--frame-shift=10\n"
        "--frame-length=25\n--delta-pitch=0.005\n")
    a, b = load_kaldi_model(path, device="cpu"), j_load(path)
    assert a.config.pitch_opts == b.config.pitch_opts and len(a.config.pitch_opts) == 7
    assert dataclasses.asdict(a.config) == dataclasses.asdict(b.config)


def test_statistics_components_io_copy():
    import io as _io

    from vosk_tpu.io import kaldiio as j_kio
    from vosk_tpu.io import nnet3 as j3
    from vosk_tpu_torch.io import kaldiio
    from vosk_tpu_torch.io import nnet3 as t3

    for args_ex, args_pool in (((7, 1, 1, True), (15, 1, 0, 10000, 0, True, 1e-10)),
                               ((3, 2, 3, False), (4, 2, -30, 30, 2, False, 0.5))):
        blobs = []
        for mod, kio in ((t3, kaldiio), (j3, j_kio)):
            buf = _io.BytesIO()
            w = kio.BinaryWriter(buf)
            mod.StatisticsExtractionComponent(*args_ex).write(w)
            mod.StatisticsPoolingComponent(*args_pool).write(w)
            blobs.append(buf.getvalue())
        assert blobs[0] == blobs[1]
        for mod, kio in ((t3, kaldiio), (j3, j_kio)):
            r = kio.BinaryReader(_io.BufferedReader(_io.BytesIO(blobs[0])))
            ex, pool = mod.read_component(r), mod.read_component(r)
            assert (ex.input_dim, ex.input_period, ex.output_period,
                    ex.include_variance) == args_ex
            assert (pool.input_dim, pool.input_period, pool.left_context, pool.right_context,
                    pool.num_log_count, pool.output_stddevs) == args_pool[:6]
            assert pool.variance_floor == pytest.approx(args_pool[6], rel=1e-7)
            assert (ex.output_dim(), pool.output_dim()) == (1 + args_ex[0] * (
                2 if args_ex[3] else 1), args_pool[4] + args_pool[0] - 1)


def test_export_kaldi_spk_model_copy(tmp_path):
    from vosk_tpu.models import xvector as jx
    from vosk_tpu_torch.models import xvector as tx

    cfg = dict(feat_dim=12, hidden_dim=10, embed_dim=6, num_layers=3, context=1)
    params = tx.init_xvector_params(tx.XvectorConfig(**cfg), seed=4)
    jparams = jx.init_xvector_params(jx.XvectorConfig(**cfg), seed=4)
    assert params.keys() == jparams.keys()
    for k in params:
        np.testing.assert_array_equal(params[k], jparams[k])
    rng = np.random.default_rng(2)
    mean, transform = rng.standard_normal(6).astype(np.float32), rng.standard_normal(
        (4, 6)).astype(np.float32)
    tx.export_kaldi_spk_model(tx.SpkModel(tx.XvectorConfig(**cfg), params, mean, transform,
                                          device="cpu"), tmp_path / "t")
    jx.export_kaldi_spk_model(jx.SpkModel(jx.XvectorConfig(**cfg), jparams, mean, transform),
                              tmp_path / "j")
    files = sorted(p.name for p in (tmp_path / "j").iterdir())
    assert files == sorted(p.name for p in (tmp_path / "t").iterdir()) and len(files) == 4
    for f in files:
        assert (tmp_path / "t" / f).read_bytes() == (tmp_path / "j" / f).read_bytes(), f


# ------------------------------------------- entry points (server, CLI, C ABI)

REPO = Path(__file__).resolve().parents[1]


def _code_changes(src, port):
    """(lines only in src, lines only in port) of two Python modules, each
    past its docstring, with vosk_tpu_torch read as vosk_tpu."""
    def code(path):
        text = (REPO / path).read_text()
        return text[text.index("from __future__"):].replace("vosk_tpu_torch",
                                                            "vosk_tpu").splitlines()
    diff = list(difflib.ndiff(code(src), code(port)))
    return ([x[2:] for x in diff if x[:1] == "-"], [x[2:] for x in diff if x[:1] == "+"])


DEVICE_FLAG = ('    p.add_argument("--device", default="cuda", help="torch device of the model '
               '(cuda, cpu)")')
COPIES = {  # the port's copy: (its source, the only lines changed, the only lines added)
    "server/wsproto.py": ("server/wsproto.py", [], []),
    "server/ws.py": ("server/ws.py", [
        "        model_path=args.model, model_name=args.model_name, lang=args.lang"], [
        "        model_path=args.model, model_name=args.model_name, lang=args.lang,",
        "        device=args.device,", DEVICE_FLAG]),
    "transcriber/transcriber.py": ("transcriber/transcriber.py", [
        "                model_path=args.model, model_name=args.model_name, lang=args.lang"], [
        "                model_path=args.model, model_name=args.model_name, lang=args.lang,",
        '                device=getattr(args, "device", "cuda"),']),
    "transcriber/cli.py": ("transcriber/cli.py", [], [DEVICE_FLAG[4:].replace(
        "p.add_argument", "parser.add_argument")]),
}


@pytest.mark.parametrize("copy", list(COPIES))
def test_entry_point_copies_differ_only_in_the_device(copy):
    """The server, wsproto, transcriber and CLI copies are their sources but
    for the package they import and the model's device."""
    src, removed, added = COPIES[copy]
    assert _code_changes(f"vosk_tpu/{src}", f"vosk_tpu_torch/{copy}") == (removed, added)


TRAINING_COPIES = {  # the training path's host copies, as COPIES
    "utils/wer.py": ("utils/wer.py", [], []),
    "training/gmm.py": ("training/gmm.py", [
        "    feats = [np.asarray(extractor.extract(w[None]))[0] for w in utt_wavs]"], [
        "    feats = [extractor.extract(w[None])[0].cpu().numpy() for w in utt_wavs]"]),
}


@pytest.mark.parametrize("copy", list(TRAINING_COPIES))
def test_training_copies_differ_only_where_stated(copy):
    """wer.py is its source; gmm.py is its source but for bringing the
    port's features (a tensor on the extractor's device) to the host."""
    src, removed, added = TRAINING_COPIES[copy]
    assert _code_changes(f"vosk_tpu/{src}", f"vosk_tpu_torch/{copy}") == (removed, added)


TOY_SYNTHESIS = ("RATE", "PHONE_DUR", "TONE_FREQS", "WORDS", "WORD_PHONES", "SIL_PHONE",
                 "build_symbols", "synth_phone", "synth_utterance", "ToyLanguage",
                 "build_big_language", "synth_phone_lang", "synth_utterance_lang",
                 "make_test_wav")


def _top_level(path, names):
    """{name: source text} of the top-level definitions and assignments of
    a module that bear the given names."""
    text = (REPO / path).read_text()
    out = {}
    for node in ast.parse(text).body:
        targets = ([t.id for t in node.targets if isinstance(t, ast.Name)]
                   if isinstance(node, ast.Assign) else [getattr(node, "name", None)])
        for name in targets:
            if name in names:
                out[name] = ast.get_source_segment(text, node)
    return out


def test_toydata_synthesis_copy_is_its_source():
    """The toy corpus synthesis in the port's utils/toydata.py (symbols,
    phone and utterance synthesis, the generated language, the test WAV)
    is its source's text."""
    port = _top_level("vosk_tpu_torch/utils/toydata.py", TOY_SYNTHESIS)
    assert set(port) == set(TOY_SYNTHESIS)
    assert port == _top_level("vosk_tpu/utils/toydata.py", TOY_SYNTHESIS)


def _c_code(path):
    """A C++ source without its comments, vosk_tpu_torch read as vosk_tpu."""
    text = re.sub(r"//[^\n]*|/\*.*?\*/", "", (REPO / path).read_text(), flags=re.S)
    return [x.rstrip() for x in text.replace("vosk_tpu_torch", "vosk_tpu").splitlines()
            if x.strip()]


def test_c_abi_copy_differs_only_in_module_and_device():
    """vosk_tpu_torch/cabi/vosk_api.cc is core/src/vosk_api.cc but for the
    module it imports and the device its models get (the with_device
    helper, in place of three class lookups)."""
    port = "\n".join(_c_code("vosk_tpu_torch/cabi/vosk_api.cc"))
    helper = re.search(r"\nPyObject \*with_device\(const char \*name\) \{\n.*?\n\}", port,
                       re.S)
    assert helper and 'getenv("VOSK_TPU_TORCH_DEVICE")' in helper.group(0)
    assert '"cuda"' in helper.group(0) and '"device"' in helper.group(0)
    port = port.replace(helper.group(0), "").splitlines()
    diff = list(difflib.ndiff(_c_code("core/src/vosk_api.cc"), port))
    removed = [x[2:].strip() for x in diff if x[:1] == "-"]
    added = [x[2:].strip() for x in diff if x[:1] == "+"]
    names = ("Model", "SpkModel", "BatchModel")
    assert removed == [f'PyObject *cls = PyObject_GetAttrString(g_module, "{n}");'
                       for n in names]
    assert added == [f'PyObject *cls = with_device("{n}");' for n in names]


def test_read_wav_copy(tmp_path):
    from vosk_tpu.io.wav import read_wav as j_read
    from vosk_tpu_torch.io.wav import read_wav

    rng = np.random.default_rng(3)
    for width, nch in ((2, 1), (2, 2), (4, 1), (1, 2)):
        path = tmp_path / f"{width}_{nch}.wav"
        with wave.open(str(path), "wb") as w:
            w.setnchannels(nch)
            w.setsampwidth(width)
            w.setframerate(8000)
            w.writeframes(rng.integers(0, 256, 999 * width * nch, dtype=np.uint8).tobytes())
        for mono in (True, False):
            (a, ra), (b, rb) = read_wav(path, mono), j_read(path, mono)
            np.testing.assert_array_equal(a, b)
            assert ra == rb == 8000


def test_wsproto_copy_speaks_to_the_source():
    """The port's client against the source's server and the source's client
    against the port's: text and binary frames of every length class, each
    echoed back unchanged."""
    from vosk_tpu.server import wsproto as j_ws
    from vosk_tpu_torch.server import wsproto as t_ws

    rng = np.random.default_rng(5)
    msgs = ["", "héllo", "x" * 126] + [rng.integers(0, 256, n, dtype=np.uint8).tobytes()
                                        for n in (0, 125, 126, 65535, 65536, 70001)]

    async def echo(ws):
        while True:
            try:
                await ws.send(await ws.recv())
            except t_ws.ConnectionClosed:
                return
            except j_ws.ConnectionClosed:
                return

    async def run(server_mod, client_mod):
        server = await server_mod.serve(echo, "127.0.0.1", 0)
        port = server.sockets[0].getsockname()[1]
        got = []
        async with client_mod.connect(f"ws://127.0.0.1:{port}") as ws:
            for m in msgs:
                await ws.send(m)
                got.append(await ws.recv())
        server.close()
        await server.wait_closed()
        return got

    for server_mod, client_mod in ((j_ws, t_ws), (t_ws, j_ws)):
        assert asyncio.run(run(server_mod, client_mod)) == msgs


def test_transcriber_output_copy():
    """srt / webvtt / txt composition of the same results."""
    from argparse import Namespace

    from vosk_tpu.transcriber import transcriber as jt
    from vosk_tpu_torch.transcriber import transcriber as tt

    words = [{"word": f"w{i}", "start": 0.37 * i, "end": 0.37 * i + 0.3, "conf": 1.0}
             for i in range(17)]
    results = [{"text": " ".join(w["word"] for w in words[:9]), "result": words[:9]},
               {"text": ""}, {"text": " ".join(w["word"] for w in words[9:]),
                              "result": words[9:]}]
    for fmt in ("txt", "srt", "webvtt"):
        args = Namespace(server="ws://unused", output_type=fmt)
        for res in (results, [{"text": ""}]):
            assert tt.Transcriber(args).format_result(res) == jt.Transcriber(
                args).format_result(res)
    subs = [(0.0, 1.25, "a b"), (3661.5, 3700.001, "c")]
    assert tt.compose_srt(subs) == jt.compose_srt(subs)
    assert tt.compose_webvtt(subs) == jt.compose_webvtt(subs)


def test_cli_parser_copy():
    """The port's CLI takes the source's arguments, with their defaults, and
    --device (default cuda)."""
    from vosk_tpu.transcriber import cli as jc
    from vosk_tpu_torch.transcriber import cli as tc

    def spec(p):
        return {a.dest: (tuple(a.option_strings), a.default, a.const, a.nargs, a.type)
                for a in p._actions}
    t, j = spec(tc.parser), spec(jc.parser)
    assert t.pop("device") == (("--device",), "cuda", None, None, None)
    assert t == j


def test_model_listing_copy(tmp_path, monkeypatch, capsys):
    """list_local_models and list_languages print what the source's print;
    list_languages reads the zoo index through the urlopen it is given."""
    import vosk_tpu
    import vosk_tpu_torch

    for name in ("vosk-model-small-en-us-0.15", "vosk-model-de-0.21", "other"):
        (tmp_path / name).mkdir()
    index = json.dumps([{"name": "a", "lang": "en-us"}, {"name": "b", "lang": "de"},
                        {"name": "c", "lang": "en-us"}, {"name": "d"}]).encode()

    asked = []

    def urlopen(url):
        asked.append(url)
        return io.BytesIO(index)

    outs = []
    for mod in (vosk_tpu, vosk_tpu_torch):
        monkeypatch.setattr(mod, "MODEL_DIRS", [None, tmp_path, tmp_path / "missing"])
        mod.list_local_models()
        langs = mod.list_languages(urlopen=urlopen)
        outs.append((capsys.readouterr().out, langs))
    assert outs[0] == outs[1] and outs[0][1] == ["?", "de", "en-us"]
    assert asked == [vosk_tpu.MODEL_LIST_URL, vosk_tpu_torch.MODEL_LIST_URL]


def _imports(path):
    """Every module a Python file imports (absolute names; relative ones as
    '.'), and every string passed to import_module / __import__."""
    tree = ast.parse(path.read_text())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names.append("." * node.level + (node.module or ""))
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(
                node.func, "id", None)) in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            names.append(node.args[0].value)
    return names


def test_port_imports_neither_jax_nor_vosk_tpu():
    """No module of vosk_tpu_torch, the C ABI it embeds, or chip_smoke.py
    imports jax or anything of vosk_tpu."""
    files = sorted((REPO / "vosk_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 60
    bad = {}
    for f in files:
        found = [n for n in _imports(f) if n.split(".")[0] in ("jax", "jaxlib", "vosk_tpu")]
        if found:
            bad[str(f.relative_to(REPO))] = found
    assert not bad, bad
    cc = (REPO / "vosk_tpu_torch" / "cabi" / "vosk_api.cc").read_text()
    assert set(re.findall(r'PyImport_ImportModule\("([^"]+)"\)', cc)) == {
        "vosk_tpu_torch", "numpy", "functools"}
