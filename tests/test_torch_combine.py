"""Combined steps of concurrent recognizers on one model, on the CPU.

Recognizers of one decoder that wait with a chunk at the same time step it
together (io/native.py `StepCombiner`, runtime/recognizer.py
`combined_step`), over STEP_ROWS rows whatever their number.  On the toy
model, its Kaldi export with an i-vector extractor grafted onto the AM
(tests/test_torch_kaldi_e2e.py) and a toy pitch model:

- a combined step's features, ll, frontier, records and host values equal
  each stream's own step, bit for bit, row by row (2, 3 and 4 streams);
- threads started behind a barrier, main-graph and grammar recognizers
  mixed, each give what vosk_tpu's recognizer gives that stream alone
  (the comparison of tests/test_torch_streaming.py);
- steps do combine streams, always at STEP_ROWS rows;
- a step that raises reaches every recognizer in it, and the next works;
- the turn goes in the order it was asked for, a step behind the calls
  already waiting for one, and behind the next call of a recognizer whose
  waiting call only buffered;
- a stream's retained record bytes are what it retains alone.
"""
import json
import sys
import threading

import numpy as np
import pytest
import torch

import vosk_tpu
import vosk_tpu_torch
from test_torch_kaldi_e2e import _graft_ivector
from test_torch_streaming import _assert_same, _drive, _pcm, _split, _wav
from vosk_tpu.io import native as j_native
from vosk_tpu.io.kaldi_export import export_kaldi_dir
from vosk_tpu.utils import toydata
from vosk_tpu_torch.runtime import native_lattice
from vosk_tpu_torch.runtime import recognizer as R


@pytest.fixture(scope="module", autouse=True)
def native_library():
    """Both packages finish lattices through core/libvosk_tpu_core.so."""
    return native_lattice.build_library()


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("combine")
    out = {"main": root / "toy", "ivector": root / "ivector", "pitch": root / "pitch"}
    toydata.build_toy_model(str(out["main"]), train_steps=400)
    toy = j_native.load_model(out["main"])
    export_kaldi_dir(toy, out["ivector"])
    _graft_ivector(toy, out["ivector"])
    # bit equality needs no trained AM
    toydata.build_toy_model(str(out["pitch"]), train_steps=20, pitch=True)
    return {k: str(v) for k, v in out.items()}


@pytest.fixture(scope="module")
def models(dirs):
    return vosk_tpu.Model(dirs["main"]), vosk_tpu_torch.Model(dirs["main"], device="cpu")


def _samples(words, seed):
    return np.clip(_wav(words, seed), -32768, 32767).astype(np.float32)


def _rows_equal(a, b):
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)


def _record_bytes(rec):
    return sum(v.untyped_storage().nbytes() for r in rec._records for v in r.values())


@pytest.mark.parametrize("which", ["main", "ivector", "pitch"])
@pytest.mark.parametrize("n", [2, 3, 4])
def test_combined_step_equals_each_stream_alone(dirs, which, n):
    """n streams step 4 chunks, the AM's flush and 2 more together, and each
    alone: every row of the combined step is its stream's own, bit for
    bit, and the stream retains the same records."""
    model = vosk_tpu_torch.Model(dirs[which], device="cpu")

    def recs():
        return [vosk_tpu_torch.KaldiRecognizer(model, 16000)._rec for _ in range(n)]

    together, alone = recs(), recs()
    assert (together[0].iv is not None) == (which == "ivector")
    assert (together[0].ex.pitch is not None) == (which == "pitch")
    S = together[0].chunk_samples
    waves = [_samples(toydata.WORDS[i: i + 3], 400 + i) for i in range(n)]
    for c in range(7):
        flush = c == 4

        def part(r, i):
            if flush:
                return R._Part(r)
            # a short last chunk in one stream, as at the end of its input
            chunk = waves[i][(c - (c > 4)) * S:][:S - 160 * i * (c == 6)]
            return R._Part(r, chunk, len(chunk))

        parts = [part(r, i) for i, r in enumerate(together)]
        got = R.combined_step(parts)
        assert got["ll"].shape[0] == R.STEP_ROWS
        for i, (r, p) in enumerate(zip(together, parts)):
            q = part(alone[i], i)
            want = R.combined_step([q])
            for k in ("feats", "fvalid", "ll", "lvalid"):
                if not flush or k in ("ll", "lvalid"):
                    assert _rows_equal(got[k][i], want[k][0]), (c, i, k)
            for k, v in got["frontier"].items():
                assert _rows_equal(v[i], want["frontier"][k][0]), (c, i, k)
            assert p.records.keys() == q.records.keys()
            for k in p.records:
                assert _rows_equal(p.records[k], q.records[k]), (c, i, k)
            assert np.array_equal(p.head, q.head), (c, i)
            r._take(p)
            alone[i]._take(q)
    for r, a in zip(together, alone):
        assert r._utt_frames == a._utt_frames > 0
        assert _record_bytes(r) == _record_bytes(a)
        for k in ("_feat_state", "_am_state", "_frontier") + (
                ("_iv_state",) if which == "ivector" else ()):
            x, y = getattr(r, k), getattr(a, k)
            flat = [(x[j], y[j]) for j in x if not isinstance(x[j], dict)]
            flat += [(x[j][m], y[j][m]) for j in x if isinstance(x[j], dict) for m in x[j]]
            assert all(_rows_equal(u, v) for u, v in flat), k


def _threads(fns, timeout=300):
    """Run each fn in a thread, all released together; returns their values."""
    out = [None] * len(fns)
    errors = []
    barrier = threading.Barrier(len(fns))

    def worker(i):
        barrier.wait()
        try:
            out[i] = fns[i]()
        except BaseException as e:  # noqa: B902 (reported below)
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-4)
    try:
        threads = [threading.Thread(target=worker, args=(i,)) for i in range(len(fns))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=timeout)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    if errors:
        raise errors[0]
    return out


STREAMS = [  # (words, seed, grammar, piece bytes)
    (["one", "two", "three"], 501, None, 3200),
    (["four", "five"], 502, None, 6400),
    (["six", "seven", "zero"], 503, json.dumps(["six seven zero", "one two"]), 3200),
    (["two", "six"], 504, None, 4000),
    (["one", "two"], 505, json.dumps(["six seven zero", "one two"]), 6400),
    (["zero", "three", "five"], 506, None, 3200),
]


def test_concurrent_streams_match_jax_alone(models):
    """Six threads, main-graph and grammar recognizers mixed, released
    together: each stream's results (endpoint flags, PartialResult,
    Result, FinalResult) equal what vosk_tpu's recognizer gives for it
    alone."""
    jm, tm = models

    def run(mod, model, words, seed, grammar, piece):
        out, _ = _drive(mod, model, _split(_pcm(_wav(words, seed)), piece), grammar=grammar,
                        partial=True, setup=lambda r: r.SetWords(True))
        return out

    want = [run(vosk_tpu, jm, *s) for s in STREAMS]
    got = _threads([lambda s=s: run(vosk_tpu_torch, tm, *s) for s in STREAMS])
    for g, w, s in zip(got, want, STREAMS):
        _assert_same(g, w)
        assert json.loads(g[-1])["text"] == " ".join(s[0])


def test_steps_combine_streams_at_fixed_rows(models, monkeypatch):
    """Four threads released together: decode_chunk always sees STEP_ROWS
    rows, and at least one step carries more than one stream."""
    _, tm = models
    dec = tm._model.shared_decoder()
    rows, streams = [], []
    decode = dec.decode_chunk
    step = R.combined_step

    def counted_decode(frontier, ll, valid=None, out=None):
        rows.append(ll.shape[0])
        return decode(frontier, ll, valid, out)

    def counted_step(parts):
        streams.append(len(parts))
        return step(parts)

    monkeypatch.setattr(dec, "decode_chunk", counted_decode)
    monkeypatch.setattr(R, "combined_step", counted_step)
    datas = [_pcm(_wav(w, 600 + i)) for i, w in
             enumerate([["one", "two"], ["three", "four"], ["five"], ["six", "seven"]])]
    _threads([lambda d=d: _drive(vosk_tpu_torch, tm, _split(d, 3200))[0] for d in datas])
    assert rows and set(rows) == {R.STEP_ROWS}
    assert max(streams) > 1 and len(streams) == len(rows)


def test_a_failed_step_reaches_every_stream(models, monkeypatch):
    """Three recognizers ask for the turn while it is held; released, they
    queue their chunks before the first one's step has its turn, so the
    three step together, and the step raises: all three calls raise its
    error, the combiner keeps no leader or queue, and the next calls decode
    as usual."""
    _, tm = models
    nm = tm._model
    dec = nm.shared_decoder()
    recs = [vosk_tpu_torch.KaldiRecognizer(tm, 16000) for _ in range(3)]
    chunk = _pcm(_wav(["one"], 700))[: 2 * recs[0]._rec.chunk_samples]

    class Planted(RuntimeError):
        pass

    def boom(*args, **kw):
        raise Planted("planted failure")

    streams = []
    step = R.combined_step

    def counted_step(parts):
        streams.append(len(parts))
        return step(parts)

    monkeypatch.setattr(dec, "decode_chunk", boom)
    monkeypatch.setattr(R, "combined_step", counted_step)
    errors = [None] * 3

    def call(i):
        try:
            recs[i].AcceptWaveform(chunk)
        except Exception as e:
            errors[i] = e

    asked = nm.combiner._asked
    with nm.turn_lock:
        threads = [threading.Thread(target=call, args=(i,)) for i in range(3)]
        for t in threads:
            t.start()
        while nm.combiner._asked < asked + 3:
            threading.Event().wait(0.01)
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert streams == [3]
    assert all(isinstance(e.__cause__, Planted) for e in errors), errors
    assert not nm.combiner._leading and not nm.combiner._queues
    monkeypatch.undo()
    data = _pcm(_wav(["three", "five"], 701))
    want, _ = _drive(vosk_tpu_torch, tm, [data])
    for r in recs:
        r.Reset()
        assert r.AcceptWaveform(data) in (0, 1)
        assert r.FinalResult() == want[-1]


def test_retained_records_match_a_stream_alone(models):
    """A stream stepped with others retains the records it retains alone:
    the same planes, each its own storage of its own row's bytes."""
    _, tm = models
    datas = [_pcm(_wav(w, 800 + i)) for i, w in
             enumerate([["seven", "one", "two", "zero"], ["four", "four", "six"],
                        ["three", "two", "one"], ["five", "six", "seven"]])]

    def stream(data):
        rec = vosk_tpu_torch.KaldiRecognizer(tm, 16000)
        for piece in _split(data, 3200):
            rec.AcceptWaveform(piece)
        r = rec._rec
        out = (_record_bytes(r), [{k: tuple(v.shape) for k, v in x.items()}
                                  for x in r._records], r._folded_frames)
        assert all(v.untyped_storage().nbytes() == v.numel() * v.element_size()
                   for x in r._records for v in x.values())
        rec.FinalResult()
        return out

    want = [stream(d) for d in datas]
    got = _threads([lambda d=d: stream(d) for d in datas])
    assert got == want and all(b > 0 for b, _, _ in want)


def test_a_step_takes_its_turn_behind_waiting_calls():
    """The turn goes in the order asked for; a leader's step takes the next
    turn, so a call already waiting for one queues its job first and the
    step carries both; a thread alone steps at once, in its call's turn."""
    from vosk_tpu_torch.io.native import StepCombiner

    comb = StepCombiner(threading.RLock())
    steps, order = [], []

    def call(name):
        with comb.turn():
            order.append(name)
            comb.run("key", None, name, steps.append)

    with comb.turn_lock:
        threads = []
        for i, name in enumerate("ab"):
            threads.append(threading.Thread(target=call, args=(name,)))
            threads[-1].start()
            while comb._asked < i + 1:
                threading.Event().wait(0.01)
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert order == ["a", "b"] and steps == [["a", "b"]]
    assert comb.sizes == {2: 1} and not comb._queues and not comb._leading
    with comb.turn():
        comb.run("key", None, "c", steps.append)
    assert steps[-1] == ["c"]


def test_a_leader_waits_for_a_recognizer_that_buffered():
    """A leader lets the calls already waiting for a turn go, and again
    after each round that ran a call of its group: a waiting call that only
    buffers audio, whose thread comes back with a chunk while that call
    runs, gets its chunk into the step, beside the one that was waiting."""
    from vosk_tpu_torch.io.native import StepCombiner

    comb = StepCombiner(threading.RLock())
    steps, threads = [], []

    def start(fn, *args):
        asked = comb._asked
        threads.append(threading.Thread(target=fn, args=args))
        threads[-1].start()
        while comb._asked < asked + 1:
            threading.Event().wait(0.01)

    def chunk(name):
        with comb.turn("g"):
            comb.run("key", "g", name, steps.append)

    def buffering():
        with comb.turn("g"):
            start(chunk, "b")  # its thread's next call, asked for in this one

    with comb.turn_lock:
        start(chunk, "a")
        start(buffering)
        start(chunk, "c")
    while len(threads) < 4:
        threading.Event().wait(0.01)
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert steps == [["a", "c", "b"]]
    assert comb.sizes == {3: 1} and not comb._queues and not comb._leading


def test_recognizers_share_the_am_and_buffering_steps_nothing(models):
    """Recognizers of a model share its AM, as they share its decoder; an
    AcceptWaveform that leaves less than a 0.2 s chunk buffered steps
    nothing, and the call that completes the chunk steps it."""
    _, tm = models
    rec = vosk_tpu_torch.KaldiRecognizer(tm, 16000)
    assert rec._rec.am is vosk_tpu_torch.KaldiRecognizer(tm, 16000)._rec.am
    half = _pcm(_wav(["two"], 900))[: rec._rec.chunk_samples]  # 0.1 s
    steps = sum(tm._model.combiner.sizes.values())
    rec.AcceptWaveform(half)
    assert sum(tm._model.combiner.sizes.values()) == steps and not rec._rec._records
    rec.AcceptWaveform(half)
    assert sum(tm._model.combiner.sizes.values()) == steps + 1
    assert len(rec._rec._records) == 1 and len(rec._rec._pending) == 0
