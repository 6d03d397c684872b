"""The AM's captured chunk programs (vosk_tpu_torch/models/streaming.py
`_AmChunkProgram`) on the CPU, where `process_chunk` runs the eager body.

On a CPU model no program is built; a copy of a model (`copy.copy`, a
torch.save round trip) starts with no program of its own; the program key
follows every shape a captured graph is fixed to (B, F, D, the history's
length, the i-vector's presence and dim), and not the features' strides
(`flush_inputs` gives a stride-0 view, which the copy-in takes); a
tensor-parallel (`mesh`) or trainable TDNN-F, a parameter that requires
grad and an empty chunk run eagerly, decided before any launch; the
copy-in, capture, replay, copy-out and eviction protocol is rehearsed over
stand-ins for the CUDA stream, event and graph; and the eager body, which is what a program captures,
equals vosk_tpu's `_process_chunk_impl` and `_flush_impl` over chained
chunks with masked frames, for a TDNN-F (weights carried by
`tdnnf_params_from_jax`, f32 and bf16) and for the toy Kaldi nnet3 AM with
an i-vector input.  Tolerances are those of the AM parity tests:
tests/test_torch_tdnnf.py (f32 rtol = atol = 1e-4, bf16 atol 2.5e-2) and
tests/test_torch_nnet3.py (atol 1e-4); masks, counters and the carried
feature history exactly.  The captured path itself needs the card
(tests/test_torch_cuda.py, chip_smoke.py).
"""
import contextlib
import copy
import dataclasses
import io

import numpy as np
import pytest
import torch

from test_torch_nnet3 import ATOL, FEAT, IVD, _jax_net, _roundtrip
from test_torch_tdnnf import TOL
from vosk_tpu.models.am import Nnet3Am as JNnet3Am
from vosk_tpu.models.tdnnf import TdnnfConfig as JCfg, TdnnfModel as JModel
from vosk_tpu.models.tdnnf import init_params as j_init
from vosk_tpu_torch.io import nnet3 as t3
from vosk_tpu_torch.io.kaldiio import BinaryReader
from vosk_tpu_torch.models import streaming
from vosk_tpu_torch.models.am import Nnet3Am
from vosk_tpu_torch.models.tdnnf import TdnnfConfig, TdnnfModel, init_params, tdnnf_params_from_jax

CFG = dict(feat_dim=12, hidden_dim=32, bottleneck_dim=8, prefinal_dim=16, num_pdfs=9,
           time_strides=(1, 0, 3))


def _tdnnf(dtype="float32", **kw):
    cfg = TdnnfConfig(**CFG, compute_dtype=dtype)
    return TdnnfModel(cfg, init_params(cfg, seed=4), device="cpu", **kw)


def _chunks(rng, n, B, F, D):
    """n chunks of seeded features [B, F, D] with ragged valid masks (one
    channel empty in the second chunk)."""
    out = []
    for i in range(n):
        feats = rng.standard_normal((B, F, D)).astype(np.float32)
        lens = np.array([F, F - 2 - i, 0 if i == 1 else F - 1][:B])
        out.append((feats, np.arange(F)[None, :] < lens[:, None]))
    return out


def test_cpu_am_builds_no_program():
    am = _tdnnf()
    before = dict(streaming.GRAPH_COUNTS)
    st = am.init_stream_state(2, 7)
    for feats, valid in _chunks(np.random.default_rng(0), 2, 2, 7, CFG["feat_dim"]):
        st, _, _ = am.process_chunk(st, torch.from_numpy(feats), torch.from_numpy(valid))
    am.flush(st)
    assert am.graph_eligible and not am._programs and not am._side_streams
    assert streaming.GRAPH_COUNTS == before


def _pickled(m):
    buf = io.BytesIO()
    torch.save(m, buf)
    buf.seek(0)
    return torch.load(buf, weights_only=False)


@pytest.mark.parametrize("copy_fn", [copy.copy, _pickled], ids=["copy", "torch.save"])
def test_copies_start_with_no_program(copy_fn):
    """A copy or a torch.save round trip (a mesh's ranks load the parent's
    nnet3 AM so) has its own lock, programs and side streams, empty, and
    computes what the original computes."""
    am = _tdnnf()
    sentinel = object()
    am._programs["parent's"], am._side_streams["parent's"] = sentinel, sentinel
    c = copy_fn(am)
    assert not c._programs and not c._side_streams and c._dispatch_lock is not am._dispatch_lock
    assert am._programs["parent's"] is sentinel and c.graph_eligible
    feats, valid = _chunks(np.random.default_rng(3), 1, 2, 7, CFG["feat_dim"])[0]
    args = (torch.from_numpy(feats), torch.from_numpy(valid))
    got = c.process_chunk(c.init_stream_state(2, 7), *args)
    want = am.process_chunk_eager(am.init_stream_state(2, 7), *args)
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])


def test_program_key_follows_every_shape():
    """(device, B, F, D, H, I): the batch, the chunk's frames, the feature
    dim, the history (its chunk frames at init), the i-vector's presence
    and dim; a stride-0 view of the flush chunk has the key of its
    contiguous copy."""
    am = _tdnnf()
    D = CFG["feat_dim"]

    def key(B, F, chunk=7, d=D, iv=None):
        st = am.init_stream_state(B, chunk)
        return am._program_key(st, torch.zeros((B, F, d)),
                               None if iv is None else torch.zeros((B, iv)))

    keys = [key(4, 7), key(2, 7), key(4, 6), key(4, 7, chunk=9), key(4, 7, d=D + 1),
            key(4, 7, iv=4), key(4, 7, iv=5)]
    assert len(set(keys)) == len(keys)
    assert key(4, 7) == key(4, 7)
    H = am.init_stream_state(4, 7)["hist"].shape[1]
    assert keys[0] == (torch.device("cpu"), 4, 7, D, H, None)
    assert keys[5][-1] == 4
    st = am.init_stream_state(3, 7)
    pad, _ = am.flush_inputs(st)
    assert pad.stride(1) == 0 and pad.shape[1] == am.right_context + am.subsample
    assert am._program_key(st, pad, None) == am._program_key(st, pad.contiguous(), None)


@contextlib.contextmanager
def _dispatch_spy(monkeypatch):
    """Every tensor reads as a CUDA tensor and `_replay` records its call
    instead of launching: which calls process_chunk would replay."""
    calls = []

    def spy(self, state, feats, valid, ivector):
        calls.append(tuple(feats.shape))
        return self._process_chunk_impl(state, feats, valid, ivector)

    with monkeypatch.context() as m:
        m.setattr(streaming.StreamingAm, "_replay", spy)
        m.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
        yield calls


def test_only_unsharded_inference_models_replay(monkeypatch):
    """The rule, decided before any launch: a tensor-parallel TDNN-F (`mesh`
    set), a trainable one, a parameter that requires grad and an empty chunk
    run eagerly; otherwise process_chunk, and flush through it, replay."""
    am, tp, trainable = _tdnnf(), _tdnnf(), _tdnnf(trainable=True)
    # what a model axis of more than one rank leaves set; the forward stays
    # the dense one here (the collectives need a process group)
    tp.mesh, tp.forward = object(), am.forward
    graded = _tdnnf()
    graded.params["output_b"].requires_grad_(True)
    nn3 = Nnet3Am(t3.Nnet3.read(BinaryReader(io.BytesIO(_roundtrip(_jax_net())))),
                  device="cpu")
    assert am.graph_eligible and nn3.graph_eligible
    assert not (tp.graph_eligible or trainable.graph_eligible or graded.graph_eligible)
    D = CFG["feat_dim"]
    feats, valid = torch.zeros((2, 7, D)), torch.ones((2, 7), dtype=torch.bool)
    with _dispatch_spy(monkeypatch) as calls:
        for m in (tp, trainable, graded):
            m.flush(m.process_chunk(m.init_stream_state(2, 7), feats, valid)[0])
        am.process_chunk(am.init_stream_state(0, 7), feats[:0], valid[:0])
        assert calls == []
        st, _, _ = am.process_chunk(am.init_stream_state(2, 7), feats, valid)
        am.flush(st)
        ivec = torch.zeros((2, IVD))
        nn3.flush(nn3.process_chunk(nn3.init_stream_state(2, 7), torch.zeros((2, 7, FEAT)),
                                    valid, ivec)[0], ivec)
    P = am.right_context + am.subsample
    assert calls == [(2, 7, D), (2, P, D), (2, 7, FEAT),
                     (2, nn3.right_context + nn3.subsample, FEAT)]


class _FakeEvent:
    def __init__(self):
        self.recorded = self.synced = 0

    def record(self, stream=None):
        self.recorded += 1

    def synchronize(self):
        self.synced += 1


class _FakeStream:
    def __init__(self, device=None):
        self.device = device

    def wait_stream(self, other):
        pass

    def wait_event(self, event):
        pass


class _FakeGraph:
    """Records the body run between capture_begin and capture_end (the
    static inputs it read and the outputs it returned); replay runs it again
    over the same inputs and writes the same output tensors, as a CUDA
    graph does."""
    capturing = None

    def capture_begin(self, capture_error_mode="global"):
        assert capture_error_mode == "thread_local"
        _FakeGraph.capturing, self.run = self, None

    def capture_end(self):
        _FakeGraph.capturing = None

    def replay(self):
        fn, outs = self.run
        new = fn()
        for a, b in zip((*outs[0].values(), *outs[1:]), (*new[0].values(), *new[1:])):
            a.copy_(b)


@pytest.fixture
def fake_card(monkeypatch):
    """torch.cuda's streams, events and graphs replaced by the stand-ins, and
    every tensor read as a CUDA tensor, so `_replay` runs its protocol on the
    CPU."""
    body = streaming.StreamingAm._process_chunk_impl

    def recorded(self, *args):
        outs = body(self, *args)
        g = _FakeGraph.capturing
        if g is not None:
            g.run = (lambda: body(self, *args), outs)
        return outs

    monkeypatch.setattr(streaming.StreamingAm, "_process_chunk_impl", recorded)
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: _FakeStream(device))
    monkeypatch.setattr(torch.cuda, "Stream", _FakeStream)
    monkeypatch.setattr(torch.cuda, "stream", lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _FakeGraph)


def _storages(res):
    state, out, out_valid = res
    return {t.untyped_storage().data_ptr() for t in (*state.values(), out, out_valid)}


def test_program_protocol_rehearsed(fake_card, monkeypatch):
    """Three chained chunks and a flush through `_replay` against the eager
    body: equal state, out and out_valid, every result fresh (no storage
    shared with the static outputs or the previous call's), one capture a
    shape and one replay a call, one side stream; with room for one
    program, the flush's capture evicts the chunk's after synchronizing on
    its last copy-out; a state of the wrong dtype raises."""
    monkeypatch.setattr(streaming, "AM_CHUNK_PROGRAMS", 1)
    am = _tdnnf("bfloat16")
    D = CFG["feat_dim"]
    before = dict(streaming.GRAPH_COUNTS)
    chunks = [(torch.from_numpy(f), torch.from_numpy(v))
              for f, v in _chunks(np.random.default_rng(1), 3, 3, 7, D)]
    st_g, st_e, prev, kept = am.init_stream_state(3, 7), am.init_stream_state(3, 7), set(), []
    for feats, valid in chunks:
        got = am.process_chunk(st_g, feats, valid)
        want = am.process_chunk_eager(st_e, feats, valid)
        kept.append((got, want))
        st_g, st_e = got[0], want[0]
        prog = next(iter(am._programs.values()))
        ptrs = _storages(got)
        assert not ptrs & _storages(prog.outs) and not ptrs & prev
        prev = ptrs
    first = prog
    kept.append((am.flush(st_g), am._flush_impl(st_e)))
    assert list(am._programs) == [am._program_key(st_g, am.flush_inputs(st_g)[0], None)]
    assert first.done.synced == 1 and first.done.recorded == 3
    for got, want in kept:
        for k in streaming.STATE_KEYS:
            assert torch.equal(got[0][k], want[0][k]), k
        assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
    assert kept[-1][0][2].any()
    assert (streaming.GRAPH_COUNTS["captures"] - before["captures"],
            streaming.GRAPH_COUNTS["replays"] - before["replays"]) == (2, 4)
    assert len(am._side_streams) == 1
    bad = dict(st_g, hist_len=st_g["hist_len"].long())
    with pytest.raises(ValueError, match="hist_len"):
        am.process_chunk(bad, *chunks[0])


def _compare(got, want, tol):
    (ts, to, tv), (js, jo, jv) = got, want
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **tol)
    for k in streaming.STATE_KEYS:
        np.testing.assert_array_equal(ts[k].numpy(), np.asarray(js[k]), err_msg=k)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_eager_body_matches_source_tdnnf(dtype):
    """process_chunk_eager over 4 chained ragged chunks at B = 3, then
    flush, against vosk_tpu's _process_chunk_impl and _flush_impl on the
    same weights (non-trivial batchnorm terms)."""
    jcfg = JCfg(**CFG, compute_dtype=dtype)
    params = j_init(jcfg, seed=6)
    rng = np.random.default_rng(6)
    for k in params:
        if k.endswith(("_b", "_offset")):
            params[k] = rng.standard_normal(params[k].shape).astype(np.float32) * 0.1
    jm = JModel(jcfg, params)
    tm = tdnnf_params_from_jax({k: np.asarray(v) for k, v in jm.params.items()},
                               TdnnfConfig(**dataclasses.asdict(jcfg)), device="cpu")
    B, F = 3, 8
    js, ts = jm.init_stream_state(B, F), tm.init_stream_state(B, F)
    emitted = 0
    for feats, valid in _chunks(rng, 4, B, F, CFG["feat_dim"]):
        want = jm._process_chunk_impl(jm.params, js, feats, valid, None)
        got = tm.process_chunk_eager(ts, torch.from_numpy(feats), torch.from_numpy(valid))
        _compare(got, want, TOL[dtype])
        (ts, _, tv), js = got, want[0]
        emitted += int(tv.sum())
    want = jm._flush_impl(jm.params, js)
    got = tm.flush(ts)
    _compare(got, want, TOL[dtype])
    assert emitted > 0 and got[2].any()


def test_eager_body_matches_source_nnet3_ivector():
    """The toy nnet3 AM of tests/test_torch_nnet3.py (every component and
    descriptor, an i-vector input through ReplaceIndex, log priors) over 4
    chained ragged chunks at B = 3 and a flush, per-channel i-vectors."""
    jnet = _jax_net(seed=8)
    tnet = t3.Nnet3.read(BinaryReader(io.BytesIO(_roundtrip(jnet))))
    priors = np.random.default_rng(8).uniform(0.01, 1.0, 7).astype(np.float32)
    jam = JNnet3Am(jnet, subsample=3, priors=priors)
    tam = Nnet3Am(tnet, subsample=3, priors=priors, device="cpu")
    assert tam.has_ivector
    B, F = 3, 10
    rng = np.random.default_rng(9)
    ivec = rng.standard_normal((B, IVD)).astype(np.float32)
    tiv = torch.from_numpy(ivec)
    js, ts = jam.init_stream_state(B, F), tam.init_stream_state(B, F)
    tol = dict(rtol=0, atol=ATOL)
    for feats, valid in _chunks(rng, 4, B, F, FEAT):
        want = jam._process_chunk_impl(jam.params, js, feats, valid, ivec)
        got = tam.process_chunk_eager(ts, torch.from_numpy(feats), torch.from_numpy(valid), tiv)
        _compare(got, want, tol)
        ts, js = got[0], want[0]
    want = jam._flush_impl(jam.params, js, ivec)
    got = tam.flush(ts, tiv)
    _compare(got, want, tol)
    assert got[2].any()
