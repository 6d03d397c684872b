"""The v4 decoder's captured chunk programs (vosk_tpu_torch/ops/viterbi.py
`_ChunkProgram`) on the CPU, where `decode_chunk` runs the eager body.

On a CPU decoder no program is built; a copy of a decoder (a clone at
another max-active, `to`, a torch.save round trip) starts with an empty
program cache of its own; the program key follows every shape a captured
graph is fixed to; only the v4 step on the padded layout with the kernels
is eligible for capture; and the eager body, which is what a program
captures, stays bit-equal to vosk_tpu's compiled `decode_chunk` over
chained chunks with masked frames and `out=` views, returning records that
share no storage from one call to the next.  The captured path itself needs
the card (tests/test_torch_cuda.py, chip_smoke.py).
"""
import io

import numpy as np
import pytest
import torch

from vosk_tpu.ops.viterbi import BatchViterbi as JViterbi, DecodeParams as JParams
from vosk_tpu.utils.benchdata import make_plausible_loglikes
from vosk_tpu_torch.ops import frame_step
from vosk_tpu_torch.ops.viterbi import BatchViterbi, DecodeParams
from vosk_tpu_torch.utils.benchdata import make_realistic_graph

SIL = np.array([0, 1], np.int32)
P = 64
PARAMS = dict(beam=10.0, max_active=256, lattice_beam=6.0)


def _bits(x):
    a = np.asarray(x)
    return a.view(np.int32) if a.dtype == np.float32 else a


@pytest.fixture(scope="module")
def graph():
    return make_realistic_graph(num_states=3000, num_pdfs=P, num_words=200, seed=3)


@pytest.fixture(scope="module")
def dec(graph):
    return BatchViterbi(graph, DecodeParams(**PARAMS), silence_pdfs=SIL, optimize_graph=True,
                        device="cpu")


def test_cpu_decoder_builds_no_program(dec):
    before = dict(frame_step.GRAPH_COUNTS)
    ll = torch.randn((2, 3, P), generator=torch.Generator().manual_seed(0))
    dec.decode_chunk(dec.init_frontier(2), ll)
    assert dec.graph_eligible and not dec._programs
    assert frame_step.GRAPH_COUNTS == before


def _pickled(d):
    buf = io.BytesIO()
    torch.save(d, buf)
    buf.seek(0)
    return torch.load(buf, weights_only=False)


@pytest.mark.parametrize("copy", [lambda d: d.clone_with_max_active(128),
                                  lambda d: d.to("cpu"), _pickled],
                         ids=["clone_with_max_active", "to", "torch.save"])
def test_copies_start_with_no_program(dec, copy):
    sentinel = object()
    dec._programs["parent's"] = sentinel
    try:
        c = copy(dec)
        assert c._programs is not dec._programs and not c._programs
        assert c._select_scratch is not dec._select_scratch
        assert c._dispatch_lock is not dec._dispatch_lock
        assert dec._programs["parent's"] is sentinel
    finally:
        del dec._programs["parent's"]


def test_program_key_follows_every_shape(dec):
    """(device, B, T, K, R, P, strides): a clone at another max-active has
    other K and R; a chunk read as a view of a longer one other strides."""
    def key(d, B, T, p=P, view_of=None):
        ll = torch.zeros((B, view_of or T, p))[:, :T]
        return d._program_key(ll.to(torch.float32))

    small = dec.clone_with_max_active(64)
    assert (small.K, small.R) != (dec.K, dec.R)
    keys = [key(dec, 4, 7), key(dec, 2, 7), key(dec, 4, 6), key(dec, 4, 7, p=P + 1),
            key(small, 4, 7), key(dec, 4, 7, view_of=9)]
    assert len(set(keys)) == len(keys)
    assert key(dec, 4, 7) == key(dec, 4, 7)
    assert keys[0] == (torch.device("cpu"), 4, 7, dec.K, dec.R, P, (7 * P, P, 1))


def test_only_v4_padded_kernels_are_eligible(graph, dec):
    assert dec.graph_eligible
    try:
        dec.step_ops = frame_step.PLAIN
        assert not dec.graph_eligible
        assert not dec.clone_with_max_active(128).graph_eligible  # step_ops copied
    finally:
        dec.step_ops = frame_step.KERNELS
    v3 = BatchViterbi(graph, DecodeParams(**PARAMS), silence_pdfs=SIL, device="cpu")
    csr = BatchViterbi(graph, DecodeParams(**PARAMS), silence_pdfs=SIL, optimize_graph=True,
                       device="cpu", layout="csr")
    assert (v3.frame_step, csr.layout) == ("v3", "csr")
    assert not v3.graph_eligible and not csr.graph_eligible


def test_eager_body_bit_equal_to_source_over_chained_chunks(graph, dec):
    """Three chained chunks with masked frames, records written into views
    of a [3, T, B, K|R] buffer, against vosk_tpu's jitted decode_chunk:
    frontier, the five record planes, best and best-final, bit for bit.
    Then the same chunks without `out`: each call's records, frontier and
    best costs are fresh (no storage shared with the previous call's)."""
    B, T, n = 4, 5, 3
    jd = JViterbi(graph, JParams(**PARAMS), lattice_records=True, silence_pdfs=SIL,
                  frame_step="auto", pack="packed16", optimize_graph=True)
    assert (jd.frame_step, jd.K, jd.R) == ("v4", dec.K, dec.R)
    ll = np.ascontiguousarray(
        make_plausible_loglikes(jd.graph, P, B, n * T, seed=7).transpose(1, 0, 2))
    ll[: B // 2] *= 0.2  # flat scores fill the frontier to max-active
    valid = np.ones((B, n * T), bool)
    valid[1, 2:6] = False
    valid[0, -2:] = False
    buf = dec.record_buffers((n, *dec.record_lead(T, B)))
    jf, tf = jd.init_frontier(B), dec.init_frontier(B)
    for c in range(n):
        sl = slice(c * T, (c + 1) * T)
        jf, jr, jb, jbf = jd.decode_chunk(jf, ll[:, sl], valid[:, sl])
        out = {k: v[c] for k, v in buf.items()}
        tf, tr, tb, tbf = dec.decode_chunk(tf, torch.from_numpy(ll[:, sl]),
                                           torch.from_numpy(valid[:, sl]), out=out)
        assert all(tr[k] is out[k] for k in out)
        for k in ("state", "cost", "tsil"):
            np.testing.assert_array_equal(_bits(tf[k]), _bits(jf[k]), err_msg=f"frontier[{k}]")
        for k in jr:
            np.testing.assert_array_equal(_bits(buf[k][c]), _bits(jr[k]), err_msg=k)
        np.testing.assert_array_equal(_bits(tb), _bits(jb))
        np.testing.assert_array_equal(_bits(tbf), _bits(jbf))
    live = np.isfinite(np.asarray(jf["cost"])).sum(axis=1)
    assert live.max() == dec.K  # the flat channels fill the frontier

    fr, prev = dec.init_frontier(B), None
    for c in range(n):
        sl = slice(c * T, (c + 1) * T)
        res = dec.decode_chunk(fr, torch.from_numpy(ll[:, sl]), torch.from_numpy(valid[:, sl]))
        fr = res[0]
        for k in buf:  # the same values as the out= run
            assert torch.equal(res[1][k], buf[k][c]), k
        ptrs = {v.untyped_storage().data_ptr()
                for v in (*res[0].values(), *res[1].values(), res[2], res[3])}
        assert len(ptrs) == 10
        if prev is not None:
            assert not ptrs & prev
        prev = ptrs
