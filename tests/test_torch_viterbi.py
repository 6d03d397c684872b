"""vosk_tpu_torch/ops/viterbi.py against vosk_tpu/ops/viterbi.py (v4 step).

Both decoders get the same realistic graph (each runs its own
prepare_graph_v4) and the same log-likelihoods, in two chunks with masked
frames.  The frontier (state, cost, tsil), the five record planes (pm,
state, f_cost, lat_pm, lat_cost) and the best costs must be BIT-equal.
B=16 with max-active 1024 makes the JAX decoder take its ragged bucket
path, which the port does not have (it is bit-equal to the full-K step).
At acoustic scale 0.7 XLA rounds each candidate cost once (a fused
multiply-add), which the port reproduces.
"""
import numpy as np
import pytest
import torch

from vosk_tpu.ops.viterbi import BatchViterbi as JViterbi, DecodeParams as JParams
from vosk_tpu.utils.benchdata import make_plausible_loglikes, make_realistic_graph
from vosk_tpu_torch.ops.viterbi import BatchViterbi, DecodeParams

SIL = np.array([0, 1], np.int32)


def _bits(x):
    a = np.asarray(x)
    return a.view(np.int32) if a.dtype == np.float32 else a


@pytest.fixture(scope="module")
def graph():
    return make_realistic_graph(num_states=20_000, num_pdfs=64, num_words=500, seed=3)


@pytest.mark.parametrize("B,K,scale", [(4, 256, 1.0), (16, 1024, 1.0), (4, 256, 0.7)],
                         ids=["4-256", "16-1024", "4-256-scale0.7"])
def test_v4_bit_equal(graph, B, K, scale):
    params = dict(beam=10.0, max_active=K, lattice_beam=6.0, acoustic_scale=scale)
    jd = JViterbi(graph, JParams(**params), lattice_records=True, silence_pdfs=SIL,
                  frame_step="auto", pack="packed16", optimize_graph=True)
    td = BatchViterbi(graph, DecodeParams(**params), silence_pdfs=SIL,
                      optimize_graph=True, device="cpu")
    assert (jd.frame_step, jd.pack, jd.K, jd.R, jd.M) == ("v4", "packed16", td.K, td.R, td.M)
    assert (jd._ragged_G(B) > 1) == (B == 16)

    T = 8
    ll = make_plausible_loglikes(jd.graph, 64, B, 2 * T, seed=B).transpose(1, 0, 2)
    ll = np.ascontiguousarray(ll)
    # flat scores on half the channels fill the frontier to max-active;
    # sharp scores on the others leave a few live tokens
    ll[: B // 2] *= 0.2
    ll[B // 2:] *= 2.0
    valid = np.ones((B, 2 * T), bool)
    valid[1, 3:5] = False
    valid[0, -2:] = False

    jf, tf = jd.init_frontier(B), td.init_frontier(B)
    jrecs, trecs = [], []
    for c in range(2):
        sl = slice(c * T, (c + 1) * T)
        jf, jr, jb, jbf = jd.decode_chunk(jf, ll[:, sl], valid[:, sl])
        tf, tr, tb, tbf = td.decode_chunk(tf, torch.from_numpy(ll[:, sl]),
                                          torch.from_numpy(valid[:, sl]))
        for k in ("state", "cost", "tsil"):
            np.testing.assert_array_equal(_bits(tf[k]), _bits(jf[k]), err_msg=f"frontier[{k}]")
        assert set(tr) == set(jr) == {"pm", "state", "f_cost", "lat_pm", "lat_cost"}
        for k in jr:
            np.testing.assert_array_equal(_bits(tr[k]), _bits(jr[k]), err_msg=f"records[{k}]")
        np.testing.assert_array_equal(_bits(tb), _bits(jb))
        np.testing.assert_array_equal(_bits(tbf), _bits(jbf))
        jrecs.append(jr)
        trecs.append(tr)

    live = np.isfinite(np.asarray(jf["cost"])).sum(axis=1)
    assert live.max() == K and live.min() < K // 8  # capped and sparse channels
    for a, b in zip(td.endpoint_info(tf), jd.endpoint_info(jf)):
        np.testing.assert_array_equal(a, b)
    for ch in (0, 1, B - 1):
        assert td.traceback_with_frames(trecs, tf, ch) == jd.traceback_with_frames(jrecs, jf, ch)


def test_rejects_graph_not_v4_eligible(graph):
    """The v4 step on a graph with eps arcs left in place raises; "auto"
    takes the v3 step there, as the source does."""
    with pytest.raises(ValueError):
        BatchViterbi(graph, DecodeParams(max_active=64), device="cpu", frame_step="v4")
    assert BatchViterbi(graph, DecodeParams(max_active=64), device="cpu").frame_step == "v3"
