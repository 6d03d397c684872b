"""The port's nnet3 evaluator and Nnet3Am against vosk_tpu's, on the CPU.

A seeded network that uses every component with a torch forward and every
descriptor (Append, Offset, Sum, Scale, Const, ReplaceIndex, Round,
IfDefined, Failover, a dim-range node), with an i-vector input, is written
by the JAX package's writer and read by the port's reader, so both evaluate
the same parsed weights.  Tolerance: f32, atol 1e-4 (the products differ
by summation order only).
"""
import io

import numpy as np
import pytest
import torch

from vosk_tpu.io import nnet3 as j3
from vosk_tpu.io.kaldiio import BinaryReader as JReader, BinaryWriter as JWriter
from vosk_tpu.models.am import Nnet3Am as JNnet3Am
from vosk_tpu_torch.io import nnet3 as t3
from vosk_tpu_torch.io.kaldiio import BinaryReader
from vosk_tpu_torch.models.am import Nnet3Am

ATOL = 1e-4
FEAT, IVD, OUT = 8, 4, 7

NET_LINES = [
    f"input-node name=input dim={FEAT}",
    f"input-node name=ivector dim={IVD}",
    "component-node name=lda component=lda input=Append(Offset(input, -1), input, "
    "Offset(input, 1), ReplaceIndex(ivector, t, 0))",
    "component-node name=relu1 component=relu1 input=lda",
    "component-node name=bn1 component=bn1 input=relu1",
    "component-node name=tdnn2 component=tdnn2 input=bn1",
    "component-node name=sig component=sig input=tdnn2",
    "component-node name=lin3 component=lin3 input=Sum(Scale(0.5, sig), Offset(tdnn2, -1))",
    "component-node name=tanh component=tanh input=Append(lin3, Const(0.25, 4))",
    "dim-range-node name=dr input-node=tanh dim-offset=2 dim=10",
    "component-node name=scale component=scale input=Round(dr, 3)",
    "component-node name=off component=off input=IfDefined(Offset(scale, 2))",
    "component-node name=noop component=noop input=Failover(off, scale)",
    "component-node name=drop component=drop input=noop",
    "component-node name=soft component=soft input=drop",
    "component-node name=out.affine component=out.affine input=Append(drop, soft)",
    "component-node name=out.log component=out.log input=out.affine",
    "output-node name=output input=out.log objective=linear",
]


def _components(rng):
    f = lambda *s: (rng.standard_normal(s) * 0.4).astype(np.float32)  # noqa: E731
    return {
        "lda": j3.AffineComponent(f(16, FEAT * 3 + IVD), f(16), "FixedAffineComponent"),
        "relu1": j3.NonlinComponent(16, "RectifiedLinearComponent"),
        "bn1": j3.BatchNormComponent(16, 1e-3, 1.3, f(16), np.abs(f(16)) + 0.5),
        "tdnn2": j3.TdnnComponent([-2, 0, 1], f(12, 48), f(12)),
        "sig": j3.NonlinComponent(12, "SigmoidComponent"),
        "lin3": j3.LinearComponent(f(12, 12)),
        "tanh": j3.NonlinComponent(16, "TanhComponent"),
        "scale": j3.PerElementScaleComponent(f(10)),
        "off": j3.PerElementOffsetComponent(f(10)),
        "noop": j3.IdentityComponent(10, "NoOpComponent"),
        "drop": j3.IdentityComponent(10, "DropoutComponent"),
        "soft": j3.NonlinComponent(10, "SoftmaxComponent"),
        "out.affine": j3.AffineComponent(f(OUT, 20), f(OUT)),
        "out.log": j3.NonlinComponent(OUT, "LogSoftmaxComponent"),
    }


def _jax_net(seed=0, lines=NET_LINES):
    net = j3.Nnet3()
    for line in lines:
        net._parse_config_line(line)
    comps = _components(np.random.default_rng(seed))
    names = [ln.split("component=")[1].split()[0] for ln in lines if "component=" in ln]
    net.components = {n: comps[n] for n in names}
    net.component_order = names
    return net


def _roundtrip(net) -> bytes:
    buf = io.BytesIO()
    net.write(JWriter(buf))
    return buf.getvalue()


@pytest.fixture(scope="module")
def nets():
    jnet = _jax_net()
    raw = _roundtrip(jnet)
    tnet = t3.Nnet3.read(BinaryReader(io.BytesIO(raw)))
    return jnet, tnet


def test_parsed_network_is_the_source_network(nets):
    jnet, tnet = nets
    assert tnet.node_order == jnet.node_order
    assert tnet.component_order == jnet.component_order
    for name in jnet.node_order:
        assert str(tnet.nodes[name]) == str(jnet.nodes[name])
    buf = io.BytesIO()
    tnet.write(t3.BinaryWriter(buf))
    assert buf.getvalue() == _roundtrip(jnet)


@pytest.mark.parametrize("name, din", [
    ("lda", FEAT * 3 + IVD), ("relu1", 16), ("bn1", 16), ("tdnn2", 16), ("sig", 12),
    ("lin3", 12), ("tanh", 16), ("scale", 10), ("off", 10), ("noop", 10),
    ("drop", 10), ("soft", 10), ("out.affine", 20), ("out.log", OUT),
])
def test_component_forward_matches_jax(nets, name, din):
    jnet, tnet = nets
    jc, tc = jnet.components[name], tnet.components[name]
    x = np.random.default_rng(3).standard_normal((2, 9, din)).astype(np.float32)
    got = tc.forward(torch.from_numpy(x), tc.tensors("cpu")).numpy()
    for b in range(2):
        want = np.asarray(jc.forward(x[b]))
        np.testing.assert_allclose(got[b], want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("T", [1, 11])
def test_evaluate_matches_jax(nets, T):
    jnet, tnet = nets
    rng = np.random.default_rng(T)
    feats = rng.standard_normal((3, T, FEAT)).astype(np.float32)
    ivec = rng.standard_normal((3, IVD)).astype(np.float32)
    got = tnet.evaluate(
        {"input": torch.from_numpy(feats), "ivector": torch.from_numpy(ivec)[:, None]},
        t3.net_tensors(tnet, "cpu")).numpy()
    assert got.shape == (3, T, OUT)
    for b in range(3):
        want = np.asarray(jnet.evaluate({"input": feats[b], "ivector": ivec[b][None]}))
        np.testing.assert_allclose(got[b], want, rtol=0, atol=ATOL)


def _ragged_chunks(rng, n, B, F):
    out = []
    for i in range(n):
        feats = rng.standard_normal((B, F, FEAT)).astype(np.float32)
        lens = np.array([F, F - 3 - i, 0 if i == 1 else F - 1])
        valid = np.arange(F)[None, :] < lens[:, None]
        out.append((feats, valid))
    return out


@pytest.mark.parametrize("with_ivector", [False, True])
def test_nnet3am_streaming_matches_jax(with_ivector):
    """process_chunk over 4 ragged chunks at B = 3, then flush, with log
    priors subtracted."""
    lines = NET_LINES
    if not with_ivector:
        lines = [ln.replace(", ReplaceIndex(ivector, t, 0)", "") for ln in NET_LINES
                 if "name=ivector" not in ln]
    jnet = _jax_net(seed=5, lines=lines)
    if not with_ivector:
        lda = jnet.components["lda"]
        lda.linear = lda.linear[:, : FEAT * 3]
    tnet = t3.Nnet3.read(BinaryReader(io.BytesIO(_roundtrip(jnet))))
    priors = np.random.default_rng(6).uniform(0.01, 1.0, OUT).astype(np.float32)
    jam = JNnet3Am(jnet, subsample=3, priors=priors)
    tam = Nnet3Am(tnet, subsample=3, priors=priors, device="cpu")
    assert (tam.left_context, tam.right_context) == (jam.left_context, jam.right_context)
    assert tam.has_ivector == jam.has_ivector == with_ivector
    B, F = 3, 10
    rng = np.random.default_rng(7)
    ivec = rng.standard_normal((B, IVD)).astype(np.float32) if with_ivector else None
    jst, tst = jam.init_stream_state(B, F), tam.init_stream_state(B, F)
    tiv = None if ivec is None else torch.from_numpy(ivec)
    emitted = 0
    for feats, valid in _ragged_chunks(rng, 4, B, F):
        jst, jout, jv = jam.process_chunk(jst, feats, valid, ivec)
        tst, tout, tv = tam.process_chunk(tst, torch.from_numpy(feats),
                                          torch.from_numpy(valid), tiv)
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=0, atol=ATOL)
        emitted += int(tv.sum())
    jst, jout, jv = jam.flush(jst, ivec)
    tst, tout, tv = tam.flush(tst, tiv)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=0, atol=ATOL)
    for k in jst:
        np.testing.assert_array_equal(tst[k].numpy(), np.asarray(jst[k]), err_msg=k)
    assert emitted > 0 and tv.any()


def test_missing_ivector_raises(nets):
    _, tnet = nets
    am = Nnet3Am(tnet, device="cpu")
    with pytest.raises(ValueError):
        am.forward(torch.zeros((1, 12, FEAT)))


def test_cyclic_net_raises():
    lines = [
        f"input-node name=input dim={FEAT}",
        "component-node name=a component=a input=Append(input, IfDefined(Offset(b, -1)))",
        "component-node name=b component=b input=a",
        "output-node name=output input=b objective=linear",
    ]
    net = t3.Nnet3()
    for line in lines:
        net._parse_config_line(line)
    rng = np.random.default_rng(0)
    net.components = {
        "a": t3.AffineComponent(rng.standard_normal((FEAT, 2 * FEAT)), np.zeros(FEAT)),
        "b": t3.NonlinComponent(FEAT, "TanhComponent"),
    }
    net.component_order = ["a", "b"]
    # a streaming AM needs a feedforward net (the source's context walk
    # would not end on this one)
    with pytest.raises(NotImplementedError):
        Nnet3Am(net, device="cpu")
    # evaluate unrolls it in time, as the source's recurrent evaluator does
    buf = io.BytesIO()
    net.write(t3.BinaryWriter(buf))
    jnet = j3.Nnet3.read(JReader(io.BytesIO(buf.getvalue())))
    x = np.random.default_rng(1).standard_normal((2, 4, FEAT)).astype(np.float32)
    got = net.evaluate({"input": torch.from_numpy(x)}, t3.net_tensors(net, "cpu")).numpy()
    for b in range(2):
        want = np.asarray(jnet.evaluate({"input": x[b]}))
        np.testing.assert_allclose(got[b], want, rtol=1e-5, atol=1e-5)


def test_lstm_component_raises():
    """The port reads LstmNonlinearityComponent as the source does, and its
    forward matches the source's within 1e-6 (it raised before the RNNLM
    slice)."""
    buf = io.BytesIO()
    params = np.random.default_rng(2).standard_normal((3, 4)).astype(np.float32)
    j3.LstmNonlinearityComponent(params).write(JWriter(buf))
    tc = t3.read_component(BinaryReader(io.BytesIO(buf.getvalue())))
    jc = j3.read_component(JReader(io.BytesIO(buf.getvalue())))
    assert isinstance(tc, t3.LstmNonlinearityComponent)
    assert isinstance(jc, j3.LstmNonlinearityComponent)
    np.testing.assert_array_equal(tc.params, jc.params)
    x = np.random.default_rng(3).standard_normal((2, 5, 20)).astype(np.float32)
    got = tc.forward(torch.from_numpy(x), tc.tensors("cpu")).numpy()
    np.testing.assert_allclose(got, np.asarray(jc.forward(x)), rtol=1e-6, atol=1e-6)
