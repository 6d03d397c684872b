"""vosk_tpu_torch/models/{tdnnf,streaming}.py against the JAX TDNN-F.

The same weights go into both packages through `tdnnf_params_from_jax`.
Chunks of seeded features stream through `_process_chunk_impl` with a
masked tail, then `_flush_impl`.  Masks and stream counters must match
exactly.  Tolerances: f32 rtol=atol=1e-4 (matmul summation order; the
measured max abs difference is 1.9e-6).  bf16 atol=2.5e-2, rtol=0: both
round the same operands to bf16 and sum in f32, but a sum that lands near
a bf16 rounding boundary rounds the next layer's input one bf16 step
(2^-8 relative) apart.  Measured on this test's data: 3.7e-3 (outputs up
to 4.6); with the products rounded to bf16 instead (torch.matmul on bf16
operands, the fault this test guards against) 3.8e-2.  Over six other
input seeds the sound reading was at most 1.7e-2 and the rounded one at
least 3.1e-2.  One bf16 layer, before rounding flips cascade, separates
them by four orders: `test_bf16_matmul_keeps_f32_products`.
"""
import dataclasses

import numpy as np
import pytest
import torch

from vosk_tpu.models.tdnnf import TdnnfConfig as JCfg, TdnnfModel as JModel
from vosk_tpu.models.tdnnf import init_params as j_init
from vosk_tpu_torch.models.tdnnf import TdnnfConfig, init_params, tdnnf_params_from_jax

TOL = {"float32": dict(rtol=1e-4, atol=1e-4), "bfloat16": dict(rtol=0, atol=2.5e-2)}


def test_init_params_seed_identical():
    cfg = TdnnfConfig(feat_dim=13, hidden_dim=32, bottleneck_dim=8,
                      prefinal_dim=16, num_pdfs=11, time_strides=(1, 0, 3))
    a = init_params(cfg, seed=3)
    b = j_init(JCfg(**dataclasses.asdict(cfg)), seed=3)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_stream_chunks_and_flush_match(dtype):
    cfg = TdnnfConfig(feat_dim=20, hidden_dim=64, bottleneck_dim=16,
                      prefinal_dim=32, num_pdfs=40, time_strides=(1, 0, 3),
                      compute_dtype=dtype)
    jcfg = JCfg(**dataclasses.asdict(cfg))
    params = j_init(jcfg, seed=1)
    rng = np.random.default_rng(1)
    # non-trivial batchnorm terms, so every parameter matters
    for k in params:
        if k.endswith(("_b", "_offset")):
            params[k] = rng.standard_normal(params[k].shape).astype(np.float32) * 0.1
        if k.endswith("_scale"):
            params[k] = rng.uniform(0.5, 1.5, params[k].shape).astype(np.float32)
    jm = JModel(jcfg, params)
    tm = tdnnf_params_from_jax({k: np.asarray(v) for k, v in jm.params.items()}, cfg, device="cpu")

    B, F = 2, 21
    js, ts = jm.init_stream_state(B, F), tm.init_stream_state(B, F)
    for c in range(4):
        feats = rng.standard_normal((B, F, 20)).astype(np.float32)
        valid = np.ones((B, F), bool)
        if c == 3:
            valid[1, 9:] = False
        js, jo, jv = jm._process_chunk_impl(jm.params, js, feats, valid, None)
        ts, to, tv = tm._process_chunk_impl(ts, torch.from_numpy(feats),
                                            torch.from_numpy(valid))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL[dtype])
        for k in ("hist_len", "feats_seen", "out_emitted"):
            np.testing.assert_array_equal(ts[k].numpy(), np.asarray(js[k]), err_msg=k)
        np.testing.assert_array_equal(ts["hist"].numpy(), np.asarray(js["hist"]))
    js, jo, jv = jm._flush_impl(jm.params, js)
    ts, to, tv = tm._flush_impl(ts)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert tv.any()
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL[dtype])


def test_bf16_matmul_keeps_f32_products():
    """The port's bf16 matmul against the source's `mm` (bf16 operands,
    `preferred_element_type=float32`) on one layer.  Measured max abs
    difference 4.8e-7 on products up to 3.9; products rounded to bf16 give
    7.8e-3.  Tolerance atol=1e-5, rtol=0."""
    import jax.numpy as jnp

    cfg = TdnnfConfig(feat_dim=20, hidden_dim=64, bottleneck_dim=16,
                      prefinal_dim=32, num_pdfs=40, time_strides=(1, 0, 3),
                      compute_dtype="bfloat16")
    params = init_params(cfg, seed=1)
    tm = tdnnf_params_from_jax(params, cfg, device="cpu")
    x = np.random.default_rng(6).standard_normal((2, 30, 60)).astype(np.float32)
    want = jnp.matmul(jnp.asarray(x, jnp.bfloat16), jnp.asarray(params["tdnn1_w"], jnp.bfloat16),
                      preferred_element_type=jnp.float32)
    got = tm._mm(torch.from_numpy(x), tm.params["tdnn1_w"])
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


def test_public_flush_matches_jax():
    """StreamingAm.flush(state, ivector=None), the public end-of-stream
    flush, on a TDNN-F at the toy model's widths (toydata.build_toy_model:
    13 MFCCs, hidden 64, bottleneck 16, prefinal 32, 9 pdfs, strides (1, 1,
    3), f32): after three ragged chunks, two flushes in a row (the first
    must emit).  Outputs within the f32 tolerance of
    process_chunk above (rtol = atol = 1e-4); masks and counters exact."""
    cfg = TdnnfConfig(feat_dim=13, hidden_dim=64, bottleneck_dim=16, prefinal_dim=32,
                      num_pdfs=9, time_strides=(1, 1, 3), subsample=3,
                      compute_dtype="float32")
    jcfg = JCfg(**dataclasses.asdict(cfg))
    jm = JModel(jcfg, j_init(jcfg, seed=2))
    tm = tdnnf_params_from_jax({k: np.asarray(v) for k, v in jm.params.items()}, cfg,
                               device="cpu")
    rng = np.random.default_rng(2)
    B, F = 3, 17
    js, ts = jm.init_stream_state(B, F), tm.init_stream_state(B, F)
    for c in range(3):
        feats = rng.standard_normal((B, F, 13)).astype(np.float32)
        valid = np.ones((B, F), bool)
        valid[c % B, 5 + c:] = False
        js, _, _ = jm.process_chunk(js, feats, valid)
        ts, _, _ = tm.process_chunk(ts, torch.from_numpy(feats), torch.from_numpy(valid))
    for n in range(2):
        js, jo, jv = jm.flush(js)
        ts, to, tv = tm.flush(ts, ivector=None)
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        assert tv.any() or n
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL["float32"])
        for k in ("hist_len", "feats_seen", "out_emitted"):
            np.testing.assert_array_equal(ts[k].numpy(), np.asarray(js[k]), err_msg=k)
