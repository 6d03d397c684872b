"""vosk_tpu_torch's device mesh and sharded search (parallel/mesh.py,
parallel/launch.py, BatchViterbi.decode_chunk_sharded, FusedPipeline(mesh=))
against vosk_tpu's on the CPU.

The port's ranks are processes of a gloo group started by `run_group`; the
JAX side runs in this process on the 8 virtual CPU devices that conftest.py
makes, on the model of tests/test_multichip.py.  The rank bodies are
module-level functions that use torch and numpy only: a spawned rank
imports this module, and asserts that jax is not loaded in it (jax is
imported inside the test functions).

  (a) expand_v4's plain version over frontier stripes against JAX
      `_expand_v4(..., slot_base=i, slot_stride=n)`, packed16 and exact3
      rows, bit for bit;
  (b) the sharded v4 decode over model = 4 against JAX's on mesh (2, 4) and
      against the unsharded decode: best, best-final and the frontier
      bit-equal, tracebacks equal to the unsharded decode's; again with the
      nsm and pm of every BIG key of each merged pool overwritten by seeded
      garbage (the expand kernel leaves them unwritten);
  (c) the JAX package's v4 sharded records come back [B, T, K] and its
      traceback of channel 2 reads the wrong rows; the port's are [T, B, K]
      and agree;
  (d) the sharded v3 step the same way, with its records against JAX's;
  (e) the channel data-parallel decode over data = 4, bit-exact;
  (f) FusedPipeline data parallel (4, 1) and tensor parallel (4, 2) against
      JAX's within tests/test_multichip.py's tolerances, and against the
      port unsharded within tighter ones; each rank holds 1/n_model of
      every sharded parameter;
  (g) am_param_sharding's decision for every TDNN-F parameter equal to the
      source's;
  (h) a rank that raises makes run_group raise while another waits in a
      collective;
  (i) the sharded search refuses the CSR layout and a max-active the model
      axis does not divide, as the source cannot run them;
  (j) FusedPipeline(mesh) over a model axis of 2 on a Kaldi directory (an
      nnet3 AM) runs the whole AM on each rank's channels, as the source
      leaves it (`Nnet3Am.params` is empty, so its `shard_am_params` shards
      nothing), against JAX's pipeline on the same mesh and the port's
      unsharded one.
"""
import functools
import sys

import numpy as np
import pytest
import torch

from vosk_tpu_torch.ops.frame_step import expand_v4_plain
from vosk_tpu_torch.parallel import mesh as pm
from vosk_tpu_torch.parallel.launch import RankError, run_group

MODEL = dict(num_states=4000, num_pdfs=256, hidden=64, max_active=256, realistic=True,
             num_words=500, seed=5)
PARAMS = dict(beam=13.0, max_active=256, lattice_beam=6.0)
B_SHARD, T_SHARD = 4, 6   # tests/test_multichip.py's sharded decode
B_DP, T_DP = 8, 6         # and its data-parallel decode
B_PIPE, N_CHUNKS = 8, 2   # and its pipelines (0.2 s chunks)
SCORES = ("sparse", "full")
TIMEOUT = 240
# the source's TDNN-F at full width (bench.py's), beside the test model's
FULL_AM = dict(num_pdfs=6008, hidden=512)


def _bits(x):
    a = np.asarray(x)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _eq(a, b, what):
    np.testing.assert_array_equal(_bits(a), _bits(b), err_msg=what)


def _shard_scores(kind="sparse"):
    """tests/test_multichip.py's scores (a few dozen live tokens a channel),
    or 16 frames of them with channels 0 and 1 flattened 40-fold, whose
    frontiers fill to max-active."""
    rng = np.random.default_rng(2)
    T = T_SHARD if kind == "sparse" else 16
    ll = (rng.standard_normal((B_SHARD, T, 256)) * 2).astype(np.float32)
    if kind == "full":
        ll[:2] *= 0.025
    return ll


def _dp_scores():
    rng = np.random.default_rng(0)
    return (rng.standard_normal((B_DP, T_DP, 256)) * 2).astype(np.float32)


def _audio():
    rng = np.random.default_rng(1)
    return (rng.standard_normal((N_CHUNKS, B_PIPE, 3200)) * 300).astype(np.float32)


def _am_shapes():
    """{config: {parameter: shape}} for the test model's TDNN-F and the
    full-width one."""
    from vosk_tpu_torch.models.tdnnf import init_params
    from vosk_tpu_torch.utils.benchdata import bench_am_config

    out = {}
    for name, kw in (("test", dict(num_pdfs=MODEL["num_pdfs"], hidden=MODEL["hidden"])),
                     ("full", FULL_AM)):
        out[name] = {k: tuple(v.shape) for k, v in init_params(bench_am_config(**kw)).items()}
    return out


# ------------------------------------------------------------------ rank bodies


def _model():
    from vosk_tpu_torch.utils.benchdata import make_bench_model

    return make_bench_model(device="cpu", **MODEL)


def _decoder(model, frame_step):
    from vosk_tpu_torch.ops.viterbi import BatchViterbi, DecodeParams

    return BatchViterbi(model.graph, DecodeParams(**PARAMS), silence_pdfs=model.silence_pdfs,
                        device="cpu", frame_step=frame_step,
                        optimize_graph=frame_step == "v4")


def _tracebacks(dec, recs, fr, B):
    return [dec.traceback_with_frames([recs], fr, b, use_final=False) for b in range(B)]


def _overwriting_select(counts, cbits, nsm, pm_, *args, **kw):
    """select_v4_plain on the pool with the nsm and pm of every BIG-keyed
    candidate replaced by seeded garbage: the words the expand kernel
    leaves unwritten (nsm and pm are defined where cbits < BIG).  Appends
    the words replaced a plane to `counts`."""
    from vosk_tpu_torch.ops.frame_step import BIG_I32, select_v4_plain

    big = cbits == BIG_I32
    n = int(big.sum())
    rng = np.random.default_rng(len(counts))
    nsm, pm_ = nsm.clone(), pm_.clone()
    for plane in (nsm, pm_):
        plane[big] = torch.from_numpy(rng.integers(-(2**31), 2**31, n).astype(np.int32))
    counts.append(n)
    return select_v4_plain(cbits, nsm, pm_, *args, **kw)


def _sharded_rank(mesh):
    """(b)-(d), (g) at model = 4: the v4 and v3 decodes of both score sets,
    sharded and not; and the v4 decodes again with the payload of every
    BIG key of each merged pool overwritten ("v4_overwritten")."""
    from vosk_tpu_torch.ops.frame_step import StepOps

    model = _model()
    out = {"jax_loaded": "jax" in sys.modules, "coord": mesh.get_coordinate(),
           "decisions": {c: {k: pm.am_param_sharding(mesh, k, s)
                             for k, s in shapes.items()} for c, shapes in _am_shapes().items()},
           "overwritten": []}
    for fs in ("v4", "v3", "v4_overwritten"):
        dec = _decoder(model, fs[:2])
        if fs == "v4_overwritten":
            dec.step_ops = StepOps(expand_v4_plain,
                                   functools.partial(_overwriting_select, out["overwritten"]))
        for kind in SCORES:
            ll = torch.from_numpy(_shard_scores(kind))
            B = ll.shape[0]
            sh = dec.decode_chunk_sharded(mesh, dec.init_frontier(B), ll)
            ref = dec.decode_chunk(dec.init_frontier(B), ll)
            out[fs, kind] = {"sharded": sh, "unsharded": ref,
                             "tb_sharded": _tracebacks(dec, sh[1], sh[0], B),
                             "tb_unsharded": _tracebacks(dec, ref[1], ref[0], B)}
    out["refused"] = _refusals(mesh, model)
    return out


def _refusals(mesh, model):
    """{case: the exception decode_chunk_sharded raised (type name, message)}
    for what the source's sharded mode cannot run: the CSR layout, and a
    max-active that the model axis does not divide."""
    from vosk_tpu_torch.ops.viterbi import BatchViterbi, DecodeParams

    ll = torch.zeros((1, 1, 256))
    decs = {"csr": BatchViterbi(model.graph, DecodeParams(**PARAMS), device="cpu",
                                layout="csr"),
            "k_not_divisible": BatchViterbi(model.graph, DecodeParams(**{
                **PARAMS, "max_active": 254}), device="cpu", optimize_graph=True)}
    out = {}
    for case, dec in decs.items():
        try:
            dec.decode_chunk_sharded(mesh, dec.init_frontier(1), ll)
        except (NotImplementedError, ValueError) as e:
            out[case] = (type(e).__name__, str(e))
    return out


def _data_parallel_rank(mesh, ll, audio):
    """(e) and (f) at data = 4: the channel-local decode of the rank's
    channels, then FusedPipeline(mesh) over the global audio."""
    from vosk_tpu_torch.runtime.pipeline import FusedPipeline

    model = _model()
    dec = _decoder(model, "v3")
    ll = pm.shard_channel_state(mesh, torch.from_numpy(ll))
    fr, recs, best, bestf = dec.decode_chunk(dec.init_frontier(ll.shape[0]), ll)
    pipe = FusedPipeline(model, batch=B_PIPE, mesh=mesh)
    _, precs, pbest = pipe.run_scan(pipe.init_state(), audio)
    return {"jax_loaded": "jax" in sys.modules, "local_B": pipe.local_B,
            "frontier": pm.gather_channels(mesh, fr), "records": pm.gather_channels(mesh, recs),
            "best": pm.gather_channels(mesh, best), "best_final": pm.gather_channels(mesh, bestf),
            "pipe_best": pm.gather_channels(mesh, pbest, dim=1),
            "pipe_pm": pm.gather_channels(mesh, precs["pm"], dim=2)}


def _odd_am():
    """A TDNN-F whose 255 pdfs do not divide by 2: the rule shards its
    output matrix on its first axis (a SUM all-reduce) and replicates its
    bias; f32 products, seed 7.  Its per-unit vectors (bias, scale, offset;
    zeros and ones in `init_params`) are drawn at random, so that a rank
    applying another rank's block of one shows.  Returns (config, params,
    features)."""
    from vosk_tpu_torch.models.tdnnf import init_params
    from vosk_tpu_torch.utils.benchdata import bench_am_config

    cfg = bench_am_config(num_pdfs=255, hidden=64, compute_dtype="float32")
    rng = np.random.default_rng(7)
    feats = (rng.standard_normal((2, 40, cfg.feat_dim)) * 3).astype(np.float32)
    params = init_params(cfg, seed=7)
    for k, v in params.items():
        if v.ndim == 1:
            base = 1.0 if k.endswith("_scale") else 0.0
            params[k] = (base + 0.1 * rng.standard_normal(v.shape)).astype(np.float32)
    return cfg, params, torch.from_numpy(feats)


def _tensor_parallel_rank(mesh, audio, kaldi_dir):
    """(f), (g) and (j) at model = 2: FusedPipeline(mesh) with the TDNN-F
    sharded over the model axis, the forward of `_odd_am`, and
    FusedPipeline(mesh) on the Kaldi directory (nnet3 AM)."""
    from vosk_tpu_torch.io.native import load_any
    from vosk_tpu_torch.models.tdnnf import TdnnfModel
    from vosk_tpu_torch.runtime.pipeline import FusedPipeline

    model = _model()
    pipe = FusedPipeline(model, batch=B_PIPE, mesh=mesh)
    _, _, best = pipe.run_scan(pipe.init_state(), audio)
    cfg, params, feats = _odd_am()
    odd = TdnnfModel(cfg, params, device="cpu", mesh=mesh)
    with torch.no_grad():
        odd_out = odd(feats)
    kaldi = load_any(kaldi_dir, device="cpu")
    kpipe = FusedPipeline(kaldi, batch=B_PIPE, mesh=mesh)
    _, _, kbest = kpipe.run_scan(kpipe.init_state(), audio)
    return {"jax_loaded": "jax" in sys.modules, "nnet3_am": kpipe.am is kaldi.am_override,
            "nnet3_best": pm.gather_channels(mesh, kbest, dim=1),
            "odd_out": odd_out, "odd_dims": dict(odd.shard_dims),
            "shapes": {k: tuple(v.shape) for k, v in pipe.am.params.items()},
            "dims": dict(pipe.am.shard_dims),
            "pipe_best": pm.gather_channels(mesh, best, dim=1),
            "decisions": {c: {k: pm.am_param_sharding(mesh, k, s)
                              for k, s in shapes.items()} for c, shapes in _am_shapes().items()}}


def _failing_rank(mesh):
    import torch.distributed as dist

    if dist.get_rank() == 1:
        raise ValueError("rank 1 fails on purpose")
    dist.all_reduce(torch.zeros(1))  # rank 0 waits for a peer that never comes


# --------------------------------------------------------------------- fixtures


@pytest.fixture(scope="module")
def jmodel():
    from vosk_tpu.utils.benchdata import make_bench_model

    return make_bench_model(**MODEL)


@pytest.fixture(scope="module")
def sharded():
    res = run_group(_sharded_rank, 1, 4, "cpu", timeout=TIMEOUT)
    assert not any(r["jax_loaded"] for r in res)
    assert [list(r["coord"]) for r in res] == [[0, i] for i in range(4)]
    return res


@pytest.fixture(scope="module")
def data_parallel():
    res = run_group(_data_parallel_rank, 4, 1, "cpu", args=(_dp_scores(), _audio()),
                    timeout=TIMEOUT)
    assert not any(r["jax_loaded"] for r in res)
    return res


@pytest.fixture(scope="module")
def kaldi_dir(tmp_path_factory):
    """A Kaldi V2 directory (nnet3 final.mdl, HCLG.fst, no i-vector) of the
    test model, written by the port's exporter (byte-identical to the
    source's, tests/test_torch_copies.py)."""
    from vosk_tpu_torch.io.kaldi_export import export_kaldi_dir
    from vosk_tpu_torch.utils import kaldidata

    m = _model()
    kaldidata.one_phone_per_pdf(m)
    path = tmp_path_factory.mktemp("kaldi_mesh") / "hclg"
    export_kaldi_dir(m, path)
    return str(path)


@pytest.fixture(scope="module")
def tensor_parallel(kaldi_dir):
    res = run_group(_tensor_parallel_rank, 4, 2, "cpu", args=(_audio(), kaldi_dir),
                    timeout=TIMEOUT)
    assert not any(r["jax_loaded"] for r in res)
    return res


def _jax_decoder(jmodel, frame_step):
    from vosk_tpu.ops.viterbi import BatchViterbi, DecodeParams

    return BatchViterbi(jmodel.graph, DecodeParams(**PARAMS), lattice_records=True,
                        silence_pdfs=jmodel.silence_pdfs, frame_step=frame_step,
                        optimize_graph=frame_step == "v4")


@pytest.fixture(scope="module")
def jax_runs(jmodel):
    """{(frame_step, scores): (decoder, sharded, unsharded)}: the source's
    decode_chunk_sharded on mesh (2, 4) and its decode_chunk, on the same
    scores as the port's ranks."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from vosk_tpu.parallel import mesh as jpm

    mesh = jpm.make_mesh(2, 4)
    csh = NamedSharding(mesh, P("data"))
    out = {}
    for fs in ("v4", "v3"):
        jdec = _jax_decoder(jmodel, fs)
        tables = jdec.tables
        for kind in SCORES:
            ll = _shard_scores(kind)
            B = ll.shape[0]
            ref = jdec.decode_chunk(jdec.init_frontier(B), jax.numpy.asarray(ll))
            jdec.tables = {k: jax.device_put(v, jpm.replicated(mesh)) for k, v in tables.items()}
            try:
                fr = {k: jax.device_put(v, csh) for k, v in jdec.init_frontier(B).items()}
                sh = jdec.decode_chunk_sharded(mesh, fr, jax.device_put(ll, csh))
            finally:
                jdec.tables = tables
            out[fs, kind] = (jdec, sh, ref)
    return out


# ------------------------------------------------------------------------ tests


@pytest.mark.parametrize("pack", ["packed16", "exact3"])
def test_expand_stripes_match_jax(jmodel, pack):
    """(a) Each stripe i of n = 4 through the port's plain expand (the
    kernel's oracle) and through JAX `_expand_v4` (jitted, as the sharded
    step runs it), on the JAX decoder's own rows of either layout, after a
    few frames so that the frontier is full and partly dead."""
    import jax
    import jax.numpy as jnp

    from vosk_tpu.ops.viterbi import BatchViterbi, DecodeParams

    jd = BatchViterbi(jmodel.graph, DecodeParams(**PARAMS), lattice_records=True,
                      silence_pdfs=jmodel.silence_pdfs, frame_step="v4", optimize_graph=True,
                      pack=pack)
    ll = _shard_scores("full")
    fr, *_ = jd.decode_chunk(jd.init_frontier(B_SHARD), jnp.asarray(ll[:, :15]))
    state, cost = np.array(fr["state"]), np.array(fr["cost"])
    assert np.isfinite(cost).sum(1).max() == jd.K and (state == jd.S).any()
    em_pack = torch.from_numpy(np.array(jd.em_pack).view(np.int32))  # f32 bit planes
    n, Kn = 4, jd.K // 4
    for i in range(n):
        want = jax.jit(lambda s, c, l, i=i: jd._expand_v4(s, c, l, slot_base=i, slot_stride=n))(
            jnp.asarray(state.reshape(B_SHARD, Kn, n)[:, :, i]),
            jnp.asarray(cost.reshape(B_SHARD, Kn, n)[:, :, i]), jnp.asarray(ll[:, 15]))
        got = expand_v4_plain(em_pack, torch.from_numpy(state), torch.from_numpy(cost),
                              torch.from_numpy(ll[:, 15]), jd.params.acoustic_scale, jd.S, jd.M,
                              jd.mbits, jd.pdf_bits if pack == "exact3" else None,
                              slot_base=i, slot_stride=n)
        for name, a, b in zip(("cbits", "nsm", "pm"), got, want):
            assert a.shape == (B_SHARD, Kn * jd.M)
            _eq(a, b, f"stripe {i} {name}")


@pytest.mark.parametrize("kind", SCORES)
@pytest.mark.parametrize("frame_step", ["v4", "v3", "v4_overwritten"])
def test_sharded_decode_matches_jax_and_unsharded(sharded, jax_runs, frame_step, kind):
    """(b), (d) The port's sharded decode over model = 4: every rank returns
    the same, and best, best-final, the frontier and every record plane are
    bit-equal to JAX's sharded decode (v4 records in their own layout,
    which the source swaps).  Against the unsharded decode: on the sparse
    scores, best, best-final, the frontier and the winners' record planes
    bit-equal; on the full frontiers, best and best-final.  The traceback
    of every channel equals the unsharded decode's.  "v4_overwritten": the
    same v4 decode with the nsm and pm of every BIG key of each merged pool
    overwritten by seeded garbage before the selection (the expand kernel
    leaves them unwritten): JAX's decode on clean pools all the same."""
    if frame_step == "v4_overwritten":
        assert all(n > 0 for r in sharded for n in r["overwritten"])
        # a selection a frame, sharded and unsharded, over both score sets
        assert all(len(r["overwritten"]) == 2 * (T_SHARD + 16) for r in sharded)
    r0 = sharded[0][frame_step, kind]
    frame_step = frame_step[:2]
    for r in sharded[1:]:
        for a, b in zip(r[frame_step, kind]["sharded"], r0["sharded"]):
            for k in (a if isinstance(a, dict) else {"": a}):
                _eq(a[k] if k else a, b[k] if k else b, f"rank agreement {k}")
    fr, recs, best, bestf = r0["sharded"]
    ufr, urecs, ubest, ubestf = r0["unsharded"]
    _, (jfr, jrecs, jbest, jbestf), _ = jax_runs[frame_step, kind]
    _eq(best, jbest, "best vs JAX sharded")
    _eq(bestf, jbestf, "best_final vs JAX sharded")
    _eq(best, ubest, "best vs unsharded")
    _eq(bestf, ubestf, "best_final vs unsharded")
    for k in ("state", "cost", "tsil"):
        _eq(fr[k], jfr[k], f"frontier[{k}] vs JAX sharded")
    for k in jrecs:  # v3: [B, T, L, K|R] in both; v4: the source's [B, T, K|R]
        _eq(recs[k] if frame_step == "v3" else recs[k].transpose(0, 1), jrecs[k],
            f"records[{k}] vs JAX sharded")
    if kind == "sparse":
        for k in ("state", "cost", "tsil"):
            _eq(fr[k], ufr[k], f"frontier[{k}] vs unsharded")
        for k in (("pm", "state", "f_cost") if frame_step == "v4"
                  else ("prev", "olabel", "pdf", "f_state", "f_cost")):
            _eq(recs[k], urecs[k], f"records[{k}] vs unsharded")
    assert r0["tb_sharded"] == r0["tb_unsharded"]
    live = torch.isfinite(fr["cost"]).sum(1)
    assert live.min() > 0 and (live.max() == 256) == (kind == "full")


def test_jax_v4_sharded_records_fault(sharded, jax_runs):
    """(c) The source's decode_chunk_sharded swaps v4 records to [B, T, K]
    (vosk_tpu/ops/viterbi.py:1573), which its v4 traceback (:1715) reads as
    [T, B, K]: channel 2's words differ from the unsharded decode's (seed
    2, B = 4, T = 6, tests/test_multichip.py's model).  The port keeps the
    v4 layout, and its traceback agrees."""
    jd, (jfr, jrecs, _, _), (rfr, rrecs, _, _) = jax_runs["v4", "sparse"]
    assert np.asarray(jrecs["pm"]).shape == (B_SHARD, T_SHARD, jd.K)
    assert np.asarray(rrecs["pm"]).shape == (T_SHARD, B_SHARD, jd.K)
    _, j_words, _ = jd.traceback([jrecs], jfr, 2, use_final=False)
    _, r_words, _ = jd.traceback([rrecs], rfr, 2, use_final=False)
    assert j_words != r_words
    port = sharded[0]["v4", "sparse"]
    assert tuple(port["sharded"][1]["pm"].shape) == (T_SHARD, B_SHARD, jd.K)
    _, t_words, _ = port["tb_sharded"][2]
    assert [w for w, _ in t_words] == list(r_words)


def test_data_parallel_decode_exact(data_parallel):
    """(e) Each rank decodes the channels of its data coordinate with
    decode_chunk; gathered, the frontier, the nine record planes and the
    best costs are bit-equal to one decode of every channel (the
    source's test_decode_data_parallel_exact)."""
    dec = _decoder(_model(), "v3")
    ll = torch.from_numpy(_dp_scores())
    fr, recs, best, bestf = dec.decode_chunk(dec.init_frontier(B_DP), ll)
    got = data_parallel[0]
    assert [r["local_B"] for r in data_parallel] == [B_PIPE // 4] * 4
    for k in fr:
        _eq(got["frontier"][k], fr[k], f"frontier[{k}]")
    for k in recs:
        _eq(got["records"][k], recs[k], f"records[{k}]")
    _eq(got["best"], best, "best")
    _eq(got["best_final"], bestf, "best_final")


@pytest.fixture(scope="module")
def unsharded_pipe_best():
    from vosk_tpu_torch.runtime.pipeline import FusedPipeline

    pipe = FusedPipeline(_model(), batch=B_PIPE)
    _, recs, best = pipe.run_scan(pipe.init_state(), _audio())
    return best, recs["pm"]


@pytest.mark.parametrize("n_model", [1, 2], ids=["data-parallel", "tensor-parallel"])
def test_pipeline_mesh_matches_jax(jmodel, data_parallel, tensor_parallel,
                                   unsharded_pipe_best, n_model):
    """(f) FusedPipeline(mesh) on (4, 1) and (4, 2): best costs against the
    JAX package's pipeline on the same mesh, within tests/test_multichip.py's
    tolerances (rtol 0.03 data parallel, 0.05 tensor parallel, atol 0.2:
    bf16 products summed in another order), and against the port's
    unsharded pipeline within rtol 1e-5 / atol 1e-3 (the same products over
    fewer rows or a block of columns: only BLAS's summation order moves,
    by a few f32 ulps of costs in the hundreds).  The data-parallel records
    equal the unsharded ones."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from vosk_tpu.parallel import mesh as jpm
    from vosk_tpu.runtime.pipeline import FusedPipeline as JFused

    audio = _audio()
    mesh = jpm.make_mesh(4, n_model)
    jp = JFused(jmodel, batch=B_PIPE, mesh=mesh)
    _, _, jbest = jp.run_scan(jp.init_state(),
                              jax.device_put(audio, NamedSharding(mesh, P(None, "data"))))
    got = (data_parallel if n_model == 1 else tensor_parallel)[0]["pipe_best"]
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(jbest),
                               rtol=0.03 if n_model == 1 else 0.05, atol=0.2)
    ubest, upm = unsharded_pipe_best
    np.testing.assert_allclose(got.numpy(), ubest.numpy(), rtol=1e-5, atol=1e-3)
    if n_model == 1:
        _eq(data_parallel[0]["pipe_pm"], upm, "data-parallel records[pm]")


def test_tensor_parallel_ranks_hold_their_shards(tensor_parallel):
    """(f) Each rank of the (4, 2) mesh holds 1/2 of every parameter that
    the rule shards, on the rule's axis, and the whole of the others."""
    full = _am_shapes()["test"]
    sharded = 0
    for r in tensor_parallel:
        for k, shape in full.items():
            dim = r["dims"][k]
            want = list(shape)
            if dim is not None:
                want[dim] //= 2
                sharded += 1
            assert r["shapes"][k] == tuple(want), k
    assert sharded == len(tensor_parallel) * len(full)  # at hidden 64 every one is sharded


def test_tensor_parallel_forward_with_row_sharded_output(tensor_parallel):
    """(f) A TDNN-F whose pdf count does not divide by the model size: its
    output matrix is sharded on its first axis, so that product takes the
    rank's block of the input and a SUM all-reduce, and its bias is
    replicated.  Every rank's output equals the unsharded forward within
    1e-5 of its largest value (f32: the partial sums are added in another
    order)."""
    from vosk_tpu_torch.models.tdnnf import TdnnfModel

    cfg, params, feats = _odd_am()
    with torch.no_grad():
        want = TdnnfModel(cfg, params, device="cpu")(feats)
    for r in tensor_parallel:
        assert r["odd_dims"]["output_w"] == 0 and r["odd_dims"]["output_b"] is None
        assert r["odd_dims"]["tdnn1_w"] == 1 and r["odd_dims"]["tdnn1_b"] == 0
        err = (r["odd_out"] - want).abs().max().item()
        assert err <= 1e-5 * want.abs().max().item(), err


def test_sharded_search_refuses_what_the_source_cannot_run(sharded, tensor_parallel):
    """The sharded search raises on the CSR layout (the source's sharded
    step reads padded rows, which CSR has not) and on a max-active that
    the model axis does not divide (the source asserts it); a model axis
    over an nnet3 AM does not raise: every rank runs the loaded network
    itself (test_nnet3_pipeline_over_model_axis_matches_jax)."""
    refused = sharded[0]["refused"]
    assert refused["csr"][0] == "NotImplementedError" and "csr" in refused["csr"][1]
    assert refused["k_not_divisible"][0] == "ValueError" and "254" in refused[
        "k_not_divisible"][1]
    assert all(r["nnet3_am"] for r in tensor_parallel)


@pytest.fixture(scope="module")
def unsharded_nnet3_best(kaldi_dir):
    from vosk_tpu_torch.io.native import load_any
    from vosk_tpu_torch.runtime.pipeline import FusedPipeline

    pipe = FusedPipeline(load_any(kaldi_dir, device="cpu"), batch=B_PIPE)
    return pipe.run_scan(pipe.init_state(), _audio())[2]


@pytest.mark.parametrize("reference", ["jax", "unsharded"])
def test_nnet3_pipeline_over_model_axis_matches_jax(kaldi_dir, tensor_parallel,
                                                    unsharded_nnet3_best, reference):
    """(j) FusedPipeline(mesh) on the Kaldi directory over mesh (4, 2): each
    rank runs the whole nnet3 AM on its channels, as the source's pipeline
    does (its `Nnet3Am.params` is empty, so `shard_am_params` shards
    nothing and every device computes the network whole).  Best costs
    against JAX's pipeline on mesh (4, 2) within test_pipeline_mesh_matches_
    jax's tensor-parallel tolerances (rtol 0.05, atol 0.2: another
    framework's products and sums), and against the port's unsharded
    pipeline within rtol 1e-5 / atol 1e-3 (the same products over fewer
    rows: only BLAS's summation order moves)."""
    got = tensor_parallel[0]["nnet3_best"]
    for r in tensor_parallel[1:]:
        _eq(r["nnet3_best"], got, "rank agreement")
    assert got.shape == (N_CHUNKS, B_PIPE) and torch.isfinite(got).all()
    if reference == "unsharded":
        np.testing.assert_allclose(got.numpy(), unsharded_nnet3_best.numpy(), rtol=1e-5,
                                   atol=1e-3)
        return
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    import vosk_tpu
    from vosk_tpu.parallel import mesh as jpm
    from vosk_tpu.runtime.pipeline import FusedPipeline as JFused

    mesh = jpm.make_mesh(4, 2)
    jp = JFused(vosk_tpu.Model(kaldi_dir)._model, batch=B_PIPE, mesh=mesh)
    assert jp.params == {}  # the source's Nnet3Am: nothing for the mesh to shard
    _, _, jbest = jp.run_scan(jp.init_state(),
                              jax.device_put(_audio(), NamedSharding(mesh, P(None, "data"))))
    np.testing.assert_allclose(got.numpy(), np.asarray(jbest), rtol=0.05, atol=0.2)


@pytest.mark.parametrize("n_model", [2, 4])
def test_am_param_sharding_decisions_match_jax(sharded, tensor_parallel, n_model):
    """(g) am_param_sharding decides as the source's, for every TDNN-F
    parameter of the test model and of the full-width one (40/512/96/192/
    6008), at model = 2 and 4."""
    from vosk_tpu.parallel import mesh as jpm

    got = (tensor_parallel if n_model == 2 else sharded)[0]["decisions"]
    jmesh = jpm.make_mesh(8 // n_model, n_model)
    for config, shapes in _am_shapes().items():
        for k, shape in shapes.items():
            spec = tuple(jpm.am_param_sharding(jmesh, k, shape).spec)
            want = spec.index("model") if "model" in spec else None
            assert got[config][k] == want, (config, k, shape, spec)


def test_failing_rank_raises():
    """(h) A rank that raises ends the group with its traceback, while the
    other rank waits in an all-reduce that cannot complete."""
    with pytest.raises(RankError, match="rank 1 fails on purpose"):
        run_group(_failing_rank, 1, 2, "cpu", timeout=60)
