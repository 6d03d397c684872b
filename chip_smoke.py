#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (vosk_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--rescoring-only | --pitch-only | --training-only]

(`--rescoring-only` / `--pitch-only` / `--training-only` build the kernels
and run phase 12 / 13 / 15 alone, with no result line.)  Phases, each of which raises on failure
(the script then exits non-zero and prints no result line):
  1. require CUDA; print the card's name and power limit (nvidia-smi);
  2. build the kernel library (every csrc/*.cu, one nvcc each, in
     parallel, linked into one .so) and print ptxas's registers, shared
     memory and spills per kernel; build, if absent, the native lattice
     library (make -C core libvosk_tpu_core.so);
  3. the gather kernel against its plain PyTorch version on the card, bit
     for bit, at the shapes its v4 call sites had plus a ragged N, index
     P-1 and out-of-range indices, with its time, the plain time and one
     torch.gather call's;
  4. generate the full-width bench model (TDNN-F 40/512/96/192/6008, 11
     layers, bf16; a 2M-state realistic graph with 100k words), save it as
     a native model dir and open it with BatchModel(max_batch_size=32);
     check features + AM on the card against the same modules on the CPU,
     and a few full-width decoder chunks three ways (the frame-step
     kernels, their plain versions on the same CUDA tensors, CPU):
     frontier and all five record planes must be bit-equal; then the two
     frame-step kernels (expand_v4, select_v4) against their plain
     versions, bit for bit, on one real frame at B = 32 and at B = 1
     (K = 7000, M = 4, R = 7000) and on a B = 32 frame under load (flat
     scores, channels at max-active, the whole pool in range), with
     kernel, plain and bound times,
     select's yardstick (one stable torch.sort of the same pool, the first
     of the three sorts it replaces), and expand's two ways of reading the
     ll row, five times each, interleaved; then one decode_chunk at B = 32
     under torch.profiler: its device kernels by name with counts per
     frame, where the frame step may launch only expand_v4 and select_v4's
     two kernels, at most 3 a frame, and no sort or gather;
  5. serve 8 requests of 3 s seeded noise through BatchRecognizer in 0.2 s
     pieces, with every launch count zeroed just before; every Result()
     must be JSON with a text field, both frame-step kernels must have
     launched (the gather kernel no longer runs there), and the frontier
     and records must live on the card;
  6. the gather kernel at the streaming recognizer's B = 1 shapes against
     its plain version, bit for bit, with the times;
  7. streaming on the same model directory through Model(dir,
     device="cuda") + KaldiRecognizer, counts zeroed just before: a 10.5 s
     stream in 0.2 s pieces with words on and a PartialResult every second
     (it must fold its record window at least once), a 3 s stream at 8000
     Hz through the resampler, and a 3 s stream with 3 alternatives; every
     result must have the source's JSON schema, both frame-step kernels
     must have launched, the frontier and records must live on the card,
     and the 10.5 s stream run again with the plain versions must give
     identical JSON;
  8. FusedPipeline.run_scan at bench.py's operating point with B = 32:
     0.48 s chunks, 4 s per channel, lattice records on, plausible scores
     (make_plausible_loglikes, snr 2.0) through ll_bias; one warm-up drive,
     then one timed drive with the counts zeroed just before;
  9. a full-width Kaldi V2 directory written by the port's exporter from the
     same AM (seed 0, one phone per pdf, phone 1 silence): final.mdl from
     tdnnf_to_nnet3 with an i-vector input (dim 100, seeded non-zero
     weights) grafted onto tdnn1.affine, an ivector/ dir at Kaldi's
     run_ivector_common.sh dims (512-Gaussian UBM, splice +-3, LDA to 40,
     i-vector dim 100, num-gselect 5, min-post 0.025, posterior-scale 0.1,
     max-count 100), model.conf with silence weight 0.001, and the 2M-state
     graph as HCLG.fst; the gather kernel at its shapes; Model(dir) +
     KaldiRecognizer streams 10.5 s of noise (words, a partial every
     second), counts zeroed just before; the i-vector must move off zero,
     silence weighting must run, the frontier, records, AM history and
     i-vector state must live on the card, and the stream run again with
     the plain versions must give identical JSON; then the same directory
     without the graft serves 8 x 3 s through BatchModel(max_batch_size=32);
 10. a split-graph directory (HCLr.fst + Gr.fst, export_kaldi_split_dir) from
     the same AM with a seeded 1,000-word lexicon (2-5 phones each over the
     6008 phones) and a word-loop Gr from graph/lm.py: the gather kernel at
     its shapes, one 3 s stream on the main graph and one with the runtime
     grammar '["w1 w2", "w3"]', whose words must lie in the grammar; both
     frame-step kernels must launch in both; then both against their plain
     versions on a real frame of each graph (M = 266; K = 124), with times;
 11. (run between 8 and 9, on the model of phase 4) the v3 step, for graphs
     that keep epsilon arcs: FusedPipeline(frame_step="v3") over the raw
     2M-state graph (eps rounds of depth 2); (a) two chunks of plausible
     scores at B = 32 through its decoder with the gather kernel, with the
     plain gather on the same CUDA tensors and on the CPU, all bit-equal,
     and one of them profiled (the sort kernels' device time a frame);
     (b) run_scan at phase 8's point, counts zeroed just before: 2 + 2 x 2
     = 6 gather launches a decoded frame and no v4 kernel; (c) a native
     directory of the same AM whose graph has a seeded 30 % of its eps arcs
     labeled with words: Model + KaldiRecognizer must pick v3 under
     "auto", stream 10.5 s (it folds) with identical JSON under the plain
     gather, then BatchModel serves 8 x 3 s; (d) the gather kernel at the
     four v3 shapes.
 12. (run after 10) LM rescoring, on a realistic 200,000-state graph over the
     same 100k words (the one cut, for load time): (a) phase 9's Kaldi
     directory (i-vector graft, ivector/) with rescore/ (a seeded 3-gram,
     about 10^5 bigrams and 10^5 trigrams, as G.carpa from the port's
     builder; its bigram as G.fst) and a TDNN-LSTM rnnlm/ at the widths of
     Kaldi's swbd TDNN-LSTM RNNLM recipe (embedding 1024, two fast-lstmp
     layers of cell 1024 with projections 256 + 256, ReLU TDNN layers;
     20,000 sparse word features): Model(dir) + KaldiRecognizer streams
     10.5 s (it folds), counts zeroed just before; it must rescore (carpa
     lookups and RNNLM histories > 0), launch both frame-step kernels, keep
     the RNNLM and the frontier on the card, and give identical JSON with
     the plain versions; then the RNNLM on the card against the same
     rescorer on the CPU for 64 seeded histories (largest logit difference
     under 1e-3); (b) the directory without the graft, with rescore/ only,
     serves 8 x 3 s through BatchModel, which must rescore; (c) a native
     directory of the TDNN-F with g.npz, rescore.arpa and a GRU rnnlm/
     (1024/1024): one 3 s stream, and the GRU step on the card against
     the CPU (under 1e-3).
 13. (run after 12) online pitch and speaker identification: (a) a Kaldi V2
     directory from the port's exporter with conf/pitch.conf
     (--sample-frequency=16000, as egs/aishell/s5's): the bench TDNN-F
     with a 43-dim input (40 MFCC-hires + 3 pitch, aishell's chain
     input), 43/512/96/192/6008, 11 layers, subsample 3, on phase 12's
     200,000-state graph (the cut, for load time), and no i-vector (a
     second cut); Model(dir) + KaldiRecognizer stream 10.5 s of a seeded
     voiced signal (harmonics of an f0 gliding over 100-300 Hz, noise at
     10 dB SNR) in 0.2 s pieces, words on, a PartialResult every second,
     counts zeroed just before: both frame-step kernels must launch, the
     pitch state must live on the card, the plain versions must give
     identical JSON, and the stream's pitch features on the card must
     match the CPU's (utils/pitchcheck.py: lags equal off ties, POV
     feature 1e-3, log pitch and delta 1e-4, MFCC 1e-3); the pitch stage's
     device events for one 0.2 s piece at B = 1 and 32; then BatchModel
     serves 8 x 3 s; (b) a Kaldi speaker dir with the node graph of the
     VoxCeleb x-vector recipe at its widths (input 30, relu-batchnorm 512
     x 4 and 1500, the mean+stddev stats pair, tdnn6.affine 3000 -> 512,
     mean.vec, transform.mat 200 x 512): SpkModel(dir) on the card, and
     KaldiRecognizer(model, 16000, spk) on (a)'s model streams the signal,
     counts zeroed just before: FinalResult must carry 200 finite `spk`
     values and spk_frames >= 50, and the x-vector must match the same
     model on the CPU within 1e-4; FinalResult time with and without it.
 14. (run after 13) the v4 step on exact3 rows and the entry points:
     (a) the bench TDNN-F with 20,000 pdfs (the first round width above
     2^14, so packed16 rows cannot hold its pdf ids) on phase 12's
     200,000-state graph, pdf ids over 0..19,999, as a native dir:
     Model + KaldiRecognizer stream 10.5 s of noise, counts zeroed just
     before; the decoder must be v4 on exact3 rows, the plain versions
     must give identical JSON; BatchModel serves 8 x 3 s; both frame-step
     kernels against their plain versions, bit for bit, on a real frame
     at B = 1 and under load at B = 32, with times and bounds; (b) the
     port's websocket server (ASRServer) on phase 4's dir (phase 7's
     Model) at 127.0.0.1: four concurrent clients stream 3 s of noise in
     8000-byte chunks, words on; each final must equal a direct
     KaldiRecognizer's; round trip per chunk (p50, max); (c) the
     transcriber CLI (txt, srt) on a 10 s WAV, and the same WAV through
     --server against (b)'s server: the same words; (d) the C ABI:
     libvosk_tpu_torch.so built, core/test/test_vosk.c and test_vosk_mt.c
     (4 threads) compiled against it into its build directory and run on
     the WAV with phase 4's dir (words.txt gains "one", which test_vosk.c
     looks up), VOSK_TPU_TORCH_DEVICE unset: both must exit 0 and print
     what a direct recognizer returns, test_vosk_mt.c's 4 threads must
     reach MT_MIN_SCALING over a warmed model (and run once more without
     the model's turn lock, for comparison), and their processes' kernel
     counts must show both frame-step kernels.
 15. (run after 14) training: (a) the bench TDNN-F (40/512/96/192/6008,
     11 layers, bf16) on a seeded minibatch of 64 chunks of 150 frames
     (forward_utterance adds the context), 50 output frames of seeded pdf
     labels, the denominator from those alignments (S = 6008, leak 0.1):
     one LF-MMI step on the CPU, then three on the card (chain_trainer,
     train_chain's loop): every loss and gradient norm finite, step 1's
     loss within 1e-3 and gradient norm within 1e-2 of the CPU's (bf16
     products summed in another order); step 2 timed after the warm
     step 1 (peak memory beside it), step 3 profiled (device events);
     den_logprob forward plus backward alone (CUDA events, device events);
     one frame-CE step, finite; (b) the recipe demo (training/recipe.py,
     chain, 24 train and 6 dev utterances, 400 steps) on the card, counts
     zeroed just before stage 5: both frame-step kernels must launch in
     its decode and the dev WER must be at most 0.15 (the bound
     tests/test_chain.py puts on the source); seconds per stage; (c) three
     RNNLM steps at phase 12's native GRU dims (1024/1024) over its
     vocabulary (100,001 words), 32 seeded sentences: losses finite, step
     1 within 1e-4 of the CPU's.  Each path's counts are zeroed just
     before it and read just after.
The line before the last is the kernel table as JSON (bounds from the
bytes and operations each call's data needs, over the H100 SXM data
sheet's 3.35 TB/s and 67 TFLOP/s in f32); the last line is
{"ok": true, "device": {...}}.  Weights and audio come from fixed seeds;
nothing is downloaded.
"""
from __future__ import annotations

import gc
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 0
B = 32
N_REQUESTS = 8
REQUEST_SECONDS = 3.0
HBM_BYTES_PER_S = 3.35e12   # H100 SXM, NVIDIA data sheet
F32_OPS_PER_S = 67e12       # f32 outside the tensor cores


def log(msg: str) -> None:
    print(msg, flush=True)


def event_ms(torch, fn, n=100):
    """Device time of one call of fn, from CUDA events around n calls
    enqueued behind a device-side sleep (so host launch overhead is not
    timed), after a warm-up."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def bits(torch, x):
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def bit_err(torch, a, b):
    """Largest distance between the 32-bit patterns of a and b (0 iff
    bit-equal): the kernels are held to their plain versions bit for bit."""
    return int((bits(torch, a).long() - bits(torch, b).long()).abs().max().item()) \
        if a.numel() else 0


def bound(nbytes, ops=0):
    """(least milliseconds the card could take, what bounds it)."""
    b_ms, o_ms = nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_OPS_PER_S * 1e3
    return (b_ms, "bytes") if b_ms >= o_ms else (o_ms, "operations")


def zero_counts():
    """Every kernel's launch count to 0, just before a path is driven."""
    from vosk_tpu_torch.ops.frame_step import expand_v4, select_v4
    from vosk_tpu_torch.ops.gather import gather_rows

    expand_v4.launches = select_v4.launches = gather_rows.launches = 0


V4_KERNELS = ("expand_v4", "select_v4")  # the v4 step's kernels
# test_vosk_mt.c's floor on 4 threads' throughput over one thread's.  Its
# own x1.5 holds the JAX engine.  The port's recognizers take turns at the
# card (NativeModel.turn_lock), so threads add no throughput but must not
# lose it either, as they did without the turns (this phase runs both;
# PERF.md §6); x1.5 needs streams batched across threads (ROADMAP C)
MT_MIN_SCALING = "0.6"
V3_KERNELS = ("gather_rows",)             # the v3 step's kernel


def read_counts(what, need=V4_KERNELS):
    """{kernel: launches} since zero_counts(); raises unless every kernel
    in `need` (the path's step) launched and no other step's kernel did."""
    from vosk_tpu_torch.ops.frame_step import expand_v4, select_v4
    from vosk_tpu_torch.ops.gather import gather_rows

    counts = {"expand_v4": expand_v4.launches, "select_v4": select_v4.launches,
              "gather_rows": gather_rows.launches}
    other = V3_KERNELS if need == V4_KERNELS else V4_KERNELS
    if any(counts[k] <= 0 for k in need) or any(counts[k] for k in other):
        raise AssertionError(f"{what} did not launch exactly the kernels {need}: {counts}")
    return counts


def on_device(records) -> bool:
    """Every plane of one chunk's decoder records is a CUDA tensor."""
    return all(v.is_cuda for v in records.values())


def count_line(counts) -> str:
    return ", ".join(f"{k} launches {v}" for k, v in counts.items())


def phase_kernel(torch, dev, cases=(
        ("ll", "float32", B, 6008, 28000),   # acoustic lookup ll[b, pdf]
        ("tsil", "int32", B, 7000, 7000),    # trailing-silence lookup
        ("ragged", "float32", 3, 300, 4097),  # N one past a block
)):
    from vosk_tpu_torch.ops.gather import gather_rows, gather_rows_plain

    g = torch.Generator().manual_seed(SEED)
    results = {}
    cases = [(name, getattr(torch, dt), b, P, N) for name, dt, b, P, N in cases]
    max_err = 0.0
    for name, dtype, b, P, N in cases:
        if dtype == torch.float32:
            table = torch.randn((b, P), generator=g)
        else:
            table = torch.randint(-(2**31), 2**31 - 1, (b, P), generator=g,
                                  dtype=torch.int64).int()
        idx = torch.randint(0, P, (b, N), generator=g, dtype=torch.int32)
        idx[0, 0], idx[0, 1], idx[-1, -1], idx[-1, 2] = P - 1, P, -1, 2**31 - 1
        table, idx = table.to(dev), idx.to(dev)
        got = gather_rows(table, idx)
        ref = gather_rows_plain(table, idx)
        torch.cuda.synchronize()
        if not torch.equal(bits(torch, got), bits(torch, ref)):
            raise AssertionError(f"gather kernel != torch.gather at {name} {b}x{P}<-{N}")
        if got[0, 1].item() != 0 or got[-1, -1].item() != 0:
            raise AssertionError("out-of-range index did not give 0")
        max_err = max(max_err, (got.double() - ref.double()).abs().max().item())
        ms = event_ms(torch, lambda: gather_rows(table, idx))
        plain_ms = event_ms(torch, lambda: gather_rows_plain(table, idx))
        # the library yardstick: one bare torch.gather, on the same indices
        # clamped into [0, P) (it asserts on the out-of-range ones)
        idx_long = idx.clamp(0, P - 1).long()
        lib_ms = event_ms(torch, lambda: torch.gather(table, 1, idx_long))
        # the table entries the indices reach, each index, each output
        inb = (idx >= 0) & (idx < P)
        reached = sum(int(torch.unique(row[m]).numel()) for row, m in zip(idx, inb))
        b_ms, b_by = bound(4 * reached + 8 * b * N)
        results[name] = (ms, plain_ms, b_ms, b_by, lib_ms)
        log(f"gather {name} [{b},{P}] <- [{b},{N}] {dtype}: bit-equal; "
            f"kernel {ms:.6f} ms, plain {plain_ms:.6f} ms, torch.gather {lib_ms:.6f} ms, "
            f"bound {b_ms:.6f} ms ({b_by}), {b_ms / ms:.1%} of it")
    return results, max_err


def expand_work(torch, dec, fr, P):
    """(bytes, operations) that expand_v4 must move and do on frontier fr:
    every token state; cost and arc row of each live token (packed16: the
    pdf words of all M slots and the next states of the finite arcs;
    exact3: the weights of all M slots, next state and meta of the finite
    arcs); the ll entries those finite arcs reach, once per channel; the
    three [B, K*M] outputs."""
    Bn, K = fr["state"].shape
    M, S = dec.M, dec.S
    live = fr["state"] != S
    b_of = torch.nonzero(live)[:, 0]
    rows = dec.em_pack[fr["state"][live].long()]
    if dec.pack == "exact3":
        finite = torch.isfinite(rows[:, :M].contiguous().view(torch.float32))
        pdf = rows[:, 2 * M:3 * M] & ((1 << dec.pdf_bits) - 1)
        per_finite = 8
    else:
        p1 = rows[:, :M]
        finite = ((p1 >> 16) & 0x7C00) != 0x7C00  # f16 exponent not all ones
        pdf = p1 & 0x3FFF
        per_finite = 4
    hit = finite & (pdf < P)
    reached = torch.unique(b_of[:, None].expand_as(pdf)[hit].long() * (1 << 32) + pdf[hit])
    n_live, n_fin = int(live.sum()), int(finite.sum())
    nbytes = (4 * Bn * K + 4 * n_live + 4 * M * n_live + per_finite * n_fin
              + 4 * reached.numel() + 12 * Bn * K * M)
    return nbytes, 3 * n_fin  # an add and a fused multiply-add per finite arc


def select_work(torch, pool, valid, beam, lattice_beam, rec):
    """(bytes, operations) that select_v4 must move and do on this frame:
    on a valid channel, every candidate's key, the next state and pm word
    of each candidate within reach of the beams (key at most the range that
    the channel's best key gives, the cut the kernel makes), and the old
    silence count of each kept winner; on a masked channel the old
    frontier; the new frontier and the five record planes once."""
    from vosk_tpu_torch.ops.frame_step import BIG_I32, bits_cost, cost_bits

    cbits = pool[0]
    Bn, E = cbits.shape
    K, R = rec["pm"].shape[1], rec["lat_pm"].shape[1]
    best = cbits.amin(dim=1, keepdim=True)
    f = bits_cost(best) + beam
    u = torch.where(torch.isnan(f), torch.where(cost_bits(f) > 0, float("inf"),
                                                float("-inf")), f + lattice_beam)
    lim = torch.maximum(cost_bits(f), cost_bits(torch.nan_to_num(u, nan=float("inf"))))
    in_range = ((cbits <= lim) & (cbits < BIG_I32)).sum(dim=1)
    kept = (rec["pm"] >= 0).sum(dim=1)
    v = valid.long()
    nbytes = int((v * (4 * E + 8 * in_range + 4 * kept) + (1 - v) * 12 * K).sum())
    nbytes += Bn + Bn * (12 * K + 12 * K + 8 * R)
    return nbytes, Bn * (R + 2)  # the beam and lattice-beam additions, one compare a row


def phase_frame_step(torch, name, dec, fr, ll, valid):
    """expand_v4 and select_v4 against their plain versions on one real
    frame of `dec`: frontier fr [B, K] on the card, ll [B, T, P] with frame
    T-1 read in place.  Returns {kernel: (ms, plain_ms, bound_ms, bound_by,
    max_abs_err, library_ms)}; every output must be bit-equal."""
    from vosk_tpu_torch.ops import frame_step as fs

    Bn, K = fr["state"].shape
    M, R, S, P = dec.M, dec.R, dec.S, ll.shape[2]
    llt = ll[:, -1]
    ex = (dec.em_pack, fr["state"], fr["cost"], llt, dec.params.acoustic_scale, S, M,
          dec.mbits, dec.pdf_bits if dec.pack == "exact3" else None)
    err = {"expand_v4": 0, "select_v4": 0}
    ref = fs.expand_v4_plain(*ex)
    for stage in (None, *fs.EXPAND_STAGES):  # the kernel's choice, then each forced
        for a, b in zip(fs.expand_v4(*ex, stage=stage), ref):
            err["expand_v4"] = max(err["expand_v4"], bit_err(torch, a, b))
            if not torch.equal(a, b):
                raise AssertionError(f"expand_v4 kernel (ll read: {stage}) != plain at {name}")
    sel = (*ref, fr, valid, dec.params.beam, dec.params.lattice_beam, S, dec.mbits, dec.K2, R)
    outs = [dec.record_buffers((2, Bn)) for _ in range(2)]
    k_out = {k: v[1] for k, v in outs[0].items()}
    p_out = {k: v[1] for k, v in outs[1].items()}
    kf, krec = fs.select_v4(*sel, k_out, scratch=dec._select_scratch)
    pf, prec = fs.select_v4_plain(*sel, p_out)
    torch.cuda.synchronize()
    for what, got, want in (("frontier", kf, pf), ("records", krec, prec)):
        for k in got:
            err["select_v4"] = max(err["select_v4"], bit_err(torch, got[k], want[k]))
            if not torch.equal(bits(torch, got[k]), bits(torch, want[k])):
                raise AssertionError(f"select_v4 kernel != plain at {name}: {what}[{k}]")
    live = int((fr["state"] != S).sum())
    kept = int((pf["cost"] < float("inf")).sum())
    # bounds from what this frame needs: each needed input byte read once,
    # each output byte written once
    ex_b = bound(*expand_work(torch, dec, fr, P))
    sel_b = bound(*select_work(torch, ref, valid, dec.params.beam, dec.params.lattice_beam,
                               prec))
    cbits = ref[0]
    out = {}
    for kname, kern, plain, (b_ms, b_by), lib in (
            ("expand_v4", lambda: fs.expand_v4(*ex), lambda: fs.expand_v4_plain(*ex), ex_b,
             None),
            # yardstick: the first of the three stable sorts select_v4 replaces
            ("select_v4", lambda: fs.select_v4(*sel, k_out, scratch=dec._select_scratch), lambda: fs.select_v4_plain(*sel, p_out),
             sel_b, lambda: torch.sort(cbits, dim=1, stable=True))):
        ms, plain_ms = event_ms(torch, kern), event_ms(torch, plain)
        lib_ms = event_ms(torch, lib) if lib else None
        out[kname] = (ms, plain_ms, b_ms, b_by, err[kname], lib_ms)
        log(f"{kname} {name} ({dec.pack} rows) B={Bn} K={K} M={M} R={R} K2={dec.K2} P={P}, "
            f"{live} live tokens, "
            f"{kept} kept: bit-equal to plain; kernel {ms:.6f} ms, plain {plain_ms:.6f} ms"
            + (f", stable torch.sort of the pool {lib_ms:.6f} ms" if lib else "")
            + f", bound {b_ms:.6f} ms ({b_by}), {b_ms / ms:.1%} of it")
    # the ll row staged in shared memory (bulk copy) against read in place,
    # five times each, interleaved: median [min, max]
    reps = {st: [] for st in fs.EXPAND_STAGES}
    for _ in range(5):
        for st, ts in reps.items():
            ts.append(event_ms(torch, lambda st=st: fs.expand_v4(*ex, stage=st)))
    log(f"expand_v4 {name}, ll row read 5 x interleaved: " + "; ".join(
        f"{st} {sorted(ts)[2]:.6f} [{min(ts):.6f}, {max(ts):.6f}] ms"
        for st, ts in reps.items()))
    return out


def phase_profile(torch, dec, fr, ll, valid):
    """One decode_chunk at B = 32 under torch.profiler: device kernels by
    name with launches per frame.  The frame step may launch only the
    expand_v4 and select_v4 kernels, at most 3 a frame, and no sort or
    gather; the rest (the chunk-end reductions) must not repeat per frame.
    Returns {kernel name: launches per frame}."""
    from torch.profiler import ProfilerActivity, profile

    T = ll.shape[1]
    dec.decode_chunk(fr, ll, valid)  # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        dec.decode_chunk(fr, ll, valid)
        torch.cuda.synchronize()
    rows = {}  # device kernel, copy or memset: (launches, device us)
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            c, us = rows.get(ev.name, (0, 0.0))
            rows[ev.name] = (c + 1, us + ev.time_range.elapsed_us())
    if not rows:
        raise AssertionError("the profiler recorded no device kernel")
    step = {k: v for k, v in rows.items() if "expand_v4" in k or "select_v4" in k}
    per_frame = {k: c / T for k, (c, _) in rows.items()}
    log(f"profiled decode_chunk B={fr['state'].shape[0]} T={T}: device kernels (launches per "
        f"frame, device us per frame): " + json.dumps(
            {k: [per_frame[k], round(us / T, 3)] for k, (c, us) in sorted(rows.items())}))
    bad = [k for k in rows if "sort" in k.lower() or "gather" in k.lower()]
    repeats = [k for k, (c, _) in rows.items() if k not in step and c >= T]
    if bad or repeats or not step or sum(c for c, _ in step.values()) > 3 * T:
        raise AssertionError(f"the frame step launched more than its kernels: sort/gather "
                             f"{bad}, per-frame others {repeats}, frame-step kernels {step}")
    return per_frame


def phase_model(torch, dev, tmp):
    from vosk_tpu_torch.io import native
    from vosk_tpu_torch.utils import benchdata

    t0 = time.perf_counter()
    m = benchdata.make_bench_model(seed=SEED, device=dev)
    t_gen = time.perf_counter() - t0
    path = Path(tmp) / "bench_model"
    native.save_model(path, m.config, m.am_params, m.graph, m.words, m.phones,
                      m.phone_of_pdf, m.silence_pdfs)
    import vosk_tpu_torch

    t0 = time.perf_counter()
    bm = vosk_tpu_torch.BatchModel(str(path), max_batch_size=B, device=dev)
    torch.cuda.synchronize()
    t_load = time.perf_counter() - t0
    dec = bm._pipeline.dec
    log(f"model: generated in {t_gen:.3f} s; BatchModel load incl. graph prep "
        f"{t_load:.3f} s; prepared graph {dec.S} states, M={dec.M}, "
        f"{int((dec.dense_w < float('inf')).sum())} arcs, K={dec.K}, R={dec.R}")
    return bm


def phase_front_end(torch, bm):
    """Features + AM on the card against the same modules on the CPU."""
    import numpy as np

    from vosk_tpu_torch.models.tdnnf import TdnnfModel
    from vosk_tpu_torch.ops.features import FeatureExtractor

    p = bm._pipeline
    rng = np.random.default_rng(SEED + 1)
    chunk = (rng.standard_normal((B, p.chunk_samples)) * 500).astype(np.float32)
    ex_cpu = FeatureExtractor(p.ex.opts, device="cpu")
    am_cpu = TdnnfModel(p.am.cfg, p.model.am_params, device="cpu")
    outs = []
    for ex, am, d in ((p.ex, p.am, p.device), (ex_cpu, am_cpu, "cpu")):
        fs, feats, fv = ex.extract_chunk(ex.init_stream_state(B, p.chunk_samples),
                                         torch.from_numpy(chunk).to(d))
        a = am.init_stream_state(B, p.max_feat_frames)
        for _ in range(3):  # fill the AM context so outputs are emitted
            a, ll, lv = am.process_chunk(a, feats, fv)
        outs.append((feats.cpu(), ll.cpu(), lv.cpu()))
    (fg, lg, vg), (fc, lc, vc) = outs
    feat_err = (fg - fc).abs().max().item()
    ll_err = (lg - lc).abs().max().item()
    scale = lc.abs().max().item()
    log(f"front end on card vs CPU: MFCC max abs diff {feat_err:.3e} (bound 1e-3), "
        f"AM bf16 max abs diff {ll_err:.3e} (bound 2e-2 x max|ll| = {2e-2 * scale:.3e})")
    if not torch.equal(vg, vc) or not vg.any():
        raise AssertionError("AM output masks differ between card and CPU")
    if not (feat_err <= 1e-3 and ll_err <= 2e-2 * scale and torch.isfinite(lg).all()):
        raise AssertionError("features/AM on the card disagree with the CPU")
    # one bf16 layer against the exact product of the same bf16-rounded
    # operands: f32 products differ by summation order only (~1e-6), while
    # products rounded to bf16 would be ~1e-2 off at these magnitudes
    w = p.am.params["tdnn1_w"]
    x = torch.from_numpy(rng.standard_normal((256, w.shape[0])).astype(np.float32))
    got = p.am._mm(x.to(p.device), w).cpu()
    ref = x.to(torch.bfloat16).double() @ w.cpu().double()
    mm_err = (got.double() - ref).abs().max().item()
    log(f"AM bf16 layer on card vs exact product of bf16 operands: max abs diff "
        f"{mm_err:.3e} (bound 1e-4, outputs up to {ref.abs().max().item():.3f})")
    if got.dtype != torch.float32 or not mm_err <= 1e-4:
        raise AssertionError("bf16 AM layer does not keep f32 products on the card")


def phase_decoder(torch, bm):
    """Full-width decoder chunks: the frame-step kernels vs their plain
    versions on the same CUDA tensors vs the CPU (plain) decoder, bit for
    bit; then both kernels on one real frame at B = 32 and at B = 1."""
    from vosk_tpu_torch.ops import frame_step

    dec = bm._pipeline.dec
    g = torch.Generator().manual_seed(SEED + 2)
    T, P = 7, bm._model.am_config.num_pdfs
    chunks = [torch.randn((B, T, P), generator=g) * 2.0 for _ in range(3)]
    valid = torch.ones((B, T), dtype=torch.bool)
    valid[1, 2:4] = False

    def run(d, ops, device):
        d.step_ops = ops
        fr = d.init_frontier(B)
        recs, times = [], []
        for ll in chunks:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fr, rec, best, bestf = d.decode_chunk(fr, ll.to(device), valid.to(device))
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            recs.append({k: v.cpu() for k, v in rec.items()})
        return {k: v.cpu() for k, v in fr.items()}, recs, times

    try:
        k_fr, k_recs, k_t = run(dec, frame_step.KERNELS, dec.device)
        p_fr, p_recs, p_t = run(dec, frame_step.PLAIN, dec.device)
    finally:
        dec.step_ops = frame_step.KERNELS
    c_fr, c_recs, _ = run(dec.to("cpu"), frame_step.KERNELS, "cpu")
    for name, (fr, recs) in {"plain versions": (p_fr, p_recs), "CPU": (c_fr, c_recs)}.items():
        for k in k_fr:
            if not torch.equal(bits(torch, k_fr[k]), bits(torch, fr[k])):
                raise AssertionError(f"decoder frontier[{k}]: kernel != {name}")
        for a, b in zip(k_recs, recs):
            for k in a:
                if not torch.equal(bits(torch, a[k]), bits(torch, b[k])):
                    raise AssertionError(f"decoder records[{k}]: kernel != {name}")
    live = torch.isfinite(k_fr["cost"]).sum(1)
    log(f"decoder B={B} K={dec.K} T={T}x{len(chunks)}, acoustic scale "
        f"{dec.params.acoustic_scale}: frontier + 5 record planes bit-equal kernels / "
        f"plain / CPU; live tokens min {live.min().item()} max {live.max().item()}; chunk "
        f"seconds kernels {[round(x, 4) for x in k_t]} plain {[round(x, 4) for x in p_t]}")
    # one real frame: the frontier after 2 chunks and T-1 frames of the third
    fr = {k: v.to(dec.device) for k, v in k_fr.items()}
    ll = chunks[2].to(dec.device)
    fr, _, _, _ = dec.decode_chunk(fr, ll[:, :T - 1], valid[:, :T - 1].to(dec.device))
    vt = valid[:, T - 1].to(dec.device)
    times = {
        "b32": phase_frame_step(torch, "batch", dec, fr, ll, vt),
        "b1": phase_frame_step(torch, "streaming", dec, {k: v[:1].contiguous() for k, v in fr.items()},
                               ll[:1], vt[:1]),
    }
    profile = phase_profile(torch, dec, fr, ll, valid.to(dec.device))
    fr, ll = loaded_frame(torch, bm)
    times["loaded"] = phase_frame_step(torch, "loaded", dec, fr, ll,
                                       torch.ones(B, dtype=torch.bool, device=dec.device))
    return times, profile


def loaded_frame(torch, bm, frames=32):
    """A B = 32 frame under load: the frontier after `frames` frames of flat
    seeded scores (N(0, 0.1^2) log-likelihoods: every arc stays within the
    beam, as in speech the model cannot yet tell apart), whose channels
    fill to max-active and keep their whole pool in range, and the chunk
    whose last frame is next."""
    dec = bm._pipeline.dec
    P = bm._model.am_config.num_pdfs
    g = torch.Generator().manual_seed(SEED + 11)
    ll = (torch.randn((B, frames + 1, P), generator=g) * 0.1).to(dec.device)
    fr, _, _, _ = dec.decode_chunk(dec.init_frontier(B), ll[:, :frames])
    return fr, ll


def real_frame(torch, dec, P, seed, frames=6):
    """A frontier of dec at B = 1 after `frames` frames of seeded scores
    over P pdfs, and the chunk [1, frames + 1, P] whose last frame is next."""
    g = torch.Generator().manual_seed(seed)
    ll = (torch.randn((1, frames + 1, P), generator=g) * 2.0).to(dec.device)
    fr, _, _, _ = dec.decode_chunk(dec.init_frontier(1), ll[:, :frames])
    return fr, ll, torch.ones(1, dtype=torch.bool, device=dec.device)


def phase_serving(torch, bm, need=V4_KERNELS):
    import numpy as np

    import vosk_tpu_torch

    p = bm._pipeline
    rate = int(p.rate)
    rng = np.random.default_rng(SEED + 3)
    n = int(REQUEST_SECONDS * rate)
    pcms = [np.clip(rng.standard_normal(n) * 500, -32768, 32767).astype("<i2").tobytes()
            for _ in range(N_REQUESTS)]
    piece = p.chunk_samples * 2  # 0.2 s of PCM16
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated() / 2**30
    zero_counts()  # every kernel count, just before the main path
    t_all = time.perf_counter()
    recs = [vosk_tpu_torch.BatchRecognizer(bm, rate) for _ in range(N_REQUESTS)]
    step_s = []
    on_card = False
    for off in range(0, len(pcms[0]), piece):
        for r, pcm in zip(recs, pcms):
            r.AcceptWaveform(pcm[off: off + piece])
        t0 = time.perf_counter()
        bm.Wait()  # one pipeline step: one chunk for every open stream
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        ch = recs[0]._channel
        on_card = on_card or bool(p._records[ch] and on_device(p._records[ch][-1])
                                  and p._frontier["state"].is_cuda)
    results = []
    for r in recs:
        r.FinishStream()
        while True:
            out = r.Result()
            if not out:
                break
            results.append(json.loads(out))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_all
    launches = read_counts("the serving path", need)
    if not on_card:
        raise AssertionError("frontier/records were not CUDA tensors")
    if len(results) < N_REQUESTS or not all(isinstance(x.get("text"), str) for x in results):
        raise AssertionError(f"bad results: {results}")
    steps = np.array(step_s)
    audio_s = N_REQUESTS * REQUEST_SECONDS
    log(f"serving {N_REQUESTS} x {REQUEST_SECONDS} s in 0.2 s pieces, B={B}: "
        f"{len(results)} JSON results, {len(step_s)} chunk steps; per-chunk step "
        f"p50 {np.median(steps) * 1e3:.3f} ms max {steps.max() * 1e3:.3f} ms; "
        f"wall {wall:.3f} s incl. finishing; {audio_s / wall:.3f} audio-s/s; "
        f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB "
        f"({base:.3f} GiB allocated before the first request); {count_line(launches)}")
    log("results: " + json.dumps([x["text"][:40] for x in results]))
    return launches


def check_schema(out: str, kind: str) -> dict:
    """A KaldiRecognizer result against the source's JSON schema."""
    res = json.loads(out)
    word_keys = {"conf", "end", "start", "word"}
    if kind == "partial":
        ok = isinstance(res.get("partial"), str) and set(res) <= {"partial", "partial_result"}
    elif kind == "final":
        ok = isinstance(res.get("text"), str) and set(res) <= {"text", "result"} and all(
            set(w) == word_keys for w in res.get("result", []))
    else:  # alternatives
        alts = res.get("alternatives")
        ok = set(res) == {"alternatives"} and isinstance(alts, list) and alts and all(
            isinstance(a.get("text"), str) and isinstance(a.get("confidence"), float)
            and all(set(w) == word_keys - {"conf"} for w in a.get("result", []))
            for a in alts)
    if not ok:
        raise AssertionError(f"{kind} result does not have the source's schema: {out}")
    return out


def noise_pcm(seconds, rate, seed):
    import numpy as np

    rng = np.random.default_rng(seed)
    return np.clip(rng.standard_normal(int(seconds * rate)) * 500, -32768,
                   32767).astype("<i2").tobytes()


def stream_long(model, pcm, rate):
    """The 10.5 s stream: 0.2 s pieces, words on, a PartialResult every
    second, then FinalResult.  Returns (every result string, timings)."""
    import numpy as np

    import vosk_tpu_torch

    rec = vosk_tpu_torch.KaldiRecognizer(model, rate)
    rec.SetWords(True)
    r = rec._rec
    piece = int(0.2 * rate) * 2
    outs, accept_s, partial_s = [], [], []
    first_fold_s, on_card = None, True
    for i, off in enumerate(range(0, len(pcm), piece)):
        t0 = time.perf_counter()
        hit = rec.AcceptWaveform(pcm[off: off + piece])
        accept_s.append(time.perf_counter() - t0)
        if hit:
            outs.append(check_schema(rec.Result(), "final"))
        if first_fold_s is None and r.metrics.count.get("fold"):
            first_fold_s = r.metrics.total_s["fold"]
        if r._records:
            on_card = on_card and r._frontier["state"].is_cuda and on_device(r._records[-1])
        if i % 5 == 4:
            t0 = time.perf_counter()
            outs.append(check_schema(rec.PartialResult(), "partial"))
            partial_s.append(time.perf_counter() - t0)
    folded = r._folded_frames
    on_card = on_card and all(v.is_cuda for v in r._am_state.values())
    t0 = time.perf_counter()
    outs.append(check_schema(rec.FinalResult(), "final"))
    final_s = time.perf_counter() - t0
    if not on_card:
        raise AssertionError("the recognizer's frontier/records were not CUDA tensors")
    if folded <= 0 or first_fold_s is None:
        raise AssertionError("the 10.5 s stream never folded its record window")
    return outs, dict(accept=np.array(accept_s), partial=np.array(partial_s),
                      first_fold=first_fold_s, final=final_s, folded=folded,
                      stages=rec.GetMetrics()["stages"], rec=r)


def phase_streaming(torch, path):
    """KaldiRecognizer on the full-width model; returns the kernels' launch
    counts over the three streams, and the model (phase 14 serves it)."""
    import numpy as np

    import vosk_tpu_torch
    from vosk_tpu_torch.ops import frame_step

    t0 = time.perf_counter()
    model = vosk_tpu_torch.Model(str(path), device="cuda")
    vosk_tpu_torch.KaldiRecognizer(model, 16000)  # builds the shared decoder
    torch.cuda.synchronize()
    log(f"streaming: Model + first KaldiRecognizer (graph prep) "
        f"{time.perf_counter() - t0:.3f} s")
    dec = model._model.shared_decoder()
    long_pcm = noise_pcm(10.5, 16000, SEED + 4)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()  # every kernel count, just before the main path
    outs, t = stream_long(model, long_pcm, 16000)
    rec = vosk_tpu_torch.KaldiRecognizer(model, 8000)
    rec.SetWords(True)
    pcm8 = noise_pcm(3.0, 8000, SEED + 5)
    for off in range(0, len(pcm8), 3200):
        rec.AcceptWaveform(pcm8[off: off + 3200])
    res8 = check_schema(rec.FinalResult(), "final")
    rec = vosk_tpu_torch.KaldiRecognizer(model, 16000)
    rec.SetMaxAlternatives(3)
    pcm_alt = noise_pcm(3.0, 16000, SEED + 6)
    for off in range(0, len(pcm_alt), 6400):
        rec.AcceptWaveform(pcm_alt[off: off + 6400])
    res_alt = check_schema(rec.FinalResult(), "alternatives")
    torch.cuda.synchronize()
    launches = read_counts("the streaming path")
    peak = torch.cuda.max_memory_allocated() / 2**30
    # the same 10.5 s stream through the plain versions (single-threaded, so
    # swapping the shared decoder's step ops is safe): identical JSON
    dec.step_ops = frame_step.PLAIN
    try:
        plain_outs, _ = stream_long(model, long_pcm, 16000)
    finally:
        dec.step_ops = frame_step.KERNELS
    if plain_outs != outs:
        raise AssertionError("the 10.5 s stream differs between the kernels and the plain "
                             "versions")
    a = t["accept"]
    log(f"streaming 10.5 s in 0.2 s pieces (B=1, K={dec.K}, R={dec.R}): AcceptWaveform "
        f"p50 {np.median(a) * 1e3:.3f} ms max {a.max() * 1e3:.3f} ms ({len(a)} pieces); "
        f"PartialResult p50 {np.median(t['partial']) * 1e3:.3f} ms max "
        f"{t['partial'].max() * 1e3:.3f} ms; first fold {t['first_fold'] * 1e3:.3f} ms "
        f"({t['folded']} frames folded); FinalResult {t['final'] * 1e3:.3f} ms; "
        f"peak device memory {peak:.3f} GiB; {count_line(launches)}; "
        f"identical JSON with the plain versions ({len(outs)} results)")
    log("streaming stages (host s): " + json.dumps(
        {k: v["seconds"] for k, v in t["stages"].items()}))
    log("streaming results: " + json.dumps({
        "long": json.loads(outs[-1])["text"][:40], "8000 Hz": json.loads(res8)["text"][:40],
        "alternatives": [x["text"][:20] for x in json.loads(res_alt)["alternatives"]]}))
    return launches, model


def bench_inputs(torch, pipe):
    """bench.py's drive at its operating point for `pipe`: 4 s a channel in
    n chunks of seeded noise [n, B, S] and plausible scores (snr 2.0) as
    ll_bias [n, B, T, P], on the card.  Returns (n, audio, ll_bias)."""
    import numpy as np

    from vosk_tpu_torch.utils.benchdata import make_plausible_loglikes

    model = pipe.model
    S, P = pipe.chunk_samples, model.am_config.num_pdfs
    n_chunks = int(4.0 * model.config.sample_rate) // S
    rng = np.random.default_rng(SEED)
    audio = torch.from_numpy(
        (rng.standard_normal((n_chunks, B, S)) * 500).astype(np.float32)).to(pipe.device)
    lb = make_plausible_loglikes(model.graph, P, B, n_chunks * pipe.T, snr=2.0, seed=SEED)
    ll_bias = torch.from_numpy(np.ascontiguousarray(
        lb.reshape(n_chunks, pipe.T, B, P).swapaxes(1, 2))).to(pipe.device)
    return n_chunks, audio, ll_bias


def phase_run_scan(torch, bm):
    """bench.py's path at its operating point, B = 32."""
    from vosk_tpu_torch.runtime.pipeline import FusedPipeline

    model = bm._model
    pipe = FusedPipeline(model, batch=B, chunk_seconds=0.48)
    S = pipe.chunk_samples
    n_chunks, audio, ll_bias = bench_inputs(torch, pipe)
    st, recs, best = pipe.run_scan(pipe.init_state(), audio, ll_bias=ll_bias)  # warm-up
    torch.cuda.synchronize()
    del recs, best, st
    state = pipe.init_state()
    torch.cuda.synchronize()
    zero_counts()  # every kernel count, just before the main path
    t0 = time.perf_counter()
    state, recs, best = pipe.run_scan(state, audio, ll_bias=ll_bias)
    best_h = best.cpu()
    dt = time.perf_counter() - t0
    launches = read_counts("run_scan")
    if not torch.isfinite(best_h).all():
        raise AssertionError(f"run_scan best costs are not finite: {best_h}")
    live = torch.isfinite(recs["f_cost"]).sum(-1).float()
    frames = n_chunks * pipe.T
    audio_s = n_chunks * B * S / model.config.sample_rate
    log(f"run_scan B={B}, {n_chunks} chunks of 0.48 s ({pipe.T} frames each), records "
        f"{tuple(recs['pm'].shape)}: {dt:.3f} s for {audio_s:.2f} audio-s = "
        f"{audio_s / dt:.3f} audio-s/s, {dt / frames * 1e3:.3f} ms per decoded frame; "
        f"live tokens p50 {live.median().item():.0f} (min {live.min().item():.0f}, "
        f"max {live.max().item():.0f}); {count_line(launches)}")
    return launches


def stage_line(stages) -> str:
    return json.dumps({k: v["seconds"] for k, v in stages.items()})


def v3_records_equal(torch, a, b, what):
    """Raise unless two runs' outputs (frontier, records, best) are bit-equal."""
    for x, y in zip(a, b):
        for k in x:
            if not torch.equal(bits(torch, x[k]), bits(torch, y[k])):
                raise AssertionError(f"v3 decoder {k}: kernel != {what}")


def phase_v3_decoder(torch, pipe):
    """11a. The v3 decoder over the raw graph at B = 32: two chunks of
    plausible scores with a masked stretch, with the gather kernel, with
    its plain version on the same CUDA tensors, and on the CPU; frontier,
    the nine record planes and the best costs must be bit-equal, with
    2 + 2 * eps_iters gather launches a frame."""
    import numpy as np

    from vosk_tpu_torch.ops.gather import gather_rows, gather_rows_plain
    from vosk_tpu_torch.utils.benchdata import make_plausible_loglikes

    dec, T = pipe.dec, pipe.T
    P = pipe.model.am_config.num_pdfs
    lb = make_plausible_loglikes(pipe.model.graph, P, B, 2 * T, snr=2.0, seed=SEED + 12)
    chunks = [torch.from_numpy(np.ascontiguousarray(lb[c * T:(c + 1) * T].swapaxes(0, 1)))
              for c in range(2)]
    valid = torch.ones((B, T), dtype=torch.bool)
    valid[1, 2:4] = False

    def run(d, gather, device):
        d.gather_op = gather
        fr, outs, secs = d.init_frontier(B), [], []
        for ll in chunks:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fr, rec, best, bestf = d.decode_chunk(fr, ll.to(device), valid.to(device))
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            outs.append({**{f"frontier.{k}": v.cpu() for k, v in fr.items()},
                         **{k: v.cpu() for k, v in rec.items()},
                         "best": best.cpu(), "best_final": bestf.cpu()})
        return outs, secs

    zero_counts()
    try:
        k_out, k_t = run(dec, gather_rows, dec.device)
        launches = read_counts("the v3 decoder", V3_KERNELS)
        p_out, p_t = run(dec, gather_rows_plain, dec.device)
    finally:
        dec.gather_op = gather_rows
    c_out, c_t = run(dec.to("cpu"), gather_rows, "cpu")
    v3_records_equal(torch, k_out, p_out, "plain gather")
    v3_records_equal(torch, k_out, c_out, "CPU")
    per_frame = 2 + 2 * dec.eps_iters
    if launches["gather_rows"] != 2 * T * per_frame:
        raise AssertionError(f"v3 decoder: {launches['gather_rows']} gather launches in "
                             f"{2 * T} frames, not {per_frame} a frame")
    live = torch.isfinite(k_out[-1]["frontier.cost"]).sum(1)
    log(f"v3 decoder B={B} K={dec.K} R={dec.R} M={dec.M} Me={dec.Me} Eb={dec.Eb} L="
        f"{1 + dec.eps_iters} T={T}x2: frontier + 9 record planes + best costs bit-equal "
        f"gather kernel / plain gather / CPU; live tokens min {live.min().item()} max "
        f"{live.max().item()}; {launches['gather_rows'] // (2 * T)} gather launches a frame; "
        f"chunk seconds kernel {[round(x, 4) for x in k_t]} plain "
        f"{[round(x, 4) for x in p_t]} CPU {[round(x, 3) for x in c_t]}")
    return chunks, valid


def phase_v3_profile(torch, dec, chunks, valid):
    """One v3 decode_chunk at B = 32 under torch.profiler: device kernels
    by name, launches and device us per frame; the sort kernels' share."""
    from torch.profiler import ProfilerActivity, profile

    T = chunks[0].shape[1]
    fr = dec.init_frontier(B)
    ll, v = chunks[0].to(dec.device), valid.to(dec.device)
    dec.decode_chunk(fr, ll, v)  # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        dec.decode_chunk(fr, ll, v)
        torch.cuda.synchronize()
    rows = {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            c, us = rows.get(ev.name, (0, 0.0))
            rows[ev.name] = (c + 1, us + ev.time_range.elapsed_us())
    if not rows:
        raise AssertionError("the profiler recorded no device kernel")
    total = sum(us for _, us in rows.values()) / T
    sort_us = sum(us for k, (_, us) in rows.items() if "sort" in k.lower()) / T
    gather = {k: c / T for k, (c, _) in rows.items() if "gather_rows" in k}
    top = sorted(rows.items(), key=lambda kv: -kv[1][1])[:12]
    log(f"profiled v3 decode_chunk B={B} T={T}: {sum(c for c, _ in rows.values()) / T:.1f} "
        f"device events and {total:.3f} us of device rows a frame; sort kernels "
        f"{sort_us:.3f} us a frame ({sort_us / total:.1%}); gather_rows launches a frame "
        f"{json.dumps(gather)}; largest rows (launches, us a frame): " + json.dumps(
            {k[:60]: [c / T, round(us / T, 3)] for k, (c, us) in top}))
    if sum(gather.values()) != 2 + 2 * dec.eps_iters:
        raise AssertionError(f"profiled v3 frame launched gather {gather}")
    return {"device_us": total, "sort_us": sort_us}


def phase_v3_run_scan(torch, pipe):
    """11b. FusedPipeline(frame_step="v3").run_scan at bench.py's point:
    one warm-up, then a timed drive with the counts zeroed just before."""
    dec = pipe.dec
    model = pipe.model
    n_chunks, audio, ll_bias = bench_inputs(torch, pipe)
    st, recs, best = pipe.run_scan(pipe.init_state(), audio, ll_bias=ll_bias)  # warm-up
    torch.cuda.synchronize()
    del recs, best, st
    state = pipe.init_state()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()  # every kernel count, just before the path
    t0 = time.perf_counter()
    state, recs, best = pipe.run_scan(state, audio, ll_bias=ll_bias)
    best_h = best.cpu()
    dt = time.perf_counter() - t0
    launches = read_counts("the v3 run_scan", V3_KERNELS)
    frames = n_chunks * pipe.T
    if launches["gather_rows"] != frames * (2 + 2 * dec.eps_iters):
        raise AssertionError(f"v3 run_scan: {launches['gather_rows']} gather launches in "
                             f"{frames} frames")
    if not torch.isfinite(best_h).all() or not on_device(recs):
        raise AssertionError(f"v3 run_scan: best costs not finite or records off the card")
    live = torch.isfinite(recs["f_cost"][:, :, :, -1]).sum(-1).float()
    audio_s = n_chunks * B * pipe.chunk_samples / model.config.sample_rate
    log(f"v3 run_scan B={B}, {n_chunks} chunks of 0.48 s ({pipe.T} frames each), records "
        f"{tuple(recs['prev'].shape)} / {tuple(recs['lat_ns'].shape)}: {dt:.3f} s for "
        f"{audio_s:.2f} audio-s = {audio_s / dt:.3f} audio-s/s, {dt / frames * 1e3:.3f} ms "
        f"per decoded frame; live tokens p50 {live.median().item():.0f} (min "
        f"{live.min().item():.0f}, max {live.max().item():.0f}); peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; {count_line(launches)} = "
        f"{launches['gather_rows'] // frames} a decoded frame")
    return launches


def phase_v3_auto(torch, bm, tmp):
    """11c. A native directory of the same AM whose graph keeps labeled eps
    arcs (the 2M-state graph, a seeded 30 % of its eps arcs given word
    labels): Model(dir) + KaldiRecognizer must pick v3 under "auto"; the
    10.5 s stream must fold, keep the source's schema, launch only the
    gather kernel and give identical JSON with the plain gather; then
    BatchModel(dir) serves 8 x 3 s.  Returns (streaming, batch) launches."""
    import dataclasses

    import numpy as np

    import vosk_tpu_torch
    from vosk_tpu_torch.io import native
    from vosk_tpu_torch.ops.gather import gather_rows, gather_rows_plain

    m = bm._model
    g = m.graph
    rng = np.random.default_rng(SEED + 13)
    ol = g.eps_olabel.copy()
    hit = rng.random(len(ol)) < 0.3
    ol[hit] = rng.integers(1, int(g.em_olabel.max()) + 1, int(hit.sum()))
    path = Path(tmp) / "eps_model"
    t0 = time.perf_counter()
    native.save_model(path, m.config, m.am_params,
                      dataclasses.replace(g, eps_olabel=ol.astype(np.int32)), m.words,
                      m.phones, m.phone_of_pdf, m.silence_pdfs)
    t_save = time.perf_counter() - t0
    t0 = time.perf_counter()
    model = vosk_tpu_torch.Model(str(path), device="cuda")
    vosk_tpu_torch.KaldiRecognizer(model, 16000)  # builds the shared decoder
    torch.cuda.synchronize()
    t_load = time.perf_counter() - t0
    dec = model._model.shared_decoder()
    if dec.frame_step != "v3":
        raise AssertionError(f"the labeled-eps model took the {dec.frame_step} step")
    pcm = noise_pcm(10.5, 16000, SEED + 14)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()  # every kernel count, just before the path
    outs, t = stream_long(model, pcm, 16000)
    torch.cuda.synchronize()
    launches = read_counts("the labeled-eps stream", V3_KERNELS)
    peak = torch.cuda.max_memory_allocated() / 2**30
    dec.gather_op = gather_rows_plain
    try:
        plain_outs, _ = stream_long(model, pcm, 16000)
    finally:
        dec.gather_op = gather_rows
    if plain_outs != outs:
        raise AssertionError("the labeled-eps stream differs between the gather kernel and "
                             "its plain version")
    a = t["accept"]
    log(f"v3 auto: labeled-eps dir ({int(hit.sum())} of {len(ol)} eps arcs labeled) saved "
        f"in {t_save:.3f} s; Model + first KaldiRecognizer {t_load:.3f} s; prepared graph "
        f"S={dec.S} M={dec.M} Me={dec.Me} eps arcs {dec.graph.num_eps_arcs} eps_iters "
        f"{dec.eps_iters}: frame_step {dec.frame_step}; 10.5 s stream AcceptWaveform p50 "
        f"{np.median(a) * 1e3:.3f} ms max {a.max() * 1e3:.3f} ms; first fold "
        f"{t['first_fold'] * 1e3:.3f} ms ({t['folded']} frames folded); FinalResult "
        f"{t['final'] * 1e3:.3f} ms; peak device memory {peak:.3f} GiB; "
        f"{count_line(launches)}; identical JSON with the plain gather ({len(outs)} results); "
        f"text {json.dumps(json.loads(outs[-1])['text'][:40])}")
    log("v3 auto streaming stages (host s): " + stage_line(t["stages"]))
    del model, dec, t
    gc.collect()
    t0 = time.perf_counter()
    bm_e = vosk_tpu_torch.BatchModel(str(path), max_batch_size=B, device="cuda")
    torch.cuda.synchronize()
    log(f"v3 auto batch: BatchModel load {time.perf_counter() - t0:.3f} s, frame_step "
        f"{bm_e._pipeline.dec.frame_step}")
    batch_launches = phase_serving(torch, bm_e, V3_KERNELS)
    del bm_e
    gc.collect()
    return launches, batch_launches


def phase_v3(torch, bm, tmp):
    """Phase 11: the v3 step (epsilon-closure rounds over exact3 rows) with
    the gather kernel at its four sites.  Returns (launches by path, gather
    times at the v3 shapes, profile)."""
    from vosk_tpu_torch.runtime.pipeline import FusedPipeline

    t0 = time.perf_counter()
    pipe = FusedPipeline(bm._model, batch=B, chunk_seconds=0.48, frame_step="v3")
    dec = pipe.dec
    log(f"v3: raw graph S={dec.S}, M={dec.M}, Me={dec.Me}, eps_iters={dec.eps_iters}, "
        f"pdf_bits={dec.pdf_bits}, olabel in meta {dec.ol_in_meta}, K={dec.K}, R={dec.R}, "
        f"K2={dec.K2}, Eb={dec.Eb}; FusedPipeline(frame_step='v3') built in "
        f"{time.perf_counter() - t0:.3f} s")
    chunks, valid = phase_v3_decoder(torch, pipe)
    profile = phase_v3_profile(torch, dec, chunks, valid)
    launches = {"v3": phase_v3_run_scan(torch, pipe)}
    shapes = (("v3_ll", "float32", B, pipe.model.am_config.num_pdfs, dec.K * dec.M),
              ("v3_tsil", "int32", B, dec.K, dec.K),
              ("v3_state", "int32", B, dec.K, dec.Eb),
              ("v3_eps_tsil", "int32", B, dec.K, dec.K))
    del pipe, dec, chunks
    gc.collect()
    launches["v3_auto"], launches["v3_auto_batch"] = phase_v3_auto(torch, bm, tmp)
    times, err = phase_kernel(torch, torch.device("cuda"), cases=shapes)
    return launches, times, err, profile


def phase_kaldi(torch, tmp):
    """Phase 9: the full-width Kaldi directory with i-vectors, streaming
    and batch.  Returns (streaming launches, batch launches, kernel shapes
    of the path)."""
    import numpy as np

    import vosk_tpu_torch
    from vosk_tpu_torch.io.kaldi_export import export_kaldi_dir
    from vosk_tpu_torch.ops import frame_step
    from vosk_tpu_torch.utils import benchdata, kaldidata

    t0 = time.perf_counter()
    m = benchdata.make_bench_model(seed=SEED, device="cpu")
    kaldidata.one_phone_per_pdf(m)
    ivcfg = kaldidata.make_ivector_config(feat_dim=m.am_config.feat_dim, seed=SEED)
    plain, ivdir = Path(tmp) / "kaldi_plain", Path(tmp) / "kaldi_ivector"
    export_kaldi_dir(m, plain)
    kaldidata.write_ivector_kaldi_dir(m, plain, ivdir, ivcfg, seed=SEED)
    t_export = time.perf_counter() - t0
    del m
    t0 = time.perf_counter()
    model = vosk_tpu_torch.Model(str(ivdir), device="cuda")
    torch.cuda.synchronize()
    t_load = time.perf_counter() - t0
    nm = model._model
    t0 = time.perf_counter()
    vosk_tpu_torch.KaldiRecognizer(model, 16000)  # builds the shared decoder
    torch.cuda.synchronize()
    t_first = time.perf_counter() - t0
    dec = nm.shared_decoder()
    am = nm.make_am()
    log(f"kaldi: export (nnet3 + ivector/ + {nm.graph.num_states}-state HCLG.fst after "
        f"prep) {t_export:.3f} s; Model load {t_load:.3f} s (by stage "
        f"{json.dumps({k: round(v, 3) for k, v in nm.load_seconds.items()})}); first "
        f"KaldiRecognizer (prepare_graph_v4 + tables) {t_first:.3f} s; decoder S={dec.S} "
        f"M={dec.M} K={dec.K}; AM context {am.left_context}/{am.right_context}, "
        f"i-vector input {am.has_ivector}")
    if not (am.has_ivector and nm.ivector is not None and nm.silence_weight == 0.001):
        raise AssertionError("the Kaldi directory did not load its i-vector parts")
    if not all(t.is_cuda for w in am.weights.values() for t in w.values()):
        raise AssertionError("the nnet3 weights are not on the card")

    pcm = noise_pcm(10.5, 16000, SEED + 7)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()  # every kernel count, just before the main path
    outs, t = stream_long(model, pcm, 16000)
    torch.cuda.synchronize()
    launches = read_counts("the Kaldi streaming path")
    peak = torch.cuda.max_memory_allocated() / 2**30
    r = t["rec"]
    if not all(v.is_cuda for v in r._iv_state.values()):
        raise AssertionError("the i-vector state is not on the card")
    iv = r.iv.current(r._iv_state)[0].cpu()
    if not (torch.isfinite(iv).all() and iv.abs().max().item() > 0):
        raise AssertionError(f"the i-vector did not move off zero: {iv[:5]}")
    if r._iv_frames_weighted <= 0 or "ivector" not in t["stages"]:
        raise AssertionError("i-vector silence weighting did not run")
    dec.step_ops = frame_step.PLAIN
    try:
        plain_outs, _ = stream_long(model, pcm, 16000)
    finally:
        dec.step_ops = frame_step.KERNELS
    if plain_outs != outs:
        raise AssertionError("the Kaldi stream differs between the kernels and the plain "
                             "versions")
    a = t["accept"]
    log(f"kaldi streaming 10.5 s in 0.2 s pieces (B=1): AcceptWaveform p50 "
        f"{np.median(a) * 1e3:.3f} ms max {a.max() * 1e3:.3f} ms ({len(a)} pieces); "
        f"PartialResult p50 {np.median(t['partial']) * 1e3:.3f} ms; first fold "
        f"{t['first_fold'] * 1e3:.3f} ms; FinalResult {t['final'] * 1e3:.3f} ms; "
        f"peak device memory {peak:.3f} GiB; {count_line(launches)}; i-vector "
        f"|x|max {iv.abs().max().item():.4f}, silence weighting scanned "
        f"{r._iv_frames_weighted} frames; identical JSON with the plain versions "
        f"({len(outs)} results)")
    log("kaldi streaming stages (host s): " + stage_line(t["stages"]))
    STAGES["kaldi"] = t["stages"]
    log("kaldi streaming result: " + json.dumps(json.loads(outs[-1])["text"][:60]))
    shapes = (dec.K * dec.M, dec.K)
    del model, nm, am, dec, r, t  # the batch phase's peak memory is its own
    gc.collect()

    t0 = time.perf_counter()
    bm = vosk_tpu_torch.BatchModel(str(plain), max_batch_size=B, device="cuda")
    torch.cuda.synchronize()
    log(f"kaldi batch: BatchModel load (no i-vector graft) {time.perf_counter() - t0:.3f} s")
    batch_launches = phase_serving(torch, bm)
    del bm
    return launches, batch_launches, shapes


def stream_short(model, rate, seed, grammar=None):
    """A 3 s noise stream in 0.2 s pieces with words on; returns (final
    JSON, AcceptWaveform seconds, FinalResult seconds)."""
    import numpy as np

    import vosk_tpu_torch

    args = () if grammar is None else (grammar,)
    rec = vosk_tpu_torch.KaldiRecognizer(model, rate, *args)
    rec.SetWords(True)
    pcm = noise_pcm(3.0, rate, seed)
    piece = int(0.2 * rate) * 2
    accept = []
    for off in range(0, len(pcm), piece):
        t0 = time.perf_counter()
        rec.AcceptWaveform(pcm[off: off + piece])
        accept.append(time.perf_counter() - t0)
    t0 = time.perf_counter()
    out = check_schema(rec.FinalResult(), "final")
    return json.loads(out), np.array(accept), time.perf_counter() - t0, rec


def phase_split(torch, tmp):
    """Phase 10: a split-graph directory and a runtime grammar on the card.
    Returns (main-graph launches, grammar launches, decoders)."""
    import numpy as np

    import vosk_tpu_torch
    from vosk_tpu_torch.io.kaldi_export import export_kaldi_split_dir
    from vosk_tpu_torch.utils import benchdata, kaldidata

    t0 = time.perf_counter()
    m = benchdata.make_bench_model(num_states=1000, num_words=10, seed=SEED, device="cpu")
    kaldidata.one_phone_per_pdf(m)
    kaldidata.make_lexicon_model(m, num_words=1000, seed=SEED)
    path = Path(tmp) / "kaldi_split"
    export_kaldi_split_dir(m, path)
    t_export = time.perf_counter() - t0
    t0 = time.perf_counter()
    model = vosk_tpu_torch.Model(str(path), device="cuda")
    t_load = time.perf_counter() - t0
    grammar = '["w1 w2", "w3"]'
    runs = {}
    for name, g in (("main", None), ("grammar", grammar)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_counts()  # every kernel count, just before the path
        t0 = time.perf_counter()
        res, accept, final_s, rec = stream_short(model, 16000, SEED + 8, g)
        torch.cuda.synchronize()
        runs[name] = dict(res=res, accept=accept, final=final_s, wall=time.perf_counter() - t0,
                          launches=read_counts(f"the {name} split-graph stream"),
                          dec=rec._rec.dec,
                          peak=torch.cuda.max_memory_allocated() / 2**30,
                          stages=rec.GetMetrics()["stages"],
                          on_card=rec._rec._frontier["state"].is_cuda)
    words = set(runs["grammar"]["res"]["text"].split())
    if not words <= {"w1", "w2", "w3"}:
        raise AssertionError(f"grammar decode left the grammar: {runs['grammar']['res']}")
    for name, run in runs.items():
        if not run["on_card"]:
            raise AssertionError(f"the {name} split-graph stream did not run on the card")
    log(f"split graph: export (1000-word lexicon, HCLr + Gr) {t_export:.3f} s; Model load "
        f"{t_load:.3f} s (by stage "
        f"{json.dumps({k: round(v, 3) for k, v in model._model.load_seconds.items()})})")
    for name, run in runs.items():
        d, a = run["dec"], run["accept"]
        log(f"split {name}: S={d.S} M={d.M} K={d.K} R={d.R}; 3 s in 0.2 s pieces, "
            f"AcceptWaveform p50 {np.median(a) * 1e3:.3f} ms max {a.max() * 1e3:.3f} ms "
            f"(first piece includes recognizer setup); FinalResult "
            f"{run['final'] * 1e3:.3f} ms; peak device memory {run['peak']:.3f} GiB; "
            f"{count_line(run['launches'])}; text "
            f"{json.dumps(run['res']['text'][:60])}; stages {stage_line(run['stages'])}")
    return runs["main"]["launches"], runs["grammar"]["launches"], (
        runs["main"]["dec"], runs["grammar"]["dec"])


STAGES = {}  # a phase's streaming stage seconds, for a later phase's comparison
RESCORE_STATES = 200_000  # phase 12's graph: the one cut, for load time
HISTORIES = 64           # phase 12's card-vs-CPU RNNLM histories


def rescore_counts_zero(nm):
    """Zero the LMs' lookup counts of a loaded model, just before a run."""
    if nm.rescore_lm is not None and hasattr(nm.rescore_lm, "scored"):
        nm.rescore_lm.scored = 0
    if nm.rnnlm_rescorer is not None:
        nm.rnnlm_rescorer.evaluated, nm.rnnlm_rescorer.seconds = 0, 0.0


def rnnlm_launches(torch, resc, state):
    """Device events of one history's evaluation under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    resc.logits(state)  # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        resc.logits(state).cpu()
        torch.cuda.synchronize()
    return sum(1 for ev in prof.events() if ev.device_type == torch.autograd.DeviceType.CUDA)


def rescore_plausible(torch, nm, dec, seed, frames=30):
    """Finish one B = 1 lattice of `frames` frames of plausible scores
    (make_plausible_loglikes, snr 2.0: a path through the graph's word
    arcs, as speech gives one; the noise streams' lattices keep no word)
    through a Finisher with the model's rescoring and one without, the
    counts zeroed just before.  Short: the source's composition is
    unpruned, and grows about tenfold per doubling of frames on such
    lattices.  Returns the stats line's numbers."""
    import copy

    import numpy as np

    from vosk_tpu_torch.graph.lattice import build_lattice
    from vosk_tpu_torch.runtime.finishing import Finisher
    from vosk_tpu_torch.utils.benchdata import make_plausible_loglikes

    ll = make_plausible_loglikes(nm.graph, len(nm.phone_of_pdf), 1, frames, snr=2.0,
                                 seed=seed)
    ll = torch.from_numpy(np.ascontiguousarray(ll.transpose(1, 0, 2))).to(dec.device)
    fr, rec, _, _ = dec.decode_chunk(dec.init_frontier(1), ll)
    torch.cuda.synchronize()
    bare = copy.copy(nm)
    bare.g_fst = None
    rescore_counts_zero(nm)
    lat, _ = build_lattice([rec], fr, 0, dec)
    out = {"frames": frames, "decoded_nodes": lat.num_nodes, "decoded_arcs": len(lat.arcs)}
    for name, fin in (("plain", Finisher(bare, dec)), ("rescored", Finisher(nm, dec))):
        zero_counts()
        t0 = time.perf_counter()
        paths = fin.paths([rec], fr, 0, n=1)
        out[f"{name}_ms"] = (time.perf_counter() - t0) * 1e3
        out[f"{name}_words"] = len(paths[0][1]) if paths else 0
    resc = fin._rnn_rescorer
    out.update(fin.rescore_stats, histories=resc.evaluated, rnnlm_s=resc.seconds,
               lm_lookups=getattr(nm.rescore_lm, "scored", None))
    if not (fin.rescoring and out["word_arcs"] > 0 and resc.evaluated > 1):
        raise AssertionError(f"the plausible lattice did not rescore words: {out}")
    return out


def phase_rescoring(torch, tmp, states=RESCORE_STATES, histories=HISTORIES,
                    rnnlm_kw=None, gru_dims=(1024, 1024)):
    """Phase 12: LM rescoring on the card.  (a) A Kaldi V2 dir (phase 9's AM
    with the i-vector graft and ivector/, on a realistic graph of `states`
    states over the 100k words) with rescore/ (a seeded 3-gram as G.carpa,
    its bigram as G.fst) and a TDNN-LSTM rnnlm/: the 10.5 s stream (it
    folds) must rescore (carpa and RNNLM histories > 0), launch both
    frame-step kernels, keep the RNNLM and the frontier on the card and
    give identical JSON with the plain step ops; then the RNNLM on the card
    against the same rescorer on the CPU for `histories` seeded histories,
    largest logit difference under 1e-3.  (b) The dir without the graft,
    with rescore/ only, serves 8 x 3 s through BatchModel.  (c) A native
    dir of the TDNN-F with g.npz, rescore.arpa and a GRU rnnlm/: one 3 s
    stream, and the GRU step on the card against the CPU.  Returns
    {path: launches}."""
    import numpy as np

    import vosk_tpu_torch
    from vosk_tpu_torch.io import native
    from vosk_tpu_torch.io.kaldi_export import export_kaldi_dir
    from vosk_tpu_torch.io.kaldi_rnnlm import KaldiRnnlmRescorer
    from vosk_tpu_torch.models.rnnlm import RnnlmModel
    from vosk_tpu_torch.ops import frame_step
    from vosk_tpu_torch.utils import benchdata, kaldidata

    t0 = time.perf_counter()
    m = benchdata.make_bench_model(num_states=states, seed=SEED, device="cpu")
    kaldidata.one_phone_per_pdf(m)
    plain, ivdir, natdir = (Path(tmp) / n for n in ("resc_plain", "resc_ivector", "resc_native"))
    export_kaldi_dir(m, plain)
    t_export = time.perf_counter() - t0
    t0 = time.perf_counter()
    counts = kaldidata.write_rescore_dir(m, plain, seed=SEED)
    t_lm = time.perf_counter() - t0
    ivcfg = kaldidata.make_ivector_config(feat_dim=m.am_config.feat_dim, seed=SEED)
    kaldidata.write_ivector_kaldi_dir(m, plain, ivdir, ivcfg, seed=SEED)
    t0 = time.perf_counter()
    rinfo = kaldidata.write_kaldi_rnnlm_dir(ivdir / "rnnlm", m.words, seed=SEED,
                                            **(rnnlm_kw or {}))
    t_rnnlm = time.perf_counter() - t0
    t0 = time.perf_counter()
    native.save_model(natdir, m.config, m.am_params, m.graph, m.words, m.phones,
                      m.phone_of_pdf, m.silence_pdfs)
    kaldidata.write_native_rescoring(m, natdir, seed=SEED, rnnlm_dims=gru_dims)
    t_native = time.perf_counter() - t0
    log(f"rescoring: {states}-state graph, {len(m.words) - 1} words; Kaldi export "
        f"{t_export:.3f} s; 3-gram ({json.dumps(counts)}) + G.carpa + G.fst written in "
        f"{t_lm:.3f} s; rnnlm/ ({json.dumps(rinfo)}) in {t_rnnlm:.3f} s; native dir with "
        f"g.npz, rescore.arpa and GRU {gru_dims} in {t_native:.3f} s")
    del m
    gc.collect()
    out = {}

    # (a) the Kaldi dir with rescore/ + rnnlm/, streaming
    t0 = time.perf_counter()
    model = vosk_tpu_torch.Model(str(ivdir), device="cuda")
    torch.cuda.synchronize()
    t_load = time.perf_counter() - t0
    nm = model._model
    resc = nm.rnnlm_rescorer
    if resc is None or nm.rescore_lm is None or nm.g_fst is None:
        raise AssertionError("the Kaldi dir did not load its rescoring resources")
    if not (resc.word_embedding.is_cuda
            and all(t.is_cuda for w in resc.weights.values() for t in w.values())):
        raise AssertionError("the RNNLM's parameters are not on the card")
    vosk_tpu_torch.KaldiRecognizer(model, 16000)  # builds the shared decoder
    dec = nm.shared_decoder()
    log(f"rescoring kaldi: Model load {t_load:.3f} s (by stage "
        f"{json.dumps({k: round(v, 3) for k, v in nm.load_seconds.items()})}); G.fst "
        f"{nm.g_fst.num_states} states {nm.g_fst.num_arcs} arcs; RNNLM "
        f"{len(resc.word_embedding)} words x {resc.word_embedding.shape[1]}, "
        f"recurrent {resc.lm.net.has_recurrence()}")
    pcm = noise_pcm(10.5, 16000, SEED + 15)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rescore_counts_zero(nm)
    zero_counts()  # every kernel count, just before the path
    outs, t = stream_long(model, pcm, 16000)
    torch.cuda.synchronize()
    out["rescored_kaldi"] = read_counts("the rescored Kaldi stream")
    peak = torch.cuda.max_memory_allocated() / 2**30
    fin = t["rec"]._finisher
    scored, evaluated, rnn_s = nm.rescore_lm.scored, resc.evaluated, resc.seconds
    stats = dict(fin.rescore_stats)
    if not (fin.rescoring and stats["lattices"] > 0 and scored > 0 and evaluated > 0):
        raise AssertionError(f"the stream did not rescore: {stats}, carpa lookups {scored}, "
                             f"RNNLM histories {evaluated}")
    dec.step_ops = frame_step.PLAIN
    try:
        plain_outs, _ = stream_long(model, pcm, 16000)
    finally:
        dec.step_ops = frame_step.KERNELS
    if plain_outs != outs:
        raise AssertionError("the rescored stream differs between the kernels and the plain "
                             "versions")
    a = t["accept"]
    log(f"rescoring kaldi stream 10.5 s (B=1, folded {t['folded']} frames): AcceptWaveform "
        f"p50 {np.median(a) * 1e3:.3f} ms max {a.max() * 1e3:.3f} ms; FinalResult "
        f"{t['final'] * 1e3:.3f} ms; {stats['lattices']} lattices rescored in "
        f"{stats['seconds']:.3f} s ({stats['seconds'] / stats['lattices'] * 1e3:.3f} ms a "
        f"lattice), last composed lattice {stats['nodes']} nodes {stats['arcs']} arcs "
        f"({stats['word_arcs']} with words); "
        f"carpa lookups {scored}; RNNLM {evaluated} histories in {rnn_s:.3f} s = "
        f"{rnn_s / evaluated * 1e3:.3f} ms a history; peak device memory {peak:.3f} GiB; "
        f"{count_line(out['rescored_kaldi'])}; identical JSON with the plain versions "
        f"({len(outs)} results); text {json.dumps(json.loads(outs[-1])['text'][:60])}")
    log("rescoring kaldi stages (host s): " + stage_line(t["stages"]))
    pl = rescore_plausible(torch, nm, dec, SEED + 18)
    log(f"rescoring kaldi, one {pl['frames']}-frame lattice of plausible scores "
        f"({pl['decoded_nodes']} nodes, {pl['decoded_arcs']} arcs): finishing "
        f"{pl['plain_ms']:.3f} ms without rescoring ({pl['plain_words']} words), "
        f"{pl['rescored_ms']:.3f} ms with ({pl['rescored_words']} words); composed lattice "
        f"{pl['nodes']} nodes {pl['arcs']} arcs ({pl['word_arcs']} with words); carpa "
        f"lookups {pl['lm_lookups']}; RNNLM {pl['histories']} histories in "
        f"{pl['rnnlm_s']:.3f} s = {pl['rnnlm_s'] / pl['histories'] * 1e3:.3f} ms a history")

    # the RNNLM on the card against the CPU, TF32 off
    rng = np.random.default_rng(SEED + 16)
    V = len(nm.words) - 1
    hists = [((resc.lm.bos,) + tuple(rng.integers(1, V + 1, k).tolist()))[-resc.history:]
             for k in rng.integers(1, 5, histories)]
    t0 = time.perf_counter()
    cpu = KaldiRnnlmRescorer(resc.lm, history=resc.history, device="cpu")
    t_cpu = time.perf_counter() - t0
    err = emb_err = 0.0
    card_s = []
    for h in hists:
        t0 = time.perf_counter()
        got = resc.logits(h).cpu()
        card_s.append(time.perf_counter() - t0)
        err = max(err, (got - cpu.logits(h)).abs().max().item())
    emb_err = (resc.word_embedding.cpu() - cpu.word_embedding).abs().max().item()
    events = rnnlm_launches(torch, resc, hists[int(np.argmax([len(h) for h in hists]))])
    log(f"rescoring RNNLM on card vs CPU ({histories} seeded histories of 1-4 words, TF32 "
        f"off): largest abs logit difference {err:.3e} (bound 1e-3), word embedding "
        f"{emb_err:.3e}; card ms a history p50 {np.median(card_s) * 1e3:.3f} max "
        f"{max(card_s) * 1e3:.3f}; CPU rescorer built in {t_cpu:.3f} s; one 4-word history "
        f"= {events} device events")
    if not err < 1e-3:
        raise AssertionError(f"the card's RNNLM disagrees with the CPU's: {err}")
    out["rnnlm"] = dict(err=err, ms=float(np.median(card_s) * 1e3), events=events,
                        stream_histories=evaluated, plausible=pl)
    del model, nm, resc, cpu, dec, t, fin
    gc.collect()

    # (b) the dir without the graft, rescore/ only, through BatchModel
    t0 = time.perf_counter()
    bm = vosk_tpu_torch.BatchModel(str(plain), max_batch_size=B, device="cuda")
    torch.cuda.synchronize()
    log(f"rescoring batch: BatchModel load {time.perf_counter() - t0:.3f} s")
    fin = bm._pipeline._finisher
    out["rescored_batch"] = phase_serving(torch, bm)
    if not (fin.rescoring and fin.rescore_stats["lattices"] > 0
            and bm._model.rescore_lm.scored > 0):
        raise AssertionError(f"the batch path did not rescore: {fin.rescore_stats}")
    log(f"rescoring batch: {json.dumps(fin.rescore_stats)}; carpa lookups "
        f"{bm._model.rescore_lm.scored}")
    del bm, fin
    gc.collect()

    # (c) the native dir with g.npz, rescore.arpa and a GRU rnnlm/
    t0 = time.perf_counter()
    gru = RnnlmModel.load(natdir / "rnnlm", device="cuda")
    torch.cuda.synchronize()
    t_gru = time.perf_counter() - t0
    del gru
    t0 = time.perf_counter()
    model = vosk_tpu_torch.Model(str(natdir), device="cuda")
    torch.cuda.synchronize()
    t_load = time.perf_counter() - t0
    nm = model._model
    if not all(v.is_cuda for v in nm.rnnlm.params.values()) or nm.rescore_lm is None:
        raise AssertionError("the native dir's GRU is not on the card or its ARPA is missing")
    torch.cuda.reset_peak_memory_stats()
    zero_counts()  # every kernel count, just before the path
    res, accept, final_s, rec = stream_short(model, 16000, SEED + 17)
    torch.cuda.synchronize()
    out["rescored_native"] = read_counts("the rescored native stream")
    fin = rec._rec._finisher
    if not (fin.rescoring and fin.rescore_stats["lattices"] > 0
            and fin._rnn_rescorer.evaluated > 0):
        raise AssertionError(f"the native stream did not rescore: {fin.rescore_stats}")
    gcpu = RnnlmModel(nm.rnnlm.cfg, {k: v.cpu() for k, v in nm.rnnlm.params.items()},
                      device="cpu")
    h, hc = nm.rnnlm.init_hidden(), gcpu.init_hidden()
    gerr = 0.0
    with torch.no_grad():
        for w in [nm.rnnlm.cfg.bos] + rng.integers(1, V + 1, 15).tolist():
            (h, lp), (hc, lpc) = nm.rnnlm.step(h, w), gcpu.step(hc, w)
            gerr = max(gerr, (h.cpu() - hc).abs().max().item(),
                       (lp.cpu() - lpc).abs().max().item())
    gr = fin._rnn_rescorer
    log(f"rescoring native: GRU {nm.rnnlm.cfg.embed_dim}/{nm.rnnlm.cfg.hidden_dim} over "
        f"{nm.rnnlm.cfg.vocab_size} words loaded in {t_gru:.3f} s; Model load {t_load:.3f} s; "
        f"3 s stream AcceptWaveform p50 {np.median(accept) * 1e3:.3f} ms, FinalResult "
        f"{final_s * 1e3:.3f} ms; {json.dumps(fin.rescore_stats)}; GRU {gr.evaluated} steps "
        f"in {gr.seconds:.3f} s; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; "
        f"{count_line(out['rescored_native'])}; GRU step card vs CPU over 16 words: largest "
        f"abs difference {gerr:.3e} (bound 1e-3); text {json.dumps(res['text'][:60])}")
    if not gerr < 1e-3:
        raise AssertionError(f"the card's GRU disagrees with the CPU's: {gerr}")
    pl = rescore_plausible(torch, nm, nm.shared_decoder(), SEED + 19)
    log(f"rescoring native, one {pl['frames']}-frame lattice of plausible scores "
        f"({pl['decoded_nodes']} nodes, {pl['decoded_arcs']} arcs): finishing "
        f"{pl['plain_ms']:.3f} ms without rescoring, {pl['rescored_ms']:.3f} ms with "
        f"({pl['rescored_words']} words); composed lattice {pl['nodes']} nodes "
        f"{pl['arcs']} arcs ({pl['word_arcs']} with words); GRU {pl['histories']} steps "
        f"in {pl['rnnlm_s']:.3f} s = {pl['rnnlm_s'] / pl['histories'] * 1e3:.3f} ms a step")
    out["gru"] = dict(err=gerr, plausible=pl)
    del model, nm, rec, fin, gcpu
    gc.collect()
    return out


PITCH_FEAT_DIM = 43  # phase 13's AM input: 40 MFCC-hires + 3 pitch (aishell chain)


def voiced_pcm(seconds, seed, rate=16000):
    """Phase 13's signal, so the tracker has a pitch to follow: harmonics
    1-5 (amplitude 1/k) of an f0 gliding over 100-300 Hz (one cycle in 3.3
    s), white noise at 10 dB SNR, peak 8000; int16 samples."""
    import numpy as np

    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * rate)) / rate
    ph = np.cumsum(2 * np.pi * (200 + 100 * np.sin(2 * np.pi * 0.3 * t)) / rate)
    x = sum(np.sin(k * ph) / k for k in range(1, 6))
    x = x + rng.standard_normal(len(t)) * np.std(x) / np.sqrt(10)
    return np.round(x / np.abs(x).max() * 8000).astype(np.int16)


def pitch_stage_events(torch, ex, B, seed):
    """The pitch tracker's work for one 0.2 s piece at batch B: the
    arguments of its frame_features call on the 4th piece of B voiced
    streams, then that call alone under torch.profiler.  Returns (device
    events, device us, host ms of one call over 10)."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    S = 3200
    audio = np.stack([voiced_pcm(0.8, seed + b) for b in range(B)]).astype(np.float32)
    frame_features = ex.pitch.frame_features
    seen = []
    ex.pitch.frame_features = lambda *a: seen.append(a) or frame_features(*a)
    try:
        st = ex.init_stream_state(B, S)
        for c in range(4):
            st, _, _ = ex.extract_chunk(st, torch.from_numpy(
                np.ascontiguousarray(audio[:, c * S:(c + 1) * S])).to(ex.device))
    finally:
        del ex.pitch.frame_features
    args = seen[-1]
    frame_features(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        frame_features(*args)
        torch.cuda.synchronize()
    dev = [ev for ev in prof.events() if ev.device_type == torch.autograd.DeviceType.CUDA]
    if not dev:
        raise AssertionError("the profiler recorded no device event for the pitch stage")
    t0 = time.perf_counter()
    for _ in range(10):
        frame_features(*args)
    torch.cuda.synchronize()
    return len(dev), sum(ev.time_range.elapsed_us() for ev in dev), \
        (time.perf_counter() - t0) / 10 * 1e3


def phase_pitch(torch, tmp):
    """Phase 13 (a): a Kaldi V2 dir with conf/pitch.conf (the port's
    exporter; the bench TDNN-F at 43/512/96/192/6008, 11 layers; the
    realistic 200,000-state graph of phase 12; no i-vector): Model(dir) +
    KaldiRecognizer stream 10.5 s of a voiced signal, counts zeroed just
    before (both frame-step kernels, pitch state on the card, identical
    JSON with the plain versions); the stream's pitch features on the card
    against the CPU (utils/pitchcheck.py); the pitch stage's device events
    for one 0.2 s piece at B = 1 and 32; then BatchModel serves 8 x 3 s.
    Returns (streaming launches, batch launches, the loaded model, the
    signal, numbers for the kernel line)."""
    import numpy as np

    import vosk_tpu_torch
    from vosk_tpu_torch.io.kaldi_export import export_kaldi_dir
    from vosk_tpu_torch.ops import frame_step
    from vosk_tpu_torch.ops.features import FeatureExtractor
    from vosk_tpu_torch.utils import benchdata, kaldidata, pitchcheck

    t0 = time.perf_counter()
    m = benchdata.make_bench_model(num_states=RESCORE_STATES, seed=SEED, device="cpu",
                                   feat_dim=PITCH_FEAT_DIM)
    kaldidata.one_phone_per_pdf(m)
    path = Path(tmp) / "kaldi_pitch"
    export_kaldi_dir(m, path)
    kaldidata.write_pitch_conf(path)
    t_export = time.perf_counter() - t0
    del m
    gc.collect()
    t0 = time.perf_counter()
    model = vosk_tpu_torch.Model(str(path), device="cuda")
    torch.cuda.synchronize()
    t_load = time.perf_counter() - t0
    nm = model._model
    t0 = time.perf_counter()
    vosk_tpu_torch.KaldiRecognizer(model, 16000)  # builds the shared decoder
    torch.cuda.synchronize()
    t_first = time.perf_counter() - t0
    dec = nm.shared_decoder()
    ex = nm.feature_extractor()
    log(f"pitch: export (43-dim nnet3 AM + {nm.graph.num_states}-state graph + conf/pitch.conf) "
        f"{t_export:.3f} s; Model load {t_load:.3f} s (by stage "
        f"{json.dumps({k: round(v, 3) for k, v in nm.load_seconds.items()})}); first "
        f"KaldiRecognizer {t_first:.3f} s; pitch_opts {json.dumps(nm.config.pitch_opts)}; "
        f"features {ex.base_dim} + 3 pitch, lookahead {ex.flush_pad_samples} samples")
    if nm.config.pitch_opts is None or ex.dim != PITCH_FEAT_DIM or nm.make_am().feat_dim != ex.dim:
        raise AssertionError("the pitch dir did not load its pitch config")

    audio = voiced_pcm(10.5, SEED + 20)
    pcm = audio.astype("<i2").tobytes()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()  # every kernel count, just before the main path
    outs, t = stream_long(model, pcm, 16000)
    torch.cuda.synchronize()
    launches = read_counts("the pitch streaming path")
    peak = torch.cuda.max_memory_allocated() / 2**30
    r = t["rec"]
    if not all(v.is_cuda for v in r._feat_state["pitch"].values()):
        raise AssertionError("the pitch tracker's state is not on the card")
    if int(r._feat_state["pitch"]["n_frames"][0]) <= 0:
        raise AssertionError("the pitch tracker saw no frame")
    dec.step_ops = frame_step.PLAIN
    try:
        plain_outs, _ = stream_long(model, pcm, 16000)
    finally:
        dec.step_ops = frame_step.KERNELS
    if plain_outs != outs:
        raise AssertionError("the pitch stream differs between the kernels and the plain "
                             "versions")
    cpu = FeatureExtractor(ex.opts, pitch_opts=ex.pitch.opts, device="cpu")
    t0 = time.perf_counter()
    feats_card = pitchcheck.stream(ex, audio[None].astype(np.float32), 3200)
    t_card = time.perf_counter() - t0
    t0 = time.perf_counter()
    feats_cpu = pitchcheck.stream(cpu, audio[None].astype(np.float32), 3200)
    t_cpu = time.perf_counter() - t0
    check = pitchcheck.compare(feats_card, feats_cpu)
    hz = 1.0 / ex.pitch.lags_s[feats_card[0][1]]
    a = t["accept"]
    feat_s = t["stages"]["features"]["seconds"]
    ref = STAGES.get("kaldi", {}).get("features", {}).get("seconds")
    log(f"pitch streaming 10.5 s voiced (B=1, folded {t['folded']} frames): AcceptWaveform "
        f"p50 {np.median(a) * 1e3:.3f} ms max {a.max() * 1e3:.3f} ms ({len(a)} pieces); "
        f"PartialResult p50 {np.median(t['partial']) * 1e3:.3f} ms; FinalResult "
        f"{t['final'] * 1e3:.3f} ms; features stage {feat_s:.4f} host s against phase 9's "
        f"{ref if ref is None else round(ref, 4)} s (no pitch); peak device memory "
        f"{peak:.3f} GiB; {count_line(launches)}; identical JSON with the plain versions "
        f"({len(outs)} results); text {json.dumps(json.loads(outs[-1])['text'][:60])}")
    log("pitch streaming stages (host s): " + stage_line(t["stages"]))
    log(f"pitch features card vs CPU over the stream ({json.dumps(check)}; bounds: lags equal "
        f"off ties < {pitchcheck.TIE}, POV feature {pitchcheck.POV_ATOL}, log pitch and delta "
        f"{pitchcheck.PITCH_ATOL}, MFCC {pitchcheck.BASE_ATOL}); tracked f0 p10/p50/p90 "
        f"{np.percentile(hz, 10):.1f}/{np.percentile(hz, 50):.1f}/{np.percentile(hz, 90):.1f} Hz "
        f"(signal 100-300 Hz); extractor alone over 10.5 s: card {t_card:.3f} s, CPU "
        f"{t_cpu:.3f} s")
    events = {}
    for b in (1, B):
        n, us, ms = pitch_stage_events(torch, ex, b, SEED + 21)
        events[f"b{b}"] = dict(events=n, device_us=us, host_ms=ms)
    log(f"pitch stage, one 0.2 s piece ({ex.stream_max_frames(3200)} frames), profiled: "
        + json.dumps(events))
    info = dict(check=check, events=events, accept_p50_ms=float(np.median(a) * 1e3),
                features_s=feat_s)
    del dec, r, t, ex, cpu
    gc.collect()

    t0 = time.perf_counter()
    bm = vosk_tpu_torch.BatchModel(str(path), max_batch_size=B, device="cuda")
    torch.cuda.synchronize()
    log(f"pitch batch: BatchModel load {time.perf_counter() - t0:.3f} s")
    batch_launches = phase_serving(torch, bm)
    del bm
    gc.collect()
    return launches, batch_launches, model, audio, info


def phase_speaker(torch, tmp, model, audio):
    """Phase 13 (b): a Kaldi speaker dir with the node graph of the
    VoxCeleb x-vector recipe at its widths (30 / 512 x 4 / 1500, stats
    mean+stddev, tdnn6.affine 3000 -> 512, LDA 200), written by the port's
    nnet3 writer; SpkModel(dir) on the card; KaldiRecognizer(model, 16000,
    spk) on phase 13 (a)'s model streams the 10.5 s signal, counts zeroed
    just before: FinalResult must carry 200 finite `spk` values and
    spk_frames >= 50, and the x-vector must match the same KaldiSpkModel
    on the CPU within 1e-4; FinalResult time with and without the speaker
    model.  Returns the path's launches."""
    import numpy as np

    import vosk_tpu_torch
    from vosk_tpu_torch.models.xvector import SpkModel, extract_xvector_for_recognizer
    from vosk_tpu_torch.utils import kaldidata

    path = Path(tmp) / "kaldi_spk"
    t0 = time.perf_counter()
    info = kaldidata.write_kaldi_xvector_dir(path, seed=SEED)
    t_write = time.perf_counter() - t0
    t0 = time.perf_counter()
    spk = vosk_tpu_torch.SpkModel(str(path))
    torch.cuda.synchronize()
    t_load = time.perf_counter() - t0
    if not all(t.is_cuda for w in spk._model.weights.values() for t in w.values()):
        raise AssertionError("the x-vector net's weights are not on the card")
    pcm = audio.astype("<i2").tobytes()
    piece = 6400

    def run(with_spk):
        args = (model, 16000, spk) if with_spk else (model, 16000)
        rec = vosk_tpu_torch.KaldiRecognizer(*args)
        for off in range(0, len(pcm), piece):
            rec.AcceptWaveform(pcm[off: off + piece])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = json.loads(rec.FinalResult())
        return out, time.perf_counter() - t0, rec

    torch.cuda.synchronize()
    zero_counts()  # every kernel count, just before the path
    res, final_spk, rec = run(True)
    launches = read_counts("the speaker stream")
    vec = res.get("spk")
    if not (vec is not None and len(vec) == 200 and np.all(np.isfinite(vec))
            and res.get("spk_frames", 0) >= 50):
        raise AssertionError(f"FinalResult carries no usable x-vector: "
                             f"{ {k: v for k, v in res.items() if k != 'spk'} }")
    r = rec._rec
    r.spk_model = SpkModel.load(path, device="cpu")
    cpu_vec, cpu_frames = extract_xvector_for_recognizer(r)
    err = float(np.abs(np.asarray(vec) - np.asarray(cpu_vec)).max())
    if cpu_frames != res["spk_frames"] or not err <= 1e-4:
        raise AssertionError(f"the x-vector on the card disagrees with the CPU: {err}, frames "
                             f"{res['spk_frames']} vs {cpu_frames}")
    spk_s = r.metrics.total_s.get("speaker", 0.0)
    _, final_plain, _ = run(False)
    log(f"speaker: Kaldi x-vector dir ({json.dumps(info)}) written in {t_write:.3f} s, "
        f"SpkModel load {t_load:.3f} s; 10.5 s voiced stream with the speaker model: "
        f"spk_frames {res['spk_frames']}, |spk| {np.linalg.norm(vec):.4f} (sqrt 200 = "
        f"{np.sqrt(200):.4f}); card vs CPU x-vector max abs diff {err:.3e} (bound 1e-4, "
        f"after length normalization, 6-decimal JSON); FinalResult {final_spk * 1e3:.3f} ms "
        f"with the speaker model ({spk_s * 1e3:.3f} ms of it the speaker stage) against "
        f"{final_plain * 1e3:.3f} ms without; {count_line(launches)}")
    return launches, dict(err=err, final_ms=final_spk * 1e3, final_plain_ms=final_plain * 1e3,
                          speaker_ms=spk_s * 1e3, spk_frames=res["spk_frames"])


EXACT3_PDFS = 20_000  # phase 14's output layer: the first round width above 2^14


def phase_exact3(torch, tmp):
    """Phase 14 (a): the v4 step on exact3 rows at full width.  The bench
    TDNN-F of phase 4 (40/512/96/192, 11 layers, bf16) with 20,000 pdfs, on
    phase 12's 200,000-state graph (pdf ids over 0..19,999), as a native
    dir.  Model + KaldiRecognizer stream 10.5 s of noise (it folds), counts
    zeroed just before; the decoder must be v4 on exact3 rows; the plain
    versions must give identical JSON; then BatchModel serves 8 x 3 s.  The
    two frame-step kernels against their plain versions on a real frame at
    B = 1 and under load at B = 32.  Returns ({path: launches}, {shape:
    phase_frame_step times})."""
    import numpy as np

    import vosk_tpu_torch
    from vosk_tpu_torch.io import native
    from vosk_tpu_torch.ops import frame_step
    from vosk_tpu_torch.utils import benchdata

    t0 = time.perf_counter()
    m = benchdata.make_bench_model(num_states=RESCORE_STATES, num_pdfs=EXACT3_PDFS, seed=SEED,
                                   device="cpu")
    path = Path(tmp) / "exact3_model"
    native.save_model(path, m.config, m.am_params, m.graph, m.words, m.phones,
                      m.phone_of_pdf, m.silence_pdfs)
    top = int(m.graph.em_pdf.max())
    del m
    gc.collect()
    t_gen = time.perf_counter() - t0
    t0 = time.perf_counter()
    model = vosk_tpu_torch.Model(str(path))  # the card by default
    vosk_tpu_torch.KaldiRecognizer(model, 16000)  # builds the shared decoder
    torch.cuda.synchronize()
    t_load = time.perf_counter() - t0
    dec = model._model.shared_decoder()
    if (dec.frame_step, dec.pack, dec.em_pack.shape[1]) != ("v4", "exact3", 3 * dec.M):
        raise AssertionError(f"a {dec.pdf_bits}-bit pdf model decoded with {dec.frame_step} "
                             f"on {dec.pack} rows")
    pcm = noise_pcm(10.5, 16000, SEED + 14)
    zero_counts()  # every kernel count, just before the path
    outs, t = stream_long(model, pcm, 16000)
    torch.cuda.synchronize()
    l_stream = read_counts("the exact3 streaming path")
    dec.step_ops = frame_step.PLAIN
    try:
        plain_outs, _ = stream_long(model, pcm, 16000)
    finally:
        dec.step_ops = frame_step.KERNELS
    if plain_outs != outs:
        raise AssertionError("the exact3 stream differs between the kernels and the plain "
                             "versions")
    a = t["accept"]
    log(f"exact3: {EXACT3_PDFS} pdfs (largest graph pdf {top}, {dec.pdf_bits} bits), graph "
        f"{dec.S} states after prep, M={dec.M}, rows [S+1, {dec.em_pack.shape[1]}] int32; "
        f"generated and saved in {t_gen:.3f} s, Model + first KaldiRecognizer {t_load:.3f} s; "
        f"10.5 s stream: AcceptWaveform p50 {np.median(a) * 1e3:.3f} ms max "
        f"{a.max() * 1e3:.3f} ms, {t['folded']} frames folded, FinalResult "
        f"{t['final'] * 1e3:.3f} ms; identical JSON with the plain versions; "
        f"{count_line(l_stream)}; text {json.loads(outs[-1])['text'][:40]!r}")
    times = {"exact3_b1": phase_frame_step(torch, "exact3_b1", dec, *real_frame(
        torch, dec, EXACT3_PDFS, SEED + 15))}
    del model, dec
    gc.collect()
    bm = vosk_tpu_torch.BatchModel(str(path), max_batch_size=B)
    bdec = bm._pipeline.dec
    if (bdec.frame_step, bdec.pack) != ("v4", "exact3"):
        raise AssertionError(f"BatchModel decoded with {bdec.frame_step} on {bdec.pack} rows")
    l_batch = phase_serving(torch, bm)
    fr, ll = loaded_frame(torch, bm)
    times["exact3_b32"] = phase_frame_step(torch, "exact3_b32", bdec, fr, ll, torch.ones(
        B, dtype=torch.bool, device=bdec.device))
    return {"exact3_streaming": l_stream, "exact3_batch": l_batch}, times


class Served:
    """The port's websocket server (ASRServer over `model`) on 127.0.0.1, an
    OS-chosen port, in a thread with its own event loop."""

    def __init__(self, model):
        import asyncio
        import threading

        from vosk_tpu_torch.server import wsproto
        from vosk_tpu_torch.server.ws import ASRServer

        ready = threading.Event()

        async def run():
            self.server = await wsproto.serve(ASRServer(model).handle, "127.0.0.1", 0)
            self.port = self.server.sockets[0].getsockname()[1]
            self.loop = asyncio.get_running_loop()
            ready.set()
            async with self.server:
                try:
                    await self.server.serve_forever()
                except asyncio.CancelledError:
                    pass

        self.thread = threading.Thread(target=lambda: asyncio.run(run()), daemon=True)
        self.thread.start()
        if not ready.wait(60):
            raise AssertionError("the websocket server did not start")

    def close(self):
        self.loop.call_soon_threadsafe(self.server.close)
        self.thread.join(60)
        if self.thread.is_alive():
            raise AssertionError("the websocket server did not stop")


def direct_results(model, pcm, piece, endpoints=True):
    """What a KaldiRecognizer on `model` returns for pcm fed in `piece`-byte
    pieces, words on: after each piece Result() at an endpoint, else
    PartialResult() (as the server and test_vosk.c call them; endpoints
    False calls neither, as test_vosk_mt.c), then FinalResult()."""
    import vosk_tpu_torch

    rec = vosk_tpu_torch.KaldiRecognizer(model, 16000)
    rec.SetWords(True)
    outs = []
    for off in range(0, len(pcm), piece):
        hit = rec.AcceptWaveform(pcm[off: off + piece])
        if endpoints:
            outs.append(rec.Result() if hit else rec.PartialResult())
    return outs + [rec.FinalResult()]


def phase_server(torch, model, clients=4):
    """Phase 14 (b): the port's websocket server on phase 4's model dir
    (phase 7's Model): `clients` concurrent wsproto clients each stream 3 s
    of noise in 8000-byte chunks with words on, counts zeroed just before;
    each final JSON must equal a direct KaldiRecognizer's on the same PCM,
    and both frame-step kernels must have launched.  Returns (launches, the
    running server)."""
    import asyncio

    import numpy as np

    from vosk_tpu_torch.server import wsproto

    pcms = [noise_pcm(REQUEST_SECONDS, 16000, SEED + 20 + i) for i in range(clients)]
    srv = Served(model)
    rtts = []

    async def client(pcm):
        async with wsproto.connect(f"ws://127.0.0.1:{srv.port}") as ws:
            await ws.send('{"config": {"sample_rate": 16000, "words": true}}')
            for off in range(0, len(pcm), 8000):
                t0 = time.perf_counter()
                await ws.send(pcm[off: off + 8000])
                json.loads(await ws.recv())
                rtts.append(time.perf_counter() - t0)
            await ws.send('{"eof": 1}')
            return await ws.recv()

    async def all_clients():
        return await asyncio.gather(*(client(p) for p in pcms))

    zero_counts()  # every kernel count, just before the path
    t0 = time.perf_counter()
    finals = asyncio.run(all_clients())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts("the websocket server")
    for i, (final, pcm) in enumerate(zip(finals, pcms)):
        want = direct_results(model, pcm, 8000)[-1]
        if final != want:
            raise AssertionError(f"client {i}: the server's final {final} != the direct "
                                 f"recognizer's {want}")
    r = np.array(rtts)
    log(f"server: {clients} concurrent clients x {REQUEST_SECONDS} s in 8000-byte chunks, "
        f"words on: {len(r)} chunk round trips p50 {np.median(r) * 1e3:.3f} ms max "
        f"{r.max() * 1e3:.3f} ms; wall {wall:.3f} s; every final equals the direct "
        f"KaldiRecognizer's; {count_line(launches)}; texts "
        f"{json.dumps([json.loads(f)['text'][:30] for f in finals])}")
    return launches, srv


def write_pcm_wav(path, pcm, rate=16000):
    import wave

    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes(pcm)


def srt_words(text):
    """The words of an srt file's subtitle lines, in order."""
    lines = [x for x in text.splitlines() if x.strip() and "-->" not in x
             and not x.strip().isdigit()]
    return " ".join(lines).split()


def phase_transcriber(torch, tmp, model_dir, srv, wav):
    """Phase 14 (c): the port's transcriber CLI (its default device, the
    card) on a 10 s WAV of phase 4's model, as txt and as srt, counts zeroed
    just before; then the same WAV through --server against (b)'s server.
    The three must give the same words.  Returns the CLI's launches."""
    from vosk_tpu_torch.transcriber import cli

    def run(argv):
        old = sys.argv
        sys.argv = ["vosk-transcriber-torch", *argv, "--tasks", "1", "--log-level", "WARNING"]
        try:
            cli.main()
        finally:
            sys.argv = old

    out = {k: Path(tmp) / f"phase14.{k}" for k in ("txt", "srt", "server.txt")}
    zero_counts()  # every kernel count, just before the path
    t0 = time.perf_counter()
    for fmt in ("txt", "srt"):
        run(["-m", str(model_dir), "-i", str(wav), "-o", str(out[fmt]), "-t", fmt])
    torch.cuda.synchronize()
    t_cli = time.perf_counter() - t0
    launches = read_counts("the transcriber CLI")
    t0 = time.perf_counter()
    run(["-i", str(wav), "-o", str(out["server.txt"]), "-t", "txt", "--server",
         f"ws://127.0.0.1:{srv.port}"])
    t_srv = time.perf_counter() - t0
    txt, srt, served = (out[k].read_text() for k in ("txt", "srt", "server.txt"))
    if not (txt.split() == srt_words(srt) == served.split()):
        raise AssertionError(f"the transcriber's txt {txt!r}, srt {srt_words(srt)} and server "
                             f"mode {served!r} differ")
    log(f"transcriber: CLI txt + srt on a 10 s WAV {t_cli:.3f} s (two model loads); server "
        f"mode {t_srv:.3f} s; the same {len(txt.split())} words in all three; "
        f"{count_line(launches)}")
    return launches


# Loaded by the C programs' embedded interpreter (on PYTHONPATH, first): a
# daemon thread writes the port's kernel counts to $VT_COUNTS_OUT every
# 0.1 s, since the programs never finalize the interpreter.  With VT_WARM
# set, each Model decodes 1 s of noise once it is loaded (the shared
# decoder's build, the first launches), so that test_vosk_mt.c's
# single-thread baseline times decoding alone; the counts written leave
# that decode out.  With VT_NO_TURNS set, models get no turn lock
# (NativeModel.turn_lock), to measure what it changes.
COUNTS_PROBE = '''
import json, os, sys, threading, time

_warm = {}


def _counts():
    fs, g = (sys.modules.get("vosk_tpu_torch.ops." + m) for m in ("frame_step", "gather"))
    if fs is None or g is None:
        return None
    return {"expand_v4": fs.expand_v4.launches, "select_v4": fs.select_v4.launches,
            "gather_rows": g.gather_rows.launches}


def _watch(path):
    while True:
        time.sleep(0.1)
        counts = _counts()
        if counts is None:
            continue
        counts = {k: v - _warm.get(k, 0) for k, v in counts.items()}
        with open(path + ".tmp", "w") as f:
            json.dump(counts, f)
        os.replace(path + ".tmp", path)


def _warmed(init):
    def __init__(self, *args, **kw):
        import numpy as np

        init(self, *args, **kw)
        rec = vosk_tpu_torch.KaldiRecognizer(self, 16000.0)
        rec.SetWords(True)
        pcm = (np.random.default_rng(0).standard_normal(16000) * 1000).astype("<i2")
        for off in range(0, len(pcm), 1600):
            rec.AcceptWaveform(pcm[off: off + 1600].tobytes())
        rec.FinalResult()
        _warm.update(_counts())
    return __init__


if os.environ.get("VT_NO_TURNS"):
    import contextlib

    from vosk_tpu_torch.io import native

    def _no_turns(init):
        def __init__(self, *args, **kw):
            init(self, *args, **kw)
            self.turn_lock = contextlib.nullcontext()
        return __init__

    native.NativeModel.__init__ = _no_turns(native.NativeModel.__init__)
if os.environ.get("VT_WARM"):
    import vosk_tpu_torch

    vosk_tpu_torch.Model.__init__ = _warmed(vosk_tpu_torch.Model.__init__)
threading.Thread(target=_watch, args=(os.environ["VT_COUNTS_OUT"],), daemon=True).start()
'''


def phase_cabi(torch, tmp, model, model_dir, wav, pcm):
    """Phase 14 (d): build libvosk_tpu_torch.so, compile core/test/test_vosk.c
    and test_vosk_mt.c (4 threads) against it into the build directory, and
    run both on the 10 s WAV (its samples `pcm`) with phase 4's dir (its
    files linked into a dir of their own whose words.txt gains the word
    "one", which test_vosk.c looks up and no arc of the graph outputs),
    VOSK_TPU_TORCH_DEVICE unset (the card).  Both must exit 0 and print what a direct KaldiRecognizer on
    `model` returns for the same calls; test_vosk_mt.c's thread scaling
    must reach MT_MIN_SCALING, its Model warmed by one decode before the
    single-thread baseline, and is printed once more without the model's
    turn lock; each program's kernel counts (read by COUNTS_PROBE in its
    process) must show both frame-step kernels.  Returns {program:
    launches}."""
    import os

    import numpy as np

    from vosk_tpu_torch.cabi import build as cabi

    t0 = time.perf_counter()
    lib = cabi.build()
    t_lib = time.perf_counter() - t0
    bdir = lib.parent
    t0 = time.perf_counter()
    for prog in ("test_vosk", "test_vosk_mt"):
        subprocess.run(["gcc", "-O2", f"-I{ROOT / 'core' / 'include'}", "-o", str(bdir / prog),
                        str(ROOT / "core" / "test" / f"{prog}.c"), f"-L{bdir}",
                        "-lvosk_tpu_torch", "-lpthread", f"-Wl,-rpath,{bdir}"], check=True)
    t_gcc = time.perf_counter() - t0
    cdir = Path(tmp) / "cabi_model"
    cdir.mkdir(exist_ok=True)
    for f in Path(model_dir).iterdir():
        if f.name != "words.txt":
            (cdir / f.name).symlink_to(f.resolve())
    words = (Path(model_dir) / "words.txt").read_text()
    n_words = len(words.splitlines())
    if any(x.split()[0] == "one" for x in words.splitlines() if x.strip()):
        raise AssertionError("the bench vocabulary already has the word 'one'")
    (cdir / "words.txt").write_text(words + f"one {n_words}\n")
    probe = Path(tmp) / "counts_probe"
    probe.mkdir(exist_ok=True)
    (probe / "sitecustomize.py").write_text(COUNTS_PROBE)
    sites = {str(Path(m.__file__).resolve().parents[1]) for m in (torch, np)}
    env = dict(os.environ)
    env.pop("VOSK_TPU_TORCH_DEVICE", None)
    env["PYTHONPATH"] = os.pathsep.join([str(probe), str(ROOT), *sorted(sites)] + (
        [env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    want = {"test_vosk": direct_results(model, pcm, 3200),
            "test_vosk_mt": direct_results(model, pcm, 3200, endpoints=False)[-1:]}
    launches, walls, notes = {}, {}, {}
    for key, prog, argv, extra in (
            ("test_vosk", "test_vosk", [], {}),
            ("test_vosk_mt", "test_vosk_mt", ["4"],
             {"VT_WARM": "1", "VOSK_MT_MIN_SCALING": MT_MIN_SCALING}),
            # for comparison, the models without their turn lock (no floor)
            ("test_vosk_mt_no_turns", "test_vosk_mt", ["4"],
             {"VT_WARM": "1", "VT_NO_TURNS": "1", "VOSK_MT_MIN_SCALING": "0"})):
        counts = Path(tmp) / f"{key}.counts.json"
        t0 = time.perf_counter()
        proc = subprocess.run([str(bdir / prog), str(cdir), str(wav), *argv],
                              env={**env, "VT_COUNTS_OUT": str(counts), **extra},
                              capture_output=True, text=True, timeout=600)
        walls[key] = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"{key} exited {proc.returncode}:\n{proc.stdout[-2000:]}\n"
                                 f"{proc.stderr[-4000:]}")
        if prog == "test_vosk":
            got = [x for x in proc.stdout.splitlines() if x.startswith("{")]
        else:
            got = [proc.stdout.split("RESULT ", 1)[1].splitlines()[0]]
            notes[key] = proc.stdout.strip().splitlines()[-1]
        if got != want[prog]:
            raise AssertionError(f"{key} printed {got[-1]} where the direct recognizer "
                                 f"gives {want[prog][-1]}")
        launches[key] = json.loads(counts.read_text()) if counts.exists() else {}
        if any(launches[key].get(k, 0) <= 0 for k in V4_KERNELS):
            raise AssertionError(f"{key} did not launch the frame-step kernels: "
                                 f"{launches[key]}")
    log(f"C ABI: libvosk_tpu_torch.so built in {t_lib:.3f} s ({lib}), test programs compiled "
        f"in {t_gcc:.3f} s; test_vosk wall {walls['test_vosk']:.3f} s, test_vosk_mt (4 "
        f"threads) wall {walls['test_vosk_mt']:.3f} s ({notes['test_vosk_mt']}; floor "
        f"x{MT_MIN_SCALING}), without the turn lock {walls['test_vosk_mt_no_turns']:.3f} s "
        f"({notes['test_vosk_mt_no_turns']}); all print the direct recognizer's results "
        f"(text {json.loads(want['test_vosk'][-1])['text'][:40]!r}); "
        f"counts in their processes {json.dumps(launches)}")
    return {k: launches[k] for k in ("test_vosk", "test_vosk_mt")}


TRAIN_CHUNKS, TRAIN_FRAMES = 64, 150  # phase 15's minibatch: Kaldi chain egs' chunk size
RNNLM_SENTENCES = 32                  # phase 15 (c)'s batch of seeded sentences


def rel_err(a, b) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


def device_events(torch, fn):
    """(device events, device us) of one call of fn under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    dev = [ev for ev in prof.events() if ev.device_type == torch.autograd.DeviceType.CUDA]
    if not dev:
        raise AssertionError("the profiler recorded no device event")
    return len(dev), sum(ev.time_range.elapsed_us() for ev in dev)


def phase_train_full_width(torch):
    """Phase 15 (a): LF-MMI and frame-CE steps of the bench TDNN-F at full
    width on the card.  Returns a dict of its numbers."""
    import numpy as np

    from vosk_tpu_torch.models import chain
    from vosk_tpu_torch.models.train import frame_ce_trainer
    from vosk_tpu_torch.utils.benchdata import bench_am_config

    cfg = bench_am_config()
    rng = np.random.default_rng(SEED + 40)
    n_out = -(-TRAIN_FRAMES // cfg.subsample)
    feats = rng.standard_normal((TRAIN_CHUNKS, TRAIN_FRAMES, cfg.feat_dim)).astype(np.float32)
    labels = rng.integers(0, cfg.num_pdfs, (TRAIN_CHUNKS, n_out))
    t0 = time.perf_counter()
    den = chain.DenominatorGraph.from_alignments(labels, cfg.num_pdfs)
    den.leaky_hmm = 0.1
    t_den = time.perf_counter() - t0

    t0 = time.perf_counter()
    cpu = chain.chain_trainer(cfg, feats, labels, den=den, device="cpu")
    cpu_loss = float(cpu.step()[0])
    cpu_norm = cpu.grad_norm()
    t_cpu = time.perf_counter() - t0
    del cpu
    gc.collect()

    card = chain.chain_trainer(cfg, feats, labels, den=den, device="cuda")
    losses, norms, walls = [], [], []

    def step():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(float(card.step()[0]))  # float() waits for the step
        walls.append(time.perf_counter() - t0)
        norms.append(card.grad_norm())

    step()                      # step 1: held to the CPU's; the warm step
    torch.cuda.reset_peak_memory_stats()
    step()                      # step 2: timed
    peak = torch.cuda.max_memory_allocated()
    events, device_us = device_events(torch, step)  # step 3: profiled
    if not all(np.isfinite(losses)) or not all(np.isfinite(norms)):
        raise AssertionError(f"chain losses or gradient norms not finite: {losses} {norms}")
    if rel_err(losses[0], cpu_loss) > 1e-3 or rel_err(norms[0], cpu_norm) > 1e-2:
        raise AssertionError(f"the card's first chain step disagrees with the CPU's: loss "
                             f"{losses[0]} vs {cpu_loss}, gradient norm {norms[0]} vs {cpu_norm}")

    # den_logprob forward + backward alone, on the network's output shape
    dden = chain.graph_to(den, "cuda")
    ll = torch.randn((TRAIN_CHUNKS, n_out, cfg.num_pdfs), device="cuda", requires_grad=True)

    def den_step():
        ll.grad = None
        chain.den_logprob(dden, ll).sum().backward()

    den_ms = event_ms(torch, den_step, n=5)
    den_events, den_us = device_events(torch, den_step)

    ce = frame_ce_trainer(cfg, feats, labels, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ce_loss = float(ce.step()[0])
    torch.cuda.synchronize()
    ce_wall = time.perf_counter() - t0
    if not np.isfinite(ce_loss):
        raise AssertionError(f"frame-CE loss not finite: {ce_loss}")
    out = dict(chunks=TRAIN_CHUNKS, frames=TRAIN_FRAMES, out_frames=n_out,
               pdfs=cfg.num_pdfs, den_build_s=t_den, cpu_step_s=t_cpu,
               losses=losses, cpu_loss=cpu_loss, loss_rel_err=rel_err(losses[0], cpu_loss),
               grad_norms=norms, cpu_grad_norm=cpu_norm,
               grad_norm_rel_err=rel_err(norms[0], cpu_norm),
               step_ms_first=walls[0] * 1e3, step_ms=walls[1] * 1e3,
               device_events_per_step=events, device_ms_per_step=device_us / 1e3,
               den_logprob_fwd_bwd_ms=den_ms, den_device_events=den_events,
               den_device_ms=den_us / 1e3, den_share_of_step=den_ms / (walls[1] * 1e3),
               peak_gib=peak / 2**30, ce_loss=ce_loss, ce_first_step_ms=ce_wall * 1e3)
    log("training (a) full width, chain on the bench TDNN-F: " + json.dumps(out))
    return out


def phase_recipe(torch, tmp):
    """Phase 15 (b): the recipe's demo (chain, 24 train and 6 dev
    utterances, 400 steps) on the card; counts zeroed just before stage 5.
    Returns (stage 5's launches, its numbers)."""
    from vosk_tpu_torch.training import recipe

    marks = []

    def hook(line):
        if line.startswith("stage 5"):
            zero_counts()
        marks.append((line, time.perf_counter()))

    t0 = time.perf_counter()
    rep = recipe.demo(str(Path(tmp) / "recipe_demo"), "chain", device="cuda", log=hook)
    t_end = time.perf_counter()
    launches = read_counts("the recipe's stage 5 (decode + score)")
    stages = {}
    for (line, t), nxt in zip(marks, [m[1] for m in marks[1:]] + [t_end]):
        if line.startswith("stage"):
            stages[line.split(":")[0]] = nxt - t
    if rep["wer"] > 0.15:
        raise AssertionError(f"the recipe's dev WER is above 0.15: {rep}")
    out = dict(report=rep, stage_s=stages, total_s=t_end - t0)
    log(f"training (b) recipe demo on the card: {json.dumps(out)}; stage 5 "
        f"{count_line(launches)}")
    return launches, out


def phase_train_rnnlm(torch, cfg):
    """Phase 15 (c): RNNLM steps at phase 12's native GRU dims over its
    vocabulary (cfg), on seeded sentences, card against CPU."""
    import numpy as np

    from vosk_tpu_torch.models.rnnlm import rnnlm_trainer

    rng = np.random.default_rng(SEED + 41)
    sents = [list(rng.integers(1, cfg.vocab_size, rng.integers(5, 16)))
             for _ in range(RNNLM_SENTENCES)]
    t0 = time.perf_counter()
    cpu_loss = float(rnnlm_trainer(cfg, sents, device="cpu").step()[0])
    t_cpu = time.perf_counter() - t0
    card = rnnlm_trainer(cfg, sents, device="cuda")
    losses, walls = [], []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(float(card.step()[0]))
        walls.append(time.perf_counter() - t0)
    if not all(np.isfinite(losses)) or rel_err(losses[0], cpu_loss) > 1e-4:
        raise AssertionError(f"RNNLM losses {losses} against the CPU's {cpu_loss}")
    out = dict(vocab=cfg.vocab_size, embed=cfg.embed_dim, hidden=cfg.hidden_dim,
               sentences=len(sents), losses=losses, cpu_loss=cpu_loss,
               loss_rel_err=rel_err(losses[0], cpu_loss), step_ms=[w * 1e3 for w in walls],
               cpu_step_s=t_cpu)
    log("training (c) RNNLM: " + json.dumps(out))
    return out


def native_rnnlm_config(path):
    """The RnnlmConfig of a native GRU rnnlm/ dir (its vocabulary and dims)."""
    from vosk_tpu_torch.models.rnnlm import RnnlmConfig

    return RnnlmConfig(**json.loads((Path(path) / "vosk_tpu_rnnlm.json").read_text()))


def phase_training(torch, tmp, rnnlm_cfg):
    """Phase 15: (a), (b) and (c).  Returns (stage 5's launches, numbers)."""
    t0 = time.perf_counter()
    full = phase_train_full_width(torch)
    gc.collect()
    torch.cuda.empty_cache()
    launches, rec = phase_recipe(torch, tmp)
    rnn = phase_train_rnnlm(torch, rnnlm_cfg)
    log(f"phase 15 (training) took {time.perf_counter() - t0:.3f} s")
    return launches, {"full_width": full, "recipe": rec, "rnnlm": rnn}


def main() -> int:
    t_start = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device; none is visible")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    log(smi)
    sys.path.insert(0, str(ROOT))
    from vosk_tpu_torch.ops import _kernels

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    lib = _kernels.build()
    t_kernel = time.perf_counter() - t0
    core = ROOT / "core" / "libvosk_tpu_core.so"
    if not core.exists():
        subprocess.run(["make", "-C", str(ROOT / "core"), "libvosk_tpu_core.so"],
                       check=True, stdout=sys.stderr)
    log(f"build: kernel library {lib.name} from "
        f"{', '.join(p.name for p in _kernels.sources())} in {t_kernel:.3f} s; "
        f"{core.name} present; ptxas per kernel:")
    for line in _kernels.build_log().splitlines():
        if "ptxas" in line and ("Compiling entry" in line or "Used" in line
                                or "spill" in line or "stack frame" in line):
            log("  " + line.strip())

    if sys.argv[1:] == ["--rescoring-only"]:  # phase 12 alone, for iterating on it
        with tempfile.TemporaryDirectory() as tmp:
            log(json.dumps(phase_rescoring(torch, tmp)))
        return 0
    if sys.argv[1:] == ["--training-only"]:  # phase 15 alone, for iterating on it
        from vosk_tpu_torch.models.rnnlm import RnnlmConfig

        with tempfile.TemporaryDirectory() as tmp:
            log(json.dumps(phase_training(torch, tmp, RnnlmConfig(
                vocab_size=100_001, embed_dim=1024, hidden_dim=1024))[1]))
        return 0
    if sys.argv[1:] == ["--pitch-only"]:  # phase 13 alone, for iterating on it
        with tempfile.TemporaryDirectory() as tmp:
            *_, model, audio, info = phase_pitch(torch, tmp)
            log(json.dumps([info, phase_speaker(torch, tmp, model, audio)]))
        return 0
    times, max_err = phase_kernel(torch, dev)
    with tempfile.TemporaryDirectory() as tmp:
        bm = phase_model(torch, dev, tmp)
        P = bm._model.am_config.num_pdfs
        phase_front_end(torch, bm)
        fs_times, profile = phase_decoder(torch, bm)
        launches = phase_serving(torch, bm)
        b1, b1_err = phase_kernel(torch, dev, cases=(
            ("b1_ll", "float32", 1, 6008, 28000),   # streaming acoustic lookup
            ("b1_tsil", "int32", 1, 7000, 7000),    # streaming tsil lookup
        ))
        max_err = max(max_err, b1_err)
        launches_streaming, bench_stream_model = phase_streaming(torch, Path(tmp) / "bench_model")
        launches_run_scan = phase_run_scan(torch, bm)
        launches_v3, v3_times, v3_err, v3_profile = phase_v3(torch, bm, tmp)
        max_err = max(max_err, v3_err)
        del bm
        launches_kaldi, launches_kaldi_batch, (n_kaldi, k_kaldi) = phase_kaldi(torch, tmp)
        kaldi_times, kaldi_err = phase_kernel(torch, dev, cases=(
            ("kaldi_ll", "float32", 1, 6008, n_kaldi),
            ("kaldi_tsil", "int32", 1, k_kaldi, k_kaldi),
        ))
        launches_split, launches_grammar, (d_main, d_gram) = phase_split(torch, tmp)
        split_times, split_err = phase_kernel(torch, dev, cases=(
            ("split_ll", "float32", 1, 6008, d_main.K * d_main.M),
            ("split_tsil", "int32", 1, d_main.K, d_main.K),
            ("grammar_ll", "float32", 1, 6008, d_gram.K * d_gram.M),
            ("grammar_tsil", "int32", 1, d_gram.K, d_gram.K),
        ))
        max_err = max(max_err, kaldi_err, split_err)
        for key, d, seed in (("split", d_main, SEED + 9), ("grammar", d_gram, SEED + 10)):
            fs_times[key] = phase_frame_step(torch, key, d, *real_frame(torch, d, P, seed))
        rescoring = phase_rescoring(torch, tmp)
        rnnlm = {k: rescoring.pop(k) for k in ("rnnlm", "gru")}
        launches_pitch, launches_pitch_batch, pitch_model, voiced, pitch_info = phase_pitch(
            torch, tmp)
        launches_speaker, speaker_info = phase_speaker(torch, tmp, pitch_model, voiced)
        del pitch_model
        gc.collect()
        t14 = time.perf_counter()
        launches_exact3, exact3_times = phase_exact3(torch, tmp)
        launches_server, srv = phase_server(torch, bench_stream_model)
        try:
            pcm10 = noise_pcm(10.0, 16000, SEED + 30)
            wav10 = Path(tmp) / "phase14.wav"
            write_pcm_wav(wav10, pcm10)
            launches_cli = phase_transcriber(torch, tmp, Path(tmp) / "bench_model", srv, wav10)
        finally:
            srv.close()
        launches_cabi = phase_cabi(torch, tmp, bench_stream_model, Path(tmp) / "bench_model",
                                   wav10, pcm10)
        del bench_stream_model
        log(f"phase 14 (exact3, server, transcriber, C ABI) took "
            f"{time.perf_counter() - t14:.3f} s")
        launches_recipe, training = phase_training(
            torch, tmp, native_rnnlm_config(Path(tmp) / "resc_native" / "rnnlm"))

    paths = {"streaming": launches_streaming, "run_scan": launches_run_scan,
             "kaldi": launches_kaldi, "kaldi_batch": launches_kaldi_batch,
             "split": launches_split, "grammar": launches_grammar, **launches_v3,
             **rescoring, "pitch": launches_pitch, "pitch_batch": launches_pitch_batch,
             "speaker": launches_speaker, **launches_exact3, "server": launches_server,
             "transcriber": launches_cli, "recipe": launches_recipe,
             **{f"cabi_{k}": {n: v.get(n, 0) for n in ("expand_v4", "select_v4", "gather_rows")}
                for k, v in launches_cabi.items()}}
    gather_times = {**b1, **kaldi_times, **split_times, **v3_times}
    kernels = [{
        "name": "gather_rows",
        "route": "cuda",
        "source": "vosk_tpu_torch/csrc/gather.cu",
        "replaces": "vosk_tpu/ops/gather.py:33",
        # its path is the v3 step's: the v3 run_scan's launches
        "launches": launches_v3["v3"]["gather_rows"],
        "launches_serving_v4": launches["gather_rows"],
        "v3_profiled_device_us_per_frame": v3_profile["device_us"],
        "v3_profiled_sort_us_per_frame": v3_profile["sort_us"],
        "max_abs_err": max_err,
        "ms": times["ll"][0],
        "plain_ms": times["ll"][1],
        "bound_ms": times["ll"][2],
        "bound_by": times["ll"][3],
        "library_ms": times["ll"][4],
        "tsil_ms": times["tsil"][0],
        "tsil_plain_ms": times["tsil"][1],
        "tsil_bound_ms": times["tsil"][2],
        "tsil_library_ms": times["tsil"][4],
        **{f"launches_{k}": v["gather_rows"] for k, v in paths.items()},
        **{f"{k}_ms": v[0] for k, v in gather_times.items()},
        **{f"{k}_plain_ms": v[1] for k, v in gather_times.items()},
        **{f"{k}_bound_ms": v[2] for k, v in gather_times.items()},
        **{f"{k}_library_ms": v[4] for k, v in gather_times.items()},
    }]
    for name, site in (("expand_v4", "vosk_tpu/ops/viterbi.py:879"),
                       ("select_v4", "vosk_tpu/ops/viterbi.py:1105")):
        main_t = fs_times["b32"][name]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "vosk_tpu_torch/csrc/frame_step.cu",
            "replaces": "vosk_tpu/ops/gather.py:33",
            "call_site": site,
            **({"rows": "packed16"} if name == "expand_v4" else {}),
            "launches": launches[name],
            "max_abs_err": max(t[name][4] for t in (*fs_times.values(), *exact3_times.values())),
            "ms": main_t[0],
            "plain_ms": main_t[1],
            "bound_ms": main_t[2],
            "bound_by": main_t[3],
            "library_ms": main_t[5],
            **{f"launches_{k}": v[name] for k, v in paths.items()},
            **{f"{shape}_{k}": t[name][i] for shape, t in fs_times.items() if shape != "b32"
               for i, k in ((0, "ms"), (1, "plain_ms"), (2, "bound_ms"), (5, "library_ms"))},
            "profiled_launches_per_frame": sum(v for k, v in profile.items() if name in k),
            **({f"{shape}_{k}": t[name][i] for shape, t in exact3_times.items()
                for i, k in ((0, "ms"), (1, "plain_ms"), (2, "bound_ms"))}
               if name == "select_v4" else {}),
        })
    e3 = exact3_times["exact3_b32"]["expand_v4"]
    kernels.append({
        "name": "expand_v4_exact3",
        "route": "cuda",
        "source": "vosk_tpu_torch/csrc/frame_step.cu",
        "replaces": "vosk_tpu/ops/gather.py:33",
        "call_site": "vosk_tpu/ops/viterbi.py:879",
        "rows": "exact3",
        # its path: BatchModel on the 20,000-pdf model
        "launches": launches_exact3["exact3_batch"]["expand_v4"],
        "launches_exact3_streaming": launches_exact3["exact3_streaming"]["expand_v4"],
        "max_abs_err": max(t["expand_v4"][4] for t in exact3_times.values()),
        "ms": e3[0],
        "plain_ms": e3[1],
        "bound_ms": e3[2],
        "bound_by": e3[3],
        "library_ms": e3[5],
        **{f"exact3_b1_{k}": exact3_times["exact3_b1"]["expand_v4"][i]
           for i, k in ((0, "ms"), (1, "plain_ms"), (2, "bound_ms"))},
    })
    log("rescoring RNNLM (torch ops, no hand kernel): " + json.dumps(rnnlm))
    log("pitch and x-vector (torch ops, no hand kernel): " + json.dumps(
        {"pitch": pitch_info, "speaker": speaker_info}))
    log("training (torch ops, no hand kernel; the recipe decodes through expand_v4 and "
        "select_v4): " + json.dumps(training))
    log(f"chip_smoke.py took {time.perf_counter() - t_start:.3f} s")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
