#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (vosk_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--rescoring-only | --pitch-only | --training-only | --csr-only
                           | --mesh-only | --adaptive-only | --threads-only | --capture-only]

(`--rescoring-only` / `--pitch-only` / `--training-only` / `--csr-only` /
`--mesh-only` / `--adaptive-only` build the kernels and run phase 12 / 13 /
15 / 16 / 17 / 18 alone, with no result line; `--csr-only` builds phase 4's
model and phase 10's directory first, `--mesh-only` phase 4's model and
phase 11's v3 decoder, `--adaptive-only` phase 4's model; `--mesh-only`
leaves out 17e's nnet3 part, which runs in phase 9.  `--threads-only` runs
phase 7's long stream and phase 14 (b0), (b) and (d) on phase 4's model,
with test_vosk_mt.c 5 times, each held to its floor.  `--capture-only` runs
phases 4, 5, 7 and 8 on phase 4's model with phase 19's checks in them,
phase 9's nnet3 AM check on phase 4's TDNN-F exported as nnet3 with the
i-vector graft.)
Phases, each of which raises on failure (the script then exits non-zero and
prints no result line):
  1. require CUDA; print the card's name and power limit (nvidia-smi);
  2. build the kernel library (every csrc/*.cu, one nvcc each, in
     parallel, linked into one .so) and print ptxas's registers, shared
     memory and spills per kernel (expand_v4's and gather_rows's kernels
     must not spill); build, if absent, the native lattice library (make
     -C core libvosk_tpu_core.so);
  3. the gather kernel against its plain PyTorch version on the card, bit
     for bit, at the shapes its v4 call sites had plus a ragged N, index
     P-1 and out-of-range indices, under its own choice of how it reads
     the table row and under each of GATHER_STAGES (in place, staged,
     multicast over a cluster of a channel's tiles), with its time, the
     plain time, one torch.gather call's, and each stage's time five times
     interleaved (median and range; so at every gather shape below);
  4. generate the full-width bench model (TDNN-F 40/512/96/192/6008, 11
     layers, bf16; a 2M-state realistic graph with 100k words), save it as
     a native model dir and open it with BatchModel(max_batch_size=32);
     check features + AM on the card against the same modules on the CPU,
     and a few full-width decoder chunks three ways (the frame-step
     kernels, their plain versions on the same CUDA tensors, CPU):
     frontier and all five record planes must be bit-equal; then the two
     frame-step kernels (expand_v4, select_v4) against their plain
     versions, bit for bit, on one real frame at B = 32 and at B = 1
     (K = 7000, M = 4, R = 7000), on a B = 32 frame under load (flat
     scores, channels at max-active, the whole pool in range) and on the
     same at max-active 10,000 (select_v4's pass 2 in global scratch), with
     kernel, plain and bound times, select_v4's pass-1 list length, in-range
     count and winners per channel and its scratch bytes a call,
     select's yardstick (one stable torch.sort of the same pool, the first
     of the three sorts it replaces), and expand's two ways of reading the
     ll row (EXPAND_STAGES), five times each, interleaved.  expand_v4
     is held to its contract: keys bit-equal everywhere, nsm and pm where
     the key is below BIG (it leaves them unwritten elsewhere); select_v4
     runs on the expand kernel's pool with the payload of every BIG key
     overwritten by seeded garbage and must give the plain selection of the
     plain pool.  expand's bound counts 4 bytes a candidate's key and 8 a
     real arc's payload (the count before PR 15, all three planes, is
     printed beside it); then one decode_chunk at B = 32
     under torch.profiler, replayed from its captured program and through
     the eager body: its device kernels by name with counts per frame,
     where the frame step may launch only expand_v4 and select_v4's two
     kernels, at most 3 a frame, and no sort or gather (a replay adds at
     most CHUNK_COPIES copies a chunk);
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
     without the graft serves 8 x 3 s through BatchModel(max_batch_size=32)
     and runs 17e's nnet3 mesh;
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
     KaldiRecognizer's; round trip per chunk (p50, max) and the
     recognizers' combined steps (their number by rows); before it, (b0)
     combined steps on the card: STEP_ROWS (4) recognizers of the model
     (distinct noise) step 3 chunks, the AM's flush and 3 more chunks
     together (runtime/recognizer.py combined_step, STEP_ROWS rows), and so
     does each alone: features, ll, frontier and records must be bit-equal
     row by row, and the retained record bytes equal; then, unbounded, the
     rows of 2-4 streams stepped unpadded at their number of rows that
     differ from each stream's alone at 1 row are counted; (c) the
     transcriber CLI (txt, srt) on a 10 s WAV, and the same WAV through
     --server against (b)'s server: the same words; (d) the C ABI:
     libvosk_tpu_torch.so built, core/test/test_vosk.c and test_vosk_mt.c
     (4 threads) compiled against it into its build directory and run on
     the WAV with phase 4's dir (words.txt gains "one", which test_vosk.c
     looks up), VOSK_TPU_TORCH_DEVICE unset: both must exit 0 and print
     what a direct recognizer returns, test_vosk_mt.c's 4 threads must
     reach its own x1.5 scaling floor over a warmed model (no
     VOSK_MT_MIN_SCALING), with the number of steps the 4 threads took and
     their mean rows printed, and run once more with the model's combiner
     stepping one stream at a time (no floor; for comparison), and their
     processes' kernel counts must show both frame-step kernels.
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
 16. (a and c run after 11 on the model of phase 4, b after 10) the CSR
     decoder, which reaches no hand kernel (torch ops; its path must
     launch none): (a) layout="csr" on the raw 2M-state graph at B = 32,
     two chunks on the card and on the CPU, frontier, nine record planes
     and best costs bit-equal; one chunk profiled (device events a frame);
     FusedPipeline.run_scan at phase 8's point (ms a decoded frame beside
     phase 11's padded v3 and phase 8's v4, peak memory); (b) phase 10's
     split directory (the source's own choice there is CSR) on a CSR
     decoder given to Model as its shared decoder: 3 s through
     KaldiRecognizer on the card and on the CPU, the same JSON
     (confidences within 1e-3), AcceptWaveform p50/max and FinalResult
     beside the default wide padded v4 decoder's on the same stream, and
     whether their JSON agrees (printed, not checked); (c) the padded v3
     step on a synthetic graph (the raw graph with 100,000 seeded states
     given 40 eps arcs each), so its eps rounds are the CSR step's, K =
     7000, B = 32: 6 + 17 frames on the card, the first 6 on the CPU too,
     bit-equal; every eps round must go through viterbi_csr.eps_level and
     some eps-round lattice arc must leave a hub.  Phase 16 lines carry
     the card's name and power limit.
 17. (run after 16 a and c, on phase 4's model and phase 11's v3 decoder)
     the device mesh and the sharded search, each mesh's ranks being
     processes (parallel/launch.py run_group) that share the card over
     gloo, so nothing here measures scaling; the ranks load the parent's
     prepared decoders from torch.save files: (a) mesh (1, 4): gloo's MIN
     all-reduce of int32 and all_gather on CUDA tensors; the sharded v4
     decode of two 8-frame chunks of plausible scores at B = 32, counts
     zeroed just before: every rank agrees, and best, best-final, the
     frontier, the pm / state / f_cost planes and every channel's
     traceback equal the unsharded decode_chunk's on the card (the lattice
     planes differ by design: the source keys candidates past the synced
     beam BIG); each rank's expand_v4 stripe (slot_base i, slot_stride 4;
     every stage choice, under expand's contract; stripe 0's stages timed)
     and the merged pool through select_v4 against their plain versions,
     bit for bit, timed in rank 0 beside the unsharded pool, on a light
     frame and on phase 4's loaded one (every rank's contribution
     overflows); from that loaded frontier a 4-frame sharded chunk whose
     best, best-final and tracebacks equal the unsharded decode's; one
     chunk profiled in rank 0 (expand_v4 once and select_v4's two kernels
     a frame, no gather_rows); then mesh (1, 2); (b) the sharded v3 step
     on the raw graph, mesh (1, 2), one chunk: best, best-final, frontier
     and tracebacks equal the unsharded v3 decode's, gather_rows launched;
     a CPU gloo group then runs (a)'s (1, 4) decode, equal record planes
     included; (c) FusedPipeline(mesh=(2, 2)).run_scan at phase 8's point:
     each channel's data-parallel decode from the same scores bit-equal,
     the tensor-parallel AM's ll within TP_LL_TOL and TP_SHARE_TOL and the
     best costs within TP_BEST_ATOL of the unsharded pipeline, and three
     planted faults of the tensor-parallel forward (TP_FAULTS) reading
     above those ll bounds; ms a
     decoded frame beside phase 8's; (e) FusedPipeline(mesh=(2,
     1)).run_adaptive at phase 8's point, seg 1, the AM silent (its output
     matrix zeroed) and the two data halves on phase 8's and snr 32's
     scores, so that each half alone would take other rungs: every rank
     takes the unsharded run's rungs (the global batch's live count), best
     and frontier bit-equal; and, in phase 9 on its directory without
     the graft, FusedPipeline(mesh=(1, 2)) with the nnet3 AM, which each
     rank runs whole: best, frontier and records bit-equal to the
     unsharded pipeline's.  Phase 17 lines carry the card's name and power
     limit.
 18. (run after 8, on phase 4's model) the adaptive max-active ladder,
     FusedPipeline.run_adaptive (rungs 1024 / 2048 / 4096 / 7000, seg 4,
     headroom 0.75; rung decoders from clone_with_max_active): (a) against
     run_scan at phase 8's point, interleaved (scan, ladder, ladder, scan)
     six times, counts zeroed just before each ladder drive (one expand_v4
     and one select_v4 a decoded frame): ms per decoded frame as median and
     range ("unresolved" where the ranges overlap), audio-s/s, the rung of
     each segment, live tokens p50 and max; one drive of each profiled
     (device busy time, idle share); (b) easy scores (snr 32) over the
     leading chunks in which every frame fits its rung (in-range
     candidates <= K2, winners <= K), seg 1: best bit-equal to run_scan's,
     32 tracebacks equal, on bench.py's ladder and on a two-rung ladder
     cut from a fixed-K drive so that the exact chunks step up; (c) a
     segment at each rung below 7000 from phase 4's loaded frontier cut to
     it: kernels, plain versions and CPU bit-equal, frontier sorted by
     cost; (d) expand_v4 and select_v4 against their plain versions at
     each rung on a real frame and under load, times, bounds and
     select_v4's torch.sort yardstick.
 19. (run inside phases 4, 8, 18, 10 and 14) the captured chunk programs:
     v4 decode_chunk on the card replays one CUDA graph per chunk shape
     (ops/viterbi.py `_ChunkProgram`).  Captured against the eager body
     (`decode_chunk_eager`), bit for bit over chained chunks, every
     chunk's frontier, 5 record planes, best and best-final kept to the end
     (`captured_vs_eager`): phase 4's decoder on its light chunks, from
     `loaded_frame` and at the combined recognizer step's STEP_ROWS = 4
     rows; the rungs K = 1024 / 2048 / 4096 from the loaded frontier cut
     to each (18c); phase 10's split (M = 266) and grammar (K = 124)
     decoders; phase 14's exact3 decoders at B = 1 and from the loaded
     frontier at B = 32.  Host ms a decode_chunk call, captured against
     eager, interleaved (`chunk_times`), with the device memory a program
     of the shape holds: B = 32 and B = 4 at T = 7, B = 32 at T = 17 and
     the K = 1024 rung.  run_scan eager against captured, interleaved (ms a
     decoded frame, best bit-equal), and one profiled drive of each (idle
     share).  The serving, streaming, run_scan and run_adaptive paths must
     replay (`read_replays`); run_adaptive's counts stay one expand_v4 and
     one select_v4 a decoded frame.  "19 am" (run inside phases 4, 8 and
     9): the AM's process_chunk and flush on the card replay one CUDA
     graph per chunk shape (models/streaming.py `_AmChunkProgram`).
     Captured against the eager body (`process_chunk_eager`, the eager
     flush), bit for bit over 3 chained feature chunks and the flush,
     every call's state, out and out_valid kept to the end
     (`am_captured_vs_eager`): phase 4's bench TDNN-F at B = 32 and at the
     combined step's STEP_ROWS = 4 rows, and phase 9's nnet3 AM with its
     i-vector input (dim 100) at 4 rows.  Host ms a process_chunk call,
     captured against eager, interleaved (`am_chunk_times`), with the
     device memory a program holds: B = 32 and B = 4 at phase 4's chunk,
     B = 32 at run_scan's.  run_scan with the AM eager against captured,
     the decoder captured in both, interleaved (ms a decoded frame, best
     bit-equal, AM replays counted), and one profiled drive of each (idle
     share).  Those four paths must replay AM programs too.
The line before the last is the kernel table as JSON (bounds from the
bytes and operations each call's data needs, over the H100 SXM data
sheet's 3.35 TB/s and 67 TFLOP/s in f32); the last line is
{"ok": true, "device": {...}}.  Weights and audio come from fixed seeds;
nothing is downloaded.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import math
import statistics
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


def event_ms(torch, fn, n=100, sleep_cycles=200_000_000):
    """Device time of one call of fn, from CUDA events around n calls
    enqueued behind a device-side sleep (so host launch overhead is not
    timed), after a warm-up."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(sleep_cycles)
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


def check_no_spills(build_log, kernels=("expand_v4_kernel", "gather_rows_kernel")):
    """{function: [spill store bytes, spill load bytes]} from ptxas's -v
    report (the line after "Function properties for <name>"); raises if a
    function of `kernels` spills."""
    spills, fn = {}, None
    for line in build_log.splitlines():
        if "Function properties for" in line:
            fn = line.split("Function properties for", 1)[1].strip()
        elif "spill stores" in line and fn is not None:
            words = line.replace(",", " ").split()
            spills[fn] = [int(words[words.index("spill") - 2]),
                          int(words[len(words) - 1 - words[::-1].index("spill") - 2])]
            fn = None
    bad = {f: v for f, v in spills.items() if any(k in f for k in kernels) and any(v)}
    if bad or not any(any(k in f for k in kernels) for f in spills):
        raise AssertionError(f"ptxas: spills in {bad or 'no report for the kernels'}")
    return spills


def zero_counts():
    """Every kernel's launch count, and the decoder's and the AM's chunk
    programs' capture and replay counts, to 0, just before a path is
    driven."""
    from vosk_tpu_torch.models.streaming import GRAPH_COUNTS as AM_COUNTS
    from vosk_tpu_torch.ops.frame_step import GRAPH_COUNTS, expand_v4, select_v4
    from vosk_tpu_torch.ops.gather import gather_rows

    expand_v4.launches = select_v4.launches = gather_rows.launches = 0
    GRAPH_COUNTS.update(captures=0, replays=0)
    AM_COUNTS.update(captures=0, replays=0)


V4_KERNELS = ("expand_v4", "select_v4")  # the v4 step's kernels
V3_KERNELS = ("gather_rows",)             # the v3 step's kernel


def read_counts(what, need=V4_KERNELS):
    """{kernel: launches} since zero_counts(); raises unless every kernel
    in `need` (the path's step) launched and no other kernel did (the CSR
    step's `need` is empty: it launches none)."""
    from vosk_tpu_torch.ops.frame_step import expand_v4, select_v4
    from vosk_tpu_torch.ops.gather import gather_rows

    counts = {"expand_v4": expand_v4.launches, "select_v4": select_v4.launches,
              "gather_rows": gather_rows.launches}
    if any(counts[k] <= 0 for k in need) or any(counts[k] for k in counts if k not in need):
        raise AssertionError(f"{what} did not launch exactly the kernels {need}: {counts}")
    return counts


REPLAYS = {}  # {path: decoder chunk programs replayed}, its first run (read_replays)
AM_REPLAYS = {}  # {path: AM chunk programs replayed}, the same


def read_replays(what, key) -> int:
    """The decoder's captured chunk programs replayed since zero_counts()
    (the first reading of each key kept in REPLAYS, and the AM's in
    AM_REPLAYS); raises unless the path replayed a program of each."""
    from vosk_tpu_torch.models.streaming import GRAPH_COUNTS as AM_COUNTS
    from vosk_tpu_torch.ops.frame_step import GRAPH_COUNTS

    n, n_am = GRAPH_COUNTS["replays"], AM_COUNTS["replays"]
    REPLAYS.setdefault(key, n)
    AM_REPLAYS.setdefault(key, n_am)
    if n <= 0 or n_am <= 0:
        raise AssertionError(f"{what} replayed no captured chunk program: decoder "
                             f"{GRAPH_COUNTS}, AM {AM_COUNTS}")
    return n


def on_device(records) -> bool:
    """Every plane of one chunk's decoder records is a CUDA tensor."""
    return all(v.is_cuda for v in records.values())


def count_line(counts) -> str:
    return ", ".join(f"{k} launches {v}" for k, v in counts.items())


def stage_times(torch, fns, reps=5) -> str:
    """Each of {stage: fn} (one kernel launch each) timed `reps` times,
    interleaved: median [min, max] ms of each.  The sleep ahead of each
    timing is a tenth of event_ms's: it still outlasts the host's enqueue
    of 100 launches."""
    ts = {st: [] for st in fns}
    for _ in range(reps):
        for st, fn in fns.items():
            ts[st].append(event_ms(torch, fn, sleep_cycles=20_000_000))
    return "; ".join(f"{st} {statistics.median(t):.6f} [{min(t):.6f}, {max(t):.6f}] ms"
                     for st, t in ts.items())


def phase_kernel(torch, dev, cases=(
        ("ll", "float32", B, 6008, 28000),   # acoustic lookup ll[b, pdf]
        ("tsil", "int32", B, 7000, 7000),    # trailing-silence lookup
        ("ragged", "float32", 3, 300, 4097),  # N one past a block
)):
    from vosk_tpu_torch.ops.gather import GATHER_STAGES, gather_rows, gather_rows_plain

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
        ref = gather_rows_plain(table, idx)
        for stage in (None, *GATHER_STAGES):  # the kernel's choice, then each forced
            got = gather_rows(table, idx, stage=stage)
            torch.cuda.synchronize()
            if not torch.equal(bits(torch, got), bits(torch, ref)):
                raise AssertionError(
                    f"gather kernel (row read: {stage}) != torch.gather at {name} {b}x{P}<-{N}")
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
        log(f"gather {name}, row read 5 x interleaved: " + stage_times(
            torch, {st: lambda st=st: gather_rows(table, idx, stage=st) for st in GATHER_STAGES}))
    return results, max_err


def pool_err(torch, got, want, what):
    """Largest bit distance between the expand kernel's pool and the plain
    version's under the pool's contract: every key, and nsm and pm where
    the key is below BIG (the kernel leaves them unwritten elsewhere).
    Raises unless 0."""
    from vosk_tpu_torch.ops.frame_step import BIG_I32

    real = want[0] < BIG_I32
    err = max(bit_err(torch, got[0], want[0]),
              *(bit_err(torch, a[real], b[real]) for a, b in zip(got[1:], want[1:])))
    if err:
        raise AssertionError(f"expand_v4 kernel != plain at {what}")
    return err


def garble_payload(torch, pool, seed):
    """The pool with the nsm and pm of every BIG-keyed candidate replaced by
    seeded garbage; returns (pool, words garbled a plane)."""
    from vosk_tpu_torch.ops.frame_step import BIG_I32

    cb, nsm, pm = (x.clone() for x in pool)
    big = cb == BIG_I32
    n = int(big.sum())
    g = torch.Generator(device=cb.device).manual_seed(seed)
    for plane in (nsm, pm):
        plane[big] = torch.randint(-(2**31), 2**31, (n,), generator=g, device=cb.device,
                                   dtype=torch.int64).int()
    return (cb, nsm, pm), n


def expand_work(torch, dec, fr, P):
    """(bytes, operations, bytes as counted before PR 15) that expand_v4
    must move and do on frontier fr: every token state; cost and arc row of
    each live token (packed16: the pdf words of all M slots and the next
    states of the finite arcs; exact3: the weights of all M slots, next
    state and meta of the finite arcs); the ll entries those finite arcs
    reach, once per channel; the key of every candidate ([B, K*M] int32)
    and the next state and pm word of each finite arc of a live token (nsm
    and pm are defined where the key is below BIG).  The count before PR 15
    took all three [B, K*M] planes as output."""
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
    inputs = 4 * Bn * K + 4 * n_live + 4 * M * n_live + per_finite * n_fin + 4 * reached.numel()
    # an add and a fused multiply-add per finite arc
    return inputs + 4 * Bn * K * M + 8 * n_fin, 3 * n_fin, inputs + 12 * Bn * K * M


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
    pools = {}
    for stage in (None, *fs.EXPAND_STAGES):  # the kernel's choice, then each forced
        pools[stage] = fs.expand_v4(*ex, stage=stage)
        err["expand_v4"] = max(err["expand_v4"], pool_err(torch, pools[stage], ref,
                                                          f"{name} (ll read: {stage})"))
    # select_v4 on the kernel's pool, the payload of every BIG key garbled
    # (the expand kernel leaves it unwritten), against the plain selection
    # of the plain pool
    garbled, n_big = garble_payload(torch, pools[None], SEED + Bn + K)
    del pools
    sel_args = (fr, valid, dec.params.beam, dec.params.lattice_beam, S, dec.mbits, dec.K2, R)
    sel = (*ref, *sel_args)
    outs = [dec.record_buffers((2, Bn)) for _ in range(2)]
    k_out = {k: v[1] for k, v in outs[0].items()}
    p_out = {k: v[1] for k, v in outs[1].items()}
    stats = torch.zeros((Bn, 3), dtype=torch.int32, device=dec.device)
    kf, krec = fs.select_v4(*garbled, *sel_args, k_out, scratch=dec._select_scratch,
                            stats=stats)
    pf, prec = fs.select_v4_plain(*sel, p_out)
    torch.cuda.synchronize()
    st = stats.cpu()
    E = K * M
    log(f"select_v4 {name} per channel: pass-1 list {st[:, 0].tolist()}, in range "
        f"{st[:, 1].tolist()}, winners {st[:, 2].tolist()}; scratch "
        f"{fs.SelectScratch.nbytes(Bn, E, K, dec.K2, R)} bytes a call (pass 2 in "
        f"{'global' if fs.select_in_global(E, K, dec.K2, R) else 'shared'} memory; the "
        f"list alone {4 * Bn * E} bytes, {8 * Bn * E} with int64 entries)")
    for what, got, want in (("frontier", kf, pf), ("records", krec, prec)):
        for k in got:
            err["select_v4"] = max(err["select_v4"], bit_err(torch, got[k], want[k]))
            if not torch.equal(bits(torch, got[k]), bits(torch, want[k])):
                raise AssertionError(f"select_v4 kernel on the garbled kernel pool != plain "
                                     f"at {name}: {what}[{k}]")
    live = int((fr["state"] != S).sum())
    kept = int((pf["cost"] < float("inf")).sum())
    # bounds from what this frame needs: each needed input byte read once,
    # each output byte written once
    ex_bytes, ex_ops, ex_bytes_before = expand_work(torch, dec, fr, P)
    ex_b = bound(ex_bytes, ex_ops)
    log(f"expand_v4 {name}: select_v4 on the kernel pool with {n_big} BIG-keyed payloads "
        f"garbled = plain on the plain pool; bound {ex_b[0]:.6f} ms in the count of PR 15 "
        f"({ex_bytes} bytes), {bound(ex_bytes_before, ex_ops)[0]:.6f} ms in the count before "
        f"({ex_bytes_before} bytes)")
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
            f"{kept} kept: "
            + ("keys bit-equal to plain, nsm and pm where below BIG" if kname == "expand_v4"
               else "bit-equal to plain (on the garbled kernel pool)")
            + f"; kernel {ms:.6f} ms, plain {plain_ms:.6f} ms"
            + (f", stable torch.sort of the pool {lib_ms:.6f} ms" if lib else "")
            + f", bound {b_ms:.6f} ms ({b_by}), {b_ms / ms:.1%} of it")
    # each way of reading the ll row, five times each, interleaved
    log(f"expand_v4 {name}, ll row read 5 x interleaved: " + stage_times(
        torch, {st: lambda st=st: fs.expand_v4(*ex, stage=st) for st in fs.EXPAND_STAGES}))
    return out


CHUNK_COPIES = 15  # a replay's copies: 5 in (frontier, scores, mask), 10 out


def profile_rows(torch, fn):
    """fn() after a warm-up call, under torch.profiler: {device row name:
    (launches, device us)}."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = {}  # device kernel, copy or memset: (launches, device us)
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            c, us = rows.get(ev.name, (0, 0.0))
            rows[ev.name] = (c + 1, us + ev.time_range.elapsed_us())
    return rows


def phase_profile(torch, dec, fr, ll, valid):
    """One decode_chunk at B = 32 under torch.profiler, as a replay of its
    captured program, then the same chunk through the eager body
    (decode_chunk_eager): device kernels by name with launches per frame.
    In both the frame step may launch only the expand_v4 and select_v4
    kernels, at most 3 a frame, and no sort or gather; the rest (the
    chunk-end reductions, and a replay's copies in and out, at most
    CHUNK_COPIES) must not repeat per frame.  Returns the replay's {kernel
    name: launches per frame}."""
    T = ll.shape[1]
    out = {}
    for way, fn in (("replayed", dec.decode_chunk), ("eager", dec.decode_chunk_eager)):
        rows = profile_rows(torch, lambda: fn(fr, ll, valid))
        if not rows:
            raise AssertionError(f"the profiler recorded no device kernel ({way})")
        step = {k: v for k, v in rows.items() if "expand_v4" in k or "select_v4" in k}
        copies = {k: v for k, v in rows.items() if k.startswith(("Memcpy", "Memset"))}
        per_frame = {k: c / T for k, (c, _) in rows.items()}
        log(f"profiled decode_chunk ({way}) B={fr['state'].shape[0]} T={T}: device rows "
            f"(launches per frame, device us per frame): " + json.dumps(
                {k: [per_frame[k], round(us / T, 3)] for k, (c, us) in sorted(rows.items())}))
        bad = [k for k in rows if "sort" in k.lower() or "gather" in k.lower()]
        repeats = [k for k, (c, _) in rows.items()
                   if k not in step and k not in copies and c >= T]
        n_copies = sum(c for c, _ in copies.values())
        if bad or repeats or not step or sum(c for c, _ in step.values()) > 3 * T \
                or n_copies > (CHUNK_COPIES if way == "replayed" else 0):
            raise AssertionError(f"the frame step ({way}) launched more than its kernels: "
                                 f"sort/gather {bad}, per-frame others {repeats}, frame-step "
                                 f"kernels {step}, copies {copies}")
        out[way] = per_frame
    return out["replayed"]


# ------------------------------------------------------------------ phase 19

CAPTURE_REPS = 20    # 19's chunk times: calls a timing, ended by one synchronize
CAPTURE_ROUNDS = 3   # 19's interleaved rounds (eager, captured, captured, eager)
CAPTURE_SECONDS = {}  # phase 19's checks: seconds each, run inside the phases named


def captured_vs_eager(torch, name, dec, chunks, valid, fr0=None):
    """Phase 19: decode_chunk (the captured program of the chunks' shape,
    captured by the first call of a new shape) against decode_chunk_eager,
    bit for bit, over the chained chunks of dec from fr0 (a fresh frontier
    by default): every chunk's frontier, 5 record planes, best and
    best-final, all kept to the end, so that a returned buffer a later
    replay overwrote would show.  Every chunk must replay."""
    from vosk_tpu_torch.ops.frame_step import GRAPH_COUNTS

    t0 = time.perf_counter()
    B = chunks[0].shape[0]

    def run(fn):
        fr = fr0 if fr0 is not None else dec.init_frontier(B)
        kept = []
        for ll, v in zip(chunks, valid):
            fr, rec, best, bestf = fn(fr, ll, v)
            kept.append({**{f"frontier.{k}": x for k, x in fr.items()}, **rec, "best": best,
                         "best_final": bestf})
        torch.cuda.synchronize()
        return kept

    r0, c0 = GRAPH_COUNTS["replays"], GRAPH_COUNTS["captures"]
    got = run(dec.decode_chunk)
    replays, captures = GRAPH_COUNTS["replays"] - r0, GRAPH_COUNTS["captures"] - c0
    want = run(dec.decode_chunk_eager)
    for i, (a, b) in enumerate(zip(got, want)):
        for k in b:
            if not torch.equal(bits(torch, a[k]), bits(torch, b[k])):
                raise AssertionError(f"19 {name}: chunk {i} {k}: captured != eager")
    if replays != len(chunks):
        raise AssertionError(f"19 {name}: {replays} replays for {len(chunks)} chunks")
    live = torch.isfinite(got[-1]["frontier.cost"]).sum(1)
    CAPTURE_SECONDS[name] = time.perf_counter() - t0
    log(f"19 {name}: B={B} K={dec.K} R={dec.R} M={dec.M} ({dec.pack} rows), chunks "
        f"{sorted({tuple(c.shape) for c in chunks})} x {len(chunks)}: captured = eager bit for "
        f"bit (frontier, 5 record planes, best, best-final of every chunk, kept to the end); "
        f"{replays} replays, {captures} captures; live tokens after {live.min().item()}-"
        f"{live.max().item()}; {CAPTURE_SECONDS[name]:.3f} s")


def seeded_chunks(torch, dec, batch, P, seed, n=2, T=7, scale=2.0):
    """n chunks [batch, T, P] of seeded N(0, scale^2) scores on dec's device,
    with a masked hole in channel 0 of the first, and their valid masks."""
    g = torch.Generator().manual_seed(seed)
    chunks = [(torch.randn((batch, T, P), generator=g) * scale).to(dec.device)
              for _ in range(n)]
    valid = [torch.ones((batch, T), dtype=torch.bool, device=dec.device) for _ in range(n)]
    valid[0][0, 2:4] = False
    return chunks, valid


def spread(ms) -> str:
    ms = sorted(ms)
    return f"{statistics.median(ms):.6f} [{ms[0]:.6f}, {ms[-1]:.6f}]"


def verdict(fast, slow) -> str:
    """Whether every reading of `fast` is below every one of `slow`."""
    return ("captured faster in every reading" if max(fast) < min(slow) else
            "captured slower in every reading" if min(fast) > max(slow) else
            "the spreads overlap: unresolved")


def chunk_times(torch, name, dec, fr, ll, valid):
    """Phase 19: host ms a decode_chunk call, captured against eager, in
    CAPTURE_ROUNDS rounds of (eager, captured, captured, eager), each
    CAPTURE_REPS calls from the same frontier ended by one synchronize:
    median [min, max]; and the device memory that a chunk program of this
    shape holds (its static tensors, scratch and graph pool) on a fresh
    clone of dec, beside the eager chunk's peak."""
    t0 = time.perf_counter()
    ways = {"eager": dec.decode_chunk_eager, "captured": dec.decode_chunk}
    ways["captured"](fr, ll, valid)  # the program of this shape exists
    ts = {w: [] for w in ways}
    for _ in range(CAPTURE_ROUNDS):
        for w in ("eager", "captured", "captured", "eager"):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            for _ in range(CAPTURE_REPS):
                ways[w](fr, ll, valid)
            torch.cuda.synchronize()
            ts[w].append((time.perf_counter() - t1) / CAPTURE_REPS * 1e3)
    mem = {}
    c = dec.clone_with_max_active(dec.K)  # no program yet
    for w, fn in (("eager", c.decode_chunk_eager), ("captured", c.decode_chunk)):
        torch.cuda.synchronize()
        a0, r0 = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()
        torch.cuda.reset_peak_memory_stats()
        fn(fr, ll, valid)
        torch.cuda.synchronize()
        mem[w] = ((torch.cuda.max_memory_allocated() - a0) / 2**20,
                  (torch.cuda.memory_allocated() - a0) / 2**20,
                  (torch.cuda.memory_reserved() - r0) / 2**20)
    del c
    CAPTURE_SECONDS[f"{name} times"] = time.perf_counter() - t0
    log(f"19 decode_chunk {name} (B={ll.shape[0]} T={ll.shape[1]} K={dec.K} R={dec.R}), host ms "
        f"a call, {CAPTURE_ROUNDS} rounds of (eager, captured, captured, eager) x "
        f"{CAPTURE_REPS} calls: eager {spread(ts['eager'])}, captured "
        f"{spread(ts['captured'])}; {verdict(ts['captured'], ts['eager'])}; device memory "
        f"(MiB: peak over the call, held after it, reserved after it) eager "
        f"{[round(x, 3) for x in mem['eager']]}, first captured call (the capture) "
        f"{[round(x, 3) for x in mem['captured']]} ({SMI})")
    return ts


def am_feature_chunks(torch, ex, rows, samples, seed, n=3):
    """n chained feature chunks [(feats [rows, F, D], valid [rows, F])] of
    seeded noise through the feature extractor `ex` (`samples` a chunk) on
    the card, row 1's last chunk half full (its stream ends there)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    st, out = ex.init_stream_state(rows, samples), []
    for i in range(n):
        audio = (rng.standard_normal((rows, samples)) * 500).astype(np.float32)
        nsamp = np.full(rows, samples, np.int32)
        if i == n - 1:
            nsamp[1] = samples // 2
        st, feats, fv = ex.extract_chunk(st, torch.from_numpy(audio).cuda(),
                                         n_samples=torch.from_numpy(nsamp).cuda())
        out.append((feats, fv))
    return out


def am_run(torch, am, frames, chunks, ivec, process, flush):
    """Every call's {state.*, out, out_valid} from `process` over the chained
    chunks from a fresh state (`frames` chunk frames), then `flush`'s, all
    kept to the end."""
    st, kept = am.init_stream_state(chunks[0][0].shape[0], frames), []
    for chunk in [*chunks, None]:
        st, out, ov = flush(st, ivec) if chunk is None else process(st, *chunk, ivec)
        kept.append({**{f"state.{k}": v for k, v in st.items()}, "out": out, "out_valid": ov})
    torch.cuda.synchronize()
    return kept


def am_captured_vs_eager(torch, name, am, frames, chunks, ivec=None):
    """Phase 19 am: process_chunk and flush (the captured programs of the
    chunks' shape and of the flush's [B, R + ss], captured by the first
    call of a new shape) against process_chunk_eager and the eager flush,
    bit for bit over the chained chunks and the flush: every call's state,
    out and out_valid, all kept to the end, so that a returned tensor a
    later replay overwrote would show.  Every call must replay, the flush
    must emit and every output be finite."""
    from vosk_tpu_torch.models.streaming import GRAPH_COUNTS as AM_COUNTS

    t0 = time.perf_counter()
    r0, c0 = AM_COUNTS["replays"], AM_COUNTS["captures"]
    got = am_run(torch, am, frames, chunks, ivec, am.process_chunk, am.flush)
    replays, captures = AM_COUNTS["replays"] - r0, AM_COUNTS["captures"] - c0
    want = am_run(torch, am, frames, chunks, ivec, am.process_chunk_eager, am._flush_impl)
    for i, (a, b) in enumerate(zip(got, want)):
        for k in b:
            if not torch.equal(bits(torch, a[k]), bits(torch, b[k])):
                raise AssertionError(f"19 am {name}: call {i} {k}: captured != eager")
    if replays != len(chunks) + 1:
        raise AssertionError(f"19 am {name}: {replays} replays for {len(chunks) + 1} calls")
    emitted = [int(k["out_valid"].sum().item()) for k in want]
    if not emitted[-1] or not all(torch.isfinite(k["out"]).all().item() for k in want):
        raise AssertionError(f"19 am {name}: the flush emitted nothing or an output is not "
                             f"finite (frames emitted {emitted})")
    CAPTURE_SECONDS[f"am {name}"] = time.perf_counter() - t0
    B, F, D = chunks[0][0].shape
    log(f"19 am {name}: {type(am).__name__} B={B} F={F} D={D} (flush F="
        f"{am.right_context + am.subsample}), i-vector "
        f"{None if ivec is None else tuple(ivec.shape)}: captured = eager bit for bit (state, "
        f"out, out_valid of {len(chunks)} chained chunks and the flush, kept to the end); "
        f"{replays} replays, {captures} captures; frames emitted {emitted}; "
        f"{CAPTURE_SECONDS[f'am {name}']:.3f} s")


def am_chunk_times(torch, name, am, frames, feats, valid, ivec=None):
    """Phase 19 am: host ms a process_chunk call, captured against eager, in
    CAPTURE_ROUNDS rounds of (eager, captured, captured, eager), each
    CAPTURE_REPS calls from the same state (one chunk in its history) ended
    by one synchronize: median [min, max]; and the device memory that a
    program of this shape holds (its static tensors and graph pool), from
    the first call of a copy of the AM that has no program, beside the eager
    call's peak."""
    import copy

    t0 = time.perf_counter()
    B = feats.shape[0]
    ways = {"eager": am.process_chunk_eager, "captured": am.process_chunk}
    st, _, _ = ways["captured"](am.init_stream_state(B, frames), feats, valid, ivec)
    ts = {w: [] for w in ways}
    for _ in range(CAPTURE_ROUNDS):
        for w in ("eager", "captured", "captured", "eager"):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            for _ in range(CAPTURE_REPS):
                ways[w](st, feats, valid, ivec)
            torch.cuda.synchronize()
            ts[w].append((time.perf_counter() - t1) / CAPTURE_REPS * 1e3)
    fresh = copy.copy(am)  # the same weights; a copy starts with no program
    mem = {}
    for w, fn in (("eager", fresh.process_chunk_eager), ("captured", fresh.process_chunk)):
        torch.cuda.synchronize()
        a0, r0 = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()
        torch.cuda.reset_peak_memory_stats()
        fn(st, feats, valid, ivec)
        torch.cuda.synchronize()
        mem[w] = ((torch.cuda.max_memory_allocated() - a0) / 2**20,
                  (torch.cuda.memory_allocated() - a0) / 2**20,
                  (torch.cuda.memory_reserved() - r0) / 2**20)
    del fresh
    CAPTURE_SECONDS[f"am {name} times"] = time.perf_counter() - t0
    log(f"19 am process_chunk {name} ({type(am).__name__} B={B} F={feats.shape[1]}), host ms a "
        f"call, {CAPTURE_ROUNDS} rounds of (eager, captured, captured, eager) x "
        f"{CAPTURE_REPS} calls: eager {spread(ts['eager'])}, captured "
        f"{spread(ts['captured'])}; {verdict(ts['captured'], ts['eager'])}; device memory "
        f"(MiB: peak over the call, held after it, reserved after it) eager "
        f"{[round(x, 3) for x in mem['eager']]}, first captured call (the capture) "
        f"{[round(x, 3) for x in mem['captured']]} ({SMI})")
    return ts


IVECTOR_DIM = 100  # phase 9's i-vector (run_ivector_common.sh's dim)


def nnet3_ivector_am(bm):
    """Phase 9's AM without its directory (for `--capture-only`): phase 4's
    TDNN-F as nnet3 (tdnnf_to_nnet3) with the i-vector input that
    write_ivector_kaldi_dir grafts (dim 100, seed SEED), on the card."""
    from vosk_tpu_torch.io.kaldi_export import tdnnf_to_nnet3
    from vosk_tpu_torch.models.am import Nnet3Am
    from vosk_tpu_torch.utils.kaldidata import graft_ivector

    m = bm._model
    return Nnet3Am(graft_ivector(tdnnf_to_nnet3(m.am_config, m.am_params), IVECTOR_DIM,
                                 seed=SEED), device="cuda")


def phase_am_nnet3(torch, am, ex, samples, frames):
    """19 am on an nnet3 AM with an i-vector input at the combined
    recognizer step's STEP_ROWS rows: 3 chained chunks of features from
    `ex` and the flush, seeded i-vectors."""
    from vosk_tpu_torch.io.native import STEP_ROWS

    g = torch.Generator().manual_seed(SEED + 13)
    ivec = torch.randn((STEP_ROWS, am.net.nodes[am.ivector_input].dim), generator=g).cuda()
    am_captured_vs_eager(torch, f"nnet3 with i-vectors B={STEP_ROWS}", am, frames,
                         am_feature_chunks(torch, ex, STEP_ROWS, samples, SEED + 13), ivec)


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
    """Features + AM on the card against the same modules on the CPU; then
    phase 19 on the AM (`am_captured_vs_eager`, `am_chunk_times`)."""
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
    # phase 19 on this AM: captured against eager over 3 chained feature
    # chunks and the flush, at B = 32 and at the combined recognizer step's
    # STEP_ROWS rows; chunk times at both
    from vosk_tpu_torch.io.native import STEP_ROWS

    chunks = am_feature_chunks(torch, p.ex, B, p.chunk_samples, SEED + 12)
    rows = [(f[:STEP_ROWS], v[:STEP_ROWS]) for f, v in chunks]
    am_captured_vs_eager(torch, f"bench TDNN-F B={B}", p.am, p.max_feat_frames, chunks)
    am_captured_vs_eager(torch, f"combined step B={STEP_ROWS}", p.am, p.max_feat_frames, rows)
    am_chunk_times(torch, f"B={B}", p.am, p.max_feat_frames, *chunks[1])
    am_chunk_times(torch, f"combined step B={STEP_ROWS}", p.am, p.max_feat_frames, *rows[1])


def phase_decoder(torch, bm):
    """Full-width decoder chunks: the frame-step kernels vs their plain
    versions on the same CUDA tensors vs the CPU (plain) decoder, bit for
    bit; then both kernels on one real frame at B = 32 and at B = 1, under
    load at B = 32, and under load at max-active 10,000."""
    from vosk_tpu_torch.ops import frame_step
    from vosk_tpu_torch.ops.viterbi import BatchViterbi

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
    # phase 19 on this decoder: captured against eager over the light chunks,
    # from the loaded frontier (flat scores keep it at max-active) and at the
    # combined recognizer step's STEP_ROWS rows; chunk times at B = 32 and 4
    from vosk_tpu_torch.io.native import STEP_ROWS

    dchunks = [c.to(dec.device) for c in chunks]
    dvalid = [valid.to(dec.device)] * len(chunks)
    captured_vs_eager(torch, "light chunks", dec, dchunks, dvalid)
    lfr, _ = loaded_frame(torch, bm)
    flat = [(torch.randn((B, T, P), generator=g) * 0.1).to(dec.device) for _ in range(2)]
    captured_vs_eager(torch, "from the loaded frontier", dec, flat, dvalid[:2], fr0=lfr)
    captured_vs_eager(torch, f"combined step B={STEP_ROWS}", dec,
                      [c[:STEP_ROWS] for c in dchunks], [v[:STEP_ROWS] for v in dvalid])
    kfr = {k: v.to(dec.device) for k, v in k_fr.items()}
    chunk_times(torch, "B=32 T=7", dec, kfr, dchunks[2], dvalid[2])
    chunk_times(torch, f"combined step B={STEP_ROWS} T=7", dec,
                {k: v[:STEP_ROWS].contiguous() for k, v in kfr.items()},
                dchunks[2][:STEP_ROWS], dvalid[2][:STEP_ROWS])
    del lfr, flat
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
    ones = torch.ones(B, dtype=torch.bool, device=dec.device)
    times["loaded"] = phase_frame_step(torch, "loaded", dec, fr, ll, ones)
    # max-active 10,000 on the same graph: pass 2 sorts and hashes in
    # global scratch
    d10 = BatchViterbi(dec.graph, dataclasses.replace(dec.params, max_active=10_000),
                       silence_pdfs=dec.silence_pdfs, device=dec.device)
    fr, ll = loaded_frame(torch, bm, dec=d10)
    times["loaded_k10000"] = phase_frame_step(torch, "loaded max-active 10000", d10, fr, ll,
                                              ones)
    return times, profile


def loaded_frame(torch, bm, frames=32, dec=None):
    """A B = 32 frame under load: the frontier after `frames` frames of flat
    seeded scores (N(0, 0.1^2) log-likelihoods: every arc stays within the
    beam, as in speech the model cannot yet tell apart), whose channels
    fill to max-active and keep their whole pool in range, and the chunk
    whose last frame is next; on bm's decoder, or on `dec` (the same
    graph)."""
    dec = dec or bm._pipeline.dec
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
    if need == V4_KERNELS:
        read_replays("the serving path", "serving")
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
    read_replays("the streaming path (combined steps)", "streaming")
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


def bench_inputs(torch, pipe, snr=2.0):
    """bench.py's drive at its operating point for `pipe`: 4 s a channel in
    n chunks of seeded noise [n, B, S] and plausible scores (snr 2.0
    unless asked otherwise) as ll_bias [n, B, T, P], on the card.  Returns
    (n, audio, ll_bias)."""
    import numpy as np

    from vosk_tpu_torch.utils.benchdata import make_plausible_loglikes

    model = pipe.model
    # a Kaldi directory's nnet3 AM has no TDNN-F config: one pdf a phone_of_pdf entry
    P = model.am_config.num_pdfs if model.am_config else len(model.phone_of_pdf)
    S = pipe.chunk_samples
    n_chunks = int(4.0 * model.config.sample_rate) // S
    rng = np.random.default_rng(SEED)
    audio = torch.from_numpy(
        (rng.standard_normal((n_chunks, B, S)) * 500).astype(np.float32)).to(pipe.device)
    lb = make_plausible_loglikes(model.graph, P, B, n_chunks * pipe.T, snr=snr, seed=SEED)
    ll_bias = torch.from_numpy(np.ascontiguousarray(
        lb.reshape(n_chunks, pipe.T, B, P).swapaxes(1, 2))).to(pipe.device)
    return n_chunks, audio, ll_bias


@contextlib.contextmanager
def eager_decode(dec):
    """A context in which dec's decode_chunk is its eager body (phase 19's
    comparisons drive a path both ways)."""
    dec.decode_chunk = dec.decode_chunk_eager
    try:
        yield
    finally:
        del dec.decode_chunk


@contextlib.contextmanager
def eager_am(am):
    """A context in which am's process_chunk (and so its flush) is its
    eager body."""
    am.process_chunk = am.process_chunk_eager
    try:
        yield
    finally:
        del am.process_chunk


def phase_run_scan(torch, bm):
    """bench.py's path at its operating point, B = 32; then phase 19 on it:
    run_scan with decode_chunk eager against captured, interleaved (eager,
    captured, captured, eager) CAPTURE_ROUNDS times (ms a decoded frame,
    median and range, the same best costs), one profiled drive of each
    (`trace_drive`: device busy time and idle share), and decode_chunk's
    chunk times at T = 17; then, the decoder captured in both, the AM's
    process_chunk eager against captured the same way, and its chunk times
    at F = 48."""
    from vosk_tpu_torch.models.streaming import GRAPH_COUNTS as AM_COUNTS
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
    read_replays("run_scan", "run_scan")
    if not torch.isfinite(best_h).all():
        raise AssertionError(f"run_scan best costs are not finite: {best_h}")
    live = torch.isfinite(recs["f_cost"]).sum(-1).float()
    frames = n_chunks * pipe.T
    RUN_SCAN_MS["v4"] = dt / frames * 1e3
    audio_s = n_chunks * B * S / model.config.sample_rate
    log(f"run_scan B={B}, {n_chunks} chunks of 0.48 s ({pipe.T} frames each), records "
        f"{tuple(recs['pm'].shape)}: {dt:.3f} s for {audio_s:.2f} audio-s = "
        f"{audio_s / dt:.3f} audio-s/s, {dt / frames * 1e3:.3f} ms per decoded frame; "
        f"live tokens p50 {live.median().item():.0f} (min {live.min().item():.0f}, "
        f"max {live.max().item():.0f}); {count_line(launches)}")
    del recs

    t19 = time.perf_counter()
    dec = pipe.dec

    def drive(eager):
        state = pipe.init_state()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if eager:
            with eager_decode(dec):
                _, _, b = pipe.run_scan(state, audio, ll_bias=ll_bias)
        else:
            _, _, b = pipe.run_scan(state, audio, ll_bias=ll_bias)
        b = b.cpu()
        return time.perf_counter() - t0, b

    runs = {"eager": [], "captured": []}
    for _ in range(CAPTURE_ROUNDS):
        for way in ("eager", "captured", "captured", "eager"):
            dt, b = drive(way == "eager")
            if not torch.equal(bits(torch, b), bits(torch, best_h)):
                raise AssertionError(f"19 run_scan ({way}): best differs from phase 8's drive")
            runs[way].append(dt / frames * 1e3)
    log(f"19 run_scan B={B}, {n_chunks} chunks x {pipe.T} frames, ms per decoded frame, "
        f"{CAPTURE_ROUNDS} rounds of (eager, captured, captured, eager): eager "
        f"{spread(runs['eager'])} {runs['eager']}, captured {spread(runs['captured'])} "
        f"{runs['captured']}; {verdict(runs['captured'], runs['eager'])}; best bit-equal to "
        f"phase 8's in every drive ({SMI})")
    for way in ("eager", "captured"):
        tr = trace_drive(torch, lambda: drive(way == "eager"))
        med = statistics.median(runs[way]) * frames
        log(f"19 run_scan {way} profiled: span {tr['span_ms']:.3f} ms (unprofiled median "
            f"{med:.3f}), device busy {tr['busy_ms']:.3f} ms (expand_v4 + select_v4 "
            f"{tr['step_ms']:.3f}), idle share {tr['idle']:.4f} of the span and "
            f"{1 - tr['busy_ms'] / med:.4f} of the unprofiled median; {tr['events']} device "
            f"events, the most device time [ms, events]: {json.dumps(tr['top'])} ({SMI})")
    chunk_times(torch, f"run_scan chunk B={B} T={pipe.T}", dec, state["frontier"],
                ll_bias[0], torch.ones((B, pipe.T), dtype=torch.bool, device=dec.device))
    CAPTURE_SECONDS["run_scan"] = time.perf_counter() - t19

    t19 = time.perf_counter()
    am = pipe.am

    def drive_am(eager):
        r0 = AM_COUNTS["replays"]
        with eager_am(am) if eager else contextlib.nullcontext():
            dt, b = drive(False)
        if AM_COUNTS["replays"] - r0 != (0 if eager else n_chunks):
            raise AssertionError(f"19 am run_scan ({'eager' if eager else 'captured'} AM): "
                                 f"{AM_COUNTS['replays'] - r0} AM replays in {n_chunks} chunks")
        return dt, b

    runs = {"eager": [], "captured": []}
    for _ in range(CAPTURE_ROUNDS):
        for way in ("eager", "captured", "captured", "eager"):
            dt, b = drive_am(way == "eager")
            if not torch.equal(bits(torch, b), bits(torch, best_h)):
                raise AssertionError(f"19 am run_scan ({way} AM): best differs from phase 8's "
                                     "drive")
            runs[way].append(dt / frames * 1e3)
    log(f"19 am run_scan B={B}, {n_chunks} chunks x {pipe.T} frames, decoder captured, ms per "
        f"decoded frame, {CAPTURE_ROUNDS} rounds of (eager AM, captured AM, captured AM, eager "
        f"AM): eager AM {spread(runs['eager'])} {runs['eager']}, captured AM "
        f"{spread(runs['captured'])} {runs['captured']}; "
        f"{verdict(runs['captured'], runs['eager'])}; best bit-equal to phase 8's in every "
        f"drive ({SMI})")
    for way in ("eager", "captured"):
        tr = trace_drive(torch, lambda: drive_am(way == "eager"))
        med = statistics.median(runs[way]) * frames
        log(f"19 am run_scan {way} AM profiled: span {tr['span_ms']:.3f} ms (unprofiled median "
            f"{med:.3f}), device busy {tr['busy_ms']:.3f} ms (expand_v4 + select_v4 "
            f"{tr['step_ms']:.3f}), idle share {tr['idle']:.4f} of the span and "
            f"{1 - tr['busy_ms'] / med:.4f} of the unprofiled median; {tr['events']} device "
            f"events, the most device time [ms, events]: {json.dumps(tr['top'])} ({SMI})")
    am_chunks = am_feature_chunks(torch, pipe.ex, B, S, SEED + 14, n=2)
    am_chunk_times(torch, f"run_scan chunk B={B}", am, pipe.F, *am_chunks[1])
    CAPTURE_SECONDS["am run_scan"] = time.perf_counter() - t19
    return launches


# ------------------------------------------------------------------ phase 18

ADAPTIVE_SEG = 4           # bench.py's run_adaptive(seg=4), at the default headroom 0.75
# (b)'s scores: the path's pdf 32 above N(0, 1) noise, so a token on another
# pdf leaves the beam (13) within a frame.  On the 2M-state graph the live
# count still passes the smallest rung after about 1 s: tests/test_adaptive.py's
# snr 8.0 reached 7000 live tokens, snr 32 551 in chunk 1 and 2088 in chunk 2
# (NVIDIA H100 80GB HBM3, 700 W): about 400 arcs share each of the 6008
# pdfs, so same-pdf tokens keep it high whatever the snr
EASY_SNR = 32.0
ADAPTIVE_T = 6             # (c)'s segment: frames of plausible scores at each rung
ADAPTIVE_ROUNDS = 6        # (a)'s interleaved rounds (scan, ladder, ladder, scan)
STEP_MIN_K = 256           # (b)'s step-up ladder: its lower rung is at least this
TRACE_TOP = 8              # (a)'s profiled drives: the device rows listed by time


def segment_rungs(recs):
    """The K of each segment's records (run_adaptive's list)."""
    return [int(r["pm"].shape[-1]) for r in recs]


def live_per_frame(torch, recs):
    """Live tokens of every decoded frame and channel, over a list of
    run_scan-shaped records ([n, T, B, K] planes), as one float tensor."""
    return torch.cat([torch.isfinite(r["f_cost"]).sum(-1).flatten() for r in recs]).float()


def flat_records(recs):
    """A run's records as traceback reads them: one [n * T, B, K|R] dict a
    segment."""
    return [{k: v.reshape(-1, *v.shape[2:]) for k, v in r.items()} for r in recs]


def silent_am(torch, nm):
    """A shallow copy of native model nm with its AM's output matrix zeroed:
    the AM's scores are then its output bias, exactly, whatever order a
    BLAS sums its products in."""
    import copy

    w = nm.am_params["output_w"]
    out = copy.copy(nm)
    out.am_params = {**nm.am_params, "output_w": torch.zeros_like(torch.as_tensor(w))}
    return out


def ladder_rung(decs, live) -> int:
    """The rung (a K) run_adaptive takes for `live` tokens over its decoders."""
    from vosk_tpu_torch.runtime.pipeline import ADAPTIVE_HEADROOM

    return next((d.K for d in decs if live <= ADAPTIVE_HEADROOM * d.K), decs[-1].K)


def step_ladder(need, ends, rungs):
    """(k0, k1) for (b): a seg-1 run_adaptive drive that starts at k0 keeps
    every frame of chunks 0..j within k0 (need: the most winners, and
    in-range candidates over DEDUP_SLACK, a chunk), stays there while the
    live count at a chunk's end (ends) is within the headroom, steps up
    after chunk j and decodes chunk j + 1 within k1, the smallest of rungs
    that takes it; None where no chunk j allows that."""
    from vosk_tpu_torch.runtime.pipeline import ADAPTIVE_HEADROOM as h

    for j in range(len(need) - 1):
        k0 = max(need[:j + 1])
        if k0 < STEP_MIN_K or any(n > h * k0 for n in ends[:j]) or ends[j] <= h * k0:
            continue
        k1 = next((k for k in rungs if k > k0 and k >= need[j + 1] and ends[j] <= h * k), None)
        if k1 is not None:
            return (k0, k1)
    return None


def trace_drive(torch, fn):
    """fn() under torch.profiler: the span of the call on the host, the
    device's busy time in it (the union of its device events), the share of
    the span the device was idle, the expand_v4 + select_v4 kernels' device
    time, in ms, and the TRACE_TOP device rows that took the most time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        span_us = (time.perf_counter() - t0) * 1e6
    evs = prof.events()
    dev = sorted((ev.time_range.start, ev.time_range.end) for ev in evs
                 if ev.device_type == torch.autograd.DeviceType.CUDA)
    if not dev:
        raise AssertionError("the profiler recorded no device event")
    busy, end = 0.0, -math.inf
    for a, b in dev:  # the union of the device intervals
        a = max(a, end)
        if b > a:
            busy += b - a
        end = max(end, b)
    rows = {}  # device time and count by event name
    for ev in evs:
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            us, n = rows.get(ev.name, (0.0, 0))
            rows[ev.name] = (us + ev.time_range.elapsed_us(), n + 1)
    step = sum(us for k, (us, _) in rows.items() if "expand_v4" in k or "select_v4" in k)
    top = sorted(rows.items(), key=lambda kv: -kv[1][0])[:TRACE_TOP]
    return {"span_ms": span_us / 1e3, "busy_ms": busy / 1e3, "idle": 1 - busy / span_us,
            "step_ms": step / 1e3, "events": len(dev),
            "top": {k[:60]: [round(us / 1e3, 3), n] for k, (us, n) in top}}


def frontier_sorted(torch, fr) -> bool:
    c = fr["cost"]
    return bool((c[:, 1:] >= c[:, :-1]).all())


def phase_adaptive(torch, bm):
    """Phase 18: FusedPipeline.run_adaptive (the ladder 1024 / 2048 / 4096 /
    7000, seg 4, headroom 0.75) at phase 8's point.  (a) run_adaptive
    against run_scan, interleaved from a fresh state (scan, ladder, ladder,
    scan) ADAPTIVE_ROUNDS times, counts zeroed just before each ladder
    drive: ms per decoded frame (median, least and most), audio-s/s, each
    segment's rung, live tokens p50 and max, and a verdict that reads
    "unresolved" where the two spreads overlap; then one drive of each
    under torch.profiler (`trace_drive`: device busy time and idle share);
    (b) easy scores (snr EASY_SNR), seg 1, over the leading chunks (at
    least 2) in which every frame of the ladder drive fits its rung
    (select_v4's stats: in-range candidates <= K2 and winners <= K, so the
    rung keeps what K = 7000 keeps): best bit-equal to run_scan's and 32
    tracebacks equal, on bench.py's ladder and on a ladder (k0, k1) cut
    from a fixed-K drive's stats (`step_ladder`) whose exact chunks step
    up from k0 to k1; (c) one segment of ADAPTIVE_T    tracebacks equal; (c) one segment of ADAPTIVE_T
    frames at each rung below 7000 (plausible scores, from phase 4's loaded
    frontier cut to the rung) with the kernels, their plain versions on the
    same CUDA tensors (set on the rung's own decoder) and the CPU: frontier
    and all five record planes bit-equal, frontier slots sorted by cost;
    (d) both kernels against their plain versions at each rung on a real
    frame (the rung's fresh frontier after ADAPTIVE_T - 1 frames of those
    scores) and under load (phase 4's `loaded_frame` at the rung), with
    phase 4's `phase_frame_step`.  Returns (run_adaptive's
    launches, {f"k{K}" or f"k{K}_loaded": kernel times})."""
    from vosk_tpu_torch.ops import frame_step
    from vosk_tpu_torch.ops.viterbi import DEDUP_SLACK
    from vosk_tpu_torch.runtime.pipeline import FusedPipeline

    t_phase = time.perf_counter()
    model = bm._model
    P = model.am_config.num_pdfs
    pipe = FusedPipeline(model, batch=B, chunk_seconds=0.48)
    n_chunks, audio, ll_bias = bench_inputs(torch, pipe)
    frames = n_chunks * pipe.T
    audio_s = n_chunks * B * pipe.chunk_samples / model.config.sample_rate

    def drive(adaptive, lb=ll_bias):
        state = pipe.init_state()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if adaptive:
            st, recs, best = pipe.run_adaptive(state, audio, ll_bias=lb, seg=ADAPTIVE_SEG)
        else:
            st, recs, best = pipe.run_scan(state, audio, ll_bias=lb)
            recs = [recs]
        best = best.cpu()
        return time.perf_counter() - t0, st, recs, best

    drive(False)
    drive(True)  # warm-up: the rung decoders built, their scratch grown
    decs = pipe._adaptive_decs
    log(f"18 ladder decoders (B={B}, M={pipe.dec.M}): " + "; ".join(
        f"K={d.K} E={d.E} K2={d.K2} R={d.R} pass 2 in "
        f"{'global' if frame_step.select_in_global(d.E, d.K, d.K2, d.R) else 'shared'} memory"
        for d in decs))
    runs, launches, seen = {"run_scan": [], "run_adaptive": []}, None, {}
    for _ in range(ADAPTIVE_ROUNDS):
        for adaptive in (False, True, True, False):
            if adaptive:
                zero_counts()  # every kernel count, just before the ladder's drive
            dt, st, recs, best = drive(adaptive)
            if adaptive:
                counts = read_counts("run_adaptive")
                launches = launches or counts
                if counts["expand_v4"] != frames or counts["select_v4"] != frames:
                    raise AssertionError(f"run_adaptive launched {counts} over {frames} frames")
                if read_replays("run_adaptive", "run_adaptive") != n_chunks:
                    raise AssertionError(f"run_adaptive replayed {REPLAYS} over {n_chunks} "
                                         f"chunks")
            if not torch.isfinite(best).all():
                raise AssertionError(f"run_adaptive={adaptive}: best costs are not finite")
            name = "run_adaptive" if adaptive else "run_scan"
            runs[name].append(dt / frames * 1e3)
            live = live_per_frame(torch, recs)
            drive_id = (segment_rungs(recs), live.median().item(), live.max().item())
            if seen.setdefault(name, drive_id) != drive_id:
                raise AssertionError(f"18a {name}: a drive took {drive_id}, the first "
                                     f"{seen[name]}")
            del st, recs, best
    for name, (rungs, p50, top) in seen.items():
        ms = sorted(runs[name])
        log(f"18a {name} B={B}, {n_chunks} chunks x {pipe.T} frames, {len(ms)} drives: "
            f"median {statistics.median(ms):.6f} ms per decoded frame [{ms[0]:.6f}, "
            f"{ms[-1]:.6f}], {audio_s / (statistics.median(ms) * frames / 1e3):.3f} audio-s/s; "
            f"rungs {rungs}; live tokens p50 {p50:.0f} max {top:.0f} ({SMI})")
    sa, sf = sorted(runs["run_adaptive"]), sorted(runs["run_scan"])
    verdict = ("run_adaptive faster in every drive" if sa[-1] < sf[0] else
               "run_adaptive slower in every drive" if sa[0] > sf[-1] else
               "the spreads overlap: unresolved")
    log(f"18a ms per decoded frame, interleaved (scan, ladder, ladder, scan) x "
        f"{ADAPTIVE_ROUNDS}: run_scan {runs['run_scan']}, run_adaptive {runs['run_adaptive']}; "
        f"{verdict} (phase 8: {RUN_SCAN_MS.get('v4', float('nan')):.3f})")
    # one drive of each under torch.profiler: the device's busy time and idle
    # share of the drive's span
    for adaptive in (False, True):
        tr = trace_drive(torch, lambda: drive(adaptive))
        name = "run_adaptive" if adaptive else "run_scan"
        med = statistics.median(runs[name])
        log(f"18a {name} profiled: span {tr['span_ms']:.3f} ms (unprofiled median "
            f"{med * frames:.3f}), device busy {tr['busy_ms']:.3f} ms (expand_v4 + select_v4 "
            f"{tr['step_ms']:.3f}), idle share {tr['idle']:.4f} of the span and "
            f"{1 - tr['busy_ms'] / (med * frames):.4f} of the unprofiled median; "
            f"{tr['events']} device events, the most device time [ms, events]: "
            f"{json.dumps(tr['top'])} ({SMI})")

    # (b) the easy case: the ladder must decode exactly as the fixed K.  A
    # frame at rung K is exact when its in-range candidates fit the dedup cut
    # K2 and its winners fit K (select_v4's stats).  First on bench.py's
    # ladder, then on a ladder (k0, k1) cut from a fixed-K drive's stats so
    # that the drive steps from k0 up to k1 while every frame is exact
    _, _, easy = bench_inputs(torch, pipe, snr=EASY_SNR)
    frame_stats = []

    def with_stats(d):
        select = d.step_ops.select

        def counted(*a, **k):
            st = torch.zeros((B, 3), dtype=torch.int32, device=d.device)
            out = select(*a, **k, stats=st)
            frame_stats.append((d.K, d.K2, st))
            return out
        return frame_step.StepOps(d.step_ops.expand, counted)

    def stats_drive(ds, fn):
        """fn() with select_v4's stats kept for every frame of decoders ds:
        (fn's result, [(K, K2, stats [B, 3])] a frame)."""
        frame_stats.clear()
        for d in ds:
            d.step_ops = with_stats(d)
        try:
            return fn(), list(frame_stats)
        finally:
            for d in ds:
                d.step_ops = frame_step.KERNELS

    def per_chunk(stats, col):
        return [max(int(st[:, col].max()) for _, _, st in stats[i * pipe.T:(i + 1) * pipe.T])
                for i in range(n_chunks)]

    def easy_case(label):
        """Hold run_adaptive (seg 1, the pipeline's ladder) to run_scan bit for
        bit over the leading chunks whose every frame fits its rung; returns
        the rungs of those chunks."""
        pipe._adaptive_decs = None  # the ladder's decoders, built by a one-chunk drive
        pipe.run_adaptive(pipe.init_state(), audio[:1], ll_bias=easy[:1], seg=1)
        (_, srecs, _), stats = stats_drive(
            pipe._adaptive_decs,
            lambda: pipe.run_adaptive(pipe.init_state(), audio, ll_bias=easy, seg=1))
        exact = [bool((st[:, 1] <= K2).all() and (st[:, 2] <= K).all()) for K, K2, st in stats]
        chunk_exact = [all(exact[i * pipe.T:(i + 1) * pipe.T]) for i in range(n_chunks)]
        n_easy = next((i for i, x in enumerate(chunk_exact) if not x), n_chunks)
        log(f"18b {label}, snr {EASY_SNR}, seg 1: rungs {segment_rungs(srecs)}, the most "
            f"in-range candidates a chunk {per_chunk(stats, 1)}; chunks whose every frame fits "
            f"its rung's cut K2 and winners K: {chunk_exact}; the easy case is the first {n_easy}")
        del srecs
        if n_easy < 2:
            raise AssertionError(f"18b {label}: fewer than 2 leading chunks decode exactly")
        ea, el = audio[:n_easy], easy[:n_easy]
        en = torch.full((n_easy, B), audio.shape[2], dtype=torch.int32)
        fst, frecs, fbest = pipe.run_scan(pipe.init_state(), ea, en, ll_bias=el)
        ast, arecs, abest = pipe.run_adaptive(pipe.init_state(), ea, en, ll_bias=el, seg=1)
        same(torch, abest, fbest, f"18b {label}: run_adaptive best against run_scan's")
        ftb = [dec.traceback(flat_records([frecs]), fst["frontier"], b) for b in range(B)]
        atb = [dec.traceback(flat_records(arecs), ast["frontier"], b) for b in range(B)]
        if atb != ftb:
            raise AssertionError(f"18b {label}: a traceback of run_adaptive differs from "
                                 f"run_scan's")
        rungs = segment_rungs(arecs)
        log(f"18b {label}, {n_easy} chunks, seg 1: rungs {rungs}; best bit-equal to "
            f"run_scan's, {B} tracebacks equal ({sum(len(t[1]) for t in atb)} words)")
        return rungs

    dec = pipe.dec
    easy_case("bench.py's ladder")
    # the step-up ladder, from a fixed-K drive of the same scores: each chunk's
    # need (winners, and in-range candidates over DEDUP_SLACK) and end live
    (_, frecs, _), stats = stats_drive(
        [dec], lambda: pipe.run_scan(pipe.init_state(), audio, ll_bias=easy))
    need = [max(w, math.ceil(c / DEDUP_SLACK))
            for w, c in zip(per_chunk(stats, 2), per_chunk(stats, 1))]
    ends = [int(torch.isfinite(frecs["f_cost"][i, -1]).sum(-1).max()) for i in range(n_chunks)]
    del frecs, stats
    ladder = step_ladder(need, ends, pipe.adaptive_ladder)
    log(f"18b run_scan at K={dec.K}, snr {EASY_SNR}: need a chunk {need}, live at its end "
        f"{ends}; the step-up ladder {ladder}")
    if ladder is None:
        raise AssertionError("18b: no ladder steps up while every frame stays exact")
    saved = pipe.adaptive_ladder
    pipe.adaptive_ladder = ladder
    try:
        rungs = easy_case(f"the ladder {ladder}")
    finally:
        pipe.adaptive_ladder, pipe._adaptive_decs = saved, decs
    if not any(a < b for a, b in zip(rungs, rungs[1:])):
        raise AssertionError(f"18b: the exact chunks' rungs {rungs} never step up")
    del easy

    # (c) one segment at each rung, three ways; (d) the kernels at its shapes
    cpu_dec = dec.to("cpu")
    lfr, _ = loaded_frame(torch, bm)
    chunks, valid = plausible_chunks(torch, model.graph, P, (ADAPTIVE_T,), SEED + 18)
    ll, valid = chunks[0].to(dec.device), valid.to(dec.device)
    ones = torch.ones(B, dtype=torch.bool, device=dec.device)
    times = {}
    for d in decs[:-1]:
        fr0 = dec.resize_frontier(lfr, d.K)
        outs = {}
        for way, ops, dd in (("kernels", frame_step.KERNELS, d), ("plain", frame_step.PLAIN, d),
                             ("CPU", frame_step.KERNELS, cpu_dec.clone_with_max_active(d.K))):
            dd.step_ops = ops
            try:
                f, r, _, _ = dd.decode_chunk({k: v.to(dd.device) for k, v in fr0.items()},
                                             ll.to(dd.device), valid.to(dd.device))
            finally:
                dd.step_ops = frame_step.KERNELS
            outs[way] = ({k: v.cpu() for k, v in f.items()}, {k: v.cpu() for k, v in r.items()})
        for way in ("plain", "CPU"):
            same(torch, outs[way][0], outs["kernels"][0], f"18c K={d.K} frontier, kernels vs {way}")
            same(torch, outs[way][1], outs["kernels"][1], f"18c K={d.K} records, kernels vs {way}")
        if not frontier_sorted(torch, outs["kernels"][0]):
            raise AssertionError(f"18c K={d.K}: select_v4 left the frontier unsorted")
        live = torch.isfinite(outs["kernels"][0]["cost"]).sum(1)
        log(f"18c rung K={d.K}: {ADAPTIVE_T} frames from the loaded frontier cut to the rung "
            f"(live after {live.min().item()}-{live.max().item()}): frontier and 5 record "
            f"planes bit-equal kernels / plain / CPU, slots sorted by cost")
        captured_vs_eager(torch, f"rung K={d.K} from the loaded frontier", d, [ll, ll],
                          [valid, valid], fr0={k: v.to(d.device) for k, v in fr0.items()})
        if d.K == 1024:
            chunk_times(torch, f"rung K={d.K}", d,
                        {k: v.to(d.device) for k, v in outs["kernels"][0].items()}, ll, valid)
        # a real frame: the rung's fresh frontier after ADAPTIVE_T - 1 frames
        fr, _, _, _ = d.decode_chunk(d.init_frontier(B), ll[:, :ADAPTIVE_T - 1],
                                     valid[:, :ADAPTIVE_T - 1])
        times[f"k{d.K}"] = phase_frame_step(torch, f"rung {d.K}", d, fr, ll, valid[:, -1])
        fr, lll = loaded_frame(torch, bm, dec=d)
        if not frontier_sorted(torch, fr):
            raise AssertionError(f"18d K={d.K}: the loaded frontier is not sorted by cost")
        times[f"k{d.K}_loaded"] = phase_frame_step(torch, f"rung {d.K} loaded", d, fr, lll, ones)
    del cpu_dec
    log(f"phase 18 (the adaptive ladder) took {time.perf_counter() - t_phase:.3f} s ({SMI})")
    return launches, times


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
    """One v3 decode_chunk at B = 32 under torch.profiler, in
    PROFILE_WINDOWS windows (`most_seen`): device kernels by name,
    launches and device us per frame; the sort kernels' share."""
    from torch.profiler import ProfilerActivity, profile

    T = chunks[0].shape[1]
    fr = dec.init_frontier(B)
    ll, v = chunks[0].to(dec.device), valid.to(dec.device)
    dec.decode_chunk(fr, ll, v)  # warm-up
    torch.cuda.synchronize()
    windows = []
    for _ in range(PROFILE_WINDOWS):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            dec.decode_chunk(fr, ll, v)
            torch.cuda.synchronize()
        windows.append(frame_kernels(torch, prof, T))
    rows, varied = most_seen(windows)
    total = sum(us for _, us in rows.values())
    sort_us = sum(us for k, (_, us) in rows.items() if "sort" in k.lower())
    gather = {k: c for k, (c, _) in rows.items() if "gather_rows" in k}
    top = sorted(rows.items(), key=lambda kv: -kv[1][1])[:12]
    log(f"profiled v3 decode_chunk B={B} T={T}: {sum(c for c, _ in rows.values()):.1f} "
        f"device events and {total:.3f} us of device rows a frame; sort kernels "
        f"{sort_us:.3f} us a frame ({sort_us / total:.1%}); gather_rows launches a frame "
        f"{json.dumps(gather)}; rows whose launches a frame varied over {PROFILE_WINDOWS} "
        f"windows {json.dumps({k[:60]: v for k, v in varied.items()})}; largest rows "
        f"(launches, us a frame): " + json.dumps({k[:60]: v for k, v in top}))
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
    RUN_SCAN_MS["v3"] = dt / frames * 1e3
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
    torch.save(dec.to("cpu"), Path(tmp) / V3_DECODER)  # for phase 17 (b)
    del pipe, dec, chunks
    gc.collect()
    launches["v3_auto"], launches["v3_auto_batch"] = phase_v3_auto(torch, bm, tmp)
    times, err = phase_kernel(torch, torch.device("cuda"), cases=shapes)
    return launches, times, err, profile


def phase_kaldi(torch, tmp):
    """Phase 9: the full-width Kaldi directory with i-vectors, streaming;
    then batch (and 17e) on the same AM exported without the graft over a
    graph of RESCORE_STATES states, as phase 12 (b) serves (a second load
    of the 2M-state HCLG took 86-91 s of the run).  Returns (streaming
    launches, batch launches, kernel shapes of the path, 17e's launches)."""
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
    phase_am_nnet3(torch, am, r.ex, r.chunk_samples, r.max_feat_frames)  # phase 19
    shapes = (dec.K * dec.M, dec.K)
    del model, nm, am, dec, r, t  # the batch phase's peak memory is its own
    gc.collect()

    t0 = time.perf_counter()
    m = benchdata.make_bench_model(num_states=RESCORE_STATES, seed=SEED, device="cpu")
    kaldidata.one_phone_per_pdf(m)
    small = Path(tmp) / "kaldi_batch"
    export_kaldi_dir(m, small)
    del m
    t_export = time.perf_counter() - t0
    t0 = time.perf_counter()
    bm = vosk_tpu_torch.BatchModel(str(small), max_batch_size=B, device="cuda")
    torch.cuda.synchronize()
    log(f"kaldi batch: export (nnet3 + {RESCORE_STATES}-state HCLG.fst) {t_export:.3f} s; "
        f"BatchModel load (no i-vector graft) {time.perf_counter() - t0:.3f} s")
    batch_launches = phase_serving(torch, bm)
    mesh_launches = phase_mesh_nnet3(torch, bm, tmp)
    del bm
    return launches, batch_launches, shapes, mesh_launches


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
    captured_vs_eager(torch, "exact3 B=1", dec, *seeded_chunks(torch, dec, 1, EXACT3_PDFS,
                                                                SEED + 19))
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
    captured_vs_eager(torch, "exact3 B=32 from the loaded frontier", bdec,
                      *seeded_chunks(torch, bdec, B, EXACT3_PDFS, SEED + 20, scale=0.1), fr0=fr)
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


def record_bytes(records) -> int:
    """Bytes of device storage a recognizer's retained records hold."""
    return sum(v.untyped_storage().nbytes() for r in records for v in r.values())


def phase_rows(torch, model, chunks=3):
    """Phase 14 (b0): STEP_ROWS recognizers of `model` (distinct noise) step
    `chunks` 0.2 s chunks, the AM's flush and `chunks` more together through
    combined_step, and as many more each alone: features, ll, their masks,
    frontier rows and record rows must be bit-equal, the host values equal,
    and the retained record bytes equal.  Then, for the record, why steps
    are padded: n = 2 .. STEP_ROWS fresh streams step `chunks` chunks at n
    rows with no padding, each against its stream alone at 1 row, and the
    rows whose features or ll differ are counted (no bound).  Returns the
    number of rows compared."""
    import numpy as np

    import vosk_tpu_torch
    from vosk_tpu_torch.runtime import recognizer as R

    n = R.STEP_ROWS

    def recs(k):
        return [vosk_tpu_torch.KaldiRecognizer(model, 16000)._rec for _ in range(k)]

    together, alone = recs(n), recs(n)
    S = together[0].chunk_samples
    waves = [np.frombuffer(noise_pcm(2 * chunks * 0.2, 16000, SEED + 50 + i), "<i2")
             .astype(np.float32) for i in range(n)]
    compared = 0
    for c in range(2 * chunks + 1):
        flush = c == chunks

        def part(r, i):
            return R._Part(r) if flush else R._Part(r, waves[i][(c - (c > chunks)) * S:][:S], S)

        parts = [part(r, i) for i, r in enumerate(together)]
        got = R.combined_step(parts)
        for i, (r, p) in enumerate(zip(together, parts)):
            q = part(alone[i], i)
            want = R.combined_step([q])
            for k in ("feats", "fvalid", "ll", "lvalid"):
                if got[k] is not None and not torch.equal(bits(torch, got[k][i]),
                                                          bits(torch, want[k][0])):
                    raise AssertionError(f"(b0) chunk {c}: row {i}'s {k} differs from its "
                                         f"stream's alone")
            for k in got["frontier"]:
                if not torch.equal(bits(torch, got["frontier"][k][i]),
                                   bits(torch, want["frontier"][k][0])):
                    raise AssertionError(f"(b0) chunk {c}: row {i}'s frontier {k} differs")
            for k in p.records:
                if not torch.equal(bits(torch, p.records[k]), bits(torch, q.records[k])):
                    raise AssertionError(f"(b0) chunk {c}: row {i}'s records {k} differ")
            if not np.array_equal(p.head, q.head):
                raise AssertionError(f"(b0) chunk {c}: row {i}'s host values differ")
            r._take(p)
            alone[i]._take(q)
            compared += 1
    kept = [record_bytes(r._records) for r in together]
    if kept != [record_bytes(r._records) for r in alone]:
        raise AssertionError("(b0) a stream stepped with others retains other record bytes "
                             "than alone")
    unpadded = {}
    try:
        for k in range(2, n + 1):
            together, alone = recs(k), recs(k)
            rows = differ = 0
            worst = {"feats": 0.0, "ll": 0.0}
            for c in range(chunks):
                parts = [R._Part(r, waves[i][c * S:][:S], S) for i, r in enumerate(together)]
                R.STEP_ROWS = k
                got = R.combined_step(parts)
                for i, p in enumerate(parts):
                    q = R._Part(alone[i], waves[i][c * S:][:S], S)
                    R.STEP_ROWS = 1
                    want = R.combined_step([q])
                    diff = {f: float((got[f][i].float() - want[f][0].float()).abs().max())
                            for f in worst}
                    rows += 1
                    differ += any(v > 0 for v in diff.values())
                    worst = {f: max(worst[f], diff[f]) for f in worst}
                    together[i]._take(p)
                    alone[i]._take(q)
            unpadded[k] = dict(rows=rows, rows_differing=differ, max_abs_feats=worst["feats"],
                               max_abs_ll=worst["ll"])
    finally:
        R.STEP_ROWS = n
    log(f"combined steps (b0): {n} streams x {2 * chunks} chunks and the AM's flush, "
        f"{n} rows a step: features, ll, frontier, records and host values "
        f"bit-equal to each stream's own steps ({compared} rows); retained record bytes "
        f"{kept[0]} a stream either way; unpadded, n streams at n rows against each alone "
        f"at 1 row (why steps are padded): {json.dumps(unpadded)}")
    return compared


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

    sizes = dict(model._model.combiner.sizes)
    zero_counts()  # every kernel count, just before the path
    t0 = time.perf_counter()
    finals = asyncio.run(all_clients())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts("the websocket server")
    steps = {k: v - sizes.get(k, 0) for k, v in model._model.combiner.sizes.items()}
    for i, (final, pcm) in enumerate(zip(finals, pcms)):
        want = direct_results(model, pcm, 8000)[-1]
        if final != want:
            raise AssertionError(f"client {i}: the server's final {final} != the direct "
                                 f"recognizer's {want}")
    r = np.array(rtts)
    log(f"server: {clients} concurrent clients x {REQUEST_SECONDS} s in 8000-byte chunks, "
        f"words on: {len(r)} chunk round trips p50 {np.median(r) * 1e3:.3f} ms max "
        f"{r.max() * 1e3:.3f} ms; wall {wall:.3f} s; the recognizers' "
        f"{step_rows_line(steps)}; every final equals the direct "
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
# daemon thread writes the port's kernel counts, and the number of steps by
# rows that threads other than the main one led (test_vosk_mt.c's 4
# threads; its single-thread baseline runs in the main thread), to
# $VT_COUNTS_OUT every 0.1 s, since the programs never finalize the
# interpreter.  With VT_WARM set, each Model decodes 1 s of noise once it
# is loaded (the shared decoder's build, the first launches), so that
# test_vosk_mt.c's single-thread baseline times decoding alone; the counts
# written leave that decode out.  With VT_ONE_AT_A_TIME set, the models'
# combiners step one stream at a time.
COUNTS_PROBE = '''
import json, os, sys, threading, time

_warm = {}
_rows = {}


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
        counts["step_rows"] = dict(_rows)
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


def _counted(step):
    def run(parts):
        if threading.current_thread() is not threading.main_thread():
            _rows[len(parts)] = _rows.get(len(parts), 0) + 1
        return step(parts)
    return run


from vosk_tpu_torch.io import native
from vosk_tpu_torch.runtime import recognizer

recognizer.combined_step = _counted(recognizer.combined_step)
if os.environ.get("VT_ONE_AT_A_TIME"):
    native.StepCombiner.rows = 1
if os.environ.get("VT_WARM"):
    import vosk_tpu_torch

    vosk_tpu_torch.Model.__init__ = _warmed(vosk_tpu_torch.Model.__init__)
threading.Thread(target=_watch, args=(os.environ["VT_COUNTS_OUT"],), daemon=True).start()
'''


def step_rows_line(rows) -> str:
    """'N steps (n with more than one row), mean rows m' of a {rows: steps}
    count."""
    rows = {int(k): v for k, v in rows.items()}
    n = sum(rows.values())
    mean = sum(k * v for k, v in rows.items()) / n if n else 0.0
    return (f"{n} steps ({sum(v for k, v in rows.items() if k > 1)} with more than one "
            f"row), mean rows {mean:.3f}, by rows {json.dumps(dict(sorted(rows.items())))}")


def phase_cabi(torch, tmp, model, model_dir, wav, pcm, mt_runs=1):
    """Phase 14 (d): build libvosk_tpu_torch.so, compile core/test/test_vosk.c
    and test_vosk_mt.c (4 threads) against it into the build directory, and
    run both on the 10 s WAV (its samples `pcm`) with phase 4's dir (its
    files linked into a dir of their own whose words.txt gains the word
    "one", which test_vosk.c looks up and no arc of the graph outputs),
    VOSK_TPU_TORCH_DEVICE unset (the card).  Both must exit 0 and print what
    a direct KaldiRecognizer on `model` returns for the same calls;
    test_vosk_mt.c runs `mt_runs` times, each of which must pass its own
    x1.5 scaling floor, its Model warmed by one decode before the
    single-thread baseline, and once more with the model's combiner
    stepping one stream at a time (no floor).  The steps its 4 threads took
    are printed by rows, and each program's kernel counts (read by
    COUNTS_PROBE in its process) must show both frame-step kernels.
    Returns {program: launches}."""
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
        if f.name != "words.txt" and not (cdir / f.name).exists():
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
    env.pop("VOSK_MT_MIN_SCALING", None)
    env["PYTHONPATH"] = os.pathsep.join([str(probe), str(ROOT), *sorted(sites)] + (
        [env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    want = {"test_vosk": direct_results(model, pcm, 3200),
            "test_vosk_mt": direct_results(model, pcm, 3200, endpoints=False)[-1:]}
    runs = [("test_vosk", "test_vosk", [], {})] + [
        ("test_vosk_mt" + (f"_{i + 1}" if i else ""), "test_vosk_mt", ["4"], {"VT_WARM": "1"})
        for i in range(mt_runs)] + [
        # for comparison, without combining (no floor)
        ("test_vosk_mt_one_at_a_time", "test_vosk_mt", ["4"],
         {"VT_WARM": "1", "VT_ONE_AT_A_TIME": "1", "VOSK_MT_MIN_SCALING": "0"})]
    launches, walls, notes, rows, failed = {}, {}, {}, {}, []
    for key, prog, argv, extra in runs:
        counts = Path(tmp) / f"{key}.counts.json"
        t0 = time.perf_counter()
        proc = subprocess.run([str(bdir / prog), str(cdir), str(wav), *argv],
                              env={**env, "VT_COUNTS_OUT": str(counts), **extra},
                              capture_output=True, text=True, timeout=600)
        walls[key] = time.perf_counter() - t0
        if proc.returncode != 0:
            # raised after the line below, which prints every run's numbers
            failed.append(f"{key} exited {proc.returncode}:\n{proc.stdout[-2000:]}\n"
                          f"{proc.stderr[-4000:]}")
            if "THROUGHPUT" not in proc.stdout:
                break
        if prog == "test_vosk":
            got = [x for x in proc.stdout.splitlines() if x.startswith("{")]
        else:
            got = [proc.stdout.split("RESULT ", 1)[1].splitlines()[0]]
            notes[key] = proc.stdout.strip().splitlines()[-1]
        if got != want[prog]:
            raise AssertionError(f"{key} printed {got[-1]} where the direct recognizer "
                                 f"gives {want[prog][-1]}")
        launches[key] = json.loads(counts.read_text()) if counts.exists() else {}
        rows[key] = launches[key].pop("step_rows", {})
        if any(launches[key].get(k, 0) <= 0 for k in V4_KERNELS):
            raise AssertionError(f"{key} did not launch the frame-step kernels: "
                                 f"{launches[key]}")
    mt = [f"{k} wall {walls[k]:.3f} s ({notes[k]}); its 4 threads' steps: "
          f"{step_rows_line(rows[k])}" for k in notes]
    log(f"C ABI: libvosk_tpu_torch.so built in {t_lib:.3f} s ({lib}), test programs compiled "
        f"in {t_gcc:.3f} s; test_vosk wall {walls.get('test_vosk', 0):.3f} s; "
        + "; ".join(mt) + f"; counts in their processes {json.dumps(launches)}")
    if failed:
        raise AssertionError("\n".join(failed))
    log(f"C ABI: test_vosk_mt passed its own x1.5 floor ({mt_runs} of {mt_runs} runs); all "
        f"print the direct recognizer's "
        f"results (text {json.loads(want['test_vosk'][-1])['text'][:40]!r})")
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


# ------------------------------------------------------------------ phase 16

CSR_HUBS, CSR_HUB_DEGREE = 100_000, 40  # phase 16 (c)'s synthetic eps hubs
RUN_SCAN_MS = {}  # phase 8's and 11's ms a decoded frame, beside phase 16 (a)'s
SMI = ""  # the card's name and power limit, beside phase 16's numbers


def records_equal(torch, a, b, what):
    """Raise unless two decodes' per-chunk outputs are bit-equal."""
    for i, (x, y) in enumerate(zip(a, b)):
        for k in x:
            if not torch.equal(bits(torch, x[k]), bits(torch, y[k])):
                raise AssertionError(f"{what}: chunk {i} {k} differs")


def decode_chunks(torch, dec, chunks, valid):
    """Chunks of [B, T, P] scores through dec on its device from its initial
    frontier: per chunk the frontier, the records and the best costs on the
    host, and the host seconds of each decode_chunk."""
    fr, outs, secs = dec.init_frontier(valid.shape[0]), [], []
    for ll in chunks:
        v = valid[:, :ll.shape[1]].to(dec.device)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fr, rec, best, bestf = dec.decode_chunk(fr, ll.to(dec.device), v)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        outs.append({**{f"frontier.{k}": x.cpu() for k, x in fr.items()},
                     **{k: x.cpu() for k, x in rec.items()},
                     "best": best.cpu(), "best_final": bestf.cpu()})
    return outs, secs


def profile_decode(torch, dec, ll, valid):
    """One decode_chunk under torch.profiler after a warm-up: (device events
    a frame, device us a frame, the largest rows by device time)."""
    from torch.profiler import ProfilerActivity, profile

    T = ll.shape[1]
    fr = dec.init_frontier(ll.shape[0])
    ll, v = ll.to(dec.device), valid.to(dec.device)
    dec.decode_chunk(fr, ll, v)
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
    top = sorted(rows.items(), key=lambda kv: -kv[1][1])[:8]
    return (sum(c for c, _ in rows.values()) / T, sum(us for _, us in rows.values()) / T,
            {k[:60]: [c / T, round(us / T, 3)] for k, (c, us) in top})


def plausible_chunks(torch, graph, P, lengths, seed):
    """Plausible scores (snr 2.0) at B = 32 cut into chunks of the given
    frame counts, [B, T, P] each on the host; a valid mask [B, max T]
    with a masked stretch on channel 1."""
    import numpy as np

    from vosk_tpu_torch.utils.benchdata import make_plausible_loglikes

    lb = make_plausible_loglikes(graph, P, B, sum(lengths), snr=2.0, seed=seed)
    cuts = np.cumsum([0, *lengths])
    chunks = [torch.from_numpy(np.ascontiguousarray(lb[a:b].swapaxes(0, 1)))
              for a, b in zip(cuts[:-1], cuts[1:])]
    valid = torch.ones((B, max(lengths)), dtype=torch.bool)
    valid[1, 2:4] = False
    return chunks, valid


def csr_decoder(model, optimize_graph):
    """A CSR decoder (layout="csr") over a NativeModel's graph with its
    search parameters, on its device."""
    from vosk_tpu_torch.ops.viterbi import BatchViterbi, DecodeParams

    c = model.config
    return BatchViterbi(model.graph, DecodeParams(beam=c.beam, max_active=c.max_active,
                                                  lattice_beam=c.lattice_beam,
                                                  acoustic_scale=c.acoustic_scale),
                        silence_pdfs=model.silence_pdfs, optimize_graph=optimize_graph,
                        device=model.device, layout="csr")


def phase_csr_run_scan(torch, bm):
    """16a. The CSR decoder (layout="csr") on the raw 2M-state graph at
    full width: two chunks at B = 32 on the card and on the CPU, frontier,
    nine record planes and best costs bit-equal; one profiled chunk; then
    FusedPipeline.run_scan at phase 8's point with counts zeroed just
    before (the CSR step launches no hand kernel).  Returns launches."""
    from vosk_tpu_torch.runtime.pipeline import FusedPipeline

    model = bm._model
    t0 = time.perf_counter()
    dec = csr_decoder(model, optimize_graph=False)
    t_build = time.perf_counter() - t0
    saved = model._decoder
    model._decoder = dec  # the pipeline takes the model's shared decoder
    try:
        pipe = FusedPipeline(model, batch=B, chunk_seconds=0.48)
    finally:
        model._decoder = saved
    if pipe.dec is not dec or (dec.layout, dec.frame_step) != ("csr", "v3"):
        raise AssertionError("FusedPipeline did not take the CSR decoder")
    P = model.am_config.num_pdfs
    chunks, valid = plausible_chunks(torch, model.graph, P, (pipe.T, pipe.T), SEED + 40)
    zero_counts()
    card, card_s = decode_chunks(torch, dec, chunks, valid)
    read_counts("the CSR decoder", ())
    cpu, cpu_s = decode_chunks(torch, dec.to("cpu"), chunks, valid)
    records_equal(torch, card, cpu, "CSR decoder card against CPU")
    ev, dev_us, top = profile_decode(torch, dec, chunks[0], valid)
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
    launches = read_counts("the CSR run_scan", ())
    peak = torch.cuda.max_memory_allocated() / 2**30
    if not torch.isfinite(best_h).all() or not on_device(recs):
        raise AssertionError("CSR run_scan: best costs not finite or records off the card")
    frames = n_chunks * pipe.T
    ms = dt / frames * 1e3
    RUN_SCAN_MS["csr"] = ms
    live = torch.isfinite(recs["f_cost"][:, :, :, -1]).sum(-1).float()
    audio_s = n_chunks * B * pipe.chunk_samples / model.config.sample_rate
    log(f"CSR decoder on the raw graph: S={dec.S} max out-degree {dec.graph.max_em_out}, "
        f"K={dec.K} E={dec.E} Ee={dec.Ee} R={dec.R} L={1 + dec.eps_iters}; built in "
        f"{t_build:.3f} s; {len(chunks)} chunks of {pipe.T} frames at "
        f"B={B}: frontier + 9 record planes + best costs bit-equal card / CPU; chunk seconds "
        f"card {[round(x, 4) for x in card_s]} CPU {[round(x, 3) for x in cpu_s]}")
    log(f"profiled CSR decode_chunk B={B} T={pipe.T}: {ev:.1f} device events and "
        f"{dev_us:.3f} us of device rows a frame; largest rows (launches, us a frame): "
        + json.dumps(top))
    log(f"CSR run_scan B={B}, {n_chunks} chunks of 0.48 s ({pipe.T} frames each), records "
        f"{tuple(recs['prev'].shape)} / {tuple(recs['lat_ns'].shape)}: {dt:.3f} s for "
        f"{audio_s:.2f} audio-s = {audio_s / dt:.3f} audio-s/s, {ms:.3f} ms per decoded "
        f"frame (padded v3, phase 11: {RUN_SCAN_MS.get('v3', float('nan')):.3f}; v4, phase "
        f"8: {RUN_SCAN_MS.get('v4', float('nan')):.3f}); live tokens p50 "
        f"{live.median().item():.0f} (min {live.min().item():.0f}, max "
        f"{live.max().item():.0f}); peak device memory {peak:.3f} GiB; {count_line(launches)}; "
        f"{SMI}")
    return launches


def same_json(a, b) -> bool:
    """Two results equal, confidences within 1e-3 (the AM's products on the
    card and on the CPU differ at float rounding)."""
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(
            abs(a[k] - b[k]) <= 1e-3 if k in ("conf", "confidence") else same_json(a[k], b[k])
            for k in a)
    if isinstance(a, list):
        return isinstance(b, list) and len(a) == len(b) and all(map(same_json, a, b))
    return a == b


def phase_csr_split(torch, tmp):
    """16b. Phase 10's split directory on a CSR decoder, the source's own
    choice for its graph (prepared out-degree 266): 3 s through Model +
    KaldiRecognizer on the card with the decoder handed to the model as
    its shared decoder, counts zeroed just before; the JSON must equal the
    same stream's on the CPU; printed beside the port's default decoder
    (wide padded v4 rows) on the same stream.  Returns launches."""
    import numpy as np

    import vosk_tpu_torch

    path = Path(tmp) / "kaldi_split"
    runs = {}
    for device in ("cuda", "cpu"):
        model = vosk_tpu_torch.Model(str(path), device=device)
        nm = model._model
        if device == "cuda":
            runs["wide"] = stream_short(model, 16000, SEED + 41)[:3] + (nm.shared_decoder(),)
        t0 = time.perf_counter()
        nm._decoder = csr_decoder(nm, optimize_graph=True)
        t_build = time.perf_counter() - t0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_counts()  # every kernel count, just before the path
        res, accept, final_s, rec = stream_short(model, 16000, SEED + 41)
        torch.cuda.synchronize()
        runs[device] = (res, accept, final_s, rec._rec.dec, t_build,
                        read_counts(f"the CSR split stream on {device}", ()),
                        torch.cuda.max_memory_allocated() / 2**30,
                        rec._rec._frontier["state"].device.type)
    res, accept, final_s, dec, t_build, launches, peak, where = runs["cuda"]
    if (dec.layout, where, runs["cpu"][7]) != ("csr", "cuda", "cpu"):
        raise AssertionError("the split stream did not decode on CSR on the card and the CPU")
    if not same_json(res, runs["cpu"][0]):
        raise AssertionError(f"CSR split stream: card {res} != CPU {runs['cpu'][0]}")
    wide, w_acc, w_final, wdec = runs["wide"]
    log(f"CSR split: S={dec.S} M={dec.M} K={dec.K} E={dec.E} R={dec.R} (default decoder: "
        f"{wdec.layout} {wdec.frame_step} rows of M={wdec.M}, {wdec.K * wdec.M} candidates a "
        f"frame); CSR decoder built in {t_build:.3f} s; 3 s in 0.2 s pieces: AcceptWaveform "
        f"p50 {np.median(accept) * 1e3:.3f} ms max {accept.max() * 1e3:.3f} ms (default: "
        f"{np.median(w_acc) * 1e3:.3f} / {w_acc.max() * 1e3:.3f}); FinalResult "
        f"{final_s * 1e3:.3f} ms (default {w_final * 1e3:.3f}); peak device memory "
        f"{peak:.3f} GiB; {count_line(launches)}; JSON equals the CPU's: True (text "
        f"{json.dumps(res['text'][:60])}); equals the default decoder's: "
        f"{same_json(res, wide)} (default text {json.dumps(wide['text'][:60])}); {SMI}")
    return launches


def phase_csr_eps(torch, bm):
    """16c. The padded v3 step with the CSR eps rounds: the raw 2M-state
    graph with CSR_HUBS seeded states given CSR_HUB_DEGREE eps arcs each (a
    synthetic graph: none of the repo's graph generators gives a state more than 32
    eps arcs at this size), K = 7000, B = 32: a 6-frame and a pipe-length
    chunk on the card with counts zeroed just before (the gather kernel
    only, 2 a frame), the first on the CPU too, bit-equal; every eps round
    must have gone through viterbi_csr.eps_level.  Returns launches."""
    import numpy as np

    from vosk_tpu_torch.ops import viterbi_csr
    from vosk_tpu_torch.ops.viterbi import BatchViterbi, DecodeParams
    from vosk_tpu_torch.utils.benchdata import with_eps_hubs

    model, c = bm._model, bm._model.config
    t0 = time.perf_counter()
    g, added = with_eps_hubs(model.graph, CSR_HUBS, CSR_HUB_DEGREE, SEED + 42)
    dec = BatchViterbi(g, DecodeParams(beam=c.beam, max_active=c.max_active,
                                       lattice_beam=c.lattice_beam,
                                       acoustic_scale=c.acoustic_scale),
                       silence_pdfs=model.silence_pdfs, device=model.device, frame_step="v3")
    t_build = time.perf_counter() - t0
    if (dec.layout, dec.frame_step, dec.Me, dec.K) != ("padded", "v3", 0, c.max_active):
        raise AssertionError(f"the hub graph's decoder is {dec.layout} {dec.frame_step} "
                             f"Me={dec.Me} K={dec.K}")
    chunks, valid = plausible_chunks(torch, g, model.am_config.num_pdfs, (6, 17), SEED + 43)
    calls = [0]
    eps_level = viterbi_csr.eps_level

    def counted(*args):
        calls[0] += 1
        return eps_level(*args)

    viterbi_csr.eps_level = counted
    try:
        zero_counts()  # every kernel count, just before the path
        card, card_s = decode_chunks(torch, dec, chunks, valid)
        launches = read_counts("the v3 step with CSR eps rounds", V3_KERNELS)
        n_card = calls[0]
        cpu, cpu_s = decode_chunks(torch, dec.to("cpu"), chunks[:1], valid)
    finally:
        viterbi_csr.eps_level = eps_level
    frames = sum(x.shape[1] for x in chunks)
    if n_card != frames * dec.eps_iters or launches["gather_rows"] != 2 * frames:
        raise AssertionError(f"{n_card} CSR eps rounds and {launches['gather_rows']} gather "
                             f"launches in {frames} frames of {dec.eps_iters} eps rounds")
    records_equal(torch, card[:1], cpu, "v3 step with CSR eps rounds, card against CPU")
    arcs = np.concatenate([r["lat_arc"][:, :, 1:].numpy().ravel() for r in card])
    hub_arcs = int(added[arcs[arcs >= 0]].sum())
    if not hub_arcs:
        raise AssertionError("no lattice arc of an eps round left a hub")
    live = torch.isfinite(card[-1]["frontier.cost"]).sum(1)
    log(f"v3 with CSR eps rounds (synthetic: the raw 2M-state graph, {CSR_HUBS} seeded states "
        f"given {CSR_HUB_DEGREE} eps arcs each): S={dec.S} M={dec.M} Me={dec.Me} Ee={dec.Ee} "
        f"eps_iters={dec.eps_iters} K={dec.K} R={dec.R}, built in {t_build:.3f} s; chunks of "
        f"{[x.shape[1] for x in chunks]} frames at B={B}: {n_card} CSR eps rounds, "
        f"{hub_arcs} eps-round lattice arcs from hubs; first chunk bit-equal card / CPU "
        f"(frontier + 9 record planes + best costs); chunk seconds card "
        f"{[round(x, 4) for x in card_s]} = {card_s[1] / chunks[1].shape[1] * 1e3:.3f} ms a "
        f"frame on the second, CPU {[round(x, 3) for x in cpu_s]}; live tokens min "
        f"{live.min().item()} max {live.max().item()}; {count_line(launches)}; {SMI}")
    return launches


# ------------------------------------------------------------------ phase 17

MESH_T = 8                 # phase 17's chunks: frames each, two of them
MESH_V3_T = 6              # (b)'s one v3 chunk
MESH_LOADED_T = 4          # (a)'s chunk from the loaded frontier
MESH_PIPE = (2, 2)         # (c)'s mesh
# (c): the tensor-parallel AM's ll may differ from the unsharded one's by at
# most TP_LL_TOL x max|ll|, and at most a share TP_SHARE_TOL of its elements
# may lie outside tests/test_multichip.py's rtol TP_RTOL / atol TP_ATOL; best
# costs by at most TP_BEST_ATOL.  A bf16 forward moves with the summation
# order of its products (bf16 rounding of each layer's input amplifies it),
# so the card's unsharded AM against the CPU's already leaves about 0.9 % of
# the elements outside that element-wise tolerance, and the bounds are read
# over the whole ll.  On the card the sound tensor-parallel AM read 0.72 %
# of max|ll| and 1.29 % of elements (the unsharded AM against the CPU: 0.65
# and 0.89 %), each planted fault of TP_FAULTS 65.6-140.7 % and 38.9-40.5 %;
# best costs moved 0.0135 (test_multichip allows rtol 0.05, atol 0.2)
TP_LL_TOL = 2e-2
TP_SHARE_TOL = 5e-2
TP_RTOL, TP_ATOL = 0.05, 0.2
TP_BEST_ATOL = 0.05
# (c)'s planted faults (`tp_faults`), each of which must read above both
# ll bounds
TP_FAULTS = ("gather_reversed", "block_tdnnf10_aff_w", "block_prefinal_l2")
MESH_ADAPTIVE = (2, 1)     # (e)'s run_adaptive mesh: the rung from the global batch
MESH_NNET3 = (1, 2)        # (e)'s mesh over phase 9's nnet3 AM
NNET3_CHUNKS = 2           # and its chunks of phase 8's drive (records come back whole)
MESH_ADAPTIVE_SEG = 1      # its segments: a rung decision at every chunk boundary


V3_DECODER = "phase11_v3_decoder.pt"  # phase 11's raw-graph decoder, saved for phase 17


def mesh_inputs(tmp):
    """Phase 17's inputs for the ranks, one file each: the v4 decoder, the
    v3 decoder, and the scores and audio."""
    return {k: str(Path(tmp) / f"phase17_{k}.pt")
            for k in ("v4", "data", "pipe", "adaptive", "nnet3")} | {
        "v3": str(Path(tmp) / V3_DECODER)}


PROFILE_WINDOWS = 3  # profiled windows of one call whose exact launches are checked


def frame_kernels(torch, prof, T):
    """{device kernel, copy or memset: [launches a frame, device us a frame]}
    of a profile over T frames."""
    rows = {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            c, us = rows.get(ev.name, (0, 0.0))
            rows[ev.name] = (c + 1, us + ev.time_range.elapsed_us())
    if not rows:
        raise AssertionError("the profiler recorded no device kernel")
    return {k: [c / T, round(us / T, 3)] for k, (c, us) in rows.items()}


def most_seen(windows):
    """The rows of PROFILE_WINDOWS `frame_kernels` windows over the same
    deterministic call: each row as the window that saw it most often, and
    {row: [fewest, most] launches a frame} of the rows whose counts
    differed between windows.  torch.profiler can lose a device record
    (seen once on the card: 7 of a chunk's 8 expand_v4 launches) and never
    adds one, so the most seen is what ran."""
    rows = {}
    for w in windows:
        for k, v in w.items():
            if k not in rows or v[0] > rows[k][0]:
                rows[k] = v
    seen = {k: [w.get(k, [0])[0] for w in windows] for k in rows}
    return rows, {k: [min(c), max(c)] for k, c in seen.items() if min(c) != max(c)}


def stripe_kernels(torch, dec, mesh, fr, llt):
    """The sharded v4 step's kernels on one frame in a rank (fr: the whole
    frontier, llt [B, P]): its stripe of expand_v4 and the merged pool
    through select_v4, each against its plain version bit for bit, and how
    many of the stripe's candidates lie within the synced beam against its
    contribution C.  Rank 0 times both beside the unsharded pool's
    select_v4; the other ranks wait at a barrier (the card is rank 0's)."""
    import torch.distributed as dist

    from vosk_tpu_torch.ops import frame_step as fs, viterbi_v3

    i, n = viterbi_v3.shard_coordinate(mesh)
    B = llt.shape[0]
    ex = (dec.em_pack, fr["state"], fr["cost"], llt, dec.params.acoustic_scale, dec.S,
          dec.M, dec.mbits, None)
    want = fs.expand_v4_plain(*ex, slot_base=i, slot_stride=n)
    err = 0
    for stage in (None, *fs.EXPAND_STAGES):  # the kernel's choice, then each forced
        got = fs.expand_v4(*ex, stage=stage, slot_base=i, slot_stride=n)
        torch.cuda.synchronize()
        err = max(err, pool_err(torch, got, want, f"stripe {i} of {n} (ll read: {stage})"))
    got = fs.expand_v4(*ex, slot_base=i, slot_stride=n)
    pool = viterbi_v3.shard_candidates(dec, mesh, got[0], got[1:], dec.K // n)
    C = min(got[0].shape[1], viterbi_v3.SHARD_SLACK * (dec.K // n))
    thresh = fs.cost_bits(fs.bits_cost(pool[0].amin(1)) + dec.params.beam)
    in_beam = (got[0] <= thresh[:, None]).sum(1)
    valid = torch.ones(B, dtype=torch.bool, device=llt.device)
    sel = (*pool, fr, valid, dec.params.beam, dec.params.lattice_beam, dec.S, dec.mbits,
           dec.K2, dec.R)
    k_out = {k: v[0] for k, v in dec.record_buffers((1, B)).items()}
    p_out = {k: v[0] for k, v in dec.record_buffers((1, B)).items()}
    kf, _ = fs.select_v4(*sel, k_out, scratch=dec._select_scratch)
    pf, _ = fs.select_v4_plain(*sel, p_out)
    torch.cuda.synchronize()
    s_err = max(bit_err(torch, kf[k], pf[k]) for k in kf)
    s_err = max(s_err, *(bit_err(torch, k_out[k], p_out[k]) for k in k_out))
    out = {"expand_err": err, "select_err": s_err, "pool": pool[0].shape[1], "C": C,
           "in_beam": (int(in_beam.min()), int(in_beam.max())),
           "overflowed": int((in_beam > C).sum())}
    if dist.get_rank() == 0:
        times = {}
        for s in range(n):
            ms = event_ms(torch, lambda: fs.expand_v4(*ex, slot_base=s, slot_stride=n))
            plain_ms = event_ms(torch, lambda: fs.expand_v4_plain(
                *ex, slot_base=s, slot_stride=n), n=10)
            nb, ops, nb_before = expand_work(
                torch, dec, {k: v[:, s::n] for k, v in fr.items()}, llt.shape[1])
            times[f"expand_stripe{s}"] = (ms, plain_ms, *bound(nb, ops))
            if s == 0:
                log(f"expand_v4 stripe 0 of {n}: bound {bound(nb, ops)[0]:.6f} ms in the count "
                    f"of PR 15, {bound(nb_before, ops)[0]:.6f} ms in the count before; ll row "
                    "read 5 x interleaved: " + stage_times(torch, {
                        st: lambda st=st: fs.expand_v4(*ex, stage=st, slot_base=0,
                                                       slot_stride=n)
                        for st in fs.EXPAND_STAGES}))
        whole = fs.expand_v4(*ex)
        for name, p in (("select_merged", pool), ("select_whole", whole)):
            a = (*p, *sel[len(pool):])
            ms = event_ms(torch, lambda: fs.select_v4(*a, k_out, scratch=dec._select_scratch))
            plain_ms = event_ms(torch, lambda: fs.select_v4_plain(*a, p_out), n=10)
            rec = fs.select_v4_plain(*a, p_out)[1]
            times[name] = (ms, plain_ms, *bound(*select_work(
                torch, p, valid, dec.params.beam, dec.params.lattice_beam, rec)),
                event_ms(torch, lambda: torch.sort(p[0], dim=1, stable=True)))
        out["times"] = times
    dist.barrier()
    return out


def loaded_tracebacks(dec, rec, fr, start):
    """Every channel's traceback through one chunk of records that starts
    from the frontier `start` (not the utterance's start)."""
    return [dec.traceback_with_frames([rec], fr, b, at_start=False,
                                      init_states=start["state"][b].numpy())
            for b in range(start["state"].shape[0])]


def mesh_rank(mesh, paths, jobs):
    """Phase 17's work in one rank of a mesh (a spawned process; the ranks
    of a card mesh share cuda:0 over gloo).  jobs: "gloo" (gloo's MIN
    all-reduce of int32 and all_gather of CUDA tensors), "v4" (the sharded
    v4 decode of the two chunks, counts zeroed just before), "kernels"
    (`stripe_kernels` on a light frame and on a loaded one), "loaded" (the
    sharded v4 decode of a chunk from the loaded frontier), "profile" (one
    more sharded chunk under torch.profiler), "v3" (the sharded v3 decode
    of one chunk), "pipe" (FusedPipeline(mesh) at phase 8's point),
    "adaptive" (FusedPipeline(mesh).run_adaptive at phase 8's point), "nnet3"
    (FusedPipeline(mesh).run_scan on phase 9's Kaldi AM).  Returns what the
    parent checks, on the host."""
    import torch
    import torch.distributed as dist

    from vosk_tpu_torch.ops import frame_step as fs
    from vosk_tpu_torch.ops.gather import gather_rows
    from vosk_tpu_torch.parallel import mesh as pm

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = mesh.device_type == "cuda"
    dev = torch.device("cuda", torch.cuda.current_device()) if card else torch.device("cpu")
    sync = torch.cuda.synchronize if card else (lambda: None)
    inp = torch.load(paths["data"], weights_only=False) \
        if set(jobs) & {"v4", "kernels", "loaded", "v3", "pipe"} else None
    r = dist.get_rank()
    out = {"device": str(dev)}

    def host(x):
        return {k: v.cpu() for k, v in x.items()} if isinstance(x, dict) else x.cpu()

    def counts():
        return {"expand_v4": fs.expand_v4.launches, "select_v4": fs.select_v4.launches,
                "gather_rows": gather_rows.launches}

    if "gloo" in jobs:
        x = torch.tensor([7 - r, -(2**31) + r, 2**31 - 1 - r], dtype=torch.int32, device=dev)
        g = torch.full((2, 3), r, dtype=torch.int32, device=dev)
        out["gloo"] = (pm.all_reduce_min(mesh, "model", x).cpu(),
                       pm.all_gather_cat(mesh, "model", g, 1).cpu(),
                       dist.get_backend(mesh.get_group("model")))
    if "v4" in jobs:
        dec = torch.load(paths["v4"], weights_only=False).to(dev)
        chunks = [c.to(dev) for c in inp["chunks"]]
        B = chunks[0].shape[0]
        fr, recs, secs = dec.init_frontier(B), [], []
        sync()
        zero_counts()  # the sharded path's kernel counts, just before it
        for c in chunks:
            t0 = time.perf_counter()
            fr, rec, best, bestf = dec.decode_chunk_sharded(mesh, fr, c)
            sync()
            secs.append(time.perf_counter() - t0)
            recs.append(host(rec))
            if len(recs) == 1:
                mid = host(fr)
        out["v4"] = {"counts": counts(), "frontier": host(fr), "records": recs,
                     "best": best.cpu(), "best_final": bestf.cpu(), "secs": secs,
                     "tracebacks": [dec.traceback_with_frames(recs, fr, b) for b in range(B)]}
    if "kernels" in jobs:
        # one real frame: the frontier after chunk 1, chunk 2's first scores;
        # and one under load (phase 4's loaded_frame), whose contributions overflow
        ld = inp["loaded"]
        out["kernels"] = {
            "light": stripe_kernels(torch, dec, mesh, {k: v.to(dev) for k, v in mid.items()},
                                    chunks[1][:, 0]),
            "loaded": stripe_kernels(torch, dec, mesh, {k: v.to(dev) for k, v in
                                                        ld["frontier"].items()},
                                     ld["frame"].to(dev))}
    if "loaded" in jobs:  # the sharded decode of a chunk whose contributions overflow
        ld = inp["loaded"]
        t0 = time.perf_counter()
        fr, rec, best, bestf = dec.decode_chunk_sharded(
            mesh, {k: v.to(dev) for k, v in ld["frontier"].items()}, ld["chunk"].to(dev))
        sync()
        out["loaded"] = {"secs": time.perf_counter() - t0, "frontier": host(fr),
                         "best": best.cpu(), "best_final": bestf.cpu(),
                         "tracebacks": loaded_tracebacks(dec, host(rec), fr, ld["frontier"])}
    if "profile" in jobs:
        from torch.profiler import ProfilerActivity, profile

        fr = {k: v.to(dev) for k, v in mid.items()}
        dec.decode_chunk_sharded(mesh, fr, chunks[1])  # warm
        sync()
        windows = []
        zero_counts()
        for _ in range(PROFILE_WINDOWS):
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                dec.decode_chunk_sharded(mesh, fr, chunks[1])
                sync()
            windows.append(frame_kernels(torch, prof, chunks[1].shape[1]))
        out["profile"] = (*most_seen(windows), counts())
    if "v3" in jobs:
        d3 = torch.load(paths["v3"], weights_only=False).to(dev)
        c3 = inp["v3_chunk"].to(dev)
        sync()
        zero_counts()
        t0 = time.perf_counter()
        fr, rec, best, bestf = d3.decode_chunk_sharded(mesh, d3.init_frontier(c3.shape[0]), c3)
        sync()
        out["v3"] = {"counts": counts(), "secs": time.perf_counter() - t0,
                     "frontier": host(fr), "best": best.cpu(), "best_final": bestf.cpu(),
                     "tracebacks": [d3.traceback_with_frames([rec], fr, b)
                                    for b in range(c3.shape[0])]}
    if "pipe" in jobs:
        out["pipe"] = mesh_pipeline(torch, mesh, inp, torch.load(paths["pipe"], weights_only=False),
                                    torch.load(paths["v4"], weights_only=False), dev)
    if "adaptive" in jobs:
        out["adaptive"] = mesh_adaptive(torch, mesh, torch.load(paths["adaptive"], weights_only=False),
                                        torch.load(paths["v4"], weights_only=False), dev)
    if "nnet3" in jobs:
        out["nnet3"] = mesh_nnet3(torch, mesh, torch.load(paths["nnet3"], weights_only=False), dev)
    return out


def mesh_adaptive(torch, mesh, inp, dec, dev):
    """17e in one rank: FusedPipeline(mesh).run_adaptive at phase 8's point
    on phase 4's directory (its prepared decoder loaded, the AM silent) over
    the two halves' scores, seg MESH_ADAPTIVE_SEG, counts zeroed just
    before; the rungs it took, and best and frontier of the global batch."""
    from vosk_tpu_torch.io import native
    from vosk_tpu_torch.parallel import mesh as pm
    from vosk_tpu_torch.runtime.pipeline import FusedPipeline

    nm = silent_am(torch, native.load_model(inp["model_dir"], device=dev))
    nm._decoder = dec.to(dev)
    audio, ll_bias = inp["audio"], inp["ll_bias"]
    pipe = FusedPipeline(nm, batch=audio.shape[1], chunk_seconds=0.48, mesh=mesh)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    sync()
    zero_counts()
    t0 = time.perf_counter()
    st, recs, best = pipe.run_adaptive(pipe.init_state(), audio, ll_bias=ll_bias,
                                       seg=MESH_ADAPTIVE_SEG)
    best = pm.gather_channels(mesh, best, dim=1).cpu()
    fr = {k: v.cpu() for k, v in pm.gather_channels(mesh, st["frontier"]).items()}
    return {"secs": time.perf_counter() - t0, "launches": read_counts("17e run_adaptive"),
            "rungs": segment_rungs(recs), "best": best, "frontier": fr,
            "local_B": pipe.local_B}


def mesh_nnet3(torch, mesh, inp, dev):
    """17e in one rank: FusedPipeline(mesh).run_scan with phase 9's nnet3 AM
    (no i-vector graft) and its prepared decoder, counts zeroed just
    before: best, frontier and records of the global batch, and whether
    the pipeline runs the loaded network itself."""
    from vosk_tpu_torch.io import native
    from vosk_tpu_torch.parallel import mesh as pm
    from vosk_tpu_torch.runtime.pipeline import FusedPipeline

    dec = inp["decoder"].to(dev)
    nm = native.NativeModel(**inp["fields"], am_params={}, graph=dec.graph, device=dev,
                            am_override=inp["am"])
    nm._decoder = dec
    audio, ll_bias = inp["audio"].to(dev), inp["ll_bias"].to(dev)
    pipe = FusedPipeline(nm, batch=audio.shape[1], chunk_seconds=0.48, mesh=mesh)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    sync()
    zero_counts()
    st, recs, best = pipe.run_scan(pipe.init_state(), audio, ll_bias=ll_bias)
    sync()
    launches = read_counts("17e nnet3 run_scan")
    recs = pm.gather_channels(mesh, recs, 2)
    return {"launches": launches, "whole_am": pipe.am is nm.am_override,
            "best": pm.gather_channels(mesh, best, dim=1).cpu(),
            "frontier": {k: v.cpu() for k, v in pm.gather_channels(mesh, st["frontier"]).items()},
            # the records once, from rank 0
            "records": {k: v.cpu() for k, v in recs.items()} if mesh.get_rank() == 0 else None}


def phase_mesh_nnet3(torch, bm, tmp):
    """17e (run in phase 9, on its directory without the graft, served by
    `bm`): FusedPipeline(mesh=(1, 2)) with the nnet3 AM, which each rank
    runs whole on its channels (as the source: its Nnet3Am has no parameter
    dict for the mesh to shard), at phase 8's point with plausible scores;
    NNET3_CHUNKS chunks; rank 0's best, frontier and record planes
    bit-equal to the unsharded pipeline's on the card.  Returns rank 0's
    launches."""
    from vosk_tpu_torch.parallel.launch import run_group
    from vosk_tpu_torch.runtime.pipeline import FusedPipeline

    t0 = time.perf_counter()
    nm = bm._model
    pipe = FusedPipeline(nm, batch=B, chunk_seconds=0.48)
    _, audio, ll_bias = bench_inputs(torch, pipe)
    audio, ll_bias = audio[:NNET3_CHUNKS], ll_bias[:NNET3_CHUNKS]
    st, recs, best = pipe.run_scan(pipe.init_state(), audio, ll_bias=ll_bias)
    paths = mesh_inputs(tmp)
    torch.save({"decoder": pipe.dec.to("cpu"), "am": nm.am_override, "audio": audio.cpu(),
                "ll_bias": ll_bias.cpu(), "fields": {
                    k: getattr(nm, k) for k in ("config", "words", "phones", "phone_of_pdf",
                                                "silence_pdfs")}}, paths["nnet3"])
    res = run_group(mesh_rank, *MESH_NNET3, nm.device.type, "gloo", args=(paths, ("nnet3",)),
                    timeout=600)
    got = res[0]["nnet3"]
    for r in res:
        if not r["nnet3"]["whole_am"]:
            raise AssertionError("17e: a rank did not run the loaded nnet3 AM whole")
        same(torch, r["nnet3"]["best"], got["best"], "17e nnet3 rank agreement")
    same(torch, got["best"], best.cpu(), "17e nnet3 mesh best against the unsharded pipeline")
    same(torch, got["frontier"], {k: v.cpu() for k, v in st["frontier"].items()},
         "17e nnet3 mesh frontier")
    same(torch, got["records"], {k: v.cpu() for k, v in recs.items()}, "17e nnet3 mesh records")
    log(f"17e FusedPipeline(mesh={MESH_NNET3}) on phase 9's Kaldi directory (nnet3 AM, no "
        f"graft) run_scan B={B}, {best.shape[0]} chunks: each rank runs the whole AM; best, "
        f"frontier and 5 record planes bit-equal to the unsharded pipeline's; group and "
        f"reference {time.perf_counter() - t0:.3f} s ({SMI}); rank 0 "
        f"{count_line(got['launches'])}")
    return got["launches"]


def mesh_pipeline(torch, mesh, inp, pipe_inp, dec, dev):
    """17c in one rank: FusedPipeline(mesh) on phase 4's directory (its
    prepared decoder loaded, not rebuilt) at phase 8's point; the AM's ll of
    the first chunk; the rank's channels decoded from the same scores as
    the unsharded decode."""
    from vosk_tpu_torch.io import native
    from vosk_tpu_torch.parallel import mesh as pm
    from vosk_tpu_torch.runtime.pipeline import FusedPipeline

    nm = native.load_model(pipe_inp["model_dir"], device=dev)
    nm._decoder = dec.to(dev)
    audio, ll_bias = pipe_inp["audio"], pipe_inp["ll_bias"]
    pipe = FusedPipeline(nm, batch=audio.shape[1], chunk_seconds=0.48, mesh=mesh)
    pipe.run_scan(pipe.init_state(), audio, ll_bias=ll_bias)  # warm-up
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    state, recs, best = pipe.run_scan(pipe.init_state(), audio, ll_bias=ll_bias)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = read_counts("17c run_scan")
    st = pipe.init_state()
    a0 = pipe._as_device(audio[0], torch.float32, 0)
    n0 = torch.full((pipe.local_B,), audio.shape[2], dtype=torch.int32, device=dev)
    _, feats, fvalid = pipe.ex.extract_chunk(st["feat"], a0, n_samples=n0)
    _, ll, _ = pipe.am.process_chunk(st["am"], feats, fvalid)
    chans = pipe.channels
    dp = pipe.dec.decode_chunk(pipe.dec.init_frontier(pipe.local_B),
                               inp["chunks"][0][chans].to(dev))
    return {"best": pm.gather_channels(mesh, best, dim=1).cpu(),
            "ll": pm.gather_channels(mesh, ll).cpu(),
            "faults": tp_faults(torch, mesh, pipe, nm.am_params, st["am"], feats, fvalid),
            "dp_frontier": {k: v.cpu() for k, v in pm.gather_channels(mesh, dp[0]).items()},
            "dp_records": {k: v.cpu() for k, v in pm.gather_channels(mesh, dp[1], 1).items()},
            "secs": secs, "frames": audio.shape[0] * pipe.T, "launches": launches,
            "tp_shapes": {k: tuple(v.shape) for k, v in pipe.am.params.items()},
            "tp_dims": dict(pipe.am.shard_dims)}


def tp_faults(torch, mesh, pipe, params, am_state, feats, fvalid):
    """{fault: the tensor-parallel AM's ll of (c)'s first chunk, every
    channel} with each of TP_FAULTS planted in every rank, one at a time:
    the blocks of the model axis' all_gather concatenated in reverse rank
    order, or a rank holding the other rank's column block of one weight
    (bf16-rounded, as the model stores it).  What a wrong tensor-parallel
    forward reads, beside what the sound one reads."""
    from vosk_tpu_torch.models import tdnnf
    from vosk_tpu_torch.parallel import mesh as pm

    real, am = tdnnf.TensorParallelOps, pipe.am
    r, n = mesh.get_local_rank("model"), pm.axis_size(mesh, "model")

    class GatherReversed(real):
        def __init__(self, *a):
            super().__init__(*a)
            gather = self._gather
            self._gather = lambda t: torch.cat(gather(t).tensor_split(self.n, -1)[::-1], -1)

    def ll():
        _, out, _ = am.process_chunk(am_state, feats, fvalid)
        return pm.gather_channels(mesh, out).cpu()

    out = {}
    for fault in TP_FAULTS:
        if fault == "gather_reversed":
            tdnnf.TensorParallelOps = GatherReversed
            try:
                out[fault] = ll()
            finally:
                tdnnf.TensorParallelOps = real
            continue
        w = fault.removeprefix("block_")
        held = am.params[w].data.clone()
        other = torch.as_tensor(params[w]).tensor_split(n, am.shard_dims[w])[(r + 1) % n]
        am.params[w].data.copy_(other.to(torch.bfloat16).float())
        out[fault] = ll()
        am.params[w].data.copy_(held)
    return out


def same(torch, a, b, what):
    """Raise unless a and b (tensors or dicts of them) are bit-equal."""
    for k in (a if isinstance(a, dict) else {None: a}):
        x, y = (a[k], b[k]) if k is not None else (a, b)
        if not torch.equal(bits(torch, x), bits(torch, y)):
            raise AssertionError(f"{what}{'' if k is None else f'[{k}]'} differs")


def phase_mesh(torch, bm, tmp):
    """Phase 17: the device mesh and the sharded search on the card, each
    mesh's ranks being processes that share cuda:0 over gloo (so nothing
    here measures scaling).  (a) mesh (1, 4) then (1, 2): gloo's collectives
    on CUDA tensors, then the sharded v4 decode of two 8-frame chunks of
    plausible scores at B = 32 on phase 4's model (2M states, K = 7000, M =
    4): every rank agrees; best, best-final, the frontier, the pm, state
    and f_cost planes and every channel's traceback equal the unsharded
    decode_chunk's on the card; the (1, 4) run equals, record planes
    included, the same sharded decode on a CPU gloo group (the plain
    versions, run after the card groups so that it shares no time with
    them); each rank's expand_v4 stripe and the merged pool through
    select_v4 against their plain versions, bit for bit, timed beside the
    unsharded pool, on a light frame and on phase 4's loaded one, whose
    contributions overflow; from that loaded frontier, a sharded chunk
    whose best, best-final and tracebacks equal the unsharded decode's;
    one chunk profiled in a rank; (b) the sharded v3 step on phase 11's
    raw-graph decoder, mesh (1, 2), one chunk, equal to the unsharded v3
    decode, gather_rows launched; (c) FusedPipeline(mesh=(2,
    2)).run_scan at phase 8's point: the data-parallel decode of each
    channel from the same scores bit-equal, the tensor-parallel AM's ll
    within TP_LL_TOL and TP_SHARE_TOL and the best costs within
    TP_BEST_ATOL of the unsharded pipeline, and each of TP_FAULTS reading
    above both ll bounds.  Returns
    (launches by path, kernel times)."""
    from vosk_tpu_torch.parallel.launch import run_group
    from vosk_tpu_torch.runtime.pipeline import FusedPipeline

    t_phase = time.perf_counter()
    dec = bm._pipeline.dec
    model = bm._model
    P = model.am_config.num_pdfs
    chunks, _ = plausible_chunks(torch, model.graph, P, (MESH_T, MESH_T), SEED + 17)
    c3, _ = plausible_chunks(torch, model.graph, P, (MESH_V3_T,), SEED + 18)
    lfr, lll = loaded_frame(torch, bm)
    g = torch.Generator().manual_seed(SEED + 19)  # more of loaded_frame's flat scores
    lchunk = torch.randn((B, MESH_LOADED_T, P), generator=g) * 0.1
    lfr = {k: v.cpu() for k, v in lfr.items()}
    pipe = FusedPipeline(model, batch=B, chunk_seconds=0.48)
    _, audio, ll_bias = bench_inputs(torch, pipe)
    paths = mesh_inputs(tmp)
    torch.save(dec.to("cpu"), paths["v4"])
    torch.save({"chunks": chunks, "v3_chunk": c3[0],
                "loaded": {"frontier": lfr, "frame": lll[:, -1].cpu(), "chunk": lchunk}},
               paths["data"])
    torch.save({"audio": audio.cpu(), "ll_bias": ll_bias.cpu(),
                "model_dir": str(Path(tmp) / "bench_model")}, paths["pipe"])
    # the unsharded references on the card
    ref_fr, ref_recs = dec.init_frontier(B), []
    for c in chunks:
        ref_fr, rec, ref_best, ref_bestf = dec.decode_chunk(ref_fr, c.to(dec.device))
        ref_recs.append({k: v.cpu() for k, v in rec.items()})
        if len(ref_recs) == 1:
            ref_mid = {k: v.cpu() for k, v in ref_fr.items()}
    ref_tb = [dec.traceback_with_frames(ref_recs, ref_fr, b) for b in range(B)]
    ref_fr = {k: v.cpu() for k, v in ref_fr.items()}
    lref = dec.decode_chunk({k: v.to(dec.device) for k, v in lfr.items()},
                            lchunk.to(dec.device))
    lref_tb = loaded_tracebacks(dec, {k: v.cpu() for k, v in lref[1].items()}, lref[0], lfr)
    log(f"phase 17 inputs saved for the ranks: " + ", ".join(
        f"{k} {Path(p).stat().st_size} bytes" for k, p in paths.items() if Path(p).exists()))

    def check_v4(res, n, what):
        for r in res[1:]:
            same(torch, r["v4"]["frontier"], res[0]["v4"]["frontier"], f"{what} rank frontier")
        got = res[0]["v4"]
        same(torch, got["best"], ref_best.cpu(), f"{what} best")
        same(torch, got["best_final"], ref_bestf.cpu(), f"{what} best_final")
        same(torch, got["frontier"], ref_fr, f"{what} frontier")
        for a, b in zip(got["records"], ref_recs):
            for k in ("pm", "state", "f_cost"):
                same(torch, a[k], b[k], f"{what} records {k}")
        if got["tracebacks"] != ref_tb:
            raise AssertionError(f"{what}: a traceback differs from the unsharded decode's")
        c = got["counts"]
        if c["expand_v4"] != 2 * MESH_T or c["select_v4"] != 2 * MESH_T or c["gather_rows"]:
            raise AssertionError(f"{what}: the sharded v4 path launched {c}")
        live = torch.isfinite(got["frontier"]["cost"]).sum(1)
        log(f"17a mesh (1, {n}) sharded v4 decode B={B} K={dec.K} M={dec.M} 2x{MESH_T} "
            f"frames: every rank agrees; best, best-final, frontier, pm/state/f_cost and "
            f"{B} tracebacks equal the unsharded decode's; live tokens {live.min().item()}-"
            f"{live.max().item()}; chunk seconds {[round(s, 4) for s in got['secs']]} "
            f"({n} processes sharing one card, {SMI}); rank 0 {count_line(c)}")
        return c

    t0 = time.perf_counter()
    card4 = run_group(mesh_rank, 1, 4, "cuda", "gloo",
                      args=(paths, ("gloo", "v4", "kernels", "loaded", "profile")), timeout=600)
    t_card4 = time.perf_counter() - t0
    mins, gath, backend = card4[0]["gloo"]
    if mins.tolist() != [4, -(2**31), 2**31 - 4] or gath.tolist() != [[0] * 3 + [1] * 3 +
                                                                      [2] * 3 + [3] * 3] * 2 \
            or backend != "gloo" or {r["device"] for r in card4} != {"cuda:0"}:
        raise AssertionError(f"gloo on CUDA tensors: {card4[0]['gloo']}")
    log(f"17a gloo on CUDA int32 tensors: MIN all-reduce {mins.tolist()} and all_gather "
        f"{gath.tolist()[0]} as expected, 4 ranks on cuda:0; the group's run {t_card4:.3f} s")
    launches = {"mesh_v4": check_v4(card4, 4, "mesh (1, 4)")}
    times = {}
    for load in ("light", "loaded"):
        ks = [r["kernels"][load] for r in card4]
        if any(k["expand_err"] or k["select_err"] for k in ks):
            raise AssertionError(f"17a {load}: stripe kernels differ from plain: {ks}")
        over = sum(k["overflowed"] for k in ks)
        if (load == "loaded") != (over > 0):
            raise AssertionError(f"17a {load} frame: {over} contributions overflowed")
        lo = min(k["in_beam"][0] for k in ks)
        hi = max(k["in_beam"][1] for k in ks)
        log(f"17a {load} frame: a rank's stripe holds {lo}-{hi} candidates within the synced "
            f"beam against its contribution C = {ks[0]['C']}; {over} of {4 * B} rank "
            f"contributions overflowed")
        pre = "" if load == "light" else "loaded_"
        for k, t in ks[0]["times"].items():
            times[pre + k] = t
            log(f"17a {load} {k} (B={B}, K={dec.K}, n=4"
                f"{', pool ' + str(ks[0]['pool']) if k == 'select_merged' else ''}): "
                + ("keys bit-equal to plain, nsm and pm where below BIG"
                   if k.startswith("expand") else "bit-equal to plain")
                + f"; kernel {t[0]:.6f} ms, plain {t[1]:.6f} ms, bound "
                f"{t[2]:.6f} ms ({t[3]}), {t[2] / t[0]:.1%} of it"
                + (f"; stable torch.sort of the pool {t[4]:.6f} ms" if len(t) > 4 else "")
                + f" ({SMI})")
    lgot = card4[0]["loaded"]
    for r in card4[1:]:
        same(torch, r["loaded"]["frontier"], lgot["frontier"], "17a loaded rank frontier")
    same(torch, lgot["best"], lref[2].cpu(), "17a loaded best")
    same(torch, lgot["best_final"], lref[3].cpu(), "17a loaded best_final")
    if lgot["tracebacks"] != lref_tb:
        raise AssertionError("17a loaded: a traceback differs from the unsharded decode's")
    same_ch = sum(all(torch.equal(bits(torch, lgot["frontier"][k][b]),
                                  bits(torch, lref[0][k][b].cpu())) for k in lfr)
                  for b in range(B))
    live = torch.isfinite(lgot["frontier"]["cost"]).sum(1)
    log(f"17a mesh (1, 4) sharded v4 decode of {MESH_LOADED_T} frames from the loaded "
        f"frontier (live tokens {live.min().item()}-{live.max().item()}): best, best-final "
        f"and {B} tracebacks equal the unsharded decode's; {same_ch} of {B} channels' "
        f"frontiers equal; {lgot['secs']:.3f} s ({SMI})")
    del lref
    prof, varied, c = card4[0]["profile"]
    hand = {k: v[0] for k, v in prof.items() if "expand_v4" in k or "select_v4" in k
            or "gather_rows" in k}
    log(f"17a rank 0's profiled sharded chunk (rows whose launches a frame varied over "
        f"{PROFILE_WINDOWS} windows: {json.dumps({k[:70]: v for k, v in varied.items()})}; "
        f"launches, device us a frame): "
        + json.dumps({k[:70]: v for k, v in sorted(prof.items(), key=lambda kv: -kv[1][1])}))
    n = PROFILE_WINDOWS * MESH_T
    if sum(v for k, v in hand.items() if "expand_v4" in k) != 1 \
            or sum(v for k, v in hand.items() if "select_v4" in k) != 2 \
            or any("gather_rows" in k for k in hand) \
            or c != {"expand_v4": n, "select_v4": n, "gather_rows": 0}:
        raise AssertionError(f"a rank's frame step launched hand kernels {hand}, counts {c}")
    t0 = time.perf_counter()
    card2 = run_group(mesh_rank, 1, 2, "cuda", "gloo", args=(paths, ("v4", "v3")),
                      timeout=600)
    t_card2 = time.perf_counter() - t0
    launches["mesh_v4_2"] = check_v4(card2, 2, "mesh (1, 2)")
    # (b) the v3 sharded step against the unsharded v3 decode on the card
    d3 = torch.load(paths["v3"], weights_only=False).to(dec.device)
    fr3, rec3, b3, bf3 = d3.decode_chunk(d3.init_frontier(B), c3[0].to(dec.device))
    tb3 = [d3.traceback_with_frames([rec3], fr3, b) for b in range(B)]
    got3 = card2[0]["v3"]
    same(torch, got3["best"], b3.cpu(), "17b best")
    same(torch, got3["best_final"], bf3.cpu(), "17b best_final")
    same(torch, got3["frontier"], {k: v.cpu() for k, v in fr3.items()}, "17b frontier")
    if got3["tracebacks"] != tb3:
        raise AssertionError("17b: a v3 traceback differs from the unsharded decode's")
    c = got3["counts"]
    if c["gather_rows"] <= 0 or c["expand_v4"] or c["select_v4"]:
        raise AssertionError(f"17b: the sharded v3 path launched {c}")
    launches["mesh_v3"] = c
    # the gather kernel at the sharded v3 ll site: a stripe of K / 2 tokens
    gather_times, gather_err = phase_kernel(torch, dec.device, cases=(
        ("mesh_v3_ll", "float32", B, P, (d3.K // 2) * d3.M),))
    del d3, fr3, rec3
    log(f"17b mesh (1, 2) sharded v3 decode B={B} K={dec.K} T={MESH_V3_T} on the raw graph: "
        f"best, best-final, frontier and {B} tracebacks equal the unsharded v3 decode's; "
        f"{c['gather_rows'] // MESH_V3_T} gather launches a frame in rank 0; "
        f"{got3['secs']:.3f} s; the (1, 2) group {t_card2:.3f} s")
    # the same (1, 4) sharded decode on a CPU gloo group, after the card groups
    t0 = time.perf_counter()
    cpu4 = run_group(mesh_rank, 1, 4, "cpu", "gloo", args=(paths, ("v4",)), timeout=600)
    for a, b in zip(card4[0]["v4"]["records"], cpu4[0]["v4"]["records"]):
        same(torch, a, b, "card vs CPU sharded records")
    same(torch, card4[0]["v4"]["frontier"], cpu4[0]["v4"]["frontier"], "card vs CPU frontier")
    log(f"17a mesh (1, 4) on a CPU gloo group (plain versions): frontier and all five "
        f"record planes bit-equal to the card's; the CPU group {time.perf_counter() - t0:.3f} s")
    # (c) the pipeline on mesh (2, 2) against the unsharded one, whose AM
    # also runs on the CPU for the card's own bf16 noise
    from vosk_tpu_torch.models.tdnnf import TdnnfModel

    st, recs, best = pipe.run_scan(pipe.init_state(), audio, ll_bias=ll_bias)
    st0 = pipe.init_state()
    n0 = torch.full((B,), audio.shape[2], dtype=torch.int32, device=pipe.device)
    _, feats, fvalid = pipe.ex.extract_chunk(st0["feat"], audio[0], n_samples=n0)
    _, ll0, _ = pipe.am.process_chunk(st0["am"], feats, fvalid)
    am_cpu = TdnnfModel(pipe.am.cfg, model.am_params, device="cpu")
    _, ll_cpu, _ = am_cpu.process_chunk(am_cpu.init_stream_state(B, pipe.F), feats.cpu(),
                                        fvalid.cpu())
    best, ll0 = best.cpu(), ll0.cpu()
    del st, recs, am_cpu
    t0 = time.perf_counter()
    res = run_group(mesh_rank, *MESH_PIPE, "cuda", "gloo", args=(paths, ("pipe",)),
                    timeout=600)
    got = res[0]["pipe"]
    for r in res:  # each rank holds 1 / n_model of every parameter the rule shards
        for k, shape in r["pipe"]["tp_shapes"].items():
            want, dim = list(model.am_params[k].shape), r["pipe"]["tp_dims"][k]
            if dim is not None:
                want[dim] //= MESH_PIPE[1]
            if shape != tuple(want):
                raise AssertionError(f"17c rank parameter {k} {shape}, not {tuple(want)}")
    same(torch, got["dp_frontier"], ref_mid, "17c data-parallel frontier")
    same(torch, got["dp_records"], ref_recs[0], "17c data-parallel records")
    scale = ll0.abs().max().item()

    def reading(ll):
        """(max |ll - ll0| over max|ll0|, the share of elements outside
        TP_RTOL / TP_ATOL of ll0)."""
        d = (ll - ll0).abs()
        return d.max().item() / scale, (d > TP_ATOL + TP_RTOL * ll0.abs()).float().mean().item()

    sound, cpu = reading(got["ll"]), reading(ll_cpu)
    faults = {k: reading(v) for k, v in got["faults"].items()}
    best_err = (got["best"] - best).abs().max().item()
    ms = got["secs"] / got["frames"] * 1e3
    log(f"17c FusedPipeline(mesh={MESH_PIPE}) run_scan B={B} (16 channels a data rank, the "
        f"TDNN-F over 2 model ranks), {got['frames']} frames: data-parallel decode of every "
        f"channel bit-equal from the same scores; tensor-parallel AM ll max |diff| "
        f"{sound[0]:.4%} of max|ll| {scale:.4f} (bound {TP_LL_TOL:.0%}), "
        f"{sound[1]:.4%} of elements outside rtol {TP_RTOL} / atol {TP_ATOL} (bound "
        f"{TP_SHARE_TOL:.0%}); the unsharded "
        f"AM on the card against the CPU: {cpu[0]:.4%}, {cpu[1]:.4%}; planted faults "
        + ", ".join(f"{k} {v[0]:.4%}, {v[1]:.4%}" for k, v in faults.items())
        + f"; best max |diff| {best_err:.6g} (bound {TP_BEST_ATOL}) against the unsharded "
        f"pipeline; {ms:.3f} ms per decoded frame in rank 0 against phase 8's "
        f"{RUN_SCAN_MS.get('v4', float('nan')):.3f} (4 processes sharing one card, no "
        f"scaling claim; {SMI}); group {time.perf_counter() - t0:.3f} s; "
        f"{count_line(got['launches'])}")
    if not (sound[0] <= TP_LL_TOL and sound[1] <= TP_SHARE_TOL and best_err <= TP_BEST_ATOL
            and torch.isfinite(got["best"]).all()):
        raise AssertionError("17c: the tensor-parallel pipeline is outside its tolerances")
    if any(v[0] <= TP_LL_TOL or v[1] <= TP_SHARE_TOL for v in faults.values()):
        raise AssertionError(f"17c: a planted fault reads within the bound: {faults}")
    launches["mesh_pipeline"] = got["launches"]
    # (e) run_adaptive on a (2, 1) mesh, the AM silent and the two data halves
    # on different scores (phase 8's, and EASY_SNR's), so that each half alone
    # would take another rung at some boundary: every rank takes the global
    # batch's rung, and best and frontier equal the unsharded run's bit for bit
    half = B // MESH_ADAPTIVE[0]
    _, _, easy = bench_inputs(torch, pipe, snr=EASY_SNR)
    mixed = torch.cat([ll_bias[:, :half], easy[:, half:]], dim=1)
    del easy
    torch.save({"audio": audio.cpu(), "ll_bias": mixed.cpu(),
                "model_dir": str(Path(tmp) / "bench_model")}, paths["adaptive"])
    spipe = FusedPipeline(silent_am(torch, model), batch=B, chunk_seconds=0.48)
    ast, arecs, abest = spipe.run_adaptive(spipe.init_state(), audio, ll_bias=mixed,
                                           seg=MESH_ADAPTIVE_SEG)
    afr, rungs = {k: v.cpu() for k, v in ast["frontier"].items()}, segment_rungs(arecs)
    decs = spipe._adaptive_decs
    local = []  # the rungs each half would take from its own live count
    for sl in (slice(0, half), slice(half, B)):
        lives = [int(spipe.dec.live_tokens(spipe.dec.init_frontier(half)).max())] + [
            int(torch.isfinite(r["f_cost"][-1, -1, sl]).sum(-1).max()) for r in arecs[:-1]]
        local.append([ladder_rung(decs, n) for n in lives])
    abest = abest.cpu()
    del arecs, ast, spipe, mixed
    if local[0] == local[1]:
        raise AssertionError(f"17e: both data halves would take the rungs {local[0]} alone")
    if rungs != [max(a, b) for a, b in zip(*local)]:
        raise AssertionError(f"17e unsharded rungs {rungs}, not the larger of the halves' {local}")
    t0 = time.perf_counter()
    res = run_group(mesh_rank, *MESH_ADAPTIVE, dec.device.type, "gloo",
                    args=(paths, ("adaptive",)), timeout=600)
    got = res[0]["adaptive"]
    if any(r["adaptive"]["rungs"] != rungs for r in res):
        raise AssertionError(f"17e run_adaptive rungs {[r['adaptive']['rungs'] for r in res]}, "
                             f"not the unsharded run's {rungs}")
    same(torch, got["best"], abest, "17e run_adaptive best against the unsharded run's")
    same(torch, got["frontier"], afr, "17e run_adaptive frontier against the unsharded run's")
    log(f"17e FusedPipeline(mesh={MESH_ADAPTIVE}).run_adaptive at phase 8's point, seg "
        f"{MESH_ADAPTIVE_SEG}, the AM silent ({got['local_B']} channels a data rank: phase 8's "
        f"scores, snr {EASY_SNR}'s): alone the halves would take the rungs {local[0]} and "
        f"{local[1]}; every rank takes the global run's {rungs}; best and frontier bit-equal "
        f"to the unsharded run's; rank 0 {got['secs']:.3f} s; group "
        f"{time.perf_counter() - t0:.3f} s ({SMI}); {count_line(got['launches'])}")
    launches["mesh_adaptive"] = got["launches"]
    log(f"phase 17 (device mesh, sharded search) took {time.perf_counter() - t_phase:.3f} s")
    errs = {"expand_err": max(r["kernels"][load]["expand_err"] for r in card4
                              for load in ("light", "loaded")),
            "select_err": max(r["kernels"][load]["select_err"] for r in card4
                              for load in ("light", "loaded")),
            "gather_err": gather_err}
    return launches, {**times, **errs, "gather": gather_times}


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
    global SMI
    SMI = smi
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
    log("ptxas spill bytes (stores, loads) per function: " + json.dumps(
        check_no_spills(_kernels.build_log())))

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
    if sys.argv[1:] == ["--csr-only"]:  # phase 16 alone (on phases 4 and 10's inputs)
        with tempfile.TemporaryDirectory() as tmp:
            bm = phase_model(torch, dev, tmp)
            log(json.dumps([phase_csr_run_scan(torch, bm), phase_csr_eps(torch, bm)]))
            del bm
            gc.collect()
            phase_split(torch, tmp)
            log(json.dumps(phase_csr_split(torch, tmp)))
        return 0
    if sys.argv[1:] == ["--mesh-only"]:  # phase 17 alone (on phases 4 and 11's decoders)
        from vosk_tpu_torch.runtime.pipeline import FusedPipeline

        with tempfile.TemporaryDirectory() as tmp:
            bm = phase_model(torch, dev, tmp)
            v3 = FusedPipeline(bm._model, batch=B, chunk_seconds=0.48, frame_step="v3").dec
            torch.save(v3.to("cpu"), Path(tmp) / V3_DECODER)
            del v3
            log(json.dumps(phase_mesh(torch, bm, tmp)))
        return 0
    if sys.argv[1:] == ["--capture-only"]:  # phases 4-8 with phase 19's checks in them
        with tempfile.TemporaryDirectory() as tmp:
            bm = phase_model(torch, dev, tmp)
            phase_front_end(torch, bm)
            p = bm._pipeline
            phase_am_nnet3(torch, nnet3_ivector_am(bm), p.ex, p.chunk_samples,
                           p.max_feat_frames)
            phase_decoder(torch, bm)
            phase_serving(torch, bm)
            phase_streaming(torch, Path(tmp) / "bench_model")
            phase_run_scan(torch, bm)
            log(f"phase 19's checks took {sum(CAPTURE_SECONDS.values()):.3f} s: "
                + json.dumps({k: round(v, 3) for k, v in CAPTURE_SECONDS.items()}))
        return 0
    if sys.argv[1:] == ["--adaptive-only"]:  # phase 18 alone (on phase 4's model)
        with tempfile.TemporaryDirectory() as tmp:
            bm = phase_model(torch, dev, tmp)
            launches_adaptive, adaptive_times = phase_adaptive(torch, bm)
            log(json.dumps({"launches": launches_adaptive, "times": adaptive_times}))
        return 0
    if sys.argv[1:] == ["--threads-only"]:  # phases 7 and 14 (b0, b, d) on phase 4's model
        with tempfile.TemporaryDirectory() as tmp:
            phase_model(torch, dev, tmp)  # writes phase 4's dir
            gc.collect()
            _, model = phase_streaming(torch, Path(tmp) / "bench_model")
            phase_rows(torch, model)
            phase_server(torch, model)[1].close()
            pcm10 = noise_pcm(10.0, 16000, SEED + 30)
            wav10 = Path(tmp) / "phase14.wav"
            write_pcm_wav(wav10, pcm10)
            phase_cabi(torch, tmp, model, Path(tmp) / "bench_model", wav10, pcm10, mt_runs=5)
        return 0
    if sys.argv[1:] == ["--pitch-only"]:  # phase 13 alone, for iterating on it
        with tempfile.TemporaryDirectory() as tmp:
            *_, model, audio, info = phase_pitch(torch, tmp)
            log(json.dumps([info, phase_speaker(torch, tmp, model, audio)]))
        return 0
    def done(what):  # where the run's time goes, read off the log
        log(f"{what} done {time.perf_counter() - t_start:.3f} s after the start")

    times, max_err = phase_kernel(torch, dev)
    done("phase_kernel")
    with tempfile.TemporaryDirectory() as tmp:
        bm = phase_model(torch, dev, tmp)
        done("phase_model")
        P = bm._model.am_config.num_pdfs
        phase_front_end(torch, bm)
        done("phase_front_end")
        fs_times, profile = phase_decoder(torch, bm)
        done("phase_decoder")
        launches = phase_serving(torch, bm)
        done("phase_serving")
        b1, b1_err = phase_kernel(torch, dev, cases=(
            ("b1_ll", "float32", 1, 6008, 28000),   # streaming acoustic lookup
            ("b1_tsil", "int32", 1, 7000, 7000),    # streaming tsil lookup
        ))
        done("phase_kernel (B = 1)")
        max_err = max(max_err, b1_err)
        launches_streaming, bench_stream_model = phase_streaming(torch, Path(tmp) / "bench_model")
        done("phase_streaming")
        launches_run_scan = phase_run_scan(torch, bm)
        done("phase_run_scan")
        launches_adaptive, adaptive_times = phase_adaptive(torch, bm)
        done("phase_adaptive")
        fs_times.update(adaptive_times)
        launches_v3, v3_times, v3_err, v3_profile = phase_v3(torch, bm, tmp)
        done("phase_v3")
        max_err = max(max_err, v3_err)
        t16 = time.perf_counter()
        launches_csr = {"csr_run_scan": phase_csr_run_scan(torch, bm),
                        "v3_csr_eps": phase_csr_eps(torch, bm)}
        t16 = time.perf_counter() - t16
        done("phase_csr_run_scan, phase_csr_eps")
        launches_mesh, mesh_times = phase_mesh(torch, bm, tmp)
        done("phase_mesh")
        del bm
        launches_kaldi, launches_kaldi_batch, (n_kaldi, k_kaldi), launches_mesh_nnet3 = \
            phase_kaldi(torch, tmp)
        kaldi_times, kaldi_err = phase_kernel(torch, dev, cases=(
            ("kaldi_ll", "float32", 1, 6008, n_kaldi),
            ("kaldi_tsil", "int32", 1, k_kaldi, k_kaldi),
        ))
        done("phase_kaldi")
        launches_split, launches_grammar, (d_main, d_gram) = phase_split(torch, tmp)
        done("phase_split")
        t0 = time.perf_counter()
        launches_csr["csr_split"] = phase_csr_split(torch, tmp)
        t16 += time.perf_counter() - t0
        done("phase_csr_split")
        log(f"phase 16 (CSR decoder, CSR eps rounds) took {t16:.3f} s")
        split_times, split_err = phase_kernel(torch, dev, cases=(
            ("split_ll", "float32", 1, 6008, d_main.K * d_main.M),
            ("split_tsil", "int32", 1, d_main.K, d_main.K),
            ("grammar_ll", "float32", 1, 6008, d_gram.K * d_gram.M),
            ("grammar_tsil", "int32", 1, d_gram.K, d_gram.K),
        ))
        done("phase_kernel (split, grammar)")
        max_err = max(max_err, kaldi_err, split_err)
        for key, d, seed in (("split", d_main, SEED + 9), ("grammar", d_gram, SEED + 10)):
            fs_times[key] = phase_frame_step(torch, key, d, *real_frame(torch, d, P, seed))
            captured_vs_eager(torch, f"{key} (phase 10's decoder)", d,
                              *seeded_chunks(torch, d, 1, P, seed))
        done("phase_frame_step, captured_vs_eager (split, grammar)")
        rescoring = phase_rescoring(torch, tmp)
        done("phase_rescoring")
        rnnlm = {k: rescoring.pop(k) for k in ("rnnlm", "gru")}
        launches_pitch, launches_pitch_batch, pitch_model, voiced, pitch_info = phase_pitch(
            torch, tmp)
        done("phase_pitch")
        launches_speaker, speaker_info = phase_speaker(torch, tmp, pitch_model, voiced)
        done("phase_speaker")
        del pitch_model
        gc.collect()
        t14 = time.perf_counter()
        launches_exact3, exact3_times = phase_exact3(torch, tmp)
        done("phase_exact3")
        phase_rows(torch, bench_stream_model)
        done("phase_rows")
        launches_server, srv = phase_server(torch, bench_stream_model)
        done("phase_server")
        try:
            pcm10 = noise_pcm(10.0, 16000, SEED + 30)
            wav10 = Path(tmp) / "phase14.wav"
            write_pcm_wav(wav10, pcm10)
            launches_cli = phase_transcriber(torch, tmp, Path(tmp) / "bench_model", srv, wav10)
        finally:
            srv.close()
        done("phase_transcriber")
        launches_cabi = phase_cabi(torch, tmp, bench_stream_model, Path(tmp) / "bench_model",
                                   wav10, pcm10)
        del bench_stream_model
        done("phase_cabi")
        log(f"phase 14 (exact3, server, transcriber, C ABI) took "
            f"{time.perf_counter() - t14:.3f} s")
        launches_recipe, training = phase_training(
            torch, tmp, native_rnnlm_config(Path(tmp) / "resc_native" / "rnnlm"))
        done("phase_training")

    paths = {"streaming": launches_streaming, "run_scan": launches_run_scan,
             "adaptive": launches_adaptive,
             "kaldi": launches_kaldi, "kaldi_batch": launches_kaldi_batch,
             "split": launches_split, "grammar": launches_grammar, **launches_v3,
             **rescoring, "pitch": launches_pitch, "pitch_batch": launches_pitch_batch,
             "speaker": launches_speaker, **launches_exact3, "server": launches_server,
             "transcriber": launches_cli, "recipe": launches_recipe, **launches_csr,
             **launches_mesh, "mesh_nnet3": launches_mesh_nnet3,
             **{f"cabi_{k}": {n: v.get(n, 0) for n in ("expand_v4", "select_v4", "gather_rows")}
                for k, v in launches_cabi.items()}}
    gather_times = {**b1, **kaldi_times, **split_times, **v3_times, **mesh_times["gather"]}
    max_err = max(max_err, mesh_times["gather_err"])
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
            # captured chunk programs replayed on the main paths (phase 19)
            **{f"graph_replays_{k}": v for k, v in REPLAYS.items()},
            **{f"am_graph_replays_{k}": v for k, v in AM_REPLAYS.items()},
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
    # the sharded search's call sites (phase 17): expand_v4 over a stripe of
    # the frontier, select_v4 over the merged pool; launches in rank 0 of
    # the (1, 4) mesh's sharded decode
    for name, key, kern, site in (
            ("expand_v4_stripe", "expand_stripe0", "expand_v4", "vosk_tpu/ops/viterbi.py:879"),
            ("select_v4_merged_pool", "select_merged", "select_v4",
             "vosk_tpu/ops/viterbi.py:1105")):
        t = mesh_times[key]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "vosk_tpu_torch/csrc/frame_step.cu",
            "replaces": "vosk_tpu/ops/gather.py:33",
            "call_site": f"{site} via _frame_step_v4_sharded vosk_tpu/ops/viterbi.py:1494",
            "launches": launches_mesh["mesh_v4"][kern],
            "max_abs_err": mesh_times[f"{kern.split('_')[0]}_err"],
            "ms": t[0],
            "plain_ms": t[1],
            "bound_ms": t[2],
            "bound_by": t[3],
            "library_ms": t[4] if len(t) > 4 else None,
            **({f"expand_stripe{s}_{k}": mesh_times[f"expand_stripe{s}"][i] for s in range(4)
                for i, k in ((0, "ms"), (2, "bound_ms"))} if kern == "expand_v4" else
               {"whole_pool_ms": mesh_times["select_whole"][0],
                "whole_pool_plain_ms": mesh_times["select_whole"][1],
                "whole_pool_bound_ms": mesh_times["select_whole"][2],
                "loaded_whole_pool_ms": mesh_times["loaded_select_whole"][0],
                "loaded_whole_pool_plain_ms": mesh_times["loaded_select_whole"][1],
                "loaded_whole_pool_bound_ms": mesh_times["loaded_select_whole"][2]}),
            # phase 4's loaded frame, whose rank contributions overflow
            **{f"loaded_{k}": mesh_times[f"loaded_{key}"][i]
               for i, k in ((0, "ms"), (1, "plain_ms"), (2, "bound_ms"))},
        })
    log("rescoring RNNLM (torch ops, no hand kernel): " + json.dumps(rnnlm))
    log("pitch and x-vector (torch ops, no hand kernel): " + json.dumps(
        {"pitch": pitch_info, "speaker": speaker_info}))
    log("training (torch ops, no hand kernel; the recipe decodes through expand_v4 and "
        "select_v4): " + json.dumps(training))
    log(f"phase 19 (captured chunk programs) took {sum(CAPTURE_SECONDS.values()):.3f} s in "
        f"all: " + json.dumps({k: round(v, 3) for k, v in CAPTURE_SECONDS.items()}))
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
