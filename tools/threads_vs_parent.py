#!/usr/bin/env python3
"""Streaming recognizers of one model, alone and in threads, against a
parent tree's, on the same card and model.

    git archive <parent commit> | tar -x -C _archive/parent
    python3 tools/threads_vs_parent.py _archive/parent

PARENT is an unpacked tree with a chip_smoke.py whose `phase_streaming`,
`phase_server` and `phase_cabi` take the arguments this tree's take.  This
tree's bench model (chip_smoke.py phase 4: TDNN-F 40/512/96/192/6008, a
2M-state graph) is generated and saved once; then each tree, in its own
process (one package per process), in the order parent, change, change,
parent, builds its kernel library and its C ABI, and runs on that model
phase 7's 10.5 s stream in 0.2 s pieces (`AcceptWaveform` p50), phase 14
(b)'s websocket server with 4 clients (chunk round trip p50) and phase 14
(d)'s C programs, test_vosk_mt.c with 4 threads among them (single-thread
and 4-thread audio-s/s, scaling), MT_RUNS times where the tree's
`phase_cabi` takes `mt_runs`, else once.  Each process prints its phases'
lines; the last line is one JSON object {"parent": [run, run], "change":
[run, run]}, a run being {"rc", "accept_p50_ms", "rtt_p50_ms", "mt_single",
"mt_threads", "mt_scaling"}, the last three lists with one entry a
test_vosk_mt.c run (rc: the process's exit code, not 0 where
test_vosk_mt.c missed its floor after printing its numbers).  Needs one
CUDA card.
"""
from __future__ import annotations

import json
import re
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

MT_RUNS = 3  # test_vosk_mt.c runs of a tree whose phase_cabi takes mt_runs

# one tree's run, in a process of its own: argv = tree, model dir
RUN = r'''
import inspect, subprocess, sys, tempfile
from pathlib import Path

tree, model_dir = Path(sys.argv[1]), Path(sys.argv[2])
sys.path.insert(0, str(tree))
import torch

import chip_smoke as cs
from vosk_tpu_torch.ops import _kernels

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
_kernels.build()
if not (tree / "core" / "libvosk_tpu_core.so").exists():
    subprocess.run(["make", "-C", str(tree / "core"), "libvosk_tpu_core.so"], check=True,
                   stdout=sys.stderr)
with tempfile.TemporaryDirectory() as tmp:
    _, model = cs.phase_streaming(torch, model_dir)
    cs.phase_server(torch, model)[1].close()
    pcm10 = cs.noise_pcm(10.0, 16000, cs.SEED + 30)
    wav10 = Path(tmp) / "phase14.wav"
    cs.write_pcm_wav(wav10, pcm10)
    more = {"mt_runs": MT_RUNS} if "mt_runs" in inspect.signature(cs.phase_cabi).parameters else {}
    cs.phase_cabi(torch, tmp, model, model_dir, wav10, pcm10, **more)
'''.replace("MT_RUNS", str(MT_RUNS))

PATTERNS = {
    "accept_p50_ms": r"AcceptWaveform p50 ([\d.]+) ms",
    "rtt_p50_ms": r"chunk round trips p50 ([\d.]+) ms",
    "mt": r"test_vosk_mt(?:_\d+)? (?:\(4 threads\) )?wall [\d.]+ s \(THROUGHPUT single ([\d.]+) "
          r"audio-s/s, 4 threads ([\d.]+) audio-s/s \(scaling x([\d.]+)\)",
}


def run_tree(tree: Path, model_dir: Path) -> dict:
    proc = subprocess.run([sys.executable, "-c", RUN, str(tree), str(model_dir)],
                          cwd=tree, capture_output=True, text=True, timeout=1200)
    print(proc.stdout, end="", flush=True)
    # a run whose test_vosk_mt.c missed its floor still printed its numbers
    out = {"rc": proc.returncode}
    for key, pat in PATTERNS.items():
        found = re.findall(pat, proc.stdout)
        if not found:
            raise SystemExit(f"{tree} exited {proc.returncode}, no match for {key}:\n"
                             f"{proc.stderr[-4000:]}")
        if key == "mt":
            for i, name in enumerate(("mt_single", "mt_threads", "mt_scaling")):
                out[name] = [float(m[i]) for m in found]
        else:
            out[key] = float(found[0])
    return out


def main() -> int:
    import torch

    if len(sys.argv) != 2:
        raise SystemExit(__doc__)
    if not torch.cuda.is_available():
        raise SystemExit("threads_vs_parent.py needs a CUDA device; none is visible")
    parent = Path(sys.argv[1]).resolve()
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from vosk_tpu_torch.io import native
    from vosk_tpu_torch.utils import benchdata

    cs.log(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    out = {"parent": [], "change": []}
    with tempfile.TemporaryDirectory() as tmp:
        m = benchdata.make_bench_model(seed=cs.SEED, device="cpu")
        model_dir = Path(tmp) / "bench_model"
        native.save_model(model_dir, m.config, m.am_params, m.graph, m.words, m.phones,
                          m.phone_of_pdf, m.silence_pdfs)
        del m
        for which, tree in (("parent", parent), ("change", ROOT), ("change", ROOT),
                            ("parent", parent)):
            cs.log(f"--- {which}: {tree}")
            out[which].append(run_tree(tree, model_dir))
    cs.log(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
