#!/usr/bin/env python3
"""select_v4 against a parent tree's select_v4, on the same frames and card.

    git archive <parent commit> | tar -x -C _archive/parent
    python3 select_vs_parent.py _archive/parent

PARENT is an unpacked tree whose `vosk_tpu_torch.ops.frame_step` has a
`select_v4` kernel wrapper of the same call (its own kernel library is
built from its own csrc/).  That package is loaded under another name;
this tree's makes the frames, those of chip_smoke.py on the full-width
smoke model (2M-state graph): the B = 32 batch frame and its first channel
(B = 1), the B = 32 frame under load (flat scores, channels at
max-active), the same at max-active 10,000 (pass 2 in global scratch), the
split-graph frame (M = 266, B = 1) and the grammar frame (K = 124).  On
each frame both selections run on the same pool from this tree's
expand_v4 and must be bit-equal to each other and to select_v4_plain;
each is timed with chip_smoke.event_ms (CUDA events over 100 calls behind
a device sleep) in the order parent, change, change, parent, twice,
beside one stable torch.sort of the pool.  Prints
one line per frame (with this tree's pass-1 list length, in-range count
and winners per channel) and, last, one JSON object {frame: {"parent_ms":
[...], "select_v4_ms": [...], "torch_sort_ms": t}}.  Needs one CUDA card.
"""
from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent


def load_parent(parent: Path):
    """The parent's frame_step, as module `parent_vtt.ops.frame_step`."""
    pkg = parent / "vosk_tpu_torch"
    spec = importlib.util.spec_from_file_location(
        "parent_vtt", pkg / "__init__.py", submodule_search_locations=[str(pkg)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules["parent_vtt"] = mod
    spec.loader.exec_module(mod)
    return importlib.import_module("parent_vtt.ops.frame_step")


def compare(torch, cs, pfs, name, dec, fr, ll, valid):
    from vosk_tpu_torch.ops import frame_step as fs

    pool = fs.expand_v4(dec.em_pack, fr["state"], fr["cost"], ll[:, -1],
                        dec.params.acoustic_scale, dec.S, dec.M, dec.mbits)
    Bn = fr["state"].shape[0]
    args = (*pool, fr, valid, dec.params.beam, dec.params.lattice_beam, dec.S, dec.mbits,
            dec.K2, dec.R)
    outs = [dec.record_buffers((Bn,)) for _ in range(3)]
    scratch, p_scratch = fs.SelectScratch(), pfs.SelectScratch()
    stats = torch.zeros((Bn, 3), dtype=torch.int32, device=dec.device)

    def parent():
        return pfs.select_v4(*args, outs[0], scratch=p_scratch)

    def change():
        return fs.select_v4(*args, outs[1], scratch=scratch)

    (pf, prec), (cf, crec) = parent(), fs.select_v4(*args, outs[1], scratch=scratch,
                                                    stats=stats)
    qf, qrec = fs.select_v4_plain(*args, outs[2])
    torch.cuda.synchronize()
    for what, a, b, c in (("frontier", pf, cf, qf), ("records", prec, crec, qrec)):
        for k in a:
            if not (torch.equal(cs.bits(torch, a[k]), cs.bits(torch, b[k]))
                    and torch.equal(cs.bits(torch, b[k]), cs.bits(torch, c[k]))):
                raise AssertionError(f"{name}: parent, select_v4 and plain differ at {what}[{k}]")
    times = {"parent_ms": [], "select_v4_ms": []}
    for _ in range(2):
        for key, fn in (("parent_ms", parent), ("select_v4_ms", change),
                        ("select_v4_ms", change), ("parent_ms", parent)):
            times[key].append(cs.event_ms(torch, fn))
    times["torch_sort_ms"] = cs.event_ms(torch, lambda: torch.sort(pool[0], dim=1, stable=True))
    kept = int(torch.isfinite(cf["cost"]).sum())
    live = int((fr["state"] != dec.S).sum())
    st = stats.cpu().tolist()
    cs.log(f"{name} B={Bn} K={dec.K} M={dec.M} K2={dec.K2} R={dec.R}, {live} live tokens, "
           f"{kept} kept: bit-equal (parent, select_v4, plain); parent "
           f"{json.dumps([round(t, 6) for t in times['parent_ms']])} ms, select_v4 "
           f"{json.dumps([round(t, 6) for t in times['select_v4_ms']])} ms, stable torch.sort "
           f"of the pool {times['torch_sort_ms']:.6f} ms; per channel (list, in range, "
           f"winners) {json.dumps(st if Bn <= 4 else st[:4] + ['...'])}, list max "
           f"{max(s[0] for s in st)}, in range max {max(s[1] for s in st)}")
    return times


def main() -> int:
    import torch

    if len(sys.argv) != 2:
        raise SystemExit(__doc__)
    if not torch.cuda.is_available():
        raise SystemExit("select_vs_parent.py needs a CUDA device; none is visible")
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from vosk_tpu_torch.ops.viterbi import BatchViterbi

    pfs = load_parent(Path(sys.argv[1]).resolve())
    if not (ROOT / "core" / "libvosk_tpu_core.so").exists():  # the serving model finishes there
        subprocess.run(["make", "-C", str(ROOT / "core"), "libvosk_tpu_core.so"], check=True,
                       stdout=sys.stderr)
    cs.log(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    dev = torch.device("cuda")
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        bm = cs.phase_model(torch, dev, tmp)
        dec = bm._pipeline.dec
        P = bm._model.am_config.num_pdfs
        # the batch frame of chip_smoke.phase_decoder: 3 chunks of 7 frames
        # of N(0, 2^2) scores, then the first 6 frames of the third again
        g = torch.Generator().manual_seed(cs.SEED + 2)
        chunks = [(torch.randn((cs.B, 7, P), generator=g) * 2.0).to(dev) for _ in range(3)]
        valid = torch.ones((cs.B, 7), dtype=torch.bool, device=dev)
        valid[1, 2:4] = False
        fr = dec.init_frontier(cs.B)
        for ll in chunks:
            fr, _, _, _ = dec.decode_chunk(fr, ll, valid)
        fr, _, _, _ = dec.decode_chunk(fr, chunks[2][:, :6], valid[:, :6])
        out["b32"] = compare(torch, cs, pfs, "batch", dec, fr, chunks[2], valid[:, 6])
        out["b1"] = compare(torch, cs, pfs, "streaming", dec,
                            {k: v[:1].contiguous() for k, v in fr.items()}, chunks[2][:1],
                            valid[:1, 6])
        ones = torch.ones(cs.B, dtype=torch.bool, device=dev)
        fr, ll = cs.loaded_frame(torch, bm)
        out["loaded"] = compare(torch, cs, pfs, "loaded", dec, fr, ll, ones)
        d10 = BatchViterbi(dec.graph, dataclasses.replace(dec.params, max_active=10_000),
                           silence_pdfs=dec.silence_pdfs, device=dev)
        fr, ll = cs.loaded_frame(torch, bm, dec=d10)
        out["loaded_k10000"] = compare(torch, cs, pfs, "loaded max-active 10000", d10, fr, ll,
                                       ones)
        del bm, dec, d10
        _, _, (d_main, d_gram) = cs.phase_split(torch, tmp)
        fr, ll, v1 = cs.real_frame(torch, d_main, P, cs.SEED + 9)
        out["split"] = compare(torch, cs, pfs, "split", d_main, fr, ll, v1)
        fr, ll, v1 = cs.real_frame(torch, d_gram, P, cs.SEED + 10)
        out["grammar"] = compare(torch, cs, pfs, "grammar", d_gram, fr, ll, v1)
    cs.log(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
