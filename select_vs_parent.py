#!/usr/bin/env python3
"""select_v4 against the selection it replaced, on the same frames and card.

    git archive 5b453ab | tar -x -C _archive/parent
    python3 select_vs_parent.py _archive/parent

PARENT is an unpacked tree whose `vosk_tpu_torch` selects with three
stable torch sorts, their payload gathers and the `select_tail_v4` kernel
(`BatchViterbi._pool_v4` after expand, `_rank_v4`, `select_tail_v4`).
That package is loaded under another name; this tree's makes the frames:
the B = 32 batch frame and the B = 32 frame under load of chip_smoke.py
(the full-width smoke model, 2M-state graph) and the split-graph frame
(M = 266).  On each frame both selections run on the same pool from this
tree's expand_v4, their outputs must be bit-equal, and each is timed with
chip_smoke.event_ms (CUDA events over 100 calls behind a device sleep) in
the order parent, change, change, parent, twice.  Prints one line per
frame and, last, one JSON object {frame: {"parent_ms": [...],
"select_v4_ms": [...]}}.  Needs one CUDA card.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import subprocess
import sys
import tempfile
from pathlib import Path
from types import SimpleNamespace

ROOT = Path(__file__).resolve().parent


def load_parent(parent: Path):
    """The parent's frame_step and BatchViterbi, as package `parent_vtt`."""
    pkg = parent / "vosk_tpu_torch"
    spec = importlib.util.spec_from_file_location(
        "parent_vtt", pkg / "__init__.py", submodule_search_locations=[str(pkg)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules["parent_vtt"] = mod
    spec.loader.exec_module(mod)
    fs = importlib.import_module("parent_vtt.ops.frame_step")
    vit = importlib.import_module("parent_vtt.ops.viterbi")
    if not hasattr(fs, "select_tail_v4"):
        raise SystemExit(f"{parent} has no select_tail_v4: not the sort-based selection")
    return fs, vit


def compare(torch, cs, pfs, pvit, name, dec, fr, ll, valid):
    from vosk_tpu_torch.ops import frame_step as fs

    pool = fs.expand_v4(dec.em_pack, fr["state"], fr["cost"], ll[:, -1],
                        dec.params.acoustic_scale, dec.S, dec.M, dec.mbits)
    Bn = fr["state"].shape[0]
    beam, lb = dec.params.beam, dec.params.lattice_beam
    shim = SimpleNamespace(K2=dec.K2, R=dec.R, S=dec.S)
    outs = [dec.record_buffers((Bn,)) for _ in range(2)]
    scratch = fs.SelectScratch()

    def parent():
        cb, order = torch.sort(pool[0], dim=1, stable=True)
        order = order[:, :max(dec.R, min(cb.shape[1], dec.K2))]
        sA = (cb, pvit._take(pool[1], order), pvit._take(pool[2], order))
        return pfs.select_tail_v4(*pvit.BatchViterbi._rank_v4(shim, sA), fr, valid, beam, lb,
                                  dec.S, dec.mbits, outs[0])

    def change():
        return fs.select_v4(*pool, fr, valid, beam, lb, dec.S, dec.mbits, dec.K2, dec.R,
                            outs[1], scratch=scratch)

    (pf, prec), (cf, crec) = parent(), change()
    torch.cuda.synchronize()
    for what, a, b in (("frontier", pf, cf), ("records", prec, crec)):
        for k in a:
            if not torch.equal(cs.bits(torch, a[k]), cs.bits(torch, b[k])):
                raise AssertionError(f"{name}: parent and select_v4 differ at {what}[{k}]")
    times = {"parent_ms": [], "select_v4_ms": []}
    for _ in range(2):
        for key, fn in (("parent_ms", parent), ("select_v4_ms", change),
                        ("select_v4_ms", change), ("parent_ms", parent)):
            times[key].append(cs.event_ms(torch, fn))
    kept = int(torch.isfinite(cf["cost"]).sum())
    live = int((fr["state"] != dec.S).sum())
    cs.log(f"{name} B={Bn} K={dec.K} M={dec.M} K2={dec.K2} R={dec.R}, {live} live tokens, "
           f"{kept} kept: bit-equal; parent (3 torch sorts + gathers + select_tail_v4) "
           f"{json.dumps([round(t, 6) for t in times['parent_ms']])} ms, select_v4 "
           f"{json.dumps([round(t, 6) for t in times['select_v4_ms']])} ms")
    return times


def main() -> int:
    import torch

    if len(sys.argv) != 2:
        raise SystemExit(__doc__)
    if not torch.cuda.is_available():
        raise SystemExit("select_vs_parent.py needs a CUDA device; none is visible")
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs

    pfs, pvit = load_parent(Path(sys.argv[1]).resolve())
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
        out["b32"] = compare(torch, cs, pfs, pvit, "batch", dec, fr, chunks[2], valid[:, 6])
        ones = torch.ones(cs.B, dtype=torch.bool, device=dev)
        fr, ll = cs.loaded_frame(torch, bm)
        out["loaded"] = compare(torch, cs, pfs, pvit, "loaded", dec, fr, ll, ones)
        del bm, dec
        _, _, (d_main, _) = cs.phase_split(torch, tmp)
        fr, ll, v1 = cs.real_frame(torch, d_main, P, cs.SEED + 9)
        out["split"] = compare(torch, cs, pfs, pvit, "split", d_main, fr, ll, v1)
    cs.log(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
