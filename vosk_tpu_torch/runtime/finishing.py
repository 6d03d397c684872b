"""Lattice finishing: decoder records -> n-best word items with posteriors
(and optional LM rescoring).

Port of `vosk_tpu/runtime/finishing.py`.  Without rescoring,
`Finisher.paths` goes through the native library (core/src/lattice.cc via
runtime/native_lattice.py): MBR for the one-best result, native n-best for
alternatives; a missing native library raises.  `finish_lattice` and
`_finish_mbr` are copies of the source's Python path over a built
`Lattice` (graph/lattice.py, graph/mbr.py): the streaming recognizer's
windowed lattices and the n-best fallback take it, as in the source.

When the model carries rescoring resources (the graph LM `g_fst` and a big
ARPA / const-ARPA LM, a native GRU RNNLM or a Kaldi RNNLM), every result
takes the Python path, as in the source: the lattice is rescored
(subtract the graph LM, add the big LM or its 0.5/0.5 mixture with the
RNNLM; reference recognizer.cc:680-705), then scaled, pruned and decoded.
The LMs are scored on the host; an RNNLM runs on the model's device.
`rescore_stats` counts the rescored lattices and the host seconds spent
in rescoring, and gives the size of the last composed lattice (nodes, arcs,
word arcs).
"""
from __future__ import annotations

import time
from typing import List, Tuple

from . import native_lattice

BUILD_HINT = (
    "build it with `make -C core libvosk_tpu_core.so` or "
    "vosk_tpu_torch.runtime.native_lattice.build_library()"
)


def _viterbi_spans(ols_frames, n_frames, pdfs, sil):
    """Word spans from a best-path alignment: word i runs from its anchor
    frame to the next word's anchor (or path end), trailing silence
    trimmed."""
    spans = []
    for i, (_, f0) in enumerate(ols_frames):
        f1 = ols_frames[i + 1][1] if i + 1 < len(ols_frames) else n_frames
        f1 = max(f1, f0 + 1)
        while f1 > f0 + 1 and f1 - 1 < len(pdfs) and pdfs[f1 - 1] in sil:
            f1 -= 1
        spans.append((f0, f1))
    return spans


class Finisher:
    def __init__(self, model, dec):
        if not native_lattice.available():
            raise RuntimeError(f"native lattice library not found; {BUILD_HINT}")
        self.model = model
        self.dec = dec
        self.lattice_beam = model.config.lattice_beam
        self._sub_lm = None
        self._rnn_rescorer = None
        self.rescore_stats = {"lattices": 0, "seconds": 0.0, "nodes": 0, "arcs": 0,
                              "word_arcs": 0}

    @property
    def rescoring(self) -> bool:
        model = self.model
        return model.g_fst is not None and (
            model.rescore_lm is not None or model.rnnlm is not None
            or model.rnnlm_rescorer is not None
        )

    def paths(
        self, records: List[dict], frontier, channel: int, n: int,
        use_final: bool = True, init_override=None,
    ) -> List[Tuple[float, List[Tuple[int, int, int, float]]]]:
        """n best paths as [(cost, [(wid, f0, f1, conf)])]; frames relative
        to the given records.  n == 1 is the MBR sausage decode (reference
        MbrResult).  init_override: (states [K], costs [K]) anchoring the
        records at a fold boundary instead of the utterance start.

        When MBR keeps no word, the source builds the Python lattice and
        takes its best path with pooled confidences; the native n-best
        computes the same pooled confidences, but skips word-less paths, so
        a best path without words is restored from MBR's cost.  When the
        native n-best finds no path, the Python lattice gives the result,
        as in the source."""
        if not records:
            return []
        model, dec = self.model, self.dec
        if self.rescoring:
            from ..graph.lattice import build_lattice

            lat, _ = build_lattice(records, frontier, channel, dec, use_final=use_final,
                                   init_override=init_override)
            return self.finish_lattice(lat, n)
        got = None
        if n == 1:
            got = native_lattice.mbr_native(
                records, frontier, channel, dec, model.silence_pdfs,
                lattice_beam=self.lattice_beam, graph_scale=0.9,
                use_final=use_final, init_override=init_override,
            )
            if got is not None and got[1]:
                cost, items = got
                # span refinement: when the MBR words equal the Viterbi
                # best path's words, realign spans from the traceback pdf
                # alignment (the reference word-aligns the lattice before
                # MBR, recognizer.cc:435)
                _, ols_frames, pdfs = dec.traceback_with_frames(
                    records, frontier, channel, use_final=use_final,
                    at_start=init_override is None,
                    init_states=None if init_override is None else init_override[0],
                )
                if [w for w, *_ in items] == [o for o, _ in ols_frames]:
                    sil = set(int(x) for x in model.silence_pdfs)
                    spans = _viterbi_spans(ols_frames, len(pdfs), pdfs, sil)
                    items = [
                        (w, f0, f1, conf)
                        for (w, _, _, conf), (f0, f1) in zip(items, spans)
                    ]
                    if model.word_boundary:
                        from .wordalign import realign_items

                        items = realign_items(
                            items, pdfs, model.phone_of_pdf, model.word_boundary,
                        )
                return [(cost, list(items))]
        out = native_lattice.nbest_native(
            records, frontier, channel, dec, model.silence_pdfs, n=n,
            lattice_beam=self.lattice_beam, graph_scale=0.9,
            use_final=use_final, distinct=n > 1, init_override=init_override,
        )
        if out is None:
            raise RuntimeError(f"native lattice build failed; {BUILD_HINT}")
        if got is not None and (not out or out[0][0] > got[0]):
            # the lattice's best path (MBR's cost) carries no word
            return [(got[0], [])]
        if out:
            return out
        from ..graph.lattice import build_lattice

        lat, _ = build_lattice(
            records, frontier, channel, dec, use_final=use_final,
            init_override=init_override,
        )
        return self.finish_lattice(lat, n)

    def _rescore(self, lat):
        """Big-LM rescoring: subtract the graph's G, add the ARPA LM and/or
        the RNNLM 0.5/0.5 mixture (reference recognizer.cc:680-705)."""
        from ..graph.arpa import FstLm
        from ..graph.lattice import rescore_lattice

        model = self.model
        t0 = time.perf_counter()
        if self._sub_lm is None:
            self._sub_lm = FstLm(model.g_fst)
        add_lm = model.rescore_lm
        kaldi_rnn = model.rnnlm_rescorer
        if model.rnnlm is not None or kaldi_rnn is not None:
            from ..models.rnnlm import MixtureLm, RnnlmRescorer

            if self._rnn_rescorer is None:
                self._rnn_rescorer = (kaldi_rnn if kaldi_rnn is not None
                                      else RnnlmRescorer(model.rnnlm))
            if add_lm is not None:
                add_lm = MixtureLm([(0.5, add_lm), (0.5, self._rnn_rescorer)])
            else:
                add_lm = self._rnn_rescorer
        lat = rescore_lattice(lat, self._sub_lm, add_lm)
        if self._rnn_rescorer is not None:
            self._rnn_rescorer.clear()
        st = self.rescore_stats
        st["lattices"] += 1
        st["seconds"] += time.perf_counter() - t0
        st["nodes"], st["arcs"] = lat.num_nodes, len(lat.arcs)
        st["word_arcs"] = sum(1 for a in lat.arcs if a.olabel)
        return lat

    def _finish_mbr(self, lat):
        """One-best items via MBR sausage decoding on the pruned lattice
        (copy of the source's `_finish_mbr`): words and confidences from
        the sausage bins; spans from the best path (with word-boundary
        realignment) when its words equal MBR's, else the sausage's
        expected times."""
        from ..graph.mbr import mbr_decode

        model = self.model
        words = mbr_decode(lat)[0]
        if not words:
            return None
        best_cost, best_path = lat.shortest()
        path_items = None
        if best_path and [w for w, _, _, _ in words] == [
            lat.arcs[ai].olabel for ai in best_path if lat.arcs[ai].olabel
        ]:
            raw = lat.path_words(best_path)
            pdfs = [lat.arcs[ai].pdf for ai in best_path if lat.arcs[ai].is_frame]
            sil = set(int(x) for x in model.silence_pdfs)
            path_items = []
            for wid, f0, f1 in raw:
                while f1 > f0 + 1 and f1 - 1 < len(pdfs) and pdfs[f1 - 1] in sil:
                    f1 -= 1
                path_items.append((wid, f0, f1, 1.0))
            if model.word_boundary:
                from .wordalign import realign_items

                path_items = realign_items(
                    path_items, pdfs, model.phone_of_pdf, model.word_boundary,
                )
        items = []
        for i, (wid, conf, tb, te) in enumerate(words):
            if path_items is not None:
                _, f0, f1, _ = path_items[i]
            else:
                f0 = int(round(tb))
                f1 = max(int(round(te)), f0 + 1)
            items.append((wid, f0, f1, float(min(conf, 1.0))))
        return [(best_cost, items)]

    def finish_lattice(
        self, lat, n: int
    ) -> List[Tuple[float, List[Tuple[int, int, int, float]]]]:
        """Rescore, prune and extract n-best word items from a built lattice
        (copy of the source's `finish_lattice`); also the entry point for
        the recognizer's spliced whole-utterance lattices."""
        from .wordalign import realign_items

        model = self.model
        if self.rescoring:
            lat = self._rescore(lat)
        # reference applies GraphLatticeScale(0.9) before result extraction
        lat.scale_graph(0.9)
        lat = lat.prune(self.lattice_beam)
        if n == 1:
            out = self._finish_mbr(lat)
            if out is not None:
                return out
        post = lat.arc_posteriors()
        # sausage-style confidence pool: all word-arc occurrences by label
        # with their time anchors, so competing alignments of the same word
        # merge into one bin posterior
        occ: dict = {}
        for ai, a in enumerate(lat.arcs):
            if a.olabel != 0:
                occ.setdefault(a.olabel, []).append(
                    (lat.node_frame[a.src], float(post[ai]))
                )
        out = []
        seen_texts = set()
        sil = set(int(x) for x in model.silence_pdfs)
        for cost, path in lat.nbest(4 * n + 8):
            if len(out) >= n:
                break
            pdfs = [lat.arcs[ai].pdf for ai in path if lat.arcs[ai].is_frame]
            raw = lat.path_words(path)
            text_key = tuple(w for w, _, _ in raw)
            if n > 1 and text_key in seen_texts:
                continue  # distinct lattice paths can share a word sequence
            seen_texts.add(text_key)
            items = []
            for wid, f0, f1 in raw:
                while f1 > f0 + 1 and f1 - 1 < len(pdfs) and pdfs[f1 - 1] in sil:
                    f1 -= 1
                items.append((wid, f0, f1, 1.0))
            items = realign_items(
                items, pdfs, model.phone_of_pdf, model.word_boundary
            )
            # bin boundaries at midpoints between adjacent path word anchors
            anchors = [lat.node_frame[lat.arcs[ai].src] for ai in path
                       if lat.arcs[ai].olabel != 0]
            for wi, (wid, f0, f1, _c) in enumerate(items):
                lo = -1e9 if wi == 0 else (anchors[wi - 1] + anchors[wi]) / 2.0
                hi = (
                    1e9
                    if wi + 1 >= len(anchors)
                    else (anchors[wi] + anchors[wi + 1]) / 2.0
                )
                conf = sum(p for (f, p) in occ.get(wid, ()) if lo <= f < hi)
                items[wi] = (wid, f0, f1, min(1.0, conf))
            out.append((cost, items))
        return out
