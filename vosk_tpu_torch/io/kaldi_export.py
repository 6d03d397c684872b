"""Export a native model as a Kaldi-layout model directory
(final.mdl + HCLG.fst + words.txt + mfcc.conf [+ model.conf]).

Primary purpose: end-to-end validation of the Kaldi *reading* path with
weights that actually decode (tests export the trained toy model and load
it back through io/kaldi_loader).  Also usable to ship natively trained
models to Kaldi-consuming tooling.

Copy of `vosk_tpu/io/kaldi_export.py` (numpy only), kept in the port so a
Kaldi directory can be written where jax is absent; both exporters write
byte-identical files (tests/test_torch_copies.py).
"""
from __future__ import annotations

import struct
from pathlib import Path

import numpy as np

from ..graph.fst import StdFst
from .kaldiio import BinaryWriter
from .kaldi_models import HmmState, TransitionModel
from . import nnet3 as n3
from .native import NativeModel


def build_transition_model(num_phones: int, self_loop_prob: float) -> TransitionModel:
    """1-state-per-phone chain-style topology; pdf = phone - 1."""
    tm = TransitionModel()
    topo = tm.topo
    topo.phones = list(range(1, num_phones + 1))
    topo.phone2idx = [-1] + [0] * num_phones
    topo.entries = [
        [HmmState(0, 0, [(0, self_loop_prob), (1, 1.0 - self_loop_prob)])]
    ]
    tm.tuples = [(p, 0, p - 1, p - 1) for p in range(1, num_phones + 1)]
    probs = []
    for p in range(1, num_phones + 1):
        probs += [self_loop_prob, 1.0 - self_loop_prob]
    tm.log_probs = np.log(np.asarray([1.0] + probs, np.float32))[1:]
    tm._build_derived()
    return tm


def tdnnf_to_nnet3(cfg, params) -> n3.Nnet3:
    """Convert trained TdnnfModel parameters to an nnet3 network that
    evaluates identically (relu/scale/offset expressed as components)."""
    net = n3.Nnet3()
    comps = {}
    order = []

    def add(name, comp):
        comps[name] = comp
        order.append(name)

    lines = [f"input-node name=input dim={cfg.feat_dim}"]
    prev = "input"

    # tdnn1: splice(-1,0,1) -> affine -> relu -> scale -> offset
    lines.append(
        f"component-node name=tdnn1.affine component=tdnn1.affine "
        f"input=Append(Offset({prev}, -1), {prev}, Offset({prev}, 1))"
    )
    add("tdnn1.affine", n3.AffineComponent(params["tdnn1_w"].T, params["tdnn1_b"]))
    lines.append("component-node name=tdnn1.relu component=tdnn1.relu input=tdnn1.affine")
    add("tdnn1.relu", n3.NonlinComponent(cfg.hidden_dim, "RectifiedLinearComponent"))
    lines.append("component-node name=tdnn1.scale component=tdnn1.scale input=tdnn1.relu")
    add("tdnn1.scale", n3.PerElementScaleComponent(params["tdnn1_scale"]))
    lines.append("component-node name=tdnn1.offset component=tdnn1.offset input=tdnn1.scale")
    add("tdnn1.offset", n3.PerElementOffsetComponent(params["tdnn1_offset"]))
    prev = "tdnn1.offset"

    for i, s in enumerate(cfg.time_strides):
        nm = f"tdnnf{i}"
        if s == 0:
            add(f"{nm}.linear", n3.LinearComponent(params[f"{nm}_lin"].T))
            lines.append(
                f"component-node name={nm}.linear component={nm}.linear input={prev}"
            )
            add(
                f"{nm}.affine",
                n3.AffineComponent(params[f"{nm}_aff_w"].T, params[f"{nm}_aff_b"]),
            )
            lines.append(
                f"component-node name={nm}.affine component={nm}.affine input={nm}.linear"
            )
        else:
            add(
                f"{nm}.linear",
                n3.TdnnComponent([-s, 0], params[f"{nm}_lin"].T, None),
            )
            lines.append(
                f"component-node name={nm}.linear component={nm}.linear input={prev}"
            )
            add(
                f"{nm}.affine",
                n3.TdnnComponent([0, s], params[f"{nm}_aff_w"].T, params[f"{nm}_aff_b"]),
            )
            lines.append(
                f"component-node name={nm}.affine component={nm}.affine input={nm}.linear"
            )
        add(f"{nm}.relu", n3.NonlinComponent(cfg.hidden_dim, "RectifiedLinearComponent"))
        lines.append(f"component-node name={nm}.relu component={nm}.relu input={nm}.affine")
        add(f"{nm}.scale", n3.PerElementScaleComponent(params[f"{nm}_scale"]))
        lines.append(f"component-node name={nm}.scale component={nm}.scale input={nm}.relu")
        add(f"{nm}.offset", n3.PerElementOffsetComponent(params[f"{nm}_offset"]))
        lines.append(f"component-node name={nm}.offset component={nm}.offset input={nm}.scale")
        lines.append(
            f"component-node name={nm}.noop component={nm}.noop "
            f"input=Sum(Scale({cfg.bypass_scale}, {prev}), {nm}.offset)"
        )
        add(f"{nm}.noop", n3.IdentityComponent(cfg.hidden_dim, "NoOpComponent"))
        prev = f"{nm}.noop"

    add("prefinal.l", n3.LinearComponent(params["prefinal_l"].T))
    lines.append(f"component-node name=prefinal.l component=prefinal.l input={prev}")
    add("prefinal.affine", n3.AffineComponent(params["prefinal_w"].T, params["prefinal_b"]))
    lines.append("component-node name=prefinal.affine component=prefinal.affine input=prefinal.l")
    add("prefinal.relu", n3.NonlinComponent(cfg.hidden_dim, "RectifiedLinearComponent"))
    lines.append("component-node name=prefinal.relu component=prefinal.relu input=prefinal.affine")
    add("prefinal.scale", n3.PerElementScaleComponent(params["prefinal_scale"]))
    lines.append("component-node name=prefinal.scale component=prefinal.scale input=prefinal.relu")
    add("prefinal.offset", n3.PerElementOffsetComponent(params["prefinal_offset"]))
    lines.append("component-node name=prefinal.offset component=prefinal.offset input=prefinal.scale")
    add("prefinal.l2", n3.LinearComponent(params["prefinal_l2"].T))
    lines.append("component-node name=prefinal.l2 component=prefinal.l2 input=prefinal.offset")
    add("output.affine", n3.AffineComponent(params["output_w"].T, params["output_b"]))
    lines.append("component-node name=output.affine component=output.affine input=prefinal.l2")
    lines.append("output-node name=output input=output.affine objective=linear")

    for line in lines:
        net._parse_config_line(line)
    net.components = comps
    net.component_order = order
    return net


def write_fst_vector(path, fst: StdFst) -> None:
    """Write an OpenFST-binary VectorFst over StdArc."""
    with open(path, "wb") as f:
        f.write(struct.pack("<i", 2125659606))
        for s in ("vector", "standard"):
            f.write(struct.pack("<i", len(s)))
            f.write(s.encode())
        f.write(struct.pack("<i", 2))  # version
        f.write(struct.pack("<i", 0))  # flags (no symbol tables)
        f.write(struct.pack("<Q", 0))  # properties
        f.write(struct.pack("<q", fst.start))
        f.write(struct.pack("<q", fst.num_states))
        f.write(struct.pack("<q", fst.num_arcs))
        for s in range(fst.num_states):
            fw = fst.final[s] if fst.final[s] != float("inf") else float("inf")
            f.write(struct.pack("<f", fw))
            f.write(struct.pack("<q", len(fst.arcs[s])))
            for il, ol, w, ns in fst.arcs[s]:
                f.write(struct.pack("<iifi", il, ol, w, ns))


def export_kaldi_split_dir(model: NativeModel, out_dir) -> None:
    """Write a V2 Kaldi dir in SPLIT-GRAPH form: graph/HCLr.fst +
    graph/Gr.fst + graph/disambig_tid.int instead of HCLG.fst (the layout
    the reference loads at model.cc:278-286 and composes at
    recognizer.cc:33).  Requires the native model to carry its lexicon and
    word-level G."""
    import os

    from ..graph.builder import expand_hmm, make_lexicon_fst

    assert model.lexicon is not None and model.g_fst is not None, (
        "split-graph export needs lexicon + g_fst"
    )
    export_kaldi_dir(model, out_dir)
    p = Path(out_dir)
    os.remove(p / "graph" / "HCLG.fst")

    num_phones = len(model.phones) - 1
    tm = build_transition_model(num_phones, model.topology.self_loop_prob)
    id2pdf = tm.id2pdf()
    pdf_to_tid = {}
    for t in range(1, len(id2pdf)):
        pdf_to_tid.setdefault(int(id2pdf[t]), t)

    # HCLr: HMM-expanded lexicon with tid ilabels and word olabels; a
    # disambiguation symbol (one past the last transition id) follows every
    # word-emitting arc, listed in disambig_tid.int for post-composition
    # removal
    L = make_lexicon_fst(model.lexicon)
    H, _ = expand_hmm(L, model.topology, num_phones)
    dis_tid = len(id2pdf)
    for s in range(H.num_states):
        arcs = H.arcs[s]
        out = []
        for il, ol, w, ns in arcs:
            tid = pdf_to_tid[il - 1] if il != 0 else 0
            if ol != 0:
                d = H.add_state()
                out.append((tid, ol, w, d))
                H.arcs[d] = [(dis_tid, 0, 0.0, ns)]
            else:
                out.append((tid, ol, w, ns))
        H.arcs[s] = out
    write_fst_vector(p / "graph" / "HCLr.fst", H)
    write_fst_vector(p / "graph" / "Gr.fst", model.g_fst)
    (p / "graph" / "disambig_tid.int").write_text(f"{dis_tid}\n")


def export_kaldi_dir(model: NativeModel, out_dir) -> None:
    """Write a V2-layout Kaldi model dir (am/ conf/ graph/) from a native
    model (1-state topology models only)."""
    p = Path(out_dir)
    p.mkdir(parents=True, exist_ok=True)
    assert model.topology.states_per_phone == 1, "only 1-state topology exportable"
    num_phones = len(model.phones) - 1
    tm = build_transition_model(num_phones, model.topology.self_loop_prob)
    net = tdnnf_to_nnet3(model.am_config, model.am_params)
    am = n3.AmNnetSimple(net, np.zeros(0, np.float32))

    (p / "am").mkdir(exist_ok=True)
    (p / "conf").mkdir(exist_ok=True)
    (p / "graph").mkdir(exist_ok=True)
    with open(p / "am" / "final.mdl", "wb") as f:
        f.write(b"\x00B")
        w = BinaryWriter(f)
        tm.write(w)
        am.write(w)

    # decoding graph: pdf+1 ilabels -> transition ids (first tid of the
    # phone's transition state; both tids share the pdf)
    g = model.graph
    fst = StdFst()
    fst.add_states(g.num_states)
    fst.set_start(g.start)
    for s in range(g.num_states):
        if np.isfinite(g.final_cost[s]):
            fst.set_final(s, float(g.final_cost[s]))
    id2pdf = tm.id2pdf()
    pdf_to_tid = {}
    for t in range(1, len(id2pdf)):
        pdf_to_tid.setdefault(int(id2pdf[t]), t)
    for s in range(g.num_states):
        for i in range(g.em_off[s], g.em_off[s + 1]):
            pdf = int(g.em_pdf[i])
            fst.add_arc(
                s,
                pdf_to_tid[pdf],
                int(g.em_olabel[i]),
                float(g.em_w[i]),
                int(g.em_next[i]),
            )
        for i in range(g.eps_off[s], g.eps_off[s + 1]):
            fst.add_arc(
                s, 0, int(g.eps_olabel[i]), float(g.eps_w[i]), int(g.eps_next[i])
            )
    write_fst_vector(p / "graph" / "HCLG.fst", fst)

    model.words.write_text(p / "graph" / "words.txt")
    fo = model.config.frame_opts
    mel = model.config.mel_opts
    mfcc = model.config.mfcc_opts
    conf = [
        f"--sample-frequency={model.config.sample_rate:g}",
        f"--dither={fo.get('dither', 1.0):g}",
        f"--num-mel-bins={mel.get('num_bins', 23)}",
        f"--num-ceps={mfcc.get('num_ceps', 13)}",
        f"--low-freq={mel.get('low_freq', 20.0):g}",
        f"--high-freq={mel.get('high_freq', 0.0):g}",
        f"--use-energy={'true' if mfcc.get('use_energy', True) else 'false'}",
    ]
    (p / "conf" / "mfcc.conf").write_text("\n".join(conf) + "\n")
    # word-boundary info is only written when phones are word-position
    # dependent (Kaldi WordBoundaryInfo semantics need begin/end/internal
    # typing; with shared position-independent phones no consistent typing
    # exists, and a wrong one would mislead word alignment downstream)
    (p / "graph" / "phones").mkdir(exist_ok=True)
    if model.word_boundary:
        wb_lines = [f"{ph} {ty}" for ph, ty in sorted(model.word_boundary.items())]
        (p / "graph" / "phones" / "word_boundary.int").write_text(
            "\n".join(wb_lines) + "\n"
        )

    sil_phones = ":".join(
        str(ph)
        for ph in sorted({int(model.phone_of_pdf[pd]) for pd in model.silence_pdfs})
    )
    (p / "conf" / "model.conf").write_text(
        f"--beam={model.config.beam:g}\n"
        f"--max-active={model.config.max_active}\n"
        f"--lattice-beam={model.config.lattice_beam:g}\n"
        f"--frame-subsampling-factor={model.am_config.subsample}\n"
        f"--endpoint.silence-phones={sil_phones}\n"
    )
