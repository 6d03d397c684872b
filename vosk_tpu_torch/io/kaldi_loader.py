"""Kaldi model-directory loader — layout + probing parity with the
reference Model (src/model.cc:106-341): V1 flat layout (final.mdl +
mfcc.conf) and V2 layout (am/ conf/ graph/ ivector/), optional resources
probed by existence.

Copy of `vosk_tpu/io/kaldi_loader.py`, adapted to the port: it produces
the port's NativeModel on `device`, whose AM is an `Nnet3Am` with its
weights on that device and whose decoding graph is the flattened
(epsilon-reduced, degree-capped) HCLG with transition-ids mapped to pdfs.

Supported: final.mdl (TransitionModel + the nnet3 components of
io/nnet3.py), HCLG.fst and split HCLr.fst/Gr.fst lookahead graphs
(vector/const/NGram formats), words.txt, mfcc/fbank conf, model.conf decode
options and i-vector silence weighting, global CMVN stats, ivector/
extractor dirs, pitch.conf (online pitch, ops/pitch.py), word_boundary.int,
rescore/ (G.carpa + G.fst) and rnnlm/ (a Kaldi RNNLM on `device`).  As in
the source, a rescore/ or rnnlm/ whose files do not parse is skipped with
a warning and the model decodes without rescoring; carrying a parsed RNNLM
to the device is outside that guard, so a device error raises.
"""
from __future__ import annotations

import dataclasses
import time
from pathlib import Path

import numpy as np

from ..graph.fst import SymbolTable
from ..models.am import Nnet3Am
from ..utils.config import apply_options, read_config_file
from ..utils.logging import log_info, log_warn
from . import native
from .kaldi_models import raw_fst_to_std, read_fst
from .nnet3 import read_final_mdl


@dataclasses.dataclass
class DecodeOptions:
    beam: float = 13.0
    max_active: int = 7000
    lattice_beam: float = 6.0
    acoustic_scale: float = 1.0
    frame_subsampling_factor: int = 3


def is_kaldi_model_dir(path) -> bool:
    p = Path(path)
    v2 = (p / "am" / "final.mdl").exists() and (p / "conf" / "model.conf").exists()
    v1 = (p / "final.mdl").exists() and (
        (p / "mfcc.conf").exists() or (p / "fbank.conf").exists()
    )
    return v2 or v1


# Kaldi PitchExtractionOptions -> PitchOptions fields (the source's map)
PITCH_KEYS = {
    "min-f0": ("min_f0", float),
    "max-f0": ("max_f0", float),
    "penalty-factor": ("penalty_factor", float),
    "nccf-ballast": ("nccf_ballast", float),
    "resample-frequency": ("resample_rate", float),
    "frame-shift": ("frame_shift_ms", float),
    "frame-length": ("frame_length_ms", float),
}


def read_pitch_conf(path) -> dict:
    """A pitch.conf as PitchOptions keyword arguments (other keys, such as
    --sample-frequency, are not mapped: the tracker takes the features'
    rate)."""
    out = {}
    for k, v in read_config_file(path).items():
        if k in PITCH_KEYS:
            name, conv = PITCH_KEYS[k]
            out[name] = conv(v)
    return out


def load_kaldi_model(path, max_out: int = 16, device="cuda") -> native.NativeModel:
    p = Path(path)
    v2 = (p / "am" / "final.mdl").exists() and (p / "conf" / "model.conf").exists()
    if v2:
        mdl = p / "am" / "final.mdl"
        conf_dir = p / "conf"
        graph_dir = p / "graph"
        mfcc_conf = conf_dir / "mfcc.conf"
        fbank_conf = conf_dir / "fbank.conf"
        model_conf = conf_dir / "model.conf"
        words_txt = graph_dir / "words.txt"
        hclg = graph_dir / "HCLG.fst"
        hclr = graph_dir / "HCLr.fst"
        gr = graph_dir / "Gr.fst"
        disambig_int = graph_dir / "disambig_tid.int"
        cmvn_stats = p / "am" / "global_cmvn.stats"
    else:
        mdl = p / "final.mdl"
        mfcc_conf = p / "mfcc.conf"
        fbank_conf = p / "fbank.conf"
        model_conf = None
        words_txt = p / "words.txt"
        hclg = p / "HCLG.fst"
        hclr = p / "HCLr.fst"
        gr = p / "Gr.fst"
        disambig_int = p / "disambig_tid.int"
        cmvn_stats = p / "global_cmvn.stats"
    # host seconds per load stage, kept on the model as `load_seconds`
    seconds = {}
    t0 = time.perf_counter()

    # ---- decode options (reference defaults, model.conf overrides)
    opts = DecodeOptions()
    endpoint_silence_phones = "1:2:3:4:5:6:7:8:9:10"
    mraw = {}
    if model_conf is not None and model_conf.exists():
        mraw = read_config_file(model_conf)
        apply_options(opts, mraw)
        endpoint_silence_phones = mraw.get(
            "endpoint.silence-phones", endpoint_silence_phones
        )

    # ---- acoustic model, weights carried to the device once
    tm, am_simple = read_final_mdl(mdl)
    nnet_am = Nnet3Am(
        am_simple.nnet,
        subsample=opts.frame_subsampling_factor,
        priors=am_simple.priors,
        device=device,
    )
    # ---- online i-vector extractor (reference model.cc:247-263)
    ivector_dir = p / "ivector"
    ivector_cfg = None
    if (ivector_dir / "final.ie").exists():
        from .kaldi_ivector import read_ivector_dir

        log_info(f"Loading i-vector extractor from {ivector_dir / 'final.ie'}")
        ivector_cfg = read_ivector_dir(ivector_dir)
    if nnet_am.has_ivector and ivector_cfg is None:
        raise FileNotFoundError(
            f"model expects an i-vector input but {ivector_dir}/final.ie "
            "is missing"
        )
    seconds["am"] = time.perf_counter() - t0

    # ---- pitch (reference model.cc:265-276 adds Kaldi online pitch when
    # conf/pitch.conf exists): PitchOptions kwargs for ops/pitch.py
    pitch_conf = (p / "conf" / "pitch.conf") if v2 else (p / "pitch.conf")
    pitch_opts = None
    if pitch_conf.exists():
        pitch_opts = read_pitch_conf(pitch_conf)
        log_info(f"Online pitch enabled from {pitch_conf}: {pitch_opts}")

    # ---- feature config
    feat_cfg: dict
    if mfcc_conf.exists():
        fraw = read_config_file(mfcc_conf)
        feat_cfg = dict(
            feature_type="mfcc",
            frame_opts=_frame_opts(fraw),
            mel_opts=_mel_opts(fraw),
            mfcc_opts={
                "num_ceps": int(fraw.get("num-ceps", 13)),
                "use_energy": fraw.get("use-energy", "true") in ("true", "1"),
            },
        )
    elif fbank_conf.exists():
        fraw = read_config_file(fbank_conf)
        feat_cfg = dict(
            feature_type="fbank",
            frame_opts=_frame_opts(fraw),
            mel_opts=_mel_opts(fraw),
        )
    else:
        raise FileNotFoundError("Failed to find feature config file")

    # ---- graph
    id2pdf = tm.id2pdf()
    id2phone = tm.id2phone()
    hcl_fst = None
    disambig = []
    from ..graph.lookahead import (
        lookahead_compose,
        prepare_decode_fst,
        read_disambig_tids,
    )

    t0 = time.perf_counter()
    if hclg.exists():
        log_info(f"Loading HCLG from {hclg}")
        fst = raw_fst_to_std(read_fst(hclg))
    elif hclr.exists():
        # split-graph models: compose HCLr with Gr at load (the reference
        # composes lazily with lookahead matchers, recognizer.cc:33)
        log_info(f"Loading HCL and G from {hclr} {gr}")
        hcl_fst = raw_fst_to_std(read_fst(hclr))
        gr_fst = raw_fst_to_std(read_fst(gr))
        if disambig_int.exists():
            disambig = read_disambig_tids(disambig_int)
        fst = lookahead_compose(hcl_fst, gr_fst, disambig)
    else:
        raise FileNotFoundError(f"no decoding graph in {path}")

    seconds["fst_read"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    graph = prepare_decode_fst(fst, id2pdf, max_out=max_out)
    seconds["graph_prep"] = time.perf_counter() - t0

    # ---- words
    if words_txt.exists():
        words = SymbolTable.read_text(words_txt)
    else:
        raise FileNotFoundError(f"Could not read symbol table from {words_txt}")

    # ---- silence pdfs from endpoint silence phones
    sil_phones = {
        int(x) for x in str(endpoint_silence_phones).split(":") if x.strip()
    }
    sil_pdfs = sorted(
        {
            int(id2pdf[t])
            for t in range(1, len(id2pdf))
            if int(id2phone[t]) in sil_phones
        }
    )
    phone_of_pdf = np.zeros(tm.num_pdfs, np.int32)
    for t in range(1, len(id2pdf)):
        phone_of_pdf[int(id2pdf[t])] = int(id2phone[t])

    config = native.ModelConfig(
        sample_rate=float(fraw.get("sample-frequency", 16000)),
        beam=opts.beam,
        max_active=opts.max_active,
        lattice_beam=opts.lattice_beam,
        acoustic_scale=opts.acoustic_scale,
        frame_shift_seconds=0.01 * opts.frame_subsampling_factor,
        pitch_opts=pitch_opts,
        **feat_cfg,
    )

    model = native.NativeModel(
        config=config,
        am_params={},
        graph=graph,
        words=words,
        phones=SymbolTable(["<eps>"]),
        phone_of_pdf=phone_of_pdf,
        silence_pdfs=np.asarray(sil_pdfs, np.int32),
        device=device,
        am_override=nnet_am,
    )
    model.ivector = ivector_cfg
    model.load_seconds = seconds
    # split-graph resources retained for runtime grammars (the reference
    # recomposes HCLr with a phrase-list G, recognizer.cc:60-95)
    model.hcl_fst = hcl_fst
    model.disambig_tids = disambig
    model.tid2pdf = id2pdf
    model.silence_weight = float(
        mraw.get("ivector-silence-weighting.silence-weight", 1.0)
    )
    swp = mraw.get("ivector-silence-weighting.silence-phones", "")
    model.silence_weight_phones = {int(x) for x in str(swp).split(":") if x.strip()}
    if cmvn_stats.exists():
        from .kaldiio import read_kaldi_matrix

        log_info(f"Reading CMVN stats from {cmvn_stats}")
        model.global_cmvn_stats = read_kaldi_matrix(cmvn_stats)

    # ---- big-LM rescoring pair (reference model.cc:308-314): binary
    # const-ARPA G.carpa to ADD, small word-level G.fst to SUBTRACT
    rescore_dir = p / "rescore"
    carpa = rescore_dir / "G.carpa"
    if carpa.exists():
        from .kaldi_carpa import read_carpa

        log_info(f"Loading CARPA model from {carpa}")
        t0 = time.perf_counter()
        # a file that does not parse leaves the model decoding without
        # big-LM rescoring, as in the source
        try:
            model.rescore_lm = read_carpa(carpa)
            seconds["carpa"] = time.perf_counter() - t0
            gfst_small = rescore_dir / "G.fst"
            if gfst_small.exists():
                log_info(f"Loading subtract G.fst model from {gfst_small}")
                t0 = time.perf_counter()
                g = raw_fst_to_std(read_fst(gfst_small))
                # ReadAndPrepareLmFst semantics: project onto output labels
                # so the LM is a word acceptor with eps backoff arcs
                for s in range(g.num_states):
                    g.arcs[s] = [(ol, ol, w, ns) for (il, ol, w, ns) in g.arcs[s]]
                model.g_fst = g
                seconds["g_fst"] = time.perf_counter() - t0
        except Exception as e:  # noqa: BLE001 — rescoring is optional
            model.rescore_lm = None
            model.g_fst = None
            log_warn(f"rescore/ dir present but not usable: {e}")

    # ---- Kaldi RNNLM dir (reference model.cc:316-339): nnet3 net +
    # word-feature embedding composition
    rnnlm_raw = p / "rnnlm" / "final.raw"
    if rnnlm_raw.exists():
        from .kaldi_rnnlm import KaldiRnnlmRescorer, read_rnnlm_dir

        log_info(f"Loading RNNLM model from {rnnlm_raw}")
        t0 = time.perf_counter()
        try:
            lm = read_rnnlm_dir(p / "rnnlm")
        except Exception as e:  # noqa: BLE001 — unsupported nets warn loudly
            lm = None
            log_warn(f"RNNLM dir present but not usable: {e}")
        if lm is not None:
            # the device half: weights and the embedding product on `device`
            model.rnnlm_rescorer = KaldiRnnlmRescorer(lm, device=device)
            seconds["rnnlm"] = time.perf_counter() - t0

    # word-boundary info (reference model.cc:302-306): phone -> position
    # (wbegin/wend/internal/singleton/nonword), used for word alignment
    winfo = (
        p / "graph" / "phones" / "word_boundary.int"
        if v2
        else p / "word_boundary.int"
    )
    if winfo.exists():
        log_info(f"Loading winfo {winfo}")
        model.word_boundary = read_word_boundary(winfo)
    return model


def read_word_boundary(path) -> dict:
    """Parse word_boundary.int: 'phone-id type' per line, types in
    {wbegin, wend, internal, singleton, nonword, begin_and_end...}."""
    out = {}
    for line in Path(path).read_text().splitlines():
        parts = line.split()
        if len(parts) >= 2:
            out[int(parts[0])] = parts[1]
    return out


def _frame_opts(raw: dict) -> dict:
    out = {}
    mapping = {
        "dither": ("dither", float),
        "frame-length": ("frame_length_ms", float),
        "frame-shift": ("frame_shift_ms", float),
        "preemphasis-coefficient": ("preemphasis_coefficient", float),
        "remove-dc-offset": ("remove_dc_offset", lambda v: v in ("true", "1")),
        "window-type": ("window_type", str),
        "snip-edges": ("snip_edges", lambda v: v in ("true", "1")),
    }
    for k, (name, conv) in mapping.items():
        if k in raw:
            out[name] = conv(raw[k])
    return out


def _mel_opts(raw: dict) -> dict:
    out = {}
    if "num-mel-bins" in raw:
        out["num_bins"] = int(raw["num-mel-bins"])
    if "low-freq" in raw:
        out["low_freq"] = float(raw["low-freq"])
    if "high-freq" in raw:
        out["high_freq"] = float(raw["high-freq"])
    return out
