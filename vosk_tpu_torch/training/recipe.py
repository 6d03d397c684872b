"""In-process training recipe, in PyTorch: the equivalent of the
reference's Kaldi bash pipeline (training/run.sh stages 0-5: data prep ->
AM training -> graph build -> decode/score).

Port of `vosk_tpu/training/recipe.py`.  Every stage is a Python call over
the port's own components, with the AM trained and the held-out set decoded
on `device` (the card by default):

  stage 0  data prep: features + per-frame alignments (from the synthesis
           oracle, or the flat-start GMM bootstrap, training/gmm.py,
           where an utterance comes without one; run.sh:10-60)
  stage 1  AM training: frame-CE or LF-MMI chain objective
           (run.sh stage 4, local/chain/run_tdnn.sh:135-166)
  stage 2  language model estimation from the training transcripts
  stage 3  graph build: HCLG-equivalent decoding graph (graph/builder.py)
  stage 4  model-dir export (io/native.py; loadable by Model())
  stage 5  decode the held-out set through Model / KaldiRecognizer + WER
           (local/score.sh analogue, utils/wer.py)

Demo on its synthetic corpus:

    python -m vosk_tpu_torch.training.recipe [out_dir] [ce|chain] [--device cpu]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import tempfile
from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np


@dataclasses.dataclass
class RecipeConfig:
    out_dir: str
    objective: str = "chain"      # "ce" | "chain"
    train_steps: int = 400
    hidden: int = 64
    bottleneck: int = 16
    subsample: int = 3
    beam: float = 16.0
    max_active: int = 2000
    seed: int = 0
    device: str = "cuda"          # where the AM trains and the dev set decodes


def run_recipe(
    cfg: RecipeConfig,
    train_utts: Sequence[Tuple[List[str], np.ndarray, np.ndarray]],
    dev_utts: Sequence[Tuple[List[str], np.ndarray]],
    lexicon,
    words,
    phones,
    extractor,
    sil_phone: int,
    log: Callable[[str], None] = print,
) -> Dict:
    """train_utts: [(words, wav [N], phone_alignment [N] or None)];
    dev_utts: [(words, wav)].  Returns the WER report dict (stage 5).
    `log` is called with each stage's line as the stage begins."""
    import vosk_tpu_torch
    from ..graph.builder import Topology, build_decoding_graph
    from ..graph.lm import LanguageModelEstimator, LanguageModelOptions
    from ..io import native
    from ..models.tdnnf import TdnnfConfig
    from ..utils.toydata import aligned_batch, train_am
    from ..utils.wer import score_corpus

    # ---- stage 0: features + frame alignments.  Utterances may come with
    # phone alignments (synthesis oracle / forced-align) or with
    # phn=None — then the flat-start GMM bootstrap produces them from the
    # transcripts alone (reference run.sh:31-60 mono GMM stages).
    ss = cfg.subsample
    if any(phn is None for _, _, phn in train_utts):
        log("stage 0a: flat-start GMM bootstrap alignment (run.sh:31-60)")
        from .gmm import flat_start_align

        boot = flat_start_align(
            [wav for _, wav, _ in train_utts],
            [[words.find(w) for w in ws] for ws, _, _ in train_utts],
            lexicon.prons,
            num_phones=len(phones),
            sil_phone=sil_phone,
            extractor=extractor,
            log=log,
        )
        train_utts = [
            (ws, wav, phn if phn is not None else boot[i])
            for i, (ws, wav, phn) in enumerate(train_utts)
        ]
    log("stage 0: data prep (features + alignments)")
    fpad, lpad = aligned_batch(extractor, [(wav, phn) for _, wav, phn in train_utts], ss)

    # ---- stage 1: AM training
    log(f"stage 1: AM training ({cfg.objective}, {cfg.train_steps} steps)")
    am_cfg = TdnnfConfig(
        feat_dim=fpad.shape[2],
        hidden_dim=cfg.hidden,
        bottleneck_dim=cfg.bottleneck,
        prefinal_dim=32,
        num_pdfs=len(phones),
        time_strides=(1, 1, ss),
        subsample=ss,
    )
    params = train_am(am_cfg, fpad, lpad, cfg.objective, cfg.train_steps, cfg.seed,
                      cfg.device)

    # ---- stage 2: word LM from the transcripts
    log("stage 2: language model estimation")
    est = LanguageModelEstimator(LanguageModelOptions(2, 0.5))
    for ws, _, _ in train_utts:
        est.add_counts([words.find(w) for w in ws])
    g = est.estimate()

    # ---- stage 3: decoding graph
    log("stage 3: graph build")
    topo = Topology(states_per_phone=1, self_loop_prob=0.7)
    graph, info = build_decoding_graph(lexicon, g, topo)

    # ---- stage 4: export
    log(f"stage 4: export -> {cfg.out_dir}")
    mc = native.ModelConfig(
        sample_rate=extractor.frame_opts.samp_freq,
        beam=cfg.beam,
        max_active=cfg.max_active,
        acoustic_scale=1.0,
        am=dataclasses.asdict(am_cfg),
        feature_type="mfcc",
        frame_opts={"dither": 1.0},
        mel_opts={"num_bins": extractor.opts.mel_opts.num_bins,
                  "low_freq": extractor.opts.mel_opts.low_freq,
                  "high_freq": extractor.opts.mel_opts.high_freq},
        mfcc_opts={"num_ceps": extractor.opts.num_ceps,
                   "use_energy": False},
    )
    native.save_model(
        cfg.out_dir, mc, params, graph, words, phones,
        info["phone_of_pdf"], info["silence_pdfs"], lexicon=lexicon, topology=topo,
        g_fst=g,
    )

    # ---- stage 5: decode dev + WER
    log("stage 5: decode + score")
    model = vosk_tpu_torch.Model(cfg.out_dir, device=cfg.device)
    refs, hyps = [], []
    for ws, wav in dev_utts:
        rec = vosk_tpu_torch.KaldiRecognizer(model, extractor.frame_opts.samp_freq)
        rec.AcceptWaveform(np.clip(wav, -32768, 32767).astype("<i2"))
        hyps.append(json.loads(rec.FinalResult())["text"].split())
        refs.append(list(ws))
    rep = score_corpus(refs, hyps).as_dict()
    log(f"WER report: {rep}")
    with open(os.path.join(cfg.out_dir, "RESULTS.json"), "w") as f:
        json.dump(rep, f)
    return rep


def demo(out_dir: str = None, objective: str = "chain", device="cuda",
         log: Callable[[str], None] = print) -> Dict:
    """The recipe on its synthetic corpus (the mini-LibriSpeech stand-in:
    24 training utterances of 5 words with their oracle alignments, 6
    held-out utterances of 4 words), into `out_dir` (a directory under the
    temporary directory by default)."""
    from ..utils import toydata

    if out_dir is None:
        out_dir = os.path.join(tempfile.gettempdir(), "vosk_tpu_torch_recipe_demo")
    rng = np.random.default_rng(0)
    words, phones = toydata.build_symbols()
    train, dev = [], []
    for _ in range(24):
        ws = [toydata.WORDS[rng.integers(0, len(toydata.WORDS))] for _ in range(5)]
        wav, phn = toydata.synth_utterance(ws, rng)
        train.append((ws, wav, phn))
    for _ in range(6):
        ws = [toydata.WORDS[rng.integers(0, len(toydata.WORDS))] for _ in range(4)]
        wav, _ = toydata.synth_utterance(ws, rng)
        dev.append((ws, wav))
    return run_recipe(
        RecipeConfig(out_dir=out_dir, objective=objective, device=device),
        train, dev, toydata.toy_lexicon(words, phones), words, phones,
        toydata.make_extractor(device=device), toydata.SIL_PHONE, log=log,
    )


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description="Train, export, decode and score the demo "
                                "model on its synthetic corpus.")
    p.add_argument("out_dir", nargs="?", default=None, help="model directory to write")
    p.add_argument("objective", nargs="?", default="chain", choices=("ce", "chain"))
    p.add_argument("--device", default="cuda", help="torch device (cuda, cpu)")
    args = p.parse_args(argv)
    demo(args.out_dir, args.objective, args.device)


if __name__ == "__main__":
    main()
