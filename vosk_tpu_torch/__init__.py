"""vosk_tpu_torch — the PyTorch/CUDA port of vosk_tpu.

The reference binding's surface (python/vosk/__init__.py) on native and
Kaldi (V1/V2, nnet3 + i-vectors + HCLG or HCLr/Gr) model directories, with
online pitch where they ship a pitch config and LM rescoring where they
ship it (a Kaldi rescore/ and rnnlm/; a native g.npz, rescore.arpa and GRU
rnnlm/): streaming recognition through `Model` / `KaldiRecognizer`,
speaker identification through `SpkModel` (native or Kaldi x-vector dirs),
batch serving through `BatchModel` / `BatchRecognizer` (the reference's GPU
batch pipeline), `SetLogLevel`, `GpuInit` and `GpuThreadInit`, with the
same method names and JSON results as `vosk_tpu`; `list_models`,
`list_local_models` and `list_languages`.  Models live on `device` ("cuda"
by default).  Beside the library: the websocket server
(`python -m vosk_tpu_torch.server.ws`), the transcriber CLI
(`python -m vosk_tpu_torch.transcriber.cli`) and the C ABI
(`libvosk_tpu_torch.so`, built by `vosk_tpu_torch.cabi.build`).  The device
mesh (`parallel/`: `make_mesh`, `run_group`) runs `FusedPipeline(mesh=...)`
and the sharded search (`BatchViterbi.decode_chunk_sharded`) with one process
per rank.  Not ported: the model-zoo download.  The JAX package stays the reference; this package
imports torch and never jax.
"""
from __future__ import annotations

import os
from pathlib import Path

# model search path parity (reference python/vosk/__init__.py:13-15)
MODEL_DIRS = [
    os.getenv("VOSK_MODEL_PATH"),
    Path("/usr/share/vosk"),
    Path.home() / "AppData/Local/vosk",
    Path.home() / ".cache/vosk",
]


def _resolve_model_path(model_path=None, model_name=None, lang=None):
    """A model directory by path, or by name/language from MODEL_DIRS
    (no model-zoo download in the port)."""
    from re import match

    if model_path is not None:
        return model_path
    for directory in MODEL_DIRS:
        if directory is None or not Path(directory).exists():
            continue
        for entry in sorted(os.listdir(directory)):
            if model_name is not None and entry == model_name:
                return Path(directory, entry)
            if lang is not None and match(rf"vosk-model(-small)?-{lang}", entry):
                return Path(directory, entry)
    what = model_name if model_name is not None else lang
    raise FileNotFoundError(
        f"model {what} does not exist (set VOSK_MODEL_PATH or pass model_path)"
    )


MODEL_PRE_URL = "https://alphacephei.com/vosk/models/"
MODEL_LIST_URL = MODEL_PRE_URL + "model-list.json"


def list_models(urlopen=None):
    """The zoo index (reference list_models, __init__.py:34), read through
    `urlopen` (urllib's by default)."""
    import json as _json
    from urllib.request import urlopen as _urlopen

    with (urlopen or _urlopen)(MODEL_LIST_URL) as r:
        return _json.loads(r.read().decode("utf-8"))


def list_local_models():
    """List locally cached model directories (source
    vosk_tpu/__init__.py:216-222)."""
    for directory in MODEL_DIRS:
        if directory is None or not Path(directory).exists():
            continue
        for entry in sorted(os.listdir(directory)):
            print(entry)


def list_languages(urlopen=None):
    """Languages available in the zoo index (reference list_languages;
    source vosk_tpu/__init__.py:225-230)."""
    langs = sorted({m.get("lang", "?") for m in list_models(urlopen=urlopen)})
    for lang in langs:
        print(lang)
    return langs


class Model:
    """Static recognition model, shareable across recognizers
    (vosk_api.h:24-27), with its tensors on `device`."""

    def __init__(self, model_path=None, model_name=None, lang=None,
                 device="cuda"):
        from .io import native

        path = _resolve_model_path(model_path, model_name, lang)
        self._model = native.load_any(path, device=device)

    def vosk_model_find_word(self, word: str) -> int:
        return self._model.find_word(word)

    def FindWord(self, word: str) -> int:
        return self._model.find_word(word)


class SpkModel:
    """Speaker identification model (vosk_api.h:30-32): a native or Kaldi
    x-vector dir, its net on `device`."""

    def __init__(self, model_path, device="cuda"):
        from .models.xvector import SpkModel as _SpkModel

        self._model = _SpkModel.load(model_path, device=device)


class KaldiRecognizer:
    """Streaming recognizer with the reference binding's API
    (python/vosk/__init__.py:134-183): constructors (model, rate),
    (model, rate, spk_model) and (model, rate, grammar_json)."""

    def __init__(self, *args):
        from .runtime.recognizer import Recognizer

        if len(args) == 2:
            model, rate = args
            self._rec = Recognizer(model._model, float(rate))
        elif len(args) == 3 and isinstance(args[2], SpkModel):
            model, rate, spk = args
            self._rec = Recognizer(model._model, float(rate), spk_model=spk._model)
        elif len(args) == 3 and isinstance(args[2], str):
            model, rate, grammar = args
            self._rec = Recognizer(model._model, float(rate), grammar=grammar)
        else:
            raise TypeError("Unknown arguments")

    def SetMaxAlternatives(self, max_alternatives: int) -> None:
        self._rec.set_max_alternatives(max_alternatives)

    def SetWords(self, enable_words: bool) -> None:
        self._rec.set_words(enable_words)

    def SetPartialWords(self, enable_partial_words: bool) -> None:
        self._rec.set_partial_words(enable_partial_words)

    def SetNLSML(self, enable_nlsml: bool) -> None:
        self._rec.set_nlsml(enable_nlsml)

    def SetSpkModel(self, spk_model: SpkModel) -> None:
        self._rec.set_spk_model(spk_model._model)

    def AcceptWaveform(self, data) -> int:
        try:
            return 1 if self._rec.accept_waveform(data) else 0
        except Exception as e:
            raise Exception("Failed to process waveform") from e

    def Result(self) -> str:
        return self._rec.result()

    def PartialResult(self) -> str:
        return self._rec.partial_result()

    def FinalResult(self) -> str:
        return self._rec.final_result()

    def Reset(self) -> None:
        self._rec.reset()

    def GetMetrics(self) -> dict:
        """Per-stage host-time report (features / acoustic_model / decoder /
        fold / finishing seconds, xRT)."""
        return self._rec.get_metrics()


def SetLogLevel(level: int) -> None:
    """vosk_set_log_level parity (vosk_api.h:287-294)."""
    from .utils.logging import set_log_level

    set_log_level(level)


def GpuInit() -> None:
    """vosk_gpu_init parity (vosk_api.h:296-301): initialise CUDA now;
    raises without a card."""
    import torch

    torch.cuda.init()


def GpuThreadInit() -> None:
    """No-op: torch keeps per-thread CUDA state itself (vosk_api.h:303-308)."""


from .runtime.batch import BatchModel, BatchRecognizer  # noqa: E402,F401
