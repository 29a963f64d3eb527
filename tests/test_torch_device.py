"""The port's entry points run on the card unless the caller asks for the
CPU; without a card they raise instead of falling back."""

import pytest
import torch

from expressive_fastspeech2_mandarin_tpu_torch.config import Config
from expressive_fastspeech2_mandarin_tpu_torch.device import resolve_device
from expressive_fastspeech2_mandarin_tpu_torch.models import FastSpeech2
from expressive_fastspeech2_mandarin_tpu_torch.synth import Synthesizer

torch.set_num_threads(2)


def _fs2_state():
    cfg = Config()
    return FastSpeech2(cfg.model, cfg.preprocess).state_dict()


def test_synthesizer_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    state = _fs2_state()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Synthesizer(Config(), state)
    with pytest.raises(RuntimeError):
        Synthesizer(Config(), state, device="cuda")
    synth = Synthesizer(Config(), state, device="cpu")
    assert next(synth.model.parameters()).device.type == "cpu"


def test_resolve_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(RuntimeError):
        resolve_device("cuda:0")
