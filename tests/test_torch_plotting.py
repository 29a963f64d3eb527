"""The port's training figures (utils/plotting.py): ``expand_by_duration``
against the JAX package's, ``plot_mel``/``save_mel_plot`` writing a PNG,
and the single logged skip where matplotlib does not import (the card has
no matplotlib)."""

import logging
import sys

import numpy as np
import pytest

from expressive_fastspeech2_mandarin_tpu.utils import plotting as jplot
from expressive_fastspeech2_mandarin_tpu_torch.utils import plotting as tplot

PNG = b"\x89PNG\r\n\x1a\n"


@pytest.mark.parametrize("durations", [[1, 2, 3, 0], [0, 0, 0, 0],
                                       [2.0, -1.0, 3.7, 1.0], [5, 1, 1, 1]])
def test_expand_by_duration_matches_jax(durations):
    values = np.array([0.5, -1.0, 2.0, 3.0], np.float32)
    d = np.array(durations)
    ours = tplot.expand_by_duration(values, d)
    np.testing.assert_array_equal(ours, jplot.expand_by_duration(values, d))
    assert ours.dtype == values.dtype


def _panels(rng):
    mel = rng.standard_normal((80, 40)).astype(np.float32)
    pitch = rng.standard_normal(40).astype(np.float32)
    energy = rng.standard_normal(40).astype(np.float32)
    return [(mel, pitch, energy), (mel[:, :30], pitch[:30], None)]


def test_plot_mel_and_save_mel_plot_write_png(tmp_path):
    rng = np.random.default_rng(0)
    stats = [-2.0, 3.0, 200.0, 40.0, -1.5, 2.5]
    fig = tplot.plot_mel(_panels(rng), stats, ["Synthesized",
                                               "Ground truth"])
    assert len(fig.axes) == 5  # two mels, two pitch and one energy overlay
    tplot.save_figure(str(tmp_path / "fig.png"), fig)
    assert tplot.save_mel_plot(str(tmp_path / "mel.png"),
                               [(_panels(rng)[0][0], None, None)], None,
                               ["Synthesized"])
    for name in ("fig.png", "mel.png"):
        assert (tmp_path / name).read_bytes()[:8] == PNG


def test_without_matplotlib_figures_are_skipped_and_logged_once(
        tmp_path, monkeypatch, caplog):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    monkeypatch.setattr(tplot, "_skip_logged", False)
    rng = np.random.default_rng(1)
    with caplog.at_level(logging.WARNING, logger=tplot.__name__):
        assert tplot.plot_mel(_panels(rng)) is None
        assert not tplot.save_mel_plot(str(tmp_path / "mel.png"),
                                       _panels(rng))
    assert not (tmp_path / "mel.png").exists()
    skips = [r for r in caplog.records if "figures skipped" in r.message]
    assert len(skips) == 1
