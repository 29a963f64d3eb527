"""Mel, pitch and energy figures on the host; the JAX package's
``utils/plotting.py``.

matplotlib is imported at the first figure, not with the module: where it
does not import, ``plot_mel`` returns None, ``save_mel_plot`` writes
nothing and returns False, and the skip is logged once per process.
"""

from __future__ import annotations

import logging

import numpy as np

logger = logging.getLogger(__name__)
_skip_logged = False


def pyplot():
    """matplotlib's pyplot on the Agg backend, or None (the skip logged
    once) where matplotlib does not import."""
    global _skip_logged
    try:
        import matplotlib

        matplotlib.use("Agg")
        from matplotlib import pyplot as plt
    except ImportError as e:
        if not _skip_logged:
            logger.warning("figures skipped: matplotlib does not import "
                           "(%s)", e)
            _skip_logged = True
        return None
    return plt


def expand_by_duration(values: np.ndarray, durations: np.ndarray
                       ) -> np.ndarray:
    """Phoneme-level values → frame-level by repetition."""
    return np.repeat(values, np.maximum(durations.astype(int), 0))


def plot_mel(
    data: list[tuple[np.ndarray, np.ndarray | None, np.ndarray | None]],
    stats: list[float] | None = None,
    titles: list[str] | None = None,
):
    """One panel per (mel (n_mels, T), pitch (T,) or None, energy or None)
    of ``data``, pitch and energy drawn over the mel where ``stats``
    (pitch min, max, mean, std, energy min, max) is given; the figure, or
    None without matplotlib."""
    plt = pyplot()
    if plt is None:
        return None
    fig, axes = plt.subplots(len(data), 1, squeeze=False)
    titles = titles or [None] * len(data)
    if stats is not None:
        p_min, p_max, p_mean, p_std, e_min, e_max = stats
        p_min = p_min * p_std + p_mean
        p_max = p_max * p_std + p_mean

    for i, (mel, pitch, energy) in enumerate(data):
        ax = axes[i][0]
        ax.imshow(mel, origin="lower", aspect="auto")
        ax.set_ylim(0, mel.shape[0])
        if titles[i]:
            ax.set_title(titles[i], fontsize="medium")
        ax.tick_params(labelsize="x-small", left=False, labelleft=False)
        if pitch is not None and stats is not None:
            ax1 = fig.add_axes(ax.get_position(), anchor="W")
            ax1.set_facecolor("None")
            ax1.plot(pitch * p_std + p_mean, color="tomato")
            ax1.set_xlim(0, mel.shape[1])
            ax1.set_ylim(0, p_max)
            ax1.set_ylabel("F0", color="tomato")
            ax1.tick_params(labelsize="x-small", colors="tomato",
                            bottom=False, labelbottom=False)
        if energy is not None and stats is not None:
            ax2 = fig.add_axes(ax.get_position(), anchor="W")
            ax2.set_facecolor("None")
            ax2.plot(energy, color="darkviolet")
            ax2.set_xlim(0, mel.shape[1])
            ax2.set_ylim(e_min, e_max)
            ax2.set_ylabel("Energy", color="darkviolet")
            ax2.yaxis.set_label_position("right")
            ax2.tick_params(labelsize="x-small", colors="darkviolet",
                            bottom=False, labelbottom=False, left=False,
                            labelleft=False, right=True, labelright=True)
    return fig


def save_figure(path: str, fig) -> None:
    """Write ``fig`` to ``path`` and close it."""
    fig.savefig(path)
    pyplot().close(fig)


def save_mel_plot(path: str, *args, **kwargs) -> bool:
    """``plot_mel(*args, **kwargs)`` written to ``path``; False, and
    nothing written, without matplotlib."""
    fig = plot_mel(*args, **kwargs)
    if fig is None:
        return False
    save_figure(path, fig)
    return True
