"""Dropout for training: ``where(keep, x / keep_prob, 0)``, as the JAX
package's ``models/transformer.py:_dropout``.

Every dropout of the model goes through ``dropout``, and every draw through
``keep_mask``, from an explicit ``torch.Generator``: a run is reproducible
from the generator's state, and a test can replace ``keep_mask`` to feed
the port and the JAX package the same masks.

With a data-parallel ``layout`` (``parallel.Layout``) the mask is drawn at
the global batch's shape, from the generator every rank holds alike, and
the rank keeps its rows: the masks are a single process's over the same
global batch.
"""

from __future__ import annotations

import torch


def keep_mask(shape: torch.Size, keep_prob: float,
              generator: torch.Generator,
              device: torch.device) -> torch.Tensor:
    """Bool mask, True with probability ``keep_prob``."""
    return torch.rand(shape, generator=generator, device=device) < keep_prob


def dropout(x: torch.Tensor, rate: float,
            generator: torch.Generator | None, layout=None) -> torch.Tensor:
    """Zero each element with probability ``rate`` and scale the rest by
    ``1 / (1 - rate)``. No generator (inference) or a rate of 0 draws
    nothing and returns ``x``. ``x`` holds ``layout``'s rows of the global
    batch, when one is given."""
    if generator is None or rate == 0.0:
        return x
    keep = 1.0 - rate
    if layout is None:
        mask = keep_mask(x.shape, keep, generator, x.device)
    else:
        rows = x.shape[0] * layout.data_parallel
        mask = keep_mask(torch.Size((rows, *x.shape[1:])), keep, generator,
                         x.device)[layout.rows(rows)]
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype,
                                                   device=x.device))
