"""One training, evaluation or synthesis step; the JAX package's
``train/step.py``.

``train_step``: teacher-forced forward in training mode (dropout from the
state's generator, the postnet's BatchNorm on batch statistics) → loss →
gradients → clip, Adam, Noam update, in place. With ``amp_dtype =
"bfloat16"`` the forward and backward run on a bf16 copy of the float32
master parameters; the gradient flows back through the cast, so it reaches
the masters in float32, and the loss stays float32. Under
``attention_impl="flash"`` (or ``"auto"`` past 2048 frames) the bf16
forward and backward run the bf16 flash kernels, as the JAX package's bf16
step runs the TPU kernel on bf16 q, k, v; evaluation and synthesis run the
float32 model, so the float32 forward kernel.

A batch is a dict of tensors on the model's device: speakers, emotions,
arousals, valences (B,), texts (B, S), src_lens (B,), mels (B, T, 80) —
float32, bfloat16, or int16 with per-utterance ``mel_scale`` and
``mel_offset`` (B,) — mel_lens (B,), pitches, energies and durations
(B, S).

Under a data-parallel ``layout`` (``parallel.Layout``) a batch holds the
rank's rows of the global batch; ``loss_and_grads`` sums the ranks'
gradients (one flat, bucketed float32 all-reduce) and their loss terms, so
that every rank holds the global batch's loss and gradient, as the JAX
package's step on a sharded batch returns them; ``eval_step``'s losses are
the global ones too.

``make_train_step``, ``make_train_multi_step``, ``make_eval_step`` and
``make_synth_step`` are the JAX package's compiled steps
(``train/step.py:93-165`` there): on the card one CUDA graph per bucket
on the state's graphs (``graphs.Graphs``), the multi step ``n_steps``
optimizer steps over a stacked batch in one replay, as JAX's
``lax.scan``; on the CPU the same steps run eagerly, as ``jax.jit`` runs
them there. The eval and synth graphs read the weights and BatchNorm's
running statistics at the addresses the train graphs write them, so they
share the state's graphs: a train replay writes them in place and keeps
every graph, an eager write drops them all.

Under a data-parallel layout the choice is the layout's
(``parallel.Layout.capturable``), made when a step is made, never after a
failed capture. Over NCCL the train, multi and eval steps are compiled as
they are in one process, their collectives inside the graph: the
gradients' sum, the global loss terms and BatchNorm's global moments,
which XLA likewise puts inside JAX's compiled step. Every rank then
captures at the same call, and the capture's warm-up (``graphs``) runs the
collectives eagerly first, so that no capture is a process's first NCCL
call. Gloo's collectives cannot be captured, so over gloo the steps run
eagerly. The synth step, which rank 0 alone calls for its samples and
which holds no collective, is compiled on an owner of its own, as JAX's
main host compiles its sample step on host-local parameters: its
captures and drops never touch the graphs every rank holds alike.
"""

from __future__ import annotations

import torch
from torch.func import functional_call

from ..config import Config
from ..graphs import Graphs, module_tensors
from ..models import FastSpeech2
from ..parallel.mesh import Layout, all_reduce_
from .loss import LossReport, fastspeech2_loss
from .state import TrainState

Batch = dict[str, torch.Tensor]


def _mel_targets(batch: Batch) -> torch.Tensor:
    """Float32 mel targets from the staged encoding: int16 per-utterance
    affine quantization (``mel_scale``/``mel_offset`` present), bf16, or
    float32 as it is."""
    mels = batch["mels"].float()
    if "mel_scale" in batch:
        # encode: q = rint((m - lo) / scale) - 32768; offset = lo + 32768 scale
        mels = (mels * batch["mel_scale"][:, None, None]
                + batch["mel_offset"][:, None, None])
    return mels


def _loss(model: FastSpeech2, batch: Batch, cfg: Config, *,
          training: bool, generator: torch.Generator | None = None,
          params: dict[str, torch.Tensor] | None = None,
          layout: Layout | None = None) -> LossReport:
    """Teacher-forced forward and loss; ``params`` replaces the model's
    parameters (the bf16 copy)."""
    mels = _mel_targets(batch)
    args = (batch["speakers"], batch["emotions"], batch["arousals"],
            batch["valences"], batch["texts"], batch["src_lens"])
    kwargs = dict(max_mel_len=mels.shape[1], mel_lens=batch["mel_lens"],
                  p_targets=batch["pitches"], e_targets=batch["energies"],
                  d_targets=batch["durations"], training=training,
                  generator=generator, layout=layout)
    out = (model(*args, **kwargs) if params is None
           else functional_call(model, params, args, kwargs))
    return fastspeech2_loss(
        out, mels, batch["pitches"], batch["energies"], batch["durations"],
        pitch_feature_level=cfg.preprocess.pitch.feature,
        energy_feature_level=cfg.preprocess.energy.feature, layout=layout)


def _global(report: LossReport, layout: Layout | None) -> LossReport:
    """The terms summed over the ranks (as they are without a layout)."""
    if layout is None:
        return report
    return LossReport(*layout.sum(torch.stack(report)).unbind())


def loss_and_grads(model: FastSpeech2, batch: Batch, cfg: Config,
                   generator: torch.Generator, layout: Layout | None = None
                   ) -> tuple[LossReport, list[torch.Tensor]]:
    """The training-mode loss and the float32 gradient of every parameter,
    in ``model.named_parameters()`` order, the global batch's under
    ``layout``. BatchNorm's running statistics are updated in place."""
    amp = getattr(torch, cfg.train.amp_dtype)
    named = dict(model.named_parameters())
    params = None
    if amp != torch.float32:
        params = {n: p.to(amp) if p.is_floating_point() else p
                  for n, p in named.items()}
    report = _loss(model, batch, cfg, training=True, generator=generator,
                   params=params, layout=layout)
    grads = torch.autograd.grad(report.total, list(named.values()),
                                allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for g, p in zip(grads, named.values())]
    if layout is not None:
        all_reduce_(grads)
    return _global(LossReport(*(x.detach() for x in report)), layout), grads


def _update(state: TrainState, batch: Batch, cfg: Config) -> LossReport:
    report, grads = loss_and_grads(state.model, batch, cfg, state.generator,
                                   state.layout)
    state.optimizer.step(grads)
    return report


def train_step(state: TrainState, batch: Batch, cfg: Config) -> LossReport:
    """One call = one micro-step: gradients, then the optimizer (which
    updates on every ``grad_acc_step``-th call); ``state.step`` counts
    calls, as the JAX package's ``TrainState.step``; data-parallel under
    ``state.layout``. Eager: ``make_train_step`` compiles it."""
    report = _update(state, batch, cfg)
    state.step += 1
    return report


def stack_batches(batches: list[Batch]) -> Batch:
    """Same-bucket batches stacked on a leading (n, ...) axis, the multi
    step's input."""
    return {k: torch.stack([b[k] for b in batches]) for k in batches[0]}


def mean_report(reports: list[LossReport]) -> LossReport:
    """Each loss term's mean over steps, as the JAX package's scanned step
    returns a chunk's report."""
    return LossReport(*(torch.stack(xs).mean() for xs in zip(*reports)))


def train_graphs(state: TrainState) -> Graphs:
    """The state's graphs: they read and write its parameters, buffers and
    optimizer state and draw from its dropout generator."""
    if state.graphs is None:
        state.graphs = Graphs(
            state=lambda: [*module_tensors(state.model),
                           *state.optimizer.tensors()],
            generators=lambda: [state.generator])
    return state.graphs


def _eager(state: TrainState) -> bool:
    """Whether the state's layout keeps its steps eager: its collectives
    cannot be captured (gloo)."""
    return state.layout is not None and not state.layout.capturable


def make_train_step(state: TrainState, cfg: Config):
    """``step(batch) -> LossReport``: ``train_step`` on ``state`` (the JAX
    package's ``make_train_step``, the state updated in place). On the
    card one CUDA graph per bucket replays the forward, the backward, the
    collectives of a capturable layout and the optimizer; on CPU tensors,
    and under a gloo layout, the eager step runs."""
    if _eager(state):
        return lambda batch: train_step(state, batch, cfg)
    compiled = train_graphs(state).jit(
        lambda batch: _update(state, batch, cfg), mutates=True)

    def step(batch: Batch) -> LossReport:
        report = compiled(batch)
        state.step += 1
        return report

    return step


def make_train_multi_step(state: TrainState, cfg: Config, n_steps: int):
    """``multi_step(batches) -> LossReport``: ``n_steps`` train steps over
    a batch stacked on a leading (n_steps, ...) axis (``stack_batches``),
    returning their mean report on the device (the JAX package's
    ``make_train_multi_step``, a ``lax.scan`` there). On the card the
    chunk is one replay of one CUDA graph per bucket, under a capturable
    layout too; on CPU tensors, and under a gloo layout, the steps run
    eagerly one by one."""

    def body(batches: Batch) -> LossReport:
        return mean_report([
            _update(state, {k: v[i] for k, v in batches.items()}, cfg)
            for i in range(n_steps)])

    run = (body if _eager(state)
           else train_graphs(state).jit(body, mutates=True))

    def multi_step(batches: Batch) -> LossReport:
        report = run(batches)
        state.step += n_steps
        return report

    return multi_step


@torch.no_grad()
def eval_step(model: FastSpeech2, batch: Batch, cfg: Config,
              layout: Layout | None = None) -> LossReport:
    """Teacher-forced deterministic forward and loss."""
    return _global(_loss(model, batch, cfg, training=False, layout=layout),
                   layout)


@torch.no_grad()
def synth_step(model: FastSpeech2, batch: Batch, max_mel_len: int,
               p_control: float = 1.0, e_control: float = 1.0,
               d_control: float = 1.0):
    """Free-running inference forward: (postnet mel, mel_lens,
    durations)."""
    out = model(batch["speakers"], batch["emotions"], batch["arousals"],
                batch["valences"], batch["texts"], batch["src_lens"],
                max_mel_len=max_mel_len, p_control=p_control,
                e_control=e_control, d_control=d_control)
    return out.postnet_mel, out.mel_lens, out.durations_rounded


def make_eval_step(state: TrainState, cfg: Config):
    """``eval(batch) -> LossReport``: ``eval_step`` on ``state.model``
    (the JAX package's ``make_eval_step``), the global losses under a
    layout; on the card one CUDA graph per bucket on the state's graphs,
    eager on CPU tensors and under a gloo layout."""
    def evaluate(batch: Batch) -> LossReport:
        return eval_step(state.model, batch, cfg, state.layout)

    return evaluate if _eager(state) else train_graphs(state).jit(evaluate)


def make_synth_step(state: TrainState):
    """``synth(batch, max_mel_len) -> (postnet mel, mel_lens,
    durations)``: ``synth_step`` on ``state.model`` (the JAX package's
    ``make_synth_step``); on the card one CUDA graph per batch shape and
    mel bucket, eager on CPU tensors. In one process it is compiled on the
    state's graphs; under a layout, where one rank alone calls it, on
    graphs of its own that read the same weights."""
    def synth(batch: Batch, max_mel_len: int):
        return synth_step(state.model, batch, max_mel_len)

    owner = (train_graphs(state) if state.layout is None
             else Graphs(state=lambda: module_tensors(state.model)))
    return owner.jit(synth)
