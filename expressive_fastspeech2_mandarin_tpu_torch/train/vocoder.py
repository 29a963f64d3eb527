"""HiFi-GAN vocoder training, the GAN recipe; the JAX package's
``train/vocoder.py``, context and paired (GTA) modes.

MPD + MSD discriminators, LSGAN adversarial losses, feature matching (×2),
45× full-band mel L1, two AdamW(2e-4, (0.8, 0.99), weight decay 0.01)
optimizers with the learning rate ×0.999 every 1000 updates (staircase).

* **Frame-exact segment windows** (context mode, from waveforms). Each
  utterance is reflect-padded by n_fft/2 once on the host; an example is a
  ``segment + n_fft - hop`` sample context window cut at a frame
  boundary, from which the device computes ``segment/hop`` mel frames
  with no further padding — the rows of the full-utterance mel — while
  ``context[n_fft/2 : n_fft/2 + segment]`` is the waveform target.
* **Paired mode** (the GTA fine-tuning recipe, JAX ``:513-660``): an
  example is ``segment/hop`` rows of a mel from disk and the
  ``segment`` samples they frame. ``export_gta_mels`` writes FastSpeech2's
  teacher-forced mels from a checkpoint of the port's trainer,
  ``load_paired_corpus`` pairs them with the wavs trimmed as the feature
  extractor trimmed them (mel row k at sample k·hop), and
  ``train_vocoder(pairs=...)`` fine-tunes the generator on the mels it
  will be given at synthesis.
* **One generator forward a step**, in JAX's order (``:277-335`` there):
  the generator's forward keeps its graph; the discriminators take their
  update on the detached ŷ; the generator's losses are taken against the
  *updated* discriminators and back-propagated into the generator alone
  (``backward(inputs=...)``), through the graph of that one forward.
* The generator runs its plain path (``Generator.forward(fast=False)``):
  the JAX trainer runs ``apply_generator(fast=False)``, and the MRF
  kernel has no backward.
* **Losses and weight-norm statistics in float32**; with ``amp_dtype =
  "bfloat16"`` the generator's and the discriminators' convs run in bf16
  on bf16 casts of the float32 parameters.

Deviations from the published recipe, the JAX package's own: the loss mel
frames a segment with the Tacotron centre padding (33 frames per 8192
samples, not 32), the convention of the generator's input mels; the first
MSD scale has weight norm, not spectral norm.

With ``steps_per_call`` > 1 the loop runs chunks of that many steps, as
the JAX package's lax.scan chunks do: a chunk's steps are the same eager
steps, on the same windows, as one by one; the cadences are checked when
a chunk ends (``step % max(every, spc) < spc``), a chunk logs its steps'
mean losses, and the last chunk runs whole, so the run may end past
``total_steps``, as JAX's does. The JAX package's retry of a remote TPU's
transient dispatch errors is not here.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from collections.abc import Callable
from typing import NamedTuple

import numpy as np
import torch

from ..config import BucketConfig, Config, MelConfig
from ..data import BucketedDataset, PreprocessedCorpus
from ..device import resolve_device
from ..dsp.stft import MelSTFT
from ..models import FastSpeech2
from ..models.hifigan import Generator, save_generator_npz
from ..models.hifigan_disc import (
    MPD,
    MSD,
    discriminator_loss,
    feature_matching_loss,
    fold_weight_norm,
    generator_adv_loss,
    generator_weight_norm,
)
from ..preprocess.preprocessor import get_alignment
from ..preprocess.textgrid import read_textgrid
from ..utils.wav import load_wav
from .loop import stage_batch
from .state import CheckpointManager


@dataclasses.dataclass
class VocoderTrainState:
    gen: Generator               # weight-norm parameterized
    mpd: MPD
    msd: MSD
    opt_g: torch.optim.AdamW
    opt_d: torch.optim.AdamW
    step: int = 0


class VocoderLossReport(NamedTuple):
    gen_total: torch.Tensor
    disc: torch.Tensor
    mel_l1: torch.Tensor
    fm: torch.Tensor
    adv: torch.Tensor

    def as_dict(self) -> dict[str, float]:
        return {k: float(v) for k, v in self._asdict().items()}


def chunk_mean(reports: list[VocoderLossReport]) -> VocoderLossReport:
    """A chunk's report: each loss's mean over its steps, as the JAX
    package's scanned step returns it."""
    if len(reports) == 1:
        return reports[0]
    return VocoderLossReport(*(torch.stack(xs).mean()
                               for xs in zip(*reports)))


def _discriminator_params(state: VocoderTrainState) -> dict:
    return {**{f"mpd.{n}": p for n, p in state.mpd.named_parameters()},
            **{f"msd.{n}": p for n, p in state.msd.named_parameters()}}


def vocoder_lr(cfg: Config, count: int) -> float:
    """The learning rate of the ``count``-th update (counted from 0):
    ``optax.exponential_decay(staircase=True)`` read before the update, as
    optax reads it."""
    vcfg = cfg.vocoder_train
    return vcfg.learning_rate * vcfg.lr_decay ** (count
                                                  // vcfg.lr_decay_steps)


def make_vocoder_optimizers(cfg: Config, gen: Generator, mpd: MPD, msd: MSD
                            ) -> tuple[torch.optim.AdamW, torch.optim.AdamW]:
    """AdamW for the generator and for both discriminators together:
    ``optax.adamw`` (eps 1e-8, no eps_root; the decay on the parameter
    before the update, both are). The learning rate is set from
    ``vocoder_lr`` before every update."""
    vcfg = cfg.vocoder_train

    def adamw(params):
        return torch.optim.AdamW(params, lr=vcfg.learning_rate,
                                 betas=vcfg.adam_betas, eps=1e-8,
                                 weight_decay=vcfg.weight_decay)

    return (adamw(gen.parameters()),
            adamw([*mpd.parameters(), *msd.parameters()]))


def init_vocoder_train_state(cfg: Config, device: torch.device,
                             init_generator_params: dict | None = None
                             ) -> VocoderTrainState:
    """A fresh GAN state from ``vocoder_train.seed``. The generator's conv
    kernels are drawn N(0, 0.01) (the recipe's init_weights; biases keep
    torch's default init), or taken from ``init_generator_params``, a
    folded generator state dict (a ``generator.npz`` or a reference
    checkpoint through ``interop.torch_ckpt.load_vocoder_state``), to
    fine-tune; the discriminators always start fresh."""
    vcfg = cfg.vocoder_train
    voc = cfg.model.vocoder
    n_mels = cfg.preprocess.mel.n_mel_channels
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(vcfg.seed)
        if init_generator_params is None:
            init_generator_params = Generator(voc, n_mels).state_dict()
            for name, t in init_generator_params.items():
                if t.ndim == 3:  # conv kernels
                    t.normal_(0.0, 0.01)
        gen = Generator(voc, n_mels, weight_norm=True)
        mpd = MPD(vcfg.mpd_periods)
        msd = MSD(vcfg.msd_scales)
    gen.load_state_dict(generator_weight_norm(
        {k: torch.as_tensor(v).float()
         for k, v in init_generator_params.items()}), strict=True)
    gen, mpd, msd = (m.to(device) for m in (gen, mpd, msd))
    return VocoderTrainState(gen, mpd, msd,
                             *make_vocoder_optimizers(cfg, gen, mpd, msd))


# ---------------------------------------------------------------------------
# Checkpoints: the optimizers' state by parameter name


def _adam_state(opt: torch.optim.AdamW, named: dict) -> dict:
    count, mu, nu = 0, {}, {}
    for name, p in named.items():
        st = opt.state.get(p)
        if st:
            count = int(st["step"])
            mu[name], nu[name] = st["exp_avg"], st["exp_avg_sq"]
    return {"count": count, "exp_avg": mu, "exp_avg_sq": nu}


def _load_adam_state(opt: torch.optim.AdamW, named: dict, saved: dict
                     ) -> None:
    opt.state.clear()
    if not saved["count"]:
        return
    for name, p in named.items():
        opt.state[p] = {
            "step": torch.tensor(float(saved["count"])),
            "exp_avg": saved["exp_avg"][name].to(p.device, p.dtype).clone(),
            "exp_avg_sq": saved["exp_avg_sq"][name].to(
                p.device, p.dtype).clone()}


def vocoder_checkpoint(state: VocoderTrainState) -> dict:
    """The state as a dict of tensors: the three modules' state dicts, each
    optimizer's update count and moments by parameter name (the
    discriminators' under ``mpd.``/``msd.``), and the step."""
    return {"gen": state.gen.state_dict(), "mpd": state.mpd.state_dict(),
            "msd": state.msd.state_dict(),
            "opt_g": _adam_state(state.opt_g,
                                 dict(state.gen.named_parameters())),
            "opt_d": _adam_state(state.opt_d, _discriminator_params(state)),
            "step": state.step}


def load_vocoder_checkpoint(state: VocoderTrainState, ckpt: dict) -> None:
    """A ``vocoder_checkpoint`` dict (or ``interop.from_jax.
    vocoder_train_state_from_jax``'s) into ``state`` in place."""
    state.gen.load_state_dict(ckpt["gen"], strict=True)
    state.mpd.load_state_dict(ckpt["mpd"], strict=True)
    state.msd.load_state_dict(ckpt["msd"], strict=True)
    _load_adam_state(state.opt_g, dict(state.gen.named_parameters()),
                     ckpt["opt_g"])
    _load_adam_state(state.opt_d, _discriminator_params(state),
                     ckpt["opt_d"])
    state.step = int(ckpt["step"])


# ---------------------------------------------------------------------------
# Mels


def context_samples(cfg: Config) -> int:
    """Samples of one example's context window: the segment and an
    (n_fft - hop) halo."""
    stft = cfg.preprocess.stft
    return (cfg.vocoder_train.segment_size
            + stft.filter_length - stft.hop_length)


def logmel_from_context(context: torch.Tensor, stft: MelSTFT,
                        n_frames: int) -> torch.Tensor:
    """(B, ctx) context windows → (B, n_frames, n_mels) log-mel with no
    further padding: the halo carries the reflect padding, so these rows
    are the full-utterance ``mel_energy`` rows of the window's frames."""
    frames = context.unfold(1, stft.n_fft, stft.hop)[:, :n_frames]
    return stft.log_mel(stft.frames_magnitude(frames))


def vocoder_mels(cfg: Config, device: torch.device
                 ) -> tuple[MelSTFT, MelSTFT]:
    """(the generator-input MelSTFT, in the acoustic model's band; the
    full-band loss MelSTFT, hifigan/config.json's fmax_for_loss null) on
    ``device``."""
    pre = cfg.preprocess
    mel_in = MelSTFT(pre.stft, pre.mel, pre.audio.sampling_rate, device)
    mel_loss = MelSTFT(
        pre.stft, MelConfig(n_mel_channels=pre.mel.n_mel_channels,
                            mel_fmin=0.0, mel_fmax=None),
        pre.audio.sampling_rate, device)
    return mel_in, mel_loss


def loss_mel_of_wav(mel_loss: MelSTFT, wav: torch.Tensor) -> torch.Tensor:
    """The full-band loss log-mel of a bare (B, segment) waveform, framed
    with the centre padding (the same for y and ŷ)."""
    return mel_loss.log_mel(mel_loss.magnitude(wav))


Batch = torch.Tensor | dict[str, torch.Tensor]


def _mel_and_target(cfg: Config, mel_in: MelSTFT, batch: Batch,
                    device: torch.device):
    """(generator-input mel, waveform target) of a batch on ``device``: a
    paired batch's ``mel`` and ``wav``, or a context batch's mel rows and
    segment."""
    if isinstance(batch, dict):
        return batch["mel"].to(device), batch["wav"].to(device)
    batch = batch.to(device)
    pre = cfg.preprocess
    half = pre.stft.filter_length // 2
    seg = cfg.vocoder_train.segment_size
    mel = logmel_from_context(batch, mel_in, seg // pre.stft.hop_length)
    return mel, batch[:, half: half + seg]


def _amp(cfg: Config) -> Callable[[torch.Tensor], torch.Tensor]:
    """The cast of the convs' inputs: to bf16 under bf16 amp, else none
    (the batch's float32, or float64 for a float64 yardstick)."""
    if cfg.vocoder_train.amp_dtype == "bfloat16":
        return lambda t: t.to(torch.bfloat16)
    return lambda t: t


def make_vocoder_val_step(cfg: Config, device: torch.device):
    """``val_step(gen, batch) -> float``: copy-synthesis full-band mel L1
    of the generator alone on one batch, of context windows or, paired,
    of ``{"mel", "wav"}``."""
    mel_in, mel_loss = vocoder_mels(cfg, device)
    amp = _amp(cfg)

    @torch.no_grad()
    def val_step(gen: Generator, batch: Batch) -> float:
        mel, y = _mel_and_target(cfg, mel_in, batch, device)
        wav = gen(amp(mel), fast=False).to(y.dtype)
        return float(torch.mean(torch.abs(loss_mel_of_wav(mel_loss, y)
                                          - loss_mel_of_wav(mel_loss, wav))))

    return val_step


STEP_SPANS = ("generator_forward", "discriminator_update",
              "generator_update")


def make_vocoder_train_step(cfg: Config, device: torch.device,
                            mark: Callable[[str], None] | None = None):
    """``train_step(state, batch) -> VocoderLossReport``, one GAN update of
    ``state`` in place; ``batch`` is (B, segment + n_fft - hop) float32
    context windows (float64 windows and a float64 state give a float64
    step, the yardstick of the float32 one) or, in paired mode, ``{"mel":
    (B, segment/hop, n_mels), "wav": (B, segment)}``, the mel taken as it
    is. After it, each parameter's ``.grad`` holds the gradient of its
    update: the discriminators' of their loss, the generator's of its loss
    against the updated discriminators.

    ``mark``, when given, is called with each name of ``STEP_SPANS`` as
    that span of the step has been issued (a timer records a CUDA event
    there; nothing synchronizes)."""
    vcfg = cfg.vocoder_train
    mark = mark or (lambda _name: None)
    mel_in, mel_loss = vocoder_mels(cfg, device)
    amp = _amp(cfg)

    def train_step(state: VocoderTrainState,
                   batch: Batch) -> VocoderLossReport:
        for opt in (state.opt_g, state.opt_d):
            for group in opt.param_groups:
                group["lr"] = vocoder_lr(cfg, state.step)
        mel, y = _mel_and_target(cfg, mel_in, batch, device)

        # One generator forward; its graph is kept for the generator's
        # update after the discriminators'.
        y_g = state.gen(amp(mel), fast=False).to(y.dtype)
        y_d = amp(y)
        mark("generator_forward")

        # The discriminators' update, real against the detached fake.
        y_g_d = amp(y_g.detach())
        real_p, _ = state.mpd(y_d)
        fake_p, _ = state.mpd(y_g_d)
        real_s, _ = state.msd(y_d)
        fake_s, _ = state.msd(y_g_d)
        disc = (discriminator_loss(real_p, fake_p)
                + discriminator_loss(real_s, fake_s))
        state.opt_d.zero_grad(set_to_none=True)
        disc.backward()
        state.opt_d.step()
        mark("discriminator_update")

        # The generator's losses against the updated discriminators.
        with torch.no_grad():
            _, real_fp = state.mpd(y_d)
            _, real_fs = state.msd(y_d)
            y_mel = loss_mel_of_wav(mel_loss, y)
        fake_p, fake_fp = state.mpd(amp(y_g))
        fake_s, fake_fs = state.msd(amp(y_g))
        adv = generator_adv_loss(fake_p) + generator_adv_loss(fake_s)
        fm = (feature_matching_loss(real_fp, fake_fp)
              + feature_matching_loss(real_fs, fake_fs))
        mel_l1 = torch.mean(torch.abs(y_mel - loss_mel_of_wav(mel_loss, y_g)))
        total = adv + fm + vcfg.mel_loss_weight * mel_l1
        state.opt_g.zero_grad(set_to_none=True)
        total.backward(inputs=list(state.gen.parameters()))
        state.opt_g.step()
        state.step += 1
        mark("generator_update")
        return VocoderLossReport(total.detach(), disc.detach(),
                                 mel_l1.detach(), fm.detach(), adv.detach())

    return train_step


# ---------------------------------------------------------------------------
# Host-side segment sampling


class SegmentSampler:
    """Random frame-aligned context windows from in-memory utterances.

    Each utterance is reflect-padded by n_fft/2 once (the full-utterance
    STFT padding), so every window gives the frames the preprocessor
    would; an utterance shorter than a window is zero-padded at its tail
    first."""

    def __init__(self, cfg: Config, wavs: list[np.ndarray], seed: int = 0):
        pre = cfg.preprocess
        self.ctx = context_samples(cfg)
        self.hop = pre.stft.hop_length
        half = pre.stft.filter_length // 2
        self.padded = []
        for w in wavs:
            w = np.asarray(w, np.float32)
            need = self.ctx - (len(w) + 2 * half)
            if need > 0:
                w = np.pad(w, (0, need))
            if len(w) < half + 1:
                w = np.pad(w, (0, half + 1 - len(w)))
            self.padded.append(np.pad(w, (half, half), mode="reflect"))
        self.rng = np.random.default_rng(seed)

    def sample(self, batch_size: int) -> np.ndarray:
        out = np.empty((batch_size, self.ctx), np.float32)
        idx = self.rng.integers(0, len(self.padded), batch_size)
        for i, j in enumerate(idx):
            w = self.padded[j]
            max_f = (len(w) - self.ctx) // self.hop
            f = int(self.rng.integers(0, max_f + 1))
            out[i] = w[f * self.hop: f * self.hop + self.ctx]
        return out


def load_corpus_wavs(wav_dir: str, sampling_rate: int,
                     limit: int | None = None) -> list[np.ndarray]:
    """Every .wav under ``wav_dir`` (recursive, in sorted order), resampled to
    ``sampling_rate`` and peak-normalized to 0.95 as the corpus prep
    does."""
    paths = []
    for root, dirs, files in os.walk(wav_dir):
        dirs.sort()  # a walk order that is the same on every filesystem
        for f in sorted(files):
            if f.endswith(".wav"):
                paths.append(os.path.join(root, f))
    if limit:
        paths = paths[:limit]
    if not paths:
        raise FileNotFoundError(f"no .wav files under {wav_dir}")
    wavs = []
    for p in paths:
        audio, _sr = load_wav(p, sr=sampling_rate)
        peak = np.abs(audio).max()
        if peak > 0:
            audio = 0.95 * audio / peak
        wavs.append(audio.astype(np.float32))
    return wavs


# Seed offset of the validation windows: a stream of its own, the same in
# every run and resume of one configuration.
VAL_SEED_OFFSET = 999983


def train_vocoder(cfg: Config, wavs: list[np.ndarray] | None, out_dir: str,
                  total_steps: int | None = None,
                  init_generator_params: dict | None = None,
                  pairs: list | None = None,
                  device: str | torch.device = "cuda",
                  log=print) -> VocoderTrainState:
    """Run the GAN loop to ``total_steps`` (``vocoder_train.total_step``
    by default) on ``device``, the card unless the caller asks for the CPU:
    in context mode on ``wavs``, or in paired mode on ``pairs`` (from
    ``load_paired_corpus``) when they are given.

    Under ``out_dir``: checkpoints ``ckpt/<step>.pt`` every ``save_step``
    and at the end (the latest is resumed, with the sampler's seed moved on
    by the step, so a resumed run draws new windows); ``metrics.jsonl``
    with the five losses every ``log_step`` and the copy-synthesis mel L1
    of four fixed validation batches every ``val_step``; and the folded
    generator as ``generator.npz`` at the end. With ``steps_per_call``
    > 1, chunks of steps (the module's docstring)."""
    device = resolve_device(device)
    vcfg = cfg.vocoder_train
    total = total_steps or vcfg.total_step
    spc = max(1, vcfg.steps_per_call)
    os.makedirs(out_dir, exist_ok=True)
    ckpt = CheckpointManager(os.path.join(out_dir, "ckpt"))
    state = init_vocoder_train_state(cfg, device, init_generator_params)
    if ckpt.latest_step() is not None:
        load_vocoder_checkpoint(state, ckpt.load())
        log(f"restored vocoder step {state.step}")

    def make_sampler(seed: int):
        if pairs is not None:
            return PairedSegmentSampler(cfg, pairs, seed=seed)
        return SegmentSampler(cfg, wavs, seed=seed)

    def stage(a):
        if isinstance(a, dict):
            return {k: stage(v) for k, v in a.items()}
        t = torch.from_numpy(a)
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        return t

    sampler = make_sampler(vcfg.seed + state.step)
    step_fn = make_vocoder_train_step(cfg, device)
    val_fn = make_vocoder_val_step(cfg, device)
    val_sampler = make_sampler(vcfg.seed + VAL_SEED_OFFSET)
    val_batches = [stage(val_sampler.sample(vcfg.batch_size))
                   for _ in range(4)]

    t0 = time.time()
    with open(os.path.join(out_dir, "metrics.jsonl"), "a") as mf:
        while state.step < total:
            report = chunk_mean([
                step_fn(state, stage(sampler.sample(vcfg.batch_size)))
                for _ in range(spc)])
            step = state.step
            if step % max(vcfg.log_step, spc) < spc:
                rec = {"step": step, "time": time.time() - t0,
                       **report.as_dict()}
                mf.write(json.dumps(rec) + "\n")
                mf.flush()
                log(f"voc step {step}: gen {rec['gen_total']:.3f} "
                    f"mel {rec['mel_l1']:.3f} disc {rec['disc']:.3f}")
            if vcfg.val_step and step % max(vcfg.val_step, spc) < spc:
                v = float(np.mean([val_fn(state.gen, vb)
                                   for vb in val_batches]))
                mf.write(json.dumps({"step": step, "time": time.time() - t0,
                                     "val_mel_l1": round(v, 4)}) + "\n")
                mf.flush()
                log(f"voc val step {step}: copy-synthesis mel L1 {v:.3f}")
            if step % max(vcfg.save_step, spc) < spc or step >= total:
                ckpt.save_dict(step, vocoder_checkpoint(state))
    save_generator_npz(os.path.join(out_dir, "generator.npz"),
                       fold_weight_norm(state.gen.state_dict()))
    return state


# ---------------------------------------------------------------------------
# Paired (GTA) mode: the vocoder fine-tuned on the acoustic model's
# teacher-forced mels paired with the real waveforms (JAX :513-660).

LOG_MEL_PAD = float(np.log(1e-5))  # silence in log-clamp mel space


class PairedSegmentSampler:
    """Random frame-aligned (mel rows, waveform segment) pairs, the same
    ``np.random.default_rng`` draws as the JAX package's.

    ``pairs`` holds (mel (F, n_mels), wav (T,)) per utterance, mel row k
    framing the window centred at sample k·hop of ``wav``. An utterance
    shorter than a segment is padded with log-clamp silence
    (``LOG_MEL_PAD``) and zeros."""

    def __init__(self, cfg: Config, pairs, seed: int = 0):
        self.hop = cfg.preprocess.stft.hop_length
        self.seg = cfg.vocoder_train.segment_size
        self.n_frames = self.seg // self.hop
        self.n_mels = cfg.preprocess.mel.n_mel_channels
        self.pairs = []
        for mel, wav in pairs:
            mel = np.asarray(mel, np.float32)
            wav = np.asarray(wav, np.float32)
            if mel.shape[0] < self.n_frames:
                mel = np.pad(mel, ((0, self.n_frames - mel.shape[0]), (0, 0)),
                             constant_values=LOG_MEL_PAD)
            if len(wav) < self.seg:
                wav = np.pad(wav, (0, self.seg - len(wav)))
            self.pairs.append((mel, wav))
        self.rng = np.random.default_rng(seed)

    def sample(self, batch_size: int) -> dict[str, np.ndarray]:
        mels = np.empty((batch_size, self.n_frames, self.n_mels), np.float32)
        wavs = np.empty((batch_size, self.seg), np.float32)
        idx = self.rng.integers(0, len(self.pairs), batch_size)
        for i, j in enumerate(idx):
            mel, wav = self.pairs[j]
            f_max = min(mel.shape[0] - self.n_frames,
                        (len(wav) - self.seg) // self.hop)
            f = int(self.rng.integers(0, max(f_max, 0) + 1))
            mels[i] = mel[f: f + self.n_frames]
            wavs[i] = wav[f * self.hop: f * self.hop + self.seg]
        return {"mel": mels, "wav": wavs}


def load_paired_corpus(cfg: Config, mel_dir: str | None = None,
                       filenames=("train.txt",)) -> list:
    """(mel, trimmed wav) pairs of the corpus utterances listed in
    ``filenames``: the mels of ``mel_dir`` (a GTA export; an utterance
    without one is left out), else the corpus' ground-truth mels. Each wav
    is trimmed by its TextGrid as the feature extractor trimmed it, so mel
    row k stays at sample k·hop; raises ``FileNotFoundError`` when no pair
    is found."""
    pre = cfg.preprocess
    corpus = PreprocessedCorpus(pre.path.preprocessed_path)
    in_dir = os.path.join(pre.path.raw_path, pre.path.sub_dir_name)
    sr, hop = pre.audio.sampling_rate, pre.stft.hop_length
    pairs = []
    for filename in filenames:
        for utt in corpus.metadata(filename):
            if mel_dir:
                mel_path = os.path.join(
                    mel_dir, f"{utt.speaker}-mel-{utt.basename}.npy")
                if not os.path.exists(mel_path):
                    continue
                mel = np.load(mel_path)
            else:
                mel = corpus.mel(utt)
            tg_path = os.path.join(pre.path.preprocessed_path, "TextGrid",
                                   utt.speaker, f"{utt.basename}.TextGrid")
            wav_path = os.path.join(in_dir, utt.speaker,
                                    f"{utt.basename}.wav")
            if not (os.path.exists(tg_path) and os.path.exists(wav_path)):
                continue
            align = get_alignment(
                read_textgrid(tg_path).get_tier_by_name("phones"), sr, hop)
            wav, _ = load_wav(wav_path, sr)
            wav = wav[int(sr * align.start): int(sr * align.end)]
            pairs.append((mel, wav.astype(np.float32)))
    if not pairs:
        raise FileNotFoundError("no (mel, wav) pairs found — check "
                                "preprocessed_path/TextGrid and raw_path")
    return pairs


GTA_BATCH = 8


def export_gta_mels(cfg: Config, ckpt_dir: str, out_dir: str,
                    filenames=("train.txt", "val.txt"),
                    device: str | torch.device = "cuda", log=print) -> int:
    """Teacher-forced (ground-truth-aligned) postnet mels of every corpus
    utterance from the latest FastSpeech2 checkpoint of the port's trainer
    under ``ckpt_dir``, written as ``<out_dir>/<speaker>-mel-<basename>
    .npy`` with as many rows as the ground-truth mel; returns how many.
    The forward runs on ``device`` (the card unless the caller asks for the
    CPU) without dropout, under ``cfg.model.transformer.attention_impl``,
    with the corpus' durations, pitch and energy as targets, in batches of
    8 at the default buckets; a padded tail's repeated rows are written
    once."""
    device = resolve_device(device)
    corpus = PreprocessedCorpus(cfg.preprocess.path.preprocessed_path)
    model = FastSpeech2(cfg.model, cfg.preprocess, corpus.stats)
    ckpt = CheckpointManager(ckpt_dir).load()
    model.load_state_dict(ckpt["model"], strict=True)
    model.to(device).eval()
    log(f"GTA export from step {int(ckpt['step'])} checkpoint")

    os.makedirs(out_dir, exist_ok=True)
    seen: set[str] = set()
    for filename in filenames:
        ds = BucketedDataset(
            corpus, filename, batch_size=GTA_BATCH, buckets=BucketConfig(),
            max_seq_len=cfg.model.max_seq_len,
            symbol_table=cfg.preprocess.symbol_table)
        for batch, examples in ds.epoch_with_examples(shuffle=False):
            b = stage_batch(batch, device, "float32")
            with torch.inference_mode():
                out = model(b["speakers"], b["emotions"], b["arousals"],
                            b["valences"], b["texts"], b["src_lens"],
                            max_mel_len=batch["mels"].shape[1],
                            mel_lens=b["mel_lens"], p_targets=b["pitches"],
                            e_targets=b["energies"],
                            d_targets=b["durations"])
            mels = out.postnet_mel.float().cpu().numpy()
            for i, e in enumerate(examples):
                name = f"{e.utt.speaker}-mel-{e.utt.basename}.npy"
                if name in seen:
                    continue
                seen.add(name)
                np.save(os.path.join(out_dir, name),
                        mels[i, :int(batch["mel_lens"][i])])
    log(f"GTA export: {len(seen)} mels -> {out_dir}")
    return len(seen)
