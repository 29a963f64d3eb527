"""The port's HiFi-GAN vocoder training (models/hifigan_disc.py,
train/vocoder.py) against the JAX package's, on the CPU in float32, at the
small configuration of tests/test_vocoder_train.py (batch 2, segment 1024,
MPD (2, 3), MSD ×2, 32 initial channels, K (3,)).

The JAX states are made from numpy (their tree from ``jax.eval_shape`` of
the JAX package's ``init_vocoder_train_state``, the values from seeds) and
carried across by ``interop.vocoder_train_state_from_jax``; one JAX step
first gives both AdamW states non-zero moments.

Bounds: the five losses 1e-5 relative (float32 sums in another order);
each gradient within 1e-3 · max|g| of its tensor (the JAX gradient read
from the step's first moment, g = (mu' − b1·mu) / (1 − b1)); after the
step, the parameters within 1e-6 where |g| > 1e-3 · max|g| (AdamW's update
is lr · sign for a gradient that is float-order noise, as in
tests/test_torch_train.py); MPD and MSD logits and feature maps 2e-5 and
3e-5 (tests/test_vocoder_train.py's bounds against its torch oracle).
"""

import dataclasses
import functools
import json

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from expressive_fastspeech2_mandarin_tpu import config as jcfg
from expressive_fastspeech2_mandarin_tpu.dsp.stft import MelSTFT as JaxMelSTFT
from expressive_fastspeech2_mandarin_tpu.models.hifigan import (
    apply_generator,
    load_generator_npz as jax_load_generator_npz,
)
from expressive_fastspeech2_mandarin_tpu.models.hifigan_disc import (
    apply_mpd,
    apply_msd,
    fold_weight_norm as jax_fold_weight_norm,
    init_mpd,
    init_msd,
)
from expressive_fastspeech2_mandarin_tpu.train import vocoder as jvoc
from expressive_fastspeech2_mandarin_tpu_torch import config as tcfg
from expressive_fastspeech2_mandarin_tpu_torch.dsp import MelSTFT
from expressive_fastspeech2_mandarin_tpu_torch.interop import (
    discriminator_from_jax,
    hifigan_from_jax,
    load_generator_npz,
    vocoder_train_state_from_jax,
    wn_generator_from_jax,
)
from expressive_fastspeech2_mandarin_tpu_torch.models import MPD, MSD
from expressive_fastspeech2_mandarin_tpu_torch.models.hifigan import Generator
from expressive_fastspeech2_mandarin_tpu_torch.models.hifigan_disc import (
    fold_weight_norm,
    generator_weight_norm,
)
from expressive_fastspeech2_mandarin_tpu_torch.train import vocoder as tvoc

torch.set_num_threads(2)
CPU = torch.device("cpu")
LOSS_REL = 1e-5
GRAD_REL = 1e-3
PARAM_ATOL = 1e-6


def _cfg(mod, **vt_overrides):
    """tests/test_vocoder_train.py:tiny_cfg in either package's classes;
    lr_decay_steps=1 puts the second update past a decay step."""
    vt = dict(batch_size=2, segment_size=1024, mpd_periods=(2, 3),
              msd_scales=2, lr_decay_steps=1)
    vt.update(vt_overrides)
    return mod.Config(
        preprocess=mod.PreprocessConfig(
            audio=mod.AudioConfig(sampling_rate=16000),
            stft=mod.STFTConfig(filter_length=256, hop_length=64,
                                win_length=256)),
        model=mod.ModelConfig(vocoder=mod.VocoderConfig(
            upsample_rates=(4, 4, 2, 2), upsample_kernel_sizes=(8, 8, 4, 4),
            upsample_initial_channel=32, resblock_kernel_sizes=(3,),
            resblock_dilation_sizes=((1, 2),))),
        vocoder_train=mod.VocoderTrainConfig(**vt))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _wn_tree(abstract, rng, std=None):
    """Numpy values for a weight-norm tree of ShapeDtypeStructs: v uniform
    in ±1/√fan_in (or N(0, std)), g = ‖v‖ over the axes g keeps as 1 (so
    the kernels are v), biases uniform in ±0.1."""
    if isinstance(abstract, dict) and "v" in abstract:
        shape = abstract["v"].shape
        if std is None:
            v = rng.uniform(-1, 1, shape) / np.sqrt(np.prod(shape[:-1]))
        else:
            v = rng.normal(0.0, std, shape)
        axes = tuple(i for i, n in enumerate(abstract["g"].shape) if n == 1)
        g = np.sqrt(np.sum(v * v, axis=axes, keepdims=True))
        bias = rng.uniform(-0.1, 0.1, abstract["bias"].shape)
        return {k: a.astype(np.float32)
                for k, a in (("v", v), ("g", g), ("bias", bias))}
    if isinstance(abstract, dict):
        return {k: _wn_tree(a, rng, std) for k, a in abstract.items()}
    return [_wn_tree(a, rng, std) for a in abstract]


def _jax_state(cfg, seed: int):
    """A fresh JAX VocoderTrainState with numpy values from ``seed``."""
    ab = jax.eval_shape(functools.partial(jvoc.init_vocoder_train_state, cfg))
    rng = np.random.default_rng(seed)
    zeros = functools.partial(jax.tree.map,
                              lambda s: np.zeros(s.shape, s.dtype))
    return jvoc.VocoderTrainState(
        gen=_wn_tree(ab.gen, rng, std=0.05), mpd=_wn_tree(ab.mpd, rng),
        msd=_wn_tree(ab.msd, rng), opt_g=zeros(ab.opt_g),
        opt_d=zeros(ab.opt_d), step=np.int32(0),
        rng=np.zeros(ab.rng.shape, ab.rng.dtype))


def _checkpoint(state):
    s = _np(state)
    return vocoder_train_state_from_jax(s.gen, s.mpd, s.msd, s.opt_g,
                                        s.opt_d, s.step)


def _wavs(seed: int, n: int = 3, length: int = 4000):
    rng = np.random.default_rng(seed)
    t = np.arange(length) / 16000
    return [(0.5 * np.sin(2 * np.pi * (150 + 70 * i) * t)
             + 0.1 * rng.normal(size=length)).astype(np.float32)
            for i in range(n)]


@pytest.fixture(scope="module")
def gan_steps():
    """One JAX step from a numpy state (non-zero moments), then one step of
    each package from that state on the same windows."""
    jc, pc = _cfg(jcfg), _cfg(tcfg)
    wavs = _wavs(5)
    ctx_a, ctx_b = (jvoc.SegmentSampler(jc, wavs, seed=s).sample(2)
                    for s in (1, 2))
    step = jvoc.make_vocoder_train_step(jc, donate=False)
    js1, _ = step(_jax_state(jc, 0), jnp.asarray(ctx_a))
    js2, report = step(js1, jnp.asarray(ctx_b))
    ps = tvoc.init_vocoder_train_state(pc, CPU)
    tvoc.load_vocoder_checkpoint(ps, _checkpoint(js1))
    port_report = tvoc.make_vocoder_train_step(pc, CPU)(
        ps, torch.from_numpy(ctx_b))
    return dict(jc=jc, pc=pc, js1=js1, js2=js2, report=report, ps=ps,
                port_report=port_report, ctx=ctx_b, wavs=wavs)


def _port_params(ps):
    return {"gen": dict(ps.gen.named_parameters()),
            "mpd": dict(ps.mpd.named_parameters()),
            "msd": dict(ps.msd.named_parameters())}


def _jax_grads(js1, js2, b1: float) -> dict:
    """The gradients of JAX's second step from its first moments."""
    def grads(opt1, opt2, convert):
        mu1 = convert(_np(optax.tree_utils.tree_get(opt1, "mu")))
        mu2 = convert(_np(optax.tree_utils.tree_get(opt2, "mu")))
        return {k: (mu2[k] - b1 * mu1[k]) / (1.0 - b1) for k in mu2}

    d = grads(js1.opt_d, js2.opt_d,
              lambda t: {f"{n}.{k}": v for n in ("mpd", "msd")
                         for k, v in discriminator_from_jax(t[n]).items()})
    return {"gen": grads(js1.opt_g, js2.opt_g, wn_generator_from_jax),
            "mpd": {k[4:]: v for k, v in d.items() if k.startswith("mpd.")},
            "msd": {k[4:]: v for k, v in d.items() if k.startswith("msd.")}}


def test_one_gan_step_losses_match_jax(gan_steps):
    ref = gan_steps["report"]
    out = gan_steps["port_report"].as_dict()
    assert gan_steps["ps"].step == int(gan_steps["js2"].step) == 2
    for name in ref._fields:
        r = float(getattr(ref, name))
        assert np.isfinite(out[name])
        assert abs(out[name] - r) <= LOSS_REL * abs(r), (name, out[name], r)


def test_one_gan_step_gradients_match_jax(gan_steps):
    b1 = gan_steps["jc"].vocoder_train.adam_betas[0]
    ref = _jax_grads(gan_steps["js1"], gan_steps["js2"], b1)
    port = _port_params(gan_steps["ps"])
    for part in ("gen", "mpd", "msd"):
        assert port[part].keys() == ref[part].keys()
        for name, p in port[part].items():
            r = ref[part][name].numpy()
            diff = np.abs(p.grad.numpy() - r).max()
            assert diff <= GRAD_REL * np.abs(r).max(), (part, name, diff)


def test_one_gan_step_parameters_match_jax(gan_steps):
    js2 = _np(gan_steps["js2"])
    ref = {"gen": wn_generator_from_jax(js2.gen),
           "mpd": discriminator_from_jax(js2.mpd),
           "msd": discriminator_from_jax(js2.msd)}
    for part, params in _port_params(gan_steps["ps"]).items():
        for name, p in params.items():
            g = p.grad.abs()
            big = g > 1e-3 * g.max()
            diff = (p.detach() - ref[part][name]).abs()[big]
            assert diff.numel() == 0 or diff.max() <= PARAM_ATOL, (
                part, name, diff.max())


def test_learning_rate_schedule_matches_optax():
    cfg = tcfg.Config()
    vt = cfg.vocoder_train
    sched = optax.exponential_decay(vt.learning_rate, vt.lr_decay_steps,
                                    vt.lr_decay, staircase=True)
    for count in (0, 999, 1000, 1001, 5000):
        np.testing.assert_allclose(tvoc.vocoder_lr(cfg, count),
                                   float(sched(count)), rtol=1e-6)


def test_discriminators_match_jax():
    """MPD (period folded into the batch, reflect padding to a multiple
    of the period, time-major logits) and MSD (grouped strided convs,
    avg-pooled scales) against apply_mpd / apply_msd."""
    periods = (2, 3, 5)
    rng = np.random.default_rng(3)
    mpd = _wn_tree(jax.eval_shape(functools.partial(
        init_mpd, jax.random.PRNGKey(0), periods)), rng)
    msd = _wn_tree(jax.eval_shape(functools.partial(
        init_msd, jax.random.PRNGKey(0), 3)), rng)
    wav = rng.normal(0, 0.3, (2, 1000)).astype(np.float32)
    port_mpd, port_msd = MPD(periods), MSD(3)
    port_mpd.load_state_dict(discriminator_from_jax(mpd), strict=True)
    port_msd.load_state_dict(discriminator_from_jax(msd), strict=True)
    jax_mpd = jax.jit(apply_mpd, static_argnums=2)(mpd, jnp.asarray(wav),
                                                   periods)
    jax_msd = jax.jit(apply_msd)(msd, jnp.asarray(wav))
    with torch.no_grad():
        for (ref_lg, ref_fm), module, atol in (
                (jax_mpd, port_mpd, 2e-5), (jax_msd, port_msd, 3e-5)):
            logits, fmaps = module(torch.from_numpy(wav))
            for lg, r in zip(logits, ref_lg, strict=True):
                assert lg.shape == r.shape
                np.testing.assert_allclose(lg.numpy(), np.asarray(r),
                                           atol=atol)
            for sub, ref_sub in zip(fmaps, ref_fm, strict=True):
                for fm, r in zip(sub, ref_sub, strict=True):
                    # port (N, C, T') against JAX (N, T', C)
                    np.testing.assert_allclose(
                        fm.numpy(), np.asarray(r).transpose(0, 2, 1),
                        atol=atol)


def test_weight_norm_fold_roundtrip():
    """Folded → weight norm → folded gives the kernels back (rtol 1e-6);
    the fold of a weight-norm state equals the JAX package's
    fold_weight_norm of the same tree; doubling g doubles the kernel."""
    cfg = _cfg(tcfg)
    gen = Generator(cfg.model.vocoder).state_dict()
    back = fold_weight_norm(generator_weight_norm(gen))
    assert back.keys() == gen.keys()
    for k in gen:
        torch.testing.assert_close(back[k], gen[k], rtol=1e-6, atol=0)

    wn = _wn_tree(jax.eval_shape(functools.partial(
        jvoc.init_vocoder_train_state, _cfg(jcfg))).gen,
        np.random.default_rng(4))
    ref = hifigan_from_jax(_np(jax_fold_weight_norm(wn)))
    ours = fold_weight_norm(wn_generator_from_jax(wn))
    for k in ref:
        torch.testing.assert_close(ours[k], ref[k], rtol=1e-6, atol=1e-7)
    state = wn_generator_from_jax(wn)
    state["conv_pre.weight_g"] = 2.0 * state["conv_pre.weight_g"]
    torch.testing.assert_close(fold_weight_norm(state)["conv_pre.weight"],
                               2.0 * ours["conv_pre.weight"], rtol=1e-6,
                               atol=0)


def test_generator_plain_path_matches_jax_and_takes_gradients():
    """Generator.forward(fast=False), the trainer's path, against JAX's
    apply_generator(fast=False) (the stage channels 16…2 of this config),
    equal to fast=True on the CPU (the plain MRF version), and
    differentiable."""
    cfg = _cfg(tcfg)
    wn = _wn_tree(jax.eval_shape(functools.partial(
        jvoc.init_vocoder_train_state, _cfg(jcfg))).gen,
        np.random.default_rng(5), std=0.05)
    folded = _np(jax_fold_weight_norm(wn))
    mel = np.random.default_rng(6).normal(size=(2, 16, 80)).astype(np.float32)
    ref = np.asarray(jax.jit(functools.partial(
        apply_generator, cfg=_cfg(jcfg).model.vocoder, fast=False))(
            folded, jnp.asarray(mel)))
    gen = Generator(cfg.model.vocoder, weight_norm=True)
    gen.load_state_dict(wn_generator_from_jax(wn), strict=True)
    out = gen(torch.from_numpy(mel), fast=False)
    np.testing.assert_allclose(out.detach().numpy(), ref, atol=2e-5)
    with torch.no_grad():
        torch.testing.assert_close(gen(torch.from_numpy(mel), fast=True),
                                   out.detach(), rtol=0, atol=1e-6)
    out.square().sum().backward()
    for name, p in gen.named_parameters():
        assert p.grad is not None and torch.isfinite(p.grad).all(), name


def test_context_window_mel_matches_full_utterance_and_jax():
    """logmel_from_context rows are the full-utterance mel rows at the
    window's frame offset (atol 1e-5), and JAX's logmel_from_context within
    the two packages' mel bound (atol 1e-4, tests/test_torch_dsp.py: their
    FFTs round differently); the waveform target is the utterance
    itself."""
    pc, jc = _cfg(tcfg), _cfg(jcfg)
    pre = pc.preprocess
    stft = MelSTFT(pre.stft, pre.mel, pre.audio.sampling_rate)
    jstft = JaxMelSTFT(jc.preprocess.stft, jc.preprocess.mel,
                       jc.preprocess.audio.sampling_rate)
    wav = np.random.default_rng(4).normal(0, 0.3, 5000).astype(np.float32)
    full_mel, _ = stft.mel_energy(torch.from_numpy(wav)[None])
    half = pre.stft.filter_length // 2
    padded = np.pad(wav, (half, half), mode="reflect")
    ctx = tvoc.context_samples(pc)
    n_frames = pc.vocoder_train.segment_size // pre.stft.hop_length
    for f in (0, 7, 31):
        window = padded[None, f * 64: f * 64 + ctx]
        mel = tvoc.logmel_from_context(torch.from_numpy(window), stft,
                                       n_frames)
        ref = np.asarray(jvoc.logmel_from_context(jnp.asarray(window), jstft,
                                                  n_frames))
        np.testing.assert_allclose(mel[0].numpy(),
                                   full_mel[0, f: f + n_frames].numpy(),
                                   atol=1e-5)
        np.testing.assert_allclose(mel.numpy(), ref, atol=1e-4)
        np.testing.assert_array_equal(window[0, half: half + 1024],
                                      wav[f * 64: f * 64 + 1024])


def test_segment_sampler_matches_jax_and_pads_short_utterances():
    pc, jc = _cfg(tcfg), _cfg(jcfg)
    wavs = [np.zeros(300, np.float32),  # shorter than one segment
            np.random.default_rng(0).normal(size=4000).astype(np.float32)]
    ours = tvoc.SegmentSampler(pc, wavs, seed=7)
    ref = jvoc.SegmentSampler(jc, wavs, seed=7)
    for _ in range(3):
        batch = ours.sample(4)
        assert batch.shape == (4, tvoc.context_samples(pc))
        np.testing.assert_array_equal(batch, ref.sample(4))
    assert all(len(w) >= tvoc.context_samples(pc) for w in ours.padded)


def test_val_step_matches_jax(gan_steps):
    jc, pc = gan_steps["jc"], gan_steps["pc"]
    ref = float(jvoc.make_vocoder_val_step(jc)(
        gan_steps["js1"].gen, jnp.asarray(gan_steps["ctx"])))
    gen = Generator(pc.model.vocoder, weight_norm=True)
    gen.load_state_dict(_checkpoint(gan_steps["js1"])["gen"], strict=True)
    out = tvoc.make_vocoder_val_step(pc, CPU)(gen,
                                              torch.from_numpy(gan_steps["ctx"]))
    assert abs(out - ref) <= LOSS_REL * abs(ref)


def test_train_vocoder_resumes_and_exports_for_both_packages(tmp_path):
    """train_vocoder on the CPU: metrics.jsonl with the losses and the val
    record; a checkpoint; a resume that continues the step, the update
    count and the learning rate; generator.npz that the JAX package's
    load_generator_npz and the port's loader read alike, and that equals
    the folded generator."""
    cfg = _cfg(tcfg, log_step=1, save_step=2, val_step=2, lr_decay_steps=2)
    out = str(tmp_path / "voc")
    state = tvoc.train_vocoder(cfg, _wavs(6), out, total_steps=2,
                               device="cpu", log=lambda *_: None)
    assert state.step == 2
    with open(tmp_path / "voc" / "metrics.jsonl") as f:
        records = [json.loads(line) for line in f]
    assert [r["step"] for r in records] == [1, 2, 2]
    assert "val_mel_l1" in records[2]
    assert all(np.isfinite(r["mel_l1"]) for r in records[:2])
    assert sorted(p.name for p in (tmp_path / "voc" / "ckpt").iterdir()) == [
        "2.pt"]

    resumed = tvoc.train_vocoder(cfg, _wavs(6), out, total_steps=3,
                                 device="cpu", log=lambda *_: None)
    assert resumed.step == 3
    # The update counts live on the parameters' device; the next update's
    # learning rate is read from them (one decay step past, at count 3).
    for opt in (resumed.opt_g, resumed.opt_d):
        assert int(opt.count) == 3 and opt.count.device == CPU
    vt = cfg.vocoder_train
    assert resumed.opt_g.lr == pytest.approx(
        vt.learning_rate * vt.lr_decay, rel=1e-6)

    npz = str(tmp_path / "voc" / "generator.npz")
    folded = fold_weight_norm(resumed.gen.state_dict())
    ours = load_generator_npz(npz)
    ref = hifigan_from_jax(jax_load_generator_npz(npz))
    assert ours.keys() == ref.keys() == folded.keys()
    for k in ours:
        torch.testing.assert_close(ours[k], ref[k], rtol=0, atol=0)
        torch.testing.assert_close(ours[k], folded[k], rtol=0, atol=0)


def test_bfloat16_amp_step_runs_on_cpu():
    """amp_dtype="bfloat16": bf16 convs in the generator and both
    discriminators, float32 masters and losses; finite, and the mel L1
    within 5 % of the float32 step's from the same state and batch."""
    reports = {}
    ctx = torch.from_numpy(tvoc.SegmentSampler(_cfg(tcfg), _wavs(8),
                                               seed=3).sample(2))
    for amp in ("float32", "bfloat16"):
        cfg = _cfg(tcfg, amp_dtype=amp)
        state = tvoc.init_vocoder_train_state(cfg, CPU)
        reports[amp] = tvoc.make_vocoder_train_step(cfg, CPU)(state, ctx)
        assert all(p.dtype == torch.float32 for p in state.gen.parameters())
    bf16, f32 = reports["bfloat16"].as_dict(), reports["float32"].as_dict()
    assert all(np.isfinite(v) for v in bf16.values())
    assert abs(bf16["mel_l1"] - f32["mel_l1"]) <= 0.05 * f32["mel_l1"]


@pytest.mark.parametrize("field,value", [("packed_generator", True),
                                         ("steps_per_call", 2)])
def test_tpu_only_vocoder_settings_raise(field, value):
    """The settings once refused as TPU-only (hence the name) are taken
    (chunks: tests/test_torch_train_loop.py); an unknown amp dtype still
    raises."""
    assert getattr(tcfg.VocoderTrainConfig(**{field: value}), field) == value
    with pytest.raises(ValueError, match="amp_dtype"):
        tcfg.VocoderTrainConfig(amp_dtype="float16")


def test_train_vocoder_needs_the_card_unless_asked_for_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tvoc.train_vocoder(_cfg(tcfg), _wavs(1), str(tmp_path / "v"),
                           total_steps=1)


def test_config_fields_match_jax():
    ours = {f.name: f.default for f in dataclasses.fields(
        tcfg.VocoderTrainConfig)}
    ref = {f.name: f.default for f in dataclasses.fields(
        jcfg.VocoderTrainConfig)}
    assert ours == ref


def _jax_cadence(cfg, out_dir, total: int, monkeypatch) -> dict:
    """The JAX package's ``train_vocoder`` loop with its state, steps,
    checkpoints and export stubbed out: the steps at which it logs,
    validates and saves."""
    from expressive_fastspeech2_mandarin_tpu.models import hifigan as jhifi

    saved = []

    class Ckpt:
        def __init__(self, _path):
            pass

        def latest_step(self):
            return None

        def save(self, step, _state):
            saved.append(step)

    class State(dict):
        step = 0
        gen = {}

    zero = jvoc.VocoderLossReport(*[np.float32(0)] * 5)
    monkeypatch.setattr(jvoc, "CheckpointManager", Ckpt)
    monkeypatch.setattr(jvoc, "init_vocoder_train_state",
                        lambda *a, **k: State())
    for name in ("make_vocoder_multi_step", "make_vocoder_train_step"):
        monkeypatch.setattr(jvoc, name,
                            lambda *a, **k: lambda st, b: (st, zero))
    monkeypatch.setattr(jvoc, "make_vocoder_val_step",
                        lambda *a, **k: lambda gen, vb: np.float32(0))
    monkeypatch.setattr(jvoc, "fold_weight_norm", lambda tree: tree)
    monkeypatch.setattr(jhifi, "save_generator_npz", lambda *a: None)
    jcfg_ = _cfg(jcfg, **{f.name: getattr(cfg.vocoder_train, f.name)
                          for f in dataclasses.fields(cfg.vocoder_train)
                          if f.name in ("log_step", "val_step", "save_step",
                                        "steps_per_call")})
    jvoc.train_vocoder(jcfg_, _wavs(6), str(out_dir), total_steps=total,
                       log=lambda *_: None)
    with open(out_dir / "metrics.jsonl") as f:
        records = [json.loads(line) for line in f]
    return {"log": [r["step"] for r in records if "mel_l1" in r],
            "val": [r["step"] for r in records if "val_mel_l1" in r],
            "save": saved}


def test_train_vocoder_chunks_are_the_steps_one_by_one(tmp_path,
                                                       monkeypatch):
    """steps_per_call 2 over 6 steps: the same parameters and losses as
    the steps one by one (each chunk's logged losses its steps' mean, 1e-6
    relative), logged, validated and saved at the steps the JAX package's
    loop picks (step % max(every, 2) < 2, and at the end)."""
    cadence = dict(log_step=3, val_step=4, save_step=3)
    chunked_cfg = _cfg(tcfg, steps_per_call=2, **cadence)
    real_save = tvoc.CheckpointManager.save_dict
    runs = {}
    for spc, cfg in ((2, chunked_cfg),
                     (1, _cfg(tcfg, log_step=1, val_step=100,
                              save_step=100))):
        out = tmp_path / f"spc{spc}"
        saves = []

        def save(self, step, ckpt, saves=saves):
            saves.append(step)
            real_save(self, step, ckpt)

        monkeypatch.setattr(tvoc.CheckpointManager, "save_dict", save)
        state = tvoc.train_vocoder(cfg, _wavs(6), str(out), total_steps=6,
                                   device="cpu", log=lambda *_: None)
        with open(out / "metrics.jsonl") as f:
            records = [json.loads(line) for line in f]
        runs[spc] = (state, records, saves)
    chunked, records, saves = runs[2]
    one, one_records, _ = runs[1]
    assert chunked.step == one.step == 6
    for a, b in zip(chunked.gen.parameters(), one.gen.parameters()):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    per_step = {r["step"]: r for r in one_records}
    logged = [r for r in records if "mel_l1" in r]
    for r in logged:
        for key in ("gen_total", "disc", "mel_l1", "fm", "adv"):
            want = (per_step[r["step"] - 1][key] + per_step[r["step"]][key]) / 2
            assert abs(r[key] - want) <= 1e-6 * abs(want), (r["step"], key)
    ours = {"log": [r["step"] for r in logged],
            "val": [r["step"] for r in records if "val_mel_l1" in r],
            "save": saves}
    monkeypatch.undo()
    ref = _jax_cadence(chunked_cfg, tmp_path / "jax", 6, monkeypatch)
    assert ours == ref == {"log": [4, 6], "val": [4], "save": [4, 6]}
