"""Typed configuration for synthesis, FastSpeech2 training and HiFi-GAN
vocoder training.

The same shape as the JAX package's configuration — audio, STFT, mel and
variance features under ``PreprocessConfig``; transformer, variance and
vocoder sizes under ``ModelConfig``; optimizer, cadence and buckets under
``TrainConfig``; the GAN recipe under ``VocoderTrainConfig`` — with the
same field names and defaults, so a configuration reads the same in both
packages. ``matmul_precision`` maps XLA's precision names onto the card's
TF32 switches (``train.loop.matmul_precision``); the profiler window
writes a ``torch.profiler`` trace; the vocoder's scan chunks run as eager
chunks; ``packed_generator``, a TPU lane-packing layout with the plain
generator's semantics, trains the plain generator. The mesh
(``mesh.model_parallel_size``) lays out the training processes
(``parallel.make_layout``).

``load_config(p, m, t)`` reads the reference's three YAML files (``-p/-m/
-t``) through ``utils.yaml_reader``, which resolves their scalars as
PyYAML's ``safe_load`` does, and sizes the speaker and emotion tables
from ``speakers.json``/``emotions.json`` of the preprocessed corpus when
they are there; the JAX package's ``config.py:311-513``.
"""

from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass, field
from typing import Any

from .utils import yaml_reader


@dataclass(frozen=True)
class AudioConfig:
    sampling_rate: int = 22050
    max_wav_value: float = 32768.0


@dataclass(frozen=True)
class STFTConfig:
    filter_length: int = 1024
    hop_length: int = 256
    win_length: int = 1024


@dataclass(frozen=True)
class MelConfig:
    n_mel_channels: int = 80
    mel_fmin: float = 0.0
    mel_fmax: float = 8000.0


@dataclass(frozen=True)
class VarianceFeatureConfig:
    feature: str = "phoneme_level"  # or "frame_level"
    normalization: bool = True


@dataclass(frozen=True)
class PathConfig:
    corpus_path: str = ""
    lexicon_path: str = ""
    raw_path: str = ""
    preprocessed_path: str = ""
    sub_dir_name: str = ""
    fixed_text_path: str = ""
    ckpt_path: str = ""
    log_path: str = ""
    result_path: str = ""


@dataclass(frozen=True)
class PreprocessConfig:
    dataset: str = "ESD-Chinese-Singing-MFA"
    path: PathConfig = field(default_factory=PathConfig)
    val_size: int = 512
    text_cleaners: tuple[str, ...] = ("basic_cleaners",)
    language: str = "zh"
    # Phoneme inventory: "pinyin" (108 symbols) or "ipa" (138 symbols).
    symbol_table: str = "pinyin"
    audio: AudioConfig = field(default_factory=AudioConfig)
    stft: STFTConfig = field(default_factory=STFTConfig)
    mel: MelConfig = field(default_factory=MelConfig)
    pitch: VarianceFeatureConfig = field(default_factory=VarianceFeatureConfig)
    energy: VarianceFeatureConfig = field(default_factory=VarianceFeatureConfig)


@dataclass(frozen=True)
class TransformerConfig:
    encoder_layer: int = 4
    encoder_head: int = 2
    encoder_hidden: int = 256
    decoder_layer: int = 6
    decoder_head: int = 2
    decoder_hidden: int = 256
    conv_filter_size: int = 1024
    conv_kernel_size: tuple[int, int] = (9, 1)
    encoder_dropout: float = 0.2
    decoder_dropout: float = 0.2
    # "auto" (flash on the card past 2048 frames) | "xla" (plain matmul +
    # softmax) | "flash" (the CUDA kernels, forward and backward, on the
    # card; their plain versions on the CPU)
    attention_impl: str = "auto"


@dataclass(frozen=True)
class VariancePredictorConfig:
    filter_size: int = 256
    kernel_size: int = 3
    dropout: float = 0.5


@dataclass(frozen=True)
class VarianceEmbeddingConfig:
    pitch_quantization: str = "linear"  # "linear" | "log"
    energy_quantization: str = "linear"
    n_bins: int = 256


@dataclass(frozen=True)
class VocoderConfig:
    model: str = "HiFi-GAN"
    speaker: str = "universal"
    # HiFi-GAN V1 universal generator topology.
    upsample_rates: tuple[int, ...] = (8, 8, 2, 2)
    upsample_kernel_sizes: tuple[int, ...] = (16, 16, 4, 4)
    upsample_initial_channel: int = 512
    resblock_kernel_sizes: tuple[int, ...] = (3, 7, 11)
    resblock_dilation_sizes: tuple[tuple[int, ...], ...] = (
        (1, 3, 5), (1, 3, 5), (1, 3, 5),
    )
    # Inference compute dtype: "bfloat16" (production) or "float32" (parity).
    compute_dtype: str = "bfloat16"
    ckpt_path: str = ""


@dataclass(frozen=True)
class ModelConfig:
    transformer: TransformerConfig = field(default_factory=TransformerConfig)
    variance_predictor: VariancePredictorConfig = field(
        default_factory=VariancePredictorConfig
    )
    variance_embedding: VarianceEmbeddingConfig = field(
        default_factory=VarianceEmbeddingConfig
    )
    multi_speaker: bool = True
    multi_emotion: bool = True
    max_seq_len: int = 2000
    vocoder: VocoderConfig = field(default_factory=VocoderConfig)
    # Phoneme embedding rows: sized from the IPA table (138 + 1) even when
    # the pinyin IDs are used, so checkpoints line up row for row.
    vocab_size: int = 139
    n_speakers: int = 10
    n_emotions: int = 5
    n_arousals: int = 5
    n_valences: int = 5
    # Scale the energy prediction by p_control, not e_control, as the
    # reference implementation does. False gives the corrected behaviour.
    replicate_energy_control_bug: bool = True
    # Zero padded positions before every conv consumer (variance predictors,
    # postnet), so a bucket-padded batch computes what exact-length runs
    # would. False keeps the reference's padded-batch behaviour.
    padding_inert: bool = True




@dataclass(frozen=True)
class OptimizerConfig:
    batch_size: int = 4
    betas: tuple[float, float] = (0.9, 0.98)
    eps: float = 1e-9
    weight_decay: float = 0.0
    grad_clip_thresh: float = 1.0
    grad_acc_step: int = 1
    warm_up_step: int = 4000
    anneal_steps: tuple[int, ...] = (300000, 400000, 500000)
    anneal_rate: float = 0.3
    # Multiplier on the Noam schedule for large-batch training.
    lr_scale: float = 1.0


@dataclass(frozen=True)
class StepConfig:
    total_step: int = 900000
    log_step: int = 100
    synth_step: int = 1000
    val_step: int = 1000
    save_step: int = 100000


@dataclass(frozen=True)
class BucketConfig:
    """Padded batch shapes: (src, mel) lengths round up to these sizes."""

    src_buckets: tuple[int, ...] = (32, 64, 96, 128)
    mel_buckets: tuple[int, ...] = (250, 500, 1000, 1500, 2000)


@dataclass(frozen=True)
class MeshConfig:
    """The JAX package's ('data', 'model') mesh over the training processes
    (``parallel.make_layout``): the ``model_parallel_size`` ranks of one
    model group collate the same rows and compute them alike (nothing is
    split over ``model``, as in the JAX package); the batch is split over
    the world size ÷ ``model_parallel_size`` data ranks. ``train()``
    raises when it does not divide the world size."""

    data_axis: str = "data"
    model_axis: str = "model"
    model_parallel_size: int = 1


# jax_default_matmul_precision's names → whether float32 matmuls and convs
# may run on TF32 tensor cores.
MATMUL_PRECISIONS = {"default": False, "highest": False, "float32": False,
                     "high": True, "tensorfloat32": True, "bfloat16": True,
                     "bfloat16_3x": True}


@dataclass(frozen=True)
class TrainConfig:
    path: PathConfig = field(default_factory=PathConfig)
    optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)
    step: StepConfig = field(default_factory=StepConfig)
    buckets: BucketConfig = field(default_factory=BucketConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    seed: int = 1234
    # jax_default_matmul_precision's names: "default", "highest" and
    # "float32" keep float32 matmuls and convs off TF32; "high",
    # "tensorfloat32", "bfloat16" and "bfloat16_3x" let them run on TF32
    # tensor cores, for the length of ``train()``.
    matmul_precision: str = "default"
    # "bfloat16": forward and backward on a bf16 copy of the float32
    # master parameters; "float32" keeps full precision.
    amp_dtype: str = "float32"
    # Optimizer steps grouped into a chunk of consecutive same-bucket
    # batches (a lax.scan on the TPU; eager steps here): the log, val,
    # synth and save cadences are checked at chunk ends, and a chunk's
    # logged losses are its steps' mean.
    steps_per_call: int = 1
    # Mel-target staging for the host → device copy: "int16" (per-utterance
    # affine quantization), "bfloat16" or "float32".
    transfer_dtype: str = "int16"
    # Batches staged ahead of the running step.
    prefetch_chunks: int = 2
    # A torch.profiler trace of steps [start, stop) under
    # <log_path>/profile (off when start < 0).
    profile_start_step: int = -1
    profile_stop_step: int = -1

    def __post_init__(self):
        if self.matmul_precision not in MATMUL_PRECISIONS:
            raise ValueError(f"matmul_precision must be one of "
                             f"{sorted(MATMUL_PRECISIONS)}, got "
                             f"{self.matmul_precision!r}")
        if self.steps_per_call < 1:
            raise ValueError(f"steps_per_call must be at least 1, got "
                             f"{self.steps_per_call}")
        if self.amp_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"amp_dtype must be float32 or bfloat16, got "
                             f"{self.amp_dtype!r}")
        if self.transfer_dtype not in ("int16", "bfloat16", "float32"):
            raise ValueError(f"transfer_dtype must be int16, bfloat16 or "
                             f"float32, got {self.transfer_dtype!r}")


@dataclass(frozen=True)
class VocoderTrainConfig:
    """HiFi-GAN generator training, the GAN recipe whose hyperparameters
    the reference ships (hifigan/config.json: batch 16, lr 2e-4, Adam
    (0.8, 0.99), decay 0.999, segment 8192); the JAX package's
    ``config.py:258-297``."""

    batch_size: int = 16
    segment_size: int = 8192  # samples; a multiple of hop · prod(ups)
    learning_rate: float = 2e-4
    adam_betas: tuple[float, float] = (0.8, 0.99)
    weight_decay: float = 0.01  # torch AdamW's default, per the recipe
    lr_decay: float = 0.999
    # The recipe decays per epoch; here every lr_decay_steps updates.
    lr_decay_steps: int = 1000
    mel_loss_weight: float = 45.0
    # Discriminator ensemble (HiFi-GAN V1).
    mpd_periods: tuple[int, ...] = (2, 3, 5, 7, 11)
    msd_scales: int = 3
    seed: int = 1234
    # "bfloat16": bf16 generator and discriminator convs, float32 master
    # parameters, weight-norm statistics and losses.
    amp_dtype: str = "float32"
    # The JAX package's packed generator, a TPU lane-packing layout with
    # the plain generator's semantics: the port trains the plain generator
    # either way.
    packed_generator: bool = False
    # GAN steps per chunk (a lax.scan on the TPU; eager steps here): the
    # log, val and save cadences are checked at chunk ends, and a chunk
    # logs its steps' mean losses.
    steps_per_call: int = 1
    total_step: int = 400000
    log_step: int = 100
    save_step: int = 10000
    val_step: int = 5000

    def __post_init__(self):
        if self.amp_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"amp_dtype must be float32 or bfloat16, got "
                             f"{self.amp_dtype!r}")


@dataclass(frozen=True)
class Config:
    preprocess: PreprocessConfig = field(default_factory=PreprocessConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    vocoder_train: VocoderTrainConfig = field(
        default_factory=VocoderTrainConfig)


# ---------------------------------------------------------------------------
# The reference's YAML files


def _get(d: dict, *keys, default=None):
    for k in keys:
        if not isinstance(d, dict) or k not in d:
            return default
        d = d[k]
    return d


def preprocess_config_from_dict(d: dict[str, Any]) -> PreprocessConfig:
    p = d.get("preprocessing", {})
    return PreprocessConfig(
        dataset=d.get("dataset", "ESD-Chinese-Singing-MFA"),
        path=PathConfig(
            corpus_path=_get(d, "path", "corpus_path", default=""),
            lexicon_path=_get(d, "path", "lexicon_path", default=""),
            raw_path=_get(d, "path", "raw_path", default=""),
            preprocessed_path=_get(d, "path", "preprocessed_path", default=""),
            sub_dir_name=_get(d, "path", "sub_dir_name", default=""),
            fixed_text_path=_get(d, "path", "fixed_text_path", default=""),
        ),
        val_size=_get(p, "val_size", default=512),
        text_cleaners=tuple(_get(p, "text", "text_cleaners",
                                 default=["basic_cleaners"])),
        language=_get(p, "text", "language", default="zh"),
        symbol_table=_get(p, "text", "symbol_table", default="pinyin"),
        audio=AudioConfig(
            sampling_rate=_get(p, "audio", "sampling_rate", default=22050),
            max_wav_value=_get(p, "audio", "max_wav_value", default=32768.0),
        ),
        stft=STFTConfig(
            filter_length=_get(p, "stft", "filter_length", default=1024),
            hop_length=_get(p, "stft", "hop_length", default=256),
            win_length=_get(p, "stft", "win_length", default=1024),
        ),
        mel=MelConfig(
            n_mel_channels=_get(p, "mel", "n_mel_channels", default=80),
            mel_fmin=float(_get(p, "mel", "mel_fmin", default=0)),
            mel_fmax=float(_get(p, "mel", "mel_fmax", default=8000)),
        ),
        pitch=VarianceFeatureConfig(
            feature=_get(p, "pitch", "feature", default="phoneme_level"),
            normalization=_get(p, "pitch", "normalization", default=True),
        ),
        energy=VarianceFeatureConfig(
            feature=_get(p, "energy", "feature", default="phoneme_level"),
            normalization=_get(p, "energy", "normalization", default=True),
        ),
    )


def model_config_from_dict(d: dict[str, Any], **overrides) -> ModelConfig:
    t = d.get("transformer", {})
    vp = d.get("variance_predictor", {})
    ve = d.get("variance_embedding", {})
    vo = d.get("vocoder", {})
    kwargs: dict[str, Any] = dict(
        transformer=TransformerConfig(
            encoder_layer=t.get("encoder_layer", 4),
            encoder_head=t.get("encoder_head", 2),
            encoder_hidden=t.get("encoder_hidden", 256),
            decoder_layer=t.get("decoder_layer", 6),
            decoder_head=t.get("decoder_head", 2),
            decoder_hidden=t.get("decoder_hidden", 256),
            conv_filter_size=t.get("conv_filter_size", 1024),
            conv_kernel_size=tuple(t.get("conv_kernel_size", (9, 1))),
            encoder_dropout=t.get("encoder_dropout", 0.2),
            decoder_dropout=t.get("decoder_dropout", 0.2),
            attention_impl=t.get("attention_impl", "auto"),
        ),
        variance_predictor=VariancePredictorConfig(
            filter_size=vp.get("filter_size", 256),
            kernel_size=vp.get("kernel_size", 3),
            dropout=vp.get("dropout", 0.5),
        ),
        variance_embedding=VarianceEmbeddingConfig(
            pitch_quantization=ve.get("pitch_quantization", "linear"),
            energy_quantization=ve.get("energy_quantization", "linear"),
            n_bins=ve.get("n_bins", 256),
        ),
        multi_speaker=d.get("multi_speaker", True),
        multi_emotion=d.get("multi_emotion", True),
        max_seq_len=d.get("max_seq_len", 2000),
        replicate_energy_control_bug=d.get(
            "replicate_energy_control_bug", True),
        padding_inert=d.get("padding_inert", True),
        vocoder=VocoderConfig(
            model=vo.get("model", "HiFi-GAN"),
            speaker=vo.get("speaker", "universal"),
            ckpt_path=vo.get("ckpt_path", ""),
        ),
    )
    kwargs.update(overrides)
    return ModelConfig(**kwargs)


def train_config_from_dict(d: dict[str, Any], **overrides) -> TrainConfig:
    o = d.get("optimizer", {})
    s = d.get("step", {})
    kwargs: dict[str, Any] = dict(
        path=PathConfig(
            ckpt_path=_get(d, "path", "ckpt_path", default=""),
            log_path=_get(d, "path", "log_path", default=""),
            result_path=_get(d, "path", "result_path", default=""),
        ),
        optimizer=OptimizerConfig(
            batch_size=o.get("batch_size", 4),
            betas=tuple(o.get("betas", (0.9, 0.98))),
            eps=float(o.get("eps", 1e-9)),
            weight_decay=float(o.get("weight_decay", 0.0)),
            grad_clip_thresh=float(o.get("grad_clip_thresh", 1.0)),
            grad_acc_step=o.get("grad_acc_step", 1),
            warm_up_step=o.get("warm_up_step", 4000),
            anneal_steps=tuple(o.get("anneal_steps",
                                     (300000, 400000, 500000))),
            anneal_rate=float(o.get("anneal_rate", 0.3)),
            lr_scale=float(o.get("lr_scale", 1.0)),
        ),
        step=StepConfig(
            total_step=s.get("total_step", 900000),
            log_step=s.get("log_step", 100),
            synth_step=s.get("synth_step", 1000),
            val_step=s.get("val_step", 1000),
            save_step=s.get("save_step", 100000),
        ),
        steps_per_call=d.get("steps_per_call", 1),
        matmul_precision=d.get("matmul_precision", "default"),
        # Read from train.yaml here; the JAX package takes the profiler
        # window from Python only.
        profile_start_step=d.get("profile_start_step", -1),
        profile_stop_step=d.get("profile_stop_step", -1),
        transfer_dtype=d.get("transfer_dtype", "int16"),
        amp_dtype=d.get("amp_dtype", "float32"),
        prefetch_chunks=d.get("prefetch_chunks", 2),
    )
    kwargs.update(overrides)
    return TrainConfig(**kwargs)


def vocoder_train_config_from_dict(d: dict[str, Any],
                                   **overrides) -> VocoderTrainConfig:
    """The optional ``vocoder_train:`` section of train.yaml, with the
    reference's hifigan/config.json names where it has one (batch_size,
    learning_rate, adam_b1/b2, lr_decay, segment_size)."""
    kwargs: dict[str, Any] = dict(
        batch_size=d.get("batch_size", 16),
        segment_size=d.get("segment_size", 8192),
        learning_rate=float(d.get("learning_rate", 2e-4)),
        adam_betas=(float(d.get("adam_b1", 0.8)),
                    float(d.get("adam_b2", 0.99))),
        weight_decay=float(d.get("weight_decay", 0.01)),
        lr_decay=float(d.get("lr_decay", 0.999)),
        lr_decay_steps=d.get("lr_decay_steps", 1000),
        mel_loss_weight=float(d.get("mel_loss_weight", 45.0)),
        mpd_periods=tuple(d.get("mpd_periods", (2, 3, 5, 7, 11))),
        msd_scales=d.get("msd_scales", 3),
        seed=d.get("seed", 1234),
        amp_dtype=d.get("amp_dtype", "float32"),
        packed_generator=d.get("packed_generator", False),
        steps_per_call=d.get("steps_per_call", 1),
        total_step=d.get("total_step", 400000),
        log_step=d.get("log_step", 100),
        save_step=d.get("save_step", 10000),
        val_step=d.get("val_step", 5000),
    )
    kwargs.update(overrides)
    return VocoderTrainConfig(**kwargs)


def load_config(preprocess_yaml: str, model_yaml: str, train_yaml: str,
                **model_overrides) -> Config:
    """The reference's configuration triplet from its three YAML files."""
    p = yaml_reader.load(preprocess_yaml) or {}
    m = yaml_reader.load(model_yaml) or {}
    t = yaml_reader.load(train_yaml) or {}
    pc = preprocess_config_from_dict(p)
    # The speaker and emotion tables are sized from the preprocessed
    # corpus' maps when they exist (reference: model/fastspeech2.py:30-67).
    overrides = dict(model_overrides)
    meta = pc.path.preprocessed_path
    if meta and os.path.isdir(meta):
        spk = os.path.join(meta, "speakers.json")
        emo = os.path.join(meta, "emotions.json")
        if os.path.exists(spk) and "n_speakers" not in overrides:
            with open(spk) as f:
                overrides["n_speakers"] = len(json.load(f))
        if os.path.exists(emo) and "n_emotions" not in overrides:
            with open(emo) as f:
                raw = json.load(f)
            overrides["n_emotions"] = len(raw["emotion_dict"])
            overrides["n_arousals"] = len(raw["arousal_dict"])
            overrides["n_valences"] = len(raw["valence_dict"])
    return Config(
        preprocess=pc,
        model=model_config_from_dict(m, **overrides),
        train=train_config_from_dict(t),
        vocoder_train=vocoder_train_config_from_dict(
            t.get("vocoder_train") or {}),
    )


def config_to_dict(cfg: Config) -> dict[str, Any]:
    return dataclasses.asdict(cfg)
