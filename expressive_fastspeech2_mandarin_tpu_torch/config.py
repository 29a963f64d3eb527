"""Typed configuration for the synthesis path.

The same three-level shape as the JAX package's configuration — audio, STFT,
mel and variance features under ``PreprocessConfig``; transformer, variance
and vocoder sizes under ``ModelConfig`` — with the same field names and
defaults, so a configuration reads the same in both packages. Training
sections belong to later parts of the port.
"""

from __future__ import annotations

from dataclasses import dataclass, field


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
    # softmax) | "flash" (the CUDA kernel on the card, plain on the CPU)
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
class Config:
    preprocess: PreprocessConfig = field(default_factory=PreprocessConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
