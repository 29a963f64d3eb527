"""Typed configuration for synthesis, FastSpeech2 training and HiFi-GAN
vocoder training.

The same shape as the JAX package's configuration — audio, STFT, mel and
variance features under ``PreprocessConfig``; transformer, variance and
vocoder sizes under ``ModelConfig``; optimizer, cadence and buckets under
``TrainConfig``; the GAN recipe under ``VocoderTrainConfig`` — with the
same field names and defaults, so a configuration reads the same in both
packages. Training values that only mean something on a TPU (scan chunks,
a model-parallel mesh, XLA matmul precision, the JAX profiler, the packed
generator) raise ``ValueError``. There is no YAML loader yet.
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
    """The JAX package's device mesh; the port trains on one card, so only
    ``model_parallel_size=1`` is accepted."""

    data_axis: str = "data"
    model_axis: str = "model"
    model_parallel_size: int = 1


@dataclass(frozen=True)
class TrainConfig:
    path: PathConfig = field(default_factory=PathConfig)
    optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)
    step: StepConfig = field(default_factory=StepConfig)
    buckets: BucketConfig = field(default_factory=BucketConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    seed: int = 1234
    # TPU matmul precision; the port takes only "default".
    matmul_precision: str = "default"
    # "bfloat16": forward and backward on a bf16 copy of the float32
    # master parameters; "float32" keeps full precision.
    amp_dtype: str = "float32"
    # Optimizer steps per host dispatch (a lax.scan chunk on the TPU); the
    # port takes only 1.
    steps_per_call: int = 1
    # Mel-target staging for the host → device copy: "int16" (per-utterance
    # affine quantization), "bfloat16" or "float32".
    transfer_dtype: str = "int16"
    # Batches staged ahead of the running step.
    prefetch_chunks: int = 2
    # JAX profiler window; the port takes only the default (off).
    profile_start_step: int = -1
    profile_stop_step: int = -1

    def __post_init__(self):
        tpu_only = [
            (self.steps_per_call > 1, f"steps_per_call={self.steps_per_call}"
             " (lax.scan chunks of optimizer steps)"),
            (self.mesh.model_parallel_size > 1,
             f"mesh.model_parallel_size={self.mesh.model_parallel_size} "
             "(a model-parallel TPU mesh)"),
            (self.matmul_precision != "default",
             f"matmul_precision={self.matmul_precision!r} (XLA's TPU "
             "matmul precision)"),
            (self.profile_start_step >= 0,
             f"profile_start_step={self.profile_start_step} (the JAX "
             "profiler)"),
        ]
        for bad, what in tpu_only:
            if bad:
                raise ValueError(f"{what} is a TPU setting the PyTorch port "
                                 f"does not take; leave it at its default")
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
    # The JAX package's packed generator (TPU lane packing); the port takes
    # only False.
    packed_generator: bool = False
    # Optimizer steps per host dispatch (a lax.scan chunk on the TPU); the
    # port takes only 1.
    steps_per_call: int = 1
    total_step: int = 400000
    log_step: int = 100
    save_step: int = 10000
    val_step: int = 5000

    def __post_init__(self):
        tpu_only = [
            (self.packed_generator, "packed_generator=True (the TPU's "
             "lane-packed generator layout)"),
            (self.steps_per_call > 1, f"steps_per_call={self.steps_per_call}"
             " (lax.scan chunks of optimizer steps)"),
        ]
        for bad, what in tpu_only:
            if bad:
                raise ValueError(f"{what} is a TPU setting the PyTorch port "
                                 f"does not take; leave it at its default")
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
