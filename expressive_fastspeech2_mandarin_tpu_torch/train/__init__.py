"""Training: FastSpeech2 (loss, Noam schedule and optimizer, train / eval
/ synth steps, checkpoints and the loop) and the HiFi-GAN vocoder's GAN
recipe (``train.vocoder``) with its paired mode on GTA mels
(``export_gta_mels``)."""

from .loop import train
from .loss import LossReport, fastspeech2_loss
from .sampling import SampleVocoder
from .schedule import Optimizer, noam_schedule
from .state import CheckpointManager, TrainState, create_train_state
from .step import (
    eval_step,
    loss_and_grads,
    make_eval_step,
    make_synth_step,
    synth_step,
    train_step,
)
from .vocoder import (
    PairedSegmentSampler,
    VocoderAdamW,
    VocoderTrainState,
    export_gta_mels,
    init_vocoder_train_state,
    load_corpus_wavs,
    load_paired_corpus,
    make_vocoder_multi_step,
    make_vocoder_train_step,
    make_vocoder_val_step,
    train_vocoder,
    vocoder_graphs,
)

__all__ = ["train", "LossReport", "fastspeech2_loss", "SampleVocoder",
           "Optimizer", "noam_schedule", "CheckpointManager", "TrainState",
           "create_train_state", "eval_step", "loss_and_grads",
           "synth_step", "train_step", "make_eval_step", "make_synth_step",
           "VocoderTrainState", "VocoderAdamW", "vocoder_graphs",
           "init_vocoder_train_state", "load_corpus_wavs",
           "make_vocoder_train_step", "make_vocoder_multi_step",
           "make_vocoder_val_step",
           "train_vocoder", "PairedSegmentSampler", "load_paired_corpus",
           "export_gta_mels"]
