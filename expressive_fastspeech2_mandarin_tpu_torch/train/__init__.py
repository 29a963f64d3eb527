"""FastSpeech2 training: loss, Noam schedule and optimizer, train / eval /
synth steps, checkpoints and the loop."""

from .loop import train
from .loss import LossReport, fastspeech2_loss
from .schedule import Optimizer, noam_schedule
from .state import CheckpointManager, TrainState, create_train_state
from .step import eval_step, loss_and_grads, synth_step, train_step

__all__ = ["train", "LossReport", "fastspeech2_loss", "Optimizer",
           "noam_schedule", "CheckpointManager", "TrainState",
           "create_train_state", "eval_step", "loss_and_grads",
           "synth_step", "train_step"]
