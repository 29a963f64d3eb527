"""Readers of a preprocessed corpus and the bucketed training batches."""

from .dataset import BucketedDataset, pick_bucket
from .metadata import EMOTION_AROUSAL_VALENCE, PreprocessedCorpus, Utterance

__all__ = ["BucketedDataset", "pick_bucket", "EMOTION_AROUSAL_VALENCE",
           "PreprocessedCorpus", "Utterance"]
