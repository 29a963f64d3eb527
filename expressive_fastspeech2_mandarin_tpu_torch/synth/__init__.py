"""Offline synthesis pipeline."""

from .synthesizer import (
    EMOTION_AROUSAL_VALENCE,
    MEL_BUCKETS,
    SRC_BUCKETS,
    SynthesisResult,
    Synthesizer,
)

__all__ = ["Synthesizer", "SynthesisResult", "EMOTION_AROUSAL_VALENCE",
           "SRC_BUCKETS", "MEL_BUCKETS"]
