"""Readers of a preprocessed corpus's metadata."""

from .metadata import PreprocessedCorpus

__all__ = ["PreprocessedCorpus"]
