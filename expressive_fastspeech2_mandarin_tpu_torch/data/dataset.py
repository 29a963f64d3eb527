"""Length-bucketed training batches; the JAX package's ``data/dataset.py``.

Batches are padded to a small fixed set of (src, mel) bucket sizes
(``BucketConfig``). An epoch shuffles with ``seed + epoch``, sorts each
window of 8 batches by descending phoneme count (the reference's
length-grouped batching) and cuts it into batches; a short tail batch is
dropped (``drop_last``) or filled by repeating its first example.
Durations are clamped from the end so that they sum to the mel frames
kept.

Sharded over ``num_shards`` processes (the JAX package's row mode,
``shard_rows=True``), every process lists the same batches, takes the
bucket shapes from the whole (global) batch and collates only its
contiguous slice of the rows, ``shard_index``-th of ``num_shards``;
``batch_size`` is the global batch.
"""

from __future__ import annotations

from collections.abc import Iterator
from dataclasses import dataclass

import numpy as np

from ..config import BucketConfig
from .metadata import PreprocessedCorpus, Utterance


def pick_bucket(length: int, buckets: tuple[int, ...]) -> int:
    """The smallest bucket that holds ``length``, else the largest."""
    for b in buckets:
        if length <= b:
            return b
    return buckets[-1]


@dataclass
class Example:
    utt: Utterance
    speaker_id: int
    emotion_id: int
    arousal_id: int
    valence_id: int
    src_len: int
    mel_len: int


class BucketedDataset:
    """Length-bucketed batches of preprocessed utterances."""

    def __init__(self, corpus: PreprocessedCorpus, filename: str,
                 batch_size: int, buckets: BucketConfig,
                 max_seq_len: int = 2000, drop_last: bool = False,
                 seed: int = 1234, symbol_table: str = "pinyin",
                 num_shards: int = 1, shard_index: int = 0):
        self.corpus = corpus
        self.batch_size = batch_size
        self.buckets = buckets
        self.drop_last = drop_last
        self.seed = seed
        self.symbol_table = symbol_table
        self.num_shards = num_shards
        self.shard_index = shard_index
        if batch_size % num_shards:
            raise ValueError(
                f"global batch_size {batch_size} not divisible by "
                f"{num_shards} shards (row sharding)")
        lengths = corpus.lengths(filename)
        self.examples: list[Example] = []
        for utt in corpus.metadata(filename):
            src_len, mel_len = lengths[utt.basename]
            if mel_len > max_seq_len or src_len == 0:
                continue  # the reference's filter
            self.examples.append(Example(
                utt=utt,
                speaker_id=corpus.speaker_id(utt),
                emotion_id=corpus.emotion_map[utt.emotion],
                arousal_id=corpus.arousal_map[utt.arousal],
                valence_id=corpus.valence_map[utt.valence],
                src_len=src_len,
                mel_len=mel_len,
            ))

    def __len__(self) -> int:
        return len(self.examples)

    def _batches(self, epoch: int, shuffle: bool) -> list[list[Example]]:
        order = np.arange(len(self.examples))
        if shuffle:
            np.random.default_rng(self.seed + epoch).shuffle(order)
        window = self.batch_size * 8
        chunks = []
        for i in range(0, len(order), window):
            idx = order[i: i + window]
            chunks.append(idx[np.argsort([-self.examples[j].src_len
                                          for j in idx])])
        order = np.concatenate(chunks) if chunks else order
        batches = []
        for i in range(0, len(order), self.batch_size):
            idx = order[i: i + self.batch_size]
            if len(idx) < self.batch_size:
                if self.drop_last:
                    continue
                idx = np.concatenate(
                    [idx, idx[np.zeros(self.batch_size - len(idx), np.int64)]])
            batches.append([self.examples[j] for j in idx])
        return batches

    def _rows(self, batch: list[Example]) -> list[Example]:
        """This process's contiguous slice of a batch's rows."""
        n = len(batch) // self.num_shards
        return batch[self.shard_index * n:(self.shard_index + 1) * n]

    def host_rows(self, epoch: int = 0, shuffle: bool = True) -> list[str]:
        """Basenames of the rows this process collates in ``epoch``, in
        order (the shards' disjointness and coverage)."""
        return [e.utt.basename for batch in self._batches(epoch, shuffle)
                for e in self._rows(batch)]

    def _collate(self, batch: list[Example]) -> dict[str, np.ndarray]:
        # The buckets come from the whole batch, so that every process
        # pads its rows to the same shapes.
        src_bucket = pick_bucket(max(e.src_len for e in batch),
                                 self.buckets.src_buckets)
        mel_bucket = pick_bucket(max(e.mel_len for e in batch),
                                 self.buckets.mel_buckets)
        batch = self._rows(batch)
        b = len(batch)
        out = {
            "speakers": np.array([e.speaker_id for e in batch], np.int32),
            "emotions": np.array([e.emotion_id for e in batch], np.int32),
            "arousals": np.array([e.arousal_id for e in batch], np.int32),
            "valences": np.array([e.valence_id for e in batch], np.int32),
            "texts": np.zeros((b, src_bucket), np.int32),
            "src_lens": np.zeros((b,), np.int32),
            "mels": np.zeros((b, mel_bucket, 80), np.float32),
            "mel_lens": np.zeros((b,), np.int32),
            "pitches": np.zeros((b, src_bucket), np.float32),
            "energies": np.zeros((b, src_bucket), np.float32),
            "durations": np.zeros((b, src_bucket), np.int32),
        }
        for i, e in enumerate(batch):
            ids = e.utt.phone_ids(self.symbol_table)
            mel = self.corpus.mel(e.utt)
            duration = self.corpus.duration(e.utt).astype(np.int64)
            s = min(len(ids), src_bucket)
            t = min(mel.shape[0], mel_bucket)
            duration = duration[:s]
            excess = duration.sum() - t
            j = s - 1
            while excess > 0 and j >= 0:
                take = min(excess, duration[j])
                duration[j] -= take
                excess -= take
                j -= 1
            out["texts"][i, :s] = ids[:s]
            out["src_lens"][i] = s
            out["mels"][i, :t] = mel[:t]
            out["mel_lens"][i] = duration.sum()
            out["pitches"][i, :s] = self.corpus.pitch(e.utt)[:s]
            out["energies"][i, :s] = self.corpus.energy(e.utt)[:s]
            out["durations"][i, :s] = duration
        return out

    def epoch(self, epoch: int = 0, shuffle: bool = True
              ) -> Iterator[dict[str, np.ndarray]]:
        for batch in self._batches(epoch, shuffle):
            yield self._collate(batch)

    def epoch_with_examples(self, epoch: int = 0, shuffle: bool = True
                            ) -> Iterator[tuple[dict[str, np.ndarray],
                                                list[Example]]]:
        """As ``epoch``, with each batch's row-aligned examples (a filled
        tail repeats its first): the basenames a per-utterance export
        needs (JAX ``data/dataset.py:202-207``)."""
        for batch in self._batches(epoch, shuffle):
            yield self._collate(batch), batch
