"""Samplers: infinite shuffled and repeat-factor index streams.

The port's own copy of ``rdpn6d_tpu/data/sampler.py`` (``InfiniteSampler``,
``frame_repeat_factors``, ``RepeatFactorSampler``): with the same seed the
index streams are the JAX package's, draw for draw (numpy's
``RandomState``). ``shard_id``/``num_shards`` slice the stream for
multi-process runs: ``loader.train_group_iterator`` passes its rank and
world.
"""

from __future__ import annotations

import itertools
import math
from typing import Iterator

import numpy as np


class InfiniteSampler:
    """Infinite shuffled index stream, optionally sharded."""

    def __init__(self, size: int, shuffle: bool = True, seed: int = 0,
                 shard_id: int = 0, num_shards: int = 1):
        if size <= 0:
            raise ValueError(f"InfiniteSampler needs size > 0, got {size}")
        self.size = size
        self.shuffle = shuffle
        self.seed = seed
        self.shard_id = shard_id
        self.num_shards = num_shards

    def __iter__(self) -> Iterator[int]:
        return itertools.islice(self._infinite(), self.shard_id, None,
                                self.num_shards)

    def _infinite(self) -> Iterator[int]:
        rng = np.random.RandomState(self.seed)
        while True:
            order = rng.permutation(self.size) if self.shuffle \
                else np.arange(self.size)
            yield from order.tolist()


def frame_repeat_factors(frame_category_ids: list[list[int]],
                         repeat_thresh: float) -> np.ndarray:
    """Image-level repeat factors (detectron2's LVIS rule): f(c) = the
    fraction of frames holding category c; r(c) = max(1, sqrt(thr / f(c)));
    r(frame) = the max over its categories. Feeds the grouped path."""
    if not frame_category_ids:
        raise ValueError("frame_repeat_factors needs >= 1 frame")
    n = len(frame_category_ids)
    freq: dict[int, float] = {}
    for cats in frame_category_ids:
        for c in set(cats):
            freq[c] = freq.get(c, 0) + 1
    cat_rep = {c: max(1.0, math.sqrt(repeat_thresh / (v / n)))
               for c, v in freq.items()}
    return np.array([max(cat_rep[c] for c in set(cats))
                     for cats in frame_category_ids])


class RepeatFactorSampler(InfiniteSampler):
    """Oversamples rare categories by max(1, sqrt(thr / freq(c))) per
    record (``category_ids`` + ``repeat_thresh``), or by precomputed
    ``repeat_factors`` (``frame_repeat_factors`` on the grouped path). The
    fractional repeats are re-rounded every epoch."""

    def __init__(self, category_ids: list[int] | None = None,
                 repeat_thresh: float = 0.0,
                 shuffle: bool = True, seed: int = 0, shard_id: int = 0,
                 num_shards: int = 1,
                 repeat_factors: np.ndarray | None = None):
        if repeat_factors is not None:
            self._rep = np.asarray(repeat_factors, np.float64)
        else:
            cats = np.asarray(category_ids)
            freqs = {c: np.sum(cats == c) / len(cats) for c in np.unique(cats)}
            cat_repeat = {c: max(1.0, math.sqrt(repeat_thresh / f))
                          for c, f in freqs.items()}
            self._rep = np.array([cat_repeat[c] for c in cats])
        self._n_records = len(self._rep)
        if self._n_records == 0:
            raise ValueError("RepeatFactorSampler needs >= 1 record")
        # nominal size; an epoch's length varies with the rounding below
        super().__init__(max(int(self._rep.sum()), 1), shuffle, seed,
                         shard_id, num_shards)

    def _infinite(self) -> Iterator[int]:
        rng = np.random.RandomState(self.seed)
        floor = np.floor(self._rep)
        frac = self._rep - floor
        while True:
            rounded = (floor + (rng.rand(self._n_records) < frac)
                       ).astype(int)
            indices = np.repeat(np.arange(self._n_records), rounded)
            if self.shuffle:
                indices = indices[rng.permutation(len(indices))]
            yield from indices.tolist()
