"""Host-side data: per-process shards, minibatch iteration and synthetic LM
streams.

Own copies of the JAX package's ``maggy_tpu.train.data`` pieces the training
slice needs; batches are dicts of numpy arrays, moved to the device by
:class:`maggy_tpu_torch.train.Trainer`.
"""

from __future__ import annotations

from typing import Dict, Iterator, Optional

import numpy as np


def host_shard(arrays: Dict[str, np.ndarray], process_index: int, num_processes: int):
    """Slice every array's leading axis into this process's contiguous shard."""
    if num_processes <= 1:
        return arrays
    out = {}
    for k, v in arrays.items():
        n = v.shape[0]
        per = n // num_processes
        out[k] = v[process_index * per : (process_index + 1) * per]
    return out


class BatchIterator:
    """Infinite (or one-epoch) minibatch iterator over array dicts, with an
    index-only ``skip(n)`` fast path.

    One permutation is drawn per epoch from a single seeded RNG stream, so
    ``skip`` (which advances epoch/offset counters and draws the skipped
    epochs' permutations without gathering any rows) lands on exactly the
    batch a ``next()`` drain would have.
    """

    def __init__(
        self,
        arrays: Dict[str, np.ndarray],
        batch_size: int,
        *,
        shuffle: bool = True,
        seed: int = 0,
        drop_remainder: bool = True,
        loop: bool = True,
    ):
        self.arrays = dict(arrays)
        self.n = min(v.shape[0] for v in self.arrays.values())
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_remainder = drop_remainder
        self.loop = loop
        self._rng = np.random.default_rng(seed)
        self._end = (self.n // batch_size) * batch_size if drop_remainder else self.n
        self._idx: Optional[np.ndarray] = None  # current epoch's permutation
        self._pos = 0  # row offset into the current epoch
        self._exhausted = False
        self.batches_materialized = 0  # row gathers done (skip test hook)

    def __iter__(self) -> "BatchIterator":
        return self

    def _ensure_epoch(self) -> None:
        if self._idx is None:
            self._idx = (
                self._rng.permutation(self.n)
                if self.shuffle
                else np.arange(self.n)
            )
            self._pos = 0

    def _advance(self) -> None:
        """Move past the batch at ``_pos``, rolling the epoch as needed."""
        self._pos += self.batch_size
        if self._pos >= self._end:
            self._idx = None
            if not self.loop:
                self._exhausted = True

    def __next__(self) -> Dict[str, np.ndarray]:
        if self._exhausted:
            raise StopIteration
        self._ensure_epoch()
        take = self._idx[self._pos : self._pos + self.batch_size]
        batch = {k: v[take] for k, v in self.arrays.items()}
        self.batches_materialized += 1
        self._advance()
        return batch

    def skip(self, n: int) -> int:
        """Advance ``n`` batches by index arithmetic only — no row gathers.
        Returns how many were skipped (short only on exhaustion)."""
        skipped = 0
        while skipped < n and not self._exhausted:
            self._ensure_epoch()
            remaining = len(range(self._pos, self._end, self.batch_size))
            take = min(n - skipped, remaining)
            if take < remaining:
                self._pos += take * self.batch_size
            else:
                # cross the epoch boundary through _advance so the loop /
                # exhaustion rules stay identical to the next() path
                self._pos += (take - 1) * self.batch_size
                self._advance()
            skipped += take
        return skipped


def batch_iterator(
    arrays: Dict[str, np.ndarray],
    batch_size: int,
    *,
    shuffle: bool = True,
    seed: int = 0,
    drop_remainder: bool = True,
    loop: bool = True,
) -> Iterator[Dict[str, np.ndarray]]:
    """Minibatch iterator over array dicts (see :class:`BatchIterator`)."""
    return BatchIterator(
        arrays,
        batch_size,
        shuffle=shuffle,
        seed=seed,
        drop_remainder=drop_remainder,
        loop=loop,
    )


def synthetic_lm_batches(
    vocab_size: int,
    batch_size: int,
    seq_len: int,
    seed: int = 0,
    structured: bool = True,
) -> Iterator[Dict[str, np.ndarray]]:
    """Synthetic token streams for benchmarks/tests; ``structured=True`` yields
    learnable arithmetic sequences (loss can actually decrease). The stream is
    the JAX package's for the same arguments."""
    rng = np.random.default_rng(seed)
    while True:
        if structured:
            start = rng.integers(0, vocab_size, (batch_size, 1))
            step = rng.integers(1, 7, (batch_size, 1))
            toks = (start + step * np.arange(seq_len)[None, :]) % vocab_size
        else:
            toks = rng.integers(0, vocab_size, (batch_size, seq_len))
        yield {"tokens": toks.astype(np.int32)}
