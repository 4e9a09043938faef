"""Batch-index machinery of the host train loaders (port of
``gdn_tpu/data/batching.py``; numpy on both sides, so the port's loaders
yield the JAX loaders' batches in the same order for the same seed).

A looping loader drops the trailing partial batch of each pass (its
samples return after the next shuffle).  A non-looping one pads it to
the batch size by repeating the last sample, and the padded rows' masks
are zeroed (a wire batch zeroes their depth counts, which the device
decodes to mask 0), so they add nothing to masked losses or metrics.
"""

from __future__ import annotations

from typing import Dict, Iterator, Tuple

import numpy as np


def iter_batch_indices(order: np.ndarray, batch_size: int,
                       loop: bool) -> Iterator[Tuple[np.ndarray, int]]:
    """Yield (indices, n_padded) chunks of exactly ``batch_size``: with
    ``loop`` the partial tail is dropped, without it the tail is padded
    by repeating the last index and ``n_padded`` counts the padding."""
    n = len(order)
    usable = n - n % batch_size
    for start in range(0, usable, batch_size):
        yield order[start:start + batch_size], 0
    rem = n - usable
    if rem and not loop:
        idx = np.concatenate([order[usable:], np.repeat(order[n - 1:n], batch_size - rem)])
        yield idx, batch_size - rem


class SeekableLoaderMixin:
    """Deterministic data order with resume.

    The batch sequence is a function of (seed, batch index): ``seek(n)``
    rebuilds the shuffle generator from ``self._seed`` and the next
    ``__iter__`` replays the index machinery (shuffles and chunking, no
    decode) for ``n`` batches.  A resumed run calls ``seek(state.step)``
    and sees the batches of an unbroken one, given the same seed, batch
    size and list file.

    Classes provide: entries, batch_size, shuffle, loop, _seed, _rng,
    _make_batch(idx).
    """

    _skip: int = 0

    def seek(self, n_batches: int) -> None:
        self._rng = np.random.default_rng(self._seed)
        self._skip = int(n_batches)

    def _index_iter(self) -> Iterator[Tuple[np.ndarray, int]]:
        order = np.arange(len(self.entries))
        if self.loop and len(order) < self.batch_size:
            # a looping loader drops the partial tail: with fewer samples
            # than one batch it would never yield, and the consumer would
            # wait forever
            raise ValueError(
                f"dataset has {len(order)} samples < batch_size {self.batch_size}; a "
                "looping loader would never yield a batch (shrink batch_size or "
                "enlarge the list)")
        while True:
            if self.shuffle:
                self._rng.shuffle(order)
            yield from iter_batch_indices(order, self.batch_size, self.loop)
            if not self.loop:
                break

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        skip, self._skip = self._skip, 0
        for idx, n_pad in self._index_iter():
            if skip:
                skip -= 1
                continue
            batch = self._make_batch(idx)
            if n_pad:
                if "mask" in batch:
                    batch["mask"][-n_pad:] = 0.0
                else:
                    # wire batch: zeroed counts decode to mask 0
                    batch["depth"][-n_pad:] = 0
            yield batch
