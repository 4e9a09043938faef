"""The grain loader's counterpart (port of ``gdn_tpu/data/grain_loader.py``),
without the ``grain`` package: the same batches in the same order, a
checkpointable cursor that is exact at any worker count, and decode
workers that are threads.

grain's order, reproduced here:

- ``IndexSampler(shuffle=True, seed=s, num_epochs=None)`` puts record
  ``index_shuffle(i, max_index=n - 1, seed=(s + epoch) % 2**32,
  rounds=4)`` at position ``epoch * n + i`` of an unbounded stream.
  ``index_shuffle`` is grain's compiled permutation: a Simon block
  cipher on the smallest even bit width (at least 16) that holds
  ``max_index``, its round keys drawn by ``std::seed_seq{seed}``, walked
  again until the value falls in range.  (grain's pure-Python
  ``index_shuffle`` computes another permutation.)
- ``Batch(B, drop_remainder=True)``: with ``worker_count`` 0 or 1 a
  batch is B consecutive positions, across epoch boundaries.  With W >
  1 workers, worker k batches its own positions k, k + W, k + 2W, ...,
  and the batches come from the workers in turn (worker 0's first, then
  worker 1's first, ...).

Workers here are threads, not processes: a fork after CUDA breaks the
child, and PIL's decode and resize release the GIL.  ``worker_count``
threads decode the samples of the next batches; the batches come out in
the order above whatever order the threads finish in.

The cursor (``state_dict``) is this port's own JSON: each worker's next
stream position and the worker whose batch comes next.
"""

from __future__ import annotations

import collections
import json
import math
import os
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, List, Tuple

import numpy as np

from gdn_tpu_torch.data.kitti import load_depth, load_rgb_u8, parse_list
from gdn_tpu_torch.data.nyu import _resize_rgb_u8, center_crop_nyu, load_nyu_depth

_M32 = 0xFFFFFFFF
_MIN_BLOCK_BITS = 16


def _seed_seq_keys(seed: int, n: int) -> List[int]:
    """``std::seed_seq{seed}.generate`` into n 32-bit words (the C++
    standard's algorithm, [rand.util.seedseq])."""
    v, s = [seed & _M32], 1
    b = [0x8B8B8B8B] * n
    t = 11 if n >= 623 else 7 if n >= 68 else 5 if n >= 39 else 3 if n >= 7 else (n - 1) // 2
    p = (n - t) // 2
    q = p + t
    m = max(s + 1, n)

    def mix(x):
        return (x ^ (x >> 27)) & _M32

    for k in range(m):
        r1 = (1664525 * mix(b[k % n] ^ b[(k + p) % n] ^ b[(k - 1) % n])) & _M32
        r2 = (r1 + s if k == 0 else r1 + k % n + v[k - 1] if k <= s else r1 + k % n) & _M32
        b[(k + p) % n] = (b[(k + p) % n] + r1) & _M32
        b[(k + q) % n] = (b[(k + q) % n] + r2) & _M32
        b[k % n] = r2
    for k in range(m, m + n):
        r3 = (1566083941 * mix((b[k % n] + b[(k + p) % n] + b[(k - 1) % n]) & _M32)) & _M32
        r4 = (r3 - k % n) & _M32
        b[(k + p) % n] ^= r3
        b[(k + q) % n] ^= r4
        b[k % n] = r4
    return b


def _simon(max_index: int, seed: int, rounds: int):
    """The block cipher of ``index_shuffle`` for [0, max_index]: a Simon
    encryption on the smallest even bit width (at least 16) that holds
    max_index, keyed by ``std::seed_seq{seed}``; returns (encrypt, bits)."""
    if rounds < 4 or rounds % 2:
        raise ValueError(f"rounds must be even and at least 4, got {rounds}")
    bits = int(math.ceil(math.log2(max_index)))
    bits = max(bits + bits % 2, _MIN_BLOCK_BITS)
    half = bits // 2
    mask = np.uint64((1 << half) - 1)
    keys = [np.uint64(k) & mask for k in _seed_seq_keys(int(seed), rounds)]

    def rotl(v, k):
        k %= half
        if k == 0:
            return v
        return ((v << np.uint64(k)) & mask) | (v >> np.uint64(half - k))

    def f(v):
        return (rotl(v, 1) & rotl(v, 8)) ^ rotl(v, 2)

    def encrypt(v):
        left, right = (v >> np.uint64(half)) & mask, v & mask
        for i in range(0, rounds, 2):
            left = left ^ f(right) ^ keys[i]
            right = right ^ f(left) ^ keys[i + 1]
        return (left << np.uint64(half)) | right

    return encrypt, bits


def index_shuffle(index, max_index: int, seed: int, rounds: int = 4) -> np.ndarray:
    """grain's ``index_shuffle(index, max_index, seed, rounds)`` over an
    array of indices: the position of each in a pseudorandom permutation
    of [0, max_index]."""
    idx = np.asarray(index, dtype=np.uint64)
    if max_index == 0:
        return np.zeros_like(idx)
    encrypt, _ = _simon(max_index, seed, rounds)
    out = encrypt(idx)
    todo = out > np.uint64(max_index)
    while todo.any():  # cycle-walk back into [0, max_index]
        out[todo] = encrypt(out[todo])
        todo = out > np.uint64(max_index)
    return out


def epoch_permutation(n: int, seed: int, rounds: int = 4) -> np.ndarray:
    """``index_shuffle(arange(n), n - 1, seed, rounds)`` for a whole epoch
    (int64).  One encryption of the block's whole domain, then the cycle
    walk by pointer doubling: each value jumps along its chain of
    out-of-range values in a logarithmic number of gathers (a walk one
    encryption at a time takes ~2^16 / n steps for a small n)."""
    if n == 1:
        return np.zeros(1, np.int64)
    encrypt, bits = _simon(n - 1, seed, rounds)
    val = encrypt(np.arange(1 << bits, dtype=np.uint64)).astype(np.int64)
    done = val < n
    while not done[:n].all():
        todo = np.flatnonzero(~done)
        nxt = val[todo]
        val[todo], done[todo] = val[nxt], done[nxt]
    return val[:n]


class _PairSource:
    """One unbatched sample per record index, as grain's data source
    decodes it (``_PairSource`` of the JAX module).

    ``wire=True`` (DataConfig.train_wire="auto"): uint8 RGB and uint16
    depth counts (round(depth * wire_scale)), decoded on the device;
    otherwise float RGB / 255, the clipped depth and the mask."""

    wire_scale = 256.0  # KITTI 16-bit-PNG counts per meter

    def __init__(self, data_path: str, entries, size: Tuple[int, int], max_depth: float,
                 wire: bool = False):
        self.data_path = data_path
        self.entries = entries
        self.size = size
        self.max_depth = max_depth
        self.wire = wire

    def __len__(self) -> int:
        return len(self.entries)

    def _decode(self, rgb_path: str, d_path: str):
        return load_rgb_u8(rgb_path, self.size), load_depth(d_path, self.size)

    def __getitem__(self, i: int) -> Dict[str, np.ndarray]:
        rgb_rel, d_rel = self.entries[i]
        rgb, depth = self._decode(os.path.join(self.data_path, rgb_rel),
                                  os.path.join(self.data_path, d_rel))
        depth = depth[..., None]
        if self.wire:
            d16 = np.clip(np.round(depth * self.wire_scale), 0, 65535).astype(np.uint16)
            return {"rgb": rgb, "depth": d16}
        mask = ((depth > 0.0) & (depth < self.max_depth)).astype(np.float32)
        return {"rgb": rgb.astype(np.float32) / 255.0,
                "depth": np.clip(depth, 0.0, self.max_depth).astype(np.float32),
                "mask": mask}


class _NyuPairSource(_PairSource):
    """NYU: the white border cropped before the resize; depth PNGs in mm."""

    wire_scale = 1000.0  # NYU mm-PNG counts per meter

    def _decode(self, rgb_path: str, d_path: str):
        rgb = center_crop_nyu(load_rgb_u8(rgb_path))
        if rgb.shape[:2] != tuple(self.size):
            rgb = _resize_rgb_u8(rgb, self.size)
        return rgb, load_nyu_depth(d_path, self.size)


class GrainKittiDataset:
    """KITTI (or ``dataset="nyu"``) train loader in grain's order.

    Iterate for batches ({'rgb', 'depth'} on the wire, + 'mask' in f32).
    ``state_dict()`` / ``load_state_dict()`` capture and restore the
    exact stream position; ``state_dict_at(consumed)`` returns the
    position as of a given number of produced batches (the checkpoint's
    form when a prefetch queue runs ahead of the trainer); ``seek(n)``
    positions a single index stream (``worker_count`` 0 or 1) at batch n.
    """

    # batches a pool of decode threads works ahead of the consumer
    LOOKAHEAD = 2

    def __init__(self, data_path: str, list_file: str, size: Tuple[int, int] = (128, 416),
                 batch_size: int = 32, shuffle: bool = True, seed: int = 0,
                 max_depth: float = 80.0, worker_count: int = 0, dataset: str = "kitti",
                 wire: str = "auto"):
        entries = parse_list(os.path.join(data_path, list_file))
        if not entries:
            raise ValueError(f"empty list file {list_file}")
        for e in entries:
            if len(e) != 2:
                raise ValueError(f"train list lines must be '<rgb> <depth>', got {e!r}")
        if worker_count < 0:
            raise ValueError(f"worker_count must be >= 0, got {worker_count}")
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = int(seed)
        self.worker_count = worker_count
        src_cls = _NyuPairSource if dataset == "nyu" else _PairSource
        self._source = src_cls(data_path, entries, size, max_depth, wire=wire == "auto")
        # the device pipeline's counts-to-meters scale (data/pipeline.py)
        self.wire_depth_scale = src_cls.wire_scale
        self._streams = max(worker_count, 1)  # index streams: one per worker
        self._cursor = self._initial_cursor()
        self._perms: Dict[int, np.ndarray] = {}
        # (produced batches, state) after each produced batch, plus the
        # base entry of the last rebase; read by state_dict_at under the lock
        self._produced = 0
        self._state_log: collections.deque = collections.deque(maxlen=64)
        self._state_log.append((0, self._state_json(self._cursor)))
        self._state_lock = threading.Lock()
        self._rebases = 0  # counts rebases: see _rebase

    def __len__(self) -> int:
        return len(self._source)

    @property
    def decoder(self) -> str:
        return f"pil, {self.worker_count} threads" if self.worker_count else "pil"

    # -- the order ---------------------------------------------------------
    def _initial_cursor(self) -> Dict[str, object]:
        return {"next": list(range(self._streams)), "worker": 0}

    def _state_json(self, cursor) -> str:
        return json.dumps({"version": 1, "worker_count": self.worker_count,
                           "num_records": len(self._source), "seed": self.seed,
                           "shuffle": self.shuffle, "batch_size": self.batch_size,
                           "next_positions": cursor["next"],
                           "next_worker": cursor["worker"]})

    def _epoch_perm(self, epoch: int) -> np.ndarray:
        perm = self._perms.get(epoch)
        if perm is None:
            n = len(self._source)
            perm = (epoch_permutation(n, (self.seed + epoch) % 2**32) if self.shuffle
                    else np.arange(n, dtype=np.int64))
            if len(self._perms) > 2:
                self._perms.pop(min(self._perms))
            self._perms[epoch] = perm
        return perm

    def records(self, positions: np.ndarray) -> np.ndarray:
        """The record indices at stream positions (grain's sampler)."""
        n = len(self._source)
        epochs, within = np.divmod(np.asarray(positions, dtype=np.int64), n)
        out = np.empty(len(within), np.int64)
        for e in np.unique(epochs):
            sel = epochs == e
            out[sel] = self._epoch_perm(int(e))[within[sel]]
        return out

    def _advance(self, cursor) -> np.ndarray:
        """The next batch's stream positions, advancing ``cursor``."""
        w, k, b = cursor["worker"], self._streams, self.batch_size
        pos = cursor["next"][w] + k * np.arange(b, dtype=np.int64)
        cursor["next"][w] = int(pos[-1]) + k
        cursor["worker"] = (w + 1) % k
        return pos

    # -- the cursor API ----------------------------------------------------
    def state_dict(self) -> str:
        """The raw stream position (what the next batch will be).  With a
        prefetch queue downstream, checkpoint :meth:`state_dict_at`."""
        with self._state_lock:
            return self._state_json(self._cursor)

    def state_dict_at(self, consumed: int) -> str:
        """The stream position as of ``consumed`` produced batches: the
        checkpoint-correct form while a prefetch queue runs ahead of the
        trainer.  The last 64 positions are kept."""
        with self._state_lock:
            for n, s in self._state_log:
                if n == consumed:
                    return s
        raise ValueError(
            f"no recorded loader state for batch {consumed} (produced={self._produced}, "
            f"log window={len(self._state_log)}/{self._state_log.maxlen}); states are "
            f"recorded per produced batch and the log keeps the most recent "
            f"{self._state_log.maxlen}")

    def load_state_dict(self, state: str, produced: int = 0) -> None:
        """Restore a ``state_dict()`` / ``state_dict_at()`` position.
        ``produced`` rebases the batch count, so later
        ``state_dict_at(step)`` calls line up with the trainer's step."""
        obj = json.loads(state)
        mine = json.loads(self._state_json(self._cursor))
        for key in ("worker_count", "num_records", "seed", "shuffle", "batch_size"):
            if obj.get(key) != mine[key]:
                raise ValueError(f"loader state was saved with {key}={obj.get(key)!r}; "
                                 f"this loader has {mine[key]!r}")
        self._rebase({"next": [int(p) for p in obj["next_positions"]],
                      "worker": int(obj["next_worker"])}, produced)

    def seek(self, n_batches: int) -> None:
        """Position the stream at batch ``n_batches`` (sampling only, no
        decode).  One index stream only (``worker_count`` 0 or 1), as the
        JAX loader; more workers round-trip ``state_dict_at`` /
        ``load_state_dict`` instead."""
        if self._streams != 1:
            raise NotImplementedError(
                "seek() supports worker_count=0; use state_dict()/"
                "load_state_dict() for multiprocess loaders")
        self._rebase({"next": [int(n_batches) * self.batch_size], "worker": 0}, n_batches)

    def _rebase(self, cursor, produced: int) -> None:
        """Move the stream to ``cursor`` as of ``produced`` batches; a
        live iterator drops the batches it decoded ahead."""
        with self._state_lock:
            self._cursor = cursor
            self._produced = int(produced)
            self._state_log.clear()
            self._state_log.append((self._produced, self._state_json(cursor)))
            self._rebases += 1

    # -- the batches -------------------------------------------------------
    def _assemble(self, samples) -> Dict[str, np.ndarray]:
        return {k: np.stack([s[k] for s in samples]) for k in samples[0]}

    def _next_indices(self) -> Tuple[np.ndarray, int]:
        """The next batch's record indices, and the rebase count they
        belong to; the position is advanced and logged under the lock, so
        a rebase never interleaves with it."""
        with self._state_lock:
            pos = self._advance(self._cursor)
            self._produced += 1
            self._state_log.append((self._produced, self._state_json(self._cursor)))
            return self.records(pos), self._rebases

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        if self.worker_count == 0:
            while True:
                idx, _ = self._next_indices()
                yield self._assemble([self._source[int(i)] for i in idx])
        pool = ThreadPoolExecutor(self.worker_count, thread_name_prefix="grain-decode")
        pending: collections.deque = collections.deque()
        try:
            while True:
                if pending and pending[0][0] != self._rebases:
                    _cancel(pending)  # decoded ahead of a rebase: stale
                while len(pending) < self.LOOKAHEAD:
                    idx, rebases = self._next_indices()
                    pending.append((rebases, [pool.submit(self._source.__getitem__, int(i))
                                              for i in idx]))
                yield self._assemble([f.result() for f in pending.popleft()[1]])
        finally:
            _cancel(pending)
            pool.shutdown(wait=True)


def _cancel(pending: collections.deque) -> None:
    while pending:
        for f in pending.popleft()[1]:
            f.cancel()

