"""Memmap-backed decoded-sample cache of the train loaders (port of
``gdn_tpu/data/cache.py``).

The first epoch decodes each PNG and stores the sample in its wire
dtypes; every later epoch reads it back from a flat memmap instead of
decoding again.

Layout under ``cache_dir`` (one cache per list and train size):

- ``manifest.json``: ``{n, height, width, depth_scale, key}``; ``key``
  fingerprints the entry list and the decode geometry, so a cache of
  another corpus, size or scale is rebuilt, never served;
- ``rgb.u8``: (N, H, W, 3) uint8;
- ``depth.u16``: (N, H, W) uint16 depth counts (value / scale meters,
  the loaders' wire convention);
- ``valid.u8``: (N,) flags, set after a sample's arrays are written;
  the cache fills lazily during the first epoch, and a partly filled
  cache is always correct.

Arrays deleted or truncated behind a surviving manifest are rebuilt.
A directory is held by one process at a time (an exclusive flock):
another process's rebuild would truncate the memmaps under this one's
already-set flags.
"""

from __future__ import annotations

import fcntl
import hashlib
import json
import os
import threading
from typing import Sequence, Tuple

import numpy as np

_MANIFEST = "manifest.json"
_LOCKFILE = "lock"

# flock handles this process holds, keyed by realpath(cache_dir): the
# lock is exclusive across processes and shared within one; held for
# the process's life, released by the OS at exit
_HELD_LOCKS: dict = {}
_HELD_LOCKS_GUARD = threading.Lock()


def _acquire_dir_lock(cache_dir: str) -> None:
    """Take the exclusive cross-process flock of ``cache_dir`` before
    deciding between reuse and rebuild; a lock held elsewhere raises."""
    key = os.path.realpath(cache_dir)
    with _HELD_LOCKS_GUARD:
        if key in _HELD_LOCKS:
            return
        f = open(os.path.join(cache_dir, _LOCKFILE), "w")
        try:
            fcntl.flock(f, fcntl.LOCK_EX | fcntl.LOCK_NB)
        except OSError:
            f.close()
            raise RuntimeError(
                f"decode cache {cache_dir!r} is locked by another process: each "
                "concurrent run needs its own --decode_cache directory (or wait for "
                "the holder to exit)") from None
        _HELD_LOCKS[key] = f


def corpus_key(entries, size: Tuple[int, int], depth_scale: float) -> str:
    """Fingerprint of the decode geometry and the entry list."""
    h = hashlib.sha1()
    h.update(f"{size[0]}x{size[1]}@{depth_scale}".encode())
    for e in entries:
        h.update(" ".join(e).encode())
        h.update(b"\n")
    return h.hexdigest()


class DecodedSampleCache:
    """Lazily filled memmap cache of (rgb uint8, depth counts uint16)
    samples at the train size."""

    def __init__(self, cache_dir: str, n: int, size: Tuple[int, int], depth_scale: float,
                 key: str):
        self.dir = cache_dir
        h, w = size
        os.makedirs(cache_dir, exist_ok=True)
        _acquire_dir_lock(cache_dir)
        manifest = {"n": n, "height": h, "width": w, "depth_scale": depth_scale, "key": key}
        mpath = os.path.join(cache_dir, _MANIFEST)
        fresh = True
        if os.path.exists(mpath):
            try:
                with open(mpath) as f:
                    fresh = json.load(f) != manifest
            except (OSError, ValueError):
                fresh = True
        if not fresh:
            # a manifest is no proof: missing or short arrays rebuild
            sizes = {"rgb.u8": n * h * w * 3, "depth.u16": n * h * w * 2, "valid.u8": n}
            for fname, want in sizes.items():
                fp = os.path.join(cache_dir, fname)
                if not os.path.exists(fp) or os.path.getsize(fp) < want:
                    fresh = True
                    break
        mode = "w+" if fresh else "r+"
        self.rgb = np.memmap(os.path.join(cache_dir, "rgb.u8"), np.uint8, mode,
                             shape=(n, h, w, 3))
        self.depth = np.memmap(os.path.join(cache_dir, "depth.u16"), np.uint16, mode,
                               shape=(n, h, w))
        self.valid = np.memmap(os.path.join(cache_dir, "valid.u8"), np.uint8, mode,
                               shape=(n,))
        if fresh:
            self.valid[:] = 0
            with open(mpath, "w") as f:
                json.dump(manifest, f)

    def split_hits(self, idx: Sequence[int]):
        """(hit positions, miss positions) within the batch ``idx``."""
        flags = self.valid[np.asarray(idx)]
        pos = np.arange(len(idx))
        return pos[flags > 0], pos[flags == 0]

    def read(self, idx: Sequence[int]):
        """(B, H, W, 3) uint8 and (B, H, W) uint16 copies of cached samples."""
        a = np.asarray(idx)
        return self.rgb[a], self.depth[a]

    def write(self, idx: Sequence[int], rgb_u8: np.ndarray, depth16: np.ndarray) -> None:
        for j, i in enumerate(idx):
            self.rgb[i] = rgb_u8[j]
            self.depth[i] = depth16[j]
        # the flags last: a crash mid-write leaves the sample missing,
        # not half written and trusted
        self.valid[np.asarray(idx)] = 1
