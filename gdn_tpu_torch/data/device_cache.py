"""Device-resident training corpus (port of ``gdn_tpu/data/device_cache.py``):
the decoded wire corpus lives on the card, a batch is a gather there,
and per step only the (B,) index array crosses from the host.

The order is exactly the wrapped loader's: the same shuffle (its own
index machinery drives the gathers), the same ``seek`` and the same wire
dtypes (uint8 RGB, uint16 depth counts carried as int16), and a
non-looping loader's padded tail has its depth counts zeroed, so the
device's mask leaves it out.

``resident_bytes`` estimates the corpus; one beyond ``max_bytes``
(2 GiB by default) is refused: ``--decode_cache`` (the host memmap)
serves larger corpora.

Over a data mesh (``parallel.mesh``), ``DeviceResidentDataset(mesh=)``
keeps the whole corpus on each rank and yields the rank's rows of each
global batch, and ``ShardedDeviceDataset`` keeps 1/D of it on each rank
(the gate is per rank) with the JAX package's order: each shard
shuffles its own slice (shard s seeded ``[seed, s]``, shard 0 with the
loader's seed), and the global batch is the concatenation of the D
sub-batches of B/D.
"""

from __future__ import annotations

import itertools
from typing import Dict, Iterator, Tuple

import numpy as np
import torch

from gdn_tpu_torch.config import resolve_device
from gdn_tpu_torch.data.batching import iter_batch_indices
from gdn_tpu_torch.data.pipeline import upload
from gdn_tpu_torch.parallel.mesh import data_rank, data_size, local_rows, spatial_size


def resident_bytes(n: int, h: int, w: int) -> int:
    """uint8 RGB + uint16 depth counts of n samples."""
    return n * (h * w * 3 + h * w * 2)


def _decode_corpus(loader, n: int, h: int, w: int) -> Tuple[np.ndarray, np.ndarray]:
    """The loader's whole corpus in wire dtypes, through its decode cache
    when it has one (hits read, misses decoded and written back)."""
    rgb = np.empty((n, h, w, 3), np.uint8)
    depth = np.empty((n, h, w), np.uint16)
    host_cache = getattr(loader, "_cache", None)
    step = max(1, loader.batch_size)
    for s in range(0, n, step):
        idx = np.arange(s, min(s + step, n))
        if host_cache is not None:
            hit, miss = host_cache.split_hits(idx)
            if len(hit):
                rgb[idx[hit]], depth[idx[hit]] = host_cache.read(idx[hit])
            if len(miss):
                mr, md = loader._decode_wire(idx[miss])
                rgb[idx[miss]], depth[idx[miss]] = mr, md
                host_cache.write(idx[miss], mr, md)
        else:
            rgb[idx], depth[idx] = loader._decode_wire(idx)
    return rgb, depth


def _check_wire_loader(loader) -> None:
    if not getattr(loader, "_wire", False):
        raise ValueError("device_cache requires the wire-format loader path "
                         "(train_wire='auto')")


class DeviceResidentDataset:
    """A wire-format train loader (KittiTrainDataset, NyuTrainDataset)
    with its corpus on ``device`` (CUDA unless asked otherwise).  With a
    data ``mesh`` each rank holds the whole corpus and yields its rows
    of each global batch."""

    def __init__(self, loader, device=None, max_bytes: int = 2 << 30, mesh=None):
        n = len(loader.entries)
        h, w = loader.size
        need = resident_bytes(n, h, w)
        if need > max_bytes:
            raise ValueError(
                f"device_cache: corpus needs {need / 2**30:.2f} GiB resident (> "
                f"{max_bytes / 2**30:.2f} GiB gate): use --decode_cache (host memmap) "
                "for corpora beyond the device's headroom")
        _check_wire_loader(loader)
        self.device = resolve_device(device)
        self._rows = local_rows(loader.batch_size, mesh)
        self._loader = loader
        self.wire_depth_scale = loader.wire_depth_scale
        self.batch_size = loader.batch_size
        rgb, depth = _decode_corpus(loader, n, h, w)
        self.rgb = torch.from_numpy(rgb).to(self.device)
        self.depth = torch.from_numpy(depth.view(np.int16)).to(self.device)

    @property
    def resident_bytes(self) -> int:
        return self.rgb.nbytes + self.depth.nbytes

    def __len__(self) -> int:
        return len(self._loader.entries)

    def seek(self, n_batches: int) -> None:
        self._loader.seek(n_batches)

    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        ld = self._loader
        skip, ld._skip = ld._skip, 0
        for idx, n_pad in ld._index_iter():
            if skip:
                skip -= 1
                continue
            s, e = self._rows
            i = upload(idx[s:e].astype(np.int64), self.device)
            depth = self.depth.index_select(0, i)[..., None]
            pad = min(e - s, max(0, e - (len(idx) - n_pad)))  # padded-tail rows among mine
            if pad:
                depth[-pad:] = 0
            yield {"rgb": self.rgb.index_select(0, i), "depth": depth}


class ShardedDeviceDataset:
    """The corpus sharded over a 1-D data mesh: rank s holds the
    contiguous slice [s n_local, (s+1) n_local) (n_local = ceil(n / D))
    plus one all-zero PAD row, and gathers its B/D rows of each global
    batch there; per step only its (B/D,) indices cross from the host.

    The order is the JAX package's ``ShardedDeviceDataset``'s, not the
    wrapped loader's: shard s shuffles its own slice with
    ``default_rng([seed, s])`` (shard 0 with the loader's seed, so one
    rank reproduces the loader's stream), the global batch is the
    concatenation of the D sub-batches, partial tails index the PAD row
    (depth 0: mask 0 on the device), and a non-looping run goes on while
    any shard has batches (``zip_longest``).  ``seek`` skips batches."""

    def __init__(self, loader, mesh, max_bytes_per_device: int = 2 << 30, device=None):
        if mesh is None:
            raise ValueError("ShardedDeviceDataset requires a mesh")
        if spatial_size(mesh) > 1:
            raise ValueError("sharded device cache supports 1-D data meshes only (a "
                             "spatial mesh shards batch HEIGHT; use DeviceResidentDataset "
                             "/ --decode_cache there)")
        _check_wire_loader(loader)
        d = data_size(mesh)
        if loader.batch_size % d:
            raise ValueError(f"batch_size {loader.batch_size} not divisible by the mesh "
                             f"data extent {d}")
        n = len(loader.entries)
        h, w = loader.size
        n_local = -(-n // d)  # ceil
        need = resident_bytes(n_local + 1, h, w)
        if need > max_bytes_per_device:
            raise ValueError(
                f"sharded device_cache: each of {d} devices needs {need / 2**30:.2f} GiB "
                f"resident (> {max_bytes_per_device / 2**30:.2f} GiB gate): use "
                "--decode_cache (host memmap) instead")
        self._loader = loader
        self._d = d
        self._n_local = n_local
        self._bl = loader.batch_size // d
        self._counts = [max(0, min(n - s * n_local, n_local)) for s in range(d)]
        self._rank = data_rank(mesh)
        self.wire_depth_scale = loader.wire_depth_scale
        self.batch_size = loader.batch_size
        if loader.loop and min(self._counts) < self._bl:
            raise ValueError(
                f"smallest corpus shard has {min(self._counts)} samples < per-device "
                f"batch {self._bl}; a looping sharded cache would starve that device "
                "(shrink the mesh or batch size)")
        self.device = resolve_device(device)
        rgb, depth = _decode_corpus(loader, n, h, w)
        s, c = self._rank, self._counts[self._rank]
        mine = slice(s * n_local, s * n_local + c)
        rgb_s = np.zeros((n_local + 1, h, w, 3), np.uint8)
        dep_s = np.zeros((n_local + 1, h, w), np.uint16)
        rgb_s[:c], dep_s[:c] = rgb[mine], depth[mine]
        self.rgb = torch.from_numpy(rgb_s).to(self.device)
        self.depth = torch.from_numpy(dep_s.view(np.int16)).to(self.device)
        self._skip = 0

    @property
    def resident_bytes(self) -> int:
        return self.rgb.nbytes + self.depth.nbytes

    def __len__(self) -> int:
        return len(self._loader.entries)

    def seek(self, n_batches: int) -> None:
        self._skip = int(n_batches)

    def _shard_stream(self, s: int) -> Iterator[Tuple[np.ndarray, int]]:
        ld = self._loader
        rng = np.random.default_rng(ld._seed if s == 0 else [ld._seed, s])
        order = np.arange(self._counts[s])
        while True:
            if ld.shuffle:
                rng.shuffle(order)
            yield from iter_batch_indices(order, self._bl, ld.loop)
            if not ld.loop:
                break

    def _index_iter(self) -> Iterator[np.ndarray]:
        """Global (B,) batches of shard-local indices, shard s's block at
        [s B/D, (s+1) B/D); padded rows index the PAD slot."""
        pad = self._n_local
        fill = (np.full((self._bl,), pad, np.int64), 0)
        streams = [self._shard_stream(s) for s in range(self._d)]
        zipped = (zip(*streams) if self._loader.loop
                  else itertools.zip_longest(*streams, fillvalue=fill))
        for subs in zipped:
            out = np.empty((self.batch_size,), np.int32)
            for s, (idx, n_pad) in enumerate(subs):
                blk = idx.astype(np.int32, copy=True)
                if n_pad:
                    blk[-n_pad:] = pad
                out[s * self._bl:(s + 1) * self._bl] = blk
            yield out

    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        skip, self._skip = self._skip, 0
        lo = self._rank * self._bl
        for idx in self._index_iter():
            if skip:
                skip -= 1
                continue
            i = upload(idx[lo:lo + self._bl].astype(np.int64), self.device)
            yield {"rgb": self.rgb.index_select(0, i),
                   "depth": self.depth.index_select(0, i)[..., None]}
