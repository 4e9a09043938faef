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
"""

from __future__ import annotations

from typing import Dict, Iterator, Tuple

import numpy as np
import torch

from gdn_tpu_torch.config import resolve_device
from gdn_tpu_torch.data.pipeline import upload


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


class DeviceResidentDataset:
    """A wire-format train loader (KittiTrainDataset, NyuTrainDataset)
    with its corpus on ``device`` (CUDA unless asked otherwise)."""

    def __init__(self, loader, device=None, max_bytes: int = 2 << 30, mesh=None):
        if mesh is not None:
            raise NotImplementedError("a device cache over a mesh is not ported to "
                                      "gdn_tpu_torch yet; see ROADMAP.md Queue A item 10 "
                                      "(parallel)")
        n = len(loader.entries)
        h, w = loader.size
        need = resident_bytes(n, h, w)
        if need > max_bytes:
            raise ValueError(
                f"device_cache: corpus needs {need / 2**30:.2f} GiB resident (> "
                f"{max_bytes / 2**30:.2f} GiB gate): use --decode_cache (host memmap) "
                "for corpora beyond the device's headroom")
        if not getattr(loader, "_wire", False):
            raise ValueError("device_cache requires the wire-format loader path "
                             "(train_wire='auto')")
        self.device = resolve_device(device)
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
            i = upload(idx.astype(np.int64), self.device)
            depth = self.depth.index_select(0, i)[..., None]
            if n_pad:
                depth[-n_pad:] = 0
            yield {"rgb": self.rgb.index_select(0, i), "depth": depth}


class ShardedDeviceDataset:
    """A corpus sharded over the devices of a mesh: not ported yet."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError("the sharded device cache is not ported to gdn_tpu_torch "
                                  "yet; see ROADMAP.md Queue A item 10 (parallel)")
