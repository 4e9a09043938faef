"""KITTI loaders (port of ``gdn_tpu/data/kitti.py``; numpy and PIL, the
same batches as the JAX package's loaders for the same files and seed).

The host only decodes and resizes to the train size; the augmentation
runs on the device (``data/augment.py``).

- ``KittiTrainDataset``: prepared training pairs at 128x416, list lines
  ``<rgb> <depth>`` relative to ``data_path``; depth is ``.npy``
  (float32 meters) or a 16-bit PNG (counts / 256 m, 0 = invalid).
- ``KittiEvalDataset``: the Eigen test split: RGB at the train size and
  the GT at its raw size (``.npy``, 16-bit PNG, or projected from a
  velodyne ``.bin`` with ``calib_dir``'s calibration).
"""

from __future__ import annotations

import os
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
from PIL import Image

from gdn_tpu_torch.data.batching import SeekableLoaderMixin


def parse_list(path: str) -> List[List[str]]:
    """A list file as per-line token lists; '#' starts a comment line."""
    entries = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            entries.append(line.split())
    return entries


def _png_bit_depth(path: str) -> int:
    """A PNG's bit depth from its IHDR header (byte 24: 8 signature + 4
    length + 'IHDR' + 4 width + 4 height); 0 if unreadable."""
    try:
        with open(path, "rb") as f:
            head = f.read(25)
        if len(head) == 25 and head[:8] == b"\x89PNG\r\n\x1a\n":
            return head[24]
    except OSError:
        pass
    return 0


def load_rgb(path: str, size: Optional[Tuple[int, int]] = None) -> np.ndarray:
    """RGB as float32 in [0, 1], optionally resized to (H, W) bilinearly."""
    return load_rgb_u8(path, size).astype(np.float32) / 255.0


def load_rgb_u8(path: str, size: Optional[Tuple[int, int]] = None) -> np.ndarray:
    """RGB as uint8, optionally resized to (H, W); PIL resizes in uint8,
    so this is exactly the wire form of ``load_rgb``."""
    img = Image.open(path).convert("RGB")
    if size is not None:
        img = img.resize((size[1], size[0]), Image.BILINEAR)
    return np.asarray(img, dtype=np.uint8)


def load_depth(path: str, size: Optional[Tuple[int, int]] = None) -> np.ndarray:
    """Depth in meters: ``.npy`` float32 meters, or a PNG (16-bit: counts
    / 256; otherwise the values as meters).  A resize is nearest, so
    sparse LiDAR points are not smeared."""
    if path.endswith(".npy"):
        depth = np.load(path).astype(np.float32)
    else:
        arr = np.asarray(Image.open(path))
        if arr.dtype == np.uint16:
            depth = arr.astype(np.float32) / 256.0
        else:
            depth = arr.astype(np.float32)
    if size is not None and depth.shape != tuple(size):
        img = Image.fromarray(depth).resize((size[1], size[0]), Image.NEAREST)
        depth = np.asarray(img, dtype=np.float32)
    return depth


def f32_batch(rgb: np.ndarray, depth: np.ndarray, max_depth: float) -> Dict[str, np.ndarray]:
    """The "f32" wire's batch: float RGB, depth (B, H, W, 1) clipped to
    [0, max_depth] and the mask 0 < depth < max_depth taken before the
    clip."""
    mask = ((depth > 0.0) & (depth < max_depth)).astype(np.float32)
    return {"rgb": rgb, "depth": np.clip(depth, 0.0, max_depth), "mask": mask}


def cached_wire(cache, idx: np.ndarray, size: Tuple[int, int], decode_wire):
    """(rgb uint8, depth uint16) of ``idx`` from a DecodedSampleCache:
    hits read, misses decoded by ``decode_wire`` and written back."""
    hit, miss = cache.split_hits(idx)
    if len(miss) == 0:
        return cache.read(idx)
    h, w = size
    rgb = np.empty((len(idx), h, w, 3), np.uint8)
    depth16 = np.empty((len(idx), h, w), np.uint16)
    if len(hit):
        rgb[hit], depth16[hit] = cache.read(idx[hit])
    mr, md = decode_wire(idx[miss])
    rgb[miss], depth16[miss] = mr, md
    cache.write(idx[miss], mr, md)
    return rgb, depth16


class KittiTrainDataset(SeekableLoaderMixin):
    """Batches of prepared KITTI training pairs.

    ``wire="auto"`` yields {'rgb' (B, H, W, 3) uint8, 'depth' (B, H, W,
    1) uint16 counts / 256 m}, decoded on the device
    (``augment.decode_wire_batch``); ``wire="f32"`` yields float32
    {'rgb', 'depth', 'mask'}.  The native decoder (``native_io``) serves
    when it is available and every depth file is a PNG whose first one
    is 16-bit; PIL otherwise.  ``cache_dir``: a DecodedSampleCache.
    ``seek(n)`` resumes the order at batch n.
    """

    def __init__(self, data_path: str, list_file: str, size: Tuple[int, int] = (128, 416),
                 batch_size: int = 32, shuffle: bool = True, seed: int = 0,
                 max_depth: float = 80.0, loop: bool = True, use_native: bool = True,
                 wire: str = "auto", cache_dir: str = ""):
        self.data_path = data_path
        self.entries = parse_list(os.path.join(data_path, list_file))
        if not self.entries:
            raise ValueError(f"empty list file {list_file}")
        for e in self.entries:
            if len(e) != 2:
                raise ValueError(f"train list lines must be '<rgb> <depth>', got {e!r}")
        self.size = size
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.max_depth = max_depth
        self.loop = loop
        self._seed = seed
        self._rng = np.random.default_rng(seed)
        # The native decoder applies the /256 convention to every PNG,
        # while load_depth reads a PNG that is not 16-bit as meters: the
        # gate checks the bit depth (the first file; annotation archives
        # are homogeneous), not only the extension, or the two decoders
        # would train on depths 256x apart.
        if use_native:
            from gdn_tpu_torch.data import native_io

            self._native = (native_io.available()
                            and all(e[1].endswith(".png") for e in self.entries)
                            and _png_bit_depth(os.path.join(data_path, self.entries[0][1]))
                            == 16)
        else:
            self._native = False
        self._wire = wire == "auto"
        self.wire_depth_scale = 256.0
        self._cache = None
        if cache_dir:
            from gdn_tpu_torch.data.cache import DecodedSampleCache, corpus_key

            self._cache = DecodedSampleCache(cache_dir, len(self.entries), size, 256.0,
                                             corpus_key(self.entries, size, 256.0))

    def __len__(self) -> int:
        return len(self.entries)

    @property
    def decoder(self) -> str:
        """The decoder this loader uses: "native" or "pil"."""
        return "native" if self._native else "pil"

    def _paths(self, idx, col: int) -> List[str]:
        return [os.path.join(self.data_path, self.entries[i][col]) for i in idx]

    def _load_pair(self, entry: Sequence[str]):
        rgb = load_rgb_u8(os.path.join(self.data_path, entry[0]), self.size)
        depth = load_depth(os.path.join(self.data_path, entry[1]), self.size)
        return rgb, depth

    def _decode_wire(self, idx) -> Tuple[np.ndarray, np.ndarray]:
        """(B, H, W, 3) uint8 RGB and (B, H, W) uint16 depth counts (/256
        m) of ``idx``: exact for 16-bit PNG depth, within 1/512 m for
        ``.npy``; the native decoder's float RGB quantizes by <= 1/510."""
        if self._native:
            from gdn_tpu_torch.data import native_io

            rgb = native_io.decode_rgb_batch(self._paths(idx, 0), *self.size)
            rgb = np.clip(np.round(rgb * 255.0), 0, 255).astype(np.uint8)
            depth = native_io.decode_depth_batch(self._paths(idx, 1), *self.size)
        else:
            rgbs, depths = zip(*(self._load_pair(self.entries[i]) for i in idx))
            rgb = np.stack(rgbs)
            depth = np.stack(depths)
        depth16 = np.clip(np.round(depth * 256.0), 0, 65535).astype(np.uint16)
        return rgb, depth16

    def _make_batch(self, idx) -> Dict[str, np.ndarray]:
        idx = np.asarray(idx)
        if self._cache is not None:
            rgb, depth16 = cached_wire(self._cache, idx, self.size, self._decode_wire)
            depth16 = depth16[..., None]
            if self._wire:
                return {"rgb": rgb, "depth": depth16}
            return f32_batch(rgb.astype(np.float32) / 255.0,
                             depth16.astype(np.float32) / 256.0, self.max_depth)
        if self._wire:
            rgb, depth16 = self._decode_wire(idx)
            return {"rgb": rgb, "depth": depth16[..., None]}
        if self._native:
            from gdn_tpu_torch.data import native_io

            rgb = native_io.decode_rgb_batch(self._paths(idx, 0), *self.size)
            depth = native_io.decode_depth_batch(self._paths(idx, 1), *self.size)[..., None]
        else:
            rgbs, depths = zip(*(self._load_pair(self.entries[i]) for i in idx))
            rgb = np.stack(rgbs).astype(np.float32) / 255.0
            depth = np.stack(depths)[..., None]
        return f32_batch(rgb, depth, self.max_depth)


class KittiEvalDataset:
    """The Eigen split: {'rgb' (1, H, W, 3) float32 at the train size,
    'gt' (1, Hg, Wg) float32 at the raw size}.

    List lines: ``<rgb> <gt>``, the GT a depth ``.npy``/``.png`` or a
    velodyne ``.bin`` (projected with the calibration in ``calib_dir``
    at the raw RGB's size).
    """

    def __init__(self, data_path: str, list_file: str, size: Tuple[int, int] = (128, 416),
                 calib_dir: Optional[str] = None):
        self.data_path = data_path
        self.entries = parse_list(os.path.join(data_path, list_file))
        self.size = size
        self.calib_dir = calib_dir

    def __len__(self) -> int:
        return len(self.entries)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        for entry in self.entries:
            rgb_path, gt_path = entry[0], entry[1]
            rgb = load_rgb(os.path.join(self.data_path, rgb_path), self.size)
            full = os.path.join(self.data_path, gt_path)
            if gt_path.endswith(".bin"):
                from gdn_tpu_torch.data.velodyne import depth_from_velodyne_files

                if not self.calib_dir:
                    raise ValueError(f"{gt_path}: velodyne GT needs calib_dir "
                                     "(--calib_dir)")
                with Image.open(os.path.join(self.data_path, rgb_path)) as img:
                    raw_shape = (img.height, img.width)  # the header, no decode
                gt = depth_from_velodyne_files(full, self.calib_dir, raw_shape)
            else:
                gt = load_depth(full)
            yield {"rgb": rgb[None], "gt": gt[None].astype(np.float32)}
