"""NYU Depth v2 loaders (port of ``gdn_tpu/data/nyu.py``): indoor RGB-D
at 228x304, 10 m cap, the 654-image test split.

Two formats: pair lists as for KITTI (``<rgb> <depth>``, depth ``.npy``
meters or a 16-bit PNG in millimeters), and the official
``nyu_depth_v2_labeled.mat`` (HDF5, read with h5py, imported only
there).  The protocol crops the 480x640 frames to (45:471, 41:601), the
region without the white border, before any resize.
"""

from __future__ import annotations

import os
from typing import Dict, Iterator, Optional, Tuple

import numpy as np
from PIL import Image

from gdn_tpu_torch.data.batching import SeekableLoaderMixin
from gdn_tpu_torch.data.kitti import cached_wire, f32_batch, load_rgb, load_rgb_u8, parse_list

NYU_CROP = (45, 471, 41, 601)  # top, bottom, left, right on 480x640 frames


def center_crop_nyu(arr: np.ndarray) -> np.ndarray:
    """The NYU crop of a 480x640 frame; other sizes pass unchanged."""
    if arr.shape[0] == 480 and arr.shape[1] == 640:
        t, b, l, r = NYU_CROP
        return arr[t:b, l:r]
    return arr


def load_nyu_depth(path: str, size: Optional[Tuple[int, int]] = None) -> np.ndarray:
    """Depth in meters from ``.npy`` (meters) or a 16-bit PNG (mm),
    cropped, then resized by nearest when ``size`` differs."""
    if path.endswith(".npy"):
        depth = np.load(path).astype(np.float32)
    else:
        arr = np.asarray(Image.open(path))
        depth = arr.astype(np.float32)
        if arr.dtype == np.uint16:
            depth /= 1000.0
    depth = center_crop_nyu(depth)
    if size is not None and depth.shape != tuple(size):
        img = Image.fromarray(depth)
        depth = np.asarray(img.resize((size[1], size[0]), Image.NEAREST), dtype=np.float32)
    return depth


def _resize_rgb_u8(rgb: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    return np.asarray(Image.fromarray(rgb).resize((size[1], size[0]), Image.BILINEAR),
                      dtype=np.uint8)


class NyuTrainDataset(SeekableLoaderMixin):
    """KittiTrainDataset's batch contract at 228x304 and 10 m; the wire
    depth is uint16 millimeters (``wire_depth_scale`` 1000), exact for
    NYU's mm PNGs.  Always decoded with PIL."""

    def __init__(self, data_path: str, list_file: str, size: Tuple[int, int] = (228, 304),
                 batch_size: int = 32, shuffle: bool = True, seed: int = 0,
                 max_depth: float = 10.0, loop: bool = True, wire: str = "auto",
                 cache_dir: str = ""):
        self.data_path = data_path
        self.entries = parse_list(os.path.join(data_path, list_file))
        if not self.entries:
            raise ValueError(f"empty list file {list_file}")
        self.size = size
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.max_depth = max_depth
        self.loop = loop
        self._seed = seed
        self._rng = np.random.default_rng(seed)
        self._wire = wire == "auto"
        self.wire_depth_scale = 1000.0
        self._cache = None
        if cache_dir:
            from gdn_tpu_torch.data.cache import DecodedSampleCache, corpus_key

            self._cache = DecodedSampleCache(cache_dir, len(self.entries), size, 1000.0,
                                             corpus_key(self.entries, size, 1000.0))

    decoder = "pil"

    def __len__(self) -> int:
        return len(self.entries)

    def _decode_raw(self, idx):
        """(B, H, W, 3) uint8 RGB and (B, H, W) float32 meters of ``idx``,
        cropped and resized: the one place of the NYU geometry."""
        rgbs, depths = [], []
        for i in idx:
            rgb_rel, d_rel = self.entries[i][:2]
            rgb = center_crop_nyu(load_rgb_u8(os.path.join(self.data_path, rgb_rel)))
            if rgb.shape[:2] != self.size:
                rgb = _resize_rgb_u8(rgb, self.size)
            rgbs.append(rgb)
            depths.append(load_nyu_depth(os.path.join(self.data_path, d_rel), self.size))
        return np.stack(rgbs), np.stack(depths)

    def _decode_wire(self, idx):
        """(B, H, W, 3) uint8 and (B, H, W) uint16 mm (exact for mm PNGs,
        within 0.5 mm for ``.npy``)."""
        rgb, depth = self._decode_raw(idx)
        return rgb, np.clip(np.round(depth * 1000.0), 0, 65535).astype(np.uint16)

    def _make_batch(self, idx) -> Dict[str, np.ndarray]:
        idx = np.asarray(idx)
        if self._cache is not None:
            rgb, depth16 = cached_wire(self._cache, idx, self.size, self._decode_wire)
        elif self._wire:
            rgb, depth16 = self._decode_wire(idx)
        else:
            # uncached f32: full-precision depth, no mm rounding
            rgb, depth = self._decode_raw(idx)
            return f32_batch(rgb.astype(np.float32) / 255.0, depth[..., None],
                             self.max_depth)
        depth16 = depth16[..., None]
        if self._wire:
            return {"rgb": rgb, "depth": depth16}
        return f32_batch(rgb.astype(np.float32) / 255.0,
                         depth16.astype(np.float32) / 1000.0, self.max_depth)


class NyuLabeledMatDataset:
    """The official ``nyu_depth_v2_labeled.mat`` (HDF5): 'images' (N, 3,
    640, 480) uint8 and 'depths' (N, 640, 480) float32 meters, stored
    transposed.  ``indices`` selects frames (e.g. the 654-image test
    split).  Yields NyuEvalDataset's contract."""

    def __init__(self, mat_path: str, size: Tuple[int, int] = (228, 304),
                 indices: Optional[list] = None):
        import h5py

        self._h5 = h5py.File(mat_path, "r")
        self.size = size
        n = self._h5["images"].shape[0]
        self.indices = list(indices) if indices is not None else list(range(n))

    def __len__(self) -> int:
        return len(self.indices)

    def _frame(self, i: int):
        rgb = np.asarray(self._h5["images"][i]).transpose(2, 1, 0)
        depth = np.asarray(self._h5["depths"][i]).transpose(1, 0)
        return rgb.astype(np.float32) / 255.0, depth.astype(np.float32)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        for i in self.indices:
            rgb, depth = self._frame(i)
            rgb = center_crop_nyu(rgb)
            depth = center_crop_nyu(depth)
            small = _resize_rgb_u8((rgb * 255).astype(np.uint8), self.size)
            yield {"rgb": (small.astype(np.float32) / 255.0)[None], "gt": depth[None]}


class NyuEvalDataset:
    """{'rgb' (1, 228, 304, 3), 'gt' (1, Hg, Wg)}, the GT at the cropped
    native size (426x560)."""

    def __init__(self, data_path: str, list_file: str, size: Tuple[int, int] = (228, 304)):
        self.data_path = data_path
        self.entries = parse_list(os.path.join(data_path, list_file))
        self.size = size

    def __len__(self) -> int:
        return len(self.entries)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        for entry in self.entries:
            rgb = center_crop_nyu(load_rgb(os.path.join(self.data_path, entry[0])))
            small = _resize_rgb_u8((rgb * 255).astype(np.uint8), self.size)
            gt = load_nyu_depth(os.path.join(self.data_path, entry[1]))
            yield {"rgb": (small.astype(np.float32) / 255.0)[None],
                   "gt": gt[None].astype(np.float32)}
