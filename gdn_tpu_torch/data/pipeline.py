"""Host -> device input pipeline (port of ``gdn_tpu/data/pipeline.py``).

    host decode (loader)  ->  prefetch thread: pinned upload on its own
    stream, wire decode, augmentation  ->  the train step

``prefetch_to_device`` runs the loader in a background thread that keeps
``size`` batches ready on the device ahead of the consumer.  On CUDA the
thread works on a stream of its own: host arrays go through pinned
memory and are copied without blocking, the batch's transform (the wire
decode and the augmentation) runs there too, and an event marks the
batch ready; the consumer's stream waits on that event before the step
reads the batch.  Threads, not worker processes: a fork after CUDA has
been initialised breaks the child.

``make_train_pipeline`` composes loader, prefetch, wire decode and
augmentation; ``make_loader`` builds the loader that
``cfg.data.dataset`` names.
"""

from __future__ import annotations

import dataclasses
import os
import queue
import threading
from typing import Any, Callable, Dict, Iterable, Iterator, Optional

import numpy as np
import torch

from gdn_tpu_torch.config import Config, resolve_device
from gdn_tpu_torch.data.augment import apply_augment, augment_params, decode_wire_batch
from gdn_tpu_torch.data.synthetic import _image_seed

Batch = Dict[str, Any]


def host_tensor(x) -> torch.Tensor:
    """A host array as a CPU tensor without a copy; uint16 (the wire's
    depth counts) travels as int16 with the same bits."""
    if isinstance(x, torch.Tensor):
        return x
    x = np.asarray(x)
    if x.dtype == np.uint16:
        x = x.view(np.int16)
    return torch.from_numpy(x)


def upload(x, device: torch.device) -> torch.Tensor:
    """A host array or tensor on ``device``.  To CUDA from the host it
    goes through pinned memory without blocking (ordered on the current
    stream) and its bytes are added to ``upload.bytes``; a tensor
    already on ``device`` is returned as it is."""
    t = host_tensor(x)
    if device.type == "cuda" and t.device.type == "cpu":
        upload.bytes += t.nbytes
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)  # the tensor itself when it is there already


upload.bytes = 0  # bytes copied host -> card by upload(), since the last reset


def prefetch_to_device(iterator: Iterable[Any], size: int = 2, device=None,
                       prepare: Optional[Callable[[Any, int], Batch]] = None,
                       start: int = 0) -> Iterator[Batch]:
    """The items of ``iterator`` made ready on ``device`` (CUDA unless
    asked otherwise) by a background thread, up to ``size`` ahead of the
    consumer.  ``prepare(item, i)`` (i: the item's index, counted from
    ``start``) turns an item into a dict of what the consumer reads; by
    default each leaf of a dict item is uploaded.  On CUDA the thread
    works on a stream of its own; the consumer's stream waits on each
    dict's event, and its tensors are recorded on that stream, so the
    allocator does not hand their memory out while the consumer may
    still read it.

    An error in the thread is raised in the consumer.  A consumer that
    abandons the generator (early exit, an exception) stops the thread,
    which otherwise would block on the full queue and keep its batches
    alive."""
    dev = resolve_device(device)
    if prepare is None:
        def prepare(item, i):
            return {k: upload(v, dev) for k, v in item.items()}
    q: "queue.Queue" = queue.Queue(maxsize=max(1, size))
    sentinel = object()
    stop = threading.Event()
    err: list = []
    stream = torch.cuda.Stream(dev) if dev.type == "cuda" else None

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def produce():
        for i, item in enumerate(iterator, start):
            batch = prepare(item, i)
            done = None
            if stream is not None:
                done = torch.cuda.Event()
                done.record(stream)
            if not put((batch, done)):
                return

    def producer():
        try:
            with torch.no_grad():
                if stream is None:
                    produce()
                else:
                    with torch.cuda.device(dev), torch.cuda.stream(stream):
                        produce()
        except Exception as e:  # handed to the consumer, raised there
            err.append(e)
        finally:
            put(sentinel)

    threading.Thread(target=producer, daemon=True).start()
    try:
        while True:
            item = q.get()
            if item is sentinel:
                if err:
                    raise err[0]
                return
            batch, done = item
            if done is not None:
                consumer = torch.cuda.current_stream(dev)
                consumer.wait_event(done)
                for t in batch.values():
                    if isinstance(t, torch.Tensor):
                        t.record_stream(consumer)
            yield batch
    finally:
        stop.set()
        try:
            while True:
                q.get_nowait()
        except queue.Empty:
            pass


def make_train_pipeline(cfg: Config, loader: Iterable[Batch], augment: bool = True,
                        skip: int = 0, device=None, seed: Optional[int] = None,
                        mesh=None) -> Iterator[Dict[str, torch.Tensor]]:
    """loader -> prefetch to ``device`` -> wire decode -> augmentation.

    Batch i (counted from ``skip``, the batches a resumed run has
    consumed) is augmented with values drawn from a CPU generator seeded
    by (seed, i), ``seed`` defaulting to cfg.train.seed: a resumed stream
    equals an unbroken one when the caller has also ``seek(skip)``-ed the
    loader.  The wire's counts-to-meters scale is the loader's
    (``wire_depth_scale``: 256 KITTI, 1000 NYU).

    With a data ``mesh`` the pipeline yields this rank's rows: a global
    host batch (``cfg.data.batch_size`` rows) is cut before the upload,
    and a batch of the rank's rows (a device cache over the mesh) is
    taken as it is.  The augmentation values are drawn for the global
    batch and cut the same way, so row i is cropped, flipped and
    jittered as on one device.  On a spatial mesh the images stay whole
    here: the train loop keeps this rank's rows of the augmented batch."""
    from gdn_tpu_torch.parallel.mesh import local_batch, local_rows

    dev = resolve_device(device)
    seed = cfg.train.seed if seed is None else seed
    depth_scale = float(getattr(loader, "wire_depth_scale", 256.0))
    max_depth = float(cfg.model.max_depth)
    b = cfg.data.batch_size
    start, end = local_rows(b, mesh)

    def prepare(host: Batch, i: int) -> Dict[str, torch.Tensor]:
        host = local_batch(host, mesh, b)  # whole images: augmented as on one device
        batch = decode_wire_batch({k: upload(v, dev) for k, v in host.items()},
                                  max_depth=max_depth, depth_scale=depth_scale)
        if augment:
            gen = torch.Generator().manual_seed(_image_seed(seed, i))
            rows = b if mesh is not None else batch["rgb"].shape[0]
            params = augment_params(gen, rows, cfg.data)
            # the seven values in one upload, this rank's rows
            flat = torch.stack(list(params.values()))
            flat = upload(flat[:, start:end].contiguous() if mesh is not None else flat, dev)
            batch = apply_augment(batch, dict(zip(params, flat)), cfg.data)
        return batch

    return prefetch_to_device(loader, cfg.data.prefetch, dev, prepare, start=skip)


class CachedSampleIterable:
    """Host-side memo of a re-iterable sample stream: in-training eval
    reads the same split every few epochs, and a disk split would be
    decoded again each time.  The first pass keeps the samples (up to
    ``max_bytes``; a larger split is read again each pass, never held);
    later passes replay them.  ``max_items`` bounds a pass, as
    ``max_images`` bounds the eval.  Call it for an iterator."""

    def __init__(self, factory: Callable[[], Iterable[Batch]], max_items: Optional[int] = None,
                 max_bytes: int = 1 << 30):
        self._factory = factory
        self._max_items = max_items
        self._max_bytes = max_bytes
        self._samples: Optional[list] = None
        self._too_big = False

    def __call__(self) -> Iterator[Batch]:
        if self._samples is not None:
            return iter(self._samples)
        if self._too_big:
            return iter(self._factory())
        return self._fill()

    def _fill(self) -> Iterator[Batch]:
        acc: Optional[list] = []
        nbytes = 0
        for i, s in enumerate(self._factory()):
            if self._max_items is not None and i >= self._max_items:
                break
            if acc is not None:
                nbytes += sum(getattr(v, "nbytes", 0) for v in s.values())
                if nbytes > self._max_bytes:
                    self._too_big = True
                    acc = None
                else:
                    acc.append(s)
            yield s
        if acc is not None:
            self._samples = acc


def _grain_loader(cfg: Config):
    """The grain loader's counterpart for cfg.data.dataset (KITTI or NYU
    decode), ``grain_workers`` decode threads."""
    d = cfg.data
    if d.decode_cache:
        raise ValueError("--decode_cache supports the native loader only "
                         "(grain owns its own worker-side transform chain)")
    from gdn_tpu_torch.data.grain_loader import GrainKittiDataset

    return GrainKittiDataset(d.data_path, d.train_list, cfg.model.image_size, d.batch_size,
                             seed=cfg.train.seed, max_depth=cfg.model.max_depth,
                             worker_count=d.grain_workers, dataset=d.dataset,
                             wire=d.train_wire)


def make_loader(cfg: Config, split: str = "train", device=None):
    """The loader named by cfg.data.dataset: for ``split="train"`` the
    batched training loader (``cfg.data.loader``: the native loaders, or
    the grain loader's counterpart), for ``"eval"`` the per-image eval
    split.  In a process group of more than one rank each rank keeps its
    own decode cache, ``<decode_cache>/rank<r>`` (a cache directory is
    held by one process).  The synthetic training source draws on ``device`` (CUDA
    unless asked otherwise); its eval split and the disk loaders yield
    host arrays."""
    h, w = cfg.model.image_size
    d = cfg.data
    if d.decode_cache:
        from gdn_tpu_torch.parallel import multihost

        if multihost.world_size() > 1:  # a decode cache is held by one process
            d = dataclasses.replace(d, decode_cache=os.path.join(
                d.decode_cache, f"rank{multihost.rank()}"))
    if split == "train" and d.loader == "grain" and d.dataset in ("kitti", "nyu"):
        return _grain_loader(cfg)
    if d.dataset == "synthetic":
        if d.loader == "grain":
            raise ValueError("--loader grain needs an on-disk dataset (kitti or nyu); "
                             "synthetic data is generated on the device")
        from gdn_tpu_torch.data.synthetic import SyntheticDataset, SyntheticEvalDataset

        if split == "eval":
            return SyntheticEvalDataset(height=h, width=w, max_depth=cfg.model.max_depth)
        return SyntheticDataset(d.batch_size, h, w, cfg.model.max_depth,
                                seed=cfg.train.seed, device=device)
    if d.dataset == "kitti":
        from gdn_tpu_torch.data.kitti import KittiEvalDataset, KittiTrainDataset

        if split == "train":
            return KittiTrainDataset(d.data_path, d.train_list, (h, w), d.batch_size,
                                     seed=cfg.train.seed, max_depth=cfg.model.max_depth,
                                     wire=d.train_wire, cache_dir=d.decode_cache)
        return KittiEvalDataset(d.data_path, d.val_list, (h, w), calib_dir=d.calib_dir or None)
    if d.dataset == "nyu":
        from gdn_tpu_torch.data.nyu import NyuEvalDataset, NyuTrainDataset

        if split == "train":
            return NyuTrainDataset(d.data_path, d.train_list, (h, w), d.batch_size,
                                   seed=cfg.train.seed, max_depth=cfg.model.max_depth,
                                   wire=d.train_wire, cache_dir=d.decode_cache)
        return NyuEvalDataset(d.data_path, d.val_list, (h, w))
    raise ValueError(f"unknown dataset {d.dataset!r}")
