"""Eval harness of the port (port of ``gdn_tpu/evaluate.py``): the
reference eval protocol,

  per image: forward at train size -> bilinear resize of the prediction
  to the GT's size, in float32 -> crop/cap/mask -> the 8-metric table.

One eval step per GT size maps a batch (rgb (B, H, W, 3), gt (B, Hg, Wg))
to one stacked (n_metrics, B) tensor of per-image metrics, computed on
the device; only that block crosses to the host, through pinned memory.
Batches are assembled and uploaded by a background thread on a stream of
its own, and dispatch runs 2 batches ahead of the fetch.  An
``Evaluator`` keeps its steps, the GT sizes it has warmed up, and
optionally the whole split resident on the device across passes.

The forward (``train.steps.make_eval_forward``) closes over its net, so
no parameters are passed here: a pass scores the net's weights as they
are when it runs.  Entry points run on CUDA unless the caller passes
``device="cpu"``.

Data-parallel eval (``mesh``, a ``parallel.mesh`` data mesh over the
ranks of a process group): ``eval.batch_size`` divides by the D ranks,
each rank uploads and scores its rows of each batch, and the per-image
metric columns (and the predictions, with ``save_preds``) are
all-gathered in rank order, so every rank accumulates, and returns, the
single-device result; the padding rows are dropped by ``n_real`` as on
one device.  Rank 0 prints and writes the predictions.
"""

from __future__ import annotations

import os
import time
from typing import Callable, Dict, Iterable, Iterator, Optional, Tuple

import numpy as np
import torch

from gdn_tpu_torch import metrics as M
from gdn_tpu_torch.config import Config, resolve_device
from gdn_tpu_torch.data.pipeline import prefetch_to_device, upload as _upload
from gdn_tpu_torch.ops.resize import resize_bilinear, resize_nearest
from gdn_tpu_torch.parallel import multihost
from gdn_tpu_torch.parallel.mesh import (
    data_group, data_size, height_rows, local_rows, spatial_axis,
)

Forward = Callable[[torch.Tensor], torch.Tensor]
HostBatch = Tuple[Tuple[int, int], torch.Tensor, torch.Tensor, int, Tuple[int, ...]]

def _gathered(t: torch.Tensor, mesh, dim: int) -> torch.Tensor:
    """The ranks' ``t`` concatenated on ``dim`` in rank order."""
    if mesh is None:
        return t
    parts = [torch.empty_like(t) for _ in range(data_size(mesh))]
    torch.distributed.all_gather(parts, t.contiguous(), group=data_group(mesh))
    return torch.cat(parts, dim=dim)


def make_eval_step(cfg: Config, forward: Forward, gt_shape: Tuple[int, int],
                   return_preds: bool = False, mesh=None, device=None):
    """step(rgb (B, H, W, 3), gt (B, Hg, Wg)) -> stacked (n_metrics, B)
    per-image metrics [, the train-size predictions (B, H, W) when
    ``return_preds``], on ``device``.  A uint16 GT is the "u16" wire and
    is decoded on the device (counts / 256).  With a ``mesh``, rgb and
    gt are this rank's rows and the outputs are the ranks' gathered in
    rank order (every rank's are the single-device step's).  On a
    spatial mesh the forward takes this rank's image rows of rgb and the
    prediction is gathered whole before the resize and the metrics; on a
    model mesh every model rank holds the whole prediction."""
    dev = resolve_device(device)
    crop = torch.from_numpy(M.crop_mask(gt_shape[0], gt_shape[1], cfg.eval.crop)).to(dev)
    min_depth, cap = cfg.model.min_depth, cfg.eval.cap

    @torch.inference_mode()
    def step(rgb: torch.Tensor, gt: torch.Tensor):
        if gt.dtype == torch.uint16:
            gt = gt.float() * (1.0 / 256.0)
        rows = spatial_axis(mesh)
        if rows is None:
            pred = forward(rgb)[..., 0]  # (B, H, W) at train size
        else:
            pred = forward(height_rows({"rgb": rgb}, mesh)["rgb"])[..., 0]
            parts = [torch.empty_like(pred) for _ in range(rows.size)]
            torch.distributed.all_gather(parts, pred.contiguous(), group=rows.group)
            pred = torch.cat(parts, dim=1)
        pred_gt = resize_bilinear(pred[:, None], gt_shape)[:, 0]
        gt_, pred_, range_mask = M.apply_cap(gt, pred_gt, min_depth, cap)
        mask = range_mask & crop
        if cfg.eval.median_scaling:
            # scale the RAW pred (apply_cap clips; see median_scale)
            pred_ = M.median_scale(pred_gt, gt_, mask, min_depth, cap)
        per_image = M.compute_errors(gt_, pred_, mask)
        stacked = _gathered(torch.stack([per_image[k] for k in M.METRIC_NAMES]), mesh, 1)
        return (stacked, _gathered(pred, mesh, 0)) if return_preds else stacked

    return step


def _wire_encoders(cfg: Config):
    """Host-side encoders of the (rgb, gt) uploads (EvalConfig gt_wire,
    rgb_wire), on CPU tensors.  "u16" GT ships round(gt * 256) counts
    (1/4 the bytes of fp32; the step decodes them).  "auto" RGB ships
    bfloat16 when the model computes in bfloat16: the model's own input
    cast rounds the same way, so the result is bit-identical."""
    if cfg.eval.gt_wire == "u16":
        def enc_gt(gt: torch.Tensor) -> torch.Tensor:
            return torch.clamp(torch.round(gt * 256.0), 0, 65535).to(torch.uint16)
    elif cfg.eval.gt_wire == "f32":
        enc_gt = None
    else:
        raise ValueError(f"unknown gt_wire {cfg.eval.gt_wire!r} (f32|u16)")
    if cfg.eval.rgb_wire == "auto" and cfg.model.dtype == "bfloat16":
        def enc_rgb(rgb: torch.Tensor) -> torch.Tensor:
            return rgb.to(torch.bfloat16)
    elif cfg.eval.rgb_wire in ("auto", "f32"):
        enc_rgb = None
    else:
        raise ValueError(f"unknown rgb_wire {cfg.eval.rgb_wire!r} (auto|f32)")
    return enc_rgb, enc_gt


def _batch_iter(dataset: Iterable[Dict[str, np.ndarray]], bs: int,
                max_images: Optional[int], enc_rgb=None, enc_gt=None) -> Iterator[HostBatch]:
    """Group per-image samples into (gt_shape, rgb, gt, n_real, indices)
    host batches of ``bs`` per GT size; the last partial batch of each
    size is padded with its last sample (its metrics are dropped).

    ``indices`` are the samples' positions in DATASET order: the
    grouping by size interleaves batches out of dataset order on
    mixed-resolution splits, so outputs are named by them."""

    def assemble(samples):
        idxs, samples = zip(*samples)
        pad = bs - len(samples)
        rgb = np.concatenate([np.asarray(s["rgb"], np.float32) for s in samples]
                             + [np.asarray(samples[-1]["rgb"], np.float32)] * pad)
        gt = np.concatenate([np.asarray(s["gt"], np.float32) for s in samples]
                            + [np.asarray(samples[-1]["gt"], np.float32)] * pad)
        rgb, gt = torch.from_numpy(rgb), torch.from_numpy(gt)
        if enc_rgb is not None:
            rgb = enc_rgb(rgb)
        if enc_gt is not None:
            gt = enc_gt(gt)
        return rgb, gt, len(samples), idxs

    pending: Dict[Tuple[int, int], list] = {}
    n_in = 0
    for sample in dataset:
        if max_images is not None and n_in >= max_images:
            break
        shape = tuple(np.asarray(sample["gt"]).shape[1:3])
        pending.setdefault(shape, []).append((n_in, sample))
        n_in += 1
        if len(pending[shape]) == bs:
            yield (shape, *assemble(pending.pop(shape)))
    for shape in list(pending):
        yield (shape, *assemble(pending.pop(shape)))


def _prefetch(batches: Iterator[HostBatch], device: torch.device,
              size: int = 2, rows: Optional[Tuple[int, int]] = None) -> Iterator[HostBatch]:
    """Assemble and upload host batches in a background thread, ahead of
    the consumer (``data.pipeline.prefetch_to_device``: on CUDA through
    pinned memory on the thread's own stream, the consumer waiting on
    each batch's upload); ``rows`` [start, end): only those rows."""
    s, e = rows if rows is not None else (0, None)

    def prepare(item: HostBatch, i: int):
        shape, rgb, gt, n_real, idxs = item
        return {"rgb": _upload(rgb[s:e], device), "gt": _upload(gt[s:e], device),
                "meta": (shape, n_real, idxs)}

    for b in prefetch_to_device(batches, size, device, prepare):
        shape, n_real, idxs = b["meta"]
        yield shape, b["rgb"], b["gt"], n_real, idxs


def _first_images(batches, max_images: Optional[int]) -> Iterator[HostBatch]:
    """The cached batches cut to the images of dataset index below
    ``max_images`` (within a batch the indices rise, so they are a
    prefix of its real images)."""
    for shape, rgb, gt, n_real, idxs in batches:
        if max_images is not None:
            idxs = tuple(i for i in idxs if i < max_images)
            n_real = len(idxs)
            if not n_real:
                continue
        yield shape, rgb, gt, n_real, idxs


class Evaluator:
    """Persistent eval harness: the eval steps and the set of GT sizes
    already warmed up survive across :meth:`run` calls, and
    :meth:`cache_dataset` can make the whole split device-resident, so
    later passes do no host batch assembly and no upload.  The
    in-training eval keeps one for the whole run."""

    PIPELINE_DEPTH = 2  # batches dispatched ahead of the fetch point
    CACHE_MAX_BYTES = 2 << 30  # wire-format payload of a device-cached split

    def __init__(self, cfg: Config, forward: Forward, mesh=None, device=None):
        self.cfg = cfg
        self.forward = forward
        self.mesh = mesh
        self.device = resolve_device(device)
        bs = max(1, cfg.eval.batch_size)
        size = data_size(mesh) if mesh is None or len(mesh.mesh_dim_names) == 1 else mesh.size()
        assert bs % size == 0, (
            f"eval.batch_size {bs} must be divisible by the mesh size {size}")
        self._rows = local_rows(bs, mesh)  # this rank's rows of each batch
        self._encoders = _wire_encoders(cfg)  # raises on an unknown wire
        self._steps: Dict[Tuple[Tuple[int, int], bool], Callable] = {}
        self._warm: set = set()
        self.warm_seconds: Dict[Tuple[int, int], float] = {}  # GT size: its warm-up batch
        self._cached: Optional[list] = None
        self.cached_bytes = 0

    def _step(self, shape: Tuple[int, int], return_preds: bool):
        key = (shape, return_preds)
        if key not in self._steps:
            self._steps[key] = make_eval_step(self.cfg, self.forward, shape,
                                              return_preds=return_preds, mesh=self.mesh,
                                              device=self.device)
        return self._steps[key]

    def cache_dataset(self, dataset: Iterable[Dict[str, np.ndarray]],
                      max_images: Optional[int] = None) -> "Evaluator":
        """Encode and upload the whole split once; later :meth:`run`
        calls with ``dataset=None`` read the device-resident batches.
        Raises ValueError past CACHE_MAX_BYTES of wire-format payload,
        and torch.OutOfMemoryError when the card runs out; either way the
        uploads made so far are dropped (see :meth:`cache_or_host_fed`)."""
        max_bytes = self.CACHE_MAX_BYTES
        self._cached, self.cached_bytes = None, 0
        bs = max(1, self.cfg.eval.batch_size)
        batches, total = [], 0
        try:
            for shape, rgb, gt, n_real, idxs in _batch_iter(dataset, bs, max_images,
                                                            *self._encoders):
                total += rgb.nbytes + gt.nbytes
                if total > max_bytes:
                    raise ValueError(
                        f"eval device cache exceeds {max_bytes / 2**30:.2f} GiB "
                        f"at image {sum(b[3] for b in batches)}: use the host-fed "
                        "path or bound the split with max_images")
                s, e = self._rows
                batches.append((shape, _upload(rgb[s:e], self.device),
                                _upload(gt[s:e], self.device), n_real, idxs))
        except BaseException:
            batches.clear()  # the traceback keeps this frame, and so the list, alive
            raise
        self._cached, self.cached_bytes = batches, total
        return self

    def cache_or_host_fed(self, dataset: Iterable[Dict[str, np.ndarray]],
                          max_images: Optional[int] = None) -> bool:
        """:meth:`cache_dataset`, or, when the split fails the byte gate
        or the card runs out of memory, nothing cached and one line
        printed: the passes then stay on the card, fed from the host.
        Returns whether the split is cached."""
        try:
            self.cache_dataset(dataset, max_images)
        except (ValueError, torch.OutOfMemoryError) as e:
            reason = (str(e).splitlines() or [type(e).__name__])[0]
            print(f"eval stays host-fed, partial uploads dropped: {reason}", flush=True)
            return False
        return True

    @property
    def cached_images(self) -> int:
        return sum(b[3] for b in self._cached or [])

    def run(self, dataset: Optional[Iterable[Dict[str, np.ndarray]]] = None,
            max_images: Optional[int] = None, verbose: bool = True,
            save_preds: Optional[str] = None) -> Dict[str, float]:
        """One full eval pass; returns the metric means and 'fps' (images
        a second on the host clock, the first batch of each GT size left
        out: it runs once more before, outside the window).

        ``dataset=None`` replays the split cached by
        :meth:`cache_dataset`, cut at ``max_images`` when given.
        ``save_preds``: a directory that receives each image's
        train-size prediction as ``pred_<dataset index>.npy``."""
        cuda = self.device.type == "cuda"
        acc = M.MetricAccumulator()
        bs = max(1, self.cfg.eval.batch_size)
        return_preds = bool(save_preds)
        writer = multihost.rank() == 0  # prints and writes the predictions
        n = 0
        t0 = None
        warm_s = 0.0  # warm-up batches after the first, left out of the fps window
        in_flight: list = []  # (host tensors, their copy's event, n_real, idxs)
        if save_preds and writer:
            os.makedirs(save_preds, exist_ok=True)

        def fetch(outs):
            """Start the copies of ``outs`` into pinned host memory."""
            if not cuda:
                return outs, None
            hosts = tuple(torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                          for t in outs)
            for h, t in zip(hosts, outs):
                h.copy_(t, non_blocking=True)
            done = torch.cuda.Event()
            done.record()
            return hosts, done

        def drain(to_depth: int):
            nonlocal n
            while len(in_flight) > to_depth:
                hosts, done, n_real, idxs = in_flight.pop(0)
                if done is not None:
                    done.synchronize()
                cols = hosts[0].numpy()  # (n_metrics, B)
                for i in range(n_real):
                    acc.update({k: float(cols[j, i]) for j, k in enumerate(M.METRIC_NAMES)})
                    n += 1
                if return_preds and writer:
                    preds = hosts[1].numpy()
                    for i in range(n_real):
                        np.save(os.path.join(save_preds, f"pred_{idxs[i]:06d}.npy"),
                                preds[i])

        if dataset is None:
            if self._cached is None:
                raise ValueError("Evaluator.run(dataset=None) needs cache_dataset() first")
            batches = _first_images(self._cached, max_images)
        else:
            batches = _prefetch(_batch_iter(dataset, bs, max_images, *self._encoders),
                                self.device, rows=self._rows)
        for shape, rgb, gt, n_real, idxs in batches:
            key = (shape, return_preds)
            step = self._step(*key)
            if key not in self._warm:
                # the first batch of each GT size runs once outside the
                # window: cuDNN picks its algorithms per shape there
                tw = time.perf_counter()
                step(rgb, gt)
                if cuda:
                    torch.cuda.synchronize(self.device)
                self._warm.add(key)
                self.warm_seconds[shape] = time.perf_counter() - tw
                if t0 is None:
                    t0 = time.perf_counter()
                else:
                    warm_s += time.perf_counter() - tw
            elif t0 is None:
                t0 = time.perf_counter()
            out = step(rgb, gt)
            in_flight.append((*fetch(out if return_preds else (out,)), n_real, idxs))
            drain(self.PIPELINE_DEPTH)
        drain(0)
        result = acc.result()
        if n > 0 and t0 is not None:
            result["fps"] = n / max(time.perf_counter() - t0 - warm_s, 1e-9)
        if verbose and writer:
            print(acc.table())
            if "fps" in result:
                print(f"eval fps: {result['fps']:.1f}")
        return result


class Stage1Split:
    """The stage-1 (D-net) reconstruction eval of an eval split: each
    sample's GT, downsampled to the train size ``hw`` by nearest resize,
    is the net's (1, H, W, 1) input (under the 'rgb' key), scored against
    the GT at its own size by the same protocol.  Re-iterable when
    ``split`` is."""

    def __init__(self, split: Iterable[Dict[str, np.ndarray]], hw: Tuple[int, int]):
        self.split = split
        self.hw = tuple(hw)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        for sample in self.split:
            gt = np.asarray(sample["gt"], np.float32)
            depth_in = resize_nearest(torch.from_numpy(gt)[:, None], self.hw)
            yield {"rgb": depth_in[:, 0, :, :, None].numpy(), "gt": gt}


def evaluate(cfg: Config, forward: Forward, dataset: Iterable[Dict[str, np.ndarray]],
             max_images: Optional[int] = None, verbose: bool = True,
             save_preds: Optional[str] = None, mesh=None, device_cache: bool = False,
             device=None) -> Dict[str, float]:
    """Run the eval split; returns the metric means and 'fps'.

    ``dataset`` yields {'rgb' (1, H, W, 3) at train size, 'gt' (1, Hg,
    Wg) GT depth at its own size}.  ``device_cache=True`` stages the
    split on the device first (2 GiB wire-format gate), so the timed pass
    reads device-resident batches; past the gate, or when the card runs
    out of memory, the pass is fed from the host instead, which iterates
    ``dataset`` again: it must be re-iterable (a list, a dataset object),
    not a one-shot iterator.  For repeated passes over one split, hold an
    :class:`Evaluator`."""
    if device_cache and iter(dataset) is dataset:
        raise TypeError("evaluate(device_cache=True) needs a re-iterable dataset: "
                        "the host-fed fallback iterates it again")
    ev = Evaluator(cfg, forward, mesh=mesh, device=device)
    if device_cache and ev.cache_or_host_fed(dataset, max_images):
        dataset = None
    return ev.run(dataset, max_images=max_images, verbose=verbose, save_preds=save_preds)
