"""Epoch loops of both stages (port of ``gdn_tpu/train/loop.py``).

``train_stage1`` trains the D-net on GT depth; ``train_stage2`` moves
the stage-1 decoder into a fresh G-net, freezes it, and trains the rest
with the guidance term from the frozen D-net.  Both run on CUDA unless
the caller passes ``device="cpu"``, and both continue a ``state`` given
to them (a resumed run).  Per-step scalars (loss terms, images/s with
the first step left out, and ``lr``, the learning rate of the last
update) go through ``MetricLogger``.  ``data_iter``
yields batches on the device: the synthetic source draws them there,
and disk data comes through ``data.pipeline.make_train_pipeline``
(prefetched, decoded and augmented on the device).  After each
epoch, optionally: validation (the mean loss terms over held-out
batches, ``val_*``) and, in stage 2, the full eval protocol through one
persistent ``Evaluator`` (``eval_*``).

With ``cfg.train.ckpt_dir`` set, each epoch ends with a full checkpoint
(``checkpoint.save_checkpoint``: weights, EMA, optimizer, counts, the
data cursor) in ``<ckpt_dir>/stage1`` or ``stage2``, keeping the newest
``keep_ckpts``, written in the background when ``async_ckpt``; each new
best eval RMSE saves one to ``<ckpt_dir>/stage2_best``.  SIGTERM or
SIGINT (``PreemptionHandler``) ends the epoch after the step in flight:
the loop skips validation and eval, checkpoints and returns, and every
write is on disk before it does.
"""

from __future__ import annotations

import os
import signal
import time
from typing import Any, Callable, Dict, Iterable, Optional, Union

import torch

from gdn_tpu_torch import kernels
from gdn_tpu_torch.checkpoint import (
    init_params, save_checkpoint, transfer_stage1_decoder, wait_for_checkpoints,
)
from gdn_tpu_torch.config import Config, resolve_device
from gdn_tpu_torch.evaluate import Evaluator
from gdn_tpu_torch.losses import total_loss
from gdn_tpu_torch.models import DtoDNet, RtoDNet
from gdn_tpu_torch.train.state import TrainState
from gdn_tpu_torch.train.steps import make_eval_forward, make_stage1_step, make_stage2_step
from gdn_tpu_torch.utils.logging import MetricLogger


class PreemptionHandler:
    """SIGTERM/SIGINT set a flag; the epoch loop finishes the step in
    flight, the trainer checkpoints, and the run returns.  A run started
    again with ``--resume`` continues where it stopped: the batch stream
    is a function of (seed, step).

    ``install`` replaces the handlers for one training run and
    ``uninstall`` puts the previous ones back."""

    def __init__(self):
        self.requested = False
        self._prev = {}

    def _on_signal(self, signum, frame):
        self.requested = True
        print(f"[train] received signal {signum}: will checkpoint and "
              "stop after the current step", flush=True)

    def install(self) -> "PreemptionHandler":
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                self._prev[sig] = signal.signal(sig, self._on_signal)
            except ValueError:  # not the main thread: no signal handling
                pass
        return self

    def uninstall(self) -> None:
        for sig, prev in self._prev.items():
            signal.signal(sig, prev)
        self._prev = {}


def _floats(terms: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """The terms as floats, in one device-to-host copy (waits for the card)."""
    keys = list(terms)
    vals = torch.stack([terms[k].float() for k in keys]).tolist()
    return dict(zip(keys, vals))


def _epoch_loop(step_fn, state: TrainState, data_iter, steps: int,
                logger: MetricLogger, batch_size: int, log_every: int,
                device: torch.device, extra_args=(),
                preemption: Optional[PreemptionHandler] = None) -> TrainState:
    """Drive ``steps`` micro-steps, fewer when preemption is requested.
    The clock restarts after the first step, so its one-time costs
    (cuDNN's algorithm search, the allocator's growth) stay out of
    ``imgs_per_sec``."""
    t_start = time.perf_counter()
    timed_from = 0
    for i in range(steps):
        batch = _batch_to(next(data_iter), device)
        state, terms = step_fn(state, *extra_args, batch)
        if i == 0:
            _floats(terms)
            t_start = time.perf_counter()
            timed_from = 1
        if (i + 1) % log_every == 0 or i == steps - 1:
            vals = _floats(terms)
            elapsed = max(time.perf_counter() - t_start, 1e-9)
            timed = i + 1 - timed_from
            # the LR of the last update applied (the schedule's value at it)
            log_kw = dict(step=state.step, **vals, lr=state.optimizer.param_groups[0]["lr"])
            if timed > 0:
                log_kw["imgs_per_sec"] = batch_size * timed / elapsed
            logger.log(**log_kw)
        if preemption is not None and preemption.requested:
            break
    return state


def _batch_to(batch: Dict[str, Any], device: torch.device) -> Dict[str, torch.Tensor]:
    """The batch's leaves as tensors on ``device``.  A tensor already
    there is passed on as it is: the batches of the prefetch pipeline
    (``data.pipeline``) and of the synthetic source cost nothing here.
    A host array (validation's f32 pairs) is copied from pageable
    memory, which waits for the copy."""
    return {k: torch.as_tensor(v).to(device, non_blocking=True) for k, v in batch.items()}


def _validate(cfg: Config, net: torch.nn.Module, val_iter, steps: int,
              logger: MetricLogger, step: int, device: torch.device,
              input_key: str = "depth") -> Dict[str, float]:
    """Periodic validation: the loss terms averaged over ``steps``
    held-out batches (fewer if ``val_iter`` ends first), without
    gradients, logged as ``val_*``.  Stage 2 feeds the G-net RGB
    (``input_key="rgb"``) and scores its depth alone: no guidance term."""
    sums: Dict[str, float] = {}
    n = 0
    for _ in range(steps):
        try:
            batch = _batch_to(next(val_iter), device)
        except StopIteration:
            break
        with torch.no_grad():
            out = net(batch[input_key])
            terms = total_loss(out["depth"], batch["depth"], batch["mask"], cfg.loss,
                               cfg.model.max_depth, scale_preds=out["depth_scales"][:-1])
        for k, v in _floats(terms).items():
            sums[k] = sums.get(k, 0.0) + v
        n += 1
    avg = {f"val_{k}": v / max(n, 1) for k, v in sums.items()}
    logger.log(step=step, **avg)
    return avg


def _net(cls, cfg: Config, sd: Dict[str, torch.Tensor], device) -> torch.nn.Module:
    net = cls(cfg.model)
    net.load_state_dict(sd, strict=True)
    return net.to(device)


def _prepare(device) -> torch.device:
    dev = resolve_device(device)
    if dev.type == "cuda":
        kernels.load_all()  # build before the clock starts
    return dev


def stage1_state(cfg: Config, device=None) -> TrainState:
    """A fresh stage-1 TrainState: a D-net from ``init_params`` with
    seed cfg.train.seed, on ``device`` (CUDA unless asked otherwise)."""
    gen = torch.Generator().manual_seed(cfg.train.seed)
    net = _net(DtoDNet, cfg, init_params(cfg.model, gen, in_channels=1),
               resolve_device(device))
    return TrainState(net, cfg.train, cfg.train.steps_per_epoch)


def stage2_state(cfg: Config, d_sd: Dict[str, torch.Tensor], device=None) -> TrainState:
    """A fresh stage-2 TrainState: a G-net (seed cfg.train.seed) with
    the decoder of the D-net ``d_sd`` (``transfer_stage1_decoder``),
    frozen when cfg.train.freeze_decoder."""
    gen = torch.Generator().manual_seed(cfg.train.seed)
    g_sd = transfer_stage1_decoder(init_params(cfg.model, gen, in_channels=3), d_sd)
    return TrainState(_net(RtoDNet, cfg, g_sd, resolve_device(device)), cfg.train,
                      cfg.train.steps_per_epoch, freeze_decoder=cfg.train.freeze_decoder)


def _save(cfg: Config, state: TrainState, stage: str, keep: Optional[int] = None,
          loader_state_fn: Optional[Callable[[int], Optional[Dict[str, Any]]]] = None) -> None:
    """A checkpoint of ``state`` under ``<ckpt_dir>/<stage>``; its
    ``loader`` entry is ``loader_state_fn(step)`` (the grain cursor) or
    ``{"step": step}``."""
    loader_state = (loader_state_fn(state.step) if loader_state_fn is not None
                    else {"step": state.step})
    save_checkpoint(os.path.join(cfg.train.ckpt_dir, stage), state.step, state,
                    cfg.train.keep_ckpts if keep is None else keep,
                    use_async=cfg.train.async_ckpt, cfg=cfg, loader_state=loader_state)


def _guarded(cfg: Config, step_fn):
    """The step behind ``utils.guards.GuardedStep`` when
    cfg.train.check_numerics: the loss terms checked every step."""
    if not cfg.train.check_numerics:
        return step_fn
    from gdn_tpu_torch.utils.guards import GuardedStep

    return GuardedStep(step_fn)


def _preempted(state: TrainState) -> None:
    print(f"[train] preempted: checkpoint saved at step {state.step}; "
          "resume with --resume", flush=True)


def train_stage1(cfg: Config, data_iter: Iterable[Dict[str, Any]],
                 epochs: Optional[int] = None, state: Optional[TrainState] = None,
                 logger: Optional[MetricLogger] = None,
                 val_iter: Optional[Iterable[Dict[str, Any]]] = None,
                 val_steps: int = 10, device=None,
                 loader_state_fn: Optional[Callable[[int], Optional[Dict[str, Any]]]] = None
                 ) -> TrainState:
    """D-net pretraining; returns the final TrainState.  Starts from
    ``stage1_state`` unless ``state`` is given.  ``val_iter``: held-out
    batches, validated after each epoch (``val_steps`` of them, from the
    start of the iterable each time).  ``loader_state_fn(step)``: the
    data cursor each checkpoint saves as its ``loader`` entry (default
    ``{"step": step}``).  cfg.train.check_numerics raises
    FloatingPointError at the first step whose loss terms are not
    finite."""
    dev = _prepare(device)
    if state is None:
        state = stage1_state(cfg, dev)
    step_fn = _guarded(cfg, make_stage1_step(cfg))
    logger = logger or MetricLogger(prefix="stage1")
    data_iter = iter(data_iter)
    preempt = PreemptionHandler().install()
    try:
        for _ in range(epochs if epochs is not None else cfg.train.epochs):
            state = _epoch_loop(step_fn, state, data_iter, cfg.train.steps_per_epoch,
                                logger, cfg.data.batch_size, cfg.train.log_every, dev,
                                preemption=preempt)
            if val_iter is not None and not preempt.requested:
                _validate(cfg, state.net, iter(val_iter), val_steps, logger, state.step, dev)
            if cfg.train.ckpt_dir:
                _save(cfg, state, "stage1", loader_state_fn=loader_state_fn)
            if preempt.requested:
                _preempted(state)
                break
    finally:
        preempt.uninstall()
        if cfg.train.ckpt_dir:
            wait_for_checkpoints(cfg.train.ckpt_dir)
    return state


def train_stage2(cfg: Config, data_iter: Iterable[Dict[str, Any]],
                 d_params: Union[Dict[str, torch.Tensor], torch.nn.Module],
                 epochs: Optional[int] = None, state: Optional[TrainState] = None,
                 logger: Optional[MetricLogger] = None,
                 val_iter: Optional[Iterable[Dict[str, Any]]] = None,
                 val_steps: int = 10,
                 eval_dataset: Optional[Callable[[], Iterable[Dict[str, Any]]]] = None,
                 eval_every: int = 1, eval_max_images: Optional[int] = None,
                 device=None,
                 loader_state_fn: Optional[Callable[[int], Optional[Dict[str, Any]]]] = None
                 ) -> TrainState:
    """Guided G-net training; returns the final TrainState.

    ``d_params``: the trained stage-1 D-net, as its state_dict or as the
    DtoDNet itself (on the device; it is frozen in place).  Unless
    ``state`` is given, the G-net starts from ``stage2_state``: fresh
    weights with the D-net's decoder.  The D-net runs without grad.

    ``val_iter``, ``val_steps``, ``loader_state_fn``: as in
    :func:`train_stage1`.
    ``eval_dataset``: a zero-argument callable returning the eval split
    ({'rgb' (1, H, W, 3), 'gt' (1, Hg, Wg)}); every ``eval_every``
    epochs the full eval protocol runs on it (at most
    ``eval_max_images`` images) and logs ``eval_*``.  One Evaluator
    serves the whole run; the split is cached on the device at its first
    use, or stays host-fed past the 2 GiB gate or when the card runs out
    of memory.  Each new best eval RMSE saves a checkpoint to
    ``<ckpt_dir>/stage2_best``, which keeps one."""
    dev = _prepare(device)
    d_net = (d_params if isinstance(d_params, torch.nn.Module)
             else _net(DtoDNet, cfg, d_params, dev)).requires_grad_(False)
    if state is None:
        state = stage2_state(cfg, d_net.state_dict(), dev)
    step_fn = _guarded(cfg, make_stage2_step(cfg))
    logger = logger or MetricLogger(prefix="stage2")
    data_iter = iter(data_iter)
    evaluator, eval_cached, best_rmse = None, False, float("inf")
    preempt = PreemptionHandler().install()
    try:
        for epoch in range(epochs if epochs is not None else cfg.train.epochs):
            state = _epoch_loop(step_fn, state, data_iter, cfg.train.steps_per_epoch,
                                logger, cfg.data.batch_size, cfg.train.log_every, dev,
                                extra_args=(d_net,), preemption=preempt)
            if val_iter is not None and not preempt.requested:
                _validate(cfg, state.net, iter(val_iter), val_steps, logger, state.step,
                          dev, input_key="rgb")
            if (eval_dataset is not None and (epoch + 1) % max(eval_every, 1) == 0
                    and not preempt.requested):
                if evaluator is None:
                    evaluator = Evaluator(cfg, make_eval_forward(cfg, state.net), device=dev)
                    eval_cached = evaluator.cache_or_host_fed(eval_dataset(),
                                                              eval_max_images)
                out = evaluator.run(None if eval_cached else eval_dataset(),
                                    max_images=eval_max_images, verbose=False)
                logger.log(step=state.step, **{f"eval_{k}": v for k, v in out.items()})
                # the best weights by eval RMSE survive later epochs that regress
                if cfg.train.ckpt_dir and out.get("rmse", float("inf")) < best_rmse:
                    best_rmse = out["rmse"]
                    _save(cfg, state, "stage2_best", keep=1)
                    logger.log(step=state.step, best_rmse=best_rmse)
            if cfg.train.ckpt_dir:
                _save(cfg, state, "stage2", loader_state_fn=loader_state_fn)
            if preempt.requested:
                _preempted(state)
                break
    finally:
        preempt.uninstall()
        if cfg.train.ckpt_dir:
            wait_for_checkpoints(cfg.train.ckpt_dir)
    return state
