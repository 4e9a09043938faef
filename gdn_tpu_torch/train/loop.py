"""Epoch loops of both stages (port of ``gdn_tpu/train/loop.py``).

``train_stage1`` trains the D-net on GT depth; ``train_stage2`` moves
the stage-1 decoder into a fresh G-net, freezes it, and trains the rest
with the guidance term from the frozen D-net.  Both run on CUDA unless
the caller passes ``device="cpu"``, and both continue a ``state`` given
to them (a resumed run).  Per-step scalars (loss terms, images/s with
the first step left out, ``lr``, the learning rate of the last
update, and the host's mean ms since the last line from the spans of
``utils.profiling``: a step, ``host_step_ms`` (``gdn.train.step``), and
its forward, backward and update, ``host_forward_ms``,
``host_backward_ms``, ``host_update_ms`` (``gdn.train.forward`` ...),
and a loss read-back, ``readback_ms`` (``gdn.train.readback``)) go
through ``MetricLogger``.  ``data_iter``
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

With ``cfg.train.steps_per_call`` = K > 1 the loops run the multistep
steps (``train.steps.make_stage{1,2}_multistep``) on K batches a call,
stacked on the device; the data cursor still counts batches, so a
resumed run continues bit for bit.

In a process group (``parallel.multihost``) the loops build the mesh
from ``cfg.mesh`` (or take ``mesh``): ``"data"``, and ``"spatial"`` and
``"model"`` where ``spatial_devices`` / ``model_devices`` > 1.  They
place the state (``parallel.mesh.shard_state``: replicated, FSDP with
``cfg.mesh.fsdp``, or tensor parallel on a ``"model"`` dim) and stage
2's D-net, and run the mesh steps.  ``data_iter`` yields the global
batch (``cfg.data.batch_size`` rows; the loop keeps this rank's rows)
or this rank's rows already (the batch size / D), as
``data.pipeline.make_train_pipeline`` with a mesh yields them; on a
spatial mesh the loop then keeps this rank's image rows;
``imgs_per_sec`` counts the global batch.  Logging and checkpoint
writes happen on rank 0 (every rank gathers an FSDP state), the ranks
meet at a barrier before a stage returns, and a preemption request on
any rank stops every rank after the same step (the flag is combined
with an all-reduce MAX at each check).  Validation and in-training
eval run data parallel too.
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
from gdn_tpu_torch.parallel import multihost
from gdn_tpu_torch.parallel.mesh import (
    create_mesh, local_batch, param_mode, pixel_group, shard_frozen, shard_state,
    spatial_axis,
)
from gdn_tpu_torch.train.state import TrainState
from gdn_tpu_torch.train.steps import (
    _reported, _spatial_safe_cfg, make_eval_forward, make_stage1_multistep, make_stage1_step,
    make_stage2_multistep, make_stage2_step,
)
from gdn_tpu_torch.utils.logging import MetricLogger
from gdn_tpu_torch.utils.profiling import span, totals


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

    def stop(self, mesh=None, device=None) -> bool:
        """Whether to stop after this step: the flag of any rank (an
        all-reduce MAX over the mesh), so that every rank stops at the
        same step; one rank stopping alone would leave the others
        waiting in the next collective."""
        if mesh is None:
            return self.requested
        flag = torch.tensor([float(self.requested)], device=device)
        torch.distributed.all_reduce(flag, op=torch.distributed.ReduceOp.MAX)
        self.requested = bool(flag.item())
        return self.requested


class _Quiet:
    """The logger of ranks other than 0."""

    def log(self, **kw) -> None:
        pass


def _floats(terms: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """The terms as floats, in one device-to-host copy (waits for the card)."""
    keys = list(terms)
    vals = torch.stack([terms[k].float() for k in keys]).tolist()
    return dict(zip(keys, vals))


def _epoch_loop(step_fn, state: TrainState, data_iter, steps: int,
                logger: MetricLogger, batch_size: int, log_every: int,
                device: torch.device, extra_args=(), steps_per_call: int = 1,
                preemption: Optional[PreemptionHandler] = None, mesh=None,
                height: Optional[int] = None) -> TrainState:
    """Drive ``steps`` micro-steps, fewer when preemption is requested.
    With ``steps_per_call`` = K > 1, ``step_fn`` is a multistep: each
    call takes K batches stacked on a leading axis on the device; K must
    divide ``steps``, the log comes every ``max(1, log_every // K)``
    calls, and preemption is checked after each call.  The clock
    restarts after the first call, so its one-time costs (cuDNN's
    algorithm search, the allocator's growth) stay out of
    ``imgs_per_sec``.  With a ``mesh`` each batch is cut to this rank's
    rows (``parallel.mesh.local_batch``; on a spatial mesh its image rows
    of images ``height`` rows high)."""
    if steps % steps_per_call != 0:
        raise ValueError(f"steps_per_epoch={steps} not divisible by "
                         f"steps_per_call={steps_per_call}")
    n_calls = steps // steps_per_call
    log_calls = max(1, log_every // steps_per_call)
    t_start = time.perf_counter()
    timed_from = 0
    # the host's mean ms a step, its parts and a read-back between log lines
    host = (("host_step_ms", "gdn.train.step", steps_per_call),
            ("host_forward_ms", "gdn.train.forward", 1),
            ("host_backward_ms", "gdn.train.backward", 1),
            ("host_update_ms", "gdn.train.update", 1),
            ("readback_ms", "gdn.train.readback", 1))
    marks = {name: totals(name) for _, name, _ in host}
    for i in range(n_calls):
        if steps_per_call == 1:
            batch = _batch_to(local_batch(next(data_iter), mesh, batch_size, height), device)
        else:
            group = [_batch_to(local_batch(next(data_iter), mesh, batch_size, height), device)
                     for _ in range(steps_per_call)]
            batch = {k: torch.stack([b[k] for b in group]) for k in group[0]}
        with span("gdn.train.step"):
            state, terms = step_fn(state, *extra_args, batch)
        if i == 0:
            _floats(terms)
            t_start = time.perf_counter()
            timed_from = 1
        if (i + 1) % log_calls == 0 or i == n_calls - 1:
            with span("gdn.train.readback"):
                vals = _floats(terms)
            elapsed = max(time.perf_counter() - t_start, 1e-9)
            timed = i + 1 - timed_from
            # the LR of the last update applied (the schedule's value at it)
            log_kw = dict(step=state.step, **vals, lr=state.optimizer.param_groups[0]["lr"])
            if timed > 0:
                log_kw["imgs_per_sec"] = batch_size * steps_per_call * timed / elapsed
            for key, name, per in host:
                (n, ns), (n0, ns0) = totals(name), marks[name]
                marks[name] = (n, ns)
                if n > n0:  # spans taken under a profiler are not in the table
                    log_kw[key] = (ns - ns0) / (n - n0) / per / 1e6
            logger.log(**log_kw)
        if preemption is not None and preemption.stop(mesh, device):
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
              input_key: str = "depth", mesh=None) -> Dict[str, float]:
    """Periodic validation: the loss terms averaged over ``steps``
    held-out batches (fewer if ``val_iter`` ends first), without
    gradients, logged as ``val_*``.  Stage 2 feeds the G-net RGB
    (``input_key="rgb"``) and scores its depth alone: no guidance term.
    With a ``mesh`` each rank scores its rows and the terms are the
    global batch's."""
    cfg = _spatial_safe_cfg(cfg, mesh)
    group, rows = pixel_group(mesh), spatial_axis(mesh)
    sums: Dict[str, float] = {}
    n = 0
    for _ in range(steps):
        try:
            batch = _batch_to(local_batch(next(val_iter), mesh, cfg.data.batch_size,
                                          cfg.model.image_size[0]), device)
        except StopIteration:
            break
        with torch.no_grad():
            out = net(batch[input_key])
            terms = total_loss(out["depth"], batch["depth"], batch["mask"], cfg.loss,
                               cfg.model.max_depth, scale_preds=out["depth_scales"][:-1],
                               group=group, rows=rows)
        for k, v in _floats(_reported(terms, group)).items():
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


def stage2_state(cfg: Config, d_sd: Optional[Dict[str, torch.Tensor]],
                 device=None) -> TrainState:
    """A fresh stage-2 TrainState: a G-net (seed cfg.train.seed) with
    the decoder of the D-net ``d_sd`` (``transfer_stage1_decoder``; with
    ``d_sd`` None its own fresh decoder), frozen when
    cfg.train.freeze_decoder."""
    gen = torch.Generator().manual_seed(cfg.train.seed)
    g_sd = init_params(cfg.model, gen, in_channels=3)
    if d_sd is not None:
        g_sd = transfer_stage1_decoder(g_sd, d_sd)
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
    if multihost.rank() == 0:
        print(f"[train] preempted: checkpoint saved at step {state.step}; "
              "resume with --resume", flush=True)


def _mesh(cfg: Config, mesh, dev: torch.device):
    """The mesh a loop runs on: ``mesh``, or the one ``cfg.mesh``
    describes over the process group (None for one process)."""
    if mesh is not None:
        return mesh
    return create_mesh(cfg.mesh.num_devices, spatial=cfg.mesh.spatial_devices,
                       model=cfg.mesh.model_devices, device_type=dev.type)


def _place(cfg: Config, state: TrainState, mesh):
    """The state placed on ``mesh`` (left as it is when it already is)
    and the specs for the step builders."""
    if mesh is None or state.mesh is not None:
        return state, state.specs
    return shard_state(state, mesh, param_mode(cfg.mesh))


def _finish(cfg: Config, mesh) -> None:
    """Every write on disk, then the ranks meet: no rank returns before
    rank 0's checkpoints are readable."""
    if cfg.train.ckpt_dir:
        wait_for_checkpoints(cfg.train.ckpt_dir)
    if mesh is not None:
        torch.distributed.barrier()


def train_stage1(cfg: Config, data_iter: Iterable[Dict[str, Any]],
                 epochs: Optional[int] = None, state: Optional[TrainState] = None,
                 logger: Optional[MetricLogger] = None,
                 val_iter: Optional[Iterable[Dict[str, Any]]] = None,
                 val_steps: int = 10, device=None,
                 loader_state_fn: Optional[Callable[[int], Optional[Dict[str, Any]]]] = None,
                 mesh=None) -> TrainState:
    """D-net pretraining; returns the final TrainState.  Starts from
    ``stage1_state`` unless ``state`` is given.  ``mesh``: the data mesh
    (default: ``cfg.mesh`` over the process group, if any).  ``val_iter``: held-out
    batches, validated after each epoch (``val_steps`` of them, from the
    start of the iterable each time).  ``loader_state_fn(step)``: the
    data cursor each checkpoint saves as its ``loader`` entry (default
    ``{"step": step}``).  cfg.train.check_numerics raises
    FloatingPointError at the first step whose loss terms are not
    finite."""
    dev = _prepare(device)
    mesh = _mesh(cfg, mesh, dev)
    if state is None:
        state = stage1_state(cfg, dev)
    state, specs = _place(cfg, state, mesh)
    k = cfg.train.steps_per_call
    mesh_kw = {} if mesh is None else dict(mesh=mesh, state_sharding=specs)
    step_fn = _guarded(cfg, make_stage1_multistep(cfg, k, **mesh_kw) if k > 1
                       else make_stage1_step(cfg, **mesh_kw))
    logger = logger or MetricLogger(prefix="stage1")
    if multihost.rank() != 0:
        logger = _Quiet()
    data_iter = iter(data_iter)
    preempt = PreemptionHandler().install()
    try:
        for _ in range(epochs if epochs is not None else cfg.train.epochs):
            state = _epoch_loop(step_fn, state, data_iter, cfg.train.steps_per_epoch,
                                logger, cfg.data.batch_size, cfg.train.log_every, dev,
                                steps_per_call=k, preemption=preempt, mesh=mesh,
                                height=cfg.model.image_size[0])
            if val_iter is not None and not preempt.requested:
                _validate(cfg, state.net, iter(val_iter), val_steps, logger, state.step, dev,
                          mesh=mesh)
            if cfg.train.ckpt_dir:
                _save(cfg, state, "stage1", loader_state_fn=loader_state_fn)
            if preempt.requested:
                _preempted(state)
                break
    finally:
        preempt.uninstall()
        _finish(cfg, mesh)
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
                 loader_state_fn: Optional[Callable[[int], Optional[Dict[str, Any]]]] = None,
                 mesh=None) -> TrainState:
    """Guided G-net training; returns the final TrainState.

    ``d_params``: the trained stage-1 D-net, as its state_dict or as the
    DtoDNet itself (on the device; it is frozen in place).  Unless
    ``state`` is given, the G-net starts from ``stage2_state``: fresh
    weights with the D-net's decoder.  The D-net runs without grad.

    ``val_iter``, ``val_steps``, ``loader_state_fn``, ``mesh``: as in
    :func:`train_stage1`; the D-net is placed as the G-net's state.
    ``eval_dataset``: a zero-argument callable returning the eval split
    ({'rgb' (1, H, W, 3), 'gt' (1, Hg, Wg)}); every ``eval_every``
    epochs the full eval protocol runs on it (at most
    ``eval_max_images`` images) and logs ``eval_*``.  One Evaluator
    serves the whole run; the split is cached on the device at its first
    use, or stays host-fed past the 2 GiB gate or when the card runs out
    of memory.  Each new best eval RMSE saves a checkpoint to
    ``<ckpt_dir>/stage2_best``, which keeps one."""
    dev = _prepare(device)
    mesh = _mesh(cfg, mesh, dev)
    d_net = (d_params if isinstance(d_params, torch.nn.Module)
             else _net(DtoDNet, cfg, d_params, dev)).requires_grad_(False)
    if state is None:
        state = stage2_state(cfg, d_net.state_dict(), dev)
    state, specs = _place(cfg, state, mesh)
    d_net = shard_frozen(d_net, mesh, param_mode(cfg.mesh))
    k = cfg.train.steps_per_call
    mesh_kw = {} if mesh is None else dict(mesh=mesh, state_sharding=specs)
    step_fn = _guarded(cfg, make_stage2_multistep(cfg, k, **mesh_kw) if k > 1
                       else make_stage2_step(cfg, **mesh_kw))
    logger = logger or MetricLogger(prefix="stage2")
    if multihost.rank() != 0:
        logger = _Quiet()
    data_iter = iter(data_iter)
    evaluator, eval_cached, best_rmse = None, False, float("inf")
    preempt = PreemptionHandler().install()
    try:
        for epoch in range(epochs if epochs is not None else cfg.train.epochs):
            state = _epoch_loop(step_fn, state, data_iter, cfg.train.steps_per_epoch,
                                logger, cfg.data.batch_size, cfg.train.log_every, dev,
                                extra_args=(d_net,), steps_per_call=k,
                                preemption=preempt, mesh=mesh,
                                height=cfg.model.image_size[0])
            if val_iter is not None and not preempt.requested:
                _validate(cfg, state.net, iter(val_iter), val_steps, logger, state.step,
                          dev, input_key="rgb", mesh=mesh)
            if (eval_dataset is not None and (epoch + 1) % max(eval_every, 1) == 0
                    and not preempt.requested):
                if evaluator is None:
                    evaluator = Evaluator(cfg, make_eval_forward(cfg, state.net), mesh=mesh,
                                          device=dev)
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
        _finish(cfg, mesh)
    return state
