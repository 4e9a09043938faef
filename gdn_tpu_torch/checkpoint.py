"""Weights and checkpoints for the port: weights carried over from the
JAX package, read from or written to a ``.pth`` (under the port's keys,
or under a reference's through the JAX package's key map), drawn at
random from an explicit generator, or moved from the stage-1 D-net's
decoder into a stage-2 G-net; and the training checkpoints a run
resumes from.

The port's module attributes follow the flax parameter paths and its
conv kernels are OIHW, so its ``state_dict`` keys and layouts are
exactly those of ``gdn_tpu.checkpoint.params_to_torch`` (and of the
``.pth`` files ``scripts/export_torch.py`` writes).

A training checkpoint directory (``<ckpt_dir>/stage1``, ``stage2`` or
``stage2_best``, the JAX package's names) holds ``config.json``, the
run's Config in the JAX package's format (either package rebuilds the
same net from it), and one ``<step>.pt`` a save: a plain dict that
``torch.load(weights_only=True)`` reads, of ``params`` (the state_dict),
``ema`` (when the run keeps one), ``optimizer`` (the Adam/AdamW
``state_dict()``), ``step`` (micro-steps), ``updates``, ``accum`` (the
gradient mean so far, when grad_accum > 1) and ``loader`` (the data
cursor: ``{"step": n}``, with the grain loader's counterpart
``{"step": n, "grain": its cursor at n}``).  Every file is written to a temporary name and
renamed, so a reader never sees half of one.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import re
import tempfile
import threading
from collections.abc import Mapping
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from gdn_tpu_torch import config as config_mod
from gdn_tpu_torch.config import Config, ModelConfig

def params_from_flax(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX package's nested parameter dict (numpy arrays) -> the
    port's state_dict: flax path "a/b/c" becomes key "a.b.c", 4-D conv
    kernels go HWIO -> OIHW, everything else copies as float32."""
    out: Dict[str, torch.Tensor] = {}

    def walk(node, prefix):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{prefix}.{k}" if prefix else k)
            return
        arr = np.asarray(node, dtype=np.float32)
        if arr.ndim == 4:
            arr = np.transpose(arr, (3, 2, 0, 1))  # HWIO -> OIHW
        out[prefix] = torch.from_numpy(np.array(arr, copy=True, order="C"))

    walk(tree, "")
    return out


def quant_from_flax(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX package's ``"quant"`` collection (nested dict of numpy
    scalars, from ``gdn_tpu.ops.quant.calibrate_quant``) -> the port's
    scale dict for ``ops.quant.set_quant_scales``: path "a/b/x_scale"
    becomes key "a.b.x_scale", each scale a float32 0-d tensor."""
    out: Dict[str, torch.Tensor] = {}

    def walk(node, prefix):
        if isinstance(node, Mapping):
            for k, v in node.items():
                walk(v, f"{prefix}.{k}" if prefix else k)
            return
        out[prefix] = torch.tensor(float(np.asarray(node, dtype=np.float32)),
                                   dtype=torch.float32)

    walk(tree, "")
    return out


def load_pth(path: str) -> Dict[str, torch.Tensor]:
    """Read a ``.pth`` state_dict written by ``scripts/export_torch.py``
    (tensors only; nothing is unpickled beyond them)."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if not isinstance(sd, dict):
        raise ValueError(f"{path}: expected a state_dict, got {type(sd)}")
    return {k: v.float() for k, v in sd.items()}


def save_pth(state_dict: Dict[str, torch.Tensor], path: str) -> None:
    """Write a state_dict as ``load_pth`` and ``scripts/serve_torch.py
    --pth`` read it: fp32 CPU tensors under the port's (flax-path) keys,
    the format of ``scripts/export_torch.py``."""
    if os.path.dirname(path):
        os.makedirs(os.path.dirname(path), exist_ok=True)
    sd = {k: v.detach().float().cpu().contiguous() for k, v in state_dict.items()}
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(sd, tmp)
    os.replace(tmp, path)  # atomic: a reader never sees half a file


def flax_path(key: str) -> str:
    """The flax parameter path ("a/b/c") of the port's state_dict key
    ("a.b.c").  A torch module or parameter name holds no dot, so the
    key's parts are the path's."""
    return "/".join(key.split("."))


def unwrap_state_dict(obj: Any) -> Dict[str, Any]:
    """The state_dict inside a loaded reference ``.pth``: the value of
    its ``"state_dict"`` entry where it has one, keys without
    DataParallel's ``module.`` prefix (``scripts/import_torch.py``'s
    rules)."""
    if not isinstance(obj, dict):
        raise ValueError(f"expected a state_dict (dict of tensors), got {type(obj).__name__}")
    if isinstance(obj.get("state_dict"), dict):
        obj = obj["state_dict"]
    return {k[len("module."):] if k.startswith("module.") else k: v for k, v in obj.items()}


def params_from_torch(template: Dict[str, torch.Tensor], state_dict: Dict[str, Any],
                      key_map: Optional[Dict[str, str]] = None,
                      strict: bool = True) -> Dict[str, torch.Tensor]:
    """Import a torch ``state_dict`` in another naming (a reference
    ``.pth``) into the port's state_dict shaped like ``template``: what
    ``gdn_tpu.checkpoint.params_from_torch`` followed by
    :func:`params_from_flax` gives.

    ``key_map`` is the JAX package's JSON map, flax path ("a/b/c") ->
    torch key; a leaf it does not name looks for its own key "a.b.c".
    Every 4-D tensor is OIHW, the port's layout, so nothing is permuted
    (a transposed conv's kernel is not detected: pre-permute it, as for
    the JAX import).  Values are copied as float32 onto the template
    leaf's device; keys of ``state_dict`` no leaf asks for are ignored.
    The leaves are visited in the order of the JAX package's trees (keys
    sorted at each level), so both packages name the same leaf: a shape
    that differs raises ValueError; with ``strict`` every leaf must be
    found (KeyError naming the first five missing flax paths); otherwise
    a missing leaf keeps the template's value."""
    key_map = key_map or {}
    out: Dict[str, torch.Tensor] = {}
    missing = []
    for key in sorted(template, key=lambda k: k.split(".")):
        want, path = template[key], flax_path(key)
        tkey = key_map.get(path, key)
        if tkey not in state_dict:
            missing.append(path)
            out[key] = want
            continue
        arr = state_dict[tkey]
        arr = (arr.detach() if isinstance(arr, torch.Tensor)
               else torch.from_numpy(np.array(arr, dtype=np.float32)))
        if tuple(arr.shape) != tuple(want.shape):
            raise ValueError(f"shape mismatch importing {tkey!r} -> {path!r}: "
                             f"{tuple(arr.shape)} vs {tuple(want.shape)}")
        out[key] = arr.to(device=want.device, dtype=torch.float32, copy=True)
    if strict and missing:
        raise KeyError(
            f"torch state_dict is missing {len(missing)} template leaves, "
            f"first: {missing[:5]} (pass strict=False for partial import "
            f"or extend key_map)")
    return {k: out[k] for k in template}


def params_to_torch(state_dict: Dict[str, torch.Tensor],
                    key_map: Optional[Dict[str, str]] = None) -> Dict[str, torch.Tensor]:
    """The port's state_dict renamed by ``key_map`` (flax path -> torch
    key, the map :func:`params_from_torch` reads), as float32 CPU
    tensors: the exact inverse of the import and what
    ``gdn_tpu.checkpoint.params_to_torch`` gives on the same weights."""
    key_map = key_map or {}
    return {key_map.get(flax_path(k), k): v.detach().to(
        "cpu", torch.float32, copy=True, memory_format=torch.contiguous_format)
        for k, v in state_dict.items()}


def transfer_stage1_decoder(g_sd: Dict[str, torch.Tensor],
                            d_sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A G-net state_dict whose ``decoder.*`` entries are copies of the
    trained D-net's.  Raises when the two decoders differ in keys or
    shapes instead of training a random decoder."""
    def dec(sd):
        return {k: v for k, v in sd.items() if k.startswith("decoder.")}

    d_dec, g_dec = dec(d_sd), dec(g_sd)
    d_shapes = {k: tuple(v.shape) for k, v in d_dec.items()}
    g_shapes = {k: tuple(v.shape) for k, v in g_dec.items()}
    if d_shapes != g_shapes:
        raise ValueError(
            "stage-1 decoder is not shape-compatible with the stage-2 "
            f"decoder: {d_shapes} vs {g_shapes}")
    return {**g_sd, **{k: v.detach().clone() for k, v in d_dec.items()}}


def _lecun(shape, fan_in: int, generator: torch.Generator) -> torch.Tensor:
    """flax's lecun_normal: a normal truncated at 2 std of the untruncated
    one and rescaled so the draw keeps variance 1/fan_in."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    t = torch.empty(shape)
    torch.nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std, generator=generator)
    return t


def init_params(cfg: ModelConfig, generator: torch.Generator,
                in_channels: int = 3) -> Dict[str, torch.Tensor]:
    """Random weights for an RtoDNet (in_channels=3) or DtoDNet (1),
    drawn as the JAX package's initializers draw them: lecun-normal conv
    kernels (fan-in cin * kh * kw; a 4x4 lecun ConvTranspose 16 * cin,
    a 1x1 ``lateral_proj`` cin), the bilinear-init ConvTranspose as
    ``compose_bilinear_deconv_kernel`` of a lecun 3x3 draw (fan-in
    9 * cin), GN scales 1, biases 0.  The numbers are not flax's: a JAX
    key and a torch generator give different draws."""
    from gdn_tpu_torch.models import DtoDNet, RtoDNet
    from gdn_tpu_torch.ops.resize import compose_bilinear_deconv_kernel

    net = (RtoDNet if in_channels == 3 else DtoDNet)(cfg)
    sd = {}
    for name, p in net.state_dict().items():
        leaf = name.rsplit(".", 1)[1]
        if p.dim() == 4 and name.endswith("ConvTranspose_0.kernel") and (
                cfg.deconv_init == "bilinear"):
            cout, cin = p.shape[:2]
            t = compose_bilinear_deconv_kernel(_lecun((cout, cin, 3, 3), 9 * cin, generator))
        elif p.dim() == 4:
            t = _lecun(p.shape, p.shape[1] * p.shape[2] * p.shape[3], generator)
        elif leaf.endswith("scale"):
            t = torch.ones(p.shape)
        else:
            t = torch.zeros(p.shape)
        sd[name] = t
    return sd


# ------------------------------------------------------------ config.json

def save_config(ckpt_dir: str, cfg: Config) -> None:
    """Write the run's Config as ``<ckpt_dir>/config.json`` (the JAX
    package's format: ``dataclasses.asdict``, sorted keys), atomically."""
    path = os.path.join(os.path.abspath(ckpt_dir), "config.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path), suffix=".tmp")
    with os.fdopen(fd, "w") as f:
        json.dump(dataclasses.asdict(cfg), f, indent=1, sort_keys=True)
    os.replace(tmp, path)


def load_config(ckpt_dir: str) -> Optional[Config]:
    """The Config saved next to a checkpoint; None without config.json."""
    path = os.path.join(os.path.abspath(ckpt_dir), "config.json")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return config_from_dict(json.load(f))


def config_from_dict(payload: Dict[str, Any]) -> Config:
    """Rebuild a Config from ``dataclasses.asdict`` output.  JSON lists
    become tuples again; keys this version does not know are dropped
    with a warning; a value neither package runs raises the config's
    ``ValueError``."""

    def build(dc_type, d):
        fields = {f.name: f for f in dataclasses.fields(dc_type)}
        kwargs = {}
        for k, v in d.items():
            if k not in fields:
                print(f"[checkpoint] config.json key {k!r} unknown to "
                      f"this version of {dc_type.__name__}; ignored", flush=True)
                continue
            if isinstance(v, dict):  # a nested dataclass, named by its annotation
                kwargs[k] = build(getattr(config_mod, str(fields[k].type).split(".")[-1]), v)
            elif isinstance(v, list):
                kwargs[k] = tuple(v)
            else:
                kwargs[k] = v
        return dc_type(**kwargs)

    return build(Config, payload)


# ------------------------------------------------------- training checkpoints

_STEP_FILE = re.compile(r"^(\d+)\.pt$")


def _steps(ckpt_dir: str) -> List[int]:
    """The steps saved in ``ckpt_dir``, oldest first (a temporary file
    of a write in flight or torn is never one)."""
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(int(m.group(1)) for m in map(_STEP_FILE.match, os.listdir(ckpt_dir)) if m)


def latest_step(ckpt_dir: str) -> Optional[int]:
    """The newest step saved in ``ckpt_dir``; None when there is none."""
    steps = _steps(ckpt_dir)
    return steps[-1] if steps else None


def _to_host(obj):
    """A copy of ``obj`` with every tensor copied to the CPU.  A copy
    from the card finishes before this returns (the next optimizer step
    updates the parameters in place); a CPU tensor is copied too."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v) for v in obj)
    return obj


class _Writes:
    """Asynchronous checkpoint writes not yet waited for, by directory:
    one background thread, so they land in the order they were made."""

    def __init__(self):
        self._lock = threading.Lock()
        self._pool: Optional[ThreadPoolExecutor] = None
        self._pending: List[Tuple[str, Future]] = []

    def submit(self, ckpt_dir: str, fn: Callable[[], None]) -> None:
        with self._lock:
            if self._pool is None:
                self._pool = ThreadPoolExecutor(1, thread_name_prefix="checkpoint")
            self._pending.append((ckpt_dir, self._pool.submit(fn)))

    def wait(self, root: str) -> None:
        """Wait for the writes under ``root``; re-raises a failed one."""
        with self._lock:
            mine = [f for d, f in self._pending if d == root or d.startswith(root + os.sep)]
            self._pending = [(d, f) for d, f in self._pending if f not in mine]
        for f in mine:
            f.result()


_WRITES = _Writes()


def _write(ckpt_dir: str, step: int, payload: Dict[str, Any], keep: int) -> None:
    path = os.path.join(ckpt_dir, f"{step}.pt")
    tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)
    for old in _steps(ckpt_dir)[:-keep] if keep > 0 else []:
        os.remove(os.path.join(ckpt_dir, f"{old}.pt"))


def save_checkpoint(ckpt_dir: str, step: int, state, keep: int = 3,
                    use_async: bool = False, cfg: Optional[Config] = None,
                    loader_state: Optional[Dict[str, Any]] = None) -> None:
    """Save ``state`` (a ``train.state.TrainState``) as
    ``<ckpt_dir>/<step>.pt`` and keep the newest ``keep`` files (0 keeps
    all).  ``cfg`` is written as ``config.json``; ``loader_state``, the
    data cursor, rides the file as ``loader``.

    The payload is copied to the host before this returns.  With
    ``use_async`` a background thread then writes it;
    :func:`wait_for_checkpoints` waits for it and raises its error.

    In a process group every rank calls this (an FSDP state is gathered
    to the single-device layout by all of them) and rank 0 writes: the
    file is the one a single-device run writes."""
    from gdn_tpu_torch.parallel.multihost import rank

    payload = _to_host(state.state_dict())
    if rank() != 0:
        return
    ckpt_dir = os.path.abspath(ckpt_dir)
    os.makedirs(ckpt_dir, exist_ok=True)
    if cfg is not None:
        save_config(ckpt_dir, cfg)
    if loader_state is not None:
        payload["loader"] = dict(loader_state)
    if use_async:
        _WRITES.submit(ckpt_dir, lambda: _write(ckpt_dir, step, payload, keep))
    else:
        _write(ckpt_dir, step, payload, keep)


def wait_for_checkpoints(root: str) -> None:
    """Wait until every asynchronous save under ``root`` is on disk: one
    call on a run's checkpoint root covers stage1/, stage2/ and
    stage2_best/."""
    _WRITES.wait(os.path.abspath(root))


def _read(ckpt_dir: str, step: Optional[int]) -> Dict[str, Any]:
    wait_for_checkpoints(ckpt_dir)
    step = latest_step(ckpt_dir) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoint found in {ckpt_dir}")
    return torch.load(os.path.join(ckpt_dir, f"{step}.pt"), map_location="cpu",
                      weights_only=True)


def restore_checkpoint(ckpt_dir: str, state, step: Optional[int] = None):
    """Load the checkpoint at ``step`` (default: the newest) into
    ``state`` and return it: parameters, optimizer state, counts, and
    the EMA and accumulator where the run keeps them."""
    state.load_state_dict(_read(ckpt_dir, step))
    return state


def load_params(ckpt_dir: str, key: str = "params",
                step: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """One set of weights of a checkpoint (default: the newest), as a
    state_dict: ``key="params"`` or ``"ema"``.  Raises KeyError naming
    the file when it holds no such set."""
    payload = _read(ckpt_dir, step)
    if key not in payload:
        raise KeyError(f"the checkpoint in {ckpt_dir} (step {payload['step']}) holds no "
                       f"{key!r}" + (" (its run had no ema_decay)" if key == "ema" else ""))
    return {k: v.float() for k, v in payload[key].items()}


def load_loader_state(ckpt_dir: str, step: Optional[int] = None) -> Optional[Dict[str, Any]]:
    """The data cursor saved with a checkpoint; None when it has none."""
    try:
        return _read(ckpt_dir, step).get("loader")
    except FileNotFoundError:
        return None
