"""What every cell's run shares: finding the cell, its configuration and
its traffic by name, the program's config built from the configuration
file, the device, the clock, the checks and the result line."""

from __future__ import annotations

import importlib.util
import json
import math
import os
import sys
import time
from typing import Dict, List, Optional

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
# top-level module names the process must not hold (compared whole)
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "gdn_tpu")


def now() -> float:
    """Seconds since boot (the clock process start times are kept on)."""
    return time.clock_gettime(time.CLOCK_BOOTTIME)


def process_start() -> float:
    """The process's start on ``now()``'s clock, from /proc/self/stat;
    now when that cannot be read."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        return ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return now()


def load_json(*parts: str):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def benchmark_spec() -> Dict:
    return load_json(ROOT, "BENCHMARK.json")


def load_cell(name: str) -> Dict:
    """The cell's file ``workloads/<name>.json``: config, traffic (the
    mix's name), kind (``traffic/<kind>.py``), its parameters,
    chips, why and the limits of its checks."""
    path = os.path.join(BENCH, "workloads", f"{name}.json")
    if not os.path.exists(path):
        raise SystemExit(f"no cell {name!r}: {path} does not exist")
    cell = load_json(path)
    cell["name"] = name
    return cell


def load_config(name: str) -> Dict:
    return load_json(BENCH, "configs", f"{name}.json")


def load_module(kind: str, name: str):
    """``benchmark/<kind>/<name>.py`` as a module (names may hold dots)."""
    path = os.path.join(BENCH, kind, f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"bench_{kind}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def program_config(cfgj: Dict, batch: int, overrides: Optional[Dict] = None):
    """The port's ``Config`` for the configuration file ``cfgj``: every
    size and loss weight from the file, the default kernel routes."""
    from gdn_tpu_torch.config import Config, DataConfig, LossConfig, ModelConfig, TrainConfig

    lw, tr = cfgj["loss"], cfgj["train"]
    model = ModelConfig(
        image_size=tuple(cfgj["image_size"]), enc_channels=tuple(cfgj["enc_channels"]),
        dec_channels=tuple(cfgj["dec_channels"]), group_norm_groups=cfgj["group_norm_groups"],
        norm=cfgj["norm"], activation=cfgj["activation"], upsample=cfgj["upsample"],
        fusion=cfgj["fusion"], max_depth=cfgj["max_depth"], min_depth=cfgj["min_depth"],
        dtype=cfgj["dtype"], **(overrides or {}))
    loss = LossConfig(w_recon=lw["w_recon"], w_grad=lw["w_grad"], w_ssim=lw["w_ssim"],
                      w_latent=lw["w_latent"], ssim_window=lw["ssim_window"],
                      ssim_sigma=lw["ssim_sigma"], grad_scales=lw["grad_scales"])
    train = TrainConfig(mode="RtoD", lr=tr["lr"], beta1=tr["beta1"], beta2=tr["beta2"],
                        eps=tr["eps"], freeze_decoder=True, log_every=tr["log_every"])
    return Config(model=model, loss=loss, data=DataConfig(batch_size=batch), train=train)


def percentile(values: List[float], q: float) -> float:
    """Nearest-rank percentile ``q`` (0-100) of ``values``; inf counts
    as larger than any number."""
    xs = sorted(values)
    k = max(0, math.ceil(q / 100.0 * len(xs)) - 1)
    return xs[k]


class Run:
    """One run of one cell: its inputs, and what it found."""

    def __init__(self, cell: Dict, cfgj: Dict, seed: int, seconds: float, trace: bool,
                 device, t_proc: Optional[float] = None):
        self.cell, self.cfgj, self.seed = cell, cfgj, seed
        self.seconds, self.trace, self.device = seconds, trace, device
        self.params = cell["params"]
        self.t_proc = process_start() if t_proc is None else t_proc
        self.e2e: Dict[str, float] = {}
        self.checks: List[tuple] = []  # (name, value, limit); value <= limit passes
        self.attempted = 0
        self.failed = 0
        self.sound = True  # False when the run saw an answer that never came
        self.slice = None  # harness.trace.Slice of the traced run
        self.ctx: Dict = {}  # what the per-layer readers read
        self.memory_peak = 0

    def setup_done(self) -> None:
        """Set-up ends here: process start to the first timed step."""
        self.e2e["setup_s"] = now() - self.t_proc

    def note(self, msg: str) -> None:
        print(f"[bench] {msg}", file=sys.stderr, flush=True)

    def check(self, name: str, value: float, limit: float) -> None:
        self.checks.append((name, float(value), float(limit)))

    @property
    def correct(self) -> bool:
        return self.sound and all(math.isfinite(v) and v <= lim for _, v, lim in self.checks)
