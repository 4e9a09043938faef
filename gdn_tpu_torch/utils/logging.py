"""Per-step metric logging (port of ``gdn_tpu/utils/logging.py``):
scalars go to stdout as ``[prefix] step=N k=v ...``, when a path is
given to a JSONL file as {"t": seconds since start, "step": N, ...}, the
JAX package's formats, and with ``tensorboard_dir`` to TensorBoard event
files under the tag ``<prefix>/<key>`` through
``torch.utils.tensorboard.SummaryWriter``.  Without the ``tensorboard``
package the logger says so on stderr and goes on with stdout and JSONL,
as the JAX logger does without tensorflow.
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import IO, Optional


class MetricLogger:
    def __init__(self, prefix: str = "", jsonl_path: Optional[str] = None,
                 stream: Optional[IO] = None, tensorboard_dir: Optional[str] = None):
        self.prefix = prefix
        # sys.stdout as it is now, not as it was when this module was imported
        self.stream = sys.stdout if stream is None else stream
        if jsonl_path and os.path.dirname(jsonl_path):
            os.makedirs(os.path.dirname(jsonl_path), exist_ok=True)
        self._jsonl = open(jsonl_path, "a") if jsonl_path else None
        self._tb = None
        if tensorboard_dir:
            try:  # tensorboard is an optional dependency of this path only
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(tensorboard_dir)
            except ImportError:
                print("[logging] tensorboard unavailable; TensorBoard scalars disabled "
                      "(JSONL still written)", file=sys.stderr)
        self._t0 = time.time()

    @property
    def tensorboard(self) -> bool:
        """True when scalars go to TensorBoard event files."""
        return self._tb is not None

    def log(self, step: int, **scalars: float) -> None:
        msg = " ".join(
            f"{k}={v:.4f}" if isinstance(v, float) else f"{k}={v}"
            for k, v in scalars.items()
        )
        print(f"[{self.prefix}] step={step} {msg}", file=self.stream, flush=True)
        if self._jsonl:
            rec = {"t": time.time() - self._t0, "step": step, **scalars}
            self._jsonl.write(json.dumps(rec) + "\n")
            self._jsonl.flush()
        if self._tb is not None:
            for k, v in scalars.items():
                if isinstance(v, (int, float)):
                    self._tb.add_scalar(f"{self.prefix}/{k}" if self.prefix else k, v,
                                        global_step=step)
            self._tb.flush()

    def close(self) -> None:
        if self._jsonl:
            self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
