"""Per-step metric logging (port of ``gdn_tpu/utils/logging.py``):
scalars go to stdout as ``[prefix] step=N k=v ...`` and, when a path is
given, to a JSONL file as {"t": seconds since start, "step": N, ...},
the JAX package's formats.  TensorBoard output is not ported yet
(ROADMAP Queue A item 9).
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import IO, Optional


class MetricLogger:
    def __init__(self, prefix: str = "", jsonl_path: Optional[str] = None,
                 stream: Optional[IO] = None):
        self.prefix = prefix
        # sys.stdout as it is now, not as it was when this module was imported
        self.stream = sys.stdout if stream is None else stream
        if jsonl_path and os.path.dirname(jsonl_path):
            os.makedirs(os.path.dirname(jsonl_path), exist_ok=True)
        self._jsonl = open(jsonl_path, "a") if jsonl_path else None
        self._t0 = time.time()

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

    def close(self) -> None:
        if self._jsonl:
            self._jsonl.close()
