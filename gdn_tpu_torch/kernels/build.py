"""Build the port's CUDA sources with nvcc and load them with ctypes.

Each ``gdn_tpu_torch/csrc/<name>.cu`` has a plain C interface and is
compiled on its own into ``gdn_tpu_torch/_build/lib<name>-<hash>.so``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o _build/lib<name>-<hash>.so csrc/<name>.cu

The hash is that of the source, so an edited source builds anew and an
unchanged one is loaded from the earlier build.  A build takes seconds
(the sources include no PyTorch header); ``build_all`` starts one nvcc
per missing library, all together.  A missing ``nvcc`` or a failed
build raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, Iterable

PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(PKG, "csrc")
BUILD = os.path.join(PKG, "_build")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (looked on PATH and in /usr/local/cuda/bin); "
            "the port's CUDA kernels are built from source at first use"
        )
    return path


def _target(name: str) -> str:
    with open(os.path.join(CSRC, f"{name}.cu"), "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(BUILD, f"lib{name}-{digest}.so")


def _start(name: str, out: str):
    os.makedirs(BUILD, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return cmd, tmp, out, proc


def _finish(job) -> None:
    cmd, tmp, out, proc = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{log}"
        )
    os.replace(tmp, out)  # atomic: readers never see half a file


def build_all(names: Iterable[str]) -> None:
    """Build the missing libraries of ``names``, one nvcc each, all
    started together; raises the first failure after all have ended."""
    with _lock:
        targets = [(n, _target(n)) for n in names]
        jobs = [_start(n, out) for n, out in targets if not os.path.exists(out)]
        errors = []
        for job in jobs:
            try:
                _finish(job)
            except RuntimeError as e:
                errors.append(e)
        if errors:
            raise errors[0]


def load(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built first if needed."""
    lib = _libs.get(name)
    if lib is None:
        build_all((name,))
        with _lock:
            lib = _libs.setdefault(name, ctypes.CDLL(_target(name)))
    return lib
