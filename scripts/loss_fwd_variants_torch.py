#!/usr/bin/env python3
"""Design check of the one-launch fused-loss forward (``loss_forward``) on
the card: the shipped tile against other tiles, in one process.

    python3 scripts/loss_fwd_variants_torch.py [NAME=PATH ...]

Needs one CUDA card (an H100) and nvcc.  It builds
``gdn_tpu_torch/csrc/fused_loss.cu`` as shipped, a copy of it for each
tile below (the source's ``kFH, kFW`` and ``kFwdBlocks`` rewritten, the
copy written under the build directory), and each NAME=PATH source given
(another state of that file with the same C interface), with ``-Xptxas
-v`` (every ``loss_forward`` instantiation's registers and spill bytes
are printed), one nvcc each, all started together:

  shipped  32 x 64, two blocks an SM;
  32x32    32 x 32, __launch_bounds__ for four blocks an SM;
  32x32b3  32 x 32, for three blocks an SM;
  16x64    16 x 64, for four blocks an SM.

Then, at the training shape (B=32, 128x416, three input sets cycled so
that they overflow the 50 MB L2), it holds each build's (B, 8) sums
against ``loss_sums_plain`` (rtol 1e-5, atol 1e-6) and a second call's
bits, and times the builds in turns (shipped first and last), in device
µs from ``torch.profiler``, with each one's plan (blocks an SM, grid,
tiles a block).  Last, the shipped build at B in BATCHES (128x416, the
same three-set cycle): the fixed cost of a call against the cost a tile.
Prints one line a build, one for the batches, and the card's name and
power limit; exits nonzero on a failure.
"""

import ctypes
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

VARIANTS = {"32x32": (32, 32, 4), "32x32b3": (32, 32, 3), "16x64": (16, 64, 4)}
_TILE = re.compile(r"constexpr int kFH = (\d+), kFW = (\d+);")
_BLOCKS = re.compile(r"constexpr int kFwdBlocks = \d+;")
SHAPE = (32, 128, 416)
BATCHES = (1, 2, 4, 8, 16, 32, 64)


def tile_of(path):
    """The forward's (rows, cols) tile as a source states it."""
    with open(path) as f:
        return tuple(int(v) for v in _TILE.search(f.read()).groups())


def variant(src, out_dir, name, rows, cols, blocks):
    """A copy of ``src`` with the tile and blocks an SM rewritten: its path."""
    with open(src) as f:
        text = f.read()
    text, n = _TILE.subn(f"constexpr int kFH = {rows}, kFW = {cols};", text)
    text, m = _BLOCKS.subn(f"constexpr int kFwdBlocks = {blocks};", text)
    if (n, m) != (1, 1):
        raise RuntimeError(f"{src}: the tile or blocks constant not found once")
    path = os.path.join(out_dir, f"{name}.cu")
    with open(path, "w") as f:
        f.write(text)
    return path


def build(out_dir, sources):
    """{name: (loaded library, tile)} of the shipped source, VARIANTS and
    ``sources`` ({name: path}), ptxas's report of loss_forward printed."""
    from gdn_tpu_torch.kernels import build as kb, fused_loss as fl

    src = os.path.join(kb.CSRC, "fused_loss.cu")
    paths = {"shipped": src}
    paths.update({name: variant(src, out_dir, name, *v) for name, v in VARIANTS.items()})
    paths.update(sources)
    procs = {name: subprocess.Popen(
        [kb._nvcc(), *kb.NVCC_FLAGS, "-Xptxas", "-v", "-o",
         os.path.join(out_dir, f"{name}.so"), path],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, path in paths.items()}
    shipped = fl.load()  # the argtypes
    libs = {}
    for name, p in procs.items():
        log = p.communicate()[0]
        if p.returncode != 0:
            raise RuntimeError(f"nvcc ({name}) failed:\n{log}")
        fn = None
        for line in log.splitlines():
            m = re.search(r"Compiling entry function '([^']+)'", line)
            if m:
                fn = m.group(1)
            elif fn and "loss_forward" in fn and ("Used" in line or "spill" in line):
                print(f"  {name} {fn[-30:]}: {line.split(':', 1)[-1].strip()}")
        lib = ctypes.CDLL(os.path.join(out_dir, f"{name}.so"))
        for entry in ("fused_loss_forward", "fused_loss_forward_occupancy",
                      "fused_loss_forward_attrs"):
            getattr(lib, entry).argtypes = getattr(shipped, entry).argtypes
            getattr(lib, entry).restype = ctypes.c_int
        libs[name] = (lib, tile_of(paths[name]))
    return libs


def plan(b, h, w, lib, tile):
    """fwd_plan's plan for a build of another tile: (FwdPlan, blocks an SM)."""
    from gdn_tpu_torch.kernels import fused_loss as fl

    info = (ctypes.c_int * 3)()
    if lib.fused_loss_forward_occupancy(5, info):
        raise RuntimeError("fused_loss_forward_occupancy failed")
    ty, tx = -(-h // tile[0]), -(-w // tile[1])
    grid = min(info[0] * info[1], b * ty * tx)
    return fl.FwdPlan(ty, tx, grid, -(-b * ty * tx // grid)), info[1]


def forward(lib, plan, pred, gt, mask, wt):
    """One call of the build's forward with ``plan``: (B, 8) sums."""
    import torch

    from gdn_tpu_torch.kernels import fused_loss as fl

    b, h, w = pred.shape
    partials = torch.empty((b, plan.tiles_y * plan.tiles_x, 8), device="cuda")
    out = torch.empty((b, 8), device="cuda")
    err = lib.fused_loss_forward(
        pred.data_ptr(), gt.data_ptr(), mask.data_ptr(), wt.data_ptr(), partials.data_ptr(),
        out.data_ptr(), b, h, w, 5, plan.tiles_y, plan.tiles_x, plan.grid, 1 / 80.0, fl.C1,
        fl.C2, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_loss_forward failed: cudaError {err}")
    return out


def main():
    import torch

    if not torch.cuda.is_available():
        print("loss_fwd_variants_torch: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from gdn_tpu_torch.kernels import fused_loss as fl

    out_dir = os.path.join(ROOT, "gdn_tpu_torch", "_build", "variants")  # gitignored
    os.makedirs(out_dir, exist_ok=True)
    libs = build(out_dir, dict(a.split("=", 1) for a in sys.argv[1:]))
    gen = torch.Generator(device="cuda").manual_seed(1)
    ins = cs._loss_inputs(*SHAPE, 3, gen)
    wt = fl._weights(11, 1.5, torch.device("cuda"))
    ref = fl.loss_sums_plain(*ins[0], 80.0)

    runs = {}
    for name, (lib, tile) in libs.items():
        attrs = (ctypes.c_int * 5)()
        if lib.fused_loss_forward_attrs(attrs):
            raise RuntimeError(f"{name}: fused_loss_forward_attrs failed")
        pl, per_sm = plan(*SHAPE, lib, tile)
        got = forward(lib, pl, *ins[0], wt)
        again = forward(lib, pl, *ins[0], wt)
        torch.cuda.synchronize()
        cs.check_tol(got, ref, 1e-5, 1e-6, f"{name} sums")
        if not torch.equal(got, again):
            raise AssertionError(f"{name}: two calls differ")
        runs[name] = [lambda i=i, lib=lib, pl=pl: forward(lib, pl, *i, wt) for i in ins]
        print(f"{name}: tile {tile}, {attrs[0]} registers, {attrs[1]} local bytes, "
              f"{attrs[2] + attrs[3]} bytes of shared memory, {per_sm} blocks an SM, grid "
              f"{pl.grid}, <= {pl.tiles_per_block} tiles a block", flush=True)
    order = ["shipped", *[n for n in libs if n != "shipped"], "shipped"]
    times = [(name, cs.device_ms(runs[name], what=name) * 1e3) for name in order]
    print(f"B={SHAPE[0]} {SHAPE[1]}x{SHAPE[2]} forward: "
          + " ".join(f"{name} {us:.1f}" for name, us in times) + " (device us)")
    line = []
    lib, tile = libs["shipped"]
    for b in BATCHES:
        sets = cs._loss_inputs(b, *SHAPE[1:], 3, gen)
        pl, _ = plan(b, *SHAPE[1:], lib, tile)
        us = cs.device_ms([lambda i=i: forward(lib, pl, *i, wt) for i in sets],
                          what=f"B={b}") * 1e3
        line.append(f"B={b} {us:.1f} ({b * pl.tiles_y * pl.tiles_x} tiles, "
                    f"<= {pl.tiles_per_block} a block)")
    print("shipped at 128x416: " + "; ".join(line) + " (device us)")
    if cs.EVENT_TIMED:
        print(f"timed with CUDA events: {cs.EVENT_TIMED}")
    print(cs.smi_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
