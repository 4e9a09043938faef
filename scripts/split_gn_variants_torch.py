#!/usr/bin/env python3
"""Design check of the split GN+ELU kernel (``gn_rows_sums`` +
``gn_rows_apply``, the form of GroupNorm+ELU for height shards) on the
card: the shipped build against other unrolls and register budgets, and,
where given, another tree's split form, in one call.

    python3 scripts/split_gn_variants_torch.py [--tree DIR] [NAME=PATH ...]

Needs one CUDA card (an H100) and nvcc.  It builds
``gdn_tpu_torch/csrc/group_norm_elu.cu`` as shipped and a copy of it for
each variant below (the source's ``kRowsUnroll`` and ``kRowsMinBlocks``
rewritten, the copy written under the build directory), one nvcc each,
all started together, with ``-Xptxas -v`` (every split-form
instantiation's registers and spill bytes are printed):

  u2     2 rows a thread a trip;
  u8     8 rows a thread a trip;
  b3     4 rows, __launch_bounds__ for three blocks an SM;
  u8b3   8 rows, for three blocks an SM;
  b4     4 rows, for four blocks an SM;

and each NAME=PATH source given (another state of that file with the
same C interface).

At each of the seven site shapes a spatial rank of the KITTI net holds
(B=32, half of 128x416's rows, bf16) every build is held to the plain
version (``_rows_plain``, chip_smoke's bf16 bound) and to a second call's
bits, then the builds are timed in turns (shipped first and last), in
device µs from ``torch.profiler``, with the plan each takes.  With
``--tree DIR`` (a checkout of another commit with the same
``gdn_tpu_torch.kernels.groupnorm._launch_rows``), that tree's split form
is timed at the same sites in a process of its own, before the builds and
after them.  Prints one line a build and site, the sums over the 21
sites, and the card's name and power limit; exits nonzero on a failure.
"""

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

VARIANTS = {"u2": (2, 1), "u8": (8, 1), "b3": (4, 3), "u8b3": (8, 3), "b4": (4, 4)}
_UNROLL = re.compile(r"constexpr int kRowsUnroll = \d+;")
_MINB = re.compile(r"constexpr int kRowsMinBlocks = \d+;")
BATCH = 32


def sites():
    """[(C, h, W, groups, count)] of a spatial rank's half of every GN
    site of the KITTI net, largest first."""
    import chip_smoke as cs
    from gdn_tpu_torch.config import kitti_config
    from gdn_tpu_torch.ops.groupnorm import pick_groups

    m = kitti_config().model
    half = [(c, h // 2, w) for c, h, w in cs.gn_sites(m)]
    return [(c, h, w, pick_groups(c, m.group_norm_groups), half.count((c, h, w)))
            for c, h, w in sorted(set(half), reverse=True)]


def inputs(c, h, w):
    import torch

    import chip_smoke as cs

    gen = torch.Generator(device="cuda").manual_seed(c * 1000 + h)
    x = cs._gn_input((BATCH, c, h, w), torch.bfloat16, gen)
    return x, torch.rand(c, device="cuda", generator=gen) + 0.5, torch.randn(
        c, device="cuda", generator=gen)


def time_tree():
    """In a process whose path leads with another tree: its split form's
    device ms at each site, as one JSON line."""
    import chip_smoke as cs
    from gdn_tpu_torch.kernels import groupnorm as gnk
    from gdn_tpu_torch.parallel.mesh import Axis

    alone, out = Axis(None, 1, 0), []
    for c, h, w, g, n in sites():
        x, scale, bias = inputs(c, h, w)
        split = {}
        ms = cs.device_ms([lambda: gnk._launch_rows(x, scale, bias, g, 1e-6, alone, h)],
                          what=f"tree {c}x{h}x{w}", split=split)
        out.append({"C": c, "h": h, "W": w, "sites": n, "ms": ms, "split": split})
    print("TREE " + json.dumps(out), flush=True)


def run_tree(tree):
    env = dict(os.environ, PYTHONPATH=tree)
    res = subprocess.run([sys.executable, os.path.abspath(__file__), "--time-tree"],
                         cwd=tree, env=env, capture_output=True, text=True, timeout=600)
    for line in res.stdout.splitlines():
        if line.startswith("TREE "):
            return json.loads(line[5:])
    raise RuntimeError(f"timing {tree} failed:\n{res.stdout[-3000:]}\n{res.stderr[-3000:]}")


def variant(src, out_dir, name, unroll, min_blocks):
    with open(src) as f:
        text = f.read()
    text, n = _UNROLL.subn(f"constexpr int kRowsUnroll = {unroll};", text)
    text, m = _MINB.subn(f"constexpr int kRowsMinBlocks = {min_blocks};", text)
    if (n, m) != (1, 1):
        raise RuntimeError(f"{src}: kRowsUnroll or kRowsMinBlocks not found once")
    path = os.path.join(out_dir, f"{name}.cu")
    with open(path, "w") as f:
        f.write(text)
    return path


def build(out_dir, sources):
    """{name: (library with argtypes, unroll)} of the shipped source,
    VARIANTS and ``sources`` ({name: path}), ptxas's report of the
    split-form kernels printed."""
    from gdn_tpu_torch.kernels import build as kb, groupnorm as gnk

    src = os.path.join(kb.CSRC, "group_norm_elu.cu")
    paths = {"shipped": src}
    paths.update({name: variant(src, out_dir, name, *v) for name, v in VARIANTS.items()})
    paths.update(sources)
    procs = {name: subprocess.Popen(
        [kb._nvcc(), *kb.NVCC_FLAGS, "-Xptxas", "-v", "-o", os.path.join(out_dir, f"{name}.so"),
         path], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, path in paths.items()}
    shipped = gnk.load()  # the argtypes
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
            elif fn and "gn_rows_" in fn and "bfloat16Li8" in fn and (
                    "Used" in line or "spill" in line):
                kind = "sums" if "gn_rows_sums" in fn else "apply"
                print(f"  {name} {kind} bf16: {line.split(':', 1)[-1].strip()}")
        lib = ctypes.CDLL(os.path.join(out_dir, f"{name}.so"))
        for entry in ("gn_elu_device", "gn_rows_occupancy", "gn_rows_sums", "gn_rows_apply",
                      "gn_rows_unroll"):
            getattr(lib, entry).argtypes = getattr(shipped, entry).argtypes
            getattr(lib, entry).restype = ctypes.c_int
        want = VARIANTS[name][0] if name in VARIANTS else None
        if want is not None and lib.gn_rows_unroll() != want:
            raise RuntimeError(f"{name}: built with another unroll")
        libs[name] = (lib, lib.gn_rows_unroll())
    return libs


def use(gnk, lib, unroll):
    """Route the wrapper's split form through ``lib``."""
    gnk.load = lambda: lib
    gnk.ROWS_UNROLL = unroll
    gnk._rows_resident.cache_clear()


def main():
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--tree", default=None, help="another checkout to time beside the builds")
    p.add_argument("--time-tree", action="store_true", help=argparse.SUPPRESS)
    p.add_argument("sources", nargs="*", metavar="NAME=PATH",
                   help="another state of group_norm_elu.cu to build and time")
    args = p.parse_args()
    if args.time_tree:
        sys.path.insert(0, os.getcwd())
        return time_tree()
    sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        print("split_gn_variants_torch: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from gdn_tpu_torch.kernels import groupnorm as gnk
    from gdn_tpu_torch.parallel.mesh import Axis

    tree = [run_tree(os.path.abspath(args.tree))] if args.tree else []
    out_dir = os.path.join(ROOT, "gdn_tpu_torch", "_build", "variants")  # gitignored
    os.makedirs(out_dir, exist_ok=True)
    libs = build(out_dir, dict(a.split("=", 1) for a in args.sources))
    alone = Axis(None, 1, 0)
    load = gnk.load
    order = ["shipped", *[n for n in libs if n != "shipped"], "shipped"]
    totals = {name: 0.0 for name in libs}
    for c, h, w, g, n in sites():
        x, scale, bias = inputs(c, h, w)
        want, _ = gnk._rows_plain(x, scale, bias, g, 1e-6, alone, h)
        line = []
        for name in order:
            lib, unroll = libs[name]
            use(gnk, lib, unroll)
            out, stats = gnk._launch_rows(x, scale, bias, g, 1e-6, alone, h)
            again, stats2 = gnk._launch_rows(x, scale, bias, g, 1e-6, alone, h)
            torch.cuda.synchronize()
            cs.check_close(out, want, x.dtype, f"{name} {c}x{h}x{w}")
            if not (torch.equal(out, again) and torch.equal(stats, stats2)):
                raise AssertionError(f"{name} {c}x{h}x{w}: two calls differ")
            plan = gnk.rows_plan_for(x, g)
            us = cs.device_ms([lambda: gnk._launch_rows(x, scale, bias, g, 1e-6, alone, h)],
                              what=f"{name} {c}x{h}x{w}") * 1e3
            line.append(f"{name} {us:.2f} (grid {plan.grid}, rows {plan.rows})")
            totals[name] += us * n / 1e3 / order.count(name)  # shipped: the mean of two
        print(f"B={BATCH} C={c} {h}x{w} x{n}: " + "; ".join(line) + " (device us)", flush=True)
    gnk.load = load
    tree += [run_tree(os.path.abspath(args.tree))] if args.tree else []
    print("21 sites, device ms: " + " ".join(f"{k} {v:.4f}" for k, v in totals.items()))
    for i, t in enumerate(tree):
        print(f"tree {args.tree} ({'before' if i == 0 else 'after'} the builds): "
              f"{sum(r['ms'] * r['sites'] for r in t):.4f} ms over 21 sites; "
              + "; ".join(f"{r['C']}x{r['h']}x{r['W']} {r['ms'] * 1e3:.2f}" for r in t))
    if cs.EVENT_TIMED:
        print(f"timed with CUDA events: {cs.EVENT_TIMED}")
    print(cs.smi_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
