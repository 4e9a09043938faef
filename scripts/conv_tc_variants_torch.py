#!/usr/bin/env python3
"""Design check of the tensor-core fused conv (``conv3x3_stats_tc``) on the
card: the shipped build against variants of its source, in one process.

    python3 scripts/conv_tc_variants_torch.py

Needs one CUDA card (an H100) and nvcc.  It builds
``gdn_tpu_torch/csrc/conv_gn_elu.cu`` once with ``-Xptxas -v`` (the
registers and spill bytes of every instantiation of the tensor-core
kernels, ``conv3x3_stats_tc`` and ``conv3x3_stats_tc_up``, are printed;
any spill fails the run) and three variants of it, each one nvcc, all
started together:

  cg     every A-tile copy through L2 only (``cp.async.cg``), where the
         shipped kernel sends the BN = 16 tile's through L1 (``.ca``);
  ca     every A-tile copy through L1;
  co75   the shipped kernel with the BN = 16 tile's shared-memory
         carveout preferred at 75%.

Then, at the five FusionBlock sites of a KITTI net, B=8 and B=32 in bf16
(``fused_fusion_bt``'s launch: a, yn and inv at B=32, a alone at B=8),
it times the shipped build and each variant in turns (shipped first and
last), in device µs from ``torch.profiler``, and at the 128×416 site
every (BM, BN) tile the tile rule could take.  Each launch is first held
against the plain version (bf16 0.05 + 0.05·|ref|).  Prints one line a
site and the card's name and power limit; exits nonzero on a failure.
"""

import ctypes
import os
import re
import subprocess
import sys
import types

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

SITES = [(256, 256, 256, 8, 26), (128, 128, 128, 16, 52), (64, 64, 64, 32, 104),
         (32, 32, 32, 64, 208), (16, 32, 16, 128, 416)]  # (Cx, Cl, Cout, H, W)
SHIPPED = "cp_async16<BN == 16>("
CO75_AT = "  return launch_dyn(conv3x3_stats_tc<"  # launch_tc's launch
VARIANTS = {
    "cg": lambda s: s.replace(SHIPPED, "cp_async16<false>("),
    "ca": lambda s: s.replace(SHIPPED, "cp_async16<true>("),
    "co75": lambda s: s.replace(CO75_AT, (
        "  if (BN == 16)\n"
        "    cudaFuncSetAttribute(conv3x3_stats_tc<T, BM, BN, BK, ASYNC, S>,\n"
        "                         cudaFuncAttributePreferredSharedMemoryCarveout, 75);\n"
        + CO75_AT), 1),
}


def build(out_dir):
    """The shipped library (loaded as the port loads it) and the variants'
    (loaded by path), ptxas's report of the shipped source checked."""
    from gdn_tpu_torch.kernels import build as kb, conv_gn_elu as ck

    src = os.path.join(kb.CSRC, "conv_gn_elu.cu")
    with open(src) as f:
        text = f.read()
    procs = {"ptxas": subprocess.Popen(
        [kb._nvcc(), *kb.NVCC_FLAGS, "-Xptxas", "-v", "-o",
         os.path.join(out_dir, "ptxas.so"), src],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)}
    for name, edit in VARIANTS.items():
        variant = edit(text)
        if variant == text:
            raise RuntimeError(f"variant {name} changed nothing in {src}")
        path = os.path.join(out_dir, f"{name}.cu")
        with open(path, "w") as f:
            f.write(variant)
        procs[name] = subprocess.Popen(
            [kb._nvcc(), *kb.NVCC_FLAGS, "-o", os.path.join(out_dir, f"{name}.so"), path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {"shipped": ck.load()}
    logs = {name: p.communicate()[0] for name, p in procs.items()}
    for name, p in procs.items():
        if p.returncode != 0:
            raise RuntimeError(f"nvcc ({name}) failed:\n{logs[name]}")
    fn, spilling, count = None, 0, 0
    for line in logs["ptxas"].splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            fn = m.group(1)
        if not fn or "conv3x3_stats_tc" not in fn:
            continue
        if "Used" in line:
            print(f"  {fn[-58:]}: {line.split(':', 1)[1].strip()}")
        if "spill stores" in line:
            count += 1
            spilling += " 0 bytes spill stores" not in line
    print(f"  ptxas: {count} instantiations of conv3x3_stats_tc{{,_up}}, {spilling} spilling")
    if spilling:
        raise AssertionError("a tensor-core kernel spills registers")
    tc = libs["shipped"].conv_gn_elu_forward_tc
    for name in VARIANTS:
        lib = ctypes.CDLL(os.path.join(out_dir, f"{name}.so"))
        lib.conv_gn_elu_forward_tc.argtypes = tc.argtypes
        lib.conv_gn_elu_forward_tc.restype = tc.restype
        libs[name] = lib
    return libs


def main():
    import torch

    if not torch.cuda.is_available():
        print("conv_tc_variants_torch: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from gdn_tpu_torch.kernels import conv_gn_elu as ck
    from gdn_tpu_torch.ops.groupnorm import pick_groups

    torch.backends.cudnn.allow_tf32 = False
    out_dir = os.path.join(ROOT, "gdn_tpu_torch", "_build", "variants")  # gitignored
    os.makedirs(out_dir, exist_ok=True)
    libs = build(out_dir)
    shipped_load = ck.load
    counter = types.SimpleNamespace(launches=0)
    gen = torch.Generator(device="cuda").manual_seed(0)

    def device_us(fn, n=10):
        fn()
        torch.cuda.synchronize()
        _, kernels, _ = cs.profiled(lambda: [fn() for _ in range(n)], min_calls=n)
        return sum(us for us, _ in kernels.values()) / n

    def timed(lib_name, run):
        ck.load = lambda: libs[lib_name]
        try:
            return device_us(run)
        finally:
            ck.load = shipped_load

    for b in (8, 32):
        for cx, cl, cout, h, w in SITES:
            x, lat = [torch.randn((b, c, h, w), device="cuda", generator=gen)
                      .to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
                      for c in (cx, cl)]
            k = torch.randn((cout, cx + cl, 3, 3), device="cuda", generator=gen) * (
                2.0 / (9 * (cx + cl))) ** 0.5
            wx, wl = k[:, :cx], k[:, cx:]
            scale = torch.rand(cout, device="cuda", generator=gen) + 0.5
            bias = torch.randn(cout, device="cuda", generator=gen) * 0.1
            g = pick_groups(cout, 8)
            res = b == 32

            def run():
                return ck._launch(counter, x, lat, wx, wl, scale, bias, g, 1e-6, 1,
                                  "bfloat16", torch.bfloat16, res, route="tc")

            want = ck.conv_gn_elu_plain(x, wx, scale, bias, g, 1e-6, 1, "bfloat16",
                                        torch.bfloat16, lat, wl)
            for name in libs:
                ck.load = lambda name=name: libs[name]
                got = run()
                ck.load = shipped_load
                torch.cuda.synchronize()
                for part, gp, wp in zip(("a", "yn", "inv"), got, want):
                    if gp is not None:
                        tol = (1e-4, 1e-5) if part == "inv" else (0.05, 0.05)
                        cs.check_tol(gp, wp, *tol, f"{name} {(b, cx, cl, cout, h, w)} {part}")
            order = ["shipped", *VARIANTS, "shipped"]
            times = [(name, timed(name, run)) for name in order]
            kc = ck.pad8(cx) + ck.pad8(cl)
            line = (f"B={b} ({cx}+{cl})->{cout} {h}x{w} tile {ck.tc_tile(b, h * w, kc, cout)}: "
                    + " ".join(f"{name} {us:.1f}" for name, us in times))
            if cout <= 16:
                tiles = [t for t in ck.TC_TILES if t[1] <= 32 and (kc % 64 or t[0] == 64)]
                main_tile = ck.tc_tile
                for tile in tiles:
                    ck.tc_tile = lambda *a, tile=tile, **kw: tile
                    try:
                        line += f"; tile {tile} {device_us(run):.1f}"
                    finally:
                        ck.tc_tile = main_tile
            print(line + " (device us)", flush=True)
    print(cs.smi_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
