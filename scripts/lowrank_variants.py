#!/usr/bin/env python3
"""Time design variants of the lowrank wavefront kernel on one CUDA card.

    python3 scripts/lowrank_variants.py

Builds csrc/lowrank_wavefront.cu as it is and in variants that each undo
one design choice, then times every variant on the prot2dna main path's
batch (B=512 proteins of 64 against their 192-base codon DNA, seed 0),
with one and with two pair walkers per block, and holds each to the plain
PyTorch version (max |kernel - plain| in nats):

  kernel      the source as it is;
  cvt_split   the TF32 split by cvt.rna.tf32.f32 for hi and for lo, in
              place of the integer add-and-mask (hi) and the plain
              difference (lo);
  one_pass    one TF32 product (hi x hi) in place of the 3xTF32 split;
  threads256  256 threads a block in place of 512.

Each line of output is one JSON object; the card's name and power limit
come first. Exits 1 without CUDA. The variants are built under the
package's build/ directory.
"""

import ctypes
import json
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)

SPLIT = """  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));"""
CVT = """  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(hi) : "f"(x));
  const float r = x - __uint_as_float(hi);
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(lo) : "f"(r));"""
SMALL = ["            if (j < nn) mma_tf32(ts[j], ah, bl[j][0], bl[j][1]);",
         "            if (j < nn) mma_tf32(ts[j], al, bh[j][0], bh[j][1]);"]
THREADS = "constexpr int THREADS = 512;"


def variants(src):
    for s in [SPLIT, THREADS] + SMALL:
        if s not in src:
            raise RuntimeError("the source no longer holds %r" % s)
    one = src
    for s in SMALL:
        one = one.replace(s, "            (void)nn;")
    return {"kernel": src, "cvt_split": src.replace(SPLIT, CVT),
            "one_pass": one,
            "threads256": src.replace(THREADS,
                                      "constexpr int THREADS = 256;")}


def build(srcs, out_dir):
    from machineboss_tpu_torch.ops.kernels import _build
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name, text in srcs.items():
        cu = os.path.join(out_dir, name + ".cu")
        with open(cu, "w") as f:
            f.write(text)
        lib = os.path.join(out_dir, "lib%s.so" % name)
        procs[name] = (lib, subprocess.Popen(
            [_build._nvcc()] + _build.NVCC_FLAGS + ["-o", lib, cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError("%s: nvcc exit %d\n%s"
                               % (name, proc.returncode, log))
        print(json.dumps({"variant": name, "ptxas": [
            ln.strip() for ln in log.splitlines()
            if "registers" in ln or "spill" in ln]}), flush=True)
        libs[name] = ctypes.CDLL(lib)
    return libs


def event_ms(fn, reps=5):
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def main():
    if not torch.cuda.is_available():
        print("lowrank_variants: CUDA is not available", file=sys.stderr)
        return 1
    from machineboss_tpu_torch.core.presets import make_preset
    from machineboss_tpu_torch.dispatch import CompiledMachine
    from machineboss_tpu_torch.ops.kernels import _build
    from machineboss_tpu_torch.ops.kernels import lowrank_kernel as lk
    from machineboss_tpu_torch.testmachines import prot2dna_pairs

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(json.dumps({"nvidia_smi": smi,
                      "device": torch.cuda.get_device_name(0)}), flush=True)
    with open(os.path.join(_build.CSRC, "lowrank_wavefront.cu")) as f:
        libs = build(variants(f.read()),
                     os.path.join(_build.BUILD_DIR, "lowrank_variants"))

    dev = torch.device("cuda")
    cm = CompiledMachine(make_preset("prot2dna"), device=dev)
    toks = [(cm.in_toks(i), cm.out_toks(o))
            for i, o in prot2dna_pairs(512, 64, seed=0)]
    mats = cm._host_mats()
    plan, host = lk.prepare_lowrank(*mats)
    ops = lk.lowrank_operands(plan, host, mats[0].shape[1], dev)
    it = torch.tensor([t[0] for t in toks], dtype=torch.int32, device=dev)
    ot = torch.tensor([t[1] for t in toks], dtype=torch.int32, device=dev)
    il = torch.full((512,), 64, dtype=torch.int32, device=dev)
    ol = torch.full((512,), 192, dtype=torch.int32, device=dev)
    plain = lk.lowrank_forward_plain(ops, it, ot, il, ol).cpu().numpy()
    load = lk.load
    try:
        for rnd in range(2):                 # variants in turns, twice
            for name, lib in libs.items():
                lk.load = lambda _name, _lib=lib: _lib
                for walkers in (1, 2):
                    def run():
                        return lk.lowrank_wavefront(ops, it, ot, il, ol,
                                                    walkers=walkers)
                    err = float(np.abs(run().cpu().numpy() - plain).max())
                    print(json.dumps({
                        "round": rnd, "variant": name, "walkers": walkers,
                        "launch": lk.launch_config(ops, 512, 64, 192,
                                                   walkers=walkers),
                        "kernel_ms": event_ms(run),
                        "max_abs_vs_plain": err, "nvidia_smi": smi}),
                        flush=True)
    finally:
        lk.load = load
    return 0


if __name__ == "__main__":
    sys.exit(main())
