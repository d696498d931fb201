#!/usr/bin/env python3
"""The row kernel on the card: its clock64 phase profile and its time at
each cluster size, on more shapes than chip_smoke's row_profile phase.

    python3 scripts/row_profile.py [--long 3000]

Builds csrc/row_scan.cu and its profile library (`_build.PROFILES`'
row_scan_profile, the same source with -DPHASE_PROFILE), then prints one
JSON line per reading, each with the card's name and power limit. The
readings are chip_smoke's own (`row_profiles`, `row_cluster_sweep`):

- `row_profile`: the profile on one prot2dna pair of 64 aa x 192 nt
  (chip_smoke's single_pair_2d shape) in each semiring at the plan's
  cluster and on one block, the profiled result checked equal to the path
  library's: a warp's SM cycles a diagonal in each phase and a cell's;
- `row_launches`: the device kernels and copies that torch.profiler's
  CUDA activity shows in one `log_forward` call on that pair (its tables
  already built), in this fresh process;
- `row_clusters`: the kernel alone (CUDA events, median of 5; of 3 on the
  long pairs) at every cluster size 1, 2, 4, 8 and 16 (non-portable),
  each result bit-equal to the plan's, on that pair, on 64 such pairs in
  one launch, on bench.py's 512-state machine at 64 x 64 and on the
  64-state ACGT machine at --long x --long; with the tables' build ms;
- `row_clusters` of `shared_ring_edge`: that machine at the longest pair
  whose ring the plan keeps in shared memory (its cluster of 16 blocks,
  whose last block waits the longest for its left neighbour's first
  cell), against 8 blocks with the ring in global memory, bit-equal.

Needs a CUDA card (~2 min at --long 3000).
"""

import argparse
import json
import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--long", type=int, default=3000)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("row_profile: CUDA is not available", file=sys.stderr)
        return 1
    from chip_smoke import row_cluster_sweep, row_profiles
    from machineboss_tpu_torch.core.presets import make_preset
    from machineboss_tpu_torch.dispatch import CompiledMachine
    from machineboss_tpu_torch.ops.kernels import _build
    from machineboss_tpu_torch.ops.kernels import row_kernel as rk
    from machineboss_tpu_torch.ops.semiring import LOGSUMEXP, MAXPLUS
    from machineboss_tpu_torch.testmachines import (align_pair,
                                                    build_random_transducer,
                                                    prot2dna_pairs)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    build_s = _build.build_all(["row_scan", "row_scan_profile"])
    dev = torch.device("cuda")

    def emit(obj):
        print(json.dumps(dict(obj, nvidia_smi=smi)), flush=True)

    def on_card(cm, sr_name):
        return [torch.from_numpy(np.ascontiguousarray(m, np.float32)).to(dev)
                for m in cm.lowered.matrices_2d(sr_name)]

    p2d = CompiledMachine(make_preset("prot2dna"), device=dev)
    pairs = prot2dna_pairs(64, 64, seed=0)
    x = torch.tensor(p2d.in_toks(pairs[0][0]), device=dev)
    y = torch.tensor(p2d.out_toks(pairs[0][1]), device=dev)
    lens = (x.shape[0], y.shape[0])
    for sr in (LOGSUMEXP, MAXPLUS):
        _, plan, profile = row_profiles(on_card(p2d, sr.name), x, y, sr,
                                        lens)
        emit({"phase": "row_profile", "semiring": sr.name, "Li": lens[0],
              "Lo": lens[1], "plan": plan, "profile": profile,
              "build_s": build_s})

    from torch.profiler import ProfilerActivity, profile
    p2d.log_forward(*pairs[0])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        p2d.log_forward(*pairs[0])
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    copies = [n for n in names if "memcpy" in n.lower()
              or "memset" in n.lower()]
    emit({"phase": "row_launches", "call": "log_forward",
          "kernels": len(names) - len(copies), "copies": len(copies),
          "row_scan": sum("row_scan" in n for n in names)})

    def sweep(name, *a, **kw):
        emit(dict(row_cluster_sweep(*a, **kw), phase="row_clusters",
                  case=name))

    mats = on_card(p2d, "logsumexp")
    sweep("prot2dna", mats, x, y, *lens)
    bi = torch.stack([torch.tensor(p2d.in_toks(p), device=dev)
                      for p, _ in pairs])
    bo = torch.stack([torch.tensor(p2d.out_toks(d), device=dev)
                      for _, d in pairs])
    n = torch.full((64,), 64, device=dev)
    sweep("prot2dna_64_pairs", mats, bi, bo, n, 3 * n)
    wide = CompiledMachine(build_random_transducer(511, list("ACGT")),
                           device=dev)
    rng = np.random.RandomState(5)
    wx = torch.tensor(rng.randint(0, 4, 64), device=dev)
    wy = torch.tensor(rng.randint(0, 4, 64), device=dev)
    sweep("states_512", on_card(wide, "logsumexp"), wx, wy, 64, 64)
    dense = CompiledMachine(build_random_transducer(64, list("ACGT")),
                            device=dev)
    dmats = on_card(dense, "logsumexp")
    S = dmats[3].shape[0]
    edge = max(L for L in range(1, 8192)
               if rk.row_launch_plan(S, L, L, 1)["rows"] == "shared")
    for name, L, clusters in (("long_pair", args.long, (1, 2, 4, 8, 16)),
                              ("shared_ring_edge", edge, (16, 8))):
        sp = align_pair(L, seed=12)
        lx = torch.tensor(dense.in_toks("".join(sp.input.seq)), device=dev)
        ly = torch.tensor(dense.out_toks("".join(sp.output.seq)), device=dev)
        sweep(name, dmats, lx, ly, L, L, reps=3, clusters=clusters)
    return 0


if __name__ == "__main__":
    sys.exit(main())
