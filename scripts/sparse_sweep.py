#!/usr/bin/env python3
"""The sparse walk's kernel on the card at every cluster size, on more
shapes than chip_smoke's sparse phase.

    python3 scripts/sparse_sweep.py

Builds csrc/sparse_walk.cu, then prints one JSON line per case, each with
the card's name and power limit: chip_smoke's own reading
(`sparse_cluster_sweep`), the kernel alone (CUDA events, median of 5) at
the plan's layout and at every cluster size 1, 2, 4, 8 and 16, each
result bit-equal to the plan's, with the ring each size takes. The cases
are chip_smoke's sparse phase's shapes: the seeded 128-node Plan7
generator (644 states) on a read of 128, the 512-node one (2,564 states)
on a read of 512, both as forward_1d_sparse; prot2dna forced sparse (132
states) on one and four pairs of 64 x 192 as forward_2d_sparse's walk,
and one pair's Backward and Viterbi.

Needs a CUDA card (~1 min).
"""

import json
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main():
    if not torch.cuda.is_available():
        print("sparse_sweep: CUDA is not available", file=sys.stderr)
        return 1
    from chip_smoke import plan7_generator, sparse_cluster_sweep
    from machineboss_tpu_torch.core.presets import make_preset
    from machineboss_tpu_torch.dispatch import CompiledMachine
    from machineboss_tpu_torch.ops.kernels import _build
    from machineboss_tpu_torch.testmachines import (AMINO, plan7_reads,
                                                    prot2dna_pairs)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    build_s = _build.build_all(["sparse_walk"])
    dev = torch.device("cuda")

    cases = []
    for K, L in ((128, 128), (512, 512)):
        cm = CompiledMachine(plan7_generator(K), device=dev)
        read = plan7_reads(AMINO, 1, L, seed=0)[0]
        toks = [([], [t + 1 for t in cm.out_toks(read)])]
        cases.append(("plan7_%d_read_%d" % (K, L), cm._sparse_machine(),
                      toks, False, False))
    p2d = CompiledMachine(make_preset("prot2dna"), device=dev,
                          dense_max_states=16)
    psm = p2d._sparse_machine()
    ptoks = [([t + 1 for t in p2d.in_toks(p)], [t + 1 for t in
                                                 p2d.out_toks(d)])
             for p, d in prot2dna_pairs(4, 64, seed=0)]
    cases += [("prot2dna_1_pair", psm, ptoks[:1], False, False),
              ("prot2dna_4_pairs", psm, ptoks, False, False),
              ("prot2dna_backward", psm, ptoks[:1], False, True),
              ("prot2dna_viterbi", psm, ptoks[:1], True, True)]
    for name, sm, toks, viterbi, reverse in cases:
        rec = sparse_cluster_sweep(sm, toks, viterbi, reverse)
        print(json.dumps(dict(rec, case=name, build_s=build_s,
                              nvidia_smi=smi)), flush=True)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
