#!/usr/bin/env python3
"""The sparse walk's kernel on the card: its time at every cluster size,
its clock64 phase profile, and its time beside another checkout's, on
more shapes than chip_smoke's sparse phases.

    python3 scripts/sparse_sweep.py [--repo DIR] [--sass FILE]

Builds csrc/sparse_walk.cu and its profile library (`_build.PROFILES`'
sparse_walk_profile, the same source with -DPHASE_PROFILE), then prints
one JSON line per reading, each with the card's name and power limit. The
cases are chip_smoke's sparse shapes: the seeded 128-node Plan7 generator
(644 states) on a read of 128 and the 512-node one (2,564 states) on a
read of 512, both as forward_1d_sparse's walk; prot2dna forced sparse
(132 states) on one and four pairs of 64 x 192 as forward_2d_sparse's
walk, and one pair's Backward and Viterbi. The readings:

- `sparse_clusters`: chip_smoke's `sparse_cluster_sweep`, the kernel alone
  (CUDA events, median of 5) at the plan's layout and at every cluster
  size 1, 2, 4, 8 and 16, each result bit-equal to the plan's;
- `sparse_profile`: chip_smoke's `sparse_profiles`, a warp's SM cycles a
  diagonal in each phase at the plan's cluster and on one block;
- `sparse_vs_repo` (with `--repo DIR`): the port's package of another
  checkout (an older commit unpacked with `git archive`) loaded beside
  this one under another name, and both kernels timed on the same inputs
  in this process, in turns (other, this, this, other; CUDA events,
  median of 5 each), their scores within 1e-3 nats in logsumexp and equal
  in max-plus.

`--sass FILE` writes `cuobjdump -sass` of the path library to FILE.
Needs a CUDA card (~2 min).
"""

import argparse
import importlib
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

PKG = "machineboss_tpu_torch"
TOL = {False: 1e-3, True: 0.0}     # nats: logsumexp, max-plus


def load_package(root, alias):
    """The port's package of checkout `root`, imported as `alias` (its
    modules import each other relatively, so both trees live side by
    side)."""
    pkg = os.path.join(os.path.abspath(root), PKG)
    spec = importlib.util.spec_from_file_location(
        alias, os.path.join(pkg, "__init__.py"),
        submodule_search_locations=[pkg])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[alias] = mod
    spec.loader.exec_module(mod)
    return alias


def cases(pkg, dev, K=(128, 512)):
    """(name, SparseMachine, 1-based token pairs, viterbi, reverse) of
    every case, built by package `pkg`."""
    def mod(name):
        return importlib.import_module(pkg + "." + name)
    CompiledMachine = mod("dispatch").CompiledMachine
    tm = mod("testmachines")
    out = []
    for k in K:
        hmm = mod("core.hmmer").HmmerModel()
        hmm.read(tm.random_plan7_hmm_text(k, tm.AMINO, 0))
        cm = CompiledMachine(hmm.machine(False), device=dev)
        read = tm.plan7_reads(tm.AMINO, 1, k, seed=0)[0]
        out.append(("plan7_%d_read_%d" % (k, k), cm._sparse_machine(),
                    [([], [t + 1 for t in cm.out_toks(read)])], False,
                    False))
    p2d = CompiledMachine(mod("core.presets").make_preset("prot2dna"),
                          device=dev, dense_max_states=16)
    psm = p2d._sparse_machine()
    ptoks = [([t + 1 for t in p2d.in_toks(p)],
              [t + 1 for t in p2d.out_toks(d)])
             for p, d in tm.prot2dna_pairs(4, 64, seed=0)]
    out += [("prot2dna_1_pair", psm, ptoks[:1], False, False),
            ("prot2dna_4_pairs", psm, ptoks, False, False),
            ("prot2dna_backward", psm, ptoks[:1], False, True),
            ("prot2dna_viterbi", psm, ptoks[:1], True, True)]
    return out


def timed(pkg, sm, toks, viterbi, reverse):
    """(scores, a function that returns one launch's CUDA-event ms) of
    package `pkg`'s kernel on `toks`."""
    from chip_smoke import event_ms
    sk = importlib.import_module(pkg + ".ops.kernels.sparse_kernel")
    it, il = sk.pad_tokens([t[0] for t in toks])
    ot, ol = sk.pad_tokens([t[1] for t in toks])
    call = sk.WalkCall(sm, it, ot, il, ol, viterbi, reverse)
    got = call.launch().cpu().numpy()
    return got, lambda: float(np.median([event_ms(call.launch)[0]
                                         for _ in range(5)]))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--repo", help="another checkout, timed beside this")
    ap.add_argument("--sass", help="write the path library's SASS here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("sparse_sweep: CUDA is not available", file=sys.stderr)
        return 1
    from chip_smoke import check, sparse_cluster_sweep, sparse_profiles
    from machineboss_tpu_torch.ops.kernels import _build
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    build_s = _build.build_all(["sparse_walk", "sparse_walk_profile"])
    dev = torch.device("cuda")
    if args.sass:
        lib = _build._lib_path("sparse_walk")[1]
        tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
        with open(args.sass, "w") as f:
            subprocess.run([tool, "-sass", lib], stdout=f, check=True,
                           timeout=300)

    def line(kind, name, rec):
        print(json.dumps(dict(rec, reading=kind, case=name, build_s=build_s,
                              nvidia_smi=smi)), flush=True)

    mine = cases(PKG, dev)
    for name, sm, toks, viterbi, reverse in mine:
        line("sparse_clusters", name,
             sparse_cluster_sweep(sm, toks, viterbi, reverse))
        line("sparse_profile", name,
             sparse_profiles(sm, toks, viterbi, reverse))
    if args.repo:
        other = load_package(args.repo, "other_port")
        for (name, sm, toks, viterbi, reverse), (_, osm, _, _, _) in zip(
                mine, cases(other, dev)):
            want, new_ms = timed(PKG, sm, toks, viterbi, reverse)
            got, old_ms = timed(other, osm, toks, viterbi, reverse)
            err = float(np.max(np.abs(got - want)))
            check(err <= TOL[viterbi], "%s: the two kernels differ by %.3g "
                  "nats" % (name, err))
            turns = [old_ms(), new_ms(), new_ms(), old_ms()]
            line("sparse_vs_repo", name, {
                "repo": os.path.abspath(args.repo), "max_abs_diff": err,
                "other_ms": [turns[0], turns[3]],
                "this_ms": [turns[1], turns[2]]})
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
