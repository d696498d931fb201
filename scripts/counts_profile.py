#!/usr/bin/env python3
"""expected_counts on the card: its time and its clock64 phase profile at
the E-step's shapes.

    python3 scripts/counts_profile.py [--repo DIR]

Builds csrc/expected_counts.cu and its profile library (`_build.PROFILES`'
expected_counts_profile, the same source with -DPHASE_PROFILE), makes
chip_smoke's em lattices (prot2dna, 128 pairs of 64 aa x 192 nt with
synonymous codons, seed 13: a Forward lattice by row_scan and the reversed
prefixes' Backward lattices), and prints one JSON line per reading, each
with the card's name and power limit:

- `counts_size`: at 128, 16 and 1 of those pairs, the kernel against the
  plain version on the card (chip_smoke's counts_close), timed by CUDA
  events around the wrapper (`ms`, mean of 10; 50 at one pair) and by
  torch.profiler's device time of the kernel alone (`kernel_ms`), beside
  its bound (chip_smoke's counts_bound);
- `counts_profile`: chip_smoke's counts_profile at each size: SM cycles
  a cell in each phase summed over the warps, the phases' shares and the
  busiest warp's cycles;
- `counts_512`: the same two timings on the 512-state machine (511 states
  and End), 8 pairs of 32 x 32.

`--repo DIR` takes the port's package from another checkout (an older
commit unpacked with `git archive`) and times its expected_counts on the
same inputs, the "before" of a change; the profile is read where that
package has one. Needs a CUDA card (~1 min).
"""

import argparse
import importlib.util
import json
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--repo", default=ROOT,
                    help="the checkout whose package is timed")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("counts_profile: CUDA is not available", file=sys.stderr)
        return 1
    # this checkout's chip_smoke helpers; the package from --repo
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    counts_bound, counts_close, counts_profile, cuda_ms, kernel_device_ms = (
        smoke.counts_bound, smoke.counts_close, smoke.counts_profile,
        smoke.cuda_ms, smoke.kernel_device_ms)
    sys.path.insert(0, os.path.abspath(args.repo))
    import numpy as np
    from machineboss_tpu_torch.core.eval import EvaluatedMachine
    from machineboss_tpu_torch.core.presets import make_preset
    from machineboss_tpu_torch.core.seqpair import NamedSeq, SeqPair
    from machineboss_tpu_torch.ops.fwdback import CountModel, tokenize_batch
    from machineboss_tpu_torch.ops.kernels import _build
    from machineboss_tpu_torch.ops.kernels import counts_kernel as ck
    from machineboss_tpu_torch.ops.kernels import row_kernel as rk
    from machineboss_tpu_torch.ops.semiring import LOGSUMEXP
    from machineboss_tpu_torch.testmachines import (build_random_transducer,
                                                    prot2dna_pairs)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    has_profile = hasattr(ck, "expected_counts_profile")
    build_s = _build.build_all(
        ["expected_counts", "row_scan"]
        + (["expected_counts_profile"] if has_profile else []))
    dev = torch.device("cuda")
    pkg = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(ck.__file__))))

    def emit(obj):
        print(json.dumps(dict(obj, repo=pkg, nvidia_smi=smi)), flush=True)

    def lattices(m, pairs):
        ev = EvaluatedMachine(m, m.get_param_defs(True))
        model = CountModel(ev, device=dev)
        mats = [x.detach() for x in model.build_tensors(model.logw)]
        toks = tokenize_batch(ev, [SeqPair(NamedSeq("i", list(a)),
                                           NamedSeq("o", list(b)))
                                   for a, b in pairs], device=dev)
        it, ot, il, ol = toks
        F = rk.row_scan(*mats, it, ot, LOGSUMEXP)
        Br = ck.backward_lattices(*mats, it, ot, il, ol)
        g = torch.ones(len(pairs), device=dev)
        tables, _ = ck.counts_tables_cached(*rk.nonempty(*mats[:3]),
                                            mats[3])
        return mats, toks, F, Br, g, tables

    def timed(name, args, mats, toks, F, tables, nb):
        it, ot, il, ol = toks
        got = ck.expected_counts(*args)
        diff, excess = counts_close(got, ck.expected_counts_plain(*args))
        reps = 10 if nb > 1 else 50
        emit({"phase": name, "pairs": nb, "build_s": build_s,
              "plan": ck.expected_counts.last["plan"],
              "max_abs_vs_plain": diff, "excess_over_tol": excess,
              "ms": cuda_ms(lambda: ck.expected_counts(*args), reps),
              "kernel_ms": kernel_device_ms(
                  lambda: ck.expected_counts(*args), reps,
                  "expected_counts_kernel"),
              "bound_ms": counts_bound(mats, it, ot, il, ol, tables,
                                       F.numel() * 4.0)[0]})

    pairs = prot2dna_pairs(128, 64, seed=13, synonymous=True)
    mats, toks, F, Br, g, tables = lattices(make_preset("prot2dna"), pairs)
    for nb in (128, 16, 1):
        sub = tuple(t[:nb] for t in toks)
        args = (F[:nb], Br[:nb], *mats, *sub, g[:nb])
        timed("counts_size", args, mats, sub, F[:nb], tables, nb)
        if has_profile:
            emit(dict(counts_profile(args), phase="counts_profile",
                      pairs=nb))
    rng = np.random.RandomState(8)
    seqs = ["".join("ACGT"[c] for c in rng.randint(0, 4, 32))
            for _ in range(16)]
    wide = lattices(build_random_transducer(511, list("ACGT")),
                    list(zip(seqs[:8], seqs[8:])))
    mats, toks, F, Br, g, tables = wide
    timed("counts_512", (F, Br, *mats, *toks, g), mats, toks, F, tables, 8)
    return 0


if __name__ == "__main__":
    sys.exit(main())
