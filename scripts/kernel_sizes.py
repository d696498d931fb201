#!/usr/bin/env python3
"""The largest sizes each CUDA kernel's launch plan takes, on the CPU.

    python3 scripts/kernel_sizes.py [--tree DIR]

The plans are host functions: this sweeps each kernel's length (or band,
or profile) by bisection until its plan raises ValueError, and prints one
JSON line a kernel with the largest size it takes ("unbounded" where no
shared-memory limit depends on it up to 2^22). Where a plan checks the
card's memory (`mem_bytes`), the sweep passes the H100's 80 GB, so a size
it refuses is past the card's memory, not past a block's 227 KiB.

--tree DIR sweeps the copy of the package at DIR instead (e.g. a
`git archive` of the parent commit unpacked there), so that the sizes
before and after a change come from the same script; a keyword that tree
does not know is left out.
"""

import argparse
import inspect
import json
import os
import sys

import numpy as np

CARD_BYTES = 80 * 10 ** 9
SMS = 132
TOP = 1 << 22


def largest(ok, lo=0, hi=TOP):
    """The largest n in [lo, hi] with ok(n) (ok monotone), "unbounded" if
    ok(hi), None if not ok(lo)."""
    if ok(hi):
        return "unbounded"
    if not ok(lo):
        return None
    while lo < hi - 1:
        mid = (lo + hi) // 2
        if ok(mid):
            lo = mid
        else:
            hi = mid
    return lo


def takes(fn, *args, **kw):
    """fn(*args, **kw) without ValueError; keywords fn lacks are dropped."""
    params = inspect.signature(fn).parameters
    kw = {k: v for k, v in kw.items() if k in params}
    try:
        fn(*args, **kw)
        return True
    except ValueError:
        return False


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", help="sweep the package at this directory")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.tree) if args.tree else
                    os.path.dirname(os.path.dirname(os.path.abspath(
                        __file__))))
    from types import SimpleNamespace

    import torch

    from machineboss_tpu_torch import testmachines
    from machineboss_tpu_torch.algo import traceback_device as tb
    from machineboss_tpu_torch.core.eval import EvaluatedMachine
    from machineboss_tpu_torch.core.presets import make_preset
    from machineboss_tpu_torch.ops.kernels import fused_plan7_kernel as fk
    from machineboss_tpu_torch.ops.kernels import lowrank_kernel as lk
    from machineboss_tpu_torch.ops.kernels import viterbi_kernel as vk
    from machineboss_tpu_torch.ops.kernels import wavefront_kernel as wk
    from machineboss_tpu_torch.ops.lowering import LoweredMachine
    cpu = torch.device("cpu")
    machines = {"prot2dna": make_preset("prot2dna"),
                "dense64": testmachines.build_random_transducer(
                    64, list("ACGT"))}

    def mats(kind, semiring=None):
        m = machines[kind]
        ev = EvaluatedMachine(m, m.get_param_defs(True))
        low = LoweredMachine(ev, dtype=np.float32)
        return tuple(np.asarray(x) for x in (
            low.matrices_2d(semiring) if semiring else low.matrices_2d()))

    def emit(kernel, **kw):
        print(json.dumps(dict({"kernel": kernel}, **kw)), flush=True)

    # lowrank (plain and chained mode: one kernel, one plan): the largest
    # padded DNA at a padded protein length; B = 4 pairs on a full grid
    for kind in ("prot2dna", "dense64"):
        plan, host = lk.prepare_lowrank(*mats(kind))
        _, et, _, n_mt, slab, KZ = lk.pack_lowrank(plan["classes"], host,
                                                   plan["Sa"])
        ops = SimpleNamespace(n_mt=n_mt, slab=slab, KZ=KZ,
                              SaP=-(-plan["Sa"] // 4) * 4,
                              et_floats=-(-et.size // 4) * 4)
        cfg_fn = getattr(lk, "global_bytes", None) and lk.launch_config
        out = {}
        for Li in ((64, 400, 1019, 2000) if kind == "prot2dna" else (64,)):
            if cfg_fn:
                ok = lambda Lo: takes(lk.launch_config, ops, 4, Li, Lo,
                                      grid=SMS, mem_bytes=CARD_BYTES)
            else:
                ok = lambda Lo: takes(lk.launch_plan, ops, Li, Lo)
            out[Li] = largest(ok)
        if cfg_fn:
            ok = lambda L: takes(lk.launch_config, ops, 4, L, 3 * L,
                                 grid=SMS, mem_bytes=CARD_BYTES)
        else:
            ok = lambda L: takes(lk.launch_plan, ops, L, 3 * L)
        emit("lowrank_wavefront", machine=kind, largest_Lo_at_Li=out,
             largest_Li_at_Lo_3Li=largest(ok))

    # the merged family's walk (merged, chained_ragged, chained): slots
    for SaP in (132, 68):
        emit("merged_family_walk", SaP=SaP, largest_Li=largest(
            lambda L: takes(wk.walk_launch_plan, SaP, L, 512)))

    # generic and seqscale: no length in their shared memory
    emit("generic_wavefront", largest_L="unbounded",
         note="shared bytes depend on the states only "
              "(generic_launch_plan(ops))")
    emit("seqscale_wavefront", largest_L="unbounded",
         note="static shared memory only")
    emit("scan1d", largest_L="unbounded",
         note="scan1d_launch_plan takes no length")

    # factored: the largest protein at Lo = 3 Li (prot2dna), Lo = Li (dense)
    for kind in ("prot2dna", "dense64"):
        plan = wk.prepare_factored(*mats(kind))
        _, ek, _, n_mt, _, NR, _ = wk.pack_factored(plan)
        ops = SimpleNamespace(
            Sa=plan["Sa"], NR=NR, n_mt=n_mt, e_floats=-(-ek.size // 4) * 4,
            nbp=2 if any(c[0] == "diag" for c in plan["classes"]) else 1)
        r = 3 if kind == "prot2dna" else 1
        if "mem_bytes" in inspect.signature(
                wk.factored_launch_config).parameters:
            ok = lambda L: takes(wk.factored_launch_config, ops, 8, L, r * L,
                                 grid=8, mem_bytes=CARD_BYTES)
        else:
            ok = lambda L: takes(wk.factored_launch_plan, ops, L, r * L)
        emit("factored_wavefront", machine=kind, Lo_over_Li=r,
             largest_Li=largest(ok))

    # the batched fill: Li at Lo = Li (dense) or 3 Li (prot2dna), B = 2
    for kind in ("dense64", "prot2dna"):
        ops = vk.viterbi_operands(vk.maxplus_class_mats(
            *mats(kind, "maxplus")), cpu)
        r = 3 if kind == "prot2dna" else 1
        emit("viterbi_wavefront", machine=kind, Lo_over_Li=r, B=2,
             largest_Li=largest(lambda L: takes(
                 vk.fill_launch_plan, ops, 2, L, r * L, SMS,
                 mem_bytes=CARD_BYTES)))

    # the banded fill: the widest band (cells a diagonal)
    for kind in ("dense64", "prot2dna"):
        ops = vk.viterbi_operands(vk.maxplus_class_mats(
            *mats(kind, "maxplus")), cpu)

        def band(Wb):
            g = SimpleNamespace(Wb=Wb, lo=np.zeros(4, np.int64),
                                hi=np.full(4, Wb, np.int64))
            return takes(vk.banded_launch_plan, ops, g, SMS)
        emit("viterbi_banded_wavefront", machine=kind,
             largest_band_cells=largest(band))

    # the lattice walk: a pair of L x L on the dense machine
    mm = mats("dense64", "maxplus")
    S, Ti, To = mm[3].shape[0], mm[1].shape[0], mm[2].shape[0]
    emit("lattice_walk", machine="dense64", largest_L=largest(
        lambda L: takes(tb.walk_launch_plan, S, Ti, To, 2 * L + 1, L, L, 64,
                        SMS)))

    # fused Plan7: the most profile nodes at St = 1, 2, 4 (20 symbols,
    # 256 reads)
    for St in (1, 2, 4):
        emit("fused_plan7", St=St, B=256, largest_K=largest(
            lambda K: takes(fk.launch_plan, K, St, 20, 256, SMS,
                            mem_bytes=CARD_BYTES), lo=1, hi=1 << 17))

    # the row engine: one pair of L x L, its score (the two rows leave
    # shared memory past largest_L_rows_shared) and its whole lattice
    try:
        from machineboss_tpu_torch.ops.kernels import row_kernel as rk
    except ImportError:                 # a tree from before the row kernel
        return
    for kind, S in (("prot2dna", mats("prot2dna")[3].shape[0]),
                    ("dense64", mm[3].shape[0]), ("states512", 512)):
        emit("row_scan", machine=kind, S=S, B=1,
             largest_L=largest(lambda L: takes(
                 rk.row_launch_plan, S, L, L, 1, mem_bytes=CARD_BYTES)),
             largest_L_rows_shared=largest(
                 lambda L: rk.row_launch_plan(S, L, L, 1)["rows"] ==
                 "shared"),
             largest_L_lattice=largest(lambda L: takes(
                 rk.row_launch_plan, S, L, L, 1, lattice=True,
                 mem_bytes=CARD_BYTES)))


if __name__ == "__main__":
    main()
