#!/usr/bin/env python3
"""Compare, on one CUDA card, the kernels whose layouts follow the sizes
(lowrank, the batched and banded Viterbi fills, factored, fused Plan7's
node-doubling layout) of two trees at chip_smoke's shapes.

    git archive <commit> machineboss_tpu_torch | tar -x -C <dir>
    python3 scripts/compare_sized_kernels.py <dir>

Runs the tree at <dir> ("parent") and this checkout ("change") in turns,
parent, change, change, parent, each turn a process of its own that builds
its tree's kernels and times, by CUDA events, the mean ms of 10 calls of:

- lowrank_wavefront and lowrank_chained_wavefront (chain 8) at chip_smoke's
  main path: prot2dna, B=512 proteins of 64 and their 192-base DNA (seed
  0), padded as log_forward_batch pads (88 x 200);
- viterbi_wavefront at viterbi_dense (the 64-state ACGT transducer, B=64
  pairs of 128 x 128, seed 3) and align_prot2dna (B=64 prot2dna pairs of
  64 x 192, seed 0);
- viterbi_banded_wavefront on one pair of 1,500 x 1,500 of the 64-state
  machine in a band of 17 cells about the diagonal;
- factored_wavefront at prot2dna_factored (the main path's pairs at
  64 x 192);
- fused_plan7 in the node-doubling layout at 600 nodes (a seeded
  amino-acid profile, the 2-state noise transducer, multihit, 256 reads of
  90).

Each turn prints one JSON line of ms; the last line gives, per kernel, the
largest difference of the two trees' outputs (0.0: equal bit for bit), the
two trees' medians and the card's name and power limit. Exits 1 without
CUDA.
"""

import json
import os
import subprocess
import sys
import tempfile

HERE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
REPS = 10


def side(root, out):
    """One turn: the tree at `root`, outputs saved to `out` (.npz)."""
    sys.path.insert(0, os.path.abspath(root))
    import numpy as np
    import torch
    import machineboss_tpu_torch
    from machineboss_tpu_torch.core.eval import EvaluatedMachine
    from machineboss_tpu_torch.core.hmmer import HmmerModel
    from machineboss_tpu_torch.core.machine import Machine
    from machineboss_tpu_torch.core.presets import make_preset
    from machineboss_tpu_torch.ops.fused_plan7 import Plan7Fused
    from machineboss_tpu_torch.ops.fwdback import pad_bucket
    from machineboss_tpu_torch.ops.kernels import fused_plan7_kernel as fk
    from machineboss_tpu_torch.ops.kernels import lowrank_kernel as lk
    from machineboss_tpu_torch.ops.kernels import viterbi_kernel as vk
    from machineboss_tpu_torch.ops.kernels import wavefront_kernel as wk
    from machineboss_tpu_torch.ops.lowering import LoweredMachine
    from machineboss_tpu_torch.testmachines import (
        AMINO, build_random_transducer, noise_transducer_json, plan7_reads,
        prot2dna_pairs, random_plan7_hmm_text)
    pkg = os.path.dirname(os.path.abspath(machineboss_tpu_torch.__file__))
    if not pkg.startswith(os.path.abspath(root)):
        raise RuntimeError("imported %s, not the tree at %s" % (pkg, root))
    dev = torch.device("cuda")

    def ms(fn):
        out = fn()
        torch.cuda.synchronize()
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(REPS):
            fn()
        t1.record()
        torch.cuda.synchronize()
        return t0.elapsed_time(t1) / REPS, out

    def lowered(machine, semiring=None):
        ev = EvaluatedMachine(machine, machine.get_param_defs(True))
        low = LoweredMachine(ev, dtype=np.float32)
        return ev, tuple(np.asarray(x) for x in (
            low.matrices_2d(semiring) if semiring else low.matrices_2d()))

    def padded(rows, L):
        a = np.zeros((len(rows), L), np.int32)
        for n, r in enumerate(rows):
            a[n, :len(r)] = r
        return a

    times, outs = {}, {}
    p2d = make_preset("prot2dna")
    ev, mats = lowered(p2d)
    pairs = prot2dna_pairs(512, 64, seed=0)
    it = [[ev.input_tokenizer.sym2tok[c] - 1 for c in p] for p, _ in pairs]
    ot = [[ev.output_tokenizer.sym2tok[c] - 1 for c in d] for _, d in pairs]
    Li, Lo = pad_bucket(64, base=16), pad_bucket(192, base=16)
    batch = [torch.from_numpy(x).to(dev) for x in (
        padded(it, Li), padded(ot, Lo), np.full(512, 64, np.int32),
        np.full(512, 192, np.int32))]
    plan, host = lk.prepare_lowrank(*mats)
    ops = lk.lowrank_operands(plan, host, mats[0].shape[1], dev)
    times["lowrank_wavefront"], o = ms(lambda: lk.lowrank_wavefront(
        ops, *batch))
    outs["lowrank_wavefront"] = o.double().cpu().numpy()
    plan, host = lk.prepare_lowrank(*mats, chained=True)
    cops = lk.lowrank_operands(plan, host, mats[0].shape[1], dev)
    exact = [torch.from_numpy(np.array(x, np.int32)).to(dev)
             for x in (it, ot)]
    times["lowrank_chained_wavefront"], o = ms(
        lambda: lk.lowrank_chained_wavefront(cops, *exact, n_chain=8))
    outs["lowrank_chained_wavefront"] = o.double().cpu().numpy()
    fops = wk.factored_operands(wk.prepare_factored(*mats), dev)
    times["factored_wavefront"], o = ms(lambda: wk.factored_wavefront(
        fops, *[torch.from_numpy(np.array(x, np.int32)).to(dev) for x in (
            it, ot, [64] * 512, [192] * 512)]))
    outs["factored_wavefront"] = o.double().cpu().numpy()

    # the batched fill at viterbi_dense and align_prot2dna
    dense = build_random_transducer(64, list("ACGT"))
    for name, machine, fill_pairs in (
            ("viterbi_wavefront_dense", dense, None),
            ("viterbi_wavefront_prot2dna", p2d, (it[:64], ot[:64]))):
        _, mm = lowered(machine, "maxplus")
        vops = vk.viterbi_operands(vk.maxplus_class_mats(*mm), dev)
        if fill_pairs is None:
            rng = np.random.RandomState(3)
            fill_pairs = (rng.randint(0, 4, (64, 128)),
                          rng.randint(0, 4, (64, 128)))
        toks = [torch.from_numpy(np.array(x, np.int32)).to(dev)
                for x in fill_pairs]
        times[name], o = ms(lambda: vk.viterbi_wavefront(vops, *toks))
        outs[name] = o.double().cpu().numpy()

    # the banded fill: one pair of 1,500 in a band of 17 cells
    _, mm = lowered(build_random_transducer(64, list("ACGT"), seed=3),
                    "maxplus")
    vops = vk.viterbi_operands(vk.maxplus_class_mats(*mm), dev)
    L = 1500
    d = np.arange(2 * L + 1)
    lo = np.clip(d // 2 - 8, np.maximum(0, d - L), np.minimum(L, d))
    hi = np.minimum(lo + 17, np.minimum(L + 1, d + 1))
    geom = vk.band_geometry(L, L, lo, hi, dev)
    rng = np.random.RandomState(11)
    bt = [torch.from_numpy(rng.randint(0, 4, L).astype(np.int32)).to(dev)
          for _ in range(2)]
    times["viterbi_banded_wavefront"], o = ms(
        lambda: vk.viterbi_banded_wavefront(vops, geom, *bt))
    outs["viterbi_banded_wavefront"] = o.double().cpu().numpy()

    # fused Plan7's node-doubling layout at 600 nodes
    hmm = HmmerModel()
    hmm.read(random_plan7_hmm_text(600, AMINO, seed=2))
    td = Machine.from_json(noise_transducer_json(AMINO))
    f = Plan7Fused(hmm, EvaluatedMachine(td, td.get_param_defs(True)),
                   mode="plan7", multihit=True, device=dev)
    p7 = fk.plan7_operands(fk.prepare_fused_plan7(f), dev)
    s2t = f.td_ev.output_tokenizer.sym2tok
    reads = plan7_reads(AMINO, 256, 90, seed=0)
    t = torch.tensor([[s2t[c] for c in r] for r in reads], dtype=torch.int32,
                     device=dev)
    n = torch.full((256,), 90, dtype=torch.int32, device=dev)
    times["fused_plan7_nodes600"], o = ms(
        lambda: fk.fused_plan7_forward_kernel(p7, t, n,
                                              layout="node_doubling"))
    outs["fused_plan7_nodes600"] = o.double().cpu().numpy()

    np.savez(out, **outs)
    print(json.dumps({"tree": root, "ms": times}), flush=True)
    return 0


def main(argv):
    if len(argv) == 4 and argv[1] == "--side":
        return side(argv[2], argv[3])
    if len(argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("compare_sized_kernels: CUDA is not available",
              file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(json.dumps({"nvidia_smi": smi}), flush=True)
    trees = {"parent": argv[1], "change": HERE}
    with tempfile.TemporaryDirectory() as tmp:
        saved, ms = {}, {}
        for n, which in enumerate(("parent", "change", "change", "parent")):
            out = os.path.join(tmp, "%s%d.npz" % (which, n))
            res = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--side",
                 trees[which], out], check=True, timeout=900,
                capture_output=True, text=True)
            print(res.stdout.strip(), flush=True)
            ms.setdefault(which, []).append(
                json.loads(res.stdout.strip().splitlines()[-1])["ms"])
            saved.setdefault(which, out)
        a, b = np.load(saved["parent"]), np.load(saved["change"])
        print(json.dumps({
            "max_abs_diff": {k: float(np.nanmax(np.abs(a[k] - b[k])))
                             for k in a.files},
            "nan_equal": {k: bool(np.array_equal(np.isnan(a[k]),
                                                 np.isnan(b[k])))
                          for k in a.files},
            "median_ms": {w: {k: float(np.median([r[k] for r in runs]))
                              for k in runs[0]} for w, runs in ms.items()},
            "nvidia_smi": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
