#!/usr/bin/env python3
"""Compare the full-rank wavefront kernels and the 1D scan of two trees on
one CUDA card.

    git archive <commit> machineboss_tpu_torch | tar -x -C <dir>
    python3 scripts/compare_trees.py <dir>

Runs the kernels of the tree at <dir> ("parent") and of this checkout
("change") in turns, parent, change, change, parent, each turn a process of
its own that builds its tree's kernels:

- merged, chained_ragged, chained (chains 2, 4 and 8), generic and
  seqscale on bench.py's dense machine (the random 64-state ACGT
  transducer), B=512 pairs of 200x200 (seed 0), and for chained_ragged the
  same pairs cut to lengths uniform in [100, 200];
- merged and chained_ragged on the same pairs and lengths through the
  all-class 64-state ACGT machine, whose every cell is live
  (merged_every_cell);
- scan1d at dense1d (the random 64-state generator, B=256 sequences of
  10,000) and at scan1d_every_entry (a seeded (4, 64, 64) transfer tensor
  with every entry finite, the same batch shape).

Each turn prints one JSON line with every kernel's mean ms over 5 calls
(CUDA events); the last line says, per 2D kernel, whether the two trees'
scores are equal bit for bit and their largest difference, and per scan
the largest difference of the log-likelihoods in nats and whether the
exponents and dead flags are equal. Each tree builds under its own
package's build/ directory. Exits 1 without CUDA.
"""

import json
import os
import subprocess
import sys
import tempfile

KERNELS = ("merged_wavefront", "chained_ragged_wavefront",
           "chained_wavefront", "chained_wavefront_c2",
           "chained_wavefront_c4", "generic_wavefront", "seqscale_wavefront",
           "merged_every_cell", "chained_ragged_every_cell")
SCANS = ("scan1d_dense1d", "scan1d_every_entry")
HERE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")


def side(root, out):
    """One turn: the tree at `root`, scores saved to `out` (.npz)."""
    sys.path.insert(0, os.path.abspath(root))
    import numpy as np
    import torch
    import machineboss_tpu_torch
    from machineboss_tpu_torch.core.eval import EvaluatedMachine
    from machineboss_tpu_torch.ops.kernels import wavefront_kernel as wk
    from machineboss_tpu_torch.ops.lowering import LoweredMachine
    from machineboss_tpu_torch.ops.kernels import scan1d_kernel as sk
    from machineboss_tpu_torch.testmachines import (
        build_allclass_transducer, build_generator_1d,
        build_random_transducer)
    pkg = os.path.dirname(os.path.abspath(machineboss_tpu_torch.__file__))
    if not pkg.startswith(os.path.abspath(root)):
        raise RuntimeError("imported %s, not the tree at %s" % (pkg, root))
    dev = torch.device("cuda")
    def lowered(m, one_d=False):
        lm = LoweredMachine(EvaluatedMachine(m, m.get_param_defs(True)),
                            dtype=np.float32)
        return tuple(np.asarray(x) for x in (
            lm.emit_matrices_1d(output_side=True) if one_d
            else lm.matrices_2d()))
    mats = lowered(build_random_transducer(64, list("ACGT")))
    B, L = 512, 200
    rng = np.random.RandomState(0)
    it = rng.randint(0, 4, (B, L)).astype(np.int32)
    ot = rng.randint(0, 4, (B, L)).astype(np.int32)
    cut = rng.randint(100, L + 1, B).astype(np.int32)
    full = np.full(B, L, np.int32)

    def tensors(*xs):
        return [torch.from_numpy(np.ascontiguousarray(x)).to(dev)
                for x in xs]
    uniform, ragged = tensors(it, ot, full, full), tensors(it, ot, cut, cut)
    merged = wk.merged_operands(wk.prepare_merged(*mats), dev)
    generic = wk.merged_operands(wk.prepare_generic(*mats), dev)
    seqscale = wk.merged_operands(wk.prepare_seqscale(*mats), dev)
    every = wk.merged_operands(wk.prepare_merged(*lowered(
        build_allclass_transducer(64, list("ACGT")))), dev)

    # the 1D scans: dense1d's machine and batch, and every entry finite
    rng1 = np.random.RandomState(42)
    gen = lowered(build_generator_1d(64, rng=rng1), one_d=True)
    toks1 = rng1.randint(0, 4, (256, 10000)).astype(np.int32)
    rng7 = np.random.RandomState(7)
    trans7 = rng7.uniform(-6.0, -2.0, (4, 64, 64)).astype(np.float32)
    with np.errstate(divide="ignore"):
        eye = np.log(np.eye(64, dtype=np.float32))
    toks7 = rng7.randint(0, 4, (256, 10000)).astype(np.int32)
    lens1 = np.full(256, 10000, np.int32)
    scans = {}
    for name, (trans, closure), toks in (
            ("scan1d_dense1d", gen, toks1),
            ("scan1d_every_entry", (trans7, eye), toks7)):
        ops = sk.scan1d_operands(*sk.prepare_scan1d(trans, closure), dev)
        scans[name] = (ops, *tensors(toks, lens1))
    calls = {
        "merged_wavefront": lambda: wk.merged_wavefront(merged, *uniform),
        "chained_ragged_wavefront":
            lambda: wk.chained_ragged_wavefront(merged, *ragged),
        "chained_wavefront":
            lambda: wk.chained_wavefront(merged, *uniform, n_chain=8),
        "chained_wavefront_c2":
            lambda: wk.chained_wavefront(merged, *uniform, n_chain=2),
        "chained_wavefront_c4":
            lambda: wk.chained_wavefront(merged, *uniform, n_chain=4),
        "generic_wavefront": lambda: wk.generic_wavefront(generic, *uniform),
        "seqscale_wavefront":
            lambda: wk.seqscale_wavefront(seqscale, *uniform),
        "merged_every_cell": lambda: wk.merged_wavefront(every, *uniform),
        "chained_ragged_every_cell":
            lambda: wk.chained_ragged_wavefront(every, *ragged)}
    for name, (ops, t, n) in scans.items():
        calls[name] = (lambda o, t, n: lambda: sk.scan1d_forward(o, t, n))(
            ops, t, n)
    scores, ms = {}, {}
    for name in KERNELS + SCANS:
        scores[name] = calls[name]().cpu().numpy()
        torch.cuda.synchronize()
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(5):
            calls[name]()
        t1.record()
        torch.cuda.synchronize()
        ms[name] = t0.elapsed_time(t1) / 5
    for name, (ops, _, _) in scans.items():
        scores[name + "_ll"] = sk.scan1d_loglike(scores[name], lens1, ops.g)
    np.savez(out, **scores)
    print(json.dumps({"tree": root, "ms": ms}), flush=True)


def main(argv):
    if len(argv) == 4 and argv[1] == "--side":
        return side(argv[2], argv[3])
    if len(argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("compare_trees: CUDA is not available", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(json.dumps({"nvidia_smi": smi}), flush=True)
    trees = {"parent": argv[1], "change": HERE}
    with tempfile.TemporaryDirectory() as tmp:
        saved = {}
        for n, which in enumerate(("parent", "change", "change", "parent")):
            out = os.path.join(tmp, "%s%d.npz" % (which, n))
            subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--side", trees[which], out], check=True,
                            timeout=900)
            saved.setdefault(which, out)
        a, b = np.load(saved["parent"]), np.load(saved["change"])
        print(json.dumps({
            "bit_equal": {k: bool(np.array_equal(a[k], b[k],
                                                 equal_nan=True))
                          for k in KERNELS},
            "max_abs_diff": {k: float(np.nanmax(np.abs(a[k] - b[k])))
                             for k in KERNELS},
            "scan_max_abs_diff_nats": {
                k: float(np.max(np.abs(a[k + "_ll"] - b[k + "_ll"])))
                for k in SCANS},
            "scan_exponents_dead_equal": {
                k: bool(np.array_equal(a[k][1:], b[k][1:])) for k in SCANS},
            "nvidia_smi": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
