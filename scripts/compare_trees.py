#!/usr/bin/env python3
"""Compare the full-rank wavefront kernels of two trees on one CUDA card.

    git archive <commit> machineboss_tpu_torch | tar -x -C <dir>
    python3 scripts/compare_trees.py <dir>

Runs the merged, chained_ragged, chained (chains 2, 4 and 8), generic and
seqscale kernels of the tree at <dir> ("parent") and of this checkout ("change") in
turns, parent, change, change, parent, each turn a process of its own that
builds its tree's kernels: bench.py's dense machine (the random 64-state
ACGT transducer), B=512 pairs of 200x200 (seed 0), and for chained_ragged
the same pairs cut to lengths uniform in [100, 200]. Each turn prints one
JSON line with every kernel's mean ms over 5 calls (CUDA events); the last
line says, per kernel, whether the two trees' scores are equal bit for bit
and their largest difference. Each tree builds under its own package's
build/ directory. Exits 1 without CUDA.
"""

import json
import os
import subprocess
import sys
import tempfile

KERNELS = ("merged_wavefront", "chained_ragged_wavefront",
           "chained_wavefront", "chained_wavefront_c2",
           "chained_wavefront_c4", "generic_wavefront", "seqscale_wavefront")
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
    from machineboss_tpu_torch.testmachines import build_random_transducer
    pkg = os.path.dirname(os.path.abspath(machineboss_tpu_torch.__file__))
    if not pkg.startswith(os.path.abspath(root)):
        raise RuntimeError("imported %s, not the tree at %s" % (pkg, root))
    dev = torch.device("cuda")
    m = build_random_transducer(64, list("ACGT"))
    ev = EvaluatedMachine(m, m.get_param_defs(True))
    mats = tuple(np.asarray(x) for x in
                 LoweredMachine(ev, dtype=np.float32).matrices_2d())
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
            lambda: wk.seqscale_wavefront(seqscale, *uniform)}
    scores, ms = {}, {}
    for name in KERNELS:
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
                             for k in KERNELS}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
