#!/usr/bin/env python3
"""Time the fused Plan7 kernel's two layouts across profile lengths on one
CUDA card.

    python3 scripts/plan7_layouts.py [--K 86,128,300] [--St 2,1,3]

For each profile length K and transducer size St: a seeded random
amino-acid Plan7 profile of K nodes fused with the noise transducer of St
states, multihit, scoring the plan7 path's batch (B=1024 random reads of
90, padded to 96) through fused_plan7_forward_kernel in the warp layout
and in the node-doubling layout, in turns (warp, node_doubling,
node_doubling, warp; the mean of 5 calls each by CUDA events). Each
layout is held to the plain PyTorch version (max |kernel - plain| in
nats, dead flags equal; a layout that does not fit is named, not
timed); launch_plan's default for K stands beside the times.
fused_plan7_kernel.WARP_DEFAULT_MAX_K, the most nodes for which the warp
layout is the default, rests on this measurement.

Each line of output is one JSON object: the card's name and power limit
first, then one line per (K, St), then the ptxas lines (registers, stack
frame, spills) of the fused_plan7 library's kernels. Exits 1 without
CUDA.
"""

import argparse
import json
import os
import re
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)

B, LR, REPS = 1024, 90, 5
KERNEL_VS_PLAIN_TOL = 1e-3     # nats: same f32 recurrence, other sum order


def cuda_ms(fn, reps=REPS):
    """Mean device ms a call of fn over `reps` calls, after a warm-up."""
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


def model(K, St, dev):
    from machineboss_tpu_torch.core.eval import EvaluatedMachine
    from machineboss_tpu_torch.core.hmmer import HmmerModel
    from machineboss_tpu_torch.core.machine import Machine
    from machineboss_tpu_torch.ops.fused_plan7 import Plan7Fused
    from machineboss_tpu_torch.testmachines import (
        AMINO, noise_transducer_json, random_plan7_hmm_text)
    hmm = HmmerModel()
    hmm.read(random_plan7_hmm_text(K, AMINO, seed=3))
    td = Machine.from_json(noise_transducer_json(AMINO, St))
    return Plan7Fused(hmm, EvaluatedMachine(td, td.get_param_defs(True)),
                      mode="plan7", multihit=True, solver="scan", device=dev)


def run(K, St, dev):
    from machineboss_tpu_torch.ops.fwdback import pad_bucket
    from machineboss_tpu_torch.ops.kernels import fused_plan7_kernel as fk
    from machineboss_tpu_torch.testmachines import AMINO, plan7_reads
    f = model(K, St, dev)
    ops = fk.plan7_operands(fk.prepare_fused_plan7(f), dev)
    s2t = f.td_ev.output_tokenizer.sym2tok
    toks = np.ones((B, pad_bucket(LR, base=16)), np.int32)
    toks[:, :LR] = [[s2t[c] for c in r] for r in plan7_reads(AMINO, B, LR)]
    t = torch.from_numpy(toks).to(dev)
    n = torch.full((B,), LR, dtype=torch.int32, device=dev)
    plain = fk.fused_plan7_forward_plain(ops, t, n)
    pll = fk.decode(plain.cpu().numpy())
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plans, err, ms = {}, {}, {}
    for lay in fk.LAYOUTS:
        try:
            plans[lay] = fk.launch_plan(K, St, ops.n_sym, B, sms, layout=lay)
        except ValueError as e:          # node doubling: does not fit
            plans[lay] = str(e)
            continue
        kern = fk.fused_plan7_forward_kernel(ops, t, n, layout=lay)
        if not torch.equal(kern[2], plain[2]):
            raise RuntimeError("K=%d St=%d %s: dead flags differ"
                               % (K, St, lay))
        err[lay] = float(np.abs(fk.decode(kern.cpu().numpy()) - pll).max())
        if not err[lay] <= KERNEL_VS_PLAIN_TOL:
            raise RuntimeError("K=%d St=%d %s: %.3g nats from plain"
                               % (K, St, lay, err[lay]))
        ms[lay] = []
    for lay in ("warp", "node_doubling", "node_doubling", "warp"):
        if lay in ms:
            ms[lay].append(cuda_ms(lambda: fk.fused_plan7_forward_kernel(
                ops, t, n, layout=lay)))
    return {"K": K, "St": St, "B": B, "L": LR, "ms": ms,
            "faster": min(ms, key=lambda lay: sum(ms[lay])),
            "default": fk.default_layout(K), "plans": plans,
            "max_abs_vs_plain": err}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--K", default="86,128,160,256,300,320,384,512")
    ap.add_argument("--St", default="2,1,3")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        sys.exit(1)
    from machineboss_tpu_torch.ops.kernels import _build
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(json.dumps({"card": torch.cuda.get_device_name(0),
                      "nvidia_smi": smi.strip()}), flush=True)
    dev = torch.device("cuda")
    for St in (int(x) for x in args.St.split(",")):
        for K in (int(x) for x in args.K.split(",")):
            print(json.dumps(run(K, St, dev)), flush=True)
    log = _build.build_logs.get("fused_plan7", "")
    keep = re.compile(r"Compiling entry|Used \d+ registers|stack frame")
    print(json.dumps({"ptxas_fused_plan7": [
        ln.strip() for ln in log.splitlines() if keep.search(ln)]}))


if __name__ == "__main__":
    main()
