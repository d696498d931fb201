#!/usr/bin/env python3
"""Smoke run of machineboss_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Builds every CUDA kernel of the port from csrc/, holds each against its
plain PyTorch version, then drives the main path: batched prot2dna Forward
through CompiledMachine.log_forward_batch at B=512 (protein length 64
against its 192-base codon DNA), gated against the float64 host oracle.
Prints one JSON line per phase, the kernel table, the card's name and power
limit, and as its last line {"ok": true, "device": {...}}. Any failure
prints its traceback and exits non-zero. Without CUDA it exits 1 and
prints no result.
"""

import json
import subprocess
import sys
import time

import numpy as np
import torch

NEG = -1e29                      # below this a score is log(0)
KERNEL_VS_PLAIN_TOL = 1e-3       # nats: same f32 recurrence, other sum order
KERNEL_VS_F64_TOL = 5e-3         # nats: signed SVD factors cancel at L~20-200
GATE_TOL = 0.01                  # nats: the f64 accuracy gate of bench.py
F32_FMA_FLOPS = 67e12            # H100 SXM f32 non-tensor peak (data sheet)
HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3 (data sheet)


def emit(obj):
    print(json.dumps(obj), flush=True)


def check(cond, msg):
    if not cond:
        raise RuntimeError("check failed: " + msg)


def score_err(a, b):
    """max |a - b| over pairs, requiring impossible pairs (<= NEG) to be
    impossible in both."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    check(a.shape == b.shape, "shapes %s vs %s" % (a.shape, b.shape))
    dead_a, dead_b = a <= NEG, b <= NEG
    check(np.array_equal(dead_a, dead_b),
          "impossible pairs differ: %s vs %s"
          % (np.where(dead_a)[0], np.where(dead_b)[0]))
    live = ~dead_a
    return float(np.abs(a[live] - b[live]).max()) if live.any() else 0.0


def cuda_ms(fn, reps):
    """Mean device ms per call of fn over `reps` calls, after a warm-up."""
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


def padded_batch(toks, Li, Lo, device):
    B = len(toks)
    it = np.zeros((B, Li), np.int32)
    ot = np.zeros((B, Lo), np.int32)
    il = np.array([len(t[0]) for t in toks], np.int32)
    ol = np.array([len(t[1]) for t in toks], np.int32)
    for n, (ti, to) in enumerate(toks):
        it[n, :len(ti)] = ti
        ot[n, :len(to)] = to
    return [torch.from_numpy(x).to(device) for x in (it, ot, il, ol)]


def f64_scores(mats, toks):
    from machineboss_tpu_torch.ops.host_oracle import forward_2d_f64
    m64 = [np.asarray(x, np.float64) for x in mats]
    return np.array([forward_2d_f64(*m64, ti, to) for ti, to in toks])


def lowrank_case(name, cm, toks, dev):
    """Kernel vs plain vs f64 oracle on one machine and batch."""
    from machineboss_tpu_torch.ops.fwdback import pad_bucket
    from machineboss_tpu_torch.ops.kernels import lowrank_kernel as lk
    mats = cm._host_mats()
    plan, host = lk.prepare_lowrank(*mats)
    ops = lk.lowrank_operands(plan, host, mats[0].shape[1], dev)
    Li = pad_bucket(max(len(t[0]) for t in toks), base=16)
    Lo = pad_bucket(max(len(t[1]) for t in toks), base=16)
    batch = padded_batch(toks, Li, Lo, dev)
    kern = lk.lowrank_wavefront(ops, *batch).cpu().numpy()
    plain = lk.lowrank_forward_plain(ops, *batch).cpu().numpy()
    ref = f64_scores(mats, toks)
    err_plain = score_err(kern, plain)
    err_f64 = score_err(kern, ref)
    emit({"phase": "kernel_vs_plain", "case": name, "B": len(toks),
          "Li": Li, "Lo": Lo, "Sa": ops.Sa,
          "classes": [[c.name, c.side, c.rank] for c in ops.classes],
          "max_abs_vs_plain": err_plain, "max_abs_vs_f64": err_f64,
          "n_impossible": int((ref <= NEG).sum())})
    check(err_plain <= KERNEL_VS_PLAIN_TOL,
          "%s: kernel vs plain %.3g nats" % (name, err_plain))
    check(err_f64 <= KERNEL_VS_F64_TOL,
          "%s: kernel vs f64 %.3g nats" % (name, err_f64))


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from machineboss_tpu_torch.core.presets import make_preset
    from machineboss_tpu_torch.dispatch import CompiledMachine
    from machineboss_tpu_torch.ops.fwdback import pad_bucket
    from machineboss_tpu_torch.ops.kernels import _build
    from machineboss_tpu_torch.ops.kernels import lowrank_kernel as lk
    from machineboss_tpu_torch.testmachines import (
        build_allclass_transducer, prot2dna_pairs)

    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    card = torch.cuda.get_device_name(0)
    emit({"phase": "env", "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "device": card,
          "count": torch.cuda.device_count(),
          "allow_tf32": torch.backends.cuda.matmul.allow_tf32})

    build_s = _build.build_all()
    emit({"phase": "build", "seconds": build_s,
          "ptxas": {k: [ln.strip() for ln in v.splitlines()
                        if "registers" in ln or "spill" in ln]
                    for k, v in _build.build_logs.items()}})

    # -- kernel vs plain, two machines -----------------------------------
    p2d = CompiledMachine(make_preset("prot2dna"), device=dev)
    rng = np.random.RandomState(1)
    pairs = prot2dna_pairs(16, rng.randint(32, 65, 16), seed=1)
    lowrank_case("prot2dna", p2d,
                 [(p2d.in_toks(i), p2d.out_toks(o)) for i, o in pairs], dev)
    ac = CompiledMachine(build_allclass_transducer(5, list("AC")), device=dev)
    rng = np.random.RandomState(8)
    lens = [(int(rng.randint(10, 21)), int(rng.randint(10, 21)))
            for _ in range(8)]
    lowrank_case("allclass", ac,
                 [(list(rng.randint(0, 2, a)), list(rng.randint(0, 2, b)))
                  for a, b in lens], dev)

    # -- the main path ----------------------------------------------------
    B, Lp = 512, 64
    cm = CompiledMachine(make_preset("prot2dna"), device=dev)
    check(cm.route() == "lowrank", "prot2dna must route to lowrank")
    pairs = prot2dna_pairs(B, Lp, seed=0)
    lk.lowrank_wavefront.launches = 0
    t0 = time.perf_counter()
    lls = cm.log_forward_batch(pairs)
    first_s = time.perf_counter() - t0
    launches = lk.lowrank_wavefront.launches
    check(launches == 1, "main path launched the kernel %d times" % launches)
    check(lls.shape == (B,) and np.isfinite(lls).all(),
          "main path scores not all finite")
    toks = [(cm.in_toks(i), cm.out_toks(o)) for i, o in pairs]
    n_gate = 8
    gate = score_err(lls[:n_gate], f64_scores(cm._host_mats(), toks[:n_gate]))
    check(gate <= GATE_TOL, "f64 gate %.3g nats" % gate)

    call_s = []
    for _ in range(5):
        before = lk.lowrank_wavefront.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cm.log_forward_batch(pairs)
        torch.cuda.synchronize()
        call_s.append(time.perf_counter() - t0)
        check(lk.lowrank_wavefront.launches == before + 1,
              "a log_forward_batch call did not launch the kernel once")
    call_ms = float(np.median(call_s)) * 1e3

    # the kernel alone, and its plain version, at the main path's shapes
    mats = cm._host_mats()
    plan, host = lk.prepare_lowrank(*mats)
    ops = lk.lowrank_operands(plan, host, mats[0].shape[1], dev)
    Li = pad_bucket(Lp, base=16)
    Lo = pad_bucket(3 * Lp, base=16)
    batch = padded_batch(toks, Li, Lo, dev)
    kern = lk.lowrank_wavefront(ops, *batch).cpu().numpy()
    plain = lk.lowrank_forward_plain(ops, *batch).cpu().numpy()
    err_main = score_err(kern, plain)
    check(err_main <= KERNEL_VS_PLAIN_TOL,
          "main shapes: kernel vs plain %.3g nats" % err_main)
    check(score_err(kern, lls) == 0.0, "kernel alone differs from main path")
    kernel_ms = cuda_ms(lambda: lk.lowrank_wavefront(ops, *batch), 10)
    plain_ms = cuda_ms(lambda: lk.lowrank_forward_plain(ops, *batch), 3)

    # least time for this run's work: every real cell (i <= il, o <= ol,
    # but the start cell) does sum_c rank_c * Sa * Sa MACs; inputs and the
    # output move once
    il = np.array([len(t[0]) for t in toks])
    ol = np.array([len(t[1]) for t in toks])
    cells = float(((il + 1) * (ol + 1) - 1).sum())
    macs_per_cell = sum(c.rank * ops.Sa * ops.Sa for c in ops.classes)
    flops = 2.0 * macs_per_cell * cells
    nbytes = float(sum(t.numel() * t.element_size() for t in batch)
                   + sum(m.numel() * 4 + e.numel() * 4 for m, e in ops.mats)
                   + ops.c0.numel() * 4 + B * 4)
    bound_ms = max(flops / F32_FMA_FLOPS, nbytes / HBM_BYTES_PER_S) * 1e3
    bound_by = "operations" if flops / F32_FMA_FLOPS >= \
        nbytes / HBM_BYTES_PER_S else "bytes"
    state_cells = B * (Lp + 1) * (3 * Lp + 1) * mats[3].shape[0]
    emit({"phase": "main_path", "B": B, "Lp": Lp, "Lo": 3 * Lp,
          "padded": [Li, Lo], "launches_first_call": launches,
          "f64_gate_max_abs": gate, "f64_gate_pairs": n_gate,
          "first_call_s": first_s, "call_ms_median5": call_ms,
          "kernel_ms": kernel_ms, "plain_ms": plain_ms,
          "kernel_share_of_call": kernel_ms / call_ms,
          "state_cells_per_s": state_cells / (call_ms / 1e3),
          "kernel_state_cells_per_s": state_cells / (kernel_ms / 1e3),
          "flops": flops, "bound_ms": bound_ms,
          "kernel_share_of_bound": bound_ms / kernel_ms,
          "card": card, "nvidia_smi": smi})

    emit({"kernels": [{
        "name": "lowrank_wavefront", "route": "cuda",
        "source": "machineboss_tpu_torch/csrc/lowrank_wavefront.cu",
        "replaces": "machineboss_tpu/ops/pallas/lowrank_kernel.py:188 "
                    "(_lowrank_kernel)",
        "launches": launches, "max_abs_err": err_main,
        "max_abs_vs_plain": err_main, "ms": kernel_ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": card,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
