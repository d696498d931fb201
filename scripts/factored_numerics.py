#!/usr/bin/env python3
"""Why the factored kernel takes its class products in float32.

    python3 scripts/factored_numerics.py

Runs on the CPU, from seeds. The factored kernel's class factors are signed
SVD factors that cancel. This script emulates, with the plain PyTorch walk
of ops/kernels/plain_walk.py, the arithmetic the kernel could use, and
prints each one's distance in nats from the float64 oracle and from the
float32 plain version (factored_forward_plain):

  float32          the plain version itself;
  3xtf32_both      both products (class factors and closure) as 3xTF32
                   tensor-core products (hi = x rounded to TF32, lo the
                   TF32 part of the rest; hi hi + (hi lo + lo hi));
  kernel           float32 class products, a 3xTF32 closure: what
                   csrc/factored_wavefront.cu computes;
  folded_rescale   the float32 plain version with the rescale's division
                   folded into the next read's weight instead of dividing
                   the states.

on three batches: the 64-state dense machine's deep pairs of
tests/test_torch_wavefront_variants.py (odd_start: 56, 53 and 99 symbols),
18 seeded pairs of 60 on the same machine, and 4 prot2dna pairs at
chip_smoke's main-path width (64 amino acids, 192 bases). One JSON line per
batch and arithmetic.
"""

import inspect
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from machineboss_tpu_torch import testmachines  # noqa: E402
from machineboss_tpu_torch.core.eval import EvaluatedMachine  # noqa: E402
from machineboss_tpu_torch.core.presets import make_preset  # noqa: E402
from machineboss_tpu_torch.ops.host_oracle import forward_2d_f64  # noqa: E402
from machineboss_tpu_torch.ops.kernels import plain_walk  # noqa: E402
from machineboss_tpu_torch.ops.kernels import wavefront_kernel as wk  # noqa: E402
from machineboss_tpu_torch.ops.lowering import LoweredMachine  # noqa: E402


def _tf32(x, rounded):
    """x cut to TF32's 10 explicit mantissa bits: rounded to nearest, ties
    away from zero, or truncated (what the tensor core reads of a float32
    operand)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + (0x1000 if rounded else 0)) & -0x2000).view(torch.float32)


def mm_3xtf32(x, y):
    """x @ y in float32 as 3xTF32 tensor-core products compute it."""
    xh, yh = _tf32(x, True), _tf32(y, True)
    xl, yl = _tf32(x - xh, False), _tf32(y - yh, False)
    return xh @ yh + (xh @ yl + xl @ yh)


def lowered(machine):
    ev = EvaluatedMachine(machine, machine.get_param_defs(True))
    return ev, tuple(np.asarray(x) for x in LoweredMachine(
        ev, dtype=np.float32).matrices_2d())


def folded_walk():
    """plain_walk.walk_plain with the rescale's division folded into the
    weight of the next read (the states kept undivided, w / den)."""
    src = inspect.getsource(plain_walk.walk_plain).replace(
        "def walk_plain(", "def walk_folded(")
    edits = [
        ("""        new_p = torch.where(has[:, :, None], cur / den[:, :, None],
                            torch.zeros_like(cur))""",
         """        new_p = torch.where(has[:, :, None], cur, torch.zeros_like(cur))
        held[0] = torch.where(has, den, torch.zeros_like(den))"""),
        ("""            w = torch.where(has & (m_op > NEG_INF / 2),
                            torch.exp(m_op - mu_safe), torch.zeros_like(m_op))""",
         """            w = torch.where(has & (m_op > NEG_INF / 2),
                            torch.exp(m_op - mu_safe), torch.zeros_like(m_op))
            one = torch.ones_like(d1[:, :1])
            dv = {"up": d1, "left": torch.cat([one, d1[:, :-1]], 1),
                  "diag": torch.cat([one, d2[:, :-1]], 1)}[name]
            w = torch.where((w == 0) | (dv == 1), w,
                            w / torch.where(dv > 0, dv, torch.ones_like(dv)))"""),
        ("""        elif d % rescale_every <= 1:
            cur, m_new = rescale(cur, m_new, None, valid)""",
         """        elif d % rescale_every <= 1:
            cur, m_new = rescale(cur, m_new, None, valid)
            dn = held[0]
        else:
            dn = torch.ones_like(m_new)"""),
        ("""        p2, m2, p1, m1 = p1, m1, cur, m_new""",
         """        p2, m2, p1, m1 = p1, m1, cur, m_new
        d2, d1 = d1, dn"""),
        ("""    p2 = torch.zeros_like(p1)""",
         """    p2 = torch.zeros_like(p1)
    d1 = torch.ones_like(m1)
    d2 = torch.ones_like(m1)
    held = [None]"""),
        ("""    def readout(p, m):
        cell = p[b_idx, il]""",
         """    def readout(p, m, dd=None):
        cell = p[b_idx, il]
        if dd is not None:
            v = dd[b_idx, il][:, None]
            cell = torch.where(v == 1, cell, torch.where(
                v > 0, cell / torch.where(v > 0, v, torch.ones_like(v)),
                torch.zeros_like(cell)))"""),
        ("""        res = torch.where(dfin == d, readout(cur, m_new), res)""",
         """        res = torch.where(dfin == d, readout(cur, m_new, dn), res)"""),
    ]
    for old, new in edits:
        if old not in src:
            raise RuntimeError("walk_plain changed; update this script")
        src = src.replace(old, new)
    ns = dict(plain_walk.__dict__)
    exec(src, ns)
    return ns["walk_folded"]


def scores(ops, batch, mm_classes, mm_closure, walk=plain_walk.walk_plain):
    by_name = {c[0]: c for c in ops.classes}

    def term(name, q, tok):
        _, Tm, Et, r = by_name[name]
        B, W = tok.shape
        out = mm_classes(q, Tm).reshape(B, W, r, ops.Sa)
        return (out * Et[tok]).sum(dim=2)

    return walk(ops.c0, term, ops.names, *batch, ops.To,
                readout_w=ops.w if ops.sink else None,
                closure_t=ops.closure, closure_mm=mm_closure).numpy()


def main():
    dense64 = lowered(testmachines.build_random_transducer(
        64, list("ACGT"), seed=42))[1]
    batches = []
    rng = np.random.RandomState(1)
    it = rng.randint(0, 4, (3, 100)).astype(np.int32)
    ot = rng.randint(0, 4, (3, 100)).astype(np.int32)
    lens = np.array([56, 53, 99], np.int32)
    batches.append(("dense64_odd_start", dense64, it, ot, lens, lens))
    its, ots = [], []
    for seed in range(6):
        rng = np.random.RandomState(100 + seed)
        its.append(rng.randint(0, 4, (3, 60)).astype(np.int32))
        ots.append(rng.randint(0, 4, (3, 60)).astype(np.int32))
    full = np.full(18, 60, np.int32)
    batches.append(("dense64_seeded_60", dense64, np.concatenate(its),
                    np.concatenate(ots), full, full))
    ev, p2d = lowered(make_preset("prot2dna"))
    pairs = testmachines.prot2dna_pairs(4, 64, seed=5)
    it = np.array([[ev.input_tokenizer.sym2tok[c] - 1 for c in p]
                   for p, _ in pairs], np.int32)
    ot = np.array([[ev.output_tokenizer.sym2tok[c] - 1 for c in d]
                   for _, d in pairs], np.int32)
    batches.append(("prot2dna_64x192", p2d, it, ot, np.full(4, 64, np.int32),
                    np.full(4, 192, np.int32)))
    folded = folded_walk()
    for name, mats, it, ot, il, ol in batches:
        ops = wk.factored_operands(wk.prepare_factored(*mats),
                                   torch.device("cpu"))
        m64 = [x.astype(np.float64) for x in mats]
        ref = np.array([forward_2d_f64(*m64, it[b][:il[b]], ot[b][:ol[b]])
                        for b in range(len(il))])
        batch = [torch.from_numpy(x) for x in (it, ot, il, ol)]
        plain = scores(ops, batch, torch.matmul, None)
        for label, got in (
                ("float32", plain),
                ("3xtf32_both", scores(ops, batch, mm_3xtf32,
                                       mm_3xtf32)),
                ("kernel", scores(ops, batch, torch.matmul, mm_3xtf32)),
                ("folded_rescale", scores(ops, batch, torch.matmul, None,
                                          walk=folded))):
            print(json.dumps({
                "batch": name, "arithmetic": label, "pairs": len(il),
                "max_abs_vs_f64": float(np.abs(got - ref).max()),
                "max_abs_vs_float32_plain": float(np.abs(got - plain).max()),
                "device": "cpu"}), flush=True)


if __name__ == "__main__":
    main()
