#!/usr/bin/env python3
"""Smoke run of machineboss_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Builds every CUDA kernel of the port from csrc/ and the three phase-profile
libraries (one nvcc process each, all at once), holds each against its
plain PyTorch version and the float64 oracles at small sizes, then drives
thirteen paths at full width (and the row kernel's calls, below), each
gated against a float64 oracle on 8 pairs or reads. Four go through
CompiledMachine.log_forward_batch:

  prot2dna       B=512, protein 64 against its 192-base codon DNA
                 (lowrank kernel);
  dense_uniform  random 64-state ACGT transducer, B=512 pairs of 200x200
                 (merged kernel);
  dense_ragged   the same machine, lengths uniform in [100, 200]
                 (chained_ragged kernel);
  dense1d        random 64-state ACGT generator, B=256 sequences of
                 10,000 (scan1d kernel; its launch plan, and variants:
                 dense columns, a block barrier a step, tokens read from
                 global memory, the renormalisation behind its own
                 barrier).

The merged and chained_ragged paths (and dense_chained below) also time
the walk's variants: every lattice cell's lanes, the separate rescale
pass, the diagonal slots in the other memory. Two kernel-alone cases, held
to their plain versions and timed, measure what the dense machines do not
exercise: scan1d_every_entry (a seeded (4, 64, 64) transfer tensor with
every entry finite, B=256 sequences of 10,000) and merged_every_cell (the
all-class 64-state ACGT machine, whose every cell is live, through merged
on dense_uniform's pairs and chained_ragged on dense_ragged's lengths).

Three go through algo.viterbi_device.device_viterbi_matrices (the max-plus
fill, the lattice walk on the card, the host re-trace), and must give the
host engine's alignments; each also prints a *_walk phase: the walk's
launch plan, its variants timed in turns (a block barrier a step, tokens
read from global memory, the cells prefetched into a shared ring, the
left, up and silent edge rows in shared memory), each with the same
records bit for bit, and the SM cycles a step in each phase from the
walk's phase-profile library:

  viterbi_dense   random 64-state ACGT transducer, B=64 pairs of 128x128
                  (viterbi_wavefront and lattice_walk kernels);
  align_banded    the same kind of machine, ONE pair of L=1500 with 10%
                  mutations inside an envelope of width 16
                  (viterbi_banded_wavefront and lattice_walk kernels; the
                  fill's launch plan, and variants: one block, streamed
                  class columns, one lane an item, the other split);
  align_prot2dna  the prot2dna preset, B=64 proteins of 64 against their
                  192-base codon DNA (viterbi_wavefront and lattice_walk).

One goes through ops.fused_plan7.Plan7Fused (forward_batch_tokens and
forward_stream):

  plan7           a seeded 86-node amino-acid profile of fn3's shape fused
                  with the 2-state noise transducer, multihit, B=1024 reads
                  of 90, eight batches streamed (fused_plan7 kernel; its
                  plan7_profile phase: the node-doubling layout and 1, 2,
                  4 and 8 reads a block timed, and the SM cycles a row in
                  each phase of both layouts from the phase-profile
                  library; its plan7_layouts phase: both layouts timed on
                  the same batch through profiles of 128 and 300 nodes,
                  either side of launch_plan's default crossover).

Five go through the kernel factory make_wavefront_forward, one call each:

  dense_chained      dense_uniform's pairs, variant="chained", chain=8
                     (chained_wavefront; chains 2 and 4 timed too, and
                     the strip schedule's B / chain blocks as a variant);
  prot2dna_chained   prot2dna's pairs, variant="lowrank", chain=8
                     (lowrank_chained_wavefront);
  dense_generic      dense_uniform's pairs, merged=False
                     (generic_wavefront; its launch plan, and variants:
                     C^T through L1/L2, a warp a cell, every cell's
                     products);
  dense_seqscale     dense_uniform's pairs, variant="seqscale"
                     (seqscale_wavefront, equal to its plain version bit
                     for bit; the merged kernel timed on its plan too, and
                     variants: the separate max pass, every cell's
                     products);
  prot2dna_factored  prot2dna's pairs, variant="factored"
                     (factored_wavefront; variant: one walker a block).

A variant undoes one design choice of a kernel and gives the same scores
bit for bit (scan1d's: held to the plain version as the kernel is); each
is timed in turns with the kernel. A bound counts the work this run's data
needs: the merged family, generic and seqscale take no class product for
a zero cell, and bench.py's dense machine reaches only the cells with
i == o (the bound over every cell is printed too); scan1d multiplies only
the nonzero entries of a position's token matrix (the S * S bound beside
it).

Then the long_shapes phase drives the four kernels whose shared memory
grew with the lengths or the profile at a size past a block's 227 KiB,
each through its entry point, its kernel launched once and no other, the
kernel alone against its plain version, and the first pair or read
against a float64 oracle of this script's own on the card
(forward_2d_f64_card, viterbi_2d_f64_card): prot2dna log_forward_batch
on 4 pairs of 64-128 aa whose flanked DNA pads to 58,837 (lowrank, the
pair's tokens in global memory); device_viterbi_matrices on 2
full-envelope pairs of 3,600 x 3,600 through the 64-state ACGT
transducer (the fill's buckets in global memory, then the walk);
Plan7Fused.forward_batch_tokens at 1,200 nodes, 256 reads of 1,200
(node doubling with the state in global memory); factored on 8 prot2dna
pairs of 400 x 1,200 (the chunked layout). It prints each plan's layout
and each case's ms (~150 s).

Then the em phase drives EM training (no kernel of the kernels line runs
in its E-step: autograd through the batched wavefront, eager torch):
prot2dna, B=128 pairs of 64 aa x 192 nt whose codons are drawn from each
amino acid's synonymous codons, through parallel.em.device_counts (first
call s, median of 3 ms, pairs/s, state-cells/s, launches and copies a
call, peak memory, beside the same batch's log_forward_batch ms), gated
(a) on the first 4 pairs against the host MachineCounts, (b) on every
pair's ll against log_forward_batch (one lowrank launch), (c) on the
emitted-token counts against the lengths and (d) on tkf91branch and the
indel transducer against host counts; then MachineFitter(engine="device")
for 3 iterations with a checkpoint (each iteration's s and E/M split; the
loglike may not fall) and a host and a device fit of 8 flanked pairs of
16 aa: every parameter the data use within 1e-3, and the two fits'
likelihoods within 0.01 nats (a parameter whose transitions the data use
less than 0.01 times, such as the intron extension, is printed).

Then three phases drive what a user reaches without writing Python, and
the neural and CTC scorers (no kernel of their own; the cli phase reaches
five kernels of the line through their counted wrappers):

  cli         machineboss_tpu_torch.cli.main in process, stdout captured, on
              files written to a temporary directory: prot2dna --loglike
              B=512 of 64 x 192 (lowrank), a 64-state generator with
              --output-fasta of 256 reads of 10,000 (scan1d), --align
              --viterbi on align_prot2dna's 64 pairs (the batched fill and
              the walk), --align --wiggle-room 16 on align_banded's pair
              (the banded fill and the walk), --counts on 16 of the em
              batch's pairs (no kernel): each call's launches, its output
              equal to the text a direct call of the same entry point
              gives, f64 gates on 8 pairs, the host's alignments with no
              fallback, the call's ms split into machine build,
              CompiledMachine set-up, entry point and the rest; the
              prot2dna call once under profiling.trace_if, whose trace
              must name lowrank_wavefront_kernel; `python -m
              machineboss_tpu_torch` once as a subprocess, within 1e-3 of
              the JAX CLI's -5.54518;
  neural      ops.dp_neural.neural_log_forward on dnapsw, one 200 x 200
              pair: constant fields against the host Forward (1e-3),
              gapOpen and gapExtend fields' summed gradients against the
              scalar ones, and those against a central difference of the
              host score; forward and backward ms, launches, peak memory;
  ctc_device  algo.ctc_device.CTCDeviceModel on prot2dna and a 192-nt
              read: build s and bytes, the root and up to 16 levels of the
              read's own protein (fewer, listed in `reduced`, once the host
              tree passes 30 s), each level's 20 children against the host
              PrefixTree (1e-3); one fill_all_tokens' ms and launches.

Then the parallel phase drives the parallel layer (parallel/*, no kernel
of its own) on a world of one: make_mesh() starts an NCCL group in
process (the card's machine has one H100, and NCCL takes one rank a
card), destroyed at the phase's end. (a) forward_batch_sharded on the
prot2dna path's 512 pairs (the f64 gate on 8, every pair against the
lowrank scores, 5e-3); (b) lowrank, merged and chained (chain 8) from
make_wavefront_forward on the rank's block, all-gathered: bit-equal to
the factory's call on the whole batch, one launch each; (c)
device_counts(mesh=) on the em phase's pairs and one
MachineFitter(engine="device", mesh=) iteration, equal to mesh=None;
(d) the length- and (e) the state-sharded scans on dense1d's generator
at L=10,000 and (f) one diagonal-sharded 2,000 x 2,000 lattice on the
dense machine, each against its single-device engine and a float64
oracle (0.01 nats); each part's ms, launches (torch.profiler) and the
NCCL kernels the profiler names.

Then four phases drive single-pair scoring and the sparse engine, each
call gated against a float64 oracle, timed with torch.cuda.synchronize()
around it (the median of 5 where a call takes under 1 s, else over its
pairs) and its device launches counted once under torch.profiler; a fifth,
row_profile, reads the row kernel. The 2D single-pair calls run the row
kernel (row_scan, the kernels line's 14th entry); the other phases run
eager torch engines, no kernel of the line:

  single_pair_2d  prot2dna, 8 pairs of 64 aa x 192 nt, each call with
                  row_scan launched once (posterior_lattice twice) and no
                  other kernel, the kernel alone timed by CUDA events, its
                  plan (the cluster of blocks a pair) and its tables'
                  build ms recorded, and held to its plain version on the
                  card (logsumexp 1e-3 nats, max-plus 0.0): log_forward
                  and log_viterbi,
                  log_backward_lattice and fwdback.posterior_lattice on
                  the first pair (every cell), forward_2d_banded in an
                  Envelope of width 16 around each pair's path,
                  api.device_forward_batch on 64 pairs, and
                  DeviceViterbiMatrix's default fill (the host's
                  alignments); dp2d.forward_2d with the associative rows
                  (eager, 2 pairs) and dp_aligned.forward_aligned along
                  each pair's path; then the 512-state machine, a pair of
                  64 x 64 (states_512), and the 64-state ACGT machine at
                  3,000 x 3,000 on 16 blocks, against the f64 oracle on
                  the card (long_pair), and again on 8 blocks, whose ring
                  of diagonals no longer fits shared memory (global
                  memory: bit-equal, timed);
  row_profile     one prot2dna pair of 64 x 192, each semiring: the row
                  kernel's clock64 phase profile (its profile library; a
                  warp's SM cycles a diagonal and a cell's in each phase)
                  at the plan's cluster and on one block, the kernel
                  against its CPU twin (row_kernel.row_scan_diagonal, run
                  on the card on the same tables), and the kernel alone at
                  each cluster size 1-16, bit-equal;
  single_pair_1d  the dense1d generator at L=10,000: log_forward with
                  "auto" (the card's measured row, dispatch_table_cuda.json,
                  asserted, and on the card "assoc"; no slower than the
                  other route, also timed),
                  log_viterbi on that route against the scan's max-plus
                  score (ms, peak memory), forward_1d_all /
                  backward_1d_all, the blocked
                  fold on the dense1d batch (256 x 10,000; also against
                  the scan1d kernel's scores) and the probability-space
                  scan at 256 x 3,000;
  sparse          a seeded 128-node Plan7 generator (644 states, not
                  dense), 4 reads of 128 (log_forward, the 1D forms in
                  both semirings), and prot2dna forced sparse, 4 pairs of
                  64 x 192 (log_forward_batch, backward and Viterbi);
  pswm            the dense and sparse PSWM forms, 1D and 2D (the 2D
                  profiles at 16 aa x 48 nt).

Prints one JSON line per phase, the total time, the kernel table, the
card's name and power limit, and as its last line {"ok": true, "device":
{...}}. Any failure prints its traceback and exits non-zero. Without CUDA
it exits 1 and prints no result.
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
MERGED_VS_F64_TOL = 2e-3         # nats: the merged family's bound at L<=20
ODD_START_VS_F64_TOL = 5e-3      # nats: the S=64, L=100 deep chain
SCAN1D_VS_F64_TOL = 1e-4         # nats: f32 products over <= 150 positions
GATE_TOL = 0.01                  # nats: the f64 accuracy gate of bench.py
VITERBI_VS_PLAIN_TOL = 0.0       # nats: float32 adds and maxes only
SEQSCALE_VS_PLAIN_TOL = 0.0      # nats: the plain version's sums and scales
PLAN7_VS_FLAT_TOL = 2e-3         # nats: scaled probability vs log space, L<=24
PLAN7_VS_F64_TOL = 5e-3          # nats: the composed-machine oracle's bound
PLAN7_VITERBI_TOL = 1e-4         # nats: max-plus flat solver vs its f64 oracle
F32_FMA_FLOPS = 67e12            # H100 SXM f32 non-tensor peak (data sheet)
TF32_FLOPS = 495e12              # H100 SXM TF32 tensor peak, dense
# That peak counts a fused multiply-add as two operations. The max-plus fills
# issue an add and a max as two instructions, so they can reach half of it at
# most: their operations bound is lower than the card can do, never higher.
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


_F64 = {}


def f64_scores(mats, toks, key=None):
    """The float64 oracle's scores; with `key`, computed once per run."""
    from machineboss_tpu_torch.ops.host_oracle import forward_2d_f64
    if key is not None and key in _F64:
        return _F64[key]
    m64 = [np.asarray(x, np.float64) for x in mats]
    ref = np.array([forward_2d_f64(*m64, ti, to) for ti, to in toks])
    if key is not None:
        _F64[key] = ref
    return ref


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


def lowrank_queue_cases(dev):
    """The lowrank kernel where its layout or its queue differs from the
    main path: ONE block (one or two walkers) takes every pair of a batch
    holding a bad token and a bad length; the 64-state dense machine's
    factors (256 KB) stream through shared memory."""
    from machineboss_tpu_torch.ops.kernels import lowrank_kernel as lk
    from machineboss_tpu_torch.testmachines import (
        build_allclass_transducer, build_random_transducer)
    mats = lowered(build_allclass_transducer(5, list("AC")))
    rng = np.random.RandomState(8)
    B, L = 8, 12
    it = rng.randint(0, 2, (B, L)).astype(np.int32)
    ot = rng.randint(0, 2, (B, L)).astype(np.int32)
    il = rng.randint(4, L + 1, B).astype(np.int32)
    ol = rng.randint(4, L + 1, B).astype(np.int32)
    plan, host = lk.prepare_lowrank(*mats)
    ops = lk.lowrank_operands(plan, host, mats[0].shape[1], dev)
    batch = [torch.from_numpy(x).to(dev) for x in (it, ot, il, ol)]
    plain = lk.lowrank_forward_plain(ops, *batch).cpu().numpy()
    ref = f64_scores(mats, [(it[b][:il[b]], ot[b][:ol[b]]) for b in range(B)])
    kin = [x.clone() for x in batch]
    kin[0][2, 0] = 99                     # a bad token
    kin[2][5] = L + 1                     # a bad length
    live = np.array([b not in (2, 5) for b in range(B)])
    for walkers in (1, 2):
        kern = lk.lowrank_wavefront(ops, *kin, grid=1,
                                    walkers=walkers).cpu().numpy()
        check(np.isnan(kern[2]) and np.isnan(kern[5]),
              "one_block: bad pairs scored %r %r" % (kern[2], kern[5]))
        err_plain = score_err(kern[live], plain[live])
        err_f64 = score_err(kern[live], ref[live])
        emit({"phase": "kernel_vs_plain", "kernel": "lowrank_wavefront",
              "case": "allclass_one_block", "B": B, "grid": 1,
              "walkers": walkers, "bad_token_nan": True,
              "bad_length_nan": True, "max_abs_vs_plain": err_plain,
              "max_abs_vs_f64": err_f64})
        check(err_plain <= KERNEL_VS_PLAIN_TOL,
              "one_block: kernel vs plain %.3g nats" % err_plain)
        check(err_f64 <= KERNEL_VS_F64_TOL,
              "one_block: kernel vs f64 %.3g nats" % err_f64)

    mats = lowered(build_random_transducer(64, list("ACGT")))
    B, L = 4, 16
    rng = np.random.RandomState(4)
    it = rng.randint(0, 4, (B, L)).astype(np.int32)
    ot = rng.randint(0, 4, (B, L)).astype(np.int32)
    il = np.array([16, 9, 12, 16], np.int32)
    ol = np.array([16, 10, 12, 5], np.int32)
    plan, host = lk.prepare_lowrank(*mats)
    ops = lk.lowrank_operands(plan, host, mats[0].shape[1], dev)
    cfg = lk.launch_config(ops, B, L, L)
    check(not cfg["resident"], "dense64: the factors did not stream")
    check(lk.smem_bytes_on_card(ops, cfg, L, L) == cfg["smem"],
          "dense64: the kernel's shared layout differs from launch_plan's")
    fn = lk.make_lowrank_forward(*mats, B, L, L, device=dev)
    kern = fn(it, ot, il, ol).cpu().numpy()
    batch = [torch.from_numpy(x).to(dev) for x in (it, ot, il, ol)]
    plain = lk.lowrank_forward_plain(ops, *batch).cpu().numpy()
    ref = f64_scores(mats, [(it[b][:il[b]], ot[b][:ol[b]]) for b in range(B)])
    err_plain, err_f64 = score_err(kern, plain), score_err(kern, ref)
    emit({"phase": "kernel_vs_plain", "kernel": "lowrank_wavefront",
          "case": "dense64_streamed", "B": B, "Li": L, "Lo": L, "Sa": ops.Sa,
          "classes": [[c.name, c.side, c.rank] for c in ops.classes],
          "factor_bytes": ops.n_mt * ops.slab * 4, "launch": cfg,
          "max_abs_vs_plain": err_plain, "max_abs_vs_f64": err_f64})
    check(err_plain <= KERNEL_VS_PLAIN_TOL,
          "dense64_streamed: kernel vs plain %.3g nats" % err_plain)
    check(err_f64 <= KERNEL_VS_F64_TOL,
          "dense64_streamed: kernel vs f64 %.3g nats" % err_f64)


def tf32_bounds(flops, nbytes, kernel_ms):
    """A 3xTF32 kernel's bound (lowrank, factored) twice: against the f32
    FMA rate (the function's own arithmetic) and against the rate its
    design runs at (3xTF32: 3 x the FLOP over the TF32 tensor peak); each
    with the kernel's share of it. The kernels line takes the lesser
    bound."""
    f32_ms, f32_by = bound(flops, nbytes)
    tf32_ms = max(3.0 * flops / TF32_FLOPS, nbytes / HBM_BYTES_PER_S) * 1e3
    return {"bound_f32_ms": f32_ms, "bound_f32_by": f32_by,
            "share_of_f32_bound": f32_ms / kernel_ms,
            "bound_3xtf32_ms": tf32_ms,
            "share_of_3xtf32_bound": tf32_ms / kernel_ms}


def lowered(machine):
    """Log-space matrices_2d of a machine, numpy float32."""
    from machineboss_tpu_torch.core.eval import EvaluatedMachine
    from machineboss_tpu_torch.ops.lowering import LoweredMachine
    ev = EvaluatedMachine(machine, machine.get_param_defs(True))
    return tuple(np.asarray(x) for x in
                 LoweredMachine(ev, dtype=np.float32).matrices_2d())


# walk_pair's layouts besides the plan's (wavefront_kernel.walk_launch_plan):
# every lattice cell, the separate rescale pass, each place of the slots
WALK_LAYOUTS = ({"live_range": False}, {"rescale_pass": True},
                {"slots": "shared"}, {"slots": "global"},
                {"live_range": False, "rescale_pass": True,
                 "slots": "global"})


def walk_variants(cfg):
    """The walk's variants that undo one choice of the plan `cfg`: every
    lattice cell's lanes, the separate rescale pass, the slots in the
    other memory."""
    out = {"no_live_range": {"live_range": False}}
    if not cfg["rescale_pass"]:
        out["rescale_pass"] = {"rescale_pass": True}
    other = "global" if cfg["slots"] == "shared" else "shared"
    out["slots_" + other] = {"slots": other}
    return out


def fullrank_case(name, mats, it, ot, il, ol, dev, ragged=False, grid=None,
                  f64_tol=MERGED_VS_F64_TOL):
    """merged (or, ragged=True, chained_ragged) kernel vs plain vs f64; the
    kernel in every walk layout bit-equal to its default."""
    from machineboss_tpu_torch.ops.kernels import wavefront_kernel as wk
    ops = wk.merged_operands(wk.prepare_merged(*mats), dev)
    batch = [torch.from_numpy(np.ascontiguousarray(x, np.int32)).to(dev)
             for x in (it, ot, il, ol)]
    wrapper = wk.chained_ragged_wavefront if ragged else wk.merged_wavefront
    kern = wrapper(ops, *batch, grid=grid).cpu().numpy()
    plain = (wk.chained_ragged_forward_plain if ragged
             else wk.merged_forward_plain)(ops, *batch).cpu().numpy()
    for layout in WALK_LAYOUTS:
        other = wrapper(ops, *batch, grid=grid, **layout).cpu().numpy()
        check(np.array_equal(other, kern, equal_nan=True),
              "%s: walk layout %s scores otherwise" % (name, layout))
    ref = f64_scores(mats, [(it[b][:il[b]], ot[b][:ol[b]])
                            for b in range(len(il))])
    err_plain = score_err(kern, plain)
    err_f64 = score_err(kern, ref)
    emit({"phase": "kernel_vs_plain",
          "kernel": "chained_ragged_wavefront" if ragged
          else "merged_wavefront", "case": name, "B": len(il),
          "Li": it.shape[1], "Lo": ot.shape[1], "Sa": ops.Sa,
          "sink": ops.sink, "classes": ops.names, "grid": grid,
          "max_abs_vs_plain": err_plain, "max_abs_vs_f64": err_f64,
          "n_impossible": int((ref <= NEG).sum())})
    check(err_plain <= KERNEL_VS_PLAIN_TOL,
          "%s: kernel vs plain %.3g nats" % (name, err_plain))
    check(err_f64 <= f64_tol, "%s: kernel vs f64 %.3g nats" % (name, err_f64))


def fullrank_cases(dev):
    from machineboss_tpu_torch.testmachines import (
        build_allclass_transducer, build_indel_transducer,
        build_random_transducer)

    def toks(seed, n_sym, B, L):
        rng = np.random.RandomState(seed)
        return (rng.randint(0, n_sym, (B, L)).astype(np.int32),
                rng.randint(0, n_sym, (B, L)).astype(np.int32), rng)

    # all three classes, ragged lengths (the unified left fold on the TPU)
    mats = lowered(build_allclass_transducer(5, list("AC")))
    it, ot, _ = toks(8, 2, 6, 7)
    fullrank_case("allclass", mats, it, ot, np.array([7, 4, 6, 7, 7, 7]),
                  np.array([7, 6, 3, 7, 7, 7]), dev)
    # empty sides and single cells
    fullrank_case("edges", mats, it, ot, np.array([0, 0, 5, 1, 1, 0]),
                  np.array([0, 5, 0, 1, 0, 1]), dev)
    # no diag class
    mats = lowered(build_indel_transducer(6, list("ACGT")))
    it, ot, _ = toks(4, 4, 6, 6)
    full = np.full(6, 6)
    fullrank_case("indel", mats, it, ot, full, full, dev)
    # diag only, one block walking every pair in turn
    mats = lowered(build_random_transducer(8, list("ACGT"), seed=15))
    it, ot, _ = toks(6, 4, 2, 20)
    fullrank_case("dense8_one_block", mats, it, ot, np.full(2, 20),
                  np.full(2, 20), dev, grid=1)
    # ragged schedule on a small dense machine
    mats = lowered(build_random_transducer(6, list("ACGT"), seed=3))
    it, ot, rng = toks(1, 4, 8, 14)
    il = rng.randint(7, 15, 8)
    fullrank_case("ragged_dense", mats, it, ot, il, il, dev, ragged=True)
    # the odd-start deep chain: 64 states, L=100, the third pair passes
    # -87.9 nats; once over the grid, once with ONE block that walks the
    # long pair and then the two short ones on the same slots
    mats = lowered(build_random_transducer(64, list("ACGT"), seed=42))
    it, ot, _ = toks(1, 4, 4, 100)
    il = np.array([56, 53, 99])
    for grid in (None, 1):
        fullrank_case("odd_start" + ("_one_block" if grid else ""), mats,
                      it[:3], ot[:3], il, il, dev, ragged=True, grid=grid,
                      f64_tol=ODD_START_VS_F64_TOL)


def scan1d_cases(dev):
    from machineboss_tpu_torch.core.eval import EvaluatedMachine
    from machineboss_tpu_torch.ops.kernels import scan1d_kernel as sk
    from machineboss_tpu_torch.ops.lowering import LoweredMachine
    from machineboss_tpu_torch.testmachines import (build_generator_1d,
                                                    forward_1d_f64)
    for name, S, B, L, seed in (("long", 6, 6, 150, 2), ("wide", 40, 3, 70, 3)):
        m = build_generator_1d(S, seed=seed)
        ev = EvaluatedMachine(m, m.get_param_defs(True))
        trans, closure = (np.asarray(x) for x in LoweredMachine(
            ev, dtype=np.float32).emit_matrices_1d(output_side=True))
        rng = np.random.RandomState(seed)
        toks = rng.randint(0, 4, (B, L)).astype(np.int32)
        lens = rng.randint(L // 2, L + 1, B).astype(np.int32)
        lens[0], lens[1] = L, 0
        toks[2, lens[2]:] = -1              # padding past the end
        if name == "long":
            toks[3, 40], lens[3] = 4, L     # outside the alphabet: dead
        ops = sk.scan1d_operands(*sk.prepare_scan1d(trans, closure), dev)
        t = torch.from_numpy(toks).to(dev)
        n = torch.from_numpy(lens).to(dev)
        errs = []
        for threads in (None, 32, 128):
            kern = sk.scan1d_forward(ops, t, n, threads=threads)
            plain = sk.scan1d_forward_plain(ops, t, n)
            torch.cuda.synchronize()
            check(torch.equal(kern[1:], plain[1:]),
                  "%s: exponents or dead flags differ" % name)
            kll = sk.scan1d_loglike(kern.cpu().numpy(), lens, ops.g)
            pll = sk.scan1d_loglike(plain.cpu().numpy(), lens, ops.g)
            errs.append(score_err(kll, pll))
        ref = forward_1d_f64(trans, closure, toks, lens)
        err_f64 = score_err(kll, ref)
        emit({"phase": "kernel_vs_plain", "kernel": "scan1d", "case": name,
              "B": B, "L": L, "S": ops.S, "max_abs_vs_plain": max(errs),
              "max_abs_vs_f64": err_f64,
              "n_impossible": int((ref <= NEG).sum())})
        check(max(errs) <= KERNEL_VS_PLAIN_TOL,
              "%s: kernel vs plain %.3g nats" % (name, max(errs)))
        check(err_f64 <= SCAN1D_VS_F64_TOL,
              "%s: kernel vs f64 %.3g nats" % (name, err_f64))


def counts():
    from machineboss_tpu_torch.algo import traceback_device as tb
    from machineboss_tpu_torch.ops.kernels import fused_plan7_kernel as fk
    from machineboss_tpu_torch.ops.kernels import lowrank_kernel as lk
    from machineboss_tpu_torch.ops.kernels import row_kernel as rk
    from machineboss_tpu_torch.ops.kernels import scan1d_kernel as sk
    from machineboss_tpu_torch.ops.kernels import viterbi_kernel as vk
    from machineboss_tpu_torch.ops.kernels import wavefront_kernel as wk
    return {"lowrank_wavefront": lk.lowrank_wavefront,
            "lowrank_chained_wavefront": lk.lowrank_chained_wavefront,
            "merged_wavefront": wk.merged_wavefront,
            "chained_ragged_wavefront": wk.chained_ragged_wavefront,
            "chained_wavefront": wk.chained_wavefront,
            "generic_wavefront": wk.generic_wavefront,
            "seqscale_wavefront": wk.seqscale_wavefront,
            "factored_wavefront": wk.factored_wavefront,
            "scan1d": sk.scan1d_forward,
            "viterbi_wavefront": vk.viterbi_wavefront,
            "viterbi_banded_wavefront": vk.viterbi_banded_wavefront,
            "lattice_walk": tb.lattice_walk,
            "fused_plan7": fk.fused_plan7_forward_kernel,
            "row_scan": rk.row_scan}


def drive(name, cm, pairs, kernel, route):
    """One path through log_forward_batch: every launch count set to 0
    just before the first call and read just after; the path's kernel must
    have been launched once and no other kernel at all. Then the call's
    median of 5. Returns (scores, launches, first call s, call ms)."""
    wrappers = counts()
    for w in wrappers.values():
        w.launches = 0
    t0 = time.perf_counter()
    lls = cm.log_forward_batch(pairs)
    first_s = time.perf_counter() - t0
    got = {k: w.launches for k, w in wrappers.items()}
    check(got == {k: int(k == kernel) for k in wrappers},
          "%s: launches %s, expected one of %s" % (name, got, kernel))
    check(cm.last_route == route, "%s took route %s, expected %s"
          % (name, cm.last_route, route))
    check(lls.shape == (len(pairs),) and np.isfinite(lls).all()
          and (lls > NEG).all(), "%s: scores not all finite" % name)
    call_s = []
    for _ in range(5):
        before = wrappers[kernel].launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        again = cm.log_forward_batch(pairs)
        torch.cuda.synchronize()
        call_s.append(time.perf_counter() - t0)
        check(wrappers[kernel].launches == before + 1,
              "%s: a call did not launch %s once" % (name, kernel))
    check(np.array_equal(again, lls), "%s: a repeated call differs" % name)
    return lls, got[kernel], first_s, float(np.median(call_s)) * 1e3


def bound(flops, nbytes):
    ops_s, bytes_s = flops / F32_FMA_FLOPS, nbytes / HBM_BYTES_PER_S
    return (max(ops_s, bytes_s) * 1e3,
            "operations" if ops_s >= bytes_s else "bytes")


def tensor_bytes(tensors):
    return float(sum(t.numel() * t.element_size() for t in tensors))


def dense_path(name, cm, pairs, ragged, dev, card, smi):
    """A full-rank 2D path at full width: merged on a uniform batch,
    chained_ragged on a ragged one."""
    from machineboss_tpu_torch.ops.fwdback import pad_bucket
    from machineboss_tpu_torch.ops.kernels import wavefront_kernel as wk
    kernel = "chained_ragged_wavefront" if ragged else "merged_wavefront"
    wrapper = wk.chained_ragged_wavefront if ragged else wk.merged_wavefront
    plain_fn = wk.chained_ragged_forward_plain if ragged \
        else wk.merged_forward_plain
    lls, launches, first_s, call_ms = drive(
        name, cm, pairs, kernel, "chained_ragged" if ragged else "merged")
    toks = [(cm.in_toks(i), cm.out_toks(o)) for i, o in pairs]
    mats = cm._host_mats()
    n_gate = 8
    gate = score_err(lls[:n_gate], f64_scores(mats, toks[:n_gate],
                                              key=(name, n_gate)))
    check(gate <= GATE_TOL, "%s: f64 gate %.3g nats" % (name, gate))

    # the kernel alone, and its plain version, at the path's shapes
    ops = wk.merged_operands(wk.prepare_merged(*mats), dev)
    Li = pad_bucket(max(len(t[0]) for t in toks), base=16)
    Lo = pad_bucket(max(len(t[1]) for t in toks), base=16)
    batch = padded_batch(toks, Li, Lo, dev)
    kern = wrapper(ops, *batch).cpu().numpy()
    check(score_err(kern, lls) == 0.0, "%s: kernel alone differs from the "
          "path" % name)
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    plain = plain_fn(ops, *batch)
    t1.record()
    torch.cuda.synchronize()
    plain_ms = t0.elapsed_time(t1)
    err = score_err(kern, plain.cpu().numpy())
    check(err <= KERNEL_VS_PLAIN_TOL,
          "%s: kernel vs plain %.3g nats" % (name, err))
    kernel_ms = cuda_ms(lambda: wrapper(ops, *batch), 5)
    layout = wk.walk_launch_config(ops, len(pairs), Li)
    variants = design_variants(wrapper, ops, batch, kern,
                               walk_variants(layout))

    # least time for this run's work: a cell does Sa*Sa MACs for each
    # present class whose neighbour lies in the pair's lattice and can be
    # reached (the kernel takes no product for a zero neighbour); tokens,
    # lengths, class blocks and scores move once
    il = np.array([len(t[0]) for t in toks], np.float64)
    ol = np.array([len(t[1]) for t in toks], np.float64)
    flops = variant_flops(kernel, ops, il, ol)
    flops_all = variant_flops(kernel, ops, il, ol, all_cells=True)
    nbytes = tensor_bytes(batch + list(ops.mats.values())
                          + [ops.c0, ops.w]) + len(pairs) * 4
    bound_ms, bound_by = bound(flops, nbytes)
    S = mats[3].shape[0]
    state_cells = float(((il + 1) * (ol + 1)).sum()) * S
    emit({"phase": name, "B": len(pairs), "S": S, "Sa": ops.Sa,
          "classes": ops.names, "lens": [int(il.min()), int(il.max())],
          "padded": [Li, Lo], "route": cm.last_route, "launches": launches,
          "f64_gate_max_abs": gate, "f64_gate_pairs": n_gate,
          "first_call_s": first_s, "call_ms_median5": call_ms,
          "kernel_ms": kernel_ms, "plain_ms": plain_ms,
          "kernel_share_of_call": kernel_ms / call_ms,
          "state_cells_per_s": state_cells / (call_ms / 1e3),
          "kernel_state_cells_per_s": state_cells / (kernel_ms / 1e3),
          "flops": flops, "bytes": nbytes, "bound_ms": bound_ms,
          "bound_by": bound_by, "kernel_share_of_bound": bound_ms / kernel_ms,
          "flops_all_cells": flops_all,
          "bound_all_cells_ms": bound(flops_all, nbytes)[0],
          "launch": layout, "variants_ms": variants,
          "card": card, "nvidia_smi": smi})
    return {"name": kernel, "route": "cuda",
            "source": "machineboss_tpu_torch/csrc/%s.cu" % kernel,
            "replaces": "machineboss_tpu/ops/pallas/wavefront_kernel.py:%s"
            % ("489 (_chained_ragged_kernel)" if ragged
               else "40 (_merged_kernel)"),
            "launches": launches, "max_abs_err": err, "ms": kernel_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None}


def merged_every_cell(x, y, lens, dev, card, smi):
    """The merged and chained_ragged kernels alone where every cell is
    live: the all-class 64-state ACGT machine (its class blocks take 384
    KB) on dense_uniform's pairs (B=512, 200x200) and dense_ragged's
    lengths, each held to its plain version and to the f64 oracle on 4
    pairs, timed, with the walk's variants. Measurement, not a path."""
    from machineboss_tpu_torch.ops.kernels import wavefront_kernel as wk
    from machineboss_tpu_torch.testmachines import build_allclass_transducer
    mats = lowered(build_allclass_transducer(64, list("ACGT")))
    ops = wk.merged_operands(wk.prepare_merged(*mats), dev)
    tok = {c: k for k, c in enumerate("ACGT")}
    it = np.vectorize(tok.get)(x).astype(np.int32)
    ot = np.vectorize(tok.get)(y).astype(np.int32)
    B, L = it.shape
    out = {}
    for kernel, wrapper, plain_fn, il in (
            ("merged_wavefront", wk.merged_wavefront,
             wk.merged_forward_plain, np.full(B, L, np.int32)),
            ("chained_ragged_wavefront", wk.chained_ragged_wavefront,
             wk.chained_ragged_forward_plain, np.asarray(lens, np.int32))):
        batch = [torch.from_numpy(np.ascontiguousarray(v)).to(dev)
                 for v in (it, ot, il, il)]
        kern = wrapper(ops, *batch).cpu().numpy()
        plain_ms, plain = event_ms(lambda: plain_fn(ops, *batch))
        err = score_err(kern, plain.cpu().numpy())
        check(err <= KERNEL_VS_PLAIN_TOL, "merged_every_cell %s: kernel vs "
              "plain %.3g nats" % (kernel, err))
        n_gate = 4
        gate = score_err(kern[:n_gate], f64_scores(
            mats, [(it[b, :il[b]], ot[b, :il[b]]) for b in range(n_gate)]))
        check(gate <= GATE_TOL, "merged_every_cell %s: f64 gate %.3g nats"
              % (kernel, gate))
        kernel_ms = cuda_ms(lambda: wrapper(ops, *batch), 5)
        layout = wk.walk_launch_config(ops, B, L)
        variants = design_variants(wrapper, ops, batch, kern,
                                   walk_variants(layout))
        flops = variant_flops(kernel, ops, il, il)
        nbytes = tensor_bytes(batch + list(ops.mats.values())
                              + [ops.c0, ops.w]) + B * 4
        bound_ms, bound_by = bound(flops, nbytes)
        emit({"phase": "merged_every_cell", "kernel": kernel, "B": B,
              "Sa": ops.Sa, "classes": ops.names,
              "class_block_bytes": tensor_bytes(list(ops.mats.values())),
              "lens": [int(il.min()), int(il.max())], "kernel_ms": kernel_ms,
              "plain_ms": plain_ms, "max_abs_vs_plain": err,
              "f64_gate_max_abs": gate, "f64_gate_pairs": n_gate,
              "flops": flops, "bytes": nbytes, "bound_ms": bound_ms,
              "bound_by": bound_by,
              "kernel_share_of_bound": bound_ms / kernel_ms,
              "flops_all_cells": variant_flops(kernel, ops, il, il, True),
              "launch": layout, "variants_ms": variants, "card": card,
              "nvidia_smi": smi})
        out[kernel] = kernel_ms
    return out


def scan1d_layout(name, ops, B):
    """The scan kernel's launch plan for B sequences, its shared bytes
    checked against the kernel's own count."""
    from machineboss_tpu_torch.ops.kernels import scan1d_kernel as sk
    cfg = sk.scan1d_launch_config(ops, B)
    check(sk.scan1d_smem_bytes_on_card(ops, cfg) == cfg["smem"],
          "%s: the scan's shared layout differs from the plan's" % name)
    return cfg


def scan1d_vs_plain(name, kern, plain, lens, g):
    """Hold a scan result to the plain version's: exponents and dead flags
    equal, log-likelihoods within KERNEL_VS_PLAIN_TOL. Returns the error."""
    from machineboss_tpu_torch.ops.kernels import scan1d_kernel as sk
    check(torch.equal(kern[1:], plain[1:]),
          "%s: exponents or dead flags differ from the plain version" % name)
    err = score_err(sk.scan1d_loglike(kern.cpu().numpy(), lens, g),
                    sk.scan1d_loglike(plain.cpu().numpy(), lens, g))
    check(err <= KERNEL_VS_PLAIN_TOL,
          "%s: kernel vs plain %.3g nats" % (name, err))
    return err


# the scan's variants that undo one design choice: dense columns (every
# entry's multiply-add), a block barrier a step, the tokens read from
# global memory, the renormalisation behind a barrier of its own
SCAN1D_VARIANTS = {"dense_columns": {"mode": "dense"},
                   "sparse_lists": {"mode": "csr"},
                   "block_barrier": {"variant": "block_barrier"},
                   "tokens_global": {"variant": "tokens_global"},
                   "renorm_barrier": {"variant": "renorm_barrier"}}


def scan1d_variants(ops, t, n, lens, plain, layout):
    """The scan kernel against its variants in turns (default, variant,
    variant, default), each held to the plain version as the kernel is;
    the variant the plan already is is skipped. Returns {variant: {which:
    [ms, ms]}}."""
    from machineboss_tpu_torch.ops.kernels import scan1d_kernel as sk
    out = {}
    for label, kw in SCAN1D_VARIANTS.items():
        if kw.get("mode") == layout["mode"].split("_")[0]:
            continue
        times = {"default": [], label: []}
        for which in ("default", label, label, "default"):
            args = kw if which == label else {}
            scan1d_vs_plain("scan1d " + which, sk.scan1d_forward(
                ops, t, n, **args), plain, lens, ops.g)
            times[which].append(cuda_ms(
                lambda: sk.scan1d_forward(ops, t, n, **args), 3))
        out[label] = times
    return out


def scan1d_bounds(ops, toks, lens, t, n, kernel_ms):
    """The scan's least time on this run's data: 2 x the multiply-adds of
    the nonzero entries of each real position's token matrix (a token
    outside the alphabet or a skipped position takes none), the tokens,
    lengths, matrices and the (3, B) result moved once; beside it the
    dense count, S * S a position."""
    nnz = np.append((ops.em_host != 0).sum(axis=(1, 2)), 0)
    pos = np.arange(toks.shape[1])[None, :] < lens[:, None]
    tk = np.where(pos & (toks >= 0), toks, -1)
    tk = np.where(tk >= ops.n_tok, -1, tk)
    flops = 2.0 * float(nnz[tk].sum())
    flops_dense = 2.0 * ops.S * ops.S * float(lens.sum())
    nbytes = tensor_bytes([t, n, ops.em, ops.c0]) + 3 * len(lens) * 4
    bound_ms, bound_by = bound(flops, nbytes)
    return {"flops": flops, "bytes": nbytes, "bound_ms": bound_ms,
            "bound_by": bound_by, "kernel_share_of_bound": bound_ms / kernel_ms,
            "flops_dense": flops_dense,
            "bound_dense_ms": bound(flops_dense, nbytes)[0]}


def scan1d_every_entry(dev, card, smi):
    """The scan kernel alone where every entry of the transfer tensor is
    finite: a seeded (4, 64, 64) tensor, B=256 sequences of 10,000, held
    to the plain version and to the float64 loop on 8 sequences, timed,
    with its variants. Measurement, not a path."""
    from machineboss_tpu_torch.ops.kernels import scan1d_kernel as sk
    from machineboss_tpu_torch.testmachines import forward_1d_f64
    S, B, L = 64, 256, 10000
    rng = np.random.RandomState(7)
    trans = rng.uniform(-6.0, -2.0, (4, S, S)).astype(np.float32)
    with np.errstate(divide="ignore"):
        closure = np.log(np.eye(S, dtype=np.float32))
    toks = rng.randint(0, 4, (B, L)).astype(np.int32)
    lens = np.full(B, L, np.int32)
    ops = sk.scan1d_operands(*sk.prepare_scan1d(trans, closure), dev)
    check(int((ops.em_host != 0).sum()) == 4 * S * S,
          "scan1d_every_entry: an entry is zero")
    t = torch.from_numpy(toks).to(dev)
    n = torch.from_numpy(lens).to(dev)
    layout = scan1d_layout("scan1d_every_entry", ops, B)
    kern = sk.scan1d_forward(ops, t, n)
    plain_ms, plain = event_ms(lambda: sk.scan1d_forward_plain(ops, t, n))
    err = scan1d_vs_plain("scan1d_every_entry", kern, plain, lens, ops.g)
    kll = sk.scan1d_loglike(kern.cpu().numpy(), lens, ops.g)
    n_gate = 8
    gate = score_err(kll[:n_gate], forward_1d_f64(
        trans, closure, toks[:n_gate], lens[:n_gate]))
    check(gate <= GATE_TOL, "scan1d_every_entry: f64 gate %.3g nats" % gate)
    kernel_ms = cuda_ms(lambda: sk.scan1d_forward(ops, t, n), 5)
    variants = scan1d_variants(ops, t, n, lens, plain, layout)
    emit({"phase": "scan1d_every_entry", "B": B, "L": L, "S": ops.S,
          "kernel_ms": kernel_ms, "plain_ms": plain_ms,
          "ns_per_step": kernel_ms * 1e6 / L, "max_abs_vs_plain": err,
          "f64_gate_max_abs": gate, "f64_gate_pairs": n_gate,
          **scan1d_bounds(ops, toks, lens, t, n, kernel_ms),
          "launch": layout, "variants_ms": variants, "card": card,
          "nvidia_smi": smi})


def dense1d_path(dev, card, smi):
    """The 1D path at full width: a random 64-state generator, 256
    sequences of 10,000."""
    from machineboss_tpu_torch.dispatch import CompiledMachine
    from machineboss_tpu_torch.ops.fwdback import pad_bucket
    from machineboss_tpu_torch.ops.kernels import scan1d_kernel as sk
    from machineboss_tpu_torch.testmachines import (build_generator_1d,
                                                    forward_1d_f64)
    S, B, L = 64, 256, 10000
    rng = np.random.RandomState(42)
    cm = CompiledMachine(build_generator_1d(S, rng=rng), device=dev)
    sym = np.array(list("ACGT"))
    pairs = [("", "".join(sym[rng.randint(0, 4, L)])) for _ in range(B)]
    lls, launches, first_s, call_ms = drive("dense1d", cm, pairs, "scan1d",
                                            "scan1d")
    trans, closure = cm._cache[("1d_mats", True)]
    Lp = pad_bucket(L, base=16)
    toks = np.zeros((B, Lp), np.int32)
    for n, (_, o) in enumerate(pairs):
        toks[n, :L] = cm.out_toks(o)
    lens = np.full(B, L, np.int32)
    n_gate = 8
    gate = score_err(lls[:n_gate], forward_1d_f64(
        trans, closure, toks[:n_gate], lens[:n_gate]))
    check(gate <= GATE_TOL, "dense1d: f64 gate %.3g nats" % gate)

    ops = sk.scan1d_operands(*sk.prepare_scan1d(trans, closure), dev)
    t = torch.from_numpy(toks).to(dev)
    n = torch.from_numpy(lens).to(dev)
    kern = sk.scan1d_forward(ops, t, n)
    kll = sk.scan1d_loglike(kern.cpu().numpy(), lens, ops.g)
    check(score_err(kll, lls) == 0.0, "dense1d: kernel alone differs from "
          "the path")
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    plain = sk.scan1d_forward_plain(ops, t, n)
    t1.record()
    torch.cuda.synchronize()
    plain_ms = t0.elapsed_time(t1)
    err = scan1d_vs_plain("dense1d", kern, plain, lens, ops.g)
    kernel_ms = cuda_ms(lambda: sk.scan1d_forward(ops, t, n), 5)
    layout = scan1d_layout("dense1d", ops, B)
    variants = scan1d_variants(ops, t, n, lens, plain, layout)

    bounds = scan1d_bounds(ops, toks, lens, t, n, kernel_ms)
    cells = float(lens.sum()) * ops.S
    emit({"phase": "dense1d", "B": B, "L": L, "S": ops.S, "padded": Lp,
          "route": cm.last_route, "launches": launches,
          "f64_gate_max_abs": gate, "f64_gate_pairs": n_gate,
          "first_call_s": first_s, "call_ms_median5": call_ms,
          "kernel_ms": kernel_ms, "plain_ms": plain_ms,
          "ns_per_step": kernel_ms * 1e6 / L,
          "kernel_share_of_call": kernel_ms / call_ms,
          "state_cells_per_s": cells / (call_ms / 1e3),
          "kernel_state_cells_per_s": cells / (kernel_ms / 1e3),
          **bounds, "launch": layout, "variants_ms": variants,
          "card": card, "nvidia_smi": smi})
    bound_ms, bound_by = bounds["bound_ms"], bounds["bound_by"]
    return {"name": "scan1d", "route": "cuda",
            "source": "machineboss_tpu_torch/csrc/scan1d.cu",
            "replaces": "machineboss_tpu/ops/pallas/scan1d_kernel.py:46 "
                        "(_scan1d_kernel)",
            "launches": launches, "max_abs_err": err, "ms": kernel_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None}


# ------------------------------------------ the other 2D Forward variants

WAVE = "machineboss_tpu/ops/pallas/wavefront_kernel.py:"
# kernel -> (what the TPU kernel was, the f64 bound of its small cases)
VARIANTS = {
    "chained_wavefront": (WAVE + "255 (_chained_kernel)", MERGED_VS_F64_TOL),
    "lowrank_chained_wavefront": (
        "machineboss_tpu/ops/pallas/lowrank_kernel.py:424 (_body_chained of "
        "_lowrank_kernel :188, chained mode)", KERNEL_VS_F64_TOL),
    "generic_wavefront": (WAVE + "1051 (_wavefront_kernel)",
                          MERGED_VS_F64_TOL),
    "seqscale_wavefront": (WAVE + "685 (_seqscale_kernel)",
                           MERGED_VS_F64_TOL),
    "factored_wavefront": (WAVE + "853 (_factored_kernel)",
                           KERNEL_VS_F64_TOL)}
CHAINED_KERNELS = ("chained_wavefront", "lowrank_chained_wavefront")


def variant_ops(kernel, mats, dev, grid=None, walkers=None, layout=None,
                rescale_every=None):
    """(operands, kernel call, plain call) of one variant kernel; both
    calls take (in_toks, out_toks, in_lens, out_lens, n_chain). `grid`
    sets the blocks of an unchained kernel or of chained_wavefront (None:
    its default), `walkers`
    the factored kernel's pairs a block, `layout` more keywords of the
    kernel's wrapper (the generic kernel's cells_per_warp and
    ct_resident), `rescale_every` the seqscale kernel's cadence, for both
    calls."""
    from machineboss_tpu_torch.ops.kernels import lowrank_kernel as lk
    from machineboss_tpu_torch.ops.kernels import wavefront_kernel as wk
    if kernel == "lowrank_chained_wavefront":
        plan, host = lk.prepare_lowrank(*mats, chained=True)
        ops = lk.lowrank_operands(plan, host, mats[0].shape[1], dev)
    elif kernel == "factored_wavefront":
        ops = wk.factored_operands(wk.prepare_factored(*mats), dev)
    else:
        prep = {"chained_wavefront": wk.prepare_merged,
                "generic_wavefront": wk.prepare_generic,
                "seqscale_wavefront": wk.prepare_seqscale}[kernel]
        ops = wk.merged_operands(prep(*mats), dev)
    wrapper, plain = {
        "chained_wavefront": (wk.chained_wavefront, wk.chained_forward_plain),
        "lowrank_chained_wavefront": (lk.lowrank_chained_wavefront,
                                      lk.lowrank_chained_forward_plain),
        "generic_wavefront": (wk.generic_wavefront, wk.generic_forward_plain),
        "seqscale_wavefront": (wk.seqscale_wavefront,
                               wk.seqscale_forward_plain),
        "factored_wavefront": (wk.factored_wavefront,
                               wk.factored_forward_plain)}[kernel]
    if kernel == "chained_wavefront":
        return (ops, lambda *b: wrapper(ops, *b[:4], n_chain=b[4], grid=grid,
                                        **(layout or {})),
                lambda *b: plain(ops, *b[:4], n_chain=b[4]))
    if kernel in CHAINED_KERNELS:
        return (ops, lambda *b: wrapper(ops, *b[:4], n_chain=b[4]),
                lambda *b: plain(ops, *b[:4], n_chain=b[4]))
    kw = dict(layout or {}, grid=grid)
    if walkers is not None:
        kw["walkers"] = walkers
    pkw = {}
    if rescale_every is not None:
        kw["rescale_every"] = pkw["rescale_every"] = rescale_every
    return (ops, lambda *b: wrapper(ops, *b[:4], **kw),
            lambda *b: plain(ops, *b[:4], **pkw))


def variant_case(kernel, name, mats, it, ot, il, ol, dev, chain=None,
                 bad=None, f64_tol=None, grid=None, bad_len=None,
                 walkers=None, layout=None, rescale_every=None):
    """One small case of a variant kernel: kernel vs plain vs the f64
    oracle (the chained kernels at the padded lengths, which they read
    out). `bad` = (pair, position) puts a token outside the alphabet into
    the kernel's input, `bad_len` = pair gives that pair an input length
    past the padded shape: such pairs must come back NaN, the others as
    the plain version gives them without the fault. The seqscale kernel
    must equal its plain version bit for bit."""
    _, run, plain = variant_ops(kernel, mats, dev, grid, walkers, layout,
                                rescale_every)
    if kernel in CHAINED_KERNELS:
        il = np.full(len(il), it.shape[1])
        ol = np.full(len(ol), ot.shape[1])
    batch = [torch.from_numpy(np.ascontiguousarray(x, np.int32)).to(dev)
             for x in (it, ot, il, ol)]
    kin = list(batch)
    if bad is not None:
        kin[0] = batch[0].clone()
        kin[0][bad] = 99
    if bad_len is not None:
        kin[2] = batch[2].clone()
        kin[2][bad_len] = it.shape[1] + 1
    kern = run(*kin, chain).cpu().numpy()
    ref_plain = plain(*batch, chain).cpu().numpy()
    live = np.ones(len(il), bool)
    if bad is not None:
        check(np.isnan(kern[bad[0]]), "%s %s: a bad token scored %r"
              % (kernel, name, kern[bad[0]]))
        live[bad[0]] = False
    if bad_len is not None:
        check(np.isnan(kern[bad_len]), "%s %s: a bad length scored %r"
              % (kernel, name, kern[bad_len]))
        live[bad_len] = False
    ref = f64_scores(mats, [(it[b][:il[b]], ot[b][:ol[b]])
                            for b in range(len(il))])
    err_plain = score_err(kern[live], ref_plain[live])
    err_f64 = score_err(kern[live], ref[live])
    emit({"phase": "kernel_vs_plain", "kernel": kernel, "case": name,
          "B": len(il), "Li": it.shape[1], "Lo": ot.shape[1], "chain": chain,
          "grid": grid, "walkers": walkers, "layout": layout,
          "rescale_every": rescale_every, "bad_token_nan": bad is not None,
          "bad_length_nan": bad_len is not None, "max_abs_vs_plain": err_plain,
          "max_abs_vs_f64": err_f64, "f64_range": [float(ref.min()),
                                                   float(ref.max())],
          "n_impossible": int((ref <= NEG).sum())})
    check(err_plain <= (SEQSCALE_VS_PLAIN_TOL if kernel == "seqscale_wavefront"
                        else KERNEL_VS_PLAIN_TOL),
          "%s %s: kernel vs plain %.3g nats" % (kernel, name, err_plain))
    tol = f64_tol or VARIANTS[kernel][1]
    check(err_f64 <= tol, "%s %s: kernel vs f64 %.3g nats"
          % (kernel, name, err_f64))
    return ref


def variant_cases(dev):
    """The five variant kernels against their plain versions, small, on
    the machines of the merged kernels' cases."""
    from machineboss_tpu_torch.core.presets import make_preset
    from machineboss_tpu_torch.testmachines import (
        build_allclass_transducer, build_indel_transducer,
        build_random_transducer, prot2dna_pairs)
    p2d = make_preset("prot2dna")
    ev = evaluated(p2d)

    def machine(kind):
        return {"indel": lambda: build_indel_transducer(6, list("ACGT")),
                "allclass": lambda: build_allclass_transducer(5, list("AC")),
                "dense8": lambda: build_random_transducer(8, list("ACGT"),
                                                         seed=15),
                "prot2dna": lambda: p2d}[kind]()

    def toks(kind, mats, B, Li, Lo, seed):
        if kind == "prot2dna":
            pairs = prot2dna_pairs(B, Li, seed=seed)
            return (np.array([[ev.input_tokenizer.sym2tok[c] - 1 for c in p]
                              for p, _ in pairs], np.int32),
                    np.array([[ev.output_tokenizer.sym2tok[c] - 1 for c in d]
                              for _, d in pairs], np.int32))
        rng = np.random.RandomState(seed)
        return (rng.randint(0, mats[1].shape[0], (B, Li)).astype(np.int32),
                rng.randint(0, mats[2].shape[0], (B, Lo)).astype(np.int32))

    shapes = {"indel": (6, 6), "allclass": (7, 7), "dense8": (12, 12),
              "prot2dna": (6, 18)}
    for kind in ("indel", "allclass", "dense8", "prot2dna"):
        mats = lowered(machine(kind))
        Li, Lo = shapes[kind]
        # uniform batches of 15 pairs: chains of 1, 3 and 5
        it, ot = toks(kind, mats, 15, Li, Lo, 15)
        full = np.full(15, Li), np.full(15, Lo)
        for kernel in CHAINED_KERNELS:
            for chain in (1, 3, 5):
                variant_case(kernel, "%s_c%d" % (kind, chain), mats, it, ot,
                             *full, dev, chain=chain,
                             bad=(4, 2) if chain == 3 else None)
        # chained: one block walks all 15 pairs, then two blocks, each pair
        # on its chain's offset, a bad token among them
        for grid in (1, 2):
            variant_case("chained_wavefront", "%s_c3_grid%d" % (kind, grid),
                         mats, it, ot, *full, dev, chain=3, bad=(4, 2),
                         grid=grid)
        # chained in every walk layout
        for layout in WALK_LAYOUTS:
            variant_case("chained_wavefront", "%s_c5_walk" % kind, mats, it,
                         ot, *full, dev, chain=5, bad=(4, 2), layout=layout)
        # ragged batches for the unchained kernels, with a bad token
        it, ot = toks(kind, mats, 8, Li, Lo, 8)
        rng = np.random.RandomState(3)
        il = rng.randint(1, Li + 1, 8)
        ol = 3 * il if kind == "prot2dna" else rng.randint(1, Lo + 1, 8)
        il[0], ol[0] = Li, Lo
        for kernel in ("generic_wavefront", "seqscale_wavefront",
                       "factored_wavefront"):
            variant_case(kernel, kind, mats, it, ot, il, ol, dev, bad=(5, 0))
            if kind == "allclass":
                # ONE block walks all 8 pairs: pairs after a bad token and
                # a bad length must score as the plain version scores them
                variant_case(kernel, kind + "_one_block", mats, it, ot, il,
                             ol, dev, bad=(2, 0), grid=1, bad_len=4)
    # empty sides and single cells
    mats = lowered(machine("allclass"))
    it, ot = toks("allclass", mats, 6, 7, 7, 8)
    for kernel in ("generic_wavefront", "seqscale_wavefront",
                   "factored_wavefront"):
        variant_case(kernel, "edges", mats, it, ot,
                     np.array([0, 0, 5, 1, 1, 0]),
                     np.array([0, 5, 0, 1, 0, 1]), dev)
    # impossible pairs: the diag-only dense8 scores no pair with il != ol
    mats = lowered(machine("dense8"))
    it, ot = toks("dense8", mats, 4, 6, 8, 2)
    for kernel in VARIANTS:
        ref = variant_case(kernel, "impossible", mats, it, ot,
                           np.array([6, 5, 6, 4]), np.array([8, 8, 6, 4]),
                           dev, chain=2 if kernel in CHAINED_KERNELS else None)
        check((ref[:2] <= NEG).all() if kernel not in CHAINED_KERNELS
              else (ref <= NEG).all(), "impossible: the pairs have a path")
    # the odd stagger: Lo odd, so sigma = Lo + 2 is odd and chain 1 starts
    # on an odd diagonal, every pair below -88 nats. chained: the 64-state
    # dense machine at 115 x 115; lowrank: prot2dna, 57 amino acids against
    # 171 bases (the lowrank factors of the dense machine cancel at this
    # depth: a machine of its own kind)
    dense64 = lowered(build_random_transducer(64, list("ACGT"), seed=42))
    for kernel, kind, mats, Li, Lo in (
            ("chained_wavefront", "dense64", dense64, 115, 115),
            ("lowrank_chained_wavefront", "prot2dna", lowered(p2d), 57, 171)):
        it, ot = toks(kind, mats, 3, Li, Lo, 1)
        for grid in ((None, 1) if kernel == "chained_wavefront" else (None,)):
            ref = variant_case(kernel, "odd_stagger", mats, it, ot,
                               np.full(3, Li), np.full(3, Lo), dev, chain=3,
                               f64_tol=ODD_START_VS_F64_TOL, grid=grid)
            check((ref < -88).all(), "odd_stagger: the scores are not deep")


def factored_cases(dev):
    """The factored kernel where its layout or its queue differs from the
    main path: fewer walkers than pairs (one and two a block) over a batch
    holding a bad token and a bad length; prot2dna pairs of 57 amino acids
    against 171 bases, every score below -88 nats; the scores equal bit for
    bit whatever the grid and the walkers."""
    from machineboss_tpu_torch.core.presets import make_preset
    from machineboss_tpu_torch.ops.kernels import wavefront_kernel as wk
    from machineboss_tpu_torch.testmachines import (build_allclass_transducer,
                                                    prot2dna_pairs)
    mats = lowered(build_allclass_transducer(5, list("AC")))
    rng = np.random.RandomState(8)
    B, L = 8, 12
    it = rng.randint(0, 2, (B, L)).astype(np.int32)
    ot = rng.randint(0, 2, (B, L)).astype(np.int32)
    il = rng.randint(4, L + 1, B).astype(np.int32)
    ol = rng.randint(4, L + 1, B).astype(np.int32)
    for grid in (1, 2):
        for walkers in (1, 2):
            variant_case("factored_wavefront", "allclass_grid%d" % grid, mats,
                         it, ot, il, ol, dev, bad=(2, 0), bad_len=5,
                         grid=grid, walkers=walkers)
    p2d = make_preset("prot2dna")
    ev = evaluated(p2d)
    mats = lowered(p2d)
    pairs = prot2dna_pairs(3, 57, seed=1)
    it = np.array([[ev.input_tokenizer.sym2tok[c] - 1 for c in p]
                   for p, _ in pairs], np.int32)
    ot = np.array([[ev.output_tokenizer.sym2tok[c] - 1 for c in d]
                   for _, d in pairs], np.int32)
    il, ol = np.full(3, 57), np.full(3, 171)
    ref = variant_case("factored_wavefront", "prot2dna_deep", mats, it, ot,
                       il, ol, dev)
    check((ref < -88).all(), "prot2dna_deep: the scores are not deep")
    ops = wk.factored_operands(wk.prepare_factored(*mats), dev)
    batch = [torch.from_numpy(np.ascontiguousarray(x, np.int32)).to(dev)
             for x in (it, ot, il, ol)]
    runs = [wk.factored_wavefront(ops, *batch, grid=g, walkers=w)
            .cpu().numpy() for g, w in ((None, None), (1, 2), (2, 1))]
    check(all(np.array_equal(r, runs[0]) for r in runs[1:]),
          "factored: the scores depend on the grid or the walkers")


def generic_seqscale_cases(dev):
    """The seqscale and generic kernels where their rules and layouts
    differ from the main path. seqscale at rescale_every 1, 2, 3 and 8 on
    the diag-only dense8 machine, with a pair that cannot be scored (its
    max is 0 on every diagonal: a factor of 1) and a bad token, equal to
    the plain version bit for bit; generic in each layout (one or two
    cells a warp, C^T in shared memory or through L1/L2) on the all-class
    machine and on the 65-state dense machine (68 padded states: a 4-state
    tail), each at grid 1 and 2 with a bad token and a bad length; and on
    all-class machines of 101, 131 and 301 states (more chunks a lane)."""
    from machineboss_tpu_torch.testmachines import (
        build_allclass_transducer, build_random_transducer)
    dense8 = lowered(build_random_transducer(8, list("ACGT"), seed=15))
    rng = np.random.RandomState(6)
    it = rng.randint(0, 4, (4, 20)).astype(np.int32)
    ot = rng.randint(0, 4, (4, 20)).astype(np.int32)
    il, ol = np.array([20, 17, 20, 20]), np.full(4, 20)
    for every in (1, 2, 3, 8):
        ref = variant_case("seqscale_wavefront", "dense8_every%d" % every,
                           dense8, it, ot, il, ol, dev, bad=(3, 5),
                           rescale_every=every)
        check(ref[1] <= NEG, "dense8: pair 1 has a path")
    for kind, mats, n_sym, B, L in (
            ("allclass", lowered(build_allclass_transducer(5, list("AC"))),
             2, 8, 12),
            ("dense64", lowered(build_random_transducer(64, list("ACGT"))),
             4, 4, 40)):
        rng = np.random.RandomState(9)
        it = rng.randint(0, n_sym, (B, L)).astype(np.int32)
        ot = rng.randint(0, n_sym, (B, L)).astype(np.int32)
        il = rng.randint(L // 2, L + 1, B)
        ol = il.copy() if kind == "dense64" else rng.randint(L // 2, L + 1, B)
        ol[0] = max(0, il[0] - 1)                 # dense64: cannot be scored
        for cells in (1, 2):
            for resident in (True, False):
                for grid in (1, 2):
                    variant_case(
                        "generic_wavefront", "%s_c%d_%s_grid%d" % (
                            kind, cells, "ct" if resident else "l2", grid),
                        mats, it, ot, il, ol, dev, bad=(2, 0), bad_len=3,
                        grid=grid, layout={"cells_per_warp": cells,
                                           "ct_resident": resident})
    # wider machines, every class present: 104 padded states (two cells a
    # warp: 26 chunks over 16 lanes, no tail), 132 (a 4-state tail, C^T
    # through L1/L2), 304 (4 chunks a lane)
    rng = np.random.RandomState(4)
    it = rng.randint(0, 2, (4, 6)).astype(np.int32)
    ot = rng.randint(0, 2, (4, 6)).astype(np.int32)
    il, ol = np.array([6, 4, 6, 0]), np.array([6, 6, 3, 5])
    for S, cells in ((100, 1), (100, 2), (130, 1), (130, 2), (300, 1)):
        variant_case("generic_wavefront", "allclass%d_c%d" % (S, cells),
                     lowered(build_allclass_transducer(S, list("AC"))), it,
                     ot, il, ol, dev, layout={"cells_per_warp": cells})


# the kernels that take no product for a zero cell (a neighbour whose log
# scale is NEG_INF, or a source row tagged all zero)
SKIPPING = ("merged_wavefront", "chained_ragged_wavefront",
            "chained_wavefront", "generic_wavefront", "seqscale_wavefront")


def variant_flops(kernel, ops, il, ol, all_cells=False):
    """2 x the multiply-adds of the variant's own recurrence on this run's
    real cells, at one token block per cell: a class counts at a cell whose
    neighbour of that class lies in the pair's lattice and, for the kernels
    that skip zero cells (unless `all_cells`), can be reached from (0, 0)."""
    il = np.asarray(il, np.float64)
    ol = np.asarray(ol, np.float64)
    nb_cells = {"up": ((il + 1) * ol).sum(), "left": (il * (ol + 1)).sum(),
                "diag": (il * ol).sum()}
    cells = float(((il + 1) * (ol + 1) - 1).sum())
    Sa = ops.Sa
    if kernel == "lowrank_chained_wavefront":
        return 2.0 * sum(c.rank * Sa * Sa for c in ops.classes) * cells
    if kernel == "factored_wavefront":
        return 2.0 * (sum(r * (Sa * Sa + Sa) * nb_cells[n]
                          for n, _, _, r in ops.classes) + Sa * Sa * cells)
    if kernel in SKIPPING and not all_cells:
        from machineboss_tpu_torch.ops.kernels.wavefront_kernel import \
            live_terms
        nb_cells, cells = live_terms(ops.names, il, ol)
    macs = Sa * Sa * sum(nb_cells[k] for k in ops.names)
    if kernel == "generic_wavefront":
        macs += Sa * Sa * cells                  # the closure product
    return 2.0 * macs


def design_variants(wrapper, ops, batch, kern, variants, fixed=None):
    """A kernel against variants that each undo one design choice, timed
    in turns (default, variant, variant, default), every one with the
    same scores bit for bit. `variants` maps a label to the wrapper's
    keywords, `fixed` holds keywords of every call. Returns {variant:
    {which: [ms, ms]}}."""
    out = {}
    for label, kw in variants.items():
        times = {"default": [], label: []}
        for which in ("default", label, label, "default"):
            args = dict(fixed or {}, **(kw if which == label else {}))
            other = wrapper(ops, *batch, **args).cpu().numpy()
            check(np.array_equal(other, kern, equal_nan=True),
                  "%s %s scores otherwise" % (wrapper.__name__, which))
            times[which].append(cuda_ms(lambda: wrapper(ops, *batch, **args),
                                        3))
        out[label] = times
    return out


# the variants of each redesigned kernel that undo one design choice
DESIGN_VARIANTS = {
    # one walker a block: no lockstep pair sharing the streamed tables
    "factored_wavefront": {"one_walker": {"walkers": 1}},
    # the first design's separate max pass and block reduction; the
    # products of the all-zero sources too
    "seqscale_wavefront": {"max_pass": {"max_pass": True},
                           "all_cells": {"skip_dead": False}},
    # C^T through L1/L2; a warp a cell (16 of its 32 lanes idle at S = 65);
    # both products of the zero cells too
    "generic_wavefront": {"ct_through_l2": {"ct_resident": False},
                          "one_cell_a_warp": {"cells_per_warp": 1},
                          "all_cells": {"skip_dead": False}}}


def factory_batch(toks):
    """(in_toks, out_toks, in_lens, out_lens) numpy arrays of (input,
    output) token lists, padded to the longest: a factory's inputs."""
    B = len(toks)
    Li = max(len(t[0]) for t in toks)
    Lo = max(len(t[1]) for t in toks)
    it, ot = np.zeros((B, Li), np.int32), np.zeros((B, Lo), np.int32)
    for n, (ti, to) in enumerate(toks):
        it[n, :len(ti)], ot[n, :len(to)] = ti, to
    il = np.array([len(t[0]) for t in toks], np.int32)
    ol = np.array([len(t[1]) for t in toks], np.int32)
    return it, ot, il, ol


def variant_path(name, kernel, cm, pairs, factory_kw, dev, card, smi,
                 gate_key, chains=(), merged_on_plan=False):
    """A variant kernel at full width through make_wavefront_forward: every
    launch count set to 0 just before the factory's function is first
    called and read just after (the path's kernel once, no other); the
    call's median of 5; the f64 gate on 8 pairs; the kernel alone by CUDA
    events, its plain version, the bound and the merged kernel's bound for
    the same batch. `chains`: other chain counts to time the kernel at;
    `merged_on_plan`: also time the merged kernel on this kernel's own
    (untrimmed, closure-folded) plan, the same function at the same state
    count. Returns the kernels line's entry."""
    from machineboss_tpu_torch.ops.kernels import _build
    from machineboss_tpu_torch.ops.kernels import lowrank_kernel as lk
    from machineboss_tpu_torch.ops.kernels import wavefront_kernel as wk
    toks = [(cm.in_toks(i), cm.out_toks(o)) for i, o in pairs]
    mats = cm._host_mats()
    it, ot, il, ol = factory_batch(toks)
    (B, Li), Lo = it.shape, ot.shape[1]
    fn = wk.make_wavefront_forward(*mats, B, Li, Lo, device=dev,
                                   **factory_kw)
    wrappers = counts()
    for w in wrappers.values():
        w.launches = 0
    t0 = time.perf_counter()
    lls = fn(it, ot, il, ol).cpu().numpy()
    first_s = time.perf_counter() - t0
    got = {k: w.launches for k, w in wrappers.items()}
    check(got == {k: int(k == kernel) for k in wrappers},
          "%s: launches %s, expected one of %s" % (name, got, kernel))
    check(lls.shape == (B,) and np.isfinite(lls).all() and (lls > NEG).all(),
          "%s: scores not all finite" % name)
    call_s = []
    for _ in range(5):
        before = wrappers[kernel].launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        again = fn(it, ot, il, ol).cpu().numpy()
        call_s.append(time.perf_counter() - t0)
        check(wrappers[kernel].launches == before + 1,
              "%s: a call did not launch %s once" % (name, kernel))
    check(np.array_equal(again, lls), "%s: a repeated call differs" % name)
    call_ms = float(np.median(call_s)) * 1e3
    n_gate = 8
    gate = score_err(lls[:n_gate], f64_scores(mats, toks[:n_gate],
                                              key=gate_key))
    check(gate <= GATE_TOL, "%s: f64 gate %.3g nats" % (name, gate))

    # the kernel alone, and its plain version, on the same inputs
    chain = factory_kw.get("chain")
    ops, run, plain = variant_ops(kernel, mats, dev)
    batch = [torch.from_numpy(x).to(dev) for x in (it, ot, il, ol)]
    kern = run(*batch, chain).cpu().numpy()
    check(score_err(kern, lls) == 0.0,
          "%s: kernel alone differs from the path" % name)
    plain_ms, ref_plain = event_ms(lambda: plain(*batch, chain))
    err = score_err(kern, ref_plain.cpu().numpy())
    check(err <= (SEQSCALE_VS_PLAIN_TOL if kernel == "seqscale_wavefront"
                  else KERNEL_VS_PLAIN_TOL),
          "%s: kernel vs plain %.3g nats" % (name, err))
    kernel_ms = cuda_ms(lambda: run(*batch, chain), 5)
    by_chain = {}
    for c in chains:
        other = run(*batch, c).cpu().numpy()
        check(score_err(other, kern) <= KERNEL_VS_PLAIN_TOL,
              "%s: chain %d scores otherwise" % (name, c))
        by_chain[str(c)] = cuda_ms(lambda: run(*batch, c), 5)
    if chains:
        by_chain[str(chain)] = kernel_ms
    merged_on_plan_ms = None
    if merged_on_plan:
        other = wk.merged_wavefront(ops, *batch).cpu().numpy()
        check(score_err(other, kern) <= KERNEL_VS_PLAIN_TOL,
              "%s: the merged kernel on this plan scores otherwise" % name)
        merged_on_plan_ms = cuda_ms(lambda: wk.merged_wavefront(ops, *batch),
                                    5)

    flops = variant_flops(kernel, ops, il, ol)
    # the kernel's operands as it reads them: tokens, lengths, the padded
    # start and readout vectors, the packed blocks or factors
    operands = [getattr(ops, k) for k in ("c0_pad", "w_pad", "mt", "e", "tk",
                                          "ek", "ct")
                if getattr(ops, k, None) is not None]
    if kernel == "lowrank_chained_wavefront":   # the factors, as the main path
        operands = [ops.c0] + [x for me in ops.mats for x in me]
    if kernel == "factored_wavefront":          # the plan's own tensors
        operands = [ops.c0, ops.w, ops.closure] + [
            x for c in ops.classes for x in c[1:3]]
    nbytes = tensor_bytes(batch + operands) + B * 4
    bound_ms, bound_by = bound(flops, nbytes)
    tf32_extra = {}
    if kernel == "lowrank_chained_wavefront":
        tf32_extra = tf32_bounds(flops, nbytes, kernel_ms)
        bound_ms = min(bound_ms, tf32_extra["bound_3xtf32_ms"])
        cfg = lk.launch_config(ops, B, Li, Lo)
        tf32_extra.update({"launch": cfg, "factors": "resident"
                           if cfg["resident"] else "streamed"})
    if kernel == "factored_wavefront":
        # both bounds of the whole function, and the one of the kernel's
        # own arithmetic: the class products on the f32 pipes, the closure
        # as 3xTF32 on the tensor cores (the kernels line takes this one)
        tf32_extra = tf32_bounds(flops, nbytes, kernel_ms)
        closure_flops = 2.0 * ops.Sa * ops.Sa * float(
            ((il + 1.0) * (ol + 1.0) - 1).sum())
        mixed_ms = max((flops - closure_flops) / F32_FMA_FLOPS
                       + 3.0 * closure_flops / TF32_FLOPS,
                       nbytes / HBM_BYTES_PER_S) * 1e3
        tf32_extra.update({"bound_own_arithmetic_ms": mixed_ms,
                           "share_of_own_arithmetic_bound":
                               mixed_ms / kernel_ms})
        bound_ms = mixed_ms
        cfg = wk.factored_launch_config(ops, B, Li, Lo)
        check(wk.factored_smem_bytes_on_card(ops, cfg, Li, Lo) == cfg["smem"],
              "%s: the kernel's shared layout differs from the plan's" % name)
        tf32_extra.update({
            "launch": cfg, "walkers": cfg["walkers"],
            "shared_bytes": cfg["smem"],
            "tables": "resident" if cfg["resident"] else "streamed",
            "table_bytes": tensor_bytes([ops.tab])})
    if kernel == "generic_wavefront":
        cfg = wk.generic_launch_plan(ops)
        check(wk.generic_smem_bytes_on_card(ops, cfg) == cfg["smem"],
              "%s: the kernel's shared layout differs from the plan's" % name)
        on_card = wk.generic_blocks_per_sm_on_card(ops, cfg)
        check(cfg["blocks_per_sm"] >= 4 and on_card >= 4,
              "%s: %d blocks a multiprocessor (the card: %d), not 4"
              % (name, cfg["blocks_per_sm"], on_card))
        tf32_extra.update({"launch": cfg, "blocks_per_sm_on_card": on_card,
                           "shared_bytes": cfg["smem"],
                           "ct_resident": cfg["ct_resident"]})
    if kernel in DESIGN_VARIANTS:
        tf32_extra["variants_ms"] = design_variants(
            counts()[kernel], ops, batch, kern, DESIGN_VARIANTS[kernel])
    if kernel == "chained_wavefront":
        # the strip schedule's block count: B / chain blocks walk the pairs
        cfg = wk.walk_launch_config(ops, B, Li)
        tf32_extra["variants_ms"] = design_variants(
            wk.chained_wavefront, ops, batch, kern,
            dict(walk_variants(cfg),
                 strip_block_count={"grid": B // chain}), {"n_chain": chain})
        tf32_extra.update({"grid": cfg["grid"], "launch": cfg})
    if kernel in SKIPPING:
        flops_all = variant_flops(kernel, ops, il, ol, all_cells=True)
        tf32_extra.update({"flops_all_cells": flops_all,
                           "bound_all_cells_ms": bound(flops_all,
                                                       nbytes)[0]})
    ptxas = [ln.strip() for ln in _build.build_logs.get(
        "lowrank_wavefront" if kernel == "lowrank_chained_wavefront"
        else kernel, "").splitlines() if "registers" in ln or "spill" in ln]
    merged = wk.merged_operands(wk.prepare_merged(*mats), dev)
    merged_flops = variant_flops("merged_wavefront", merged, il, ol)
    merged_bound_ms, _ = bound(merged_flops, nbytes)
    S = mats[3].shape[0]
    state_cells = float(((il + 1.0) * (ol + 1.0)).sum()) * S
    emit({"phase": name, "kernel": kernel, "B": B, "S": S, "Sa": ops.Sa,
          "shape": [Li, Lo], "factory": factory_kw, "launches": got[kernel],
          "f64_gate_max_abs": gate, "f64_gate_pairs": n_gate,
          "first_call_s": first_s, "call_ms_median5": call_ms,
          "kernel_ms": kernel_ms, "kernel_ms_by_chain": by_chain or None,
          "plain_ms": plain_ms, "kernel_vs_plain_max_abs": err,
          "kernel_share_of_call": kernel_ms / call_ms,
          "state_cells_per_s": state_cells / (call_ms / 1e3),
          "kernel_state_cells_per_s": state_cells / (kernel_ms / 1e3),
          "flops": flops, "bytes": nbytes, "bound_ms": bound_ms,
          "bound_by": bound_by, "kernel_share_of_bound": bound_ms / kernel_ms,
          "merged_flops": merged_flops, "merged_bound_ms": merged_bound_ms,
          "merged_kernel_ms_on_this_plan": merged_on_plan_ms,
          **tf32_extra, "ptxas": ptxas, "card": card, "nvidia_smi": smi})
    src = "lowrank_wavefront" if kernel == "lowrank_chained_wavefront" \
        else kernel
    return {"name": kernel, "route": "cuda", "path": name,
            "source": "machineboss_tpu_torch/csrc/%s.cu" % src,
            "replaces": VARIANTS[kernel][0], "launches": got[kernel],
            "max_abs_err": err, "ms": kernel_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}


# ---------------------------------------------------------------- alignment

def max_abs_diff(a, b):
    """max |a - b| of two float tensors of one shape (NEG_INF cells are
    equal bit for bit, so they contribute 0)."""
    check(a.shape == b.shape, "shapes %s vs %s" % (a.shape, b.shape))
    return float((a.double() - b.double()).abs().max()) if a.numel() else 0.0


def evaluated(machine):
    from machineboss_tpu_torch.core.eval import EvaluatedMachine
    return EvaluatedMachine(machine, machine.get_param_defs(True))


def maxplus_mats(ev, dtype=np.float32):
    from machineboss_tpu_torch.ops.lowering import LoweredMachine
    return tuple(np.asarray(x) for x in
                 LoweredMachine(ev, dtype=dtype).matrices_2d("maxplus"))


def ragged_batch(tok_in, tok_out, dev):
    """Padded int32 token and length tensors of a list of token arrays,
    padded as device_viterbi_matrices pads."""
    B = len(tok_in)
    Li = max([len(t) for t in tok_in] + [1])
    Lo = max([len(t) for t in tok_out] + [1])
    it = np.zeros((B, Li), np.int32)
    ot = np.zeros((B, Lo), np.int32)
    for b in range(B):
        it[b, :len(tok_in[b])] = tok_in[b]
        ot[b, :len(tok_out[b])] = tok_out[b]
    il = np.array([len(t) for t in tok_in], np.int32)
    ol = np.array([len(t) for t in tok_out], np.int32)
    return [torch.from_numpy(x).to(dev) for x in (it, ot, il, ol)], Li, Lo


def walk_equal(name, kern, plain):
    """The kernel's records against the plain walk's: n, ok, ij and vals
    equal exactly (unwritten slots keep their preset on both sides).
    Returns the measured difference: the largest |vals - vals| plus the
    number of entries of n, ij and ok that differ."""
    diff = 0.0
    for k, (a, b) in enumerate(zip(kern, plain)):
        a, b = a.cpu(), b.cpu()
        check(torch.equal(a, b),
              "%s: lattice walk differs from the plain walk in %s"
              % (name, ("n", "ij", "vals", "ok")[k]))
        if a.is_floating_point():
            diff += max_abs_diff(a, b)
        else:
            diff += float((a != b).sum())
    return diff


def viterbi_cases(dev):
    """The three alignment kernels against their plain versions, small."""
    from machineboss_tpu_torch.algo import traceback_device as tb
    from machineboss_tpu_torch.core.machine import Machine
    from machineboss_tpu_torch.core.seqpair import Envelope
    from machineboss_tpu_torch.ops.kernels import viterbi_kernel as vk
    from machineboss_tpu_torch.testmachines import (
        align_pair, build_allclass_transducer, build_indel_transducer,
        build_random_transducer)

    def full_case(name, machine, tok_in, tok_out, grid=None, walk=True,
                  **layout):
        ev = evaluated(machine)
        ops = vk.viterbi_operands(vk.maxplus_class_mats(*maxplus_mats(ev)),
                                  dev)
        batch, Li, Lo = ragged_batch(tok_in, tok_out, dev)
        kern = vk.viterbi_wavefront(ops, *batch, grid=grid, **layout)
        plain = vk.viterbi_forward_plain(ops, *batch)
        torch.cuda.synchronize()
        err = max_abs_diff(kern, plain)
        wk_ = None
        if walk:          # (a token outside the alphabet has no edges)
            walker = tb.make_lattice_walker(ev, Li, Lo, device=dev)
            wargs = tb.walk_tensors(walker, np.zeros(Li + Lo + 1), tok_in,
                                    tok_out)
            wk_ = tb.lattice_walk(walker, kern, *wargs)
            wp = tb.lattice_walk_plain(walker, kern, *wargs)
            torch.cuda.synchronize()
            walk_equal(name, wk_, wp)
            # the other layouts, and blocks of 1, 4 and 8 pairs (the last
            # block part full)
            for v in WALK_VARIANTS:
                walk_equal("%s walk %s" % (name, v), tb.lattice_walk(
                    walker, kern, *wargs, variant=v), wp)
            for P in (1, 4, 8):
                walk_equal("%s walk, %d pairs a block" % (name, P),
                           tb.lattice_walk(walker, kern, *wargs, pairs=P), wp)
        emit({"phase": "kernel_vs_plain",
              "kernel": "viterbi_wavefront+lattice_walk" if walk
              else "viterbi_wavefront", "case": name,
              "B": len(tok_in), "Li": Li, "Lo": Lo, "S": ops.S,
              "classes": ops.classes, "grid": grid, "layout": layout,
              "max_abs_vs_plain": err,
              "walk_ok": [bool(x) for x in wk_[3].cpu()] if walk else None,
              "walk_cells": [int(x) for x in wk_[0].cpu()] if walk
              else None})
        check(err <= VITERBI_VS_PLAIN_TOL,
              "%s: viterbi kernel vs plain %.3g nats" % (name, err))
        return wk_

    def toks(rng, n_sym, lens):
        return ([rng.randint(0, n_sym, a).astype(np.int32) for a, _ in lens],
                [rng.randint(0, n_sym, b).astype(np.int32) for _, b in lens])

    # all three classes, ragged lengths, an empty side and an empty pair:
    # one and two blocks a pair, the previous diagonals in shared slots or
    # read back from the lattice, one walker taking every pair
    rng = np.random.RandomState(0)
    ti, to = toks(rng, 2, [(6, 5), (0, 5), (3, 0), (0, 0), (6, 2), (4, 4)])
    allclass = build_allclass_transducer(5, list("AC"))
    full_case("allclass_ragged", allclass, ti, to)
    for cluster in (1, 2):
        for slots in (True, False):
            full_case("allclass_ragged", allclass, ti, to, cluster=cluster,
                      slots=slots)
        full_case("allclass_ragged_one_walker", allclass, ti, to, grid=1,
                  cluster=cluster)
    # tokens outside the alphabet match nothing
    bad_in = [t.copy() for t in ti]
    bad_in[0][2] = 9
    bad_out = [t.copy() for t in to]
    bad_out[1][0] = 7
    full_case("allclass_bad_tokens", allclass, bad_in, bad_out, walk=False,
              cluster=2)
    # no diag class
    rng = np.random.RandomState(5)
    ti, to = toks(rng, 2, [(5, 5)] * 3)
    full_case("indel", build_indel_transducer(5, list("AC"), seed=21), ti, to)
    # a batch through ONE block, one pair after the other
    rng = np.random.RandomState(6)
    ti, to = toks(rng, 4, [(20, 20), (9, 9), (14, 14)])
    full_case("dense8_one_block",
              build_random_transducer(8, list("ACGT"), seed=15), ti, to,
              grid=1)
    # a pair without a path: the walk is stuck at its first step
    chain = Machine.from_json({"state": [
        {"id": "s", "trans": [
            {"in": "A", "out": "A", "to": "s", "weight": 0.5},
            {"in": "C", "to": "s", "weight": 0.2},
            {"out": "C", "to": "s", "weight": 0.1},
            {"to": "t", "weight": 0.3}]},
        {"id": "t", "trans": [
            {"to": "e", "weight": 0.7},
            {"in": "A", "out": "C", "to": "t", "weight": 0.2}]},
        {"id": "e", "trans": []}]})
    i32 = np.int32
    res = full_case("chain_no_path", chain,
                    [np.zeros(3, i32), np.array([1], i32), np.zeros(0, i32)],
                    [np.zeros(3, i32), np.array([0], i32), np.zeros(0, i32)])
    check([bool(x) for x in res[3].cpu()] == [True, False, True],
          "chain_no_path: ok flags %s" % (res[3],))

    def band_case(name, machine, sp, lo, hi):
        ev = evaluated(machine)
        ops = vk.viterbi_operands(vk.maxplus_class_mats(*maxplus_mats(ev)),
                                  dev)
        it0 = np.array(ev.input_tokenizer.tokenize(sp.input.seq), i32) - 1
        ot0 = np.array(ev.output_tokenizer.tokenize(sp.output.seq), i32) - 1
        Li, Lo = len(it0), len(ot0)
        geom = vk.band_geometry(Li, Lo, lo, hi, dev)
        t_it = torch.from_numpy(it0).to(dev)
        t_ot = torch.from_numpy(ot0).to(dev)
        kern = vk.viterbi_banded_wavefront(ops, geom, t_it, t_ot)
        plain = vk.viterbi_banded_forward_plain(ops, geom, t_it, t_ot)
        torch.cuda.synchronize()
        err = max_abs_diff(kern, plain)
        walker = tb.make_lattice_walker(ev, Li, Lo, device=dev)
        wargs = tb.walk_tensors(walker, geom.bases, [it0], [ot0])
        lat = kern[:, None].contiguous()
        wk_ = tb.lattice_walk(walker, lat, *wargs)
        wp = tb.lattice_walk_plain(walker, lat, *wargs)
        torch.cuda.synchronize()
        walk_equal(name, wk_, wp)
        steps = np.diff(geom.bases)
        emit({"phase": "kernel_vs_plain",
              "kernel": "viterbi_banded_wavefront+lattice_walk", "case": name,
              "Li": Li, "Lo": Lo, "Wb": geom.Wb, "S": ops.S,
              "base_steps": [int((steps == 0).sum()), int((steps == 1).sum())],
              "max_abs_vs_plain": err, "walk_ok": bool(wk_[3][0]),
              "walk_cells": int(wk_[0][0])})
        check(err <= VITERBI_VS_PLAIN_TOL,
              "%s: banded kernel vs plain %.3g nats" % (name, err))

    # every layout the plan allows (clusters of 1 to 16, the class columns
    # resident or streamed, 1, 4 or 8 lanes an item), bit for bit: the
    # 64-state ACGT machine (diag only) on a pair of 120 in an envelope of
    # 8, prot2dna (up and left, S = 132) on a protein of 20 in a band of 6
    from machineboss_tpu_torch.core.presets import make_preset
    from machineboss_tpu_torch.testmachines import prot2dna_pairs
    sp = align_pair(120, mutate=0.1, seed=5)
    dense64 = build_random_transducer(64, list("ACGT"), seed=3)
    ev = evaluated(dense64)
    band_layouts("dense64_L120", ev, *tok_arrays(ev, sp),
                 *vk.envelope_diag_bands(Envelope(sp, width=8)), dev)
    p2d = make_preset("prot2dna")
    ev = evaluated(p2d)
    (p, dna), = prot2dna_pairs(1, 20, seed=3)
    it0 = np.array([ev.input_tokenizer.sym2tok[c] - 1 for c in p], i32)
    ot0 = np.array([ev.output_tokenizer.sym2tok[c] - 1 for c in dna], i32)
    d = np.arange(len(it0) + len(ot0) + 1)
    lo = np.clip(d // 4 - 3, np.maximum(0, d - len(ot0)),
                 np.minimum(len(it0), d))
    band_layouts("prot2dna_L20", ev, it0, ot0, lo,
                 np.minimum(np.minimum(lo + 6, len(it0) + 1), d + 1), dev)

    dense6 = build_random_transducer(6, list("ACGT"), seed=2)
    sp = align_pair(24, seed=1)
    band_case("band_L24_w4", dense6, sp,
              *vk.envelope_diag_bands(Envelope(sp, width=4)))
    # a band that jumps two cells at a time: the window's base follows one
    # cell per diagonal, below the band's lower edge
    sp = align_pair(12, seed=3)
    d = np.arange(25)
    lo = np.clip(2 * (d // 3), np.maximum(0, d - 12), np.minimum(12, d))
    hi = np.minimum(np.minimum(lo + 4, 13), d + 1)
    band_case("band_jumps", dense6, sp, lo, np.maximum(hi, lo + 1))


def tok_arrays(ev, sp):
    """The 0-based int32 token arrays of a SeqPair."""
    return (np.array(ev.input_tokenizer.tokenize(sp.input.seq), np.int32) - 1,
            np.array(ev.output_tokenizer.tokenize(sp.output.seq), np.int32)
            - 1)


def band_layouts(name, ev, it0, ot0, lo, hi, dev):
    """The banded fill in every layout the plan allows on this card, each
    equal to the plain version bit for bit."""
    from machineboss_tpu_torch.ops.kernels import viterbi_kernel as vk
    ops = vk.viterbi_operands(vk.maxplus_class_mats(*maxplus_mats(ev)), dev)
    geom = vk.band_geometry(len(it0), len(ot0), lo, hi, dev)
    t_it = torch.from_numpy(it0).to(dev)
    t_ot = torch.from_numpy(ot0).to(dev)
    plain = vk.viterbi_banded_forward_plain(ops, geom, t_it, t_ot)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    ran = []
    for c in (1, 2, 4, 8, 16):
        for resident in (True, False):
            for split in (1, 4, 8):
                try:
                    vk.banded_launch_plan(
                        ops, geom, sms, cluster=c, resident=resident,
                        split=split, max_clusters=lambda cfg:
                        vk.banded_max_clusters_on_card(ops, geom, cfg))
                except ValueError:
                    continue
                kern = vk.viterbi_banded_wavefront(
                    ops, geom, t_it, t_ot, cluster=c, resident=resident,
                    split=split)
                check(torch.equal(kern, plain), "%s: banded fill at cluster "
                      "%d, %s, split %d differs from plain" % (
                          name, c, "resident" if resident else "streamed",
                          split))
                ran.append([c, resident, split])
    check(any(r[1] for r in ran) and any(not r[1] for r in ran),
          "%s: no resident or no streamed layout ran" % name)
    emit({"phase": "kernel_vs_plain", "kernel": "viterbi_banded_wavefront",
          "case": name + "_layouts", "Li": len(it0), "Lo": len(ot0),
          "Wb": geom.Wb, "S": ops.S, "layouts": ran,
          "max_abs_vs_plain": 0.0})


def viterbi_bound(ops, il, ol, lattice_bytes, other_bytes):
    """Least ms for a max-plus fill of these pairs: 2 float32 operations
    (an add and a max) per term against the non-tensor peak, S*S terms per
    class for every cell whose neighbour lies in the lattice; and the
    lattice written once plus the inputs read once at the memory rate."""
    il = np.asarray(il, np.float64)
    ol = np.asarray(ol, np.float64)
    has_up, has_left, has_diag = ops.classes
    cells = (has_up * ((il + 1) * ol).sum() + has_left * (il * (ol + 1)).sum()
             + has_diag * (il * ol).sum())
    flops = 2.0 * ops.S * ops.S * float(cells)
    ms, by = bound(flops, lattice_bytes + other_bytes)
    return ms, by, flops


def banded_terms(lo, hi, classes):
    """Class terms of a banded fill, in units of S*S: for each present
    class the band's cells whose neighbour of that class lies in the band
    too. lo, hi: the band's rows [lo_d, hi_d) on every diagonal d."""
    lo = np.asarray(lo, np.int64)
    hi = np.asarray(hi, np.int64)
    d = np.arange(len(lo))

    def overlap(a0, a1, b0, b1):
        return int(np.maximum(np.minimum(a1, b1) - np.maximum(a0, b0),
                              0).sum())
    has_up, has_left, has_diag = classes
    # up (i, o-1): row i of diagonal d-1, o >= 1; left (i-1, o): row i-1 of
    # diagonal d-1; diag (i-1, o-1): row i-1 of diagonal d-2, o >= 1
    up = overlap(lo[1:], np.minimum(hi[1:], d[1:]), lo[:-1], hi[:-1])
    left = overlap(lo[1:], hi[1:], lo[:-1] + 1, hi[:-1] + 1)
    diag = overlap(lo[2:], np.minimum(hi[2:], d[2:]), lo[:-2] + 1,
                   hi[:-2] + 1)
    return has_up * up + has_left * left + has_diag * diag


def event_ms(fn):
    """Device ms of one call of fn, by CUDA events."""
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    out = fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1), out


def fill_variants(ops, batch, kern):
    """The batched fill against variants that undo one design choice each,
    timed in turns (default, variant, variant, default), each giving the
    same lattice bit for bit: one block a pair (no cluster), the previous
    diagonals read back from the lattice (no slots), a token's block loaded
    for every cell (no token grouping: pieces of one cell), the source
    states in one chunk an item. Returns {variant: {which: [ms, ms]}}."""
    from machineboss_tpu_torch.ops.kernels import viterbi_kernel as vk
    out = {}
    for label, kw in (("one_block_a_pair", {"cluster": 1}),
                      ("read_back", {"slots": False}),
                      ("no_token_grouping", {"piece": 1}),
                      ("one_source_chunk", {"chunks": 1})):
        times = {"default": [], label: []}
        for which in ("default", label, label, "default"):
            args = kw if which == label else {}
            check(torch.equal(vk.viterbi_wavefront(ops, *batch, **args), kern),
                  "fill %s differs" % which)
            times[which].append(cuda_ms(
                lambda: vk.viterbi_wavefront(ops, *batch, **args), 3))
        out[label] = times
    return out


def banded_variants(ops, geom, t_it, t_ot, kern, cfg):
    """The banded fill against variants that undo one design choice each,
    timed in turns (default, variant, variant, default), each giving the
    same lattice bit for bit: one block (no cluster; the plan's choice of
    residency at that size), the class columns streamed through L2 (no
    resident blocks), one lane an item (no split of the source states).
    Also the other split of 4 or 8 lanes. Returns
    {variant: {"layout": keywords, which: [ms, ms]}}."""
    from machineboss_tpu_torch.ops.kernels import viterbi_kernel as vk
    out = {}
    other = 4 if cfg["split"] == 8 else 8
    for label, kw in (("one_block", {"cluster": 1}),
                      ("streamed", {"resident": False}),
                      ("one_lane", {"split": 1}),
                      ("%d_lanes" % other, {"split": other})):
        if "split" in kw:        # the same cluster, residency as planned
            kw = dict(kw, cluster=cfg["cluster"], resident=cfg["resident"])
        elif "resident" in kw:
            kw = dict(kw, cluster=cfg["cluster"])
        times = {"default": [], label: []}
        for which in ("default", label, label, "default"):
            args = kw if which == label else {}
            check(torch.equal(vk.viterbi_banded_wavefront(
                ops, geom, t_it, t_ot, **args), kern),
                "banded fill %s differs" % which)
            times[which].append(cuda_ms(
                lambda: vk.viterbi_banded_wavefront(ops, geom, t_it, t_ot,
                                                    **args), 3))
        out[label] = {"layout": kw, **times}
    return out


def align_path(name, machine, pairs, envelopes, dev, card, smi, n_host=2,
               cpu_fallbacks=False):
    """One path through device_viterbi_matrices at full width.

    Every launch count is set to 0 just before the first call and read
    just after: one fill per batched call (or per banded pair), one walk
    per batch, no other kernel. Then the f64 gate on 8 pairs, alignment
    equality with the host ViterbiMatrix on `n_host` pairs, the number of
    full-readback fallbacks over all pairs, the call's median of 5, and
    the fill and walk kernels alone against their plain versions.
    Returns the entries of the kernels line."""
    from machineboss_tpu_torch.algo import traceback_device as tb
    from machineboss_tpu_torch.algo.dp_host import ViterbiMatrix
    from machineboss_tpu_torch.algo.viterbi_device import \
        device_viterbi_matrices
    from machineboss_tpu_torch.ops.host_oracle import viterbi_2d_f64
    from machineboss_tpu_torch.ops.kernels import viterbi_kernel as vk
    from machineboss_tpu_torch.ops.lowering import LoweredMachine
    ev = evaluated(machine)
    lowered_m = LoweredMachine(ev, dtype=np.float32)   # once, as a caller
    banded = envelopes is not None                     # looping over batches
    fill_name = "viterbi_banded_wavefront" if banded else "viterbi_wavefront"
    wrappers = counts()
    expect = {k: 0 for k in wrappers}
    expect[fill_name] = len(pairs) if banded else 1
    expect["lattice_walk"] = len(pairs) if banded else 1

    def trans(path):
        return [(t.in_, t.out, t.dest) for t in path.trans]

    for w in wrappers.values():
        w.launches = 0
    t0 = time.perf_counter()
    mats = device_viterbi_matrices(ev, pairs, lowered=lowered_m,
                                   envelopes=envelopes, device=dev)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    got = {k: w.launches for k, w in wrappers.items()}
    check(got == expect, "%s: launches %s, expected %s" % (name, got, expect))
    lls = np.array([m.log_like() for m in mats])
    check(np.isfinite(lls).all() and (lls > NEG).all(),
          "%s: scores not all finite" % name)
    paths = [m.path(machine) for m in mats]
    fallbacks = sum(m._full is not None for m in mats)
    check(fallbacks == 0 or cpu_fallbacks,
          "%s: %d pairs fell back to the full readback" % (name, fallbacks))

    tok_in = [np.array(ev.input_tokenizer.tokenize(sp.input.seq),
                       np.int32) - 1 for sp in pairs]
    tok_out = [np.array(ev.output_tokenizer.tokenize(sp.output.seq),
                        np.int32) - 1 for sp in pairs]
    # gates: the f64 score on 8 pairs (the banded pair against the host's
    # banded fill, which is float64), the host's alignment on n_host
    hosts = [ViterbiMatrix(ev, pairs[b], env=envelopes[b] if banded else None)
             for b in range(min(n_host, len(pairs)))]
    for b, host in enumerate(hosts):
        check(trans(host.traceback(machine)) == trans(paths[b]),
              "%s: pair %d is not aligned as the host aligns it" % (name, b))
    if banded:
        ref = np.array([h.log_like() for h in hosts])
    else:
        m64 = maxplus_mats(ev, np.float64)
        ref = np.array([viterbi_2d_f64(*m64, tok_in[b], tok_out[b])
                        for b in range(min(8, len(pairs)))])
    gate = score_err(lls[:len(ref)], ref)
    check(gate <= GATE_TOL, "%s: f64 gate %.3g nats" % (name, gate))

    cpu_fb = None
    if cpu_fallbacks:
        # the same pairs through the CPU path: the same fallbacks, scores
        # and alignments
        cpu = device_viterbi_matrices(ev, pairs, envelopes=envelopes,
                                      engine="kernel", device="cpu")
        cpu_paths = [m.path(machine) for m in cpu]
        cpu_fb = sum(m._full is not None for m in cpu)
        check(cpu_fb == fallbacks, "%s: %d fallbacks on the card, %d on the "
              "CPU" % (name, fallbacks, cpu_fb))
        check(all(trans(a) == trans(b) for a, b in zip(cpu_paths, paths)),
              "%s: the CPU path aligns differently" % name)
        check(all(a.log_like() == b.log_like() for a, b in zip(cpu, mats)),
              "%s: the CPU path scores differently" % name)

    call_s, align_s = [], []
    for _ in range(5):
        before = {k: w.launches for k, w in wrappers.items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        again = device_viterbi_matrices(ev, pairs, lowered=lowered_m,
                                        envelopes=envelopes, device=dev)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        again_paths = [m.path(machine) for m in again]
        t2 = time.perf_counter()
        call_s.append(t1 - t0)
        align_s.append(t2 - t0)
        check({k: w.launches - before[k] for k, w in wrappers.items()}
              == expect, "%s: a repeated call launched otherwise" % name)
    check(all(trans(a) == trans(b) for a, b in zip(again_paths, paths)),
          "%s: a repeated call aligns differently" % name)
    call_ms = float(np.median(call_s)) * 1e3
    align_ms = float(np.median(align_s)) * 1e3

    # the kernels alone, and their plain versions, at the path's shapes
    ops = vk.viterbi_operands(vk.maxplus_class_mats(*maxplus_mats(ev)), dev)
    il = [len(t) for t in tok_in]
    ol = [len(t) for t in tok_out]
    if banded:
        lo, hi = vk.envelope_diag_bands(envelopes[0])
        geom = vk.band_geometry(il[0], ol[0], lo, hi, dev)
        t_it = torch.from_numpy(tok_in[0]).to(dev)
        t_ot = torch.from_numpy(tok_out[0]).to(dev)
        fill = lambda: vk.viterbi_banded_wavefront(ops, geom, t_it, t_ot)
        fill_plain = lambda: vk.viterbi_banded_forward_plain(ops, geom, t_it,
                                                             t_ot)
        Li, Lo, bases = il[0], ol[0], geom.bases
        in_bytes = tensor_bytes([t_it, t_ot, geom.meta])
        shape = {"Wb": geom.Wb, "n_diags": Li + Lo + 1,
                 "band_cells": int(envelopes[0].n_cells())}
    else:
        batch, Li, Lo = ragged_batch(tok_in, tok_out, dev)
        fill = lambda: vk.viterbi_wavefront(ops, *batch)
        fill_plain = lambda: vk.viterbi_forward_plain(ops, *batch)
        bases = np.zeros(Li + Lo + 1, np.int32)
        in_bytes = tensor_bytes(batch)
        shape = {"padded": [Li, Lo]}
    kern = fill()
    plain_ms, plain = event_ms(fill_plain)
    err = max_abs_diff(kern, plain)
    check(err <= VITERBI_VS_PLAIN_TOL,
          "%s: fill kernel vs plain %.3g nats" % (name, err))
    del plain
    fill_ms = cuda_ms(fill, 5)
    fill_layout = None
    if banded:
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        cfg = vk.banded_launch_plan(
            ops, geom, sms, max_clusters=lambda c:
            vk.banded_max_clusters_on_card(ops, geom, c))
        check(vk.banded_smem_bytes_on_card(ops, geom, cfg) == cfg["smem"],
              "%s: the banded fill's shared layout differs from the plan's"
              % name)
        fill_layout = {
            **cfg, "max_clusters_on_card":
                vk.banded_max_clusters_on_card(ops, geom, cfg),
            "variants_ms": banded_variants(ops, geom, t_it, t_ot, kern, cfg)}
    else:
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        cfg = vk.fill_launch_plan(ops, len(pairs), Li, Lo, sms)
        check(vk.fill_smem_bytes_on_card(ops, cfg, Li, Lo) == cfg["smem"],
              "%s: the fill's shared layout differs from the plan's" % name)
        fill_layout = {
            "cluster": cfg["cluster"], "grid": cfg["grid"],
            "previous_diagonals": "shared slots (%d)" % cfg["n_slots"]
            if cfg["n_slots"] else "read back from the lattice",
            "shared_bytes": cfg["smem"],
            "variants_ms": fill_variants(ops, batch, kern)}
    lat = kern[:, None].contiguous() if banded else kern
    walker = tb.make_lattice_walker(ev, Li, Lo, device=dev)
    wargs = tb.walk_tensors(walker, bases, tok_in, tok_out)
    walked = tb.lattice_walk(walker, lat, *wargs)
    walk_plain_ms, walked_plain = event_ms(
        lambda: tb.lattice_walk_plain(walker, lat, *wargs))
    walk_err = walk_equal(name, walked, walked_plain)
    walk_ms = cuda_ms(lambda: tb.lattice_walk(walker, lat, *wargs), 5)
    walk_profile_phase(name, walker, lat, wargs, walked, walk_ms, card, smi)

    lattice_bytes = tensor_bytes([kern])
    op_bytes = tensor_bytes([t for t in (ops.up, ops.left, ops.diag, ops.c0)
                             if t is not None])
    if banded:
        flops = 2.0 * ops.S * ops.S * banded_terms(lo, hi, ops.classes)
        fill_bound, fill_by = bound(flops, lattice_bytes + op_bytes + in_bytes)
    else:
        fill_bound, fill_by, flops = viterbi_bound(ops, il, ol, lattice_bytes,
                                                   op_bytes + in_bytes)
    # the walk: per visited cell 4*S candidates (an add and a compare), 4*S
    # lattice floats and 4*S edge weights read, 4*S record floats written
    n_cells = float(walked[0].sum())
    walk_flops = 2.0 * 4 * ops.S * n_cells
    walk_bytes = 3.0 * 4 * ops.S * 4 * n_cells
    walk_bound, walk_by = bound(walk_flops, walk_bytes)
    readback = tensor_bytes(list(walked))
    S = ops.S
    state_cells = float(envelopes[0].n_cells()) * S if banded else \
        float(((np.array(il) + 1) * (np.array(ol) + 1)).sum()) * S
    emit({"phase": name, "B": len(pairs), "S": S, "classes": ops.classes,
          "lens": [[min(il), max(il)], [min(ol), max(ol)]], **shape,
          "launches": {k: v for k, v in got.items() if v},
          "f64_gate_max_abs": gate, "f64_gate_pairs": len(ref),
          "host_alignments_equal": len(hosts), "fallbacks": fallbacks,
          "cpu_fallbacks": cpu_fb, "path_steps": len(paths[0].trans),
          "first_call_s": first_s, "call_ms_median5": call_ms,
          "call_and_paths_ms_median5": align_ms,
          "fill_kernel_ms": fill_ms, "walk_kernel_ms": walk_ms,
          "kernels_share_of_call": (fill_ms + walk_ms) / call_ms,
          "fill_plain_ms": plain_ms, "walk_plain_ms": walk_plain_ms,
          "fill_max_abs_vs_plain": err, "walk_diff_vs_plain": walk_err,
          "fill_layout": fill_layout,
          "walk_cells": n_cells, "lattice_bytes": lattice_bytes,
          "readback_bytes": readback,
          "readback_share_of_lattice": readback / lattice_bytes,
          "fill_flops": flops, "fill_bound_ms": fill_bound,
          "fill_bound_by": fill_by,
          "fill_share_of_bound": fill_bound / fill_ms,
          "walk_bound_ms": walk_bound, "walk_bound_by": walk_by,
          "state_cells_per_s": state_cells / (call_ms / 1e3),
          "fill_state_cells_per_s": state_cells / (fill_ms / 1e3),
          "card": card, "nvidia_smi": smi})
    line = "296 (_viterbi_banded_kernel)" if banded else "48 (_viterbi_kernel)"
    return [
        {"name": fill_name, "route": "cuda", "path": name,
         "source": "machineboss_tpu_torch/csrc/%s.cu" % fill_name,
         "replaces": "machineboss_tpu/ops/pallas/viterbi_kernel.py:" + line,
         "launches": got[fill_name], "max_abs_err": err, "ms": fill_ms,
         "plain_ms": plain_ms, "bound_ms": fill_bound, "bound_by": fill_by,
         "library_ms": None},
        {"name": "lattice_walk", "route": "cuda", "path": name,
         "source": "machineboss_tpu_torch/csrc/lattice_walk.cu",
         "replaces": "machineboss_tpu/algo/traceback_device.py:113 (the "
                     "jitted while_loop of make_lattice_walker; no Pallas "
                     "kernel)",
         "launches": got["lattice_walk"], "max_abs_err": walk_err,
         "ms": walk_ms,
         "plain_ms": walk_plain_ms, "bound_ms": walk_bound,
         "bound_by": walk_by, "library_ms": None}]


# the walk's variants, each undoing one choice of the warp layout
WALK_VARIANTS = ("block_barrier", "tokens_global", "prefetch",
                 "edges_shared")


def walk_profile_phase(name, walker, lat, wargs, walked, walk_ms, card, smi):
    """The walk at a path's shapes: its launch plan, the variants timed in
    turns (default, variant, variant, default), each giving the same
    records bit for bit, and the clock64 phase profile (SM cycles a step)
    of the warp layout and of each variant."""
    from machineboss_tpu_torch.algo import traceback_device as tb
    B = lat.shape[1]
    plan = tb.walk_launch_plan(
        walker.S, walker.Ti, walker.To, lat.shape[0], max(walker.Li_max, 1),
        max(walker.Lo_max, 1), B,
        torch.cuda.get_device_properties(lat.device).multi_processor_count)
    variants = {}
    for v in WALK_VARIANTS:
        try:
            got = tb.lattice_walk(walker, lat, *wargs, variant=v)
        except ValueError as err:          # edges_shared: does not fit
            variants[v] = str(err)
            continue
        walk_equal("%s walk %s" % (name, v), got, walked)
        runs = {"default": [], v: []}
        for which in ("default", v, v, "default"):
            kw = {} if which == "default" else {"variant": which}
            runs[which].append(cuda_ms(
                lambda: tb.lattice_walk(walker, lat, *wargs, **kw), 5))
        variants[v] = runs
    profile = {}
    for v in ("warp",) + WALK_VARIANTS:
        if isinstance(variants.get(v), str):
            continue
        got, prof = tb.lattice_walk_profile(walker, lat, *wargs, variant=v)
        walk_equal("%s walk profile %s" % (name, v), got, walked)
        profile[v] = prof
    steps = profile["warp"]["max_steps"]
    emit({"phase": name + "_walk", "B": B, "S": walker.S, "plan": plan,
          "kernel_ms": walk_ms, "max_steps_a_pair": steps,
          "ns_a_step": walk_ms * 1e6 / max(steps, 1),
          "variants_ms": variants, "profile_cycles_a_step": profile,
          "card": card, "nvidia_smi": smi})


def alignment_paths(dev, card, smi):
    """The three alignment paths; returns the kernels line's entries (one
    per kernel: the fills from their own paths, the walk from
    viterbi_dense)."""
    from machineboss_tpu_torch.core.presets import make_preset
    from machineboss_tpu_torch.core.seqpair import (Envelope, NamedSeq,
                                                    SeqPair)
    from machineboss_tpu_torch.testmachines import (
        align_pair, build_random_transducer, prot2dna_pairs)
    sym = np.array(list("ACGT"))
    B, L = 64, 128
    rng = np.random.RandomState(0)
    x = sym[rng.randint(0, 4, (B, L))]
    y = sym[rng.randint(0, 4, (B, L))]
    dense = align_path(
        "viterbi_dense", build_random_transducer(64, list("ACGT")),
        [SeqPair(NamedSeq("x", list(x[n])), NamedSeq("y", list(y[n])))
         for n in range(B)], None, dev, card, smi)
    sp = align_pair(1500, mutate=0.1, seed=11)
    banded = align_path(
        "align_banded", build_random_transducer(64, list("ACGT"), seed=3),
        [sp], [Envelope(sp, width=16)], dev, card, smi, n_host=1,
        cpu_fallbacks=True)
    align_path(
        "align_prot2dna", make_preset("prot2dna"),
        [SeqPair(NamedSeq("x", list(p)), NamedSeq("y", list(d)))
         for p, d in prot2dna_pairs(64, 64, seed=0)], None, dev, card, smi)
    return [dense[0], banded[0], dense[1]]


# ------------------------------------------------------------- fused Plan7

def plan7_model(hmm_text, td_json, dev, **config):
    """(Plan7Fused on `dev`, the profile, the transducer) from HMMER3 text
    and transducer JSON."""
    from machineboss_tpu_torch.core.hmmer import HmmerModel
    from machineboss_tpu_torch.core.machine import Machine
    from machineboss_tpu_torch.ops.fused_plan7 import Plan7Fused
    hmm = HmmerModel()
    hmm.read(hmm_text)
    td = Machine.from_json(td_json)
    return Plan7Fused(hmm, evaluated(td), mode="plan7", device=dev,
                      **config), hmm, td


def plan7_cases(dev):
    """The fused Plan7 kernel against its plain version, the flat solver
    and the float64 host oracles, small."""
    from machineboss_tpu_torch.algo.dp_host import ForwardMatrix
    from machineboss_tpu_torch.algo.fused_align import FusedViterbiAligner
    from machineboss_tpu_torch.core.machine import Machine
    from machineboss_tpu_torch.core.seqpair import NamedSeq, SeqPair
    from machineboss_tpu_torch.ops.kernels import fused_plan7_kernel as fk
    from machineboss_tpu_torch.testmachines import (
        AMINO, TOY_HMM_TEXT, TOY_TD_JSON, noise_transducer_json,
        random_plan7_hmm_text)
    noise = noise_transducer_json(AMINO)
    amino19 = random_plan7_hmm_text(19, AMINO, seed=3)
    amino300 = random_plan7_hmm_text(300, AMINO, seed=3)
    # the St cases reach the kernel's other instantiations (1, 3, 4 states);
    # at K=86 with 4 states and at K=300 the large tables do not fit in
    # shared memory and are read from global memory; at K=300 a thread owns
    # two profile nodes
    profiles = {"toy": (TOY_HMM_TEXT, TOY_TD_JSON),
                "amino19": (amino19, noise),
                "amino8": (random_plan7_hmm_text(8, AMINO, seed=5), noise),
                "amino19_St1": (amino19, noise_transducer_json(AMINO, 1)),
                "amino19_St3": (amino19, noise_transducer_json(AMINO, 3)),
                "amino19_St4": (amino19, noise_transducer_json(AMINO, 4)),
                "amino86_St4": (random_plan7_hmm_text(86, AMINO, seed=3),
                                noise_transducer_json(AMINO, 4)),
                "amino300": (amino300, noise),
                "amino300_St3": (amino300, noise_transducer_json(AMINO, 3))}
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    for name, multihit, B, L, one_block, oracle in (
            ("toy", False, 8, 7, False, True),
            ("toy", True, 8, 7, True, True),
            ("amino19", True, 16, 24, False, False),
            ("amino8", True, 8, 10, False, True),
            ("amino19_St1", True, 16, 24, False, False),
            ("amino19_St3", True, 16, 24, False, False),
            ("amino19_St4", False, 16, 24, False, False),
            ("amino86_St4", True, 16, 24, False, False),
            ("amino300", True, 8, 24, False, False),
            ("amino300_St3", False, 8, 24, False, False)):
        f, hmm, td = plan7_model(*profiles[name], dev, multihit=multihit,
                                 length=10.0)
        ops = fk.plan7_operands(fk.prepare_fused_plan7(f), dev)
        rng = np.random.RandomState(B + L)
        toks = rng.randint(1, f.n_out, (B, L)).astype(np.int32)
        lens = rng.randint(1, L + 1, B).astype(np.int32)
        lens[0], lens[1] = 1, L              # a read of 1, a full-width read
        toks[2, 0], lens[2] = 0, max(lens[2], 2)   # token 0: no mass left
        t = torch.from_numpy(toks).to(dev)
        n = torch.from_numpy(lens).to(dev)
        plan = fk.launch_plan(f.K, f.St, f.n_out - 1, B, n_sm)
        rpb = min(B, 8) if one_block else None
        kern = fk.fused_plan7_forward_kernel(ops, t, n, reads_per_block=rpb)
        plain = fk.fused_plan7_forward_plain(ops, t, n)
        torch.cuda.synchronize()
        check(torch.equal(kern[2], plain[2]) and float(kern[2, 2]) == 1.0,
              "%s: dead flags %s vs %s" % (name, kern[2], plain[2]))
        kll = fk.decode(kern.cpu().numpy())
        pll = fk.decode(plain.cpu().numpy())
        check(kll[2] == fk.NEG_INF, "%s: the dead read scores %r"
              % (name, kll[2]))
        err_plain = score_err(kll, pll)
        # every reads a block the warp layout allows gives the same result;
        # the node-doubling layout holds to the plain version too
        for r in range(1, 9):
            check(torch.equal(fk.fused_plan7_forward_kernel(
                ops, t, n, reads_per_block=r, layout="warp"), kern),
                "%s: %d reads a block score otherwise" % (name, r))
        nodes = fk.fused_plan7_forward_kernel(ops, t, n,
                                              layout="node_doubling")
        check(torch.equal(nodes[2], plain[2]), "%s: node doubling's dead "
              "flags differ" % name)
        err_nodes = score_err(fk.decode(nodes.cpu().numpy()), pll)
        check(err_nodes <= KERNEL_VS_PLAIN_TOL,
              "%s: node doubling vs plain %.3g nats" % (name, err_nodes))
        # the flat solver reads token 0 as the empty output: leave it out
        live = np.arange(B) != 2
        flat = f.forward_batch_tokens(toks[live], lens[live], impl="flat")
        err_flat = score_err(kll[live], flat)
        err_f64 = None
        if oracle:
            comp = Machine.compose(
                hmm.plan7_machine(multihit=multihit, length=10.0), td)
            cev = evaluated(comp)
            t2s = f.td_ev.output_tokenizer.tok2sym
            ref = np.array([ForwardMatrix(cev, SeqPair(
                NamedSeq("i", []), NamedSeq("o", [
                    t2s[x] for x in toks[b, :lens[b]]]))).log_like()
                for b in np.where(live)[0][:6]])
            err_f64 = score_err(kll[live][:6], ref)
        emit({"phase": "kernel_vs_plain", "kernel": "fused_plan7",
              "case": name, "multihit": multihit, "B": B, "L": L, "K": f.K,
              "St": f.St, "n_sym": f.n_out - 1, "one_block": one_block,
              "plan": plan, "max_abs_vs_plain": err_plain,
              "node_doubling_vs_plain": err_nodes,
              "max_abs_vs_flat": err_flat,
              "max_abs_vs_f64": err_f64, "n_dead": int((kll <= NEG).sum())})
        check(err_plain <= KERNEL_VS_PLAIN_TOL,
              "%s: kernel vs plain %.3g nats" % (name, err_plain))
        check(err_flat <= PLAN7_VS_FLAT_TOL,
              "%s: kernel vs flat %.3g nats" % (name, err_flat))
        check(err_f64 is None or err_f64 <= PLAN7_VS_F64_TOL,
              "%s: kernel vs f64 oracle %.3g nats" % (name, err_f64 or 0))

    # the max-plus flat solver on the card against the f64 product-graph
    # Viterbi, single hit and multihit
    errs = []
    reads = ["A", "ACG", "TTACGACGTT", "GT", "GATTACA"]
    for multihit in (False, True):
        f, hmm, td = plan7_model(TOY_HMM_TEXT, TOY_TD_JSON, dev,
                                 multihit=multihit, length=10.0,
                                 semiring="maxplus")
        check(not f._kernel_supported(), "Viterbi must stay off the kernel")
        got = f.forward_batch([list(r) for r in reads])
        aligner = FusedViterbiAligner(
            hmm.plan7_machine(multihit=multihit, length=10.0), td)
        errs.append(score_err(got, [aligner.score(r) for r in reads]))
    emit({"phase": "plan7_viterbi_flat", "reads": len(reads),
          "max_abs_vs_f64": max(errs)})
    check(max(errs) <= PLAN7_VITERBI_TOL,
          "maxplus flat solver vs f64 %.3g nats" % max(errs))


def plan7_path(dev, card, smi):
    """Fused Plan7 read scoring at full width: an 86-node amino-acid
    profile of fn3's shape (seeded, random) fused with the 2-state noise
    transducer, multihit, B=1024 reads of 90 padded to the bucket
    forward_batch pads to, one blocking call and eight batches streamed.
    Returns the kernels line's entry."""
    from machineboss_tpu_torch.ops.fwdback import pad_bucket
    from machineboss_tpu_torch.ops.kernels import fused_plan7_kernel as fk
    from machineboss_tpu_torch.testmachines import (
        AMINO, fn3_shaped_hmm_text, noise_transducer_json, plan7_reads,
        random_plan7_hmm_text)
    B, Lr, n_stream = 1024, 90, 8
    text, noise = fn3_shaped_hmm_text(seed=0), noise_transducer_json(AMINO)
    f, _, _ = plan7_model(text, noise, dev, multihit=True, solver="prefix")
    reads = plan7_reads(AMINO, B, Lr, seed=0)
    s2t = f.td_ev.output_tokenizer.sym2tok
    Lo = pad_bucket(Lr, base=16)
    toks = np.ones((B, Lo), np.int32)
    toks[:, :Lr] = np.array([[s2t[c] for c in r] for r in reads], np.int32)
    lens = np.full(B, Lr, np.int32)

    # the blocking call: one launch of this kernel and of no other
    wrappers = counts()
    for w in wrappers.values():
        w.launches = 0
    t0 = time.perf_counter()
    lls = f.forward_batch_tokens(toks, lens, impl="auto")
    first_s = time.perf_counter() - t0
    got = {k: w.launches for k, w in wrappers.items()}
    check(got == {k: int(k == "fused_plan7") for k in wrappers},
          "plan7: launches %s, expected one of fused_plan7" % got)
    check(lls.shape == (B,) and np.isfinite(lls).all() and (lls > NEG).all(),
          "plan7: scores not all finite")
    # the streamed batches: one launch each, one copy back
    batches = [(toks, lens)] * n_stream
    for w in wrappers.values():
        w.launches = 0
    streamed = f.forward_stream(batches)
    got_stream = {k: w.launches for k, w in wrappers.items()}
    check(got_stream == {k: n_stream * int(k == "fused_plan7")
                         for k in wrappers},
          "plan7 stream: launches %s, expected %d of fused_plan7"
          % (got_stream, n_stream))
    check(all(np.array_equal(o, lls) for o in streamed),
          "plan7: a streamed batch differs from the blocking call")

    call_s, stream_s = [], []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        again = f.forward_batch_tokens(toks, lens)
        torch.cuda.synchronize()
        call_s.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        f.forward_stream(batches)
        torch.cuda.synchronize()
        stream_s.append(time.perf_counter() - t0)
    check(np.array_equal(again, lls), "plan7: a repeated call differs")
    call_ms = float(np.median(call_s)) * 1e3
    stream_ms = float(np.median(stream_s)) * 1e3

    # gates: the flat solver (log space, the prefix matrix), the scan
    # solver through the per-read route, and the flat solver in float64
    # on 8 reads
    flat_ms, flat = event_ms(
        lambda: f.forward_batch_tokens(toks, lens, impl="flat"))
    err_flat = score_err(lls, flat)
    check(err_flat <= GATE_TOL, "plan7: kernel vs flat %.3g nats" % err_flat)
    f_scan, _, _ = plan7_model(text, noise, dev, multihit=True,
                               solver="scan")
    scan = f_scan.forward_batch_tokens(toks, lens, impl="vmap")
    err_scan = score_err(flat, scan)
    check(err_scan <= GATE_TOL, "plan7: prefix vs scan %.3g nats" % err_scan)
    n_gate = 8
    f64, _, _ = plan7_model(text, noise, dev, multihit=True, solver="prefix",
                            dtype=torch.float64)
    ref = f64.forward_batch_tokens(toks[:n_gate], lens[:n_gate], impl="flat")
    gate = score_err(lls[:n_gate], ref)
    check(gate <= GATE_TOL, "plan7: f64 gate %.3g nats" % gate)

    # the kernel alone, and its plain version, at the path's shapes
    ops = f._kernel_ops
    t = torch.from_numpy(toks).to(dev)
    n = torch.from_numpy(lens).to(dev)
    kern = fk.fused_plan7_forward_kernel(ops, t, n)
    kll = fk.decode(kern.cpu().numpy())
    check(score_err(kll, lls) == 0.0, "plan7: kernel alone differs from the "
          "path")
    plain_ms, plain = event_ms(lambda: fk.fused_plan7_forward_plain(ops, t, n))
    check(torch.equal(kern[2], plain[2]), "plan7: dead flags differ")
    err = score_err(kll, fk.decode(plain.cpu().numpy()))
    check(err <= KERNEL_VS_PLAIN_TOL,
          "plan7: kernel vs plain %.3g nats" % err)
    kernel_ms = cuda_ms(lambda: fk.fused_plan7_forward_kernel(ops, t, n), 10)
    # the same batch with fewer reads a block (more, smaller blocks): says
    # whether a row's time is latency or instruction slots; and the
    # node-doubling layout (a thread a node, named barriers) in turns
    # (warp, node_doubling, node_doubling, warp), each within the plain
    # version's bound with its dead flags
    by_reads = {}
    for r in (1, 2, 4, 8):
        other = fk.fused_plan7_forward_kernel(ops, t, n, reads_per_block=r)
        check(torch.equal(other, kern), "plan7: %d reads a block score "
              "otherwise" % r)
        by_reads[str(r)] = cuda_ms(lambda: fk.fused_plan7_forward_kernel(
            ops, t, n, reads_per_block=r), 5)
    nodes = fk.fused_plan7_forward_kernel(ops, t, n, layout="node_doubling")
    check(torch.equal(nodes[2], plain[2]), "plan7: node doubling's dead "
          "flags differ")
    err_nodes = score_err(fk.decode(nodes.cpu().numpy()),
                          fk.decode(plain.cpu().numpy()))
    check(err_nodes <= KERNEL_VS_PLAIN_TOL,
          "plan7: node doubling vs plain %.3g nats" % err_nodes)
    layouts = {"warp": [], "node_doubling": []}
    for lay in ("warp", "node_doubling", "node_doubling", "warp"):
        layouts[lay].append(cuda_ms(lambda: fk.fused_plan7_forward_kernel(
            ops, t, n, layout=lay), 5))
    nodes_by_reads = {str(r): cuda_ms(lambda: fk.fused_plan7_forward_kernel(
        ops, t, n, reads_per_block=r, layout="node_doubling"), 5)
        for r in (1, 2, 4, 8)}
    profile = {}
    for lay in ("warp", "node_doubling"):
        got_p, profile[lay] = fk.fused_plan7_profile(ops, t, n, layout=lay)
        check(torch.equal(got_p, kern if lay == "warp" else nodes),
              "plan7: the %s profile build scores otherwise" % lay)
    emit({"phase": "plan7_profile", "B": B, "K": f.K, "St": f.St,
          "profile_cycles_a_row": profile, "layout_ms": layouts,
          "node_doubling_by_reads_ms": nodes_by_reads,
          "node_doubling_vs_plain_max_abs": err_nodes,
          "card": card, "nvidia_smi": smi})

    # both layouts on the same batch through profiles either side of
    # launch_plan's default crossover (fused_plan7_kernel.WARP_DEFAULT_MAX_K,
    # which scripts/plan7_layouts.py measures over K), in turns, each held
    # to the plain version
    crossover = {}
    for K2 in (128, 300):
        f2, _, _ = plan7_model(random_plan7_hmm_text(K2, AMINO, seed=3),
                               noise, dev, multihit=True, solver="scan")
        ops2 = fk.plan7_operands(fk.prepare_fused_plan7(f2), dev)
        pll2 = fk.decode(fk.fused_plan7_forward_plain(ops2, t, n).cpu()
                         .numpy())
        ms2, err2 = {"warp": [], "node_doubling": []}, {}
        for lay in ms2:
            k2 = fk.decode(fk.fused_plan7_forward_kernel(
                ops2, t, n, layout=lay).cpu().numpy())
            err2[lay] = score_err(k2, pll2)
            check(err2[lay] <= KERNEL_VS_PLAIN_TOL, "plan7 K=%d: %s vs "
                  "plain %.3g nats" % (K2, lay, err2[lay]))
        for lay in ("warp", "node_doubling", "node_doubling", "warp"):
            ms2[lay].append(cuda_ms(lambda: fk.fused_plan7_forward_kernel(
                ops2, t, n, layout=lay), 5))
        crossover[str(K2)] = {"default": fk.default_layout(K2), "ms": ms2,
                              "max_abs_vs_plain": err2}
    emit({"phase": "plan7_layouts", "B": B, "St": f.St,
          "warp_default_max_k": fk.WARP_DEFAULT_MAX_K, "by_K": crossover,
          "card": card, "nvidia_smi": smi})

    # least time for this run's work. Multiply-adds per read and row (the
    # start row included): per node 12 St^2 (five cold blocks, two paired
    # emissions, em0, ei0 twice, ci twice), 5 St^2 more for the multihit
    # basis maps, 8 St for the scalar recombinations and the along-k
    # solve, and some 20 St^2 per row for the flanks. The solve costs
    # (3 St)^2 per node and doubling level in the form the kernel
    # implements (ceil(log2 K) levels), (3 St)^2 per node as the plain
    # recurrence, the cheapest form, and (3 St K)^2 / 2 per row as the
    # closed form with the lower-block-triangular prefix matrix. The bound
    # takes the cheapest form's count. Tokens, lengths, tables and the
    # (3, B) result move once.
    K, St = f.K, f.St
    rows = float((lens + 1).sum())
    macs_node = (12 + 5 * int(f.multihit)) * St * St + 8 * St
    flank = 20 * St * St
    solve = 9 * St * St
    macs_row = K * (macs_node + solve) + flank
    macs_row_doubling = K * (macs_node + solve * fk.n_levels(K)) + flank
    macs_row_tri = K * macs_node + (3 * St * K) ** 2 / 2 + flank
    flops = 2.0 * macs_row * rows
    nbytes = tensor_bytes([t, n, ops.consts, ops.ksc, ops.kco, ops.alev,
                           ops.emm, ops.emi]) + 3 * B * 4
    bound_ms, bound_by = bound(flops, nbytes)
    plan = fk.launch_plan(
        K, St, ops.n_sym, B,
        torch.cuda.get_device_properties(dev).multi_processor_count)
    # table bytes a read loads a row in the warp layout, per lane node:
    # pass A the scalars, em0, ei0, ci and A_k, pass B the scalars, A_k and
    # ci, pass C (multihit) the five basis maps, and the token's panels;
    # per lane one span product a scan level
    N2 = St * St
    per_node = 16 + 24 * N2 + 5 * N2 * int(f.multihit)
    moved = 4 * fk.LANES * (fk.warp_chunk(K) * per_node
                            + fk.lane_levels(K) * 9 * N2)
    emit({"phase": "plan7", "B": B, "Lr": Lr, "padded": Lo, "K": K, "St": St,
          "n_sym": ops.n_sym, "multihit": True, "solver": f._solver,
          "launches": got["fused_plan7"],
          "stream_batches": n_stream,
          "stream_launches": got_stream["fused_plan7"],
          "launch_plan": plan,
          "table_bytes_a_read_a_row": moved,
          "kernel_vs_plain_max_abs": err, "kernel_vs_flat_max_abs": err_flat,
          "prefix_vs_scan_max_abs": err_scan, "f64_gate_max_abs": gate,
          "f64_gate_reads": n_gate, "score_range": [float(lls.min()),
                                                    float(lls.max())],
          "first_call_s": first_s, "call_ms_median5": call_ms,
          "stream_ms_median5": stream_ms,
          "reads_per_s_call": B / (call_ms / 1e3),
          "reads_per_s_stream": n_stream * B / (stream_ms / 1e3),
          "kernel_ms": kernel_ms, "plain_ms": plain_ms,
          "kernel_ms_by_reads_per_block": by_reads,
          "flat_solver_ms": flat_ms,
          "kernel_share_of_call": kernel_ms / call_ms,
          "flops": flops,
          "flops_doubling_form": 2.0 * macs_row_doubling * rows,
          "flops_triangular_form": 2.0 * macs_row_tri * rows,
          "bytes": nbytes, "bound_ms": bound_ms, "bound_by": bound_by,
          "kernel_share_of_bound": bound_ms / kernel_ms,
          "card": card, "nvidia_smi": smi})
    return {"name": "fused_plan7", "route": "cuda",
            "source": "machineboss_tpu_torch/csrc/fused_plan7.cu",
            "replaces": "machineboss_tpu/ops/pallas/fused_plan7_kernel.py:61 "
                        "(_kernel)",
            "launches": got["fused_plan7"], "max_abs_err": err,
            "ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None}


# ------------------------------- single-pair scoring and the sparse engine

SINGLE_FB_TOL = 1e-3             # nats: Backward total against Forward
ONE_HOT_TOL = 1e-4               # nats: a one-hot profile against tokens
SPARSE_VS_DENSE_TOL = 1e-3       # nats: sparse forms against the dense ones
BLOCKED_VS_SCAN1D_TOL = 5e-3     # nats: blocked fold against the scan kernel


def cuda_activity(fn):
    """(fn(), names): the names of the device's activities (kernels,
    memcpy, memset) in one call under torch.profiler's CUDA activity. The
    tracing costs some 40 us a launch on the card's host, so the call's
    time is taken apart."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    kineto = getattr(prof.profiler, "kineto_results", None)
    if kineto is not None:
        # the raw activity records: prof.events() would build the event
        # tree, tens of seconds for a call of 500k launches
        names = [e.name() for e in kineto.events()
                 if e.device_type() == cuda]
    else:
        names = [e.name for e in prof.events() if e.device_type == cuda]
    return out, names


def device_kernels(names):
    """The kernel launches among cuda_activity's names."""
    return [n for n in names
            if "memcpy" not in n.lower() and "memset" not in n.lower()]


def collective_names(names):
    """The NCCL kernels among cuda_activity's names."""
    return sorted({n for n in names if "nccl" in n.lower()})


def launches_per_call(fn):
    """(fn(), kernels, copies) of one call under torch.profiler's CUDA
    activity: the device's kernel launches, and its memcpy and memset
    operations (None, None where the profiler saw no device activity)."""
    out, names = cuda_activity(fn)
    kernels = len(device_kernels(names))
    copies = len(names) - kernels
    if kernels + copies == 0:
        return out, None, None
    return out, kernels, copies


def synced_ms(fn):
    """(fn(), ms): one call between two torch.cuda.synchronize()."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def call_record(fns, count=True):
    """One call form over one or more inputs (a zero-argument function
    each): launches per call from one profiled call of the first (unless
    `count` is false), whose result stands for the first input's, then
    the others' calls timed, synchronised around each. ms is the median
    over those calls; with one input, over 5 calls where a call takes
    under 1 s, else of one. Returns (record, the inputs' results)."""
    fns = list(fns) if isinstance(fns, (list, tuple)) else [fns]
    if count:
        out, kernels, copies = launches_per_call(fns[0])
        outs, timed = [out], fns[1:] or fns
    else:
        outs, timed, kernels, copies = [], fns, None, None
    times = []
    for fn in timed:
        out, ms = synced_ms(fn)
        times.append(ms)
        if len(outs) < len(fns):
            outs.append(out)
    if len(fns) == 1 and times[0] < 1000.0:
        times += [synced_ms(fns[0])[1] for _ in range(4)]
    return {"ms": float(np.median(times)), "ms_all": times,
            "launches_per_call": kernels, "copies_per_call": copies}, outs


def gated(rec, err, bound, gate, what, **extra):
    """The record with its gate; fails the run past `bound` nats."""
    check(err <= bound, "%s: %s %.3g nats" % (what, gate, err))
    rec.update(gate_max_abs=err, gate=gate, **extra)
    return rec


def lattice_err(lat, ref):
    """max |lat - ref| over the cells live in `ref`; the impossible cells
    (<= NEG) must be the same."""
    lat = lat.cpu().numpy().astype(np.float64)
    check(lat.shape == ref.shape and np.array_equal(lat <= NEG, ref <= NEG),
          "lattice shape or impossible cells differ")
    live = ref > NEG
    return float(np.abs(lat[live] - ref[live]).max())


ROW_VS_PLAIN_TOL = {"logsumexp": 1e-3, "maxplus": 0.0}   # nats: the
# plain version's prepared exponentials summed in another order; max-plus
# takes the same float32 sums and maxes


def row_err(kern, plain):
    """max |kern - plain| over the finite cells of two score or lattice
    tensors; their impossible cells (<= NEG) must be the same."""
    a = kern.detach().cpu().numpy().astype(np.float64).reshape(-1)
    b = plain.detach().cpu().numpy().astype(np.float64).reshape(-1)
    check(a.shape == b.shape and np.array_equal(a <= NEG, b <= NEG),
          "row kernel: shape or impossible cells differ from plain")
    live = b > NEG
    return float(np.abs(a[live] - b[live]).max()) if live.any() else 0.0


def row_bound(mats, toks, lattice):
    """(bound_ms, bound_by, operations, bytes) of the row engine's work on
    the pairs `toks`: each cell's products with the finite entries of the
    four matrices it uses (A_up[y] and A_diag[x, y] of the row before,
    A_left[x] and the closure in the chain) as multiply-adds (two
    operations each), and 8 S exps and logs a cell (the four products'
    source exponentials and destination logs), at the float32 peak; the
    matrices and tokens read once, the scores or lattices written once."""
    a_diag, a_left, a_up, closure = (np.asarray(m) for m in mats)
    S = closure.shape[-1]

    def nz(m):
        return (m > NEG).sum(axis=(-2, -1)).astype(np.float64)

    nd, nl, nu, nc = nz(a_diag), nz(a_left), nz(a_up), float(nz(closure))
    macs = cells = 0.0
    for x, y in toks:
        x, y = np.asarray(x, np.int64), np.asarray(y, np.int64)
        n = (len(x) + 1.0) * (len(y) + 1.0)
        cells += n
        macs += nc * n + (len(y) + 1) * nl[x].sum() \
            + (len(x) + 1) * nu[y].sum() + nd[x][:, y].sum()
    flops = 2.0 * macs + 8.0 * S * cells
    out = 4.0 * S * cells if lattice else 4.0 * len(toks)
    nbytes = float(sum(m.size * 4 for m in (a_diag, a_left, a_up, closure))
                   + 4 * sum(len(x) + len(y) for x, y in toks)) + out
    ms, by = bound(flops, nbytes)
    # beside it: every entry of the four matrices, 4 S^2 multiply-adds a
    # cell, as the kernel takes them
    dense_ms, _ = bound(2.0 * 4 * S * S * cells + 8.0 * S * cells, nbytes)
    return ms, by, flops, nbytes, dense_ms


def row_record(name, fns, kernel_fn, plain_fn, sr_name, mats, per_call=1):
    """One call form of the row engine over its inputs (a zero-argument
    function each): every call's row_scan launches (set to 0 just before,
    read just after: `per_call`, and no other counted kernel), then
    call_record's ms and device launches; the kernel alone (kernel_fn:
    row_scan on the first input) by CUDA events, median of 5, its launch
    plan (the cluster of blocks a pair) and the build ms of its tables
    (row_tables on `mats`, the kernel's operands, timed apart), and
    against its plain version (plain_fn) on the card. Returns (record,
    the first run's results)."""
    from machineboss_tpu_torch.ops import semiring
    from machineboss_tpu_torch.ops.kernels import row_kernel as rk
    wrappers = counts()
    outs = []
    for fn in fns:
        for w in wrappers.values():
            w.launches = 0
        outs.append(fn())
        torch.cuda.synchronize()
        got = {k: w.launches for k, w in wrappers.items()}
        check(got == {k: per_call * (k == "row_scan") for k in wrappers},
              "%s: launches %s, expected %d of row_scan" % (name, got,
                                                            per_call))
    rec, _ = call_record(fns)
    kern = kernel_fn()
    plan = rk.row_scan.last["plan"]
    prep_ms = rk.row_tables(*mats, getattr(semiring, sr_name.upper())).prep_ms
    plain, plain_ms = synced_ms(plain_fn)
    err = row_err(kern, plain)
    check(err <= ROW_VS_PLAIN_TOL[sr_name], "%s: row kernel vs plain %.3g "
          "nats" % (name, err))
    kernel_ms = float(np.median([event_ms(kernel_fn)[0] for _ in range(5)]))
    rec.update(row_scan_per_call=per_call, row_scan_launches=per_call *
               len(fns), kernel_ms=kernel_ms, plain_ms=plain_ms,
               kernel_vs_plain=err, semiring=sr_name,
               cluster=plan["cluster"], plan=plan, tables_prep_ms=prep_ms)
    return rec, outs


def single_pair_2d_phase(dev, card, smi, B=8, Lp=64, n_batch=64, n_assoc=2,
                         L_long=3000, L_wide=64):
    """prot2dna's single-pair calls on B pairs of Lp aa x 3Lp nt, each
    through the row kernel (one row_scan launch a call; posterior_lattice
    two), held to its plain version on the card and to the float64 host
    oracle: log_forward, log_viterbi, log_backward_lattice and
    posterior_lattice (the first pair, every cell), forward_2d_banded in
    an Envelope of width 16 around each pair's Viterbi path,
    api.device_forward_batch on n_batch pairs, DeviceViterbiMatrix's
    default fill (the host's alignments); the associative rows (eager, on
    n_assoc pairs) and the aligned scan. Then the 512-state machine (one
    pair of L_wide x L_wide) and the 64-state ACGT machine at L_long x
    L_long (rows past a block's shared memory). Returns the kernels-line
    entry of row_scan (log_forward's)."""
    from machineboss_tpu_torch import api
    from machineboss_tpu_torch.algo.dp_host import (
        BackwardMatrix, ForwardMatrix, ViterbiMatrix)
    from machineboss_tpu_torch.algo.viterbi_device import DeviceViterbiMatrix
    from machineboss_tpu_torch.core.presets import make_preset
    from machineboss_tpu_torch.core.seqpair import Envelope, NamedSeq, SeqPair
    from machineboss_tpu_torch.dispatch import CompiledMachine
    from machineboss_tpu_torch.ops import dp2d, dp_aligned, fwdback
    from machineboss_tpu_torch.ops.fwdback import tokenize_batch
    from machineboss_tpu_torch.ops.kernels import row_kernel as rk
    from machineboss_tpu_torch.ops.semiring import LOGSUMEXP, MAXPLUS
    from machineboss_tpu_torch.testmachines import prot2dna_pairs
    t_phase = time.perf_counter()
    Lo = 3 * Lp
    cm = CompiledMachine(make_preset("prot2dna"), device=dev)
    batch_pairs = prot2dna_pairs(n_batch, Lp, seed=0)
    pairs = batch_pairs[:B]
    toks = [(cm.in_toks(i), cm.out_toks(o)) for i, o in pairs]
    f64 = f64_scores(cm._host_mats(), toks, key=("prot2dna", B, Lp))
    plain = [SeqPair(NamedSeq("i", list(p)), NamedSeq("o", list(d)))
             for p, d in pairs]
    oracle = "host_oracle.forward_2d_f64, %d pairs" % B
    calls = {}

    def on_card(mats):
        return [torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(dev)
                for x in mats]

    mats = on_card(cm._host_mats())
    vmats = on_card(cm.lowered.matrices_2d("maxplus"))
    dt = [(torch.tensor(i, device=dev), torch.tensor(o, device=dev))
          for i, o in toks]
    x0, y0 = dt[0]
    check(torch.backends.cuda.matmul.allow_tf32 is False, "TF32 is on")

    check(cm._strategy(Lp, Lo, "auto") == "rows", "prot2dna: not rows")
    # the path's run: B log_forward calls, each counted from 0
    rec, got = row_record(
        "log_forward", [lambda p=p: cm.log_forward(*p) for p in pairs],
        lambda: rk.row_scan(*mats, x0, y0, LOGSUMEXP, lens=(Lp, Lo)),
        lambda: dp2d.forward_2d_plain(*mats, x0, y0, Lp, Lo), "logsumexp",
        mats)
    check(cm.last_route == "rows", "log_forward took %s" % cm.last_route)
    path_launches = rec["row_scan_launches"]
    calls["log_forward"] = gated(rec, score_err(got, f64), GATE_TOL, oracle,
                                 "log_forward")
    bound_ms, bound_by, flops, nbytes, dense_ms = row_bound(
        cm._host_mats(), toks[:1], False)
    calls["log_forward"].update(bound_ms=bound_ms, bound_by=bound_by,
                                flops=flops, bytes=nbytes,
                                bound_every_entry_ms=dense_ms,
                                kernel_share_of_bound=bound_ms /
                                calls["log_forward"]["kernel_ms"])
    cfg = calls["log_forward"]["plan"]
    check(cfg == rk.row_launch_plan(
        mats[3].shape[0], Lp, Lo, 1, sms=torch.cuda.get_device_properties(
            dev).multi_processor_count, n_tab=cfg["n_tab"],
        mem_bytes=torch.cuda.get_device_properties(dev).total_memory),
          "row_scan: the call's plan is not row_launch_plan's")
    check(rk.row_smem_bytes_on_card(cfg, mats[3].shape[0], Lp)
          == cfg["smem_bytes"], "row_scan: the kernel's shared bytes differ "
          "from row_launch_plan's")
    host_vit = [ViterbiMatrix(cm.ev, sp) for sp in plain]
    vit = [max(v.log_like(), -1e30) for v in host_vit]
    host_paths = [v.path(cm.machine) for v in host_vit]
    # each pair with its Viterbi path's alignment: the banded fill's
    # envelope and the aligned scan's columns
    sps = [SeqPair(sp.input, sp.output, SeqPair.alignment_from_path(h))
           for sp, h in zip(plain, host_paths)]
    rec, got = row_record(
        "log_viterbi", [lambda p=p: cm.log_viterbi(*p) for p in pairs],
        lambda: rk.row_scan(*vmats, x0, y0, MAXPLUS, lens=(Lp, Lo)),
        lambda: dp2d.forward_2d_plain(*vmats, x0, y0, Lp, Lo, sr=MAXPLUS),
        "maxplus", vmats)
    check(all(v <= f + 1e-4 for v, f in zip(got, f64)), "Viterbi > Forward")
    calls["log_viterbi"] = gated(rec, score_err(got, vit), GATE_TOL,
                                 "dp_host.ViterbiMatrix, %d pairs" % B,
                                 "log_viterbi")

    rec, got = call_record([lambda x=x: float(dp2d.forward_2d(
        *mats, *x, Lp, Lo, assoc=True)) for x in dt[:n_assoc]])
    calls["forward_2d_assoc"] = gated(rec, score_err(got, f64[:n_assoc]),
                                      GATE_TOL, "host_oracle.forward_2d_f64,"
                                      " %d pairs" % n_assoc, "assoc rows")

    # the Backward lattice and the posteriors of the first pair, every cell
    host_b = BackwardMatrix(cm.ev, plain[0]).cell         # (Li+1, Lo+1, S)
    host_f = ForwardMatrix(cm.ev, plain[0]).cell
    rev = [m.transpose(-1, -2).contiguous() for m in mats]
    eN = dp2d._e0(mats[3].shape[0], torch.float32, LOGSUMEXP, dev,
                  state=mats[3].shape[0] - 1)
    rec, (lat,) = row_record(
        "log_backward_lattice", [lambda: cm.log_backward_lattice(*pairs[0])],
        lambda: rk.row_scan(*rev, x0.flip(-1), y0.flip(-1), LOGSUMEXP,
                            start_vec=eN),
        lambda: dp2d.forward_2d_lattice_plain(*rev, x0.flip(-1),
                                              y0.flip(-1), start_vec=eN),
        "logsumexp", rev)
    ref = np.maximum(np.transpose(host_b, (1, 0, 2)), -1e30)
    fb = abs(float(lat[0, 0, 0]) - f64[0])
    check(fb <= SINGLE_FB_TOL, "backward total vs forward %.3g" % fb)
    calls["log_backward_lattice"] = gated(
        rec, lattice_err(lat, ref), GATE_TOL,
        "dp_host.BackwardMatrix, every cell of the first pair",
        "backward lattice", backward_total_vs_forward=fb)
    live = (host_f > -1e29) & (host_b > -1e29)
    ref = np.transpose(np.where(live, host_f + host_b - host_f[-1, -1, -1],
                                -1e30), (1, 0, 2))
    rec, (post,) = row_record(
        "posterior_lattice", [lambda: fwdback.posterior_lattice(
            *mats, x0, y0)],
        lambda: rk.row_scan(*mats, x0, y0, LOGSUMEXP),
        lambda: dp2d.forward_2d_lattice_plain(*mats, x0, y0), "logsumexp",
        mats, per_call=2)
    calls["posterior_lattice"] = gated(
        rec, lattice_err(torch.clamp(post, min=-1e30), ref), GATE_TOL,
        "dp_host ForwardMatrix + BackwardMatrix - ll, every cell of the "
        "first pair", "posteriors")

    # the banded fill and the aligned scan along each pair's path
    envs = [Envelope(sp, width=16) for sp in sps]
    band = [(torch.tensor(e.in_start, device=dev),
             torch.tensor(e.in_end, device=dev)) for e in envs]
    rec, got = row_record(
        "forward_2d_banded", [lambda x=x, b=b: float(dp2d.forward_2d_banded(
            *mats, *x, *b, Lp, Lo)) for x, b in zip(dt, band)],
        lambda: rk.row_scan(*mats, x0, y0, LOGSUMEXP, lens=(Lp, Lo),
                            band=band[0]),
        lambda: dp2d.forward_2d_banded_plain(*mats, x0, y0, *band[0], Lp,
                                             Lo), "logsumexp", mats)
    check(all(g <= f + 1e-4 for g, f in zip(got, f64)), "banded > full")
    ref = [max(ForwardMatrix(cm.ev, sp, e).log_like(), -1e30)
           for sp, e in zip(sps, envs)]
    calls["forward_2d_banded"] = gated(
        rec, score_err(got, ref), GATE_TOL,
        "dp_host.ForwardMatrix(ev, sp, Envelope(sp, 16)), %d pairs" % B,
        "banded", band_cells=[e.n_cells() for e in envs])
    lt = torch.from_numpy(np.ascontiguousarray(cm.lowered.log_trans,
                                               np.float32)).to(dev)
    lt64 = torch.from_numpy(np.asarray(cm.lowered.log_trans, np.float64))
    cl64 = torch.from_numpy(np.asarray(cm._host_mats()[3], np.float64))
    cols = [dp_aligned.alignment_tokens(cm.ev, sp.alignment) for sp in sps]
    rec, got = call_record([lambda c=c: float(dp_aligned.forward_aligned(
        lt, mats[3], *c, len(c[0]))) for c in cols])
    check(all(a <= f + 1e-4 for a, f in zip(got, f64)), "aligned > forward")
    ref = [float(dp_aligned.forward_aligned(lt64, cl64, *c, len(c[0])))
           for c in cols]
    calls["forward_aligned"] = gated(
        rec, score_err(got, ref), GATE_TOL, "the same scan on the CPU in "
        "float64, %d paths; aligned <= forward" % B, "aligned")

    # the batched row engine: every pair in one launch, a block each
    bt = tokenize_batch(cm.ev, [SeqPair(NamedSeq("i", list(p)),
                                        NamedSeq("o", list(d)))
                                for p, d in batch_pairs], device=dev)
    rec, (got,) = row_record(
        "device_forward_batch", [lambda: api.device_forward_batch(
            make_preset("prot2dna"), batch_pairs, device=dev)],
        lambda: rk.row_scan(*mats, bt[0], bt[1], LOGSUMEXP,
                            lens=(bt[2], bt[3])),
        lambda: dp2d.forward_2d_plain(*mats, *bt), "logsumexp", mats)
    calls["device_forward_batch"] = gated(
        rec, score_err(got[:B], f64), GATE_TOL, oracle + " of %d" % n_batch,
        "device_forward_batch", pairs=n_batch)

    # DeviceViterbiMatrix's default fill: the host's alignments
    rec, dvm = row_record(
        "DeviceViterbiMatrix", [lambda sp=sp: DeviceViterbiMatrix(
            cm.ev, sp, lowered=cm.lowered, device=dev) for sp in plain],
        lambda: rk.row_scan(*vmats, x0, y0, MAXPLUS),
        lambda: dp2d.forward_2d_lattice_plain(*vmats, x0, y0, sr=MAXPLUS),
        "maxplus", vmats)

    def trans(path):
        return [(t.in_, t.out, t.dest) for t in path.trans]

    for b, (m, h) in enumerate(zip(dvm, host_paths)):
        check(trans(m.path(cm.machine)) == trans(h), "DeviceViterbiMatrix: "
              "pair %d is not aligned as the host aligns it" % b)
    calls["DeviceViterbiMatrix"] = gated(
        rec, score_err([m.log_like() for m in dvm], vit), GATE_TOL,
        "dp_host.ViterbiMatrix, %d pairs, and its alignments" % B,
        "DeviceViterbiMatrix")

    wide = row_wide_case(dev, L_wide)
    long_pair = row_long_case(dev, L_long)
    lf = calls["log_forward"]
    emit({"phase": "single_pair_2d", "machine": "prot2dna",
          "S": cm.ev.n_states(), "pairs": B, "Li": Lp, "Lo": Lo,
          "reduced": ["forward_2d_assoc (eager, not the row kernel) on %d "
                      "of the %d pairs" % (n_assoc, B)],
          "calls": calls, "states_512": wide, "long_pair": long_pair,
          "seconds": time.perf_counter() - t_phase,
          "card": card, "nvidia_smi": smi})
    return {"name": "row_scan", "route": "cuda",
            "source": "machineboss_tpu_torch/csrc/row_scan.cu",
            "replaces": "machineboss_tpu/ops/dp2d.py:103-200 (forward_2d, "
                        "forward_2d_lattice, backward_2d_lattice, "
                        "forward_2d_banded: jitted lax.scans, no "
                        "pallas_call)",
            "launches": path_launches, "max_abs_err": lf["kernel_vs_plain"],
            "ms": lf["kernel_ms"], "plain_ms": lf["plain_ms"],
            "bound_ms": lf["bound_ms"], "bound_by": lf["bound_by"],
            "library_ms": None}


ROW_CLUSTERS = (1, 2, 4, 8, 16)   # the cluster sizes the row kernel takes


def row_profiles(mats, x, y, sr, lens, clusters=(None, 1)):
    """The row kernel's clock64 phase profile (the profile library: a
    warp's SM cycles a diagonal and a cell's in each phase) at each cluster
    size (None: the plan's), each profiled result equal to the path
    library's. Returns (the path's result, its plan, {cluster: profile})."""
    from machineboss_tpu_torch.ops.kernels import row_kernel as rk
    got = rk.row_scan(*mats, x, y, sr, lens=lens)
    plan = rk.row_scan.last["plan"]
    out = {}
    for cluster in clusters:
        res, prof = rk.row_scan_profile(*mats, x, y, sr, lens=lens,
                                        cluster=cluster)
        check(torch.equal(res, got), "row profile: cluster %d differs from "
              "the path library" % prof["cluster"])
        out[prof["cluster"]] = prof
    return got, plan, out


def row_cluster_sweep(mats, it, ot, il, ol, reps=5, clusters=ROW_CLUSTERS):
    """The row kernel alone in logsumexp (CUDA events, median of `reps`)
    at each cluster size, each result bit-equal to the plan's; with the
    shape, the plan, and the lists' entries and build ms."""
    from machineboss_tpu_torch.ops.kernels import row_kernel as rk
    from machineboss_tpu_torch.ops.semiring import LOGSUMEXP
    tables = rk.row_tables(*mats, LOGSUMEXP)

    def kernel(cluster=None):
        return rk.row_scan(*mats, it, ot, LOGSUMEXP, lens=(il, ol),
                           cluster=cluster)

    want = kernel()
    rec = {"S": int(mats[3].shape[0]),
           "B": 1 if it.dim() == 1 else int(it.shape[0]),
           "Li": int(it.shape[-1]), "Lo": int(ot.shape[-1]),
           "plan": rk.row_scan.last["plan"], "tables_ms": tables.prep_ms,
           "n_tab": tables.n_tab, "ms": {}, "rows": {}}
    for cluster in clusters:
        check(torch.equal(kernel(cluster), want), "row kernel: cluster %d "
              "differs from the plan's" % cluster)
        rec["rows"][cluster] = rk.row_scan.last["plan"]["rows"]
        rec["ms"][cluster] = float(np.median(
            [event_ms(lambda: kernel(cluster))[0] for _ in range(reps)]))
    return rec


def row_profile_phase(dev, card, smi, Lp=64):
    """The row kernel on one prot2dna pair of Lp aa x 3 Lp nt, each
    semiring: its phase profile at the plan's cluster and on one block
    (row_profiles); the kernel against its CPU twin
    (row_kernel.row_scan_diagonal) run on the card on the same tables,
    score and lattice (max-plus bit-equal on the live cells, logsumexp
    within ROW_VS_PLAIN_TOL); in logsumexp, the kernel alone at each
    cluster size 1-16 (row_cluster_sweep). scripts/row_profile.py takes
    the same readings on more shapes."""
    from machineboss_tpu_torch.core.presets import make_preset
    from machineboss_tpu_torch.dispatch import CompiledMachine
    from machineboss_tpu_torch.ops.kernels import row_kernel as rk
    from machineboss_tpu_torch.ops.semiring import LOGSUMEXP, MAXPLUS
    from machineboss_tpu_torch.testmachines import prot2dna_pairs
    t_phase = time.perf_counter()
    cm = CompiledMachine(make_preset("prot2dna"), device=dev)
    (p, d), = prot2dna_pairs(1, Lp, seed=0)
    x = torch.tensor(cm.in_toks(p), device=dev)
    y = torch.tensor(cm.out_toks(d), device=dev)
    lens = (len(p), len(d))
    out = {}
    for sr in (LOGSUMEXP, MAXPLUS):
        mats = [torch.from_numpy(np.ascontiguousarray(m, np.float32)).to(dev)
                for m in cm.lowered.matrices_2d(sr.name)]
        got, plan, profile = row_profiles(mats, x, y, sr, lens)
        rec = {"plan": plan, "profile": profile}
        tables = rk.row_tables(*mats, sr)
        lat = rk.row_scan(*mats, x, y, sr)
        twin = (rk.row_scan_diagonal(tables, x, y, lens=lens),
                rk.row_scan_diagonal(tables, x, y))
        err = max(row_err(got, twin[0]), row_err(lat, twin[1]))
        check(err <= ROW_VS_PLAIN_TOL[sr.name], "row kernel vs its twin "
              "%.3g nats" % err)
        rec["kernel_vs_twin"] = err
        if sr is LOGSUMEXP:
            rec["kernel_ms_by_cluster"] = row_cluster_sweep(
                mats, x, y, *lens)["ms"]
        out[sr.name] = rec
    emit({"phase": "row_profile", "machine": "prot2dna", "Li": lens[0],
          "Lo": lens[1], "S": cm.ev.n_states(), "semirings": out,
          "seconds": time.perf_counter() - t_phase, "card": card,
          "nvidia_smi": smi})


def row_wide_case(dev, L):
    """The 512-state machine (511 states and End: dispatch's
    DENSE_MAX_STATES), one pair of L x L through log_forward: the closure
    read from global memory, one lane a destination; the kernel alone
    against its plain version and the call against the float64 host
    oracle."""
    from machineboss_tpu_torch.dispatch import CompiledMachine
    from machineboss_tpu_torch.ops import dp2d
    from machineboss_tpu_torch.ops.kernels import row_kernel as rk
    from machineboss_tpu_torch.ops.semiring import LOGSUMEXP
    from machineboss_tpu_torch.testmachines import build_random_transducer
    cm = CompiledMachine(build_random_transducer(511, list("ACGT")),
                         device=dev)
    S = cm.ev.n_states()
    check(S == 512 and cm._strategy(L, L, "auto") == "rows",
          "the 512-state machine: %d states, route %s"
          % (S, cm._strategy(L, L, "auto")))
    rng = np.random.RandomState(5)
    x = "".join("ACGT"[c] for c in rng.randint(0, 4, L))
    y = "".join("ACGT"[c] for c in rng.randint(0, 4, L))
    mats = [torch.from_numpy(np.ascontiguousarray(m, np.float32)).to(dev)
            for m in cm._host_mats()]
    xt = torch.tensor(cm.in_toks(x), device=dev)
    yt = torch.tensor(cm.out_toks(y), device=dev)
    rec, (got,) = row_record(
        "states_512", [lambda: cm.log_forward(x, y)],
        lambda: rk.row_scan(*mats, xt, yt, LOGSUMEXP, lens=(L, L)),
        lambda: dp2d.forward_2d_plain(*mats, xt, yt, L, L), "logsumexp",
        mats)
    ref = f64_scores(cm._host_mats(), [(cm.in_toks(x), cm.out_toks(y))])
    bound_ms, bound_by, _, _, dense_ms = row_bound(
        cm._host_mats(), [(cm.in_toks(x), cm.out_toks(y))], False)
    return gated(rec, score_err([got], ref), GATE_TOL,
                 "host_oracle.forward_2d_f64", "states_512", S=S, L=L,
                 bound_ms=bound_ms, bound_by=bound_by,
                 bound_every_entry_ms=dense_ms)


def row_long_case(dev, L):
    """The 64-state ACGT machine, one pair of L x L (a sequence and a copy
    with 10% of its positions redrawn) through log_forward (the plan's
    cluster of 16 blocks, the ring in shared memory); one call, against
    the float64 oracle on the card (forward_2d_f64_card; the eager plain
    version would take hours at this size). Then the kernel on 8 blocks,
    whose ring (three diagonals of 376 cells a block) is past a block's
    shared memory, in global memory: bit-equal, timed by CUDA events."""
    from machineboss_tpu_torch.dispatch import CompiledMachine
    from machineboss_tpu_torch.ops.kernels import row_kernel as rk
    from machineboss_tpu_torch.ops.semiring import LOGSUMEXP
    from machineboss_tpu_torch.testmachines import (align_pair,
                                                    build_random_transducer)
    cm = CompiledMachine(build_random_transducer(64, list("ACGT")),
                         device=dev)
    S = cm.ev.n_states()
    sp = align_pair(L, seed=12)
    x, y = "".join(sp.input.seq), "".join(sp.output.seq)
    wrappers = counts()
    for w in wrappers.values():
        w.launches = 0
    got, ms = synced_ms(lambda: cm.log_forward(x, y))
    launches = {k: w.launches for k, w in wrappers.items()}
    check(launches == {k: int(k == "row_scan") for k in wrappers},
          "long pair: launches %s" % launches)
    cfg = rk.row_scan.last["plan"]
    mats = cm._device_mats(("2d_dev", "logsumexp"), cm._host_mats)
    xt = torch.tensor(cm.in_toks(x), device=dev)
    yt = torch.tensor(cm.out_toks(y), device=dev)
    prep_ms = rk.row_tables(*mats, LOGSUMEXP).prep_ms

    def kernel(cluster=None):
        return rk.row_scan(*mats, xt, yt, LOGSUMEXP, lens=(L, L),
                           cluster=cluster)

    kernel_ms, alone = event_ms(kernel)
    check(float(alone) == got, "long pair: the kernel alone differs")
    global_ms, other = event_ms(lambda: kernel(8))
    glob = rk.row_scan.last["plan"]
    check(glob["rows"] == "global" and torch.equal(other, alone),
          "long pair: the global ring (%s) differs" % glob["rows"])
    t0 = time.perf_counter()
    ref = forward_2d_f64_card(cm._host_mats(), cm.in_toks(x), cm.out_toks(y),
                              dev)
    oracle_s = time.perf_counter() - t0
    bound_ms, bound_by, _, _, dense_ms = row_bound(
        cm._host_mats(), [(cm.in_toks(x), cm.out_toks(y))], False)
    gate = score_err([got], [ref])
    check(gate <= GATE_TOL, "long pair: f64 gate %.3g nats" % gate)
    return {"S": S, "L": L, "plan": cfg, "cluster": cfg["cluster"],
            "tables_prep_ms": prep_ms, "call_ms": ms, "kernel_ms": kernel_ms,
            "global_ring": {"plan": glob, "kernel_ms": global_ms},
            "score": got, "f64_gate_max_abs": gate, "f64_oracle_s": oracle_s,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "bound_every_entry_ms": dense_ms}


def dense1d_batch(B=256, L=10000, S=64):
    """dense1d_path's generator and batch, drawn again from its seed."""
    from machineboss_tpu_torch.testmachines import build_generator_1d
    rng = np.random.RandomState(42)
    m = build_generator_1d(S, rng=rng)
    sym = np.array(list("ACGT"))
    return m, [("", "".join(sym[rng.randint(0, 4, L)])) for _ in range(B)]


def table_route(row, S, L):
    """The JAX class's 1D rule on a measured row: assoc from the smallest
    winning L of the nearest measured S; scan where assoc never won."""
    by_s = row["derived"]["assoc_min_L_by_S"]
    if not by_s:
        return "scan"
    nearest = min((int(k) for k in by_s), key=lambda k: abs(k - S))
    return "assoc" if L >= by_s[str(nearest)] else "scan"


def single_pair_1d_phase(dev, card, smi, B=256, L=10000, Lq=3000):
    """The dense1d generator's single-pair calls at L ("auto", which the
    card's measured row routes, and the other route, the table's route no
    slower; Viterbi on the table's route against the scan's max-plus
    score; the lattices) and the batch engines on the dense1d batch: the
    blocked fold at B x L, the probability-space scan at B x Lq. Returns
    the machine and the batch's tokens."""
    from machineboss_tpu_torch.dispatch import (CompiledMachine,
                                                _load_dispatch_table)
    from machineboss_tpu_torch.ops import dp1d
    from machineboss_tpu_torch.ops.semiring import LOGSUMEXP
    from machineboss_tpu_torch.testmachines import forward_1d_f64
    t_phase = time.perf_counter()
    m, pairs = dense1d_batch(B, L)
    cm = CompiledMachine(m, device=dev)
    trans, closure = (np.asarray(x) for x in
                      cm.lowered.emit_matrices_1d(output_side=True))
    S = trans.shape[-1]
    toks = np.array([cm.out_toks(o) for _, o in pairs], np.int64)
    n_gate = min(8, B)
    ref = forward_1d_f64(trans, closure, toks[:n_gate], np.full(n_gate, L))
    one = "forward_1d_f64, 1 sequence"
    calls = {}
    check(torch.backends.cuda.matmul.allow_tf32 is False, "TF32 is on")
    # the card's measured row (dispatch_table_cuda.json, written on the
    # card by autotune_dispatch.py) under the JAX class's rule; S counts
    # End: the 64-state generator has 65 states
    row = _load_dispatch_table(dev.type)
    check(row is not None, "no %s row in the dispatch tables" % dev.type)
    auto = table_route(row, S, L)
    check(cm._strategy(0, L, "auto") == auto,
          "the %s row's rule at S=%d, L=%d" % (dev.type, S, L))
    if dev.type == "cuda":
        # the card's row measured the log-depth product faster from L=128
        check(auto == "assoc", "the cuda row's assoc_min_L_by_S %s routes "
              "dense1d to %s, not assoc"
              % (row["derived"]["assoc_min_L_by_S"], auto))
    other = "scan" if auto == "assoc" else "assoc"
    for strategy in ("auto", other):
        rec, got = call_record(lambda: cm.log_forward(
            "", pairs[0][1], strategy=strategy))
        calls["log_forward_" + cm.last_route] = gated(
            rec, score_err(got, ref[:1]), GATE_TOL, one, "log_forward",
            strategy=strategy, route=cm.last_route)
    table_ms = calls["log_forward_" + auto]["ms"]
    other_ms = calls["log_forward_" + other]["ms"]
    check(table_ms <= other_ms, "the table's route %s took %.2f ms, %s "
          "%.2f ms: the row is stale, re-run autotune_dispatch"
          % (auto, table_ms, other, other_ms))
    # Viterbi on the table's route, against the scan's max-plus score
    ref_vit, scan_vit_ms = synced_ms(lambda: cm.log_viterbi(
        "", pairs[0][1], strategy="scan"))
    torch.cuda.reset_peak_memory_stats()
    rec, got = call_record(lambda: cm.log_viterbi("", pairs[0][1], "auto"))
    check(cm.last_route == auto, "log_viterbi took %s" % cm.last_route)
    calls["log_viterbi_" + auto] = gated(
        rec, score_err(got, [ref_vit]), GATE_TOL, "log_viterbi's scan "
        "route on the card, 1 sequence", "log_viterbi", route=auto,
        scan_ms=scan_vit_ms,
        max_memory_allocated=torch.cuda.max_memory_allocated())
    t, c = (torch.from_numpy(x).to(dev) for x in (trans, closure))
    tk = torch.from_numpy(toks).to(dev)
    # the lattices carry absolute log values (as the JAX package's do): in
    # float32 their totals drift with L, so the gate takes them in float64
    # and the float32 call's error is reported beside it
    for name, fn in (("forward_1d_all", dp1d.forward_1d_all),
                     ("backward_1d_all", dp1d.backward_1d_all)):
        err = {}
        for dt in (torch.float32, torch.float64):
            tt, cc = t.to(dt), c.to(dt)
            f0 = dp1d._start_vector(S, cc, LOGSUMEXP, dt)
            rec, (lat,) = call_record(lambda: fn(tt, cc, tk[0], L),
                                      count=dt == torch.float32)
            total = float(lat[L, S - 1]) if name == "forward_1d_all" \
                else float(LOGSUMEXP.reduce(f0 + lat[0]))
            err[dt] = score_err([total], ref[:1])
            if dt == torch.float32:
                rec32 = rec
        calls[name] = gated(rec32, err[torch.float64], GATE_TOL, one +
                            ", the lattice's total, the same call in "
                            "float64 on the card", name,
                            float32_total_err=err[torch.float32],
                            float64_ms=rec["ms"])

    # the blocked fold on the whole batch, also against scan1d's scores
    fn, build_ms = synced_ms(lambda: dp1d.make_forward_1d_blocked(
        trans, closure, device=dev))
    lk = torch.full((B,), L, device=dev)
    rec, (got,) = call_record(lambda: fn(tk, lk))
    got = got.cpu().numpy()
    scan1d = cm.log_forward_batch(pairs)
    check(cm.last_route == ("scan1d" if dev.type == "cuda" else "scan"),
          "the batch took %s" % cm.last_route)
    err = score_err(got, scan1d)
    check(err <= BLOCKED_VS_SCAN1D_TOL, "blocked vs scan1d %.3g" % err)
    calls["make_forward_1d_blocked"] = gated(
        rec, score_err(got[:n_gate], ref), GATE_TOL, "forward_1d_f64, %d of "
        "%d sequences; the scan1d kernel's scores, all" % (n_gate, B),
        "blocked", vs_scan1d_max_abs=err, host_table_ms=build_ms)

    # the probability-space batch scan at its documented limit
    tq = tk[:, :Lq].contiguous()
    lq = torch.full((B,), Lq, device=dev)
    rec, (got,) = call_record(lambda: dp1d.forward_1d_scan_probs_batch(
        t, c, tq, lq))
    refq = forward_1d_f64(trans, closure, toks[:n_gate, :Lq],
                          np.full(n_gate, Lq))
    calls["forward_1d_scan_probs_batch"] = gated(
        rec, score_err(got.cpu().numpy()[:n_gate], refq), GATE_TOL,
        "forward_1d_f64, %d of %d sequences of %d" % (n_gate, B, Lq),
        "probs batch")
    emit({"phase": "single_pair_1d", "machine": "dense1d generator",
          "S": S, "B": B, "L": L, "Lq": Lq, "table_route": auto,
          "table_ms": table_ms, "other_route": other, "other_ms": other_ms,
          "table_card": row.get("nvidia_smi"),
          "table_assoc_min_L_by_S": row["derived"]["assoc_min_L_by_S"],
          "calls": calls,
          "seconds": time.perf_counter() - t_phase, "card": card,
          "nvidia_smi": smi})
    return cm, toks


def plan7_generator(K, seed=0):
    """A seeded K-node amino-acid Plan7 profile viewed as a generator."""
    from machineboss_tpu_torch.core.hmmer import HmmerModel
    from machineboss_tpu_torch.testmachines import AMINO, \
        random_plan7_hmm_text
    hmm = HmmerModel()
    hmm.read(random_plan7_hmm_text(K, AMINO, seed))
    return hmm.machine(False)


def sparse_phase(dev, card, smi, K=128, n_reads=4, Lr=128, n_pairs=4,
                 Lp=64):
    """The sparse engine: the K-node Plan7 generator (not dense at K=128,
    S=644: "auto" takes "sparse"), n_reads reads of Lr; prot2dna forced
    sparse (dense_max_states=16), n_pairs pairs of Lp x 3Lp."""
    from machineboss_tpu_torch.core.presets import make_preset
    from machineboss_tpu_torch.dispatch import CompiledMachine
    from machineboss_tpu_torch.ops import sparse
    from machineboss_tpu_torch.ops.host_oracle import viterbi_2d_f64
    from machineboss_tpu_torch.testmachines import (AMINO, plan7_reads,
                                                    prot2dna_pairs)
    t_phase = time.perf_counter()
    gen = plan7_generator(K)
    cm = CompiledMachine(gen, device=dev)
    reads = plan7_reads(AMINO, n_reads, Lr, seed=0)
    dense = CompiledMachine(gen, device="cpu", dense_max_states=1024)
    otoks = [dense.out_toks(r) for r in reads]
    ref_f = f64_scores(dense._host_mats(), [([], o) for o in otoks])
    vmats = dense.lowered.matrices_2d("maxplus")
    ref_v = [viterbi_2d_f64(*vmats, [], o) for o in otoks]
    of_dense = " of the dense lowering, %d reads" % n_reads
    calls = {}
    check(cm._strategy(0, Lr, "auto") == "sparse", "plan7: not sparse")
    rec, got = call_record([lambda r=r: cm.log_forward("", r)
                            for r in reads])
    check(cm.last_route == "sparse", "log_forward took %s" % cm.last_route)
    calls["plan7_log_forward"] = gated(
        rec, score_err(got, ref_f), GATE_TOL,
        "host_oracle.forward_2d_f64" + of_dense, "plan7 log_forward")
    sm = cm._cache["sparse"]
    ones = [[t + 1 for t in o] for o in otoks]
    for name in ("forward_1d_sparse", "backward_1d_sparse"):
        fn = getattr(sparse, name)
        for viterbi, ref, oracle in ((False, ref_f, "forward_2d_f64"),
                                     (True, ref_v, "viterbi_2d_f64")):
            rec, got = call_record([lambda o=o: fn(sm, o, viterbi=viterbi)
                                    for o in ones])
            calls["plan7_%s%s" % (name, "_viterbi" if viterbi else "")] = \
                gated(rec, score_err(got, ref), GATE_TOL,
                      "host_oracle." + oracle + of_dense, name)

    p2d = CompiledMachine(make_preset("prot2dna"), device=dev,
                          dense_max_states=16)
    pd = CompiledMachine(make_preset("prot2dna"), device=dev)
    pairs = prot2dna_pairs(n_pairs, Lp, seed=0)
    toks = [(pd.in_toks(i), pd.out_toks(o)) for i, o in pairs]
    ref = f64_scores(pd._host_mats(), toks)
    rec, (got,) = call_record(lambda: p2d.log_forward_batch(pairs))
    check(p2d.last_route == "sparse", "the batch took %s" % p2d.last_route)
    err = score_err(got, pd.log_forward_batch(pairs))
    check(err <= SPARSE_VS_DENSE_TOL, "sparse vs dense route %.3g" % err)
    calls["prot2dna_log_forward_batch"] = gated(
        rec, score_err(got, ref), GATE_TOL, "host_oracle.forward_2d_f64, "
        "%d pairs; the dense route's (lowrank) scores" % n_pairs,
        "prot2dna sparse batch", vs_dense_route_max_abs=err)
    psm = p2d._cache["sparse"]
    it, ot = [t + 1 for t in toks[0][0]], [t + 1 for t in toks[0][1]]
    rec, (got,) = call_record(lambda: sparse.backward_2d_sparse(psm, it, ot))
    calls["prot2dna_backward_2d_sparse"] = gated(
        rec, abs(got - ref[0]), SINGLE_FB_TOL,
        "backward = the Forward f64 score, 1 pair", "prot2dna backward")
    vref = viterbi_2d_f64(*pd.lowered.matrices_2d("maxplus"), *toks[0])
    rec, got = call_record(lambda: sparse.viterbi_2d_sparse(psm, it, ot))
    calls["prot2dna_viterbi_2d_sparse"] = gated(
        rec, score_err(got, [vref]), GATE_TOL,
        "host_oracle.viterbi_2d_f64, 1 pair", "prot2dna viterbi")
    emit({"phase": "sparse",
          "plan7": {"K": K, "S": cm.ev.n_states(), "reads": n_reads,
                    "L": Lr, "closure_edges": int(sm.closure()[0].numel())},
          "prot2dna": {"S": p2d.ev.n_states(), "dense_max_states": 16,
                       "pairs": n_pairs, "Li": Lp, "Lo": 3 * Lp,
                       "closure_edges": int(psm.closure()[0].numel())},
          "calls": calls, "seconds": time.perf_counter() - t_phase,
          "card": card, "nvidia_smi": smi})


def dirichlet_profile(L, T, seed):
    """(L, T+1) log weights: Dirichlet rows, column 0 the epsilon skip."""
    w = np.random.RandomState(seed).dirichlet(np.ones(T + 1), size=L)
    return np.log(w).astype(np.float32)


def pswm_phase(dev, card, smi, cm1d, toks1d, L1=1000, K=128, Lp=16):
    """The PSWM engines: dense 1D on the dense1d generator at L1 and dense
    2D on one prot2dna pair of Lp x 3Lp; sparse 1D on the K-node generator
    (K positions) and sparse 2D on prot2dna forced sparse, the same pair.
    Times and launches are the float32 calls'; the gates (one-hot =
    tokens, backward = forward, sparse = dense) take the same calls in
    float64 on the card, as these engines carry absolute log values, and
    the float32 errors are printed beside them."""
    from machineboss_tpu_torch.core.presets import make_preset
    from machineboss_tpu_torch.dispatch import CompiledMachine
    from machineboss_tpu_torch.ops import dp1d, dp2d, pswm, sparse
    from machineboss_tpu_torch.testmachines import (AMINO, plan7_reads,
                                                    prot2dna_pairs)
    t_phase = time.perf_counter()
    f64 = torch.float64
    calls = {}

    def on(x, dt=torch.float32):
        return torch.as_tensor(np.asarray(x, np.float64), device=dev).to(dt)

    def record(names, fns, errs, gate, bound, **extra):
        """Two call forms (Forward, Backward) gated by errs = {float64:
        err, float32: err}."""
        for name, fn in zip(names, fns):
            rec, _ = call_record(fn)
            calls[name] = gated(rec, errs[f64], bound, gate, name,
                                float32_err=errs[torch.float32], **extra)

    def one_hot_check(what, err):
        check(err <= ONE_HOT_TOL, "%s: one-hot vs tokens %.3g" % (what, err))
        return err

    dts = (torch.float32, f64)
    # dense 1D
    lt, clo = cm1d.lowered.log_trans[0, 1:], cm1d.lowered.closure_for()
    trans = cm1d.lowered.emit_matrices_1d(True)[0]
    prof = dirichlet_profile(L1, lt.shape[0], 1)
    tk = torch.from_numpy(toks1d[0, :L1]).to(dev)
    fb = {dt: abs(float(pswm.backward_1d_pswm(on(lt, dt), on(clo, dt),
                                              on(prof, dt), L1))
                  - float(pswm.forward_1d_pswm(on(lt, dt), on(clo, dt),
                                               on(prof, dt), L1)))
          for dt in dts}
    oh = one_hot_check("dense 1D", abs(float(pswm.forward_1d_pswm(
        on(lt, f64), on(clo, f64), pswm.pswm_from_tokens(
            tk, lt.shape[0], dtype=f64), L1)) - float(dp1d.forward_1d_scan(
                on(trans, f64), on(clo, f64), tk, L1))))
    e, c, p = on(lt), on(clo), on(prof)
    record(("forward_1d_pswm", "backward_1d_pswm"),
           (lambda: pswm.forward_1d_pswm(e, c, p, L1),
            lambda: pswm.backward_1d_pswm(e, c, p, L1)), fb,
           "backward = forward", SINGLE_FB_TOL, one_hot_vs_tokens=oh)

    # dense and sparse 2D on one prot2dna pair
    pd = CompiledMachine(make_preset("prot2dna"), device=dev)
    pr, dn = prot2dna_pairs(1, Lp, seed=5)[0]
    it, ot = pd.in_toks(pr), pd.out_toks(dn)
    Li, Lo = len(it), len(ot)
    Ti = pd.ev.input_tokenizer.n_tokens() - 1
    To = pd.ev.output_tokenizer.n_tokens() - 1
    mats = pd._host_mats()
    ip, op = dirichlet_profile(Li, Ti, 2), dirichlet_profile(Lo, To, 3)
    ti, to = torch.tensor(it, device=dev), torch.tensor(ot, device=dev)

    def dense2d(fn, dt, a=ip, b=op):
        return float(fn(*[on(x, dt) for x in mats], on(a, dt), on(b, dt),
                        Li, Lo))

    f2 = {dt: dense2d(pswm.forward_2d_pswm, dt) for dt in dts}
    fb = {dt: abs(dense2d(pswm.backward_2d_pswm, dt) - f2[dt]) for dt in dts}
    ih = pswm.pswm_from_tokens(ti, Ti, dtype=f64).cpu().numpy()
    oh2 = pswm.pswm_from_tokens(to, To, dtype=f64).cpu().numpy()
    oh = one_hot_check("dense 2D", abs(
        dense2d(pswm.forward_2d_pswm, f64, ih, oh2)
        - float(dp2d.forward_2d_plain(*[on(x, f64) for x in mats], ti, to,
                                      Li, Lo))))
    m32, p32 = [on(x) for x in mats], (on(ip), on(op))
    record(("forward_2d_pswm", "backward_2d_pswm"),
           (lambda: pswm.forward_2d_pswm(*m32, *p32, Li, Lo),
            lambda: pswm.backward_2d_pswm(*m32, *p32, Li, Lo)), fb,
           "backward = forward", SINGLE_FB_TOL, one_hot_vs_tokens=oh)
    sms = {dt: sparse.SparseMachine(pd.ev, dtype=np.float64 if dt == f64
                                    else np.float32, device=dev)
           for dt in dts}
    fs = {dt: sparse.forward_2d_sparse_pswm(sms[dt], ip, op) for dt in dts}
    bs = {dt: sparse.backward_2d_sparse_pswm(sms[dt], ip, op) for dt in dts}
    oh = one_hot_check("sparse 2D", abs(
        sparse.forward_2d_sparse_pswm(sms[f64], ih, oh2)
        - sparse.forward_2d_sparse(sms[f64], [t + 1 for t in it],
                                   [t + 1 for t in ot])))
    check(abs(bs[f64] - fs[f64]) <= SINGLE_FB_TOL
          and sparse.forward_2d_sparse_pswm(sms[torch.float32], ip, op,
                                            viterbi=True)
          <= fs[torch.float32] + 1e-5,
          "sparse 2D PSWM: backward %.3g, or Viterbi above Forward"
          % abs(bs[f64] - fs[f64]))
    sm = sms[torch.float32]
    record(("forward_2d_sparse_pswm", "backward_2d_sparse_pswm"),
           (lambda: sparse.forward_2d_sparse_pswm(sm, ip, op),
            lambda: sparse.backward_2d_sparse_pswm(sm, ip, op)),
           {dt: max(abs(fs[dt] - f2[dt]), abs(bs[dt] - f2[dt]))
            for dt in dts}, "sparse = dense", SPARSE_VS_DENSE_TOL,
           one_hot_vs_tokens=oh)

    # sparse 1D on the K-node generator, against its dense lowering
    gen = plan7_generator(K)
    gev = CompiledMachine(gen, device=dev).ev
    gsms = {dt: sparse.SparseMachine(gev, dtype=np.float64 if dt == f64
                                     else np.float32, device=dev)
            for dt in dts}
    T = gev.output_tokenizer.n_tokens() - 1
    gp = dirichlet_profile(K, T, 4)
    gd = CompiledMachine(gen, device="cpu", dense_max_states=1024)
    fd = {dt: float(pswm.forward_1d_pswm(
        on(gd.lowered.log_trans[0, 1:], dt), on(gd.lowered.closure_for(), dt),
        on(gp, dt), K)) for dt in dts}
    f1 = {dt: sparse.forward_1d_sparse_pswm(gsms[dt], gp) for dt in dts}
    b1 = {dt: sparse.backward_1d_sparse_pswm(gsms[dt], gp) for dt in dts}
    rt = [gev.output_tokenizer.sym2tok[ch]
          for ch in plan7_reads(AMINO, 1, K, seed=1)[0]]
    oh1 = pswm.pswm_from_tokens(torch.tensor(rt) - 1, T, dtype=f64).numpy()
    oh = one_hot_check("sparse 1D", abs(
        sparse.forward_1d_sparse_pswm(gsms[f64], oh1)
        - sparse.forward_1d_sparse(gsms[f64], rt)))
    check(abs(b1[f64] - f1[f64]) <= SINGLE_FB_TOL
          and sparse.forward_1d_sparse_pswm(gsms[torch.float32], gp,
                                            viterbi=True)
          <= f1[torch.float32] + 1e-5,
          "sparse 1D PSWM: backward %.3g, or Viterbi above Forward"
          % abs(b1[f64] - f1[f64]))
    gsm = gsms[torch.float32]
    record(("forward_1d_sparse_pswm", "backward_1d_sparse_pswm"),
           (lambda: sparse.forward_1d_sparse_pswm(gsm, gp),
            lambda: sparse.backward_1d_sparse_pswm(gsm, gp)),
           {dt: max(abs(f1[dt] - fd[dt]), abs(b1[dt] - fd[dt]))
            for dt in dts}, "sparse = dense (forward_1d_pswm of the dense "
           "lowering)", SPARSE_VS_DENSE_TOL, one_hot_vs_tokens=oh)
    emit({"phase": "pswm", "dense_1d": {"S": int(clo.shape[0]), "L": L1},
          "dense_2d": {"S": int(mats[3].shape[0]), "Li": Li, "Lo": Lo},
          "sparse_1d": {"S": gsm.n_states, "L": K},
          "sparse_2d": {"S": sm.n_states, "Li": Li, "Lo": Lo},
          "reduced": ["the 2D profiles, dense and sparse, at %d aa x %d nt: "
                      "a diagonal cell mixes Ti x To = %d classes"
                      % (Li, Lo, Ti * To)],
          "calls": calls, "seconds": time.perf_counter() - t_phase,
          "card": card, "nvidia_smi": smi})


# ------------------------------------------------------------ EM training

COUNT_RTOL, COUNT_ATOL = 1e-3, 1e-4   # the JAX tests' count tolerance
EM_LL_TOL = 0.01                 # nats a pair: E-step lls vs host and kernel
EMISSION_TOL = 1e-4              # relative: emitted-token counts vs lengths
FIT_TOL = 1e-3                   # per parameter: device fit vs host fit
FIT_MIN_USES = 0.01              # expected uses below which data fit nothing
EM_RISE_TOL = 1e-6               # of |ll|: EM's loglike may not fall


def count_err(got, host):
    """The largest excess of |got - host| over the count tolerance
    (<= 0 passes), and the largest |got - host|, over two MachineCounts."""
    g = np.concatenate(got.count)
    h = np.concatenate(host.count)
    diff = np.abs(g - h)
    return (float((diff - COUNT_ATOL - COUNT_RTOL * np.abs(h)).max()),
            float(diff.max()))


def small_count_cases():
    """gate (d)'s machines and pairs: the silent tkf91branch (insRate
    0.1, delRate 0.2, time 0.5), with a pair empty on each side, and the
    6-state indel transducer."""
    from machineboss_tpu_torch.core.params import param_assign_from_json
    from machineboss_tpu_torch.core.presets import make_preset
    from machineboss_tpu_torch.testmachines import build_indel_transducer
    tkf = make_preset("tkf91branch")
    indel = build_indel_transducer(6, list("ACGT"))
    return {"tkf91branch": (tkf, tkf.get_param_defs(True).combine(
        param_assign_from_json({"insRate": 0.1, "delRate": 0.2,
                                "time": 0.5}), True),
        [("ACGT", "ACGGT"), ("", "AC"), ("GA", ""), ("AACG", "ACCG"),
         ("T", "T")]),
        "indel": (indel, indel.get_param_defs(True),
                  [("ACGTA", "ACTA"), ("GGC", "GAGC"), ("T", "TT"),
                   ("CATG", "CAG")])}


def em_phase(dev, card, smi, B=128, Lp=64, n_host=4, fit_iters=3,
             fit_B=8, fit_Lp=16):
    """EM training at full width: prot2dna (S=132, 249 transitions, its 68
    default parameters in 21 norm groups and 3 probabilities), B pairs of
    Lp aa x 3Lp nt whose codons are drawn from each amino acid's
    synonymous codons. The E-step (parallel.em.device_counts, autograd
    through the batched wavefront, eager torch) is timed and its launches
    counted; gates: (a) the first n_host pairs' counts and lls against the
    host MachineCounts, (b) every pair's ll against log_forward_batch (one
    lowrank_wavefront launch), (c) the emitted-token counts against the
    lengths, (d) tkf91branch and the indel transducer against host counts.
    Then MachineFitter(engine="device") for fit_iters iterations with a
    checkpoint (each iteration's s and its E/M split; the loglike may not
    fall), and a host and a device fit of fit_B flanked pairs of fit_Lp
    aa: every parameter the data use within FIT_TOL, the fits'
    likelihoods within EM_LL_TOL. The sizes are arguments, so the phase
    rehearses on the CPU at small sizes."""
    import os
    import tempfile
    from machineboss_tpu_torch.algo.counts import MachineCounts
    from machineboss_tpu_torch.algo.fitter import MachineFitter
    from machineboss_tpu_torch.core import weight as W
    from machineboss_tpu_torch.core.eval import EvaluatedMachine
    from machineboss_tpu_torch.core.presets import make_preset
    from machineboss_tpu_torch.core.seqpair import (
        NamedSeq, SeqPair, SeqPairList)
    from machineboss_tpu_torch.dispatch import CompiledMachine
    from machineboss_tpu_torch.ops.fwdback import CountModel, tokenize_batch
    from machineboss_tpu_torch.parallel.em import device_counts
    from machineboss_tpu_torch.testmachines import prot2dna_pairs
    t_phase = time.perf_counter()

    def seq_pairs(pairs):
        return SeqPairList([SeqPair(NamedSeq("i", list(a)),
                                    NamedSeq("o", list(b)))
                            for a, b in pairs])

    m = make_preset("prot2dna")
    params = m.get_param_defs(True)
    ev = EvaluatedMachine(m, params)
    S = ev.n_states()
    n_trans = sum(len(st.trans) for st in m.states)
    pairs = prot2dna_pairs(B, Lp, seed=13, synonymous=True)
    spl = seq_pairs(pairs)

    # the E-step: no kernel of the kernels line runs in it
    wrappers = counts()
    for w in wrappers.values():
        w.launches = 0
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    dc, first_ms = synced_ms(lambda: device_counts(m, params, spl,
                                                   device=dev))
    peak = torch.cuda.max_memory_allocated() - mem0
    times = [synced_ms(lambda: device_counts(m, params, spl,
                                             device=dev))[1]
             for _ in range(3)]
    check(all(w.launches == 0 for w in wrappers.values()),
          "the E-step launched a kernel of the kernels line")
    _, launches, copies = launches_per_call(
        lambda: device_counts(m, params, spl, device=dev))
    estep_ms = float(np.median(times))
    flat = np.concatenate(dc.count)
    check(flat.shape == (n_trans,) and np.isfinite(flat).all()
          and np.isfinite(dc.loglike), "E-step counts not finite")

    # (b) every pair's ll against the lowrank kernel's
    model = CountModel(ev, device=dev)
    toks = tokenize_batch(ev, spl.seq_pairs, device=dev)
    grads, total, lls = model.counts_and_loglike(*toks)
    lls = lls.cpu().numpy()
    check(abs(float(total) - dc.loglike) <= EM_RISE_TOL * abs(dc.loglike),
          "CountModel total %r vs device_counts %r" % (float(total),
                                                       dc.loglike))
    cm = CompiledMachine(m, params, device=dev)
    fwd, fwd_launches, _, fwd_ms = drive("em_forward", cm, pairs,
                                         "lowrank_wavefront", "lowrank")
    err_b = score_err(lls, fwd)
    check(err_b <= EM_LL_TOL, "(b) E-step lls vs log_forward_batch %.3g"
          % err_b)

    # (c) each input (output) token is emitted by one edge with an input
    # (output) token: their counts sum to the summed lengths
    il = float(sum(len(a) for a, _ in pairs))
    ol = float(sum(len(b) for _, b in pairs))
    itok, otok = model.itok.cpu().numpy(), model.otok.cpu().numpy()
    err_in = abs(flat[itok > 0].sum() - il) / il
    err_out = abs(flat[otok > 0].sum() - ol) / ol
    check(max(err_in, err_out) <= EMISSION_TOL,
          "(c) emission counts off by %.3g, %.3g" % (err_in, err_out))

    # (a) the first n_host pairs in their own call against the host
    t0 = time.perf_counter()
    host = MachineCounts()
    host.init(ev)
    host_lls = [host.add(ev, sp) for sp in spl.seq_pairs[:n_host]]
    host_s = time.perf_counter() - t0
    head = device_counts(m, params, SeqPairList(spl.seq_pairs[:n_host]),
                         device=dev)
    excess_a, diff_a = count_err(head, host)
    err_a = score_err(lls[:n_host], host_lls)
    check(excess_a <= 0.0, "(a) counts vs host past tolerance by %.3g"
          % excess_a)
    check(err_a <= EM_LL_TOL, "(a) lls vs host %.3g" % err_a)
    check(abs(head.loglike - host.loglike) <= EM_LL_TOL * n_host,
          "(a) total vs host")

    # (d) the small machines on the card
    small = {}
    for name, (sm, sp_params, sm_pairs) in small_count_cases().items():
        sm_spl = seq_pairs(sm_pairs)
        got = device_counts(sm, sp_params, sm_spl, device=dev)
        ref = MachineCounts(EvaluatedMachine(sm, sp_params), sm_spl)
        excess, diff = count_err(got, ref)
        check(excess <= 0.0 and abs(got.loglike - ref.loglike) <= 1e-3,
              "(d) %s counts vs host: %.3g over tolerance" % (name, excess))
        small[name] = {"max_abs": diff, "loglike_err":
                       abs(got.loglike - ref.loglike)}

    # the fit: each E-step timed from the fitter's own calls
    class TimedFitter(MachineFitter):
        marks = []

        def _estep(self, all_params, training_set, envelopes):
            t0 = time.perf_counter()
            got = super()._estep(all_params, training_set, envelopes)
            torch.cuda.synchronize()
            self.marks.append((t0, time.perf_counter(), got.loglike))
            return got

    with tempfile.TemporaryDirectory() as tmp:
        ck = os.path.join(tmp, "em.ckpt.json")
        fitter = TimedFitter(machine=m, seed=params, engine="device",
                             device=dev, checkpoint_path=ck)
        t0 = time.perf_counter()
        fitted = fitter.fit(spl, max_iterations=fit_iters)
        fit_s = time.perf_counter() - t0
        with open(ck) as f:
            ck_state = json.load(f)
    marks = fitter.marks
    iters = []
    for k in range(len(marks) - 1):
        e = marks[k][1] - marks[k][0]
        mstep = marks[k + 1][0] - marks[k][1]
        iters.append({"s": e + mstep, "estep_s": e, "mstep_s": mstep,
                      "estep_share": e / (e + mstep),
                      "mstep_share": mstep / (e + mstep),
                      "loglike": marks[k][2]})
    ll_seq = [mk[2] for mk in marks]
    for a, b in zip(ll_seq, ll_seq[1:]):
        check(b >= a - EM_RISE_TOL * abs(a),
              "EM loglike fell: %r -> %r" % (a, b))
    check(ck_state["iteration"] == len(marks) - 1
          and ck_state["loglike"] == ll_seq[-2],
          "the checkpoint is not the last iteration's")
    check(all(np.isfinite(float(fitted.defs[k])) for k in fitted.defs),
          "fitted parameters not finite")

    # a host fit and a device fit of a small set. Every parameter the data
    # use must agree; a parameter whose transitions the data use less than
    # FIT_MIN_USES times in all (the intron extension here: no pair has an
    # intron) has float32 counts at noise level in both of its outcomes,
    # and is fitted from that noise: printed, not gated. The fitted
    # likelihoods must agree too. On coding DNA alone (no flanks) the
    # flank composition pA..pT joins them: printed, not gated
    def param_uses(fit, spl_f):
        hc = MachineCounts(EvaluatedMachine(m, m.funcs.combine(fit)), spl_f)
        uses = dict.fromkeys(params.defs, 0.0)
        for s_, st in enumerate(m.states):
            for t_, tr in enumerate(st.trans):
                for name in W.params_of(tr.weight, m.funcs.defs):
                    uses[name] = uses.get(name, 0.0) + hc.count[s_][t_]
        return uses, hc.loglike

    def host_and_device_fit(flank):
        spl_f = seq_pairs(prot2dna_pairs(fit_B, fit_Lp, seed=14,
                                         synonymous=True, flank=flank))
        t0 = time.perf_counter()
        host_fit = MachineFitter(machine=m, seed=params).fit(
            spl_f, max_iterations=fit_iters)
        t1 = time.perf_counter()
        dev_fit = MachineFitter(machine=m, seed=params, engine="device",
                                device=dev).fit(spl_f,
                                                max_iterations=fit_iters)
        t2 = time.perf_counter()
        uses, host_ll = param_uses(host_fit, spl_f)
        _, dev_ll = param_uses(dev_fit, spl_f)
        diff = {k: abs(float(host_fit.defs[k]) - float(dev_fit.defs[k]))
                for k in host_fit.defs}
        used = [k for k in diff if uses[k] >= FIT_MIN_USES]
        return {"pairs": fit_B, "Li": fit_Lp, "flank": flank,
                "max_abs_param": max(diff.values()),
                "max_abs_used_param": max(diff[k] for k in used),
                "used_params": len(used),
                "unused_params": len(diff) - len(used),
                "params_past_tol": {k: {"abs_diff": v, "uses": uses[k]}
                                    for k, v in diff.items() if v > FIT_TOL},
                "host_fit_loglike": host_ll, "device_fit_loglike": dev_ll,
                "largest_move_from_seed": max(
                    abs(float(host_fit.defs[k]) - float(params.defs[k]))
                    for k in params.defs),
                "host_s": t1 - t0, "device_s": t2 - t1}

    fit_check = host_and_device_fit(flank=8)
    check(fit_check["max_abs_used_param"] <= FIT_TOL,
          "host vs device fit %.3g" % fit_check["max_abs_used_param"])
    check(abs(fit_check["host_fit_loglike"] - fit_check["device_fit_loglike"])
          <= EM_LL_TOL, "host vs device fit's loglike")
    fit_coding = host_and_device_fit(flank=0)

    state_cells = B * (Lp + 1) * (3 * Lp + 1) * S
    emit({"phase": "em", "machine": "prot2dna", "S": S, "transitions": n_trans,
          "pairs": B, "Li": Lp, "Lo": 3 * Lp, "codons": "synonymous",
          "estep": {"first_call_s": first_ms / 1e3, "ms_median3": estep_ms,
                    "ms_all": times, "pairs_per_s": B / (estep_ms / 1e3),
                    "state_cells_per_s": state_cells / (estep_ms / 1e3),
                    "launches_per_call": launches,
                    "copies_per_call": copies,
                    "peak_bytes": peak, "peak_gib": peak / 2 ** 30},
          "log_forward_batch": {"ms_median5": fwd_ms,
                                "lowrank_launches": fwd_launches,
                                "estep_over_forward": estep_ms / fwd_ms},
          "gate_a": {"pairs": n_host, "count_max_abs": diff_a,
                     "count_excess_over_tol": excess_a,
                     "ll_max_abs": err_a, "host_s": host_s},
          "gate_b_ll_max_abs_vs_lowrank": err_b,
          "gate_c_rel": {"input": err_in, "output": err_out},
          "gate_d": small,
          "fit": {"max_iterations": fit_iters, "estep_calls": len(marks),
                  "seconds": fit_s, "iterations": iters,
                  "last_estep_s": marks[-1][1] - marks[-1][0],
                  "loglikes": ll_seq, "checkpoint_iteration":
                  ck_state["iteration"]},
          "fit_host_vs_device": fit_check,
          "fit_host_vs_device_coding_only": fit_coding,
          "seconds": time.perf_counter() - t_phase,
          "card": card, "nvidia_smi": smi})


# ------------------------------------------------------- the command line

JAX_CLI_MKV_LL = -5.54518        # the JAX CLI's --loglike of MKV / ATGAAAGTT
CLI_SUBPROCESS_TOL = 1e-3        # nats: the module entry against that score
CLI_COUNTS_RTOL = 1e-5           # CLI counts vs a direct call: float32 sums
CLI_COUNTS_ATOL = 1e-6           # in another order (autograd's atomics)


class CliSplit:
    """The CLI call's wall time split by patching its entry points with
    timers (each synchronised): the stack-language build (cli's
    _build_machine), the CompiledMachine set-up, the device entry point
    (log_forward_batch, device_viterbi_matrices or device_counts, whose
    results are kept) and the rest (reading data, the host re-trace of
    alignments, output)."""

    def __init__(self):
        from machineboss_tpu_torch import cli, dispatch
        from machineboss_tpu_torch.algo import viterbi_device
        from machineboss_tpu_torch.parallel import em
        self.ms = {"machine_build": 0.0, "compiled_setup": 0.0,
                   "entry_point": 0.0}
        self.results = []
        self._patches = [
            (cli, "_build_machine", "machine_build", False),
            (dispatch.CompiledMachine, "__init__", "compiled_setup", False),
            (dispatch.CompiledMachine, "log_forward_batch", "entry_point",
             True),
            (viterbi_device, "device_viterbi_matrices", "entry_point", True),
            (em, "device_counts", "entry_point", True)]
        self._saved = []

    def __enter__(self):
        for owner, name, key, keep in self._patches:
            fn = getattr(owner, name)
            self._saved.append((owner, name, fn))
            setattr(owner, name, self._timed(fn, key, keep))
        return self

    def __exit__(self, *exc):
        for owner, name, fn in self._saved:
            setattr(owner, name, fn)

    def _timed(self, fn, key, keep):
        def wrapper(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            self.ms[key] += (time.perf_counter() - t0) * 1e3
            if keep:
                self.results.append(out)
            return out
        return wrapper


def run_cli(argv):
    """One in-process cli.main call: (status, stdout, stderr, launches of
    every counted kernel in the call, the call's ms split, the device
    entry points' results)."""
    import contextlib
    import io
    from machineboss_tpu_torch import cli
    wrappers = counts()
    for w in wrappers.values():
        w.launches = 0
    out, err = io.StringIO(), io.StringIO()
    with CliSplit() as split, contextlib.redirect_stdout(out), \
            contextlib.redirect_stderr(err):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        status = cli.main(list(argv))
        torch.cuda.synchronize()
        total = (time.perf_counter() - t0) * 1e3
    launches = {k: w.launches for k, w in wrappers.items()}
    ms = dict(split.ms, total=total)
    ms["rest"] = total - sum(split.ms.values())
    return status, out.getvalue(), err.getvalue(), launches, ms, \
        split.results


def cli_expect(name, launches, kernels):
    """The call launched each of `kernels` once and no other kernel."""
    want = {k: int(k in kernels) for k in launches}
    check(launches == want, "cli %s: launches %s, expected one of each of %s"
          % (name, {k: v for k, v in launches.items() if v}, kernels))


def score_table(names, values):
    """The CLI's score table text for (input name, output name) pairs and
    scores, as cli.py formats it."""
    from machineboss_tpu_torch.utils.jsonfmt import (infinity_safe_string,
                                                     write_escaped)
    rows = ['["%s","%s",%s]' % (write_escaped(a), write_escaped(b),
                                infinity_safe_string(float(v)))
            for (a, b), v in zip(names, values)]
    return "[" + ",\n ".join(rows) + "]\n"


def cli_trace(argv, out, trace_dir):
    """The CLI call once more under profiling.trace_if: it prints the same
    output, and its Chrome trace names the lowrank kernel's CUDA function
    once."""
    import glob
    import os
    from machineboss_tpu_torch.utils import profiling
    with profiling.trace_if(trace_dir):
        traced = run_cli(argv)
    check(traced[0] == 0 and traced[1] == out,
          "cli prot2dna: the traced call printed otherwise")
    kernel_events = []
    for path in glob.glob(os.path.join(trace_dir, "*.json")):
        with open(path) as f:
            trace = json.load(f)
        kernel_events += [e["name"] for e in trace.get("traceEvents", [])
                          if e.get("cat") == "kernel"]
    lowrank_events = [n for n in kernel_events
                      if "lowrank_wavefront_kernel" in n]
    check(len(lowrank_events) == 1,
          "cli prot2dna: the trace holds %d lowrank_wavefront_kernel events"
          % len(lowrank_events))
    return {"kernel_events": len(kernel_events),
            "lowrank_event": lowrank_events[0],
            "traced_ms": traced[4]["total"]}


def cli_module_entry():
    """`python -m machineboss_tpu_torch` as a user starts it, on the card
    by default: exit 0, and the JAX CLI's score within
    CLI_SUBPROCESS_TOL."""
    import os
    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    sub = subprocess.run(
        [sys.executable, "-m", "machineboss_tpu_torch", "--preset",
         "prot2dna", "-U", "--input-chars", "MKV", "--output-chars",
         "ATGAAAGTT", "--loglike", "--engine", "device"], cwd=root,
        capture_output=True, text=True, timeout=300)
    sub_s = time.perf_counter() - t0
    check(sub.returncode == 0, "python -m machineboss_tpu_torch: exit %d: %s"
          % (sub.returncode, sub.stderr[-2000:]))
    sub_ll = json.loads(sub.stdout)[0][2]
    check(abs(sub_ll - JAX_CLI_MKV_LL) <= CLI_SUBPROCESS_TOL,
          "python -m machineboss_tpu_torch scored %r, the JAX CLI %r"
          % (sub_ll, JAX_CLI_MKV_LL))
    return {"loglike": sub_ll, "jax_cli": JAX_CLI_MKV_LL, "seconds": sub_s}


def cli_phase(dev, card, smi, B=512, Lp=64, B1d=256, L1d=10000, S1d=64,
              B_align=64, L_band=1500, band=16, B_counts=16, n_host=2):
    """The port's command line at the main path's full width, in process
    (cli.main with stdout captured) on files written to a temporary
    directory: prot2dna --loglike (B pairs of Lp aa x 3Lp nt, the lowrank
    kernel), a 64-state 1D generator with --output-fasta of B1d reads of
    L1d (scan1d), --align --viterbi on align_prot2dna's B_align pairs (the
    batched fill and the walk), --align --wiggle-room on align_banded's
    pair (the banded fill and the walk) and --counts on B_counts of the em
    batch's pairs (the E-step, no kernel of the kernels line). Each call's
    launches are read, its printed scores must be the strings a direct
    call of the same entry point gives, 8 pairs are held to the float64
    oracle, alignments to the host ViterbiMatrix's (n_host pairs; every
    pair's to the direct call's) with no fallback, counts to a direct
    device_counts call. Then the prot2dna call once under
    profiling.trace_if (its trace must name the lowrank kernel) and
    `python -m machineboss_tpu_torch` once as a subprocess."""
    import os
    import shutil
    import tempfile
    from machineboss_tpu_torch.algo.dp_host import ViterbiMatrix
    from machineboss_tpu_torch.algo.viterbi_device import \
        device_viterbi_matrices
    from machineboss_tpu_torch.core.presets import make_preset
    from machineboss_tpu_torch.core.seqpair import (
        Envelope, NamedSeq, SeqPair, SeqPairList)
    from machineboss_tpu_torch.dispatch import CompiledMachine
    from machineboss_tpu_torch.ops.host_oracle import viterbi_2d_f64
    from machineboss_tpu_torch.parallel.em import device_counts
    from machineboss_tpu_torch.core.machine import Machine
    from machineboss_tpu_torch.testmachines import (
        align_pair, build_generator_1d, build_random_transducer,
        forward_1d_f64, prot2dna_pairs)
    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="cli_phase_")
    record = {"phase": "cli"}

    def write(name, text):
        path = os.path.join(tmp, name)
        with open(path, "w") as f:
            f.write(text)
        return path

    def spl(pairs):
        return SeqPairList([SeqPair(NamedSeq("x%d" % n, list(a)),
                                    NamedSeq("y%d" % n, list(b)))
                            for n, (a, b) in enumerate(pairs)])

    def names(pairs):
        return [("x%d" % n, "y%d" % n) for n in range(len(pairs))]

    def ok(name, res):
        status, out, err = res[:3]
        check(status == 0, "cli %s: exit %s: %s" % (name, status, err))
        return out

    # -- prot2dna --loglike: the lowrank kernel
    p2d = make_preset("prot2dna")
    params = p2d.get_param_defs(True)
    pairs = prot2dna_pairs(B, Lp, seed=0)
    data = write("prot2dna.json", spl(pairs).to_json_str())
    argv = ["--preset", "prot2dna", "-U", "--data", data, "--loglike",
            "--engine", "device"]
    res = run_cli(argv)
    out = ok("prot2dna", res)
    cli_expect("prot2dna", res[3], ["lowrank_wavefront"])
    cm = CompiledMachine(p2d, params, device=dev)
    lls = cm.log_forward_batch(pairs)
    check(out == score_table(names(pairs), lls),
          "cli prot2dna: the printed scores are not the direct call's")
    toks = [(cm.in_toks(i), cm.out_toks(o)) for i, o in pairs]
    gate = score_err(lls[:8], f64_scores(cm._host_mats(), toks[:8],
                                         key=("prot2dna", 8)))
    check(gate <= GATE_TOL, "cli prot2dna: f64 gate %.3g nats" % gate)
    record["prot2dna_loglike"] = {
        "pairs": B, "Li": Lp, "Lo": 3 * Lp, "ms": res[4],
        "launches": {k: v for k, v in res[3].items() if v},
        "f64_gate_max_abs": gate, "f64_gate_pairs": 8}

    record["prot2dna_trace"] = cli_trace(argv, out, os.path.join(tmp,
                                                                 "trace"))

    # -- a 1D generator with --output-fasta: the scan1d kernel
    rng = np.random.RandomState(42)
    gen = build_generator_1d(S1d, rng=rng)
    sym = np.array(list("ACGT"))
    reads = ["".join(sym[rng.randint(0, 4, L1d)]) for _ in range(B1d)]
    gen_path = write("gen1d.json", gen.to_json_str())
    fasta = write("reads.fa", "".join(">r%d\n%s\n" % (n, s)
                                      for n, s in enumerate(reads)))
    res = run_cli([gen_path, "--output-fasta", fasta, "--loglike",
                   "--engine", "device"])
    out = ok("generator_1d", res)
    cli_expect("generator_1d", res[3], ["scan1d"])
    gen = Machine.from_file(gen_path)              # as the CLI loads it
    cm1 = CompiledMachine(gen, gen.get_param_defs(True), device=dev)
    pairs1 = [("", r) for r in reads]
    lls1 = cm1.log_forward_batch(pairs1)
    check(out == score_table([("", "r%d" % n) for n in range(B1d)], lls1),
          "cli generator_1d: the printed scores are not the direct call's")
    trans, closure = cm1._cache[("1d_mats", True)]
    t1d = np.array([cm1.out_toks(r) for r in reads[:8]], np.int32)
    gate = score_err(lls1[:8], forward_1d_f64(trans, closure, t1d,
                                              np.full(len(t1d), L1d,
                                                      np.int32)))
    check(gate <= GATE_TOL, "cli generator_1d: f64 gate %.3g nats" % gate)
    record["generator_1d_loglike"] = {
        "states": S1d, "reads": B1d, "L": L1d, "ms": res[4],
        "launches": {k: v for k, v in res[3].items() if v},
        "f64_gate_max_abs": gate, "f64_gate_pairs": 8}

    # -- alignments: the batched fill and the banded fill, and the walk
    def trans_of(path):
        return [(t.in_, t.out, t.dest) for t in path.trans]

    def align_case(name, machine, pairs_sp, wiggle, kernels):
        m_path = write(name + ".json", machine.to_json_str())
        d_path = write(name + "-data.json",
                       SeqPairList(pairs_sp).to_json_str())
        argv = [m_path, "-U", "--data", d_path, "--align", "--viterbi",
                "--engine", "device"]
        if wiggle is not None:
            argv += ["--wiggle-room", str(wiggle)]
        res = run_cli(argv)
        out = ok(name, res)
        cli_expect(name, res[3], kernels)
        mats = res[5][0]
        machine = Machine.from_file(m_path)        # as the CLI loads it
        fallbacks = sum(m._full is not None for m in mats)
        check(fallbacks == 0, "cli %s: %d pairs fell back to the full "
              "readback" % (name, fallbacks))
        ev = evaluated(machine)
        envs = [Envelope(sp, wiggle) for sp in pairs_sp] \
            if wiggle is not None else None
        direct = device_viterbi_matrices(ev, pairs_sp, envelopes=envs,
                                         device=dev)
        vit = [m.log_like() for m in direct]
        aligned = SeqPairList([SeqPair.from_path(
            m.path(machine), machine, sp.input.name, sp.output.name)
            for m, sp in zip(direct, pairs_sp)])
        check(out == score_table([(sp.input.name, sp.output.name)
                                  for sp in pairs_sp], vit)
              + aligned.to_json_str() + "\n",
              "cli %s: the output is not the direct call's" % name)
        t0 = time.perf_counter()
        for b in range(min(n_host, len(pairs_sp))):
            host = ViterbiMatrix(ev, pairs_sp[b],
                                 env=envs[b] if envs else None)
            check(trans_of(host.traceback(machine))
                  == trans_of(direct[b].path(machine)),
                  "cli %s: pair %d is not aligned as the host aligns it"
                  % (name, b))
        host_s = time.perf_counter() - t0
        if envs:
            ref = np.array([ViterbiMatrix(ev, pairs_sp[0], env=envs[0])
                            .log_like()])
        else:
            m64 = maxplus_mats(ev, np.float64)
            ref = np.array([viterbi_2d_f64(
                *m64, np.array(ev.input_tokenizer.tokenize(sp.input.seq))
                - 1, np.array(ev.output_tokenizer.tokenize(sp.output.seq))
                - 1) for sp in pairs_sp[:8]])
        gate = score_err(vit[:len(ref)], ref)
        check(gate <= GATE_TOL, "cli %s: f64 gate %.3g nats" % (name, gate))
        record[name] = {"pairs": len(pairs_sp), "wiggle_room": wiggle,
                        "ms": res[4],
                        "launches": {k: v for k, v in res[3].items() if v},
                        "fallbacks": fallbacks, "host_pairs": n_host,
                        "host_s": host_s, "f64_gate_max_abs": gate,
                        "f64_gate_pairs": len(ref)}

    align_case("align_prot2dna", p2d,
               [SeqPair(NamedSeq("x%d" % n, list(a)),
                        NamedSeq("y%d" % n, list(b)))
                for n, (a, b) in enumerate(prot2dna_pairs(B_align, Lp,
                                                          seed=0))],
               None, ["viterbi_wavefront", "lattice_walk"])
    sp = align_pair(L_band, mutate=0.1, seed=11)
    align_case("align_banded",
               build_random_transducer(64, list("ACGT"), seed=3), [sp],
               band, ["viterbi_banded_wavefront", "lattice_walk"])

    # -- --counts on the em batch's first pairs: no kernel of the line
    cpairs = prot2dna_pairs(128, Lp, seed=13, synonymous=True)[:B_counts]
    data = write("counts.json", spl(cpairs).to_json_str())
    res = run_cli(["--preset", "prot2dna", "-U", "--data", data, "--counts",
                   "--engine", "device"])
    out = ok("counts", res)
    cli_expect("counts", res[3], [])
    got = json.loads(out)
    direct = device_counts(p2d, params, spl(cpairs), device=dev)
    want = json.loads(direct.param_counts_json_str(p2d, params))
    check(list(got) == list(want), "cli counts: other parameters")
    g = np.array([got[k] for k in got])
    w = np.array([want[k] for k in want])
    excess = float((np.abs(g - w) - CLI_COUNTS_ATOL
                    - CLI_COUNTS_RTOL * np.abs(w)).max())
    check(excess <= 0.0, "cli counts vs a direct device_counts call: %.3g "
          "over tolerance" % excess)
    record["counts"] = {"pairs": B_counts, "ms": res[4],
                        "max_abs_vs_direct": float(np.abs(g - w).max()),
                        "params": len(got)}

    record["module_entry"] = cli_module_entry()
    shutil.rmtree(tmp, ignore_errors=True)
    record.update(seconds=time.perf_counter() - t_phase, card=card,
                  nvidia_smi=smi)
    emit(record)


# ---------------------------------------------------- the neural DP

NEURAL_VS_HOST_TOL = 1e-3        # nats: float32 DP vs the float64 host
NEURAL_FIELD_RTOL = 1e-3         # field gradients summed vs scalar gradient
NEURAL_FD_RTOL = 1e-2            # scalar gradient vs host central difference
NEURAL_GRAD_ATOL = 1e-4          # both: float32's resolution of a gradient
# that is a difference of near-equal terms. At dnapsw's defaults gapOpen's
# gradient is N_open / p - N_not / (1 - p), two terms near 400 (the pair's
# expected counts over 0.5) whose difference is 0.0025: float32 holds such
# a sum to 2^-15 = 3.1e-5 (the card gave -81 * 2^-15 against the host's
# -0.0025055, 1.3% off), so a relative gate alone cannot pass it.
NEURAL_FD_EPS = 1e-4


def neural_phase(dev, card, smi, L=200):
    """ops.dp_neural.neural_log_forward on dnapsw (its defaults: 8 states,
    22 parameters, 10 silent edges) and one pair of L x L random bases:
    constant fields against the float64 host ForwardMatrix, gapOpen and
    gapExtend as (L+1, L+1) fields whose gradients, summed over the cells,
    equal the scalar parameters' gradients, and those equal a central
    difference of the host score (each within its rtol plus
    NEURAL_GRAD_ATOL). The forward and the backward are timed
    (synchronised) and their launches counted under torch.profiler; the
    peak memory of the two."""
    from machineboss_tpu_torch.algo.dp_host import ForwardMatrix
    from machineboss_tpu_torch.core.eval import EvaluatedMachine
    from machineboss_tpu_torch.core.params import param_assign_from_json
    from machineboss_tpu_torch.core.presets import make_preset
    from machineboss_tpu_torch.core.seqpair import NamedSeq, SeqPair
    from machineboss_tpu_torch.ops.dp_neural import neural_log_forward
    from machineboss_tpu_torch.ops.exprjit import ParameterizedMachine
    t_phase = time.perf_counter()
    m = make_preset("dnapsw")
    params = m.get_param_defs(True)
    ev = EvaluatedMachine(m, params)
    rng = np.random.RandomState(200)
    x = list(rng.choice(list("ACGT"), L))
    y = list(rng.choice(list("ACGT"), L))
    sp = SeqPair(NamedSeq("x", x), NamedSeq("y", y))
    it = [ev.input_tokenizer.sym2tok[c] - 1 for c in x]
    ot = [ev.output_tokenizer.sym2tok[c] - 1 for c in y]
    values = {k: float(v) for k, v in params.defs.items()}
    pm = ParameterizedMachine(m, device=dev)

    def host(p=params):
        return ForwardMatrix(EvaluatedMachine(m, p), sp).log_like()

    t0 = time.perf_counter()
    host_ll = host()
    host_s = time.perf_counter() - t0
    constant = {k: torch.full((L + 1, L + 1), v, device=dev)
                for k, v in values.items()}
    got, first_ms = synced_ms(lambda: neural_log_forward(pm, it, ot,
                                                         constant))
    err = abs(float(got) - host_ll)
    check(err <= NEURAL_VS_HOST_TOL, "neural: constant fields vs host %.3g "
          "nats" % err)

    names = ("gapOpen", "gapExtend")
    fields = {k: torch.full((L + 1, L + 1), values[k], device=dev,
                            requires_grad=True) for k in names}
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    score, fwd_ms = synced_ms(lambda: neural_log_forward(
        pm, it, ot, {**values, **fields}))
    _, bwd_ms = synced_ms(score.backward)
    peak = torch.cuda.max_memory_allocated() - mem0
    # the timed calls on fields of their own: a backward accumulates
    timing = {k: torch.full((L + 1, L + 1), values[k], device=dev,
                            requires_grad=True) for k in names}
    fwd_rec, _ = call_record(lambda: neural_log_forward(
        pm, it, ot, {**values, **timing}))
    bwd_rec, _ = call_record(lambda: neural_log_forward(
        pm, it, ot, {**values, **timing}).backward())
    scalars = {k: torch.tensor(values[k], device=dev, requires_grad=True)
               for k in names}
    neural_log_forward(pm, it, ot, {**values, **scalars}).backward()
    grads = {}
    for k in names:
        g_scalar = float(scalars[k].grad)
        g_field = float(fields[k].grad.sum())
        check(abs(g_field - g_scalar) <= NEURAL_FIELD_RTOL * abs(g_scalar)
              + NEURAL_GRAD_ATOL, "neural: %s field gradient %r vs scalar %r"
              % (k, g_field, g_scalar))
        fd = (host(params.combine(param_assign_from_json(
            {k: values[k] + NEURAL_FD_EPS}), True))
              - host(params.combine(param_assign_from_json(
                  {k: values[k] - NEURAL_FD_EPS}), True))) \
            / (2 * NEURAL_FD_EPS)
        check(abs(g_scalar - fd) <= NEURAL_FD_RTOL * abs(fd)
              + NEURAL_GRAD_ATOL,
              "neural: %s gradient %r vs host difference %r"
              % (k, g_scalar, fd))
        grads[k] = {"scalar": g_scalar, "fields_summed": g_field,
                    "host_central_difference": fd,
                    "fields_vs_scalar": abs(g_field - g_scalar),
                    "scalar_vs_difference": abs(g_scalar - fd),
                    "scalar_vs_difference_rel": abs(g_scalar - fd) / abs(fd)}
    emit({"phase": "neural", "machine": "dnapsw", "S": pm.n_states,
          "edges": len(pm.edges), "L": L, "host_ll": host_ll,
          "host_s": host_s, "ll": float(got), "vs_host": err,
          "first_call_ms": first_ms, "forward_ms": fwd_ms,
          "backward_ms": bwd_ms, "forward": fwd_rec,
          "forward_and_backward": bwd_rec, "gradients": grads,
          "peak_bytes": peak, "peak_gib": peak / 2 ** 30,
          "seconds": time.perf_counter() - t_phase,
          "card": card, "nvidia_smi": smi})


# ------------------------------------------------ device CTC prefix scoring

CTC_VS_HOST_TOL = 1e-3           # the JAX test's TOL


def ctc_device_phase(dev, card, smi, Lp=64, levels=16, host_budget_s=30.0):
    """algo.ctc_device.CTCDeviceModel on prot2dna (-U defaults) and one
    read: the 3Lp-nt coding sequence of an Lp-aa protein from
    prot2dna_pairs (GeneWise's decode: which protein does this read
    encode). The model's build (s, bytes on the card), fill at the root,
    then fill_all_tokens down the read's own protein, `levels` levels, each
    level's 20 children held to the host PrefixTree._extend_node's seq
    and prefix cells and log prefix probabilities within CTC_VS_HOST_TOL
    (the model is float64, as the host tree is); a level is
    left out (and listed in `reduced`) once the host side would pass
    host_budget_s."""
    from machineboss_tpu_torch.algo.ctc import PrefixTree
    from machineboss_tpu_torch.algo.ctc_device import CTCDeviceModel
    from machineboss_tpu_torch.core.presets import make_preset
    from machineboss_tpu_torch.testmachines import prot2dna_pairs
    t_phase = time.perf_counter()
    m = make_preset("prot2dna")
    ev = evaluated(m)
    protein, read = prot2dna_pairs(1, Lp, seed=0)[0]
    syms = list(read)
    toks = ev.output_tokenizer.tokenize(syms)
    mem0 = torch.cuda.memory_allocated()
    model, build_ms = synced_ms(lambda: CTCDeviceModel(ev, toks,
                                                       device=dev))
    model_bytes = torch.cuda.memory_allocated() - mem0

    def cells_err(a, b):
        a = np.asarray(a, np.float64)
        b = np.asarray(b, np.float64)
        live = b > -1e20
        check(np.all(a[~live] < -1e20), "ctc_device: a dead cell is live")
        return float(np.abs(np.where(live, a - b, 0)).max())

    def lpp_err(a, b):
        if not np.isfinite(b) or b < -1e20:
            check(a < -1e20, "ctc_device: an impossible prefix scored")
            return 0.0
        return abs(float(a) - b)

    t0 = time.perf_counter()
    tree = PrefixTree(ev, syms)
    host_s = time.perf_counter() - t0
    seq, pref, lpp = model.fill(np.zeros((len(syms) + 1, ev.n_states())), 0)
    root_err = max(cells_err(seq, tree.root.seq_cell),
                   cells_err(pref, tree.root.prefix_cell),
                   lpp_err(lpp, tree.root.log_prefix_prob))
    check(root_err <= CTC_VS_HOST_TOL, "ctc_device: root vs host %.3g"
          % root_err)
    node, per_level, level_s = tree.root, [], 0.0
    for level in range(levels):
        if host_s + level_s > host_budget_s:
            break
        (seqs, prefs, lpps), fill_ms = synced_ms(
            lambda: model.fill_all_tokens(node.seq_cell))
        t0 = time.perf_counter()
        tree._extend_node(node)
        level_s = time.perf_counter() - t0
        host_s += level_s
        check(len(node.child) == seqs.shape[0],
              "ctc_device: %d children, %d candidates"
              % (len(node.child), seqs.shape[0]))
        err_seq = max(cells_err(seqs[c.in_tok - 1], c.seq_cell)
                      for c in node.child)
        err_pref = max(cells_err(prefs[c.in_tok - 1], c.prefix_cell)
                       for c in node.child)
        err_lpp = max(lpp_err(lpps[c.in_tok - 1], c.log_prefix_prob)
                      for c in node.child)
        check(max(err_seq, err_pref, err_lpp) <= CTC_VS_HOST_TOL,
              "ctc_device: level %d vs host %.3g, %.3g, %.3g"
              % (level, err_seq, err_pref, err_lpp))
        per_level.append({"fill_all_tokens_ms": fill_ms,
                          "seq_cells_max_abs": err_seq,
                          "prefix_cells_max_abs": err_pref,
                          "log_prefix_prob_max_abs": err_lpp,
                          "host_extend_s": level_s})
        tok = ev.input_tokenizer.sym2tok[protein[level]]
        node = next(c for c in node.child if c.in_tok == tok)
    check(per_level, "ctc_device: no level ran")
    rec, _ = call_record(lambda: model.fill_all_tokens(node.seq_cell))
    reduced = [] if len(per_level) == levels else [
        "levels %d of %d: the host side passed %.0f s"
        % (len(per_level), levels, host_budget_s)]
    emit({"phase": "ctc_device", "machine": "prot2dna", "S": ev.n_states(),
          "candidates": model.n_in - 1, "read_nt": len(syms),
          "protein_aa": Lp, "build_ms": build_ms,
          "model_bytes_on_card": model_bytes, "levels": len(per_level),
          "reduced": reduced, "root_max_abs": root_err,
          "per_level": per_level, "fill_all_tokens": rec,
          "host_s": host_s, "seconds": time.perf_counter() - t_phase,
          "card": card, "nvidia_smi": smi})


# ------------------------------------------ the parallel layer (NCCL, N=1)

PARALLEL_VS_LOWRANK_TOL = 5e-3   # nats: the wavefront engine vs lowrank's
                                 # signed SVD factors (KERNEL_VS_F64_TOL)


def diag_chain_f64(mats, x, y):
    """The float64 Forward of one pair on a machine whose every
    transition consumes an input and emits an output (bench.py's dense
    machine: no left or up class), where only the cells i == o live: the
    2D recurrence is then the 1D chain cell(k,k) = cell(k-1,k-1) (x)
    D[x_k, y_k] (x) C, scored by testmachines.forward_1d_f64 over the
    tokens x_k * To + y_k."""
    from machineboss_tpu_torch.testmachines import forward_1d_f64
    a_diag, a_left, a_up, closure = (np.asarray(m, np.float64) for m in mats)
    check((a_left <= NEG).all() and (a_up <= NEG).all(),
          "diag_chain_f64: the machine has a left or an up class")
    check(len(x) == len(y), "diag_chain_f64: the pair's lengths differ")
    Ti, To, S, _ = a_diag.shape
    em = np.where(a_diag > NEG, np.exp(np.minimum(a_diag, 700.0)), 0.0)
    cl = np.where(closure > NEG, np.exp(np.minimum(closure, 700.0)), 0.0)
    step = np.einsum("tij,jk->tik", em.reshape(Ti * To, S, S), cl)
    with np.errstate(divide="ignore"):
        trans = np.where(step > 0, np.log(np.maximum(step, 1e-300)), -1e30)
    toks = np.asarray(x, np.int64) * To + np.asarray(y, np.int64)
    return float(forward_1d_f64(trans, closure, toks[None], [len(toks)])[0])


def parallel_phase(dev, card, smi, p2d_cm, p2d_pairs, p2d_lls, dense_cm,
                   dense_pairs, em_B=128, em_Lp=64, fit_B=8, fit_Lp=16,
                   L1d=10000, S1d=64,
                   L2d=2000, n_profile=256, n_profile_2d=128,
                   mesh_device=None):
    """The parallel layer (parallel/*) on a world of one (make_mesh with
    mesh_device, None: the card, NCCL), each part through the entry point a
    user calls:
    (a) parallel.infer.forward_batch_sharded on the main path's prot2dna
        pairs (the scaled wavefront engine): the f64 gate on 8 pairs, and
        every pair against the main path's lowrank scores;
    (b) lowrank (prot2dna), merged and chained (chain 8; dense_uniform)
        from make_wavefront_forward, each scoring the rank's block of the
        batch, all-gathered on the 'data' axis: bit-equal to the factory's
        call on the whole batch, one launch of the kernel each;
    (c) parallel.em.device_counts(mesh=) on the em phase's pairs, bit-equal
        to mesh=None (no padding on one rank; a SUM over one rank is a
        copy), and one MachineFitter(engine="device", mesh=) iteration on
        the em phase's fit set (fit_B flanked pairs of fit_Lp aa: the
        M-step, not the batch, sets a fit iteration's time) against the
        mesh-less one: the same parameters;
    (d) the length-sharded and (e) the state-sharded scan on dense1d's
        generator, one sequence of L1d, against dp1d.forward_1d_scan and
        forward_1d_f64 (their float32 drift printed); the state scan's
        collectives counted;
    (f) the diagonal-sharded wavefront on dense_uniform's machine, one pair
        of L2d x L2d, against ops.wavefront.forward_2d_wavefront and
        diag_chain_f64.
    Device launches are counted under torch.profiler, for (e) on the first
    n_profile tokens and for (f) on an n_profile_2d square cut (the
    tracing costs some 40 us a launch). Ends with
    destroy_process_group()."""
    import torch.distributed as dist
    from machineboss_tpu_torch.algo.fitter import MachineFitter
    from machineboss_tpu_torch.core.presets import make_preset
    from machineboss_tpu_torch.core.seqpair import (NamedSeq, SeqPair,
                                                    SeqPairList)
    from machineboss_tpu_torch.dispatch import CompiledMachine
    from machineboss_tpu_torch.ops import dp1d
    from machineboss_tpu_torch.ops.kernels import wavefront_kernel as wk
    from machineboss_tpu_torch.ops.wavefront import forward_2d_wavefront
    from machineboss_tpu_torch.parallel import mesh as pm
    from machineboss_tpu_torch.parallel.em import device_counts
    from machineboss_tpu_torch.parallel.infer import forward_batch_sharded
    from machineboss_tpu_torch.parallel.lengthshard import (
        diag_sharded_wavefront_fn, length_sharded_forward_fn)
    from machineboss_tpu_torch.parallel.stateshard import (
        state_sharded_scan_fn)
    from machineboss_tpu_torch.testmachines import (forward_1d_f64,
                                                    prot2dna_pairs)
    t_phase = time.perf_counter()
    seconds = {}

    def seq_pairs(pairs):
        return [SeqPair(NamedSeq("i", list(a)), NamedSeq("o", list(b)))
                for a, b in pairs]

    def zero_counts():
        wrappers = counts()
        for w in wrappers.values():
            w.launches = 0
        return wrappers

    t0 = time.perf_counter()
    mesh = pm.make_mesh(device=mesh_device)
    init_s = time.perf_counter() - t0
    world = {"world_size": dist.get_world_size(),
             "backend": dist.get_backend(),
             "mesh": dict(zip(mesh.mesh_dim_names, mesh.mesh.shape)),
             "device": str(pm.mesh_device(mesh)), "init_s": init_s}
    check(world["world_size"] == 1, "the card's world is one rank")
    try:
        # (a) data-parallel inference on the main path's pairs
        t0 = time.perf_counter()
        sps = seq_pairs(p2d_pairs)
        wrappers = zero_counts()
        torch.cuda.reset_peak_memory_stats()
        scores, first_ms = synced_ms(
            lambda: forward_batch_sharded(p2d_cm.ev, sps, mesh))
        peak = torch.cuda.max_memory_allocated()
        check(all(w.launches == 0 for w in wrappers.values()),
              "infer: the wavefront engine launched a kernel of the line")
        _, names = cuda_activity(
            lambda: forward_batch_sharded(p2d_cm.ev, sps, mesh))
        times = [synced_ms(lambda: forward_batch_sharded(p2d_cm.ev, sps,
                                                         mesh))[1]
                 for _ in range(5)]
        toks = [(p2d_cm.in_toks(i), p2d_cm.out_toks(o))
                for i, o in p2d_pairs]
        n_gate = 8
        gate = score_err(scores[:n_gate], f64_scores(
            p2d_cm._host_mats(), toks[:n_gate], key=("prot2dna", n_gate)))
        check(gate <= GATE_TOL, "infer: f64 gate %.3g nats" % gate)
        vs_lowrank = score_err(scores, p2d_lls)
        check(vs_lowrank <= PARALLEL_VS_LOWRANK_TOL,
              "infer: vs the lowrank kernel %.3g nats" % vs_lowrank)
        B = len(p2d_pairs)
        Lp, Lo = len(p2d_pairs[0][0]), len(p2d_pairs[0][1])
        call_ms = float(np.median(times))
        infer = {"B": B, "Lp": Lp, "Lo": Lo, "reduced": [],
                 "first_call_ms": first_ms, "call_ms_median5": call_ms,
                 "ms_all": times, "peak_bytes": peak,
                 "launches_per_call": len(device_kernels(names)),
                 "copies_per_call": len(names) - len(device_kernels(names)),
                 "collective_kernels": collective_names(names),
                 "state_cells_per_s": B * (Lp + 1) * (Lo + 1)
                 * p2d_cm.ev.n_states() / (call_ms / 1e3),
                 "f64_gate_max_abs": gate, "f64_gate_pairs": n_gate,
                 "vs_lowrank_max_abs": vs_lowrank}
        seconds["infer"] = time.perf_counter() - t0

        # (b) the kernels on the rank's block, all-gathered
        t0 = time.perf_counter()
        n = pm.axis_size(mesh, "data")
        idx = pm.axis_index(mesh, "data")
        blocks = {}
        for name, cm, pairs, kw, kernel in (
                ("lowrank", p2d_cm, p2d_pairs, {"variant": "lowrank"},
                 "lowrank_wavefront"),
                ("merged", dense_cm, dense_pairs, {"merged": True},
                 "merged_wavefront"),
                ("chained", dense_cm, dense_pairs,
                 {"variant": "chained", "chain": 8}, "chained_wavefront")):
            mats = cm._host_mats()
            batch = factory_batch([(cm.in_toks(i), cm.out_toks(o))
                                   for i, o in pairs])
            (Bk, Li), Lo = batch[0].shape, batch[1].shape[1]
            direct = wk.make_wavefront_forward(*mats, Bk, Li, Lo,
                                               device=pm.mesh_device(mesh),
                                               **kw)(*batch)
            local = wk.make_wavefront_forward(*mats, Bk // n, Li, Lo,
                                              device=pm.mesh_device(mesh),
                                              **kw)
            blk = slice(idx * (Bk // n), (idx + 1) * (Bk // n))

            def sharded():
                return pm.all_gather(local(*(x[blk] for x in batch)), mesh,
                                     "data").reshape(Bk)

            wrappers = zero_counts()
            got = sharded()
            launched = {k: w.launches for k, w in wrappers.items()
                        if w.launches}
            check(launched == {kernel: 1},
                  "%s on the mesh launched %s" % (name, launched))
            check(torch.equal(got, direct),
                  "%s: the all-gathered blocks differ from the direct call"
                  % name)
            _, names = cuda_activity(sharded)
            blocks[name] = {
                "kernel": kernel, "B": Bk, "launches": launched.get(kernel, 0),
                "sharded_call_ms_median3": float(np.median(
                    [synced_ms(sharded)[1] for _ in range(3)])),
                "collective_kernels": collective_names(names),
                "bit_equal": True}
        seconds["kernels"] = time.perf_counter() - t0

        # (c) the data-parallel E-step and one fit iteration
        t0 = time.perf_counter()
        m = make_preset("prot2dna")
        params = m.get_param_defs(True)
        spl = SeqPairList(seq_pairs(prot2dna_pairs(em_B, em_Lp, seed=13,
                                                   synonymous=True)))
        plain, plain_ms = synced_ms(lambda: device_counts(m, params, spl,
                                                          device=dev))
        meshed, mesh_ms = synced_ms(lambda: device_counts(m, params, spl,
                                                          mesh=mesh))
        check(np.array_equal(np.concatenate(plain.count),
                             np.concatenate(meshed.count))
              and plain.loglike == meshed.loglike,
              "em: device_counts(mesh=) differs from mesh=None")
        fit_spl = SeqPairList(seq_pairs(prot2dna_pairs(
            fit_B, fit_Lp, seed=14, synonymous=True, flank=8)))
        fits, fit_s = {}, {}
        for key, kw in (("plain", {"device": dev}), ("mesh", {"mesh": mesh})):
            t1 = time.perf_counter()
            fitted = MachineFitter(machine=m, seed=params, engine="device",
                                   **kw).fit(fit_spl, max_iterations=1)
            fit_s[key] = time.perf_counter() - t1
            fits[key] = {k: float(fitted.defs[k]) for k in fitted.defs}
        check(fits["plain"] == fits["mesh"],
              "em: a fit iteration on the mesh differs from one without")
        em = {"B": em_B, "Lp": em_Lp, "fit_B": fit_B, "fit_Lp": fit_Lp,
              "estep_ms": plain_ms,
              "estep_mesh_ms": mesh_ms, "counts_bit_equal": True,
              "fit_iteration_s": fit_s, "fit_params": len(fits["mesh"]),
              "fit_params_equal": True, "loglike": meshed.loglike}
        seconds["em"] = time.perf_counter() - t0

        # (d), (e) the length- and state-sharded scans on dense1d's generator
        t0 = time.perf_counter()
        gen, seqs = dense1d_batch(B=1, L=L1d, S=S1d)
        cm1d = CompiledMachine(gen, device=dev)
        trans, closure = cm1d.lowered.emit_matrices_1d(output_side=True)
        toks1d = np.asarray(cm1d.out_toks(seqs[0][1]), np.int64)
        tt, ct = (torch.from_numpy(np.ascontiguousarray(x)).to(dev)
                  for x in (trans, closure))
        tk = torch.from_numpy(toks1d).to(dev)
        f64 = float(forward_1d_f64(trans, closure, toks1d[None], [L1d])[0])
        scan, scan_ms = synced_ms(
            lambda: float(dp1d.forward_1d_scan(tt, ct, tk, L1d)))
        length_fn = length_sharded_forward_fn(mesh)
        vec, length_ms = synced_ms(lambda: length_fn(tt, ct, tk, L1d))
        ll_len = float(vec[-1])
        state_fn = state_sharded_scan_fn(mesh)
        gathers = [0]
        real_gather = pm.MeshAxis.all_gather

        def counted(self, x):
            gathers[0] += 1
            return real_gather(self, x)

        pm.MeshAxis.all_gather = counted
        try:
            ll_state, state_ms = synced_ms(
                lambda: float(state_fn(tt, ct, tk, L1d)))
        finally:
            pm.MeshAxis.all_gather = real_gather
        _, len_names = cuda_activity(lambda: length_fn(tt, ct, tk, L1d))
        cut = min(n_profile, L1d)
        _, state_names = cuda_activity(lambda: state_fn(tt, ct, tk[:cut],
                                                        cut))
        scans = {}
        for name, ll, ms, names, per in (
                ("length", ll_len, length_ms, len_names, None),
                ("state", ll_state, state_ms, state_names, cut)):
            err_scan, err_f64 = abs(ll - scan), abs(ll - f64)
            check(max(err_scan, err_f64) <= GATE_TOL,
                  "%s-sharded scan: vs scan %.3g, vs f64 %.3g nats"
                  % (name, err_scan, err_f64))
            launches = len(device_kernels(names))
            scans[name] = {
                "ll": ll, "call_ms": ms, "vs_scan_max_abs": err_scan,
                "f32_drift_vs_f64": ll - f64,
                "collective_kernels": collective_names(names)}
            if per is None:
                scans[name]["launches_per_call"] = launches
            else:
                scans[name]["launches_per_token"] = launches / per
                scans[name]["launches_per_token_profiled_on"] = per
        scans["state"]["all_gathers_per_call"] = gathers[0]
        scans["scan"] = {"ll": scan, "call_ms": scan_ms, "f64": f64,
                         "f32_drift_vs_f64": scan - f64, "S": trans.shape[-1],
                         "L": L1d}
        seconds["scans"] = time.perf_counter() - t0

        # (f) one long lattice split over the 'len' axis
        t0 = time.perf_counter()
        rng = np.random.RandomState(7)
        sym = np.array(list("ACGT"))
        x = "".join(sym[rng.randint(0, 4, L2d)])
        y = "".join(sym[rng.randint(0, 4, L2d)])
        mats = dense_cm._host_mats()
        mt = [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in mats]
        xt, yt = dense_cm.in_toks(x), dense_cm.out_toks(y)
        pair = [torch.tensor([t], dtype=torch.int64, device=dev)
                for t in (xt, yt)]
        lens = [torch.tensor([L2d], dtype=torch.int64, device=dev)] * 2
        diag_fn = diag_sharded_wavefront_fn(mesh)
        got, diag_ms = synced_ms(lambda: float(diag_fn(*mt, *pair,
                                                       *lens)[0]))
        ref, ref_ms = synced_ms(lambda: float(forward_2d_wavefront(
            *mt, *pair, *lens)[0]))
        f64_2d = diag_chain_f64(mats, xt, yt)
        err_ref, err_f64 = abs(got - ref), abs(got - f64_2d)
        check(max(err_ref, err_f64) <= GATE_TOL,
              "diag-sharded: vs wavefront %.3g, vs f64 %.3g nats"
              % (err_ref, err_f64))
        cut = min(n_profile_2d, L2d)
        _, names = cuda_activity(lambda: diag_fn(
            *mt, *(p[:, :cut] for p in pair),
            *[torch.full_like(l, cut) for l in lens]))
        per_diag = len(device_kernels(names)) / (2 * cut)
        diag = {"L": L2d, "S": mats[3].shape[0], "ll": got, "call_ms": diag_ms,
                "wavefront_ms": ref_ms, "vs_wavefront_max_abs": err_ref,
                "f64": f64_2d, "f32_drift_vs_f64": got - f64_2d,
                "launches_per_diagonal": per_diag,
                "launches_per_diagonal_profiled_on": [cut, cut],
                "launches_call_from_per_diagonal": per_diag * 2 * L2d,
                "collective_kernels": collective_names(names)}
        seconds["diag"] = time.perf_counter() - t0
    finally:
        dist.destroy_process_group()
    emit({"phase": "parallel", **world, "infer": infer, "kernels": blocks,
          "em": em, "scans": scans, "diag": diag, "seconds_by_part": seconds,
          "seconds": time.perf_counter() - t_phase, "card": card,
          "nvidia_smi": smi})


def single_pair_paths(dev, card, smi):
    """The four phases of the single-pair and sparse engines (the row
    kernel under the 2D single-pair calls, eager torch under the rest) and
    the row kernel's profile. Returns the kernels-line entry of
    row_scan."""
    row = single_pair_2d_phase(dev, card, smi)
    row_profile_phase(dev, card, smi)
    cm1d, toks1d = single_pair_1d_phase(dev, card, smi)
    sparse_phase(dev, card, smi)
    pswm_phase(dev, card, smi, cm1d, toks1d)
    return row


# -- the long shapes: the sizes past a block's shared memory ----------------

def forward_2d_f64_card(mats, x, y, dev):
    """The float64 Forward of one pair on the card: forward_2d_f64's
    recurrence in probability space, each cell's states divided by their
    max with a float64 log scale, one product per class and diagonal over
    every token's block (an oracle of this script's own, where the host's
    numpy oracle would take minutes)."""
    a_diag, a_left, a_up, closure = (
        torch.tensor(np.asarray(m, np.float64), device=dev) for m in mats)
    Ti, To, S, _ = a_diag.shape
    f64 = torch.float64

    def prob(a):
        return torch.where(a > NEG, torch.exp(torch.clamp(a, max=700.0)),
                           torch.zeros_like(a))

    up_cat = prob(a_up).permute(1, 0, 2).reshape(S, To * S)
    left_cat = prob(a_left).permute(1, 0, 2).reshape(S, Ti * S)
    diag_cat = prob(a_diag).reshape(Ti * To, S, S).permute(1, 0, 2) \
        .reshape(S, Ti * To * S)
    has_diag = bool((diag_cat > 0).any())
    C = prob(closure)
    Li, Lo = len(x), len(y)
    W = Li + 1
    xt = torch.tensor(np.asarray(x, np.int64), device=dev)
    yt = torch.tensor(np.asarray(y, np.int64), device=dev)
    i = torch.arange(W, device=dev)
    neg = torch.tensor(-np.inf, dtype=f64, device=dev)

    def norm(p, m):
        mx = p.max(dim=-1).values
        has = mx > 0
        return (torch.where(has[:, None], p / torch.clamp(mx, min=1e-300)
                            [:, None], torch.zeros_like(p)),
                torch.where(has, m + torch.log(torch.clamp(mx, min=1e-300)),
                            neg))

    p1 = torch.zeros((W, S), dtype=f64, device=dev)
    m1 = torch.full((W,), -np.inf, dtype=f64, device=dev)
    p1[0], m1[0] = C[0], 0.0
    p1, m1 = norm(p1, m1)
    p2, m2 = torch.zeros_like(p1), torch.full_like(m1, -np.inf)
    zp, zm = torch.zeros((1, S), dtype=f64, device=dev), neg.reshape(1)
    xi = xt[torch.clamp(i - 1, 0, max(Li - 1, 0))] if Li else i * 0
    for d in range(1, Li + Lo + 1):
        o = d - i
        yo = yt[torch.clamp(o - 1, 0, max(Lo - 1, 0))] if Lo else i * 0
        terms = []
        up = (p1 @ up_cat).reshape(W, To, S)[i, yo]
        terms.append((up, torch.where(o >= 1, m1, neg)))
        left = (p1 @ left_cat).reshape(W, Ti, S)
        left = torch.cat([zp, left[i[:-1], xi[1:]]])
        terms.append((left, torch.where(i >= 1, torch.cat([zm, m1[:-1]]),
                                        neg)))
        if has_diag:
            dg = (p2 @ diag_cat).reshape(W, Ti * To, S)
            dg = torch.cat([zp, dg[i[:-1], (xi * To + yo)[1:]]])
            terms.append((dg, torch.where((i >= 1) & (o >= 1),
                                          torch.cat([zm, m2[:-1]]), neg)))
        mu = torch.stack([m for _, m in terms]).max(dim=0).values
        live = (mu > -np.inf) & (o >= 0) & (o <= Lo)
        mu_s = torch.where(live, mu, torch.zeros_like(mu))
        pre = sum(t * torch.exp(m - mu_s)[:, None] for t, m in terms)
        cur, m = norm(pre @ C, mu_s)
        cur = torch.where(live[:, None], cur, torch.zeros_like(cur))
        m = torch.where(live, m, neg)
        p2, m2, p1, m1 = p1, m1, cur, m
    end = float(p1[Li, S - 1])
    return float(m1[Li]) + np.log(end) if end > 0 else -np.inf


def viterbi_2d_f64_card(mats, x, y, dev):
    """The float64 max-plus score of one pair on the card: viterbi_2d_f64's
    recurrence with each cell's class block gathered by its token."""
    a_diag, a_left, a_up, closure = (
        torch.tensor(np.asarray(m, np.float64), device=dev) for m in mats)
    Ti, To, S, _ = a_diag.shape
    f64 = torch.float64
    Li, Lo = len(x), len(y)
    W = Li + 1
    xt = torch.tensor(np.asarray(x, np.int64), device=dev)
    yt = torch.tensor(np.asarray(y, np.int64), device=dev)
    i = torch.arange(W, device=dev)
    neg = torch.full((1, S), -1e30, dtype=f64, device=dev)
    classes = [(name, m) for name, m in (("up", a_up), ("left", a_left),
                                         ("diag", a_diag.reshape(Ti * To, S,
                                                                 S)))
               if bool((m > NEG).any())]

    def mp(v, blocks):                      # (W, S) x (W, S, S) -> (W, S)
        return (v[:, :, None] + blocks).max(dim=1).values

    p1 = torch.full((W, S), -1e30, dtype=f64, device=dev)
    p1[0] = closure[0]
    p2 = torch.full_like(p1, -1e30)
    xi = xt[torch.clamp(i - 1, 0, max(Li - 1, 0))] if Li else i * 0
    for d in range(1, Li + Lo + 1):
        o = d - i
        yo = yt[torch.clamp(o - 1, 0, max(Lo - 1, 0))] if Lo else i * 0
        pre = torch.full_like(p1, -1e30)
        for name, blocks in classes:
            if name == "up":
                v = torch.where((o >= 1)[:, None], p1, neg)
                pre = torch.maximum(pre, mp(v, blocks[yo]))
            elif name == "left":
                v = torch.where((i >= 1)[:, None], torch.cat([neg, p1[:-1]]),
                                neg)
                pre = torch.maximum(pre, mp(v, blocks[xi]))
            else:
                v = torch.where(((i >= 1) & (o >= 1))[:, None],
                                torch.cat([neg, p2[:-1]]), neg)
                pre = torch.maximum(pre, mp(v, blocks[xi * To + yo]))
        cur = mp(pre, closure.expand(W, S, S))
        cur = torch.where(((o >= 0) & (o <= Lo))[:, None], cur, neg)
        cur = torch.where(cur > NEG, cur, neg)
        p2, p1 = p1, cur
    return float(p1[Li, S - 1])


def long_lowrank_case(dev):
    """prot2dna log_forward_batch on 4 pairs whose DNA runs into tens of
    kilobases of flank (the lowrank kernel's pair past shared memory)."""
    from machineboss_tpu_torch.core.presets import make_preset
    from machineboss_tpu_torch.dispatch import CompiledMachine
    from machineboss_tpu_torch.ops.fwdback import pad_bucket
    from machineboss_tpu_torch.ops.kernels import lowrank_kernel as lk
    from machineboss_tpu_torch.testmachines import prot2dna_pairs
    cm = CompiledMachine(make_preset("prot2dna"), device=dev)
    check(cm.route() == "lowrank", "prot2dna must route to lowrank")
    # seed 0: the first pair, which the f64 oracle scores, has the longest
    # DNA (40,194 nt)
    pairs = prot2dna_pairs(4, [64, 64, 96, 128], seed=0, flank=30000)
    toks = [(cm.in_toks(p), cm.out_toks(d)) for p, d in pairs]
    Li = pad_bucket(max(len(t[0]) for t in toks), base=16)
    Lo = pad_bucket(max(len(t[1]) for t in toks), base=16)
    check(max(len(d) for _, d in pairs) > 39224 and Lo == 58837,
          "long lowrank: the longest DNA must pad to 58,837 (got %d)" % Lo)
    wrappers = counts()
    for w in wrappers.values():
        w.launches = 0
    t0 = time.perf_counter()
    lls = np.asarray(cm.log_forward_batch(pairs))
    call_s = time.perf_counter() - t0
    got = {k: w.launches for k, w in wrappers.items()}
    check(got == {k: int(k == "lowrank_wavefront") for k in wrappers},
          "long lowrank: launches %s" % got)
    check(np.isfinite(lls).all() and (lls > NEG).all(),
          "long lowrank: scores not all finite")
    mats = cm._host_mats()
    plan, host = lk.prepare_lowrank(*mats)
    ops = lk.lowrank_operands(plan, host, mats[0].shape[1], dev)
    batch = padded_batch(toks, Li, Lo, dev)
    cfg = lk.launch_config(ops, len(toks), Li, Lo)
    check(lk.smem_bytes_on_card(ops, cfg, Li, Lo) == cfg["smem"],
          "long lowrank: the shared layout differs from launch_plan's")
    kernel_ms, kern = event_ms(lambda: lk.lowrank_wavefront(ops, *batch))
    kern = kern.cpu().numpy()
    check(score_err(kern, lls) == 0.0, "long lowrank: kernel alone differs")
    plain_ms, plain = event_ms(lambda: lk.lowrank_forward_plain(ops, *batch))
    err = score_err(kern, plain.cpu().numpy())
    check(err <= KERNEL_VS_PLAIN_TOL, "long lowrank: kernel vs plain %.3g "
          "nats" % err)
    t0 = time.perf_counter()
    ref = forward_2d_f64_card(mats, *toks[0], dev)
    oracle_s = time.perf_counter() - t0
    gate = score_err(kern[:1], [ref])
    check(gate <= GATE_TOL, "long lowrank: f64 gate %.3g nats" % gate)
    return {"kernel": "lowrank_wavefront", "entry": "log_forward_batch",
            "B": len(pairs), "lengths": [[len(p), len(d)] for p, d in pairs],
            "padded": [Li, Lo], "layout": cfg, "call_s": call_s,
            "kernel_ms": kernel_ms, "plain_ms": plain_ms,
            "kernel_vs_plain": err, "scores": lls.tolist(),
            "f64_gate_pair0": gate, "f64_oracle_s": oracle_s}


def long_fill_case(dev):
    """device_viterbi_matrices on 2 full-envelope pairs of 3,600 x 3,600
    through the 64-state ACGT transducer (the fill's buckets in global
    memory, then the walk)."""
    from machineboss_tpu_torch.algo import traceback_device as tb
    from machineboss_tpu_torch.algo.viterbi_device import \
        device_viterbi_matrices
    from machineboss_tpu_torch.core.seqpair import NamedSeq, SeqPair
    from machineboss_tpu_torch.ops.kernels import viterbi_kernel as vk
    from machineboss_tpu_torch.ops.lowering import LoweredMachine
    from machineboss_tpu_torch.testmachines import build_random_transducer
    B, L = 2, 3600
    machine = build_random_transducer(64, list("ACGT"))
    ev = evaluated(machine)
    rng = np.random.RandomState(17)
    sym = np.array(list("ACGT"))
    pairs = [SeqPair(NamedSeq("x", list(sym[rng.randint(0, 4, L)])),
                     NamedSeq("y", list(sym[rng.randint(0, 4, L)])))
             for _ in range(B)]
    wrappers = counts()
    for w in wrappers.values():
        w.launches = 0
    t0 = time.perf_counter()
    vms = device_viterbi_matrices(ev, pairs, lowered=LoweredMachine(
        ev, dtype=np.float32), device=dev)
    torch.cuda.synchronize()
    call_s = time.perf_counter() - t0
    got = {k: w.launches for k, w in wrappers.items()}
    check(got == {k: int(k in ("viterbi_wavefront", "lattice_walk"))
                  for k in wrappers}, "long fill: launches %s" % got)
    lls = np.array([m.log_like() for m in vms])
    check(np.isfinite(lls).all() and (lls > NEG).all(),
          "long fill: scores not all finite")
    paths = [m.path(machine) for m in vms]
    fallbacks = sum(m._full is not None for m in vms)
    check(fallbacks == 0, "long fill: %d pairs fell back" % fallbacks)
    check(all(len(p.trans) >= L for p in paths), "long fill: short paths")
    del vms
    tok_in = [np.array(ev.input_tokenizer.tokenize(sp.input.seq),
                       np.int32) - 1 for sp in pairs]
    tok_out = [np.array(ev.output_tokenizer.tokenize(sp.output.seq),
                        np.int32) - 1 for sp in pairs]
    t0 = time.perf_counter()
    ref = viterbi_2d_f64_card(maxplus_mats(ev, np.float64), tok_in[0],
                              tok_out[0], dev)
    oracle_s = time.perf_counter() - t0
    gate = score_err(lls[:1], [ref])
    check(gate <= GATE_TOL, "long fill: f64 gate %.3g nats" % gate)
    ops = vk.viterbi_operands(vk.maxplus_class_mats(*maxplus_mats(ev)), dev)
    batch, Li, Lo = ragged_batch(tok_in, tok_out, dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    cfg = vk.fill_launch_plan(ops, B, Li, Lo, sms)
    check(cfg["buckets"] == "global", "long fill: buckets %s"
          % cfg["buckets"])
    check(vk.fill_smem_bytes_on_card(ops, cfg, Li, Lo) == cfg["smem"],
          "long fill: the shared layout differs from the plan's")
    fill_ms, kern = event_ms(lambda: vk.viterbi_wavefront(ops, *batch))
    plain_ms, plain = event_ms(lambda: vk.viterbi_forward_plain(ops, *batch))
    # 13 GB lattices: compared a diagonal at a time where they differ
    err = 0.0 if torch.equal(kern, plain) else max(
        max_abs_diff(a, b) for a, b in zip(kern, plain))
    check(err <= VITERBI_VS_PLAIN_TOL, "long fill: kernel vs plain %.3g" % err)
    del plain
    walker = tb.make_lattice_walker(ev, Li, Lo, device=dev)
    wargs = tb.walk_tensors(walker, np.zeros(Li + Lo + 1, np.int32), tok_in,
                            tok_out)
    walk_ms, walked = event_ms(lambda: tb.lattice_walk(walker, kern, *wargs))
    walk_plain_ms, walked_plain = event_ms(
        lambda: tb.lattice_walk_plain(walker, kern, *wargs))
    walk_err = walk_equal("long fill", walked, walked_plain)
    del kern
    return {"kernel": "viterbi_wavefront", "entry":
            "device_viterbi_matrices", "B": B, "lengths": [L, L],
            "layout": cfg, "call_s": call_s, "fill_ms": fill_ms,
            "plain_ms": plain_ms, "kernel_vs_plain": err, "walk_ms": walk_ms,
            "walk_plain_ms": walk_plain_ms, "walk_vs_plain": walk_err,
            "fallbacks": fallbacks, "scores": lls.tolist(),
            "f64_gate_pair0": gate, "f64_oracle_s": oracle_s}


def long_plan7_case(dev):
    """Plan7Fused.forward_batch_tokens: a seeded 1,200-node profile with the
    2-state noise transducer, 256 reads of 1,200 (the read's state in
    global memory)."""
    from machineboss_tpu_torch.ops.kernels import fused_plan7_kernel as fk
    from machineboss_tpu_torch.testmachines import (
        AMINO, noise_transducer_json, plan7_reads, random_plan7_hmm_text)
    K, B, Lr = 1200, 256, 1200
    text = random_plan7_hmm_text(K, AMINO, seed=5)
    noise = noise_transducer_json(AMINO)
    f, _, _ = plan7_model(text, noise, dev, multihit=True)
    reads = plan7_reads(AMINO, B, Lr, seed=5)
    s2t = f.td_ev.output_tokenizer.sym2tok
    toks = np.array([[s2t[c] for c in r] for r in reads], np.int32)
    lens = np.full(B, Lr, np.int32)
    wrappers = counts()
    for w in wrappers.values():
        w.launches = 0
    t0 = time.perf_counter()
    lls = f.forward_batch_tokens(toks, lens)
    call_s = time.perf_counter() - t0
    got = {k: w.launches for k, w in wrappers.items()}
    check(got == {k: int(k == "fused_plan7") for k in wrappers},
          "long plan7: launches %s" % got)
    check(np.isfinite(lls).all() and (lls > NEG).all(),
          "long plan7: scores not all finite")
    ops = f._kernel_ops
    plan = fk._plan(ops, B, None, None)
    check(plan["layout"] == "node_doubling" and plan["state"] == "global",
          "long plan7: layout %s" % plan)
    t = torch.from_numpy(toks).to(dev)
    n = torch.from_numpy(lens).to(dev)
    kernel_ms, kern = event_ms(lambda: fk.fused_plan7_forward_kernel(ops, t,
                                                                     n))
    kll = fk.decode(kern.cpu().numpy())
    check(score_err(kll, lls) == 0.0, "long plan7: kernel alone differs")
    plain_ms, plain = event_ms(lambda: fk.fused_plan7_forward_plain(ops, t,
                                                                    n))
    err = score_err(kll, fk.decode(plain.cpu().numpy()))
    check(err <= KERNEL_VS_PLAIN_TOL, "long plan7: kernel vs plain %.3g "
          "nats" % err)
    t0 = time.perf_counter()
    f64, _, _ = plan7_model(text, noise, dev, multihit=True,
                            dtype=torch.float64)
    ref = f64.forward_batch_tokens(toks[:1], lens[:1], impl="vmap")
    oracle_s = time.perf_counter() - t0
    gate = score_err(lls[:1], ref)
    check(gate <= GATE_TOL, "long plan7: f64 gate %.3g nats" % gate)
    return {"kernel": "fused_plan7", "entry": "Plan7Fused."
            "forward_batch_tokens", "K": K, "St": f.St, "B": B, "L": Lr,
            "layout": plan, "call_s": call_s, "kernel_ms": kernel_ms,
            "plain_ms": plain_ms, "kernel_vs_plain": err,
            "f64_gate_read0": gate, "f64_oracle_s": oracle_s}


def long_factored_case(dev):
    """make_wavefront_forward(variant="factored") on 8 prot2dna pairs of
    400 x 1,200 (the chunked layout)."""
    from machineboss_tpu_torch.core.presets import make_preset
    from machineboss_tpu_torch.dispatch import CompiledMachine
    from machineboss_tpu_torch.ops.kernels import wavefront_kernel as wk
    from machineboss_tpu_torch.testmachines import prot2dna_pairs
    cm = CompiledMachine(make_preset("prot2dna"), device=dev)
    pairs = prot2dna_pairs(8, 400, seed=7)
    toks = [(cm.in_toks(p), cm.out_toks(d)) for p, d in pairs]
    it, ot, il, ol = factory_batch(toks)
    (B, Li), Lo = it.shape, ot.shape[1]
    mats = cm._host_mats()
    fn = wk.make_wavefront_forward(*mats, B, Li, Lo, variant="factored",
                                   device=dev)
    wrappers = counts()
    for w in wrappers.values():
        w.launches = 0
    t0 = time.perf_counter()
    lls = fn(it, ot, il, ol).cpu().numpy()
    call_s = time.perf_counter() - t0
    got = {k: w.launches for k, w in wrappers.items()}
    check(got == {k: int(k == "factored_wavefront") for k in wrappers},
          "long factored: launches %s" % got)
    check(np.isfinite(lls).all() and (lls > NEG).all(),
          "long factored: scores not all finite")
    ops = wk.factored_operands(wk.prepare_factored(*mats), dev)
    batch = [torch.from_numpy(np.ascontiguousarray(x, np.int32)).to(dev)
             for x in (it, ot, il, ol)]
    cfg = wk.factored_launch_config(ops, B, Li, Lo)
    check(cfg["CC"] > 0, "long factored: not the chunked layout")
    check(wk.factored_smem_bytes_on_card(ops, cfg, Li, Lo) == cfg["smem"],
          "long factored: the shared layout differs from the plan's")
    check(wk.factored_chunk_gbytes_on_card(ops, Li)
          == wk.factored_chunk_gbytes(ops.Sa, Li),
          "long factored: the global layout differs from the plan's")
    kernel_ms, kern = event_ms(lambda: wk.factored_wavefront(ops, *batch))
    kern = kern.cpu().numpy()
    check(score_err(kern, lls) == 0.0, "long factored: kernel alone differs")
    plain_ms, plain = event_ms(lambda: wk.factored_forward_plain(ops,
                                                                 *batch))
    err = score_err(kern, plain.cpu().numpy())
    check(err <= KERNEL_VS_PLAIN_TOL, "long factored: kernel vs plain %.3g "
          "nats" % err)
    t0 = time.perf_counter()
    ref = forward_2d_f64_card(mats, *toks[0], dev)
    oracle_s = time.perf_counter() - t0
    gate = score_err(kern[:1], [ref])
    check(gate <= GATE_TOL, "long factored: f64 gate %.3g nats" % gate)
    return {"kernel": "factored_wavefront", "entry":
            "make_wavefront_forward(variant='factored')", "B": B,
            "padded": [Li, Lo], "layout": cfg, "call_s": call_s,
            "kernel_ms": kernel_ms, "plain_ms": plain_ms,
            "kernel_vs_plain": err, "f64_gate_pair0": gate,
            "f64_oracle_s": oracle_s}


def long_shapes_phase(dev, card, smi):
    """Each of the four kernels whose shared memory grew with the lengths
    or the profile, at a size past a block's 227 KiB, through its entry
    point: the path's kernel launched once and no other, the kernel alone
    against its plain version on the same inputs, and one pair or read
    against a float64 oracle. Prints the layout each plan chose and each
    case's ms."""
    t0 = time.perf_counter()
    cases = {"lowrank": long_lowrank_case(dev),
             "fill": long_fill_case(dev),
             "plan7": long_plan7_case(dev),
             "factored": long_factored_case(dev)}
    emit({"phase": "long_shapes", "cases": cases,
          "seconds": time.perf_counter() - t0, "card": card,
          "nvidia_smi": smi})


def main():
    t_start = time.perf_counter()
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
        build_allclass_transducer, build_random_transducer, prot2dna_pairs,
        ragged_lens)

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

    # every path's library and the phase profiles', one nvcc each, at once
    build_s = _build.build_all(list(_build.SOURCES) + list(_build.PROFILES))
    ptxas = {k: [ln.strip() for ln in v.splitlines()
                 if "registers" in ln or "spill" in ln]
             for k, v in _build.build_logs.items()}
    emit({"phase": "build", "seconds": build_s, "ptxas": ptxas,
          "lowrank_ptxas": ptxas.get("lowrank_wavefront"),
          "factored_ptxas": ptxas.get("factored_wavefront"),
          "viterbi_fill_ptxas": ptxas.get("viterbi_wavefront")})

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
    lowrank_queue_cases(dev)

    fullrank_cases(dev)
    variant_cases(dev)
    generic_seqscale_cases(dev)
    factored_cases(dev)
    scan1d_cases(dev)
    viterbi_cases(dev)
    plan7_cases(dev)

    # -- the prot2dna path ------------------------------------------------
    B, Lp = 512, 64
    cm = CompiledMachine(make_preset("prot2dna"), device=dev)
    check(cm.route() == "lowrank", "prot2dna must route to lowrank")
    pairs = prot2dna_pairs(B, Lp, seed=0)
    lls, launches, first_s, call_ms = drive("main_path", cm, pairs,
                                            "lowrank_wavefront", "lowrank")
    toks = [(cm.in_toks(i), cm.out_toks(o)) for i, o in pairs]
    n_gate = 8
    gate = score_err(lls[:n_gate], f64_scores(cm._host_mats(), toks[:n_gate],
                                              key=("prot2dna", n_gate)))
    check(gate <= GATE_TOL, "f64 gate %.3g nats" % gate)

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
    cfg = lk.launch_config(ops, B, Li, Lo)
    check(lk.smem_bytes_on_card(ops, cfg, Li, Lo) == cfg["smem"],
          "the kernel's shared layout differs from launch_plan's")
    kernel_ms = cuda_ms(lambda: lk.lowrank_wavefront(ops, *batch), 10)
    plain_ms = cuda_ms(lambda: lk.lowrank_forward_plain(ops, *batch), 3)
    # one walker a block against two, in turns (1, 2, 2, 1), same scores
    by_walkers = {1: [], 2: []}
    for walkers in (1, 2, 2, 1):
        other = lk.lowrank_wavefront(ops, *batch, walkers=walkers)
        check(np.array_equal(other.cpu().numpy(), kern),
              "walkers=%d scores otherwise" % walkers)
        by_walkers[walkers].append(cuda_ms(
            lambda: lk.lowrank_wavefront(ops, *batch, walkers=walkers), 5))

    # least time for this run's work: every real cell (i <= il, o <= ol,
    # but the start cell) does sum_c rank_c * Sa * Sa MACs; inputs and the
    # output move once
    il = np.array([len(t[0]) for t in toks])
    ol = np.array([len(t[1]) for t in toks])
    cells = float(((il + 1) * (ol + 1) - 1).sum())
    macs_per_cell = sum(c.rank * ops.Sa * ops.Sa for c in ops.classes)
    flops = 2.0 * macs_per_cell * cells
    nbytes = tensor_bytes(batch + [x for me in ops.mats for x in me]
                          + [ops.c0]) + B * 4
    bounds = tf32_bounds(flops, nbytes, kernel_ms)
    bound_ms = min(bounds["bound_f32_ms"], bounds["bound_3xtf32_ms"])
    bound_by = "operations" if bound_ms > nbytes / HBM_BYTES_PER_S * 1e3 \
        else "bytes"
    state_cells = B * (Lp + 1) * (3 * Lp + 1) * mats[3].shape[0]
    emit({"phase": "main_path", "B": B, "Lp": Lp, "Lo": 3 * Lp,
          "launch": cfg, "factors": "resident" if cfg["resident"]
          else "streamed", "kernel_ms_by_walkers": by_walkers, **bounds,
          "padded": [Li, Lo], "launches_first_call": launches,
          "f64_gate_max_abs": gate, "f64_gate_pairs": n_gate,
          "first_call_s": first_s, "call_ms_median5": call_ms,
          "kernel_ms": kernel_ms, "plain_ms": plain_ms,
          "kernel_share_of_call": kernel_ms / call_ms,
          "state_cells_per_s": state_cells / (call_ms / 1e3),
          "kernel_state_cells_per_s": state_cells / (kernel_ms / 1e3),
          "flops": flops, "bytes": nbytes, "bound_ms": bound_ms,
          "kernel_share_of_bound": bound_ms / kernel_ms,
          "card": card, "nvidia_smi": smi})

    p2d_cm, p2d_pairs, p2d_lls = cm, pairs, lls
    kernels = [{
        "name": "lowrank_wavefront", "route": "cuda",
        "source": "machineboss_tpu_torch/csrc/lowrank_wavefront.cu",
        "replaces": "machineboss_tpu/ops/pallas/lowrank_kernel.py:188 "
                    "(_lowrank_kernel)",
        "launches": launches, "max_abs_err": err_main, "ms": kernel_ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": None}]

    # -- the full-rank and 1D paths, at full width ------------------------
    # the dense grid machine is diag-only, so a scoreable pair has il == ol
    B, L = 512, 200
    dense = CompiledMachine(build_random_transducer(64, list("ACGT")),
                            device=dev)
    rng = np.random.RandomState(0)
    sym = np.array(list("ACGT"))
    x = sym[rng.randint(0, 4, (B, L))]
    y = sym[rng.randint(0, 4, (B, L))]
    lens = ragged_lens(rng, B, L)
    dense_pairs = [("".join(x[n]), "".join(y[n])) for n in range(B)]
    kernels.append(dense_path("dense_uniform", dense, dense_pairs, False,
                              dev, card, smi))
    kernels.append(dense_path(
        "dense_ragged", dense,
        [("".join(x[n, :lens[n]]), "".join(y[n, :lens[n]]))
         for n in range(B)], True, dev, card, smi))
    kernels.append(dense1d_path(dev, card, smi))

    # -- the every-entry and every-cell cases: the kernels alone ----------
    scan1d_every_entry(dev, card, smi)
    merged_every_cell(x, y, lens, dev, card, smi)

    # -- the other 2D Forward variants, at full width ----------------------
    dense_key, p2d_key = ("dense_uniform", 8), ("prot2dna", 8)
    kernels.append(variant_path(
        "dense_chained", "chained_wavefront", dense, dense_pairs,
        {"variant": "chained", "chain": 8}, dev, card, smi, dense_key,
        chains=(2, 4)))
    kernels.append(variant_path(
        "prot2dna_chained", "lowrank_chained_wavefront", p2d_cm, p2d_pairs,
        {"variant": "lowrank", "chain": 8}, dev, card, smi, p2d_key))
    kernels.append(variant_path(
        "dense_generic", "generic_wavefront", dense, dense_pairs,
        {"merged": False}, dev, card, smi, dense_key))
    kernels.append(variant_path(
        "dense_seqscale", "seqscale_wavefront", dense, dense_pairs,
        {"variant": "seqscale"}, dev, card, smi, dense_key,
        merged_on_plan=True))
    kernels.append(variant_path(
        "prot2dna_factored", "factored_wavefront", p2d_cm, p2d_pairs,
        {"variant": "factored"}, dev, card, smi, p2d_key))

    # -- the alignment paths, at full width -------------------------------
    kernels += alignment_paths(dev, card, smi)

    # -- fused Plan7 read scoring, at full width --------------------------
    kernels.append(plan7_path(dev, card, smi))

    # -- the four kernels past a block's shared memory --------------------
    long_shapes_phase(dev, card, smi)

    # -- EM training (the autograd E-step, eager torch), at full width ---
    em_phase(dev, card, smi)

    # -- the command line, the neural DP and device CTC scoring ----------
    cli_phase(dev, card, smi)
    neural_phase(dev, card, smi)
    ctc_device_phase(dev, card, smi)

    # -- the parallel layer on a world of one (NCCL) ---------------------
    parallel_phase(dev, card, smi, p2d_cm, p2d_pairs, p2d_lls, dense,
                   dense_pairs)

    # -- single-pair scoring (the row kernel) and the sparse engine -------
    kernels.append(single_pair_paths(dev, card, smi))

    # no single PyTorch call computes a wavefront, this scan, this walk or
    # this row solve: library_ms is null for every kernel
    check(len(kernels) == 14, "the kernels line has %d entries" % len(kernels))
    emit({"phase": "total", "seconds": time.perf_counter() - t_start})
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": card,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
