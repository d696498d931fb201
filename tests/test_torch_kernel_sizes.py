"""The four kernels whose shared memory grew with the lengths or the
profile, at the sizes the JAX kernels take (their 120 MiB of VMEM).

lowrank (the main path), the batched Viterbi fill, fused Plan7 and the
factored wavefront each kept something in a block's shared memory that
grows with a sequence or a profile (the pair's tokens and cells, a
diagonal's token buckets, a read's row state, a diagonal's state
operands), and their launch plans raised ValueError past 227 KiB. Each
plan now takes a layout that keeps that part in global memory (or, for
factored, streams the diagonal through shared memory in chunks) where the
old one does not fit, and keeps the old layout wherever it does. These
tests run the plans, which are host functions, on the CPU:

- the long sizes get a layout whose shared bytes fit a block (each raised
  ValueError before);
- the shapes chip_smoke runs keep the layout they had;
- a forced layout that does not fit, and a size past the card's memory,
  still raise ValueError;
- Plan7Fused at 1,000 nodes through its kernel route (the kernel's plain
  version here) against its own per-read scan solver, which
  tests/test_torch_fused_plan7.py holds to the JAX class (the JAX class
  itself takes some 20 s at this size).

The kernels themselves are held to their plain versions at these sizes by
the card tests in tests/test_torch_{lowrank,viterbi_kernel,
fused_plan7_kernel,factored}.py and by chip_smoke.py's long_shapes phase.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from machineboss_tpu_torch import testmachines
from machineboss_tpu_torch.core.eval import EvaluatedMachine
from machineboss_tpu_torch.core.presets import make_preset
from machineboss_tpu_torch.ops.kernels import fused_plan7_kernel as fk
from machineboss_tpu_torch.ops.kernels import lowrank_kernel as lk
from machineboss_tpu_torch.ops.kernels import viterbi_kernel as vk
from machineboss_tpu_torch.ops.kernels import wavefront_kernel as wk
from machineboss_tpu_torch.ops.lowering import LoweredMachine

SMS = 132                  # the H100's multiprocessors
CARD_BYTES = 80 * 10 ** 9  # the H100's device memory
PLAN7_VS_SCAN = 1e-4       # nats, the kernel route's plain version vs the
                           # scan solver (both float32, L=6)
_cache = {}


def _machine(kind):
    if kind == "prot2dna":
        return make_preset("prot2dna")
    return testmachines.build_random_transducer(64, list("ACGT"))


def _mats(kind, semiring=None):
    key = ("mats", kind, semiring)
    if key not in _cache:
        m = _machine(kind)
        ev = EvaluatedMachine(m, m.get_param_defs(True))
        low = LoweredMachine(ev, dtype=np.float32)
        _cache[key] = tuple(np.asarray(x) for x in (
            low.matrices_2d(semiring) if semiring else low.matrices_2d()))
    return _cache[key]


def _lowrank_ops(kind):
    """What launch_plan reads of the card's lowrank operands."""
    plan, host = lk.prepare_lowrank(*_mats(kind))
    _, et, _, n_mt, slab, KZ = lk.pack_lowrank(plan["classes"], host,
                                               plan["Sa"])
    return SimpleNamespace(n_mt=n_mt, slab=slab, KZ=KZ,
                           SaP=-(-plan["Sa"] // 4) * 4,
                           et_floats=-(-et.size // 4) * 4)


def _fill_ops(kind):
    return vk.viterbi_operands(
        vk.maxplus_class_mats(*_mats(kind, "maxplus")), torch.device("cpu"))


def _factored_ops(kind):
    """What factored_launch_plan reads of the card's factored operands."""
    key = ("factored", kind)
    if key not in _cache:
        plan = wk.prepare_factored(*_mats(kind))
        _, ek, _, n_mt, _, NR, _ = wk.pack_factored(plan)
        _cache[key] = SimpleNamespace(
            Sa=plan["Sa"], NR=NR, n_mt=n_mt, e_floats=-(-ek.size // 4) * 4,
            nbp=2 if any(c[0] == "diag" for c in plan["classes"]) else 1)
    return _cache[key]


# ---- the long sizes: a layout that fits a block (each raised before)

@pytest.mark.parametrize("kind,Li,Lo", [
    ("prot2dna", 64, 58837),      # 64 aa against DNA past 39,224 nt
    ("prot2dna", 1019, 39224),    # an 800-aa protein (padded) at 39 kb
    ("dense64", 64, 30000)])
def test_lowrank_long_pairs_get_a_layout(kind, Li, Lo):
    cfg = lk.launch_plan(_lowrank_ops(kind), Li, Lo)
    assert cfg["smem"] <= lk.SMEM_MAX
    assert cfg["pair"] in ("tokens_global", "cells_global")


@pytest.mark.parametrize("kind,Li,Lo", [
    ("dense64", 3600, 3600),      # the 64-state ACGT transducer
    ("prot2dna", 3200, 9600)])
def test_fill_long_pairs_get_a_layout(kind, Li, Lo):
    ops = _fill_ops(kind)
    cfg = vk.fill_launch_plan(ops, 2, Li, Lo, SMS)
    assert cfg["smem"] <= vk.SMEM_MAX and cfg["buckets"] == "global"
    assert cfg["n_slots"] == 0


@pytest.mark.parametrize("K,St", [(1200, 2), (2000, 2), (1000, 4)])
def test_plan7_long_profiles_get_a_layout(K, St):
    cfg = fk.launch_plan(K, St, 20, 256, SMS)
    assert cfg["smem"] <= fk._SMEM_LIMIT
    assert cfg["layout"] == "node_doubling" and cfg["state"] == "global"


def test_banded_wide_band_gets_a_layout():
    """A band of 15,000 cells (past the 14,395 whose tokens a block could
    stage) on the 64-state machine: the tokens read from global memory."""
    ops = _fill_ops("dense64")
    Li, Lo = 15000, 15000
    d = np.arange(Li + Lo + 1)
    geom = vk.band_geometry(Li, Lo, np.maximum(0, d - Lo),
                            np.minimum(Li, d) + 1, torch.device("cpu"))
    assert geom.Wb >= 15000
    cfg = vk.banded_launch_plan(ops, geom, SMS)
    assert cfg["smem"] <= vk.SMEM_MAX
    assert not cfg["staged"] and not cfg["slots"]


def test_factored_long_pairs_get_a_layout():
    cfg = wk.factored_launch_plan(_factored_ops("prot2dna"), 400, 1200)
    assert cfg["smem"] <= wk.SMEM_MAX and cfg["CC"] > 0
    assert cfg["walkers"] == 1 and cfg["CC"] % 8 == 0


# ---- the shapes chip_smoke runs keep their layout

def test_lowrank_keeps_the_main_path_layout():
    """prot2dna at 64 x 192 and at the main path's padded 88 x 200: two
    walkers, 24 cells a chunk, the factors and the token scales resident,
    the pair in shared memory."""
    ops = _lowrank_ops("prot2dna")
    for Li, Lo in ((64, 192), (88, 200)):
        cfg = lk.launch_plan(ops, Li, Lo)
        assert {k: cfg[k] for k in ("walkers", "CC", "seg_mt", "resident",
                                    "et_floats", "pair")} == {
            "walkers": 2, "CC": 24, "seg_mt": ops.n_mt, "resident": True,
            "et_floats": ops.et_floats, "pair": "shared"}


def test_fill_keeps_the_viterbi_dense_layout():
    """viterbi_dense: 64 pairs of 128 x 128 on the 64-state machine."""
    cfg = vk.fill_launch_plan(_fill_ops("dense64"), 64, 128, 128, SMS)
    assert {k: cfg[k] for k in ("grid", "cluster", "n_slots", "piece",
                                "chunks", "buckets", "smem")} == {
        "grid": 64, "cluster": 2, "n_slots": 3, "piece": 8, "chunks": 0,
        "buckets": "shared", "smem": 109872}


def test_plan7_keeps_the_warp_layout_at_86_nodes():
    """plan7: 1,024 reads of fn3's 86 nodes through the 2-state noise
    transducer."""
    cfg = fk.launch_plan(86, 2, 20, 1024, SMS)
    assert cfg == {"layout": "warp", "reads": 8, "chunk": 3,
                   "lane_levels": 5, "smem": 114400,
                   "in_smem": {"nodes": True, "span": True, "panels": True}}


def test_banded_keeps_the_align_banded_layout():
    """align_banded: one pair of 1,500 in an envelope of width 16 on the
    64-state machine: the tokens staged, the diagonals in shared slots."""
    ops = _fill_ops("dense64")
    geom = vk.band_geometry(1500, 1500, *(lambda d: (
        np.clip(d // 2 - 8, np.maximum(0, d - 1500), np.minimum(1500, d)),
        np.minimum(np.clip(d // 2 - 8, np.maximum(0, d - 1500),
                           np.minimum(1500, d)) + 17, np.minimum(1501, d + 1))
    ))(np.arange(3001)), torch.device("cpu"))
    cfg = vk.banded_launch_plan(ops, geom, SMS)
    assert cfg["staged"] and cfg["slots"] and cfg["resident"]


def test_factored_keeps_the_prot2dna_factored_layout():
    """prot2dna_factored: 64 x 192, two walkers, groups of 3 units, E
    through L1/L2, a whole diagonal in shared memory."""
    cfg = wk.factored_launch_plan(_factored_ops("prot2dna"), 64, 192)
    assert cfg == {"walkers": 2, "seg": 3, "resident": False,
                   "e_floats": 0, "CC": 0, "smem": 225408}


# ---- what still raises

def test_forced_layouts_that_do_not_fit_raise():
    with pytest.raises(ValueError, match="58837"):
        lk.launch_plan(_lowrank_ops("prot2dna"), 64, 58837, pair="shared")
    with pytest.raises(ValueError, match="token buckets"):
        vk.fill_launch_plan(_fill_ops("dense64"), 2, 3600, 3600, SMS,
                            buckets="shared")
    with pytest.raises(ValueError, match="K=1200"):
        fk.launch_plan(1200, 2, 20, 256, SMS, state="shared")
    d = np.arange(30001)
    wide = vk.band_geometry(15000, 15000, np.maximum(0, d - 15000),
                            np.minimum(15000, d) + 1, torch.device("cpu"))
    with pytest.raises(ValueError, match="tokens of a band"):
        vk.banded_launch_plan(_fill_ops("dense64"), wide, SMS, staged=True)
    with pytest.raises(ValueError, match="whole diagonal"):
        wk.factored_launch_plan(_factored_ops("prot2dna"), 400, 1200,
                                chunk=0)


def test_sizes_past_the_cards_memory_raise():
    """Every layout fits a block; what is left is the card's memory."""
    ops = _lowrank_ops("prot2dna")
    with pytest.raises(ValueError, match="bytes of device memory"):
        lk.launch_config(ops, 4, 400000, 600000, grid=SMS,
                         mem_bytes=CARD_BYTES)
    assert lk.launch_config(ops, 4, 64, 58837, grid=SMS,
                            mem_bytes=CARD_BYTES)["bytes"] < CARD_BYTES
    with pytest.raises(ValueError, match="bytes of device memory"):
        vk.fill_launch_plan(_fill_ops("dense64"), 2, 30000, 30000, SMS,
                            mem_bytes=CARD_BYTES)
    with pytest.raises(ValueError, match="bytes of device memory"):
        fk.launch_plan(20000, 4, 20, 100000, SMS, mem_bytes=CARD_BYTES)
    with pytest.raises(ValueError, match="bytes of device memory"):
        wk.factored_launch_config(_factored_ops("prot2dna"), 132, 400000,
                                  600000, grid=SMS, mem_bytes=CARD_BYTES)


# ---- the entry point at a long profile

def test_plan7fused_kernel_route_at_1000_nodes():
    """Plan7Fused at 1,000 nodes with the 2-state noise transducer (past
    the 918 whose read state fits shared memory): the card's plan keeps
    the state in global memory, and the kernel route (its plain version
    on the CPU) agrees with the scan solver on 2 short reads."""
    from machineboss_tpu_torch.core.hmmer import HmmerModel
    from machineboss_tpu_torch.core.machine import Machine
    from machineboss_tpu_torch.ops.fused_plan7 import Plan7Fused
    hmm = HmmerModel()
    hmm.read(testmachines.random_plan7_hmm_text(1000, testmachines.AMINO,
                                                seed=3))
    td = Machine.from_json(testmachines.noise_transducer_json(
        testmachines.AMINO, 2))
    f = Plan7Fused(hmm, EvaluatedMachine(td, td.get_param_defs(True)),
                   mode="plan7", multihit=True, length=10.0, device="cpu")
    assert (f.K, f.St) == (1000, 2) and f._kernel_supported()
    cfg = fk.launch_plan(f.K, f.St, f.n_out - 1, 2, SMS)
    assert cfg["layout"] == "node_doubling" and cfg["state"] == "global"
    rng = np.random.RandomState(4)
    toks = rng.randint(1, f.n_out, (2, 6)).astype(np.int32)
    lens = np.array([6, 4], np.int32)
    toks[1, 4:] = 1
    got = f.forward_batch_tokens(toks, lens, impl="kernel")
    want = f.forward_batch_tokens(toks, lens, impl="vmap")
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() <= PLAN7_VS_SCAN
