"""The factored wavefront's kernel layout, launch plan and arithmetic.

The kernel (csrc/factored_wavefront.cu) takes its class products T_r^T p
on the f32 pipes and its closure product C^T pre as 3xTF32 products on the
tensor cores. Its layout (pack_factored: the factors source-major, C^T in
mma.m16n8k8 fragment order, E per token) unpacks to prepare_factored's
tensors bit for bit. The 3xTF32 split (each operand split into two TF32
values, three products summed in float32) is emulated here on the CPU: with
both products split, on prot2dna at full width and on the small machines
it holds within 0.01 nats (prot2dna) or 5e-3 (the factored bound of
tests/test_torch_wavefront_variants.py, signed SVD factors) of the float64
oracle and within 1e-3 of factored_forward_plain; on the 64-state dense
machine's deep pairs it does not (scripts/factored_numerics.py), which is
why the class products stay in float32. The kernel's own arithmetic
(float32 class products, a 3xTF32 closure) holds those bounds there too.
The launch plan (walkers, streamed group size, shared bytes) is checked at
prot2dna and on the 64-state dense machine. On a CUDA card the kernel is
held to the plain version at 1e-3 nats (the same f32 recurrence, summed in
another order):
    python -m pytest --noconftest tests/test_torch_factored.py -m cuda
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from machineboss_tpu_torch import testmachines
from machineboss_tpu_torch.core.eval import EvaluatedMachine
from machineboss_tpu_torch.core.presets import make_preset
from machineboss_tpu_torch.ops.host_oracle import forward_2d_f64
from machineboss_tpu_torch.ops.kernels import wavefront_kernel as wk
from machineboss_tpu_torch.ops.kernels.plain_walk import walk_plain
from machineboss_tpu_torch.ops.lowering import LoweredMachine
from one_thread import one_torch_thread  # noqa: F401

F64_FULL = 0.01      # nats, the accuracy gate, prot2dna at full width
F64_SMALL = 5e-3     # nats, the factored bound vs f64 on the small machines
CARD_BOUND = 1e-3    # nats, kernel (or its emulation) vs plain
NEG = -1e29
_cache = {}


def _machine(kind):
    return {
        "prot2dna": lambda: make_preset("prot2dna"),
        "allclass": lambda: testmachines.build_allclass_transducer(
            5, list("AC")),
        "indel": lambda: testmachines.build_indel_transducer(6, list("ACGT")),
        "dense8": lambda: testmachines.build_random_transducer(
            8, list("ACGT"), seed=15),
        "dense64": lambda: testmachines.build_random_transducer(
            64, list("ACGT"), seed=42)}[kind]()


def _lowered(kind):
    key = ("mats", kind)
    if key not in _cache:
        m = _machine(kind)
        ev = EvaluatedMachine(m, m.get_param_defs(True))
        _cache[key] = (ev, tuple(np.asarray(x) for x in LoweredMachine(
            ev, dtype=np.float32).matrices_2d()))
    return _cache[key]


def _plan(kind):
    key = ("plan", kind)
    if key not in _cache:
        _cache[key] = wk.prepare_factored(*_lowered(kind)[1])
    return _cache[key]


def _prot2dna_batch(B, Lp, seed):
    ev, _ = _lowered("prot2dna")
    pairs = testmachines.prot2dna_pairs(B, Lp, seed=seed)
    it = np.array([[ev.input_tokenizer.sym2tok[c] - 1 for c in p]
                   for p, _ in pairs], np.int32)
    ot = np.array([[ev.output_tokenizer.sym2tok[c] - 1 for c in d]
                   for _, d in pairs], np.int32)
    return it, ot


def _case(name):
    """(kind, it, ot, il, ol, f64 scores) from seeds."""
    if name in _cache:
        return _cache[name]
    if name == "prot2dna_full":      # chip_smoke's main-path width
        kind = "prot2dna"
        it, ot = _prot2dna_batch(4, 64, 5)
        il, ol = np.full(4, 64, np.int32), np.full(4, 192, np.int32)
    elif name == "dense64_deep":     # the variants' odd_start pairs
        kind = "dense64"
        rng = np.random.RandomState(1)
        it = rng.randint(0, 4, (3, 100)).astype(np.int32)
        ot = rng.randint(0, 4, (3, 100)).astype(np.int32)
        il = ol = np.array([56, 53, 99], np.int32)
    elif name == "prot2dna_deep":    # odd lengths, every score below -88
        kind = "prot2dna"
        it, ot = _prot2dna_batch(3, 57, 1)
        il, ol = np.full(3, 57, np.int32), np.full(3, 171, np.int32)
    else:
        kind = name
        mats = _lowered(kind)[1]
        rng = np.random.RandomState(8)
        B, L = 6, 9
        it = rng.randint(0, mats[1].shape[0], (B, L)).astype(np.int32)
        ot = rng.randint(0, mats[2].shape[0], (B, L)).astype(np.int32)
        il = rng.randint(1, L + 1, B).astype(np.int32)
        ol = il.copy() if kind.startswith("dense") \
            else rng.randint(1, L + 1, B).astype(np.int32)
        il[0], ol[0] = L, L
    m64 = [x.astype(np.float64) for x in _lowered(kind)[1]]
    ref = np.array([forward_2d_f64(*m64, it[b][:il[b]], ot[b][:ol[b]])
                    for b in range(len(il))])
    _cache[name] = (kind, it, ot, il, ol, ref)
    return _cache[name]


def _assert_close(got, ref, bound):
    assert len(got) == len(ref)
    for b in range(len(ref)):
        if ref[b] <= NEG:
            assert got[b] <= NEG, (b, got[b])
        else:
            assert abs(float(got[b]) - float(ref[b])) <= bound, \
                (b, got[b], ref[b])


# ---- the layout and the launch plan, on the CPU

@pytest.mark.parametrize("kind", ["prot2dna", "allclass", "indel", "dense8",
                                  "dense64"])
def test_packed_layout_unpacks_bit_for_bit(kind):
    plan = _plan(kind)
    Sa = plan["Sa"]
    tab, ek, desc, n_mt, KT, NR, SaP = wk.pack_factored(plan)
    assert tab.dtype == np.float32 and ek.dtype == np.float32
    assert n_mt * 16 >= Sa and KT * 8 >= Sa and SaP % 4 == 0
    assert NR == sum(c[3] for c in plan["classes"]) == desc[:, 2].sum()
    # n_mt * NR stage-A units and n_mt stage-B units of KT A tiles
    assert tab.size == n_mt * (NR + 1) * KT * 128
    assert list(desc[:, 0]) == [{"up": 0, "left": 1, "diag": 2}[c[0]]
                                for c in plan["classes"]]
    classes, closure = wk.unpack_factored(tab, ek, desc, Sa)
    assert np.array_equal(closure, plan["closure"])
    for (_, mt, e, r), (umt, ue, ur) in zip(plan["classes"], classes):
        assert ur == r
        assert np.array_equal(umt, mt) and np.array_equal(ue, e)


def _plan_ops(kind):
    plan = _plan(kind)
    _, ek, _, n_mt, _, NR, _ = wk.pack_factored(plan)
    return SimpleNamespace(
        Sa=plan["Sa"], NR=NR, n_mt=n_mt, e_floats=-(-ek.size // 4) * 4,
        nbp=2 if any(c[0] == "diag" for c in plan["classes"]) else 1)


def test_launch_plan_at_prot2dna_and_dense64():
    p2d = _plan_ops("prot2dna")
    assert (p2d.Sa, p2d.NR, p2d.n_mt, p2d.nbp) == (131, 5, 9, 1)
    # the tables (459 KB of units) stream; two walkers share each streamed
    # group, E read from global memory keeps the groups large
    two = wk.factored_launch_plan(p2d, 64, 192)
    assert two == wk.factored_launch_plan(p2d, 64, 192, walkers=2)
    assert two["walkers"] == 2 and not two["resident"]
    assert two["seg"] == 3 and two["e_floats"] == 0
    assert two["smem"] == wk.factored_smem_bytes(
        131, 5, 64, 192, 2, 1, 3, 0) <= wk.SMEM_MAX
    one = wk.factored_launch_plan(p2d, 64, 192, walkers=1)
    assert one["walkers"] == 1 and one["seg"] > two["seg"]
    # the dense machine: one diag class of rank 14, two state buffers
    d64 = _plan_ops("dense64")
    assert (d64.NR, d64.nbp) == (14, 2)
    for walkers in (1, 2):
        cfg = wk.factored_launch_plan(d64, 100, 100, walkers=walkers)
        assert not cfg["resident"] and cfg["smem"] <= wk.SMEM_MAX
    assert wk.factored_launch_plan(d64, 100, 100)["walkers"] == 2
    # 201 cells a diagonal leave room for one walker only
    assert wk.factored_launch_plan(d64, 200, 200)["walkers"] == 1
    with pytest.raises(ValueError, match="two walkers"):
        wk.factored_launch_plan(d64, 200, 200, walkers=2)
    # a small machine keeps every table and E resident
    small = wk.factored_launch_plan(_plan_ops("allclass"), 7, 7)
    assert small["resident"] and small["e_floats"] > 0


def test_launch_plan_refuses_what_fits_nothing():
    p2d = _plan_ops("prot2dna")
    # 401 cells a diagonal: no whole diagonal fits beside the tables, the
    # chunked layout does (one walker)
    with pytest.raises(ValueError, match="do not fit"):
        wk.factored_launch_plan(p2d, 400, 1200, chunk=0)
    cfg = wk.factored_launch_plan(p2d, 400, 1200)
    assert cfg["CC"] > 0 and cfg["walkers"] == 1
    assert cfg["smem"] == wk.factored_smem_bytes(
        131, 5, 400, 1200, 1, 1, cfg["seg"], cfg["e_floats"],
        cfg["CC"]) <= wk.SMEM_MAX
    with pytest.raises(ValueError, match="ranks"):
        wk.factored_launch_plan(SimpleNamespace(
            Sa=8, NR=200, n_mt=1, e_floats=4, nbp=1), 8, 8)
    with pytest.raises(ValueError, match="walkers"):
        wk.factored_launch_plan(p2d, 64, 192, walkers=3)


# ---- the kernel's arithmetic, emulated on the CPU

def _tf32(x, rounded=True):
    """x cut to 10 explicit mantissa bits: rounded to nearest, ties away
    from zero (the kernel's add-and-mask), or truncated (what the tensor
    core reads of a float32 operand)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + (0x1000 if rounded else 0)) & -0x2000).view(torch.float32)


def _mm3(x, y):
    """x @ y as the kernel's 3xTF32 split: hi = x rounded to TF32, lo the
    TF32 part of x - hi; hi_x hi_y + (hi_x lo_y + lo_x hi_y) in float32."""
    xh, yh = _tf32(x), _tf32(y)
    xl, yl = _tf32(x - xh, False), _tf32(y - yh, False)
    return xh @ yh + (xh @ yl + xl @ yh)


def _forward_3xtf32(ops, it, ot, il, ol, split_classes=True):
    """factored_forward_plain with the closure product split as the
    kernel's tensor-core products are, and the class products too unless
    split_classes is False (the kernel's own arithmetic)."""
    by_name = {c[0]: c for c in ops.classes}
    mm = _mm3 if split_classes else torch.matmul

    def term(name, q, tok):
        _, Tm, Et, r = by_name[name]
        B, W = tok.shape
        out = mm(q, Tm).reshape(B, W, r, ops.Sa)
        return (out * Et[tok]).sum(dim=2)

    return walk_plain(ops.c0, term, ops.names,
                      *[torch.from_numpy(x) for x in (it, ot, il, ol)],
                      ops.To, readout_w=ops.w if ops.sink else None,
                      closure_t=ops.closure, closure_mm=_mm3)


@pytest.mark.parametrize("name", ["prot2dna_full", "allclass", "indel",
                                  "dense8"])
def test_3xtf32_products_hold_the_f64_bound(name):
    """Before any card time: both products split keep the factored Forward
    within the f64 bounds and within the card bound of the float32 plain
    version."""
    kind, it, ot, il, ol, ref = _case(name)
    ops = wk.factored_operands(_plan(kind), torch.device("cpu"))
    split = _forward_3xtf32(ops, it, ot, il, ol).numpy()
    plain = wk.factored_forward_plain(
        ops, *[torch.from_numpy(x) for x in (it, ot, il, ol)]).numpy()
    _assert_close(split, ref, F64_FULL if kind == "prot2dna" else F64_SMALL)
    _assert_close(split, plain, CARD_BOUND)


def test_kernel_arithmetic_holds_the_bounds_on_dense64():
    """The 64-state dense machine's deep pairs (tests/
    test_torch_wavefront_variants.py's odd_start: one diag class of rank
    14, pairs of 56, 53 and 99): the kernel's arithmetic, float32 class
    products and a 3xTF32 closure, stays within 5e-3 nats of f64 and 1e-3
    of the float32 plain version."""
    kind, it, ot, il, ol, ref = _case("dense64_deep")
    ops = wk.factored_operands(_plan(kind), torch.device("cpu"))
    own = _forward_3xtf32(ops, it, ot, il, ol,
                          split_classes=False).numpy()
    plain = wk.factored_forward_plain(
        ops, *[torch.from_numpy(x) for x in (it, ot, il, ol)]).numpy()
    _assert_close(own, ref, F64_SMALL)
    _assert_close(own, plain, CARD_BOUND)


# ---- the kernel on the card

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _on(dev, *arrays):
    return [torch.from_numpy(np.ascontiguousarray(x, np.int32)).to(dev)
            for x in arrays]


def _plain(kind, it, ot, il, ol):
    ops = wk.factored_operands(_plan(kind), torch.device("cpu"))
    return wk.factored_forward_plain(
        ops, *[torch.from_numpy(np.ascontiguousarray(x, np.int32))
               for x in (it, ot, il, ol)]).numpy()


@pytest.mark.cuda
@pytest.mark.parametrize("walkers", [1, 2])
@pytest.mark.parametrize("grid", [1, 2])
def test_kernel_grid_below_batch_with_faults_on_card(grid, walkers):
    """Fewer walkers than pairs, so each takes several pairs from the
    queue; pair 2 holds a bad token and pair 4 a bad length: both NaN, the
    pairs after them as the plain version scores them."""
    dev = _card()
    kind, it, ot, il, ol, ref = _case("allclass")
    bad_it, bad_il = it.copy(), il.copy()
    bad_it[2, 0] = 7                      # outside the 2-letter alphabet
    bad_il[4] = it.shape[1] + 1           # past the padded shape
    ops = wk.factored_operands(_plan(kind), dev)
    before = wk.factored_wavefront.launches
    kern = wk.factored_wavefront(ops, *_on(dev, bad_it, ot, bad_il, ol),
                                 grid=grid, walkers=walkers).cpu().numpy()
    assert wk.factored_wavefront.launches == before + 1
    assert np.isnan(kern[2]) and np.isnan(kern[4])
    live = np.array([b not in (2, 4) for b in range(len(il))])
    _assert_close(kern[live], _plain(kind, it, ot, il, ol)[live], CARD_BOUND)
    _assert_close(kern[live], ref[live], F64_SMALL)


@pytest.mark.cuda
def test_streamed_plan_at_full_width_on_card():
    dev = _card()
    kind, it, ot, il, ol, ref = _case("prot2dna_full")
    ops = wk.factored_operands(_plan(kind), dev)
    cfg = wk.factored_launch_config(ops, len(il), 64, 192)
    assert not cfg["resident"]
    assert wk.factored_smem_bytes_on_card(ops, cfg, 64, 192) == cfg["smem"]
    kern = wk.factored_wavefront(ops, *_on(dev, it, ot, il, ol)).cpu().numpy()
    _assert_close(kern, _plain(kind, it, ot, il, ol), CARD_BOUND)
    _assert_close(kern, ref, F64_FULL)


@pytest.mark.cuda
def test_impossible_pairs_on_card():
    """The diag-only dense8 machine has no path for il != ol."""
    dev = _card()
    mats = _lowered("dense8")[1]
    rng = np.random.RandomState(2)
    it = rng.randint(0, 4, (4, 6)).astype(np.int32)
    ot = rng.randint(0, 4, (4, 8)).astype(np.int32)
    il = np.array([6, 5, 6, 4], np.int32)
    ol = np.array([8, 8, 6, 4], np.int32)
    ops = wk.factored_operands(wk.prepare_factored(*mats), dev)
    kern = wk.factored_wavefront(ops, *_on(dev, it, ot, il, ol)).cpu().numpy()
    assert (kern[:2] <= NEG).all() and (kern[2:] > NEG).all()
    _assert_close(kern, _plain("dense8", it, ot, il, ol), CARD_BOUND)


@pytest.mark.cuda
def test_deep_odd_pairs_below_88_nats_on_card():
    """prot2dna, 57 amino acids against 171 bases: odd lengths, every
    score below -88 nats, so the rescale carries the scale."""
    dev = _card()
    kind, it, ot, il, ol, ref = _case("prot2dna_deep")
    assert (ref < -88).all()
    ops = wk.factored_operands(_plan(kind), dev)
    kern = wk.factored_wavefront(ops, *_on(dev, it, ot, il, ol)).cpu().numpy()
    _assert_close(kern, _plain(kind, it, ot, il, ol), CARD_BOUND)
    _assert_close(kern, ref, F64_SMALL)


@pytest.mark.cuda
def test_walkers_and_grid_do_not_change_the_scores_on_card():
    """One walker computes a pair in a fixed order whatever the group
    size: the scores are equal bit for bit across grids and walkers."""
    dev = _card()
    kind, it, ot, il, ol, _ = _case("prot2dna_deep")
    ops = wk.factored_operands(_plan(kind), dev)
    batch = _on(dev, it, ot, il, ol)
    runs = [wk.factored_wavefront(ops, *batch, grid=g, walkers=w)
            .cpu().numpy()
            for g, w in ((None, None), (1, 1), (1, 2), (2, 1), (3, 2))]
    for r in runs[1:]:
        assert np.array_equal(r, runs[0])


@pytest.mark.cuda
@pytest.mark.parametrize("name,chunk", [("prot2dna_full", 24),
                                        ("prot2dna_full", 72),
                                        ("dense64_deep", 32),
                                        ("allclass", 8)])
def test_chunked_layout_matches_whole_diagonal_on_card(name, chunk):
    """The chunked layout (states and log scales in global memory, a
    diagonal taken `chunk` cells at a time) against the whole diagonal in
    shared memory, one walker each: the same sums in the same order, so
    the scores are equal bit for bit; the all-class batch holds a bad
    token and a bad length (NaN in both)."""
    dev = _card()
    kind, it, ot, il, ol, _ = _case(name)
    it, il = it.copy(), il.copy()
    if name == "allclass":
        it[2, 0] = 7                      # outside the 2-letter alphabet
        il[4] = it.shape[1] + 1           # past the padded shape
    ops = wk.factored_operands(_plan(kind), dev)
    Li, Lo = it.shape[1], ot.shape[1]
    cfg = wk.factored_launch_config(ops, len(il), Li, Lo, chunk=chunk)
    assert cfg["CC"] == chunk and cfg["walkers"] == 1
    assert wk.factored_smem_bytes_on_card(ops, cfg, Li, Lo) == cfg["smem"]
    assert wk.factored_chunk_gbytes_on_card(ops, Li) == \
        wk.factored_chunk_gbytes(ops.Sa, Li)
    batch = _on(dev, it, ot, il, ol)
    want = wk.factored_wavefront(ops, *batch, walkers=1, chunk=0)
    got = wk.factored_wavefront(ops, *batch, chunk=chunk)
    want, got = want.cpu().numpy(), got.cpu().numpy()
    assert np.array_equal(np.isnan(got), np.isnan(want))
    assert np.array_equal(got[~np.isnan(got)], want[~np.isnan(want)])


@pytest.mark.cuda
def test_long_pairs_match_plain_on_card():
    """prot2dna, 4 proteins of 400 against their 1,200-base DNA: a whole
    diagonal of states does not fit beside the tables, so the plan takes
    the chunked layout; the kernel within 1e-3 nats of the plain version
    (both on the card)."""
    dev = _card()
    it, ot = _prot2dna_batch(4, 400, 11)
    il, ol = np.full(4, 400, np.int32), np.full(4, 1200, np.int32)
    ops = wk.factored_operands(_plan("prot2dna"), dev)
    cfg = wk.factored_launch_config(ops, 4, 400, 1200)
    assert cfg["CC"] > 0 and cfg["smem"] <= wk.SMEM_MAX
    batch = _on(dev, it, ot, il, ol)
    before = wk.factored_wavefront.launches
    kern = wk.factored_wavefront(ops, *batch).cpu().numpy()
    assert wk.factored_wavefront.launches == before + 1
    plain = wk.factored_forward_plain(ops, *batch).cpu().numpy()
    _assert_close(kern, plain, CARD_BOUND)
