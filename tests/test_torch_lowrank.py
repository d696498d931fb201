"""The port's lowrank wavefront against the JAX kernel and the f64 oracle.

lowrank_forward_plain (the CPU path of make_lowrank_forward) is held to
the JAX package's make_lowrank_forward in its own CPU mode (interpret=True)
and to forward_2d_f64. Bound: 5e-3 nats, the JAX lowrank kernel's own
bound at L=20 (tests/test_pallas_kernel.py), because its signed SVD
factors cancel. On a CUDA card the kernel is held to the plain version at
1e-3 nats (the same f32 recurrence, summed in another order).

The kernel's layout (pack_lowrank: the factors in mma.m16n8k8 fragment
order, E transposed) unpacks to prepare_lowrank's M and E bit for bit, and
its 3xTF32 products are emulated here on the CPU (each operand split into
two TF32 values, three products summed in float32): on prot2dna at full
width and on the all-class machine they stay within the f64 bounds above
and within 1e-3 nats of the plain version. The streamed-factor fixture is
the 64-state dense machine (one dest-side diag class of rank 16, 256 KB of
factor tiles).

The JAX package is imported inside the tests that use it, so that the card
test runs where only torch is installed:
    python -m pytest --noconftest tests/test_torch_lowrank.py -m cuda
"""

import numpy as np
import pytest
import torch

from machineboss_tpu_torch import testmachines
from machineboss_tpu_torch.core.eval import EvaluatedMachine
from machineboss_tpu_torch.core.presets import make_preset
from machineboss_tpu_torch.ops.host_oracle import forward_2d_f64
from machineboss_tpu_torch.ops.kernels import lowrank_kernel as lk
from machineboss_tpu_torch.ops.lowering import LoweredMachine
from one_thread import one_torch_thread  # noqa: F401

JAX_BOUND = 5e-3     # nats, lowrank vs f64 and vs the JAX kernel at L<=20
CARD_BOUND = 1e-3    # nats, kernel vs plain on the card
CASES = ["prot2dna", "allclass", "dense8", "edges"]
# a diagonal of 101 cells takes two of the kernel's shared-memory chunks
CARD_CASES = CASES + ["prot2dna_long"]
# chained mode, uniform lengths: name -> (machine case, B, chain)
CHAINED = {"prot2dna_c2": ("prot2dna", 4, 2),
           "allclass_c3": ("allclass", 6, 3), "dense8_c2": ("dense8", 4, 2),
           "prot2dna_c1": ("prot2dna", 3, 1),
           "allclass_c5": ("allclass", 5, 5)}
_cache = {}


def _case(name):
    """(log-space matrices_2d, it, ot, il, ol) as numpy, from seeds."""
    if name in _cache:
        return _cache[name]
    if name in CHAINED:
        return _chained_case(name)
    if name.startswith("prot2dna"):
        m = make_preset("prot2dna")
        B, Lp = (8, 6) if name == "prot2dna" else (2, 100)
        rng = np.random.RandomState(2)
        lens = rng.randint(3, Lp + 1, B)
        lens[0] = Lp
        pairs = testmachines.prot2dna_pairs(B, lens, seed=2)
        Li, Lo = Lp, 3 * Lp
    elif name == "dense64":
        m = testmachines.build_random_transducer(64, list("ACGT"))
        B, L = 3, 10
        Li = Lo = L
    elif name in ("allclass", "edges"):
        m = testmachines.build_allclass_transducer(5, list("AC"))
        B, L = 6, 7
        Li = Lo = L
    else:
        m = testmachines.build_random_transducer(8, list("ACGT"), seed=15)
        B, L = 2, 20
        Li = Lo = L
    ev = EvaluatedMachine(m, m.get_param_defs(True))
    mats = tuple(np.asarray(x) for x in
                 LoweredMachine(ev, dtype=np.float32).matrices_2d())
    it = np.zeros((B, Li), np.int32)
    ot = np.zeros((B, Lo), np.int32)
    if name.startswith("prot2dna"):
        il = np.zeros(B, np.int32)
        ol = np.zeros(B, np.int32)
        for n, (p, dna) in enumerate(pairs):
            it[n, :len(p)] = [ev.input_tokenizer.sym2tok[c] - 1 for c in p]
            ot[n, :len(dna)] = [ev.output_tokenizer.sym2tok[c] - 1
                                for c in dna]
            il[n], ol[n] = len(p), len(dna)
    else:
        n_in, n_out = mats[1].shape[0], mats[2].shape[0]
        rng = np.random.RandomState({"allclass": 8, "dense64": 4}
                                    .get(name, 6))
        it[:] = rng.randint(0, n_in, (B, Li))
        ot[:] = rng.randint(0, n_out, (B, Lo))
        il = np.full(B, Li, np.int32)
        ol = np.full(B, Lo, np.int32)
        if name == "allclass":      # ragged, as the JAX package's test
            il[1], ol[1] = L - 3, L - 1
            il[2], ol[2] = L - 1, L - 4
        elif name == "edges":       # empty sides and single cells
            il[:], ol[:] = (0, 0, 5, 1, 1, 0), (0, 5, 0, 1, 0, 1)
    _cache[name] = (mats, it, ot, il, ol)
    return _cache[name]


def _chained_case(name):
    """A uniform-length batch of B pairs of a machine case (prot2dna: B
    proteins of 6 and their codon DNA; the others: seeded random tokens at
    the case's padded shape)."""
    kind, B, _ = CHAINED[name]
    mats, it, ot, _, _ = _case(kind)
    if kind == "prot2dna":
        m = make_preset("prot2dna")
        ev = EvaluatedMachine(m, m.get_param_defs(True))
        pairs = testmachines.prot2dna_pairs(B, 6, seed=B)
        it = np.array([[ev.input_tokenizer.sym2tok[c] - 1 for c in p]
                       for p, _ in pairs], np.int32)
        ot = np.array([[ev.output_tokenizer.sym2tok[c] - 1 for c in d]
                       for _, d in pairs], np.int32)
    else:
        rng = np.random.RandomState(B)
        it = rng.randint(0, mats[1].shape[0], (B, it.shape[1])) \
            .astype(np.int32)
        ot = rng.randint(0, mats[2].shape[0], (B, ot.shape[1])) \
            .astype(np.int32)
    _cache[name] = (mats, it, ot, np.full(B, it.shape[1], np.int32),
                    np.full(B, ot.shape[1], np.int32))
    return _cache[name]


def _f64(name):
    key = ("f64", name)
    if key not in _cache:
        mats, it, ot, il, ol = _case(name)
        m64 = [x.astype(np.float64) for x in mats]
        _cache[key] = np.array([forward_2d_f64(*m64, it[b][:il[b]],
                                               ot[b][:ol[b]])
                                for b in range(len(il))])
    return _cache[key]


def _port(name, device="cpu", rescale_every=4, chain=None):
    mats, it, ot, il, ol = _case(name)
    B, Li = it.shape
    if chain is None and name in CHAINED:
        chain = CHAINED[name][2]
    fn = lk.make_lowrank_forward(*mats, B, Li, ot.shape[1], device=device,
                                 rescale_every=rescale_every, chain=chain)
    return fn(it, ot, il, ol).cpu().numpy()


def _jax(name, chain=None):
    import jax.numpy as jnp
    from machineboss_tpu.ops.pallas.lowrank_kernel import \
        make_lowrank_forward as j_make
    mats, it, ot, il, ol = _case(name)
    B, Li = it.shape
    if chain is None and name in CHAINED:
        chain = CHAINED[name][2]
    jfn = j_make(*mats, B, Li, ot.shape[1], interpret=True, chain=chain)
    return np.array(jfn(jnp.array(it), jnp.array(ot), jnp.array(il),
                        jnp.array(ol)))


def _assert_close(dev, ref, bound):
    for b in range(len(ref)):
        if ref[b] <= -1e29:
            assert dev[b] <= -1e29, (b, dev[b])
        else:
            assert abs(float(dev[b]) - float(ref[b])) <= bound, \
                (b, dev[b], ref[b])


@pytest.mark.parametrize("name", CASES)
def test_plain_matches_jax_interpret(name):
    _assert_close(_port(name), _jax(name), JAX_BOUND)


@pytest.mark.parametrize("name", CASES)
def test_plain_matches_f64(name):
    _assert_close(_port(name), _f64(name), JAX_BOUND)


@pytest.mark.parametrize("rescale_every", [1, 2, 8])
def test_rescale_schedule_invariant(rescale_every):
    # rescaling only moves mass between p and its log scale m, so every
    # cadence gives the same scores up to f32 rounding (1e-5 nats)
    np.testing.assert_allclose(_port("allclass", rescale_every=rescale_every),
                               _port("allclass"), rtol=0, atol=1e-5)


def test_cpu_wrapper_takes_plain_without_launch():
    mats, it, ot, il, ol = _case("allclass")
    plan, host = lk.prepare_lowrank(*mats)
    ops = lk.lowrank_operands(plan, host, mats[0].shape[1],
                              torch.device("cpu"))
    batch = [torch.from_numpy(x) for x in (it, ot, il, ol)]
    before = lk.lowrank_wavefront.launches
    out = lk.lowrank_wavefront(ops, *batch)
    assert lk.lowrank_wavefront.launches == before
    assert torch.equal(out, lk.lowrank_forward_plain(ops, *batch))


@pytest.mark.parametrize("name", list(CHAINED))
def test_chained_plain_matches_jax_interpret(name):
    _assert_close(_port(name), _jax(name), JAX_BOUND)


@pytest.mark.parametrize("name", list(CHAINED))
def test_chained_plain_matches_f64(name):
    _assert_close(_port(name), _f64(name), JAX_BOUND)


@pytest.mark.parametrize("chain", [0, 1])
@pytest.mark.parametrize("name", ["prot2dna", "allclass"])
def test_chain_one_is_plain_mode(name, chain):
    """As the JAX factory (chained = bool(chain) and chain > 1), chain 0 and
    1 score in plain mode: the pairs' own lengths, the plain kernel."""
    before = lk.lowrank_chained_wavefront.launches
    res = _port(name, chain=chain)
    assert lk.lowrank_chained_wavefront.launches == before
    assert np.array_equal(res, _port(name))
    _assert_close(res, _jax(name, chain=chain), JAX_BOUND)


def test_prepare_lowrank_chained_equals_jax():
    """Chained mode has no static token scale: every class's scale is
    built from its tokens in the kernel; the factors are plain mode's."""
    from machineboss_tpu.ops.pallas.lowrank_kernel import \
        prepare_lowrank as j_prepare
    mats = _case("prot2dna")[0]
    plan, host = lk.prepare_lowrank(*mats, chained=True)
    j_plan, j_host = j_prepare(*mats, chained=True)
    assert [c.static_sc for c in plan["classes"]] == [False, False]
    assert [tuple(vars(c).values()) for c in plan["classes"]] == \
        [tuple(vars(c).values()) for c in j_plan["classes"]]
    plain_plan, plain_host = lk.prepare_lowrank(*mats)
    assert [c.static_sc for c in plain_plan["classes"]] == [False, True]
    for (M, E), (jM, jE), (pM, pE) in zip(host, j_host, plain_host):
        assert np.array_equal(M, jM) and np.array_equal(E, jE)
        assert np.array_equal(M, pM) and np.array_equal(E, pE)


def test_chained_cpu_wrapper_and_checks():
    mats, it, ot, il, ol = _case("allclass_c3")
    plan, host = lk.prepare_lowrank(*mats, chained=True)
    ops = lk.lowrank_operands(plan, host, mats[0].shape[1],
                              torch.device("cpu"))
    batch = [torch.from_numpy(x) for x in (it, ot, il, ol)]
    before = lk.lowrank_chained_wavefront.launches
    out = lk.lowrank_chained_wavefront(ops, *batch, n_chain=3)
    assert lk.lowrank_chained_wavefront.launches == before
    assert torch.equal(out, lk.lowrank_chained_forward_plain(
        ops, *batch, n_chain=3))
    # the lengths are ignored: every pair is read out at (Li, Lo)
    assert torch.equal(out, lk.lowrank_chained_forward_plain(
        ops, *batch[:2], n_chain=3))
    with pytest.raises(ValueError, match="multiple of chain"):
        lk.make_lowrank_forward(*mats, 6, 7, 7, device="cpu", chain=4)
    with pytest.raises(ValueError, match="non-empty"):
        lk.make_lowrank_forward(*mats, 6, 0, 7, device="cpu", chain=3)
    # through the wavefront factory too
    from machineboss_tpu_torch.ops.kernels import wavefront_kernel as wk
    fn = wk.make_wavefront_forward(*mats, 6, 7, 7, device="cpu",
                                   variant="lowrank", chain=3)
    assert torch.equal(fn(it, ot, il, ol), out)


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CHAINED))
def test_chained_kernel_matches_plain_on_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    chained = CHAINED[name][2] > 1
    before = lk.lowrank_chained_wavefront.launches
    kern = _port(name, device="cuda")
    assert lk.lowrank_chained_wavefront.launches == before + chained
    _assert_close(kern, _port(name), CARD_BOUND)
    _assert_close(kern, _f64(name), JAX_BOUND)


@pytest.mark.cuda
def test_chained_kernel_flags_a_bad_token_as_nan_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    mats, it, ot, il, ol = _case("allclass_c3")
    dev = torch.device("cuda")
    plan, host = lk.prepare_lowrank(*mats, chained=True)
    ops = lk.lowrank_operands(plan, host, mats[0].shape[1], dev)
    it = it.copy()
    it[4, 3] = 7                         # outside the 2-letter alphabet
    batch = [torch.from_numpy(x).to(dev) for x in (it, ot, il, ol)]
    res = lk.lowrank_chained_wavefront(ops, *batch, n_chain=3).cpu().numpy()
    assert np.isnan(res[4]) and np.isfinite(res[np.arange(6) != 4]).all()


@pytest.mark.cuda
@pytest.mark.parametrize("name", CARD_CASES)
def test_kernel_matches_plain_on_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    before = lk.lowrank_wavefront.launches
    kern = _port(name, device="cuda")
    assert lk.lowrank_wavefront.launches == before + 1
    _assert_close(kern, _port(name), CARD_BOUND)
    _assert_close(kern, _f64(name), JAX_BOUND)


# ---- the kernel's layout and arithmetic, on the CPU

def _plan(name):
    mats = _case(name)[0]
    plan, host = lk.prepare_lowrank(*mats)
    return plan, host


@pytest.mark.parametrize("name", ["prot2dna", "allclass", "dense8",
                                  "dense64"])
def test_packed_layout_unpacks_bit_for_bit(name):
    plan, host = _plan(name)
    Sa = plan["Sa"]
    a, et, desc, n_mt, slab, KZ = lk.pack_lowrank(plan["classes"], host, Sa)
    assert a.dtype == np.float32 and a.size == n_mt * slab
    assert n_mt * 16 >= Sa and slab % 128 == 0 and KZ % 8 == 0
    # the classes' operand rows are stacked in k-tiles, in class order
    assert list(desc[:, 8]) == list(np.cumsum([0] + [8 * k for k in
                                                     desc[:-1, 4]]))
    assert KZ == 8 * desc[:, 4].sum()
    for (M, E), (uM, uE) in zip(host, lk.unpack_lowrank(a, et, desc, n_mt,
                                                       slab, Sa)):
        assert np.array_equal(uM, M) and np.array_equal(uE, E)


def test_launch_plan_keeps_prot2dna_resident_and_streams_dense64():
    from types import SimpleNamespace

    def ops(name):
        plan, host = _plan(name)
        _, et, _, n_mt, slab, KZ = lk.pack_lowrank(plan["classes"], host,
                                                   plan["Sa"])
        return SimpleNamespace(n_mt=n_mt, slab=slab, KZ=KZ,
                               et_floats=-(-et.size // 4) * 4)

    p2d = ops("prot2dna")
    two = lk.launch_plan(p2d, 64, 192)
    assert two["resident"] and two["walkers"] == 2 and two["CC"] >= 16
    assert two["et_floats"] == p2d.et_floats       # token scales shared too
    one = lk.launch_plan(p2d, 64, 192, walkers=1)
    # the token scales take the room of one 8-cell tile of a diagonal
    assert one["resident"] and one["CC"] == 64 and one["et_floats"] > 0
    for cfg in (two, one):
        assert cfg["smem"] <= lk.SMEM_MAX and cfg["seg_mt"] == p2d.n_mt
    d64 = ops("dense64")
    assert d64.n_mt * d64.slab * 4 == 256 * 1024
    cfg = lk.launch_plan(d64, 200, 200)
    assert not cfg["resident"] and cfg["walkers"] == 1
    assert 1 <= cfg["seg_mt"] < d64.n_mt and cfg["smem"] <= lk.SMEM_MAX
    with pytest.raises(ValueError, match="two walkers"):
        lk.launch_plan(d64, 200, 200, walkers=2)
    with pytest.raises(ValueError, match="do not fit"):
        lk.launch_plan(SimpleNamespace(n_mt=4, slab=128 * 256, KZ=2048,
                                       et_floats=4), 64, 64)
    with pytest.raises(ValueError, match="walkers"):
        lk.launch_plan(p2d, 64, 192, walkers=3)


def _tf32(x, rounded=True):
    """x cut to 10 explicit mantissa bits: rounded to nearest, ties away
    from zero (cvt.rna.tf32.f32), or truncated (what the tensor core reads
    of a float32 operand)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + (0x1000 if rounded else 0)) & -0x2000).view(torch.float32)


def _mm3(x, y):
    """x @ y as the kernel's 3xTF32 split: hi = x rounded to TF32, lo the
    TF32 part of x - hi; hi_x hi_y + (hi_x lo_y + lo_x hi_y) in float32."""
    xh, yh = _tf32(x), _tf32(y)
    xl, yl = _tf32(x - xh, False), _tf32(y - yh, False)
    return xh @ yh + (xh @ yl + xl @ yh)


def _forward_3xtf32(ops, it, ot, il, ol):
    """lowrank_forward_plain with every class product split as the
    kernel's tensor-core products are."""
    from machineboss_tpu_torch.ops.kernels.plain_walk import walk_plain
    by_name = {cs.name: (cs, M, E) for cs, (M, E) in zip(ops.classes,
                                                         ops.mats)}

    def term(name, q, tok):
        cs, M, E = by_name[name]
        B, W = tok.shape
        sc = E.t()[tok]
        if cs.side == "src":
            return _mm3(q.repeat(1, 1, cs.rank) * sc, M.t())
        out = _mm3(q, M.t()) * sc
        return out.reshape(B, W, cs.rank, ops.Sa).sum(dim=2)

    return walk_plain(ops.c0, term, [cs.name for cs in ops.classes],
                      *[torch.from_numpy(x) for x in (it, ot, il, ol)],
                      ops.To)


def _p2d_full():
    """prot2dna at chip_smoke's main-path width: B=4 proteins of 64 and
    their 192-base DNA."""
    if "p2d_full" not in _cache:
        m = make_preset("prot2dna")
        ev = EvaluatedMachine(m, m.get_param_defs(True))
        mats = tuple(np.asarray(x) for x in
                     LoweredMachine(ev, dtype=np.float32).matrices_2d())
        pairs = testmachines.prot2dna_pairs(4, 64, seed=5)
        it = np.array([[ev.input_tokenizer.sym2tok[c] - 1 for c in p]
                       for p, _ in pairs], np.int32)
        ot = np.array([[ev.output_tokenizer.sym2tok[c] - 1 for c in d]
                       for _, d in pairs], np.int32)
        il, ol = np.full(4, 64, np.int32), np.full(4, 192, np.int32)
        m64 = [x.astype(np.float64) for x in mats]
        ref = np.array([forward_2d_f64(*m64, it[b], ot[b]) for b in range(4)])
        _cache["p2d_full"] = (mats, it, ot, il, ol, ref)
    return _cache["p2d_full"]


@pytest.mark.parametrize("name", ["prot2dna_full", "allclass"])
def test_3xtf32_products_hold_the_f64_bound(name):
    """Before any card time: the kernel's split products keep the lowrank
    Forward within the f64 bounds (5e-3 nats on the small machine, the
    0.01 gate at prot2dna's full width) and within the card bound of the
    float32 plain version."""
    if name == "prot2dna_full":
        mats, it, ot, il, ol, ref = _p2d_full()
        bound = 0.01
    else:
        mats, it, ot, il, ol = _case(name)
        ref, bound = _f64(name), JAX_BOUND
    plan, host = lk.prepare_lowrank(*mats)
    ops = lk.lowrank_operands(plan, host, mats[0].shape[1],
                              torch.device("cpu"))
    split = _forward_3xtf32(ops, it, ot, il, ol).numpy()
    plain = lk.lowrank_forward_plain(
        ops, *[torch.from_numpy(x) for x in (it, ot, il, ol)]).numpy()
    _assert_close(split, ref, bound)
    _assert_close(split, plain, CARD_BOUND)


def test_streamed_fixture_plain_matches_f64():
    """The 64-state dense machine (the streamed-factor plan) at 10 x 10:
    the plain version within the lowrank bound of the f64 oracle."""
    _assert_close(_port("dense64"), _f64("dense64"), JAX_BOUND)


# ---- the kernel on the card

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _ops(mats, dev, chained=False):
    plan, host = lk.prepare_lowrank(*mats, chained=chained)
    return lk.lowrank_operands(plan, host, mats[0].shape[1], dev)


@pytest.mark.cuda
@pytest.mark.parametrize("walkers", [1, 2])
@pytest.mark.parametrize("grid", [1, 2])
def test_kernel_grid_below_batch_with_faults_on_card(grid, walkers):
    """Fewer walkers than pairs, so each takes several pairs from the
    queue; pair 2 holds a bad token and pair 4 a bad length: both NaN, the
    pairs after them as the plain version scores them."""
    dev = _card()
    mats, it, ot, il, ol = _case("allclass")
    bad_it, bad_il = it.copy(), il.copy()
    bad_it[2, 0] = 7                      # outside the 2-letter alphabet
    bad_il[4] = it.shape[1] + 1           # past the padded shape
    ops = _ops(mats, dev)
    batch = [torch.from_numpy(x).to(dev) for x in (bad_it, ot, bad_il, ol)]
    kern = lk.lowrank_wavefront(ops, *batch, grid=grid,
                                walkers=walkers).cpu().numpy()
    assert np.isnan(kern[2]) and np.isnan(kern[4])
    live = np.array([b not in (2, 4) for b in range(len(il))])
    _assert_close(kern[live], _port("allclass")[live], CARD_BOUND)


@pytest.mark.cuda
def test_streamed_factors_match_plain_on_card():
    dev = _card()
    mats, it, ot, il, ol = _case("dense64")
    ops = _ops(mats, dev)
    assert not lk.launch_plan(ops, it.shape[1], ot.shape[1])["resident"]
    before = lk.lowrank_wavefront.launches
    kern = _port("dense64", device="cuda")
    assert lk.lowrank_wavefront.launches == before + 1
    _assert_close(kern, _port("dense64"), CARD_BOUND)
    _assert_close(kern, _f64("dense64"), JAX_BOUND)


@pytest.mark.cuda
def test_walkers_and_grid_do_not_change_the_scores_on_card():
    """One walker computes a pair in a fixed order: the scores are equal
    bit for bit whatever the grid and the walkers per block."""
    dev = _card()
    mats, it, ot, il, ol = _case("prot2dna_long")
    ops = _ops(mats, dev)
    batch = [torch.from_numpy(x).to(dev) for x in (it, ot, il, ol)]
    runs = [lk.lowrank_wavefront(ops, *batch, grid=g, walkers=w)
            .cpu().numpy() for g, w in ((None, None), (1, 1), (1, 2),
                                        (3, 1))]
    for r in runs[1:]:
        assert np.array_equal(r, runs[0])


@pytest.mark.cuda
def test_impossible_pairs_on_card():
    """The diag-only dense8 machine has no path for il != ol."""
    dev = _card()
    mats = _case("dense8")[0]
    rng = np.random.RandomState(2)
    it = rng.randint(0, 4, (4, 6)).astype(np.int32)
    ot = rng.randint(0, 4, (4, 8)).astype(np.int32)
    il = np.array([6, 5, 6, 4], np.int32)
    ol = np.array([8, 8, 6, 4], np.int32)
    ops = _ops(mats, dev)
    kern = lk.lowrank_wavefront(
        ops, *[torch.from_numpy(x).to(dev) for x in (it, ot, il, ol)])
    kern = kern.cpu().numpy()
    assert (kern[:2] <= -1e29).all() and (kern[2:] > -1e29).all()
    plain = lk.lowrank_forward_plain(
        _ops(mats, torch.device("cpu")),
        *[torch.from_numpy(x) for x in (it, ot, il, ol)]).numpy()
    _assert_close(kern, plain, CARD_BOUND)


@pytest.mark.cuda
def test_chained_odd_stagger_below_88_nats_on_card():
    """prot2dna, 3 pairs of 57 amino acids against 171 bases on 3 chains:
    Lo + 2 = 173 is odd, so chain 1 starts on an odd diagonal, and every
    pair scores below -88 nats."""
    dev = _card()
    m = make_preset("prot2dna")
    ev = EvaluatedMachine(m, m.get_param_defs(True))
    mats = tuple(np.asarray(x) for x in
                 LoweredMachine(ev, dtype=np.float32).matrices_2d())
    pairs = testmachines.prot2dna_pairs(3, 57, seed=1)
    it = np.array([[ev.input_tokenizer.sym2tok[c] - 1 for c in p]
                   for p, _ in pairs], np.int32)
    ot = np.array([[ev.output_tokenizer.sym2tok[c] - 1 for c in d]
                   for _, d in pairs], np.int32)
    m64 = [x.astype(np.float64) for x in mats]
    ref = np.array([forward_2d_f64(*m64, it[b], ot[b]) for b in range(3)])
    assert (ref < -88).all()
    ops = _ops(mats, dev, chained=True)
    kern = lk.lowrank_chained_wavefront(
        ops, *[torch.from_numpy(x).to(dev) for x in (it, ot)],
        n_chain=3).cpu().numpy()
    plain = lk.lowrank_chained_forward_plain(
        _ops(mats, torch.device("cpu"), chained=True),
        *[torch.from_numpy(x) for x in (it, ot)], n_chain=3).numpy()
    _assert_close(kern, plain, CARD_BOUND)
    _assert_close(kern, ref, JAX_BOUND)


@pytest.mark.cuda
@pytest.mark.parametrize("pair", ["tokens_global", "cells_global"])
def test_pair_modes_match_the_shared_pair_on_card(pair):
    """The pair's tokens read from global memory, and with them its cells'
    log scales, divisors and maxima in a global buffer: the same sums in
    the same order as with the pair in shared memory, so the scores are
    equal bit for bit, with one walker a block and two, in both modes."""
    dev = _card()
    mats, it, ot, il, ol = _case("prot2dna_long")
    ops = _ops(mats, dev)
    assert lk.launch_plan(ops, it.shape[1], ot.shape[1])["pair"] == "shared"
    batch = [torch.from_numpy(x).to(dev) for x in (it, ot, il, ol)]
    for walkers in (1, 2):
        want = lk.lowrank_wavefront(ops, *batch, walkers=walkers)
        got = lk.lowrank_wavefront(ops, *batch, walkers=walkers, pair=pair)
        assert torch.equal(got, want)
    mats, it, ot, _, _ = _case("prot2dna_c2")
    ops = _ops(mats, dev, chained=True)
    batch = [torch.from_numpy(x).to(dev) for x in (it, ot)]
    want = lk.lowrank_chained_wavefront(ops, *batch, n_chain=2)
    got = lk.lowrank_chained_wavefront(ops, *batch, n_chain=2, pair=pair)
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_long_dna_matches_plain_on_card():
    """prot2dna, 2 pairs of 64 amino acids whose codon DNA lies inside
    about 20,000 random bases on each side (the preset's flank states give
    them a path): the longer DNA pads to 58,837, past what the pair's
    tokens leave room for in shared memory, so the plan reads them from
    global memory; the kernel within 1e-3 nats of the plain version, and
    its scores, below -50,000 nats, are where the float64 log scales
    matter."""
    from machineboss_tpu_torch.ops.fwdback import pad_bucket
    dev = _card()
    m = make_preset("prot2dna")
    ev = EvaluatedMachine(m, m.get_param_defs(True))
    mats = tuple(np.asarray(x) for x in
                 LoweredMachine(ev, dtype=np.float32).matrices_2d())
    rng = np.random.RandomState(9)
    pairs = []
    for n, (p, dna) in enumerate(testmachines.prot2dna_pairs(2, 64, seed=9)):
        left, right = ("".join("ACGT"[c] for c in rng.randint(0, 4, k))
                       for k in (20000 - 400 * n, 19900))
        pairs.append((p, left + dna + right))
    Li = pad_bucket(64, base=16)
    Lo = pad_bucket(max(len(d) for _, d in pairs), base=16)
    assert Lo == 58837
    it = np.zeros((2, Li), np.int32)
    ot = np.zeros((2, Lo), np.int32)
    for n, (p, dna) in enumerate(pairs):
        it[n, :len(p)] = [ev.input_tokenizer.sym2tok[c] - 1 for c in p]
        ot[n, :len(dna)] = [ev.output_tokenizer.sym2tok[c] - 1 for c in dna]
    il = np.array([len(p) for p, _ in pairs], np.int32)
    ol = np.array([len(d) for _, d in pairs], np.int32)
    ops = _ops(mats, dev)
    cfg = lk.launch_config(ops, 2, Li, Lo)
    assert cfg["pair"] == "tokens_global" and cfg["smem"] <= lk.SMEM_MAX
    assert lk.smem_bytes_on_card(ops, cfg, Li, Lo) == cfg["smem"]
    batch = [torch.from_numpy(x).to(dev) for x in (it, ot, il, ol)]
    kern = lk.lowrank_wavefront(ops, *batch).cpu().numpy()
    plain = lk.lowrank_forward_plain(ops, *batch).cpu().numpy()
    assert (kern < -5e4).all()
    _assert_close(kern, plain, CARD_BOUND)
