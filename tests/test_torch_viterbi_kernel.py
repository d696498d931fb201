"""The port's max-plus (Viterbi) wavefront fills against the JAX kernels and
the host engine.

viterbi_forward_plain and viterbi_banded_forward_plain (the CPU paths of
make_wavefront_viterbi and make_wavefront_viterbi_banded) are held to the
JAX package's factories in their own CPU mode (interpret=True) on the same
numpy matrices: max-plus uses only float32 adds and maxes, so 0.0 is
expected and the bound is 1e-6 nats, with the same finite/NEG_INF pattern;
and to the host ViterbiMatrix's cells at 1e-4 nats (the JAX tests' TOL:
the host fills in float64). The host prep is held bit-equal to the JAX
package's, and the batched fill's launch plan (cluster size, shared slots
or read-back) is checked on the CPU. On a CUDA card the kernels are held
to the plain versions at 0.0, the batched fill with one and two blocks a
pair, with slots and read back.

The JAX package is imported inside the tests that use it, so that the card
tests run where only torch is installed:
    python -m pytest --noconftest tests/test_torch_viterbi_kernel.py -m cuda
"""

import numpy as np
import pytest
import torch

from machineboss_tpu_torch import testmachines
from machineboss_tpu_torch.algo.dp_host import ViterbiMatrix
from machineboss_tpu_torch.convert import viterbi_from_numpy
from machineboss_tpu_torch.core.eval import EvaluatedMachine
from machineboss_tpu_torch.core.seqpair import Envelope, NamedSeq, SeqPair
from machineboss_tpu_torch.ops.kernels import viterbi_kernel as vk
from machineboss_tpu_torch.ops.lowering import LoweredMachine
from machineboss_tpu_torch.ops.wavefront import lattice_from_diagonals

EXACT_BOUND = 1e-6   # nats, plain vs the JAX kernel (0.0 expected)
HOST_TOL = 1e-4      # nats, vs the float64 host fill
NEG = -1e29

# name -> (machine factory, alphabet, B, Li, Lo, token seed)
CASES = {
    "allclass": (lambda: testmachines.build_allclass_transducer(
        5, list("AC")), "AC", 4, 6, 5, 0),
    "indel": (lambda: testmachines.build_indel_transducer(
        5, list("AC"), seed=21), "AC", 3, 5, 5, 5),
    "dense6": (lambda: testmachines.build_random_transducer(
        6, list("ACGT"), seed=2), "ACGT", 3, 6, 6, 3),
    "tiefree": (testmachines.build_tiefree_machine, "ACG", 3, 5, 6, 4),
}
_cache = {}


def _case(name):
    """(machine, ev, maxplus matrices_2d, it, ot) from seeds."""
    if name not in _cache:
        build, _, B, Li, Lo, seed = CASES[name]
        m = build()
        ev = EvaluatedMachine(m, m.get_param_defs(True))
        mats = tuple(np.asarray(x) for x in LoweredMachine(
            ev, dtype=np.float32).matrices_2d("maxplus"))
        rng = np.random.RandomState(seed)
        n_in, n_out = mats[1].shape[0], mats[2].shape[0]
        it = rng.randint(0, n_in, (B, Li)).astype(np.int32)
        ot = rng.randint(0, n_out, (B, Lo)).astype(np.int32)
        _cache[name] = (m, ev, mats, it, ot)
    return _cache[name]


def _pair(name, b, li=None, lo=None):
    _, _, _, it, ot = _case(name)
    alphabet = CASES[name][1]
    return SeqPair(NamedSeq("i", [alphabet[t] for t in it[b][:li]]),
                   NamedSeq("o", [alphabet[t] for t in ot[b][:lo]]))


def _assert_same(a, b, bound):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape
    assert np.array_equal(a > NEG, b > NEG)
    live = a > NEG
    if live.any():
        assert np.abs(a[live] - b[live]).max() <= bound


def _band_case(seed=1, L=24, width=4):
    m, ev, mats, _, _ = _case("dense6")
    sp = testmachines.align_pair(L, seed=seed)
    env = Envelope(sp, width=width)
    it0 = np.array(ev.input_tokenizer.tokenize(sp.input.seq), np.int32) - 1
    ot0 = np.array(ev.output_tokenizer.tokenize(sp.output.seq), np.int32) - 1
    return m, ev, mats, sp, env, it0, ot0


# ------------------------------------------------------------- the host prep

@pytest.mark.parametrize("name", list(CASES))
def test_maxplus_class_mats_bit_equal(name):
    from machineboss_tpu.ops.pallas.viterbi_kernel import \
        maxplus_class_mats as j_mats
    mats = _case(name)[2]
    ours, theirs = vk.maxplus_class_mats(*mats), j_mats(*mats)
    assert ours[4] == theirs[4]
    for a, b in zip(ours[:4], theirs[:4]):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    if name == "indel":
        assert ours[4] == (True, True, False)
    elif name == "dense6":
        assert ours[4] == (False, False, True)
    else:
        assert ours[4] == (True, True, True)


@pytest.mark.parametrize("L,width,seed", [(24, 4, 1), (17, 2, 3), (9, 0, 5),
                                          (6, 30, 7)])
def test_band_geometry_bit_equal(L, width, seed):
    from machineboss_tpu.core.seqpair import Envelope as JEnvelope
    from machineboss_tpu.ops.pallas.viterbi_kernel import (
        band_windows as j_windows, envelope_diag_bands as j_bands)
    # an alignment with indels, so that the band's base moves unevenly
    rng = np.random.RandomState(seed)
    cols = []
    for _ in range(L):
        r = rng.rand()
        a, b = "ACGT"[rng.randint(4)], "ACGT"[rng.randint(4)]
        cols.append((a, b) if r < 0.6 else (a, "") if r < 0.8 else ("", b))
    sp = SeqPair(NamedSeq("x", [a for a, _ in cols if a]),
                 NamedSeq("y", [b for _, b in cols if b]), cols)
    env = Envelope(sp, width=width)
    jenv = JEnvelope(sp, width=width)
    assert (env.in_start, env.in_end) == (jenv.in_start, jenv.in_end)
    lo, hi = vk.envelope_diag_bands(env)
    jlo, jhi = j_bands(jenv)
    assert np.array_equal(lo, jlo) and np.array_equal(hi, jhi)
    for pad in (128, 8, 1):
        ours, theirs = vk.band_windows(lo, hi, pad), j_windows(jlo, jhi, pad)
        assert np.array_equal(ours[0], theirs[0])
        assert np.array_equal(ours[1], theirs[1]) and ours[2] == theirs[2]


def test_envelope_diag_bands_rejects_a_split_diagonal():
    sp = SeqPair(NamedSeq("x", list("ACGT")), NamedSeq("y", list("AC")))
    env = Envelope(sp)
    # diagonal 2 holds i = 2 (row 0) and i = 0 (row 2) but not i = 1
    env.in_start, env.in_end = [0, 2, 0], [3, 5, 1]
    with pytest.raises(ValueError, match="not contiguous"):
        vk.envelope_diag_bands(env)


def test_operands_layout():
    mats = _case("allclass")[2]
    pre = vk.maxplus_class_mats(*mats)
    ops = viterbi_from_numpy(*pre, device="cpu")
    S = mats[3].shape[0]
    assert (ops.S, ops.SP, ops.Ti, ops.To) == (S, 8, 2, 2)
    assert ops.classes == (True, True, True)
    mu, md, ml = pre[:3]
    for ty in range(2):
        assert np.array_equal(ops.up[ty, :, :S].numpy(),
                              mu[ty * S:(ty + 1) * S].T)
        for ti in range(2):
            assert np.array_equal(
                ops.diag[ti * 2 + ty, :, :S].numpy(),
                md[ty * S:(ty + 1) * S, ti * S:(ti + 1) * S].T)
    assert np.array_equal(ops.left[1, :, :S].numpy(), ml[S:2 * S].T)
    assert (ops.up[:, :, S:] == -1e30).all()
    ind = viterbi_from_numpy(*vk.maxplus_class_mats(*_case("indel")[2]),
                             device="cpu")
    assert ind.diag is None and ind.classes == (True, True, False)


# -------------------------------------------------------------- the full fill

@pytest.mark.parametrize("name", list(CASES))
def test_plain_matches_jax_interpret(name):
    import jax.numpy as jnp
    from machineboss_tpu.ops.pallas.viterbi_kernel import \
        make_wavefront_viterbi as j_make
    _, _, mats, it, ot = _case(name)
    B, Li = it.shape
    Lo = ot.shape[1]
    ref = np.asarray(j_make(*mats, B, Li, Lo, interpret=True)(
        jnp.array(it), jnp.array(ot)))
    got = vk.make_wavefront_viterbi(*mats, B, Li, Lo, device="cpu")(it, ot)
    assert got.shape == (Li + Lo + 1, B, Li + 1, mats[3].shape[0])
    # the JAX slabs are lane-padded beyond W = Li + 1
    _assert_same(got.numpy(), ref[:, :, :Li + 1], EXACT_BOUND)
    assert np.array_equal(got.numpy(), ref[:, :, :Li + 1])


@pytest.mark.parametrize("name", list(CASES))
def test_plain_matches_host_cells(name):
    _, ev, mats, it, ot = _case(name)
    B, Li = it.shape
    Lo = ot.shape[1]
    diags = vk.make_wavefront_viterbi(*mats, B, Li, Lo, device="cpu")(it, ot)
    lat = lattice_from_diagonals(diags, Li, Lo)
    for b in range(B):
        host = np.asarray(ViterbiMatrix(ev, _pair(name, b)).cell)
        _assert_same(np.where(host > NEG, host, -1e30), lat[b], HOST_TOL)


@pytest.mark.parametrize("name", ["allclass", "indel"])
def test_lengths_mask_the_padding(name):
    """With per-pair lengths, every cell inside a pair's own lattice keeps
    the value of the pair's own fill, and every cell beyond it is
    NEG_INF."""
    _, _, mats, it, ot = _case(name)
    B, Li = it.shape
    Lo = ot.shape[1]
    il = np.array([Li, 0, 3, 2][:B], np.int32)
    ol = np.array([0, Lo, 2, Lo][:B], np.int32)
    fn = vk.make_wavefront_viterbi(*mats, B, Li, Lo, device="cpu")
    lat = lattice_from_diagonals(fn(it, ot, il, ol), Li, Lo)
    for b in range(B):
        own = vk.make_wavefront_viterbi(*mats, 1, il[b], ol[b], device="cpu")
        ref = lattice_from_diagonals(
            own(it[b:b + 1, :il[b]], ot[b:b + 1, :ol[b]]), il[b], ol[b])[0]
        assert np.array_equal(lat[b, :il[b] + 1, :ol[b] + 1], ref)
        beyond = np.ones((Li + 1, Lo + 1), bool)
        beyond[:il[b] + 1, :ol[b] + 1] = False
        assert (lat[b][beyond] == np.float32(-1e30)).all()


def test_token_outside_the_alphabet_matches_nothing():
    _, _, mats, it, ot = _case("allclass")
    B, Li = it.shape
    Lo = ot.shape[1]
    bad = it.copy()
    bad[0, 2] = 7
    fn = vk.make_wavefront_viterbi(*mats, B, Li, Lo, device="cpu")
    lat = lattice_from_diagonals(fn(bad, ot), Li, Lo)
    good = lattice_from_diagonals(fn(it, ot), Li, Lo)
    assert (lat[0, 3:] <= NEG).all()          # no path passes x_3
    assert np.array_equal(lat[0, :3], good[0, :3])
    assert np.array_equal(lat[1:], good[1:])


def test_factories_check_their_arguments():
    _, _, mats, it, ot = _case("dense6")
    fn = vk.make_wavefront_viterbi(*mats, 3, 6, 6, device="cpu", n_chunks=2)
    with pytest.raises(ValueError, match="expected tokens of shape"):
        fn(it[:, :4], ot)
    with pytest.raises(ValueError, match="Li \\+ Lo \\+ 1"):
        vk.make_wavefront_viterbi_banded(*mats, 6, 6, [0] * 5, [1] * 5,
                                         device="cpu")
    lo, hi = np.zeros(13, int), np.full(13, 7)
    band = vk.make_wavefront_viterbi_banded(*mats, 6, 6, lo, hi, device="cpu")
    with pytest.raises(ValueError, match="expected tokens of shape"):
        band.fill_raw(it[0, :4], ot[0])


def test_cpu_wrappers_take_plain_without_launch():
    _, _, mats, it, ot = _case("allclass")
    ops = vk.viterbi_operands(vk.maxplus_class_mats(*mats),
                              torch.device("cpu"))
    t_it, t_ot = torch.from_numpy(it), torch.from_numpy(ot)
    before = vk.viterbi_wavefront.launches
    out = vk.viterbi_wavefront(ops, t_it, t_ot)
    assert vk.viterbi_wavefront.launches == before
    assert torch.equal(out, vk.viterbi_forward_plain(ops, t_it, t_ot))
    Li, Lo = it.shape[1], ot.shape[1]
    geom = vk.band_geometry(Li, Lo, np.zeros(Li + Lo + 1, int),
                            np.full(Li + Lo + 1, Li + 1), torch.device("cpu"))
    before = vk.viterbi_banded_wavefront.launches
    out = vk.viterbi_banded_wavefront(ops, geom, t_it[0], t_ot[0])
    assert vk.viterbi_banded_wavefront.launches == before
    assert torch.equal(out, vk.viterbi_banded_forward_plain(
        ops, geom, t_it[0], t_ot[0]))


def _ops_of(name, dev=torch.device("cpu")):
    return vk.viterbi_operands(vk.maxplus_class_mats(*_case(name)[2]), dev)


def test_fill_launch_plan():
    """Two blocks a pair while the batch has fewer pairs than the card has
    multiprocessors; two shared slots without a diag class, three with
    one, read-back when they do not fit."""
    indel, allclass = _ops_of("indel"), _ops_of("allclass")
    assert indel.diag is None and allclass.diag is not None
    cfg = vk.fill_launch_plan(indel, 64, 64, 192, 132)
    assert (cfg["grid"], cfg["cluster"], cfg["n_slots"]) == (64, 2, 2)
    assert cfg["piece"] == 8 and cfg["chunks"] == 0
    assert cfg["smem"] == vk.fill_smem_bytes(64, 192, indel.S, 2,
                                             vk._n_toks(indel))
    assert vk.fill_launch_plan(allclass, 64, 128, 128, 132)["n_slots"] == 3
    assert vk.fill_launch_plan(indel, 132, 8, 8, 132)["cluster"] == 1
    assert vk.fill_launch_plan(indel, 4, 8, 8, 132, grid=1)["grid"] == 1
    # three (3401, 6) diagonals exceed 227 KB: read back from the lattice
    long_ = vk.fill_launch_plan(allclass, 1, 3400, 3, 132)
    assert long_["n_slots"] == 0 and long_["smem"] <= vk.SMEM_MAX
    assert vk.fill_smem_bytes(3400, 3, allclass.S, 3,
                              vk._n_toks(allclass)) > vk.SMEM_MAX
    with pytest.raises(ValueError, match="do not fit"):
        vk.fill_launch_plan(allclass, 1, 3400, 3, 132, slots=True)
    assert vk.fill_launch_plan(allclass, 4, 8, 8, 132,
                               slots=False)["n_slots"] == 0
    with pytest.raises(ValueError, match="token buckets"):
        vk.fill_launch_plan(allclass, 1, 20000, 3, 132)
    for bad in ({"cluster": 4}, {"piece": 0}, {"piece": 9}, {"chunks": 9},
                {"grid": 0}):
        with pytest.raises(ValueError):
            vk.fill_launch_plan(indel, 4, 8, 8, 132, **bad)


# ------------------------------------------------------------ the banded fill

@pytest.mark.parametrize("seed", [1, 7])
def test_banded_plain_matches_jax_interpret(seed):
    from machineboss_tpu.ops.pallas.viterbi_kernel import \
        make_wavefront_viterbi_banded as j_make
    _, _, mats, _, env, it0, ot0 = _band_case(seed)
    lo, hi = vk.envelope_diag_bands(env)
    L = len(it0)
    jfill = j_make(*mats, L, L, lo, hi, interpret=True)
    fill = vk.make_wavefront_viterbi_banded(*mats, L, L, lo, hi, device="cpu")
    assert np.array_equal(fill.bases, jfill.bases)
    assert fill.Wb == 8 and jfill.Wb == 128
    raw = fill.fill_raw(it0, ot0).numpy()                  # (n_diags, Wb, S)
    jraw = np.asarray(jfill.fill_raw(it0, ot0))            # (n_diags, S, 128)
    assert np.array_equal(raw, np.transpose(jraw, (0, 2, 1))[:, :fill.Wb])
    assert (jraw[:, :, fill.Wb:] == np.float32(-1e30)).all()
    full, jfull = fill(it0, ot0), jfill(it0, ot0)
    _assert_same(full, jfull, EXACT_BOUND)
    assert np.array_equal(full, jfull)


def test_banded_plain_matches_host_cells():
    _, ev, mats, sp, env, it0, ot0 = _band_case()
    lo, hi = vk.envelope_diag_bands(env)
    L = len(it0)
    full = vk.make_wavefront_viterbi_banded(*mats, L, L, lo, hi,
                                            device="cpu")(it0, ot0)
    host = np.asarray(ViterbiMatrix(ev, sp, env=env).cell)
    _assert_same(np.where(host > NEG, host, -1e30), full, HOST_TOL)


def test_full_band_equals_the_full_fill():
    """A band that covers the lattice, on the all-class machine with an
    uneven window (the base held at 0), gives the full fill's lattice."""
    _, _, mats, it, ot = _case("allclass")
    Li, Lo = it.shape[1], ot.shape[1]
    n = Li + Lo + 1
    d = np.arange(n)
    lo, hi = np.maximum(0, d - Lo), np.minimum(Li, d) + 1
    band = vk.make_wavefront_viterbi_banded(*mats, Li, Lo, lo, hi,
                                            device="cpu")
    diags = vk.make_wavefront_viterbi(*mats, 1, Li, Lo, device="cpu")(
        it[:1], ot[:1])
    assert np.array_equal(band(it[0], ot[0]),
                          lattice_from_diagonals(diags, Li, Lo)[0])


@pytest.mark.parametrize("li,lo", [(0, 4), (4, 0), (0, 0)])
def test_banded_zero_length_sides(li, lo):
    _, _, mats, it, ot = _case("allclass")
    n = li + lo + 1
    d = np.arange(n)
    band = vk.make_wavefront_viterbi_banded(
        *mats, li, lo, np.maximum(0, d - lo), np.minimum(li, d) + 1,
        device="cpu")
    diags = vk.make_wavefront_viterbi(*mats, 1, li, lo, device="cpu")(
        it[:1, :li], ot[:1, :lo])
    assert np.array_equal(band(it[0, :li], ot[0, :lo]),
                          lattice_from_diagonals(diags, li, lo)[0])


# ------------------------------------------------------------------- the card

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("grid", [None, 1])
@pytest.mark.parametrize("name", list(CASES))
def test_kernel_matches_plain_on_card(name, grid):
    """grid=1 sends every pair through ONE block, one after the other."""
    dev = _card()
    _, _, mats, it, ot = _case(name)
    B, Li = it.shape
    Lo = ot.shape[1]
    ops = vk.viterbi_operands(vk.maxplus_class_mats(*mats), dev)
    t_it = torch.from_numpy(it).to(dev)
    t_ot = torch.from_numpy(ot).to(dev)
    lens = [None, None]
    if grid == 1:                   # ragged, with an empty side
        lens = [torch.tensor(([Li, 0, 3, 2] * B)[:B], dtype=torch.int32,
                             device=dev),
                torch.tensor(([0, Lo, 2, Lo] * B)[:B], dtype=torch.int32,
                             device=dev)]
    before = vk.viterbi_wavefront.launches
    kern = vk.viterbi_wavefront(ops, t_it, t_ot, *lens, grid=grid)
    torch.cuda.synchronize()
    assert vk.viterbi_wavefront.launches == before + 1
    assert torch.equal(kern, vk.viterbi_forward_plain(ops, t_it, t_ot, *lens))


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [1, 7])
def test_banded_kernel_matches_plain_on_card(seed):
    dev = _card()
    _, _, mats, _, env, it0, ot0 = _band_case(seed)
    lo, hi = vk.envelope_diag_bands(env)
    L = len(it0)
    ops = vk.viterbi_operands(vk.maxplus_class_mats(*mats), dev)
    geom = vk.band_geometry(L, L, lo, hi, dev)
    t_it = torch.from_numpy(it0).to(dev)
    t_ot = torch.from_numpy(ot0).to(dev)
    before = vk.viterbi_banded_wavefront.launches
    kern = vk.viterbi_banded_wavefront(ops, geom, t_it, t_ot)
    torch.cuda.synchronize()
    assert vk.viterbi_banded_wavefront.launches == before + 1
    assert torch.equal(kern, vk.viterbi_banded_forward_plain(
        ops, geom, t_it, t_ot))


@pytest.mark.cuda
@pytest.mark.parametrize("banded", [False, True])
def test_kernel_reads_the_lattice_back_when_shared_memory_is_short(banded):
    """A pair so long that three diagonals exceed a block's shared memory:
    both kernels then read the previous diagonals from the lattice."""
    dev = _card()
    mats = _case("allclass")[2]
    S = mats[3].shape[0]
    Li, Lo = 3400, 3
    assert 3 * (Li + 1) * S * 4 > 232448
    rng = np.random.RandomState(12)
    ops = vk.viterbi_operands(vk.maxplus_class_mats(*mats), dev)
    # only the first symbol can be consumed without an output: an input
    # of it alone keeps every diagonal alive
    t_it = torch.zeros((1, Li), dtype=torch.int32, device=dev)
    t_ot = torch.from_numpy(
        rng.randint(0, 2, (1, Lo)).astype(np.int32)).to(dev)
    if banded:
        d = np.arange(Li + Lo + 1)
        geom = vk.band_geometry(Li, Lo, np.zeros_like(d),
                                np.minimum(Li, d) + 1, dev)
        assert geom.Wb >= Li + 1
        kern = vk.viterbi_banded_wavefront(ops, geom, t_it[0], t_ot[0])
        plain = vk.viterbi_banded_forward_plain(ops, geom, t_it[0], t_ot[0])
    else:
        assert vk.fill_launch_plan(ops, 1, Li, Lo, 132)["n_slots"] == 0
        kern = vk.viterbi_wavefront(ops, t_it, t_ot)
        plain = vk.viterbi_forward_plain(ops, t_it, t_ot)
    torch.cuda.synchronize()
    assert torch.equal(kern, plain)
    assert (kern[Li // 2] > NEG).any()


@pytest.mark.cuda
@pytest.mark.parametrize("slots", [True, False])
@pytest.mark.parametrize("cluster", [1, 2])
@pytest.mark.parametrize("name", list(CASES))
def test_fill_clusters_and_slots_match_plain_on_card(name, cluster, slots):
    """One and two blocks a pair, the previous diagonals in shared memory
    or read back from the lattice: the lattice equals the plain version."""
    dev = _card()
    _, _, mats, it, ot = _case(name)
    B = it.shape[0]
    ops = vk.viterbi_operands(vk.maxplus_class_mats(*mats), dev)
    batch = [torch.from_numpy(x).to(dev) for x in (it, ot)]
    lens = [torch.tensor(([it.shape[1], 2, 4] * B)[:B], dtype=torch.int32,
                         device=dev),
            torch.tensor(([ot.shape[1], 3, 1] * B)[:B], dtype=torch.int32,
                         device=dev)]
    kern = vk.viterbi_wavefront(ops, *batch, *lens, cluster=cluster,
                                slots=slots)
    torch.cuda.synchronize()
    assert torch.equal(kern, vk.viterbi_forward_plain(ops, *batch, *lens))


@pytest.mark.cuda
@pytest.mark.parametrize("cluster", [1, 2])
def test_fill_one_walker_ragged_with_an_empty_side_on_card(cluster):
    """grid=1: one walker (one cluster) takes every pair in turn, the
    lengths ragged, one pair with no input and one with no output."""
    dev = _card()
    _, _, mats, it, ot = _case("allclass")
    B, Li = it.shape
    Lo = ot.shape[1]
    ops = vk.viterbi_operands(vk.maxplus_class_mats(*mats), dev)
    batch = [torch.from_numpy(x).to(dev) for x in (it, ot)]
    lens = [torch.tensor([Li, 0, 3, 2][:B], dtype=torch.int32, device=dev),
            torch.tensor([1, Lo, 0, Lo][:B], dtype=torch.int32, device=dev)]
    kern = vk.viterbi_wavefront(ops, *batch, *lens, grid=1, cluster=cluster)
    torch.cuda.synchronize()
    assert torch.equal(kern, vk.viterbi_forward_plain(ops, *batch, *lens))


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [{"cluster": 2}, {"cluster": 1, "slots": False},
                                {"piece": 1}, {"piece": 3, "chunks": 5}])
def test_fill_token_outside_the_alphabet_on_card(kw):
    """A token outside its alphabet matches nothing, in every layout; the
    piece size and the source chunks change nothing."""
    dev = _card()
    _, _, mats, it, ot = _case("allclass")
    bad_it, bad_ot = it.copy(), ot.copy()
    bad_it[1, 2] = 9
    bad_ot[2, 0] = -3
    ops = vk.viterbi_operands(vk.maxplus_class_mats(*mats), dev)
    batch = [torch.from_numpy(x).to(dev) for x in (bad_it, bad_ot)]
    kern = vk.viterbi_wavefront(ops, *batch, **kw)
    torch.cuda.synchronize()
    assert torch.equal(kern, vk.viterbi_forward_plain(ops, *batch))
