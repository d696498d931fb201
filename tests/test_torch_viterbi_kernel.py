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
    # 20,001 cells a diagonal: the token buckets go to global memory;
    # forced into shared memory, they raise
    with pytest.raises(ValueError, match="token buckets"):
        vk.fill_launch_plan(allclass, 1, 20000, 3, 132, buckets="shared")
    far = vk.fill_launch_plan(allclass, 1, 20000, 3, 132)
    assert far["buckets"] == "global" and far["n_slots"] == 0
    assert far["smem"] == vk.fill_smem_bytes(20000, 3, allclass.S, 0,
                                             vk._n_toks(allclass), True)
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


# ------------------------------------------- the banded fill's card layout

def _big_ops(kind, dev=torch.device("cpu")):
    """(ev, ops) of the 64-state ACGT machine of align_banded (diag class
    only, S = 65) or of the prot2dna preset (up and left, S = 132)."""
    key = ("big", kind, str(dev))
    if key not in _cache:
        from machineboss_tpu_torch.core.presets import make_preset
        m = testmachines.build_random_transducer(64, list("ACGT"), seed=3) \
            if kind == "dense64" else make_preset("prot2dna")
        ev = EvaluatedMachine(m, m.get_param_defs(True))
        mats = tuple(np.asarray(x) for x in LoweredMachine(
            ev, dtype=np.float32).matrices_2d("maxplus"))
        _cache[key] = (ev, vk.viterbi_operands(vk.maxplus_class_mats(*mats),
                                               dev))
    return _cache[key]


def _band_of(Li, Lo, width, seed, dev=torch.device("cpu")):
    """A band of `width` cells about a wandering path, its base moving
    unevenly: the BandGeometry of Li x Lo."""
    rng = np.random.RandomState(seed)
    n = Li + Lo + 1
    d = np.arange(n)
    mid = np.round(d * Li / max(Li + Lo, 1) + rng.randint(-1, 2, n))
    lo = np.clip(mid - width // 2, np.maximum(0, d - Lo), np.minimum(Li, d))
    hi = np.minimum(np.minimum(lo + width, Li + 1), d + 1)
    return vk.band_geometry(Li, Lo, lo.astype(int), np.maximum(hi, lo + 1),
                            dev)


def test_banded_launch_plan():
    """align_banded's machine (16 diag blocks of 65 x 68, 283 KB): eight
    lanes an item, so eight blocks a cluster (the smallest whose 18 band
    cells x 3 column groups x 8 lanes fit 512 threads), the columns
    resident beside the slots. prot2dna (up and left, 1.67 MB of blocks):
    no portable cluster holds them, so streamed, at the smallest cluster
    whose band items fit one pass of the block. Forced layouts that do not
    fit raise."""
    _, d64 = _big_ops("dense64")
    geom = _band_of(1500, 1500, 18, 3)
    assert geom.Wb == 24
    cfg = vk.banded_launch_plan(d64, geom, 132)
    assert (cfg["cluster"], cfg["resident"], cfg["slots"], cfg["split"],
            cfg["groups_per_rank"]) == (8, True, True, 8, 3)
    assert cfg["smem"] == vk.banded_smem_bytes(d64, 24, 8, True, True)
    # the rank's columns: 16 tokens x 65 sources x 12 floats
    assert cfg["smem"] - vk.banded_smem_bytes(d64, 24, 8, False, True) \
        == 16 * 65 * 12 * 4
    # at four blocks the 5 groups of a rank are a row of 20 floats; at
    # sixteen, 2 groups padded to 3 (an odd count of 16-byte groups)
    assert vk.banded_smem_bytes(d64, 24, 4, True, True) \
        - vk.banded_smem_bytes(d64, 24, 4, False, True) == 16 * 65 * 20 * 4
    assert vk.banded_smem_bytes(d64, 24, 16, True, True) \
        - vk.banded_smem_bytes(d64, 24, 16, False, True) == 16 * 65 * 12 * 4
    # one lane an item: the smallest cluster that holds the columns
    one_lane = vk.banded_launch_plan(d64, geom, 132, split=1)
    assert (one_lane["cluster"], one_lane["resident"]) == (2, True)
    one = vk.banded_launch_plan(d64, geom, 132, cluster=1)
    assert not one["resident"]                 # 283 KB do not fit a block
    with pytest.raises(ValueError, match="does not fit"):
        vk.banded_launch_plan(d64, geom, 132, cluster=1, resident=True)
    assert vk.banded_launch_plan(d64, geom, 132, cluster=16)["resident"]
    _, p2d = _big_ops("prot2dna")
    assert p2d.classes == (True, True, False) and p2d.S == 132
    pgeom = _band_of(64, 192, 12, 4)
    cfg = vk.banded_launch_plan(p2d, pgeom, 132)
    assert not cfg["resident"] and cfg["slots"] and cfg["split"] == 8
    cells = int((pgeom.hi - pgeom.lo).max())
    assert cfg["cluster"] == min(c for c in (1, 2, 4, 8)
                                 if cells * -(-33 // c) * 8 <= 512)
    assert cfg["smem"] == vk.banded_smem_bytes(p2d, pgeom.Wb,
                                               cfg["cluster"], False, True)
    # an occupancy calculator that refuses a layout: passed over, or raised
    cfg = vk.banded_launch_plan(d64, geom, 132,
                                max_clusters=lambda c: int(c["cluster"] != 8))
    assert cfg["cluster"] == 4 and cfg["resident"]
    with pytest.raises(ValueError):
        vk.banded_launch_plan(d64, geom, 132, cluster=4,
                              max_clusters=lambda c: 0)
    for bad in ({"cluster": 3}, {"cluster": 32}, {"split": 3},
                {"split": 16}):
        with pytest.raises(ValueError):
            vk.banded_launch_plan(d64, geom, 132, **bad)
    # S = 5 pads to 2 column groups: at most 2 blocks a cluster, split 1
    small = _ops_of("allclass")
    sgeom = _band_of(6, 5, 3, 1)
    assert vk.banded_launch_plan(small, sgeom, 132)["split"] == 1
    with pytest.raises(ValueError):
        vk.banded_launch_plan(small, sgeom, 132, cluster=4)
    # a window too wide for three slots: read back from the lattice
    wide = vk.band_geometry(3400, 3, np.zeros(3404, int),
                            np.minimum(3400, np.arange(3404)) + 1,
                            torch.device("cpu"))
    assert not vk.banded_launch_plan(small, wide, 132)["slots"]


@pytest.mark.parametrize("csize", [1, 2, 3, 4, 8, 16])
@pytest.mark.parametrize("kind", ["dense64", "prot2dna", "allclass"])
def test_pack_banded_round_trip(kind, csize):
    """pack_banded's rank slices hold each rank's columns of every block,
    NEG_INF past them (an odd count of 4-column groups a row) and past SP,
    and unpack_banded gives the blocks back bit for bit."""
    ops = _ops_of("allclass") if kind == "allclass" else _big_ops(kind)[1]
    ops.packs.clear()
    packed = vk.pack_banded(ops, csize)
    own = 4 * -(-(ops.SP // 4) // csize)
    Wr = 4 * (-(-(ops.SP // 4) // csize) | 1)
    assert Wr // 4 % 2 == 1 and own <= Wr < own + 8
    n_blk = sum(t.numel() // ops.SP for t in (ops.up, ops.left, ops.diag)
                if t is not None)
    assert packed.shape == (n_blk * csize * Wr,) and packed.is_contiguous()
    back = vk.unpack_banded(packed, ops, csize)
    for a, b in zip(back, (ops.up, ops.left, ops.diag)):
        assert (a is None) == (b is None)
        if b is not None:
            assert torch.equal(a, b)
    first = next(t for t in (ops.up, ops.left, ops.diag) if t is not None)
    n_tok = first.shape[0]
    rank_last = packed[:csize * n_tok * ops.S * Wr].reshape(
        csize, n_tok, ops.S, Wr)[-1]
    cols = ops.SP - (csize - 1) * own
    if cols > 0:
        assert torch.equal(rank_last[:, :, :cols],
                           first[:, :, (csize - 1) * own:])
    assert (rank_last[:, :, max(cols, 0):] == -1e30).all()
    assert vk.pack_banded(ops, csize) is packed        # cached


def _banded_emulated(ops, geom, it, ot, csize, split, seed):
    """The banded fill as the kernel splits it, in torch: rank h of a
    cluster of `csize` computes its columns from its slice of pack_banded,
    each item's `split` lanes take every split-th source state, and the
    lanes' and the classes' maxima are combined in a shuffled order."""
    rng = np.random.RandomState(seed)
    Li, Lo, Wb, S, SP = geom.Li, geom.Lo, geom.Wb, ops.S, ops.SP
    own = 4 * -(-(SP // 4) // csize)
    Wr = 4 * (-(-(SP // 4) // csize) | 1)
    packed, at, cls = vk.pack_banded(ops, csize), 0, []
    for t in (ops.up, ops.left, ops.diag):
        if t is None:
            cls.append(None)
            continue
        n = csize * t.shape[0] * S * Wr
        cls.append(packed[at:at + n].reshape(csize, t.shape[0], S, Wr))
        at += n
    neg = torch.tensor(-1e30, dtype=torch.float32)
    w_idx = torch.arange(Wb)
    out = torch.full((Li + Lo + 1, Wb, S), -1e30, dtype=torch.float32)
    if geom.lo[0] <= 0 < geom.hi[0]:
        out[0, 0] = ops.c0

    def term(q, tok, ok, nbr):
        """(Wb, S) maxima of class q: per rank, per lane, then combined."""
        n_tok = cls[q].shape[1]
        ok = ok & (tok >= 0) & (tok < n_tok)
        tok = torch.clamp(tok, 0, n_tok - 1)
        parts = []
        for h in range(csize):
            blk = cls[q][h][tok]                             # (Wb, S, Wr)
            lanes = [(blk[:, j::split] + nbr[:, j::split, None])
                     .max(dim=1).values for j in range(split) if j < S]
            order = rng.permutation(len(lanes))
            acc = lanes[order[0]]
            for j in order[1:]:
                acc = torch.maximum(acc, lanes[j])
            parts.append(acc[:, :own])
        full = torch.cat(parts, dim=1)[:, :S]
        return torch.where(ok[:, None], full, neg)

    for d in range(1, Li + Lo + 1):
        base = int(geom.bases[d])
        i = base + w_idx
        o = d - i
        x = it[torch.clamp(i - 1, 0, max(Li - 1, 0))] if Li \
            else torch.zeros_like(i)
        y = ot[torch.clamp(o - 1, 0, max(Lo - 1, 0))] if Lo \
            else torch.zeros_like(i)

        def nb(slab, shift):
            src = w_idx + shift
            ok = (src >= 0) & (src < Wb)
            return ok, slab[torch.clamp(src, 0, Wb - 1)]
        s1 = base - int(geom.bases[d - 1])
        terms = []
        if ops.up is not None:
            ok, v = nb(out[d - 1], s1)
            terms.append(term(0, y, ok & (o >= 1), v))
        if ops.left is not None:
            ok, v = nb(out[d - 1], s1 - 1)
            terms.append(term(1, x, ok & (i >= 1), v))
        if ops.diag is not None and d >= 2:
            ok, v = nb(out[d - 2], base - int(geom.bases[d - 2]) - 1)
            ok = ok & (i >= 1) & (o >= 1) & (x >= 0) & (x < ops.Ti) \
                & (y >= 0) & (y < ops.To)
            terms.append(term(2, x * ops.To + y, ok, v))
        cur = torch.full((Wb, S), -1e30, dtype=torch.float32)
        for k in rng.permutation(len(terms)):
            cur = torch.maximum(cur, terms[k])
        band = (i >= int(geom.lo[d])) & (i < int(geom.hi[d])) & (i <= Li) \
            & (o >= 0) & (o <= Lo)
        out[d] = torch.where(band[:, None], cur, neg)
    return out


@pytest.mark.parametrize("csize,split", [(1, 1), (2, 4), (1, 8), (2, 2)])
@pytest.mark.parametrize("kind", ["allclass", "indel", "prot2dna"])
def test_banded_rank_and_lane_split_is_bit_equal(kind, csize, split):
    """The kernel's split of the work (destination columns by rank, source
    states by lane, maxima met in any order) gives the plain version's
    windows bit for bit, on every class combination: all three classes,
    up and left alone, and prot2dna's S = 132 (its column groups split
    over up to 16 ranks)."""
    if kind == "prot2dna":
        ev, ops = _big_ops("prot2dna")
        csize = {1: 3, 2: 16}[csize]
        Li, Lo = 5, 15
        rng = np.random.RandomState(2)
        it = rng.randint(0, ops.Ti, Li).astype(np.int32)
        ot = rng.randint(0, ops.To, Lo).astype(np.int32)
        geom = _band_of(Li, Lo, 5, 2)
    else:
        _, _, mats, its, ots = _case(kind)
        ops = _ops_of(kind)
        it, ot = its[0], ots[0]
        Li, Lo = len(it), len(ot)
        geom = _band_of(Li, Lo, 3, 5)
    t_it, t_ot = torch.from_numpy(it), torch.from_numpy(ot)
    ref = vk.viterbi_banded_forward_plain(ops, geom, t_it, t_ot)
    assert (ref > NEG).sum() > Li
    got = _banded_emulated(ops, geom, t_it, t_ot, csize, split, seed=csize)
    assert torch.equal(got, ref)


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
@pytest.mark.parametrize("banded,cluster", [(False, None), (True, None),
                                            (True, 2)])
def test_kernel_reads_the_lattice_back_when_shared_memory_is_short(banded,
                                                                   cluster):
    """A pair so long that three diagonals exceed a block's shared memory:
    both kernels then read the previous diagonals from the lattice (the
    banded fill with one block and with a cluster of two, whose blocks
    read each other's columns back)."""
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
        cfg = vk.banded_launch_plan(ops, geom, 132, cluster=cluster)
        assert not cfg["slots"]
        kern = vk.viterbi_banded_wavefront(ops, geom, t_it[0], t_ot[0],
                                           cluster=cluster)
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


def _band_pair(kind, dev):
    """(ops, geom, in_toks, out_toks) of a banded pair on `dev`: dense64, a
    pair of 120 with 10% redrawn in an envelope of width 8; prot2dna, a
    protein of 20 against its 60 bases in a band of 6; allclass, pair 0 of
    its case in a band of 3."""
    if kind == "dense64":
        ev, _ = _big_ops("dense64")
        ops = _big_ops("dense64", dev)[1]
        sp = testmachines.align_pair(120, mutate=0.1, seed=5)
        it = np.array(ev.input_tokenizer.tokenize(sp.input.seq),
                      np.int32) - 1
        ot = np.array(ev.output_tokenizer.tokenize(sp.output.seq),
                      np.int32) - 1
        geom = vk.band_geometry(len(it), len(ot),
                                *vk.envelope_diag_bands(Envelope(sp, width=8)),
                                dev)
    elif kind == "prot2dna":
        ev, _ = _big_ops("prot2dna")
        ops = _big_ops("prot2dna", dev)[1]
        (p, dna), = testmachines.prot2dna_pairs(1, 20, seed=3)
        it = np.array([ev.input_tokenizer.sym2tok[c] - 1 for c in p], np.int32)
        ot = np.array([ev.output_tokenizer.sym2tok[c] - 1 for c in dna],
                      np.int32)
        geom = _band_of(len(it), len(ot), 6, 3, dev)
    else:
        _, _, _, its, ots = _case("allclass")
        ops = _ops_of("allclass", dev)
        it, ot = its[0], ots[0]
        geom = _band_of(len(it), len(ot), 3, 5, dev)
    return (ops, geom, torch.from_numpy(it).to(dev),
            torch.from_numpy(ot).to(dev))


def _layouts(ops, geom, resident, split):
    """Every cluster size up to 16 that the plan allows for this residency
    and split, the card's occupancy calculator deciding."""
    out = []
    for c in (1, 2, 4, 8, 16):
        try:
            out.append(vk.banded_launch_plan(
                ops, geom, 132, cluster=c, resident=resident, split=split,
                max_clusters=lambda cfg: vk.banded_max_clusters_on_card(
                    ops, geom, cfg)))
        except ValueError:
            pass
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["dense64", "prot2dna"])
def test_banded_smem_bytes_on_card(kind):
    """The plan's shared bytes are the kernel's own, in the plan's layout
    and in every layout the card allows."""
    dev = _card()
    ops, geom, _, _ = _band_pair(kind, dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    cfg = vk.banded_launch_plan(ops, geom, sms)
    assert cfg["resident"] == (kind == "dense64")
    for c in [cfg] + _layouts(ops, geom, None, None):
        assert vk.banded_smem_bytes_on_card(ops, geom, c) == c["smem"]


@pytest.mark.cuda
@pytest.mark.parametrize("split", [1, 4, 8])
@pytest.mark.parametrize("resident", [True, False])
@pytest.mark.parametrize("kind", ["dense64", "prot2dna", "allclass"])
def test_banded_layouts_match_plain_on_card(kind, resident, split):
    """The banded fill equals its plain version bit for bit at every
    cluster size the plan allows up to 16, the class columns resident or
    streamed, one, four or eight lanes an item; one launch each."""
    dev = _card()
    ops, geom, t_it, t_ot = _band_pair(kind, dev)
    plain = vk.viterbi_banded_forward_plain(ops, geom, t_it, t_ot)
    layouts = _layouts(ops, geom, resident, split)
    assert layouts
    for cfg in layouts:
        before = vk.viterbi_banded_wavefront.launches
        kern = vk.viterbi_banded_wavefront(
            ops, geom, t_it, t_ot, cluster=cfg["cluster"], resident=resident,
            split=split)
        torch.cuda.synchronize()
        assert vk.viterbi_banded_wavefront.launches == before + 1
        assert torch.equal(kern, plain), cfg


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [{}, {"cluster": 1}, {"cluster": 2},
                                {"resident": False, "split": 2}])
def test_banded_bad_tokens_and_empty_sides_on_card(kw):
    """Tokens outside the alphabet match nothing, and a pair with an empty
    side fills its one row or column, in each layout."""
    dev = _card()
    ops, geom, t_it, t_ot = _band_pair("allclass", dev)
    bad_it, bad_ot = t_it.clone(), t_ot.clone()
    bad_it[2] = 9
    bad_ot[0] = -3
    kern = vk.viterbi_banded_wavefront(ops, geom, bad_it, bad_ot, **kw)
    assert torch.equal(kern, vk.viterbi_banded_forward_plain(
        ops, geom, bad_it, bad_ot))
    for li, lo in ((0, 4), (4, 0), (0, 0)):
        d = np.arange(li + lo + 1)
        g = vk.band_geometry(li, lo, np.maximum(0, d - lo),
                             np.minimum(li, d) + 1, dev)
        kern = vk.viterbi_banded_wavefront(ops, g, t_it[:li].contiguous(),
                                           t_ot[:lo].contiguous(), **kw)
        torch.cuda.synchronize()
        assert torch.equal(kern, vk.viterbi_banded_forward_plain(
            ops, g, t_it[:li], t_ot[:lo]))


@pytest.mark.cuda
@pytest.mark.parametrize("cluster", [1, 2])
@pytest.mark.parametrize("name", list(CASES))
def test_fill_global_buckets_match_shared_buckets_on_card(name, cluster):
    """The token buckets in each block's global buffer instead of shared
    memory: the same adds and maxes, so the lattice is the shared layout's
    bit for bit."""
    dev = _card()
    _, _, mats, it, ot = _case(name)
    ops = vk.viterbi_operands(vk.maxplus_class_mats(*mats), dev)
    batch = [torch.from_numpy(x).to(dev) for x in (it, ot)]
    want = vk.viterbi_wavefront(ops, *batch, cluster=cluster)
    got = vk.viterbi_wavefront(ops, *batch, cluster=cluster,
                               buckets="global")
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_fill_past_the_shared_buckets_matches_plain_on_card():
    """A pair of 4,000 x 3 on the all-class machine: its buckets (about 16
    words a cell) pass a block's shared memory, so the plan keeps them in
    global memory, and the lattice equals the plain version's."""
    dev = _card()
    mats = _case("allclass")[2]
    Li, Lo = 4000, 3
    ops = vk.viterbi_operands(vk.maxplus_class_mats(*mats), dev)
    assert vk.fill_smem_bytes(Li, Lo, ops.S, 0, vk._n_toks(ops)) > vk.SMEM_MAX
    cfg = vk.fill_launch_plan(ops, 1, Li, Lo, 132)
    assert cfg["buckets"] == "global" and cfg["smem"] <= vk.SMEM_MAX
    assert vk.fill_smem_bytes_on_card(ops, cfg, Li, Lo) == cfg["smem"]
    assert vk.fill_gbuck_bytes_on_card(ops, Li, Lo) == \
        vk.fill_gbuck_bytes(Li, Lo, vk._n_toks(ops))
    rng = np.random.RandomState(13)
    t_it = torch.zeros((1, Li), dtype=torch.int32, device=dev)
    t_ot = torch.from_numpy(
        rng.randint(0, 2, (1, Lo)).astype(np.int32)).to(dev)
    before = vk.viterbi_wavefront.launches
    kern = vk.viterbi_wavefront(ops, t_it, t_ot)
    torch.cuda.synchronize()
    assert vk.viterbi_wavefront.launches == before + 1
    assert torch.equal(kern, vk.viterbi_forward_plain(ops, t_it, t_ot))
    assert (kern[Li // 2] > NEG).any()


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["dense64", "prot2dna"])
def test_banded_unstaged_tokens_match_staged_on_card(kind):
    """The band's tokens read from global memory instead of staged with
    its bounds (read-back, the layout of a band past some 14,000 cells)
    against the default layout at a small band: the same adds and maxes,
    so the lattice is equal bit for bit."""
    dev = _card()
    ev, ops = _big_ops(kind, dev)
    Li, Lo = (300, 300) if kind == "dense64" else (64, 192)
    geom = _band_of(Li, Lo, 18, 5, dev)
    rng = np.random.RandomState(6)
    t_it = torch.from_numpy(rng.randint(0, ops.Ti, Li).astype(np.int32)
                            ).to(dev)
    t_ot = torch.from_numpy(rng.randint(0, ops.To, Lo).astype(np.int32)
                            ).to(dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    cfg = vk.banded_launch_plan(ops, geom, sms, staged=False)
    assert not cfg["staged"] and not cfg["slots"]
    assert vk.banded_smem_bytes_on_card(ops, geom, cfg) == cfg["smem"]
    want = vk.viterbi_banded_wavefront(ops, geom, t_it, t_ot)
    got = vk.viterbi_banded_wavefront(ops, geom, t_it, t_ot, staged=False)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_banded_past_the_staged_tokens_matches_plain_on_card():
    """A full band of 15,000 x 3 on the all-class machine: 15,001 cells
    a diagonal pass the band whose tokens a block can stage, so the plan
    reads them from global memory; the lattice equals the plain
    version's."""
    dev = _card()
    mats = _case("allclass")[2]
    ops = vk.viterbi_operands(vk.maxplus_class_mats(*mats), dev)
    Li, Lo = 15000, 3
    d = np.arange(Li + Lo + 1)
    geom = vk.band_geometry(Li, Lo, np.zeros_like(d), np.minimum(Li, d) + 1,
                            dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    cfg = vk.banded_launch_plan(ops, geom, sms)
    assert not cfg["staged"] and cfg["smem"] <= vk.SMEM_MAX
    rng = np.random.RandomState(14)
    t_it = torch.zeros(Li, dtype=torch.int32, device=dev)
    t_ot = torch.from_numpy(rng.randint(0, 2, Lo).astype(np.int32)).to(dev)
    before = vk.viterbi_banded_wavefront.launches
    kern = vk.viterbi_banded_wavefront(ops, geom, t_it, t_ot)
    torch.cuda.synchronize()
    assert vk.viterbi_banded_wavefront.launches == before + 1
    assert torch.equal(kern, vk.viterbi_banded_forward_plain(ops, geom, t_it,
                                                             t_ot))
    assert (kern[Li // 2] > NEG).any()
