"""The port's device lattice walk against the JAX package's.

The torch walk (lattice_walk_plain, the CPU path of lattice_walk) and the
JAX package's jitted walker get the SAME lattice (numpy, from the port's
plain fill, which equals the JAX kernel's bit for bit) and must return
identical records: n, the first n rows of ij and vals, and ok. Both are
float32 adds followed by a first-maximum argmax, so nothing is left to a
tolerance. The host functions copied verbatim are held bit-equal. On a CUDA
card the kernel is held to the plain walk exactly.

The JAX package is imported inside the tests that use it, so that the card
tests run where only torch is installed:
    python -m pytest --noconftest tests/test_torch_traceback.py -m cuda
"""

import json

import numpy as np
import pytest
import torch

from machineboss_tpu_torch import testmachines
from machineboss_tpu_torch.algo import traceback_device as tb
from machineboss_tpu_torch.core.eval import EvaluatedMachine
from machineboss_tpu_torch.core.machine import Machine
from machineboss_tpu_torch.core.seqpair import Envelope
from machineboss_tpu_torch.ops.kernels import viterbi_kernel as vk
from machineboss_tpu_torch.ops.lowering import LoweredMachine

# a silent chain of depth 2 (s -> t -> e) and a state no path leaves: the
# third pair below cannot be emitted
CHAIN = {"state": [
    {"id": "s", "trans": [
        {"in": "A", "out": "A", "to": "s", "weight": 0.5},
        {"in": "C", "to": "s", "weight": 0.2},
        {"out": "C", "to": "s", "weight": 0.1},
        {"to": "t", "weight": 0.3}]},
    {"id": "t", "trans": [{"to": "e", "weight": 0.7},
                          {"in": "A", "out": "C", "to": "t", "weight": 0.2}]},
    {"id": "e", "trans": []}]}

MACHINES = {
    "allclass": lambda: testmachines.build_allclass_transducer(5, list("AC")),
    "indel": lambda: testmachines.build_indel_transducer(5, list("AC"),
                                                         seed=21),
    "dense6": lambda: testmachines.build_random_transducer(6, list("ACGT"),
                                                           seed=2),
    "tiefree": testmachines.build_tiefree_machine,
    "chain": lambda: Machine.from_json(CHAIN),
}
_cache = {}


def _machine(name):
    if name not in _cache:
        m = MACHINES[name]()
        ev = EvaluatedMachine(m, m.get_param_defs(True))
        mats = tuple(np.asarray(x) for x in LoweredMachine(
            ev, dtype=np.float32).matrices_2d("maxplus"))
        _cache[name] = (m, ev, mats)
    return _cache[name]


def _jax_ev(name):
    from machineboss_tpu.core.eval import EvaluatedMachine as JEvaluated
    from machineboss_tpu.core.machine import Machine as JMachine
    jm = JMachine.from_json(json.loads(_machine(name)[0].to_json_str()))
    return JEvaluated(jm, jm.get_param_defs(True))


def _batch(name, seed=0, B=4, Li=6, Lo=5):
    """Ragged token lists, with an empty side and an empty pair."""
    _, _, mats = _machine(name)
    rng = np.random.RandomState(seed)
    n_in, n_out = mats[1].shape[0], mats[2].shape[0]
    lens = [(Li, Lo), (0, Lo), (3, 0), (0, 0), (Li, 2)][:B]
    if name == "chain":
        # all-A pairs align; the third would emit an A without reading
        # one: no path
        return ([np.zeros(3, np.int32), np.zeros(2, np.int32),
                 np.array([1], np.int32), np.zeros(0, np.int32)],
                [np.zeros(3, np.int32), np.zeros(2, np.int32),
                 np.array([0], np.int32), np.zeros(0, np.int32)])
    return ([rng.randint(0, n_in, a).astype(np.int32) for a, _ in lens],
            [rng.randint(0, n_out, b).astype(np.int32) for _, b in lens])


def _full_lattice(name, tok_in, tok_out, device="cpu"):
    """The plain (or, on the card, the kernel's) fill of a ragged batch:
    (diags tensor, Li, Lo)."""
    _, _, mats = _machine(name)
    B = len(tok_in)
    Li = max([len(t) for t in tok_in] + [1])
    Lo = max([len(t) for t in tok_out] + [1])
    it = np.zeros((B, Li), np.int32)
    ot = np.zeros((B, Lo), np.int32)
    for b in range(B):
        it[b, :len(tok_in[b])] = tok_in[b]
        ot[b, :len(tok_out[b])] = tok_out[b]
    fn = vk.make_wavefront_viterbi(*mats, B, Li, Lo, device=device)
    return fn(it, ot, [len(t) for t in tok_in],
              [len(t) for t in tok_out]), Li, Lo


def _same_records(ours, theirs):
    n, ij, vals, ok = ours
    jn, jij, jvals, jok = theirs
    assert (n, ok) == (jn, jok)
    assert np.array_equal(ij[:n], jij[:n])
    assert np.array_equal(vals[:n], jvals[:n])


# -------------------------------------------------------------- host copies

@pytest.mark.parametrize("name", list(MACHINES))
def test_edge_matrices_and_depth_bit_equal(name):
    from machineboss_tpu.algo.traceback_device import (
        maxplus_edge_matrices as j_edges, silent_chain_depth as j_depth)
    ev, jev = _machine(name)[1], _jax_ev(name)
    for a, b in zip(tb.maxplus_edge_matrices(ev), j_edges(jev)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert tb.silent_chain_depth(ev) == j_depth(jev)
    if name == "chain":
        assert tb.silent_chain_depth(ev) == 2


def test_sparse_cells_from_records_equal():
    from machineboss_tpu.algo.traceback_device import \
        sparse_cells_from_records as j_cells
    rng = np.random.RandomState(0)
    ij = np.array([[3, 2], [2, 1], [2, 0], [1, 0], [0, 0], [-1, -1]], np.int32)
    vals = rng.randn(6, 4, 3).astype(np.float32)
    ours = tb.sparse_cells_from_records(5, ij, vals)
    theirs = j_cells(5, ij, vals)
    assert sorted(ours) == sorted(theirs)
    for k in ours:
        assert ours[k].dtype == np.float64 and np.array_equal(ours[k],
                                                              theirs[k])
    assert (1, 1) in ours and (-1, 0) not in ours and (3, 2) in ours


# ------------------------------------------------------ the walk, full lattice

@pytest.mark.parametrize("name", list(MACHINES))
def test_walk_matches_jax_walker_on_full_lattice(name):
    from machineboss_tpu.algo.traceback_device import (
        make_lattice_walker as j_make, run_walker as j_run)
    ev = _machine(name)[1]
    tok_in, tok_out = _batch(name)
    diags, Li, Lo = _full_lattice(name, tok_in, tok_out)
    walker = tb.make_lattice_walker(ev, Li, Lo, device="cpu")
    assert walker.Ncap == Li + Lo + 2
    assert walker.max_steps == walker.Ncap * (1 + tb.silent_chain_depth(ev))
    zeros = np.zeros(Li + Lo + 1, np.int32)
    ours = tb.run_walker_batch(walker, diags, zeros, tok_in, tok_out)
    jwalk = j_make(_jax_ev(name), Li, Lo)
    lat = diags.numpy()
    n_ok = 0
    for b in range(len(tok_in)):
        li, lo = len(tok_in[b]), len(tok_out[b])
        theirs = j_run(jwalk, lat[:, b], zeros, tok_in[b], tok_out[b], li, lo)
        _same_records(ours[b], theirs)
        # the one-pair entry point gives the batch's records
        single = tb.run_walker(walker, diags[:, b], zeros, tok_in[b],
                               tok_out[b], li, lo)
        _same_records(single, ours[b])
        n_ok += ours[b][3]
        assert tuple(ours[b][1][0]) == (li, lo)
    assert n_ok >= 1
    if name == "chain":
        # the no-path pair: stuck at its first step, the final cell recorded
        n, _, vals, ok = ours[2]
        assert not ok and n == 1 and vals[0, 0, -1] <= -1e29
        assert [r[3] for r in ours] == [True, True, False, True]


def test_walk_records_serve_the_host_traceback():
    """The records' cells are exactly what the host traceback queries."""
    from machineboss_tpu_torch.algo.dp_host import ViterbiMatrix
    _, ev, _ = _machine("dense6")
    sp = testmachines.align_pair(12, seed=9)
    it0 = np.array(ev.input_tokenizer.tokenize(sp.input.seq), np.int32) - 1
    ot0 = np.array(ev.output_tokenizer.tokenize(sp.output.seq), np.int32) - 1
    diags, Li, Lo = _full_lattice("dense6", [it0], [ot0])
    walker = tb.make_lattice_walker(ev, Li, Lo, device="cpu")
    n, ij, vals, ok = tb.run_walker(walker, diags[:, 0],
                                    np.zeros(Li + Lo + 1, np.int32), it0, ot0,
                                    Li, Lo)
    assert ok and n == 12 and tuple(ij[n - 1]) == (1, 1)
    cells = tb.sparse_cells_from_records(n, ij, vals)
    host = ViterbiMatrix(ev, sp)
    for (i, o), v in cells.items():
        live = host.cell[i, o] > -1e29
        assert np.array_equal(v > -1e29, live)
        np.testing.assert_allclose(v[live], host.cell[i, o][live], rtol=0,
                                   atol=1e-4)


def test_run_walker_takes_the_jax_parameter_names():
    """run_walker's parameters are the JAX function's (the walker is
    `walk`), so a keyword call gives the positional call's records."""
    import inspect
    from machineboss_tpu.algo.traceback_device import run_walker as j_run
    assert list(inspect.signature(tb.run_walker).parameters) \
        == list(inspect.signature(j_run).parameters)
    _, ev, _ = _machine("dense6")
    tok_in, tok_out = _batch("dense6")
    diags, Li, Lo = _full_lattice("dense6", tok_in, tok_out)
    walker = tb.make_lattice_walker(ev, Li, Lo, device="cpu")
    zeros = np.zeros(Li + Lo + 1, np.int32)
    li, lo = len(tok_in[0]), len(tok_out[0])
    _same_records(
        tb.run_walker(walk=walker, lat=diags[:, 0], bases=zeros,
                      in_toks=tok_in[0], out_toks=tok_out[0], li=li, lo=lo),
        tb.run_walker(walker, diags[:, 0], zeros, tok_in[0], tok_out[0], li,
                      lo))


# ---------------------------------------------------- the walk, banded lattice

@pytest.mark.parametrize("seed", [1, 7])
def test_walk_matches_jax_walker_on_banded_lattice(seed):
    import jax.numpy as jnp
    from machineboss_tpu.algo.traceback_device import (
        make_lattice_walker as j_make, run_walker as j_run)
    _, ev, mats = _machine("dense6")
    sp = testmachines.align_pair(24, seed=seed)
    env = Envelope(sp, width=4)
    it0 = np.array(ev.input_tokenizer.tokenize(sp.input.seq), np.int32) - 1
    ot0 = np.array(ev.output_tokenizer.tokenize(sp.output.seq), np.int32) - 1
    lo, hi = vk.envelope_diag_bands(env)
    fill = vk.make_wavefront_viterbi_banded(*mats, 24, 24, lo, hi,
                                            device="cpu")
    raw = fill.fill_raw(it0, ot0)
    walker = tb.make_lattice_walker(ev, 24, 24, device="cpu")
    ours = tb.run_walker(walker, raw, fill.bases, it0, ot0, 24, 24)
    theirs = j_run(j_make(_jax_ev("dense6"), 24, 24), jnp.asarray(raw.numpy()),
                   fill.bases, it0, ot0, 24, 24)
    _same_records(ours, theirs)
    assert ours[3] and ours[0] == 24     # (0, 0) ships as a neighbour


# ------------------------------------------------- the kernel's host tables

@pytest.mark.parametrize("name", list(MACHINES))
def test_edge_rows_hold_every_destination_row(name):
    """The kernel's one edge table: ad's rows (tx, ty, dst), al's (tx, dst),
    au's (ty, dst), sil's dst, each the incoming weights of dst from every
    source, padded with NEG_INF to a multiple of 4 floats, then a row of
    NEG_INF for the cells outside a lattice."""
    ev = _machine(name)[1]
    ad, al, au, sil = tb.maxplus_edge_matrices(ev)
    rows = tb.edge_rows(ad, al, au, sil)
    Ti, To, S = ad.shape[0], ad.shape[1], sil.shape[0]
    n = (Ti * To + Ti + To + 1) * S
    assert rows.shape == (n + 1, (S + 3) // 4 * 4) and \
        rows.dtype == np.float32
    assert (rows[:, S:] == tb.NEG_INF).all() and \
        (rows[n] == tb.NEG_INF).all()
    at = 0
    for m in (ad, al, au, sil):
        dst_major = np.swapaxes(m, -1, -2).reshape(-1, S)
        assert np.array_equal(rows[at:at + len(dst_major), :S], dst_major)
        at += len(dst_major)
    assert at == n
    walker = tb.make_lattice_walker(ev, 3, 4, device="cpu")
    assert np.array_equal(walker.rows.numpy(), rows)


# (S, Ti, To, n_diags, Lip, Lop, B, SMs) -> (pairs a block, blocks, the
# bases and tokens in shared memory, shared bytes)
# (shared floats: the bases rounded to 4, per pair the tokens rounded to 4)
@pytest.mark.parametrize("shape,expect", [
    ((65, 4, 4, 257, 128, 128, 64, 132), (1, 64, True, 2064)),
    ((65, 4, 4, 3001, 1500, 1500, 1, 132), (1, 1, True, 24016)),  # banded
    ((132, 20, 4, 257, 64, 192, 64, 132), (1, 64, True, 2064)),
    ((65, 4, 4, 257, 128, 128, 1000, 132), (8, 125, True, 9232)),
    # six pairs of 4,000 x 4,000 stage, not eight
    ((65, 4, 4, 8001, 4000, 4000, 1000, 132), (6, 167, True, 224016)),
    # long banded pairs: nothing staged
    ((65, 4, 4, 40001, 20000, 20000, 1, 132), (1, 1, False, 0)),
    ((65, 4, 4, 60001, 30000, 30000, 1, 132), (1, 1, False, 0)),
    ((6, 4, 4, 200001, 100000, 100000, 2, 132), (1, 2, False, 0)),
])
def test_walk_launch_plan(shape, expect):
    S, Ti, To, nd, Lip, Lop, B, n_sm = shape
    plan = tb.walk_launch_plan(S, Ti, To, nd, Lip, Lop, B, n_sm)
    assert (plan["pairs"], plan["blocks"], plan["staged"],
            plan["smem"]) == expect
    assert plan["smem"] == tb.walk_smem_bytes(
        S, Ti, To, nd, Lip, Lop, plan["pairs"], plan["staged"])
    assert plan["blocks"] * plan["pairs"] >= B > \
        (plan["blocks"] - 1) * plan["pairs"]


@pytest.mark.parametrize("L", [1500, 20000, 30000, 100000])
def test_walk_launch_plan_takes_every_length(L):
    """The default walk has a layout for a banded pair of any length (two
    30 kb sequences have 60,001 diagonals): nothing a pair's length sets
    has to fit in shared memory. The variants stage the bases (and all
    but tokens_global the tokens) and raise where those do not fit."""
    plan = tb.walk_launch_plan(65, 4, 4, 2 * L + 1, L, L, 1, 132)
    assert plan["smem"] <= 227 * 1024
    assert plan["staged"] == (L == 1500)
    for variant in ("block_barrier", "tokens_global", "prefetch"):
        # the bases alone of 40,001 diagonals fit
        if L == 1500 or (L == 20000 and variant == "tokens_global"):
            assert tb.walk_launch_plan(65, 4, 4, 2 * L + 1, L, L, 1, 132,
                                       variant=variant)["staged"]
            continue
        with pytest.raises(ValueError, match="shared memory"):
            tb.walk_launch_plan(65, 4, 4, 2 * L + 1, L, L, 1, 132,
                                variant=variant)


def test_walk_launch_plan_variants_and_limits():
    # 3 pairs a block over 4 pairs: a last block holding one
    plan = tb.walk_launch_plan(6, 2, 2, 12, 6, 5, 4, 132, pairs=3)
    assert (plan["pairs"], plan["blocks"]) == (3, 2)
    # tokens from global memory: the bases alone are staged
    assert tb.walk_launch_plan(65, 4, 4, 257, 128, 128, 64, 132,
                               variant="tokens_global")["smem"] == 4 * 260
    # the left, up and silent rows in shared memory: 9 * 65 * 68 floats
    edges = tb.walk_launch_plan(65, 4, 4, 257, 128, 128, 64, 132,
                                variant="edges_shared")
    assert edges["smem"] == 4 * (9 * 65 * 68) + 2064
    # only the prefetch variant keeps its ring of 9 cells a pair
    ring = tb.walk_launch_plan(65, 4, 4, 257, 128, 128, 64, 132,
                               variant="prefetch")
    assert ring["smem"] == 4 * 9 * 68 + 2064
    with pytest.raises(ValueError, match="shared memory"):
        tb.walk_launch_plan(132, 20, 4, 257, 64, 192, 64, 132,
                            variant="edges_shared")
    with pytest.raises(ValueError, match="pairs a block"):
        tb.walk_launch_plan(65, 4, 4, 257, 128, 128, 64, 132, pairs=9)
    with pytest.raises(ValueError, match="variant"):
        tb.walk_launch_plan(65, 4, 4, 257, 128, 128, 64, 132,
                            variant="block")


def test_cpu_wrapper_takes_plain_without_launch():
    ev = _machine("allclass")[1]
    tok_in, tok_out = _batch("allclass")
    diags, Li, Lo = _full_lattice("allclass", tok_in, tok_out)
    walker = tb.make_lattice_walker(ev, Li, Lo, device="cpu")
    before = tb.lattice_walk.launches
    tb.run_walker_batch(walker, diags, np.zeros(Li + Lo + 1, np.int32),
                        tok_in, tok_out)
    assert tb.lattice_walk.launches == before


# ------------------------------------------------------------------- the card

def _card_records_equal(walker, lat, wargs, plain, **kw):
    """The kernel's records at layout `kw` equal the plain walk's, bit for
    bit, n, ij, vals and ok, unwritten slots included."""
    got = tb.lattice_walk(walker, lat, *wargs, **kw)
    for a, b in zip(got, plain):
        assert torch.equal(a.cpu(), b.cpu()), kw
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(MACHINES) + ["dense64", "prot2dna"])
def test_walk_kernel_every_layout_matches_plain_on_card(name):
    """Every variant and blocks of 1, 3 and 8 pairs (4 and 5 pairs: a last
    block part full), on the small machines, the 64-state ACGT machine (S
    = 65, three values a lane) and the prot2dna preset (S = 132, float4
    rows), and with the walk cut at Ncap and at max_steps."""
    import dataclasses
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    if name == "dense64":
        m = testmachines.build_random_transducer(64, list("ACGT"), seed=3)
    elif name == "prot2dna":
        from machineboss_tpu_torch.core.presets import make_preset
        m = make_preset("prot2dna")
    if name in ("dense64", "prot2dna"):
        ev = EvaluatedMachine(m, m.get_param_defs(True))
        mats = tuple(np.asarray(x) for x in LoweredMachine(
            ev, dtype=np.float32).matrices_2d("maxplus"))
        _cache[name] = (m, ev, mats)
        rng = np.random.RandomState(3)
        n_in, n_out = mats[1].shape[0], mats[2].shape[0]
        lens = [(7, 21), (5, 15), (0, 6), (6, 0), (3, 9)]
        tok_in = [rng.randint(0, n_in, a).astype(np.int32) for a, _ in lens]
        tok_out = [rng.randint(0, n_out, b).astype(np.int32)
                   for _, b in lens]
    else:
        ev = _machine(name)[1]
        tok_in, tok_out = _batch(name)
    diags, Li, Lo = _full_lattice(name, tok_in, tok_out, device="cuda")
    walker = tb.make_lattice_walker(ev, Li, Lo)
    wargs = tb.walk_tensors(walker, np.zeros(Li + Lo + 1, np.int32), tok_in,
                            tok_out)
    plain = tb.lattice_walk_plain(walker, diags, *wargs)
    for variant in tb.WALK_VARIANTS:
        try:
            _card_records_equal(walker, diags, wargs, plain, variant=variant)
        except ValueError as err:            # edges_shared at S = 132
            assert variant == "edges_shared" and "shared memory" in str(err)
    for pairs in (1, 3, 8):
        _card_records_equal(walker, diags, wargs, plain, pairs=pairs)
    for cut in (dict(Ncap=3), dict(max_steps=2)):
        short = dataclasses.replace(walker, plans={}, **cut)
        want = tb.lattice_walk_plain(short, diags, *wargs)
        assert not want[3].all()              # the cut stops some pair
        _card_records_equal(short, diags, wargs, want)


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(MACHINES))
def test_walk_kernel_matches_plain_on_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    ev = _machine(name)[1]
    tok_in, tok_out = _batch(name)
    diags, Li, Lo = _full_lattice(name, tok_in, tok_out, device="cuda")
    zeros = np.zeros(Li + Lo + 1, np.int32)
    before = tb.lattice_walk.launches
    kern = tb.run_walker_batch(tb.make_lattice_walker(ev, Li, Lo), diags,
                               zeros, tok_in, tok_out)
    assert tb.lattice_walk.launches == before + 1     # all pairs, one launch
    plain = tb.run_walker_batch(
        tb.make_lattice_walker(ev, Li, Lo, device="cpu"), diags.cpu(), zeros,
        tok_in, tok_out)
    for a, b in zip(kern, plain):
        _same_records(a, b)
        # beyond the n records nothing was written
        assert np.array_equal(a[1][a[0]:], b[1][b[0]:])


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [1, 7])
def test_banded_walk_kernel_matches_plain_on_card(seed):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    _, ev, mats = _machine("dense6")
    sp = testmachines.align_pair(24, seed=seed)
    env = Envelope(sp, width=4)
    it0 = np.array(ev.input_tokenizer.tokenize(sp.input.seq), np.int32) - 1
    ot0 = np.array(ev.output_tokenizer.tokenize(sp.output.seq), np.int32) - 1
    lo, hi = vk.envelope_diag_bands(env)
    fill = vk.make_wavefront_viterbi_banded(*mats, 24, 24, lo, hi)
    raw = fill.fill_raw(it0, ot0)
    kern = tb.run_walker(tb.make_lattice_walker(ev, 24, 24), raw, fill.bases,
                         it0, ot0, 24, 24)
    plain = tb.run_walker(tb.make_lattice_walker(ev, 24, 24, device="cpu"),
                          raw.cpu(), fill.bases, it0, ot0, 24, 24)
    _same_records(kern, plain)
    assert kern[3]


@pytest.mark.cuda
def test_long_banded_walk_kernel_matches_plain_on_card():
    """The banded alignment of two 30,000-token sequences (60,001
    diagonals): the default walk takes it, with the bases and tokens read
    from global memory, walks it to (0, 0), and its records equal the plain
    walk's bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    _, ev, mats = _machine("dense6")
    L = 30000
    sp = testmachines.align_pair(L, seed=7)
    env = Envelope(sp, width=8)
    it0 = np.array(ev.input_tokenizer.tokenize(sp.input.seq), np.int32) - 1
    ot0 = np.array(ev.output_tokenizer.tokenize(sp.output.seq), np.int32) - 1
    lo, hi = vk.envelope_diag_bands(env)
    fill = vk.make_wavefront_viterbi_banded(*mats, L, L, lo, hi)
    raw = fill.fill_raw(it0, ot0)
    walker = tb.make_lattice_walker(ev, L, L)
    nd = raw.shape[0]
    assert nd == 2 * L + 1
    plan = tb.walk_launch_plan(walker.S, walker.Ti, walker.To, nd, L, L, 1,
                               132)
    assert not plan["staged"]
    before = tb.lattice_walk.launches
    kern = tb.run_walker(walker, raw, fill.bases, it0, ot0, L, L)
    assert tb.lattice_walk.launches == before + 1
    plain = tb.run_walker(tb.make_lattice_walker(ev, L, L, device="cpu"),
                          raw.cpu(), fill.bases, it0, ot0, L, L)
    _same_records(kern, plain)
    assert np.array_equal(kern[1], plain[1]) and \
        np.array_equal(kern[2], plain[2])
    assert kern[3] and kern[0] == L      # the diagonal, cell by cell
