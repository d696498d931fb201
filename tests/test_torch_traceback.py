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
