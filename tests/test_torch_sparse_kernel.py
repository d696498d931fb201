"""The sparse walk's kernel (ops/kernels/sparse_kernel.py,
csrc/sparse_walk.cu) against the eager walk and the JAX engine.

On the CPU the kernel's walk in plain PyTorch (`sparse_walk_diagonal`, on
the kernel's tables, in its stage order) is held to the port's eager walk
(bit-equal in max-plus, 1e-5 nats in logsumexp), to the JAX engine at
1e-4 nats and to the float64 host engine at 0.01 nats, on the machines of
tests/test_torch_sparse.py (indel, prot2dna, allclass, an 8-node Plan7
generator), in Forward, Backward and Viterbi, 2D and 1D, and on a float64
machine; impossible tokens and pairs stay impossible; the launch plan
takes every size below the card's memory, and a batch of many long pairs
(a global ring a cluster launched); a non-dense CompiledMachine's
batch equals its pair-by-pair scores. The JAX engine compiles one program
a call, unrolled over every cell, so its pairs stay at most 4 x 5. The
card tests (marker cuda) hold the kernel to the eager walk on the card
(1e-3 nats logsumexp, 0.0 max-plus), to the twin, to one launch a call, on
a ragged batch bit-equal to per-pair calls (also a batch whose rings, one
a pair, would not fit the card), on a float64 machine, and in every
cluster and ring layout. This file imports the JAX package only
inside its JAX tests.
"""

import numpy as np
import pytest
import torch

from machineboss_tpu_torch import testmachines
from machineboss_tpu_torch.core.presets import make_preset
from machineboss_tpu_torch.dispatch import CompiledMachine
from machineboss_tpu_torch.ops import sparse
from machineboss_tpu_torch.ops.kernels import sparse_kernel as sk
from one_thread import one_torch_thread  # noqa: F401
from test_torch_sparse import (HOST_BOUND, JAX_BOUND, NEG, PAIRS_2D, SEQ_1D,
                               _close, _host, _jax_2d, _jsm, _pair_toks, _sm)

EAGER_BOUND = 1e-5        # nats: the twin against the eager walk
CARD_BOUND = 1e-3         # nats: the kernel against the eager walk on the card
CARD_BYTES = 80 * 10 ** 9

# the token call forms: (name, viterbi, reverse)
FORMS = [("forward", False, False), ("backward", False, True),
         ("viterbi", True, True), ("forward_viterbi", True, False)]


def _batch(name, pairs):
    toks = [_pair_toks(name, a, b) for a, b in pairs]
    it, il = sk.pad_tokens([t[0] for t in toks])
    ot, ol = sk.pad_tokens([t[1] for t in toks])
    return it, ot, il, ol


def _twin(sm, batch, viterbi, reverse):
    return sk.sparse_walk_diagonal(sk.sparse_tables(sm, reverse, viterbi),
                                   *batch).numpy()


def _eager(sm, batch, viterbi, reverse):
    it, ot, il, ol = batch
    return np.array([sparse._token_walk(sm, it[b, :il[b]], ot[b, :ol[b]],
                                        viterbi, reverse)
                     for b in range(len(il))])


def _equal(port, ref):
    """Bit-equal on the live scores, the same impossible ones."""
    port, ref = np.asarray(port), np.asarray(ref)
    assert np.array_equal(port <= NEG / 2, ref <= NEG / 2), (port, ref)
    live = ref > NEG / 2
    assert np.array_equal(port[live], ref[live]), (port, ref)


@pytest.mark.parametrize("name", list(PAIRS_2D))
def test_twin_matches_eager_walk_jax_and_host_2d(name):
    """Every 2D call form on a batch of the machine's pairs: the twin
    against the eager walk, the float64 host engine and (on the first
    pair, one JAX compile a form) the JAX engine."""
    sm = _sm(name)
    pairs = PAIRS_2D[name]
    batch = _batch(name, pairs)
    host_f = [_host(name, a, b) for a, b in pairs]
    host_v = [_host(name, a, b, True) for a, b in pairs]
    jf, jb, jv = _jax_2d(name, *pairs[0])
    for form, viterbi, reverse in FORMS:
        got = _twin(sm, batch, viterbi, reverse)
        eager = _eager(sm, batch, viterbi, reverse)
        if viterbi:
            _equal(got, eager)
        else:
            _close(got, eager, EAGER_BOUND)
        _close(got, host_v if viterbi else host_f, HOST_BOUND)
        ref = {"forward": jf, "backward": jb, "viterbi": jv}.get(form)
        if ref is not None:
            _close(got[:1], [ref], JAX_BOUND)


@pytest.mark.parametrize("viterbi", [False, True])
def test_twin_1d_matches_eager_walk_jax_and_host(viterbi):
    """forward_1d_sparse's and backward_1d_sparse's walks on the 8-node
    Plan7 generator (its silent delete chain in the closure)."""
    from machineboss_tpu.ops import sparse as jsparse
    sm, jsm = _sm("plan7"), _jsm("plan7")
    batch = _batch("plan7", [("", SEQ_1D), ("", SEQ_1D[:2]), ("", "")])
    _, toks = _pair_toks("plan7", "", SEQ_1D)
    ref = [jsparse.forward_1d_sparse(jsm, toks, viterbi=viterbi),
           jsparse.backward_1d_sparse(jsm, toks, viterbi=viterbi)]
    host = [_host("plan7", "", s, viterbi) for s in (SEQ_1D, SEQ_1D[:2], "")]
    for reverse in (False, True):
        got = _twin(sm, batch, viterbi, reverse)
        eager = _eager(sm, batch, viterbi, reverse)
        if viterbi:
            _equal(got, eager)
        else:
            _close(got, eager, EAGER_BOUND)
        _close(got, host, HOST_BOUND)
        _close(got[:1], [ref[int(reverse)]], JAX_BOUND)


@pytest.mark.parametrize("name", ["prot2dna", "plan7"])
def test_twin_float64_machine(name):
    """A float64 machine's tables are float64: the twin equals the eager
    float64 walk and the host engine."""
    sm = _sm(name, np.float64)
    pairs = PAIRS_2D.get(name, [("", SEQ_1D), ("", "MK")])
    batch = _batch(name, pairs)
    for form, viterbi, reverse in FORMS:
        t = sk.sparse_tables(sm, reverse, viterbi)
        assert t.weights.dtype == torch.float64
        got = _twin(sm, batch, viterbi, reverse)
        eager = _eager(sm, batch, viterbi, reverse)
        if viterbi:
            _equal(got, eager)
        else:
            _close(got, eager, 1e-12)
        _close(got, [_host(name, a, b, viterbi) for a, b in pairs],
               HOST_BOUND)


def test_impossible_tokens_and_pairs():
    """A token outside the alphabet takes the empty class, in both
    directions; a pair no path explains is impossible in the twin and the
    eager walk alike."""
    sm = _sm("prot2dna")
    it, ot = _pair_toks("prot2dna", "M", "ATG")
    seqs = [(it, ot + [99]), ([99] + it, ot), ([-3] + it, ot), (it, ot),
            (it, ot[:2])]
    tin, il = sk.pad_tokens([s[0] for s in seqs])
    tout, ol = sk.pad_tokens([s[1] for s in seqs])
    for form, viterbi, reverse in FORMS:
        got = _twin(sm, (tin, tout, il, ol), viterbi, reverse)
        eager = _eager(sm, (tin, tout, il, ol), viterbi, reverse)
        assert (got[[0, 1, 2, 4]] <= NEG).all()
        assert got[3] > NEG
        _close(got, eager, EAGER_BOUND)


def test_tables_hold_every_edge_once():
    """The CSR lists hold every emitting edge under its class and scatter
    state, with the class's weight, and the closure's edge set; kept in
    the machine's cache."""
    sm = _sm("prot2dna")
    for reverse in (False, True):
        t = sk.sparse_tables(sm, reverse, False)
        assert sk.sparse_tables(sm, reverse, False) is t
        ints = t.ints.numpy().astype(np.int64)
        w = t.weights.numpy()
        eoff = ints[:t.o_coff]
        got = set()
        for c in range(t.n_cls):
            for s in range(t.S):
                for e in range(eoff[c * t.S + s], eoff[c * t.S + s + 1]):
                    got.add((c, s, int(ints[t.o_eidx + e]), float(w[e])))
        want = set()
        for k, (src, dst, lw) in sm.classes.items():
            if k == (0, 0):
                continue
            c = int(sm.class_index[k])
            for a, b, x in zip(src, dst, lw):
                s, g = (a, b) if reverse else (b, a)
                want.add((c, int(s), int(g), float(x)))
        assert got == want
        assert t.o_cidx - t.o_eidx == t.o_cw
        csrc, _, _ = sm.closure(False)
        assert ints.shape[0] - t.o_cidx == csrc.numel()
        assert (np.asarray(sm.class_index).reshape(-1)
                == ints[t.o_cls:t.o_eidx]).all()


def _sizes(S, emit=2, closure=3, n_cls=25, n_io=105):
    """ListSizes of S states, each with `emit` emitting entries over its
    classes and `closure` closure entries."""
    return sk.ListSizes(S=S, n_cls=n_cls, n_io=n_io,
                        state_emit=np.full(S, emit, np.int64),
                        state_closure=np.full(S, closure, np.int64),
                        emit_row=1.0, closure_row=float(closure),
                        cell_terms=3.0 * emit * S / (n_cls - 1)
                        + closure * S)


def test_launch_plan_takes_every_size_below_the_card():
    """Past shared memory the 2D ring and the tables go global and the plan
    never refuses below 80 GB; a 2D shared ring is a cluster a pair, a
    global ring one a cluster launched, never more clusters than the card
    holds; a side left empty takes the 1D form, whose state ranges cover
    the states once; every layout's shared bytes fit a block."""
    for S, elt in ((132, 4), (644, 4), (2564, 4), (132, 8), (2564, 8)):
        for L in (0, 1, 64, 300, 5000, 100000):
            for B in (1, 4, 132, 1024):
                for closure in (1, 53, 206):
                    lists = _sizes(S, closure=closure)
                    cfg = sk.sparse_launch_plan(S, L, 3 * L, B, lists, elt,
                                                mem_bytes=CARD_BYTES)
                    W = L + 1
                    assert cfg["W"] == W
                    assert cfg["form"] == ("1d" if L == 0 else "2d")
                    assert cfg["smem_bytes"] <= sk.SMEM_MAX
                    assert cfg["smem_bytes"] == sk.sparse_smem_bytes(cfg)
                    assert B * cfg["cluster"] <= max(sk.SMS, B)
                    assert 1 <= cfg["grid"] <= B
                    if cfg["form"] == "1d":
                        b = cfg["bounds"]
                        assert len(b) == cfg["cluster"] + 1
                        assert b[0] == 0 and b[-1] == S
                        assert all(x < y for x, y in zip(b, b[1:]))
                        assert cfg["tables"] in ("slice", "global")
                    else:
                        assert cfg["ncb"] * cfg["cluster"] >= W
                        assert cfg["tables"] in ("shared", "global")
                        if cfg["rows"] == "shared":
                            assert cfg["grid"] == B
                        else:
                            assert cfg["grid"] * cfg["cluster"] <= sk.SMS
                    assert cfg["mem_bytes"] <= CARD_BYTES
    p2d = _sizes(132, emit=2, closure=1)
    one_d = sk.sparse_launch_plan(2564, 0, 512, 1, _sizes(2564, 1, 206, 22,
                                                          21))
    assert one_d["cluster"] == 16 and one_d["form"] == "1d"
    assert one_d["grid"] == 1
    four = sk.sparse_launch_plan(132, 64, 192, 4, p2d)
    assert four["cluster"] == 16 and four["rows"] == "shared"
    assert four["tables"] == "shared" and four["ncb"] == 5
    full = sk.sparse_launch_plan(132, 64, 192, 132, p2d)
    assert full["cluster"] == 1 and full["rows"] == "shared"
    assert full["grid"] == 132
    tiny = sk.sparse_launch_plan(132, 3, 9, 1, p2d)
    assert tiny["cluster"] == 1 and tiny["rows"] == "shared"
    lanes = sk.sparse_launch_plan(644, 0, 128, 1, sk.ListSizes(
        S=644, n_cls=21, n_io=21, state_emit=np.ones(644, np.int64),
        state_closure=np.full(644, 53, np.int64), emit_row=1.0,
        closure_row=52.9, cell_terms=34000.0))
    assert (lanes["lanes_emit"], lanes["lanes_closure"]) == (1, 32)
    # refused: past the 32-bit indices, and one ring past the memory given
    with pytest.raises(ValueError):
        sk.sparse_launch_plan(2564, 10 ** 6, 10 ** 6, 64, _sizes(2564),
                              mem_bytes=CARD_BYTES)
    with pytest.raises(ValueError):
        sk.sparse_launch_plan(132, 10 ** 6, 3 * 10 ** 6, 1, p2d,
                              mem_bytes=10 ** 9)


def test_launch_plan_takes_many_long_pairs():
    """A batch of 10,000 pairs of 300 x 900 over the 512-node generator's
    2,564 states: a ring a pair would be 123 GB; the plan launches the
    clusters the card holds, one global ring and workspace each, and
    fewer where the memory given holds fewer."""
    S, Li, Lo, B = 2564, 300, 900, 10000
    lists = _sizes(S)
    scratch = (3 * (Li + 1) + sk.WARPS) * S * 4
    assert B * 3 * (Li + 1) * S * 4 > CARD_BYTES
    cfg = sk.sparse_launch_plan(S, Li, Lo, B, lists, mem_bytes=CARD_BYTES)
    assert (cfg["rows"], cfg["cluster"], cfg["grid"]) == ("global", 1,
                                                           sk.SMS)
    fixed = B * 4 + B * (2 + Li + Lo) * 4
    assert cfg["mem_bytes"] == fixed + sk.SMS * scratch
    few = sk.sparse_launch_plan(S, Li, Lo, B, lists,
                                mem_bytes=fixed + 5 * scratch + 7)
    assert few["grid"] == 5 and few["mem_bytes"] == fixed + 5 * scratch
    assert sk.sparse_launch_plan(S, Li, Lo, B, lists,
                                 mem_bytes=fixed + scratch)["grid"] == 1
    with pytest.raises(ValueError):
        sk.sparse_launch_plan(S, Li, Lo, B, lists,
                              mem_bytes=fixed + scratch - 1)


def test_lanes_follow_the_list_lengths():
    assert [sk._lanes(x) for x in (0, 1, 1.5, 2, 7, 53, 206, 1000)] == \
        [1, 1, 1, 2, 4, 32, 32, 32]


def test_cpu_batch_equals_its_pairs():
    """A non-dense CompiledMachine on the CPU: log_forward_batch's one
    sparse_walk call gives what log_forward gives pair by pair, with no
    launch counted."""
    cm = CompiledMachine(make_preset("prot2dna"), device="cpu",
                         dense_max_states=16)
    pairs = [("MK", "ATGAAA"), ("W", "TGGTTA"), ("M", ""), ("", ""),
             ("MKW", "ATGAAATGG")]
    before = sk.sparse_walk.launches
    got = cm.log_forward_batch(pairs)
    assert cm.last_route == "sparse"
    assert sk.sparse_walk.launches == before
    want = np.array([cm.log_forward(i, o) for i, o in pairs])
    assert got.dtype == np.float64 and np.array_equal(got, want)
    assert cm.log_forward_batch([]).shape == (0,)


def test_public_forms_on_cpu_take_the_eager_walk():
    sm = _sm("indel")
    it, ot = _pair_toks("indel", "ACGT", "TTGCA")
    before = sk.sparse_walk.launches
    assert sparse.forward_2d_sparse(sm, it, ot) == \
        sparse._token_walk(sm, it, ot, False, False)
    assert sparse.viterbi_2d_sparse(sm, it, ot) == \
        sparse._token_walk(sm, it, ot, True, True)
    assert sk.sparse_walk.launches == before


# ------------------------------------------------------------- the card

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _on_card(sm, batch, viterbi, reverse, **kw):
    before = sk.sparse_walk.launches
    got = sk.sparse_walk(sm, *batch, viterbi, reverse, **kw)
    torch.cuda.synchronize()
    assert sk.sparse_walk.launches == before + 1
    return got.cpu().numpy()


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(PAIRS_2D) + ["plan7"])
def test_kernel_matches_eager_walk_and_twin_on_card(name):
    _card()
    card = _sm(name, device="cuda")
    pairs = PAIRS_2D.get(name, [("", SEQ_1D), ("", "MK"), ("", "")])
    batch = _batch(name, pairs)
    for form, viterbi, reverse in FORMS:
        got = _on_card(card, batch, viterbi, reverse)
        eager = _eager(card, batch, viterbi, reverse)
        twin = sk.sparse_walk_diagonal(
            sk.sparse_tables(card, reverse, viterbi), *batch).cpu().numpy()
        if viterbi:
            _equal(got, eager)
            _equal(got, twin)
        else:
            _close(got, eager, CARD_BOUND)
            _close(got, twin, CARD_BOUND)


@pytest.mark.cuda
def test_public_forms_launch_once_on_card():
    _card()
    sm = _sm("plan7", device="cuda")
    cpu = _sm("plan7", np.float64)
    _, toks = _pair_toks("plan7", "", SEQ_1D)
    for fn, kw in ((sparse.forward_1d_sparse, {}),
                   (sparse.backward_1d_sparse, {}),
                   (sparse.forward_1d_sparse, {"viterbi": True}),
                   (sparse.backward_1d_sparse, {"viterbi": True})):
        before = sk.sparse_walk.launches
        got = fn(sm, toks, **kw)
        assert sk.sparse_walk.launches == before + 1
        _close([got], [fn(cpu, toks, **kw)], CARD_BOUND)
    sm = _sm("prot2dna", device="cuda")
    it, ot = _pair_toks("prot2dna", "MKW", "ATGAAATGG")
    for fn in (sparse.forward_2d_sparse, sparse.backward_2d_sparse,
               sparse.viterbi_2d_sparse):
        before = sk.sparse_walk.launches
        fn(sm, it, ot)
        assert sk.sparse_walk.launches == before + 1


@pytest.mark.cuda
def test_ragged_batch_equals_its_pairs_on_card():
    """A ragged batch (lengths 0 to 40, a bad token) in one launch equals
    each pair's own launch bit for bit (a pair with an empty side alone
    takes the 1D form), in every layout the plan or a forced cluster or
    ring gives; with the global ring at 8 and 16 blocks a pair the 20
    pairs are more than the clusters launched, so a cluster walks
    several."""
    _card()
    sm = _sm("prot2dna", device="cuda")
    pairs = testmachines.prot2dna_pairs(
        18, [1, 5, 13, 2, 9, 13, 4, 7, 11, 3, 6, 12, 8, 10, 1, 2, 13, 5],
        seed=3)
    pairs += [("", ""), ("M", "")]
    batch = _batch("prot2dna", pairs)
    batch[0][0, 0] = 99
    for form, viterbi, reverse in FORMS:
        whole = _on_card(sm, batch, viterbi, reverse)
        one = np.concatenate([_on_card(sm, tuple(x[b:b + 1] for x in batch),
                                       viterbi, reverse)
                              for b in range(len(pairs))])
        _equal(whole, one)
        for kw in ({"cluster": 2}, {"cluster": 4}, {"rows": "global"},
                   {"cluster": 8}, {"cluster": 16},
                   {"cluster": 8, "rows": "global"},
                   {"cluster": 16, "rows": "global"}):
            _equal(_on_card(sm, batch, viterbi, reverse, **kw), whole)
            if "rows" in kw and kw.get("cluster", 1) >= 8:
                assert sk.sparse_walk.last["plan"]["grid"] < len(pairs)


@pytest.mark.cuda
def test_batch_past_a_ring_a_pair_on_card():
    """2,500 pairs padded to 10,000 aa x 30,000 nt on a float64 machine: a
    ring a pair would take 106 GB, past the card. One launch walks them on
    the clusters the card holds (each pair in turn), bit-equal to each
    pair's own launch. The two long pairs have one empty side (10,001 and
    30,001 one-cell diagonals); two real pairs have live scores."""
    _card()
    sm = _sm("prot2dna", np.float64, device="cuda")
    rng = np.random.default_rng(11)
    pairs = [("".join(rng.choice(sorted(testmachines.CODONS), 10000)), ""),
             ("", "".join(rng.choice(list("ACGT"), 30000)))]
    pairs += testmachines.prot2dna_pairs(2, 12, seed=4)
    pairs += [("", "")] * (2500 - len(pairs))
    batch = _batch("prot2dna", pairs)
    ring = 4 * 10001 * sm.n_states * 8
    assert len(pairs) * ring > torch.cuda.get_device_properties(0) \
        .total_memory
    whole = _on_card(sm, batch, False, False)
    plan = sk.sparse_walk.last["plan"]
    assert plan["rows"] == "global" and plan["grid"] < len(pairs)
    one = np.concatenate([_on_card(sm, tuple(x[b:b + 1] for x in batch),
                                   False, False)
                          for b in range(len(pairs))])
    _equal(whole, one)
    assert (whole[2:4] > NEG / 2).all()


@pytest.mark.cuda
def test_kernel_runs_on_the_callers_stream():
    """A launch on a side stream takes that stream's handle: the same
    scores as on the default stream, ready once the side stream is."""
    _card()
    sm = _sm("prot2dna", device="cuda")
    batch = _batch("prot2dna", PAIRS_2D["prot2dna"])
    want = _on_card(sm, batch, False, False)
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        got = sk.sparse_walk(sm, *batch)
    side.synchronize()
    _equal(got.cpu().numpy(), want)


@pytest.mark.cuda
def test_float64_machine_on_card():
    _card()
    sm = _sm("prot2dna", np.float64, device="cuda")
    cpu = _sm("prot2dna", np.float64)
    batch = _batch("prot2dna", PAIRS_2D["prot2dna"])
    for form, viterbi, reverse in FORMS:
        got = _on_card(sm, batch, viterbi, reverse)
        assert sk.sparse_walk.last["plan"]["rows"] in ("shared", "global")
        _close(got, _eager(cpu, batch, viterbi, reverse), 1e-9)


@pytest.mark.cuda
def test_batch_route_is_one_launch_on_card():
    _card()
    cm = CompiledMachine(make_preset("prot2dna"), dense_max_states=16)
    cpu = CompiledMachine(make_preset("prot2dna"), device="cpu",
                          dense_max_states=16)
    pairs = testmachines.prot2dna_pairs(4, 12, seed=0)
    before = sk.sparse_walk.launches
    got = cm.log_forward_batch(pairs)
    assert sk.sparse_walk.launches == before + 1
    assert cm.last_route == "sparse"
    _equal(got, [cm.log_forward(i, o) for i, o in pairs])
    _close(got, cpu.log_forward_batch(pairs), CARD_BOUND)


def _dense_sm(S=48, alph="ACGT", seed=5):
    """A machine whose every state has an edge to every state in every
    class (S^2 entries a class: 448 KB of tables at S=48, past a block's
    shared memory), on the card."""
    from machineboss_tpu_torch.core.eval import EvaluatedMachine
    from machineboss_tpu_torch.core.machine import Machine
    rng = np.random.RandomState(seed)
    kinds = ([{"in": a, "out": b} for a in alph for b in alph]
             + [{"in": a} for a in alph] + [{"out": b} for b in alph])
    states = [{"id": "s%d" % s, "trans": [
        dict(k, to=t, weight=float(rng.uniform(0.001, 0.01)))
        for k in kinds for t in range(S)] + [{"to": S, "weight": 0.01}]}
        for s in range(S)] + [{"id": "end", "trans": []}]
    m = Machine.from_json({"state": states})
    ev = EvaluatedMachine(m, m.get_param_defs(True))
    return sparse.SparseMachine(ev, device="cuda"), ev


@pytest.mark.cuda
def test_each_table_layout_on_card():
    """The kernel against the eager walk and its twin on the card in each
    table layout the plan picks by size: prot2dna's pairs, every table in
    every block ("shared"); the 8-node Plan7 generator's reads, a block's
    states' lists ("slice"); a dense 48-state machine's pairs, its 448 KB
    of tables read through L1/L2 ("global"), 16 lanes a state's emitting
    terms; each layout's shared bytes the kernel's own count."""
    _card()
    dense, ev = _dense_sm()
    dpairs = [("ACGTTA", "CGTAGCA"), ("GGA", "T"), ("", "AC")]
    it, il = sk.pad_tokens([[ev.input_tokenizer.sym2tok[c] for c in a]
                            for a, _ in dpairs])
    ot, ol = sk.pad_tokens([[ev.output_tokenizer.sym2tok[c] for c in b]
                            for _, b in dpairs])
    cases = [(_sm("prot2dna", device="cuda"), _batch(
        "prot2dna", PAIRS_2D["prot2dna"] + [("MKW", "ATGAAATGG")]),
        "shared"),
        (_sm("plan7", device="cuda"), _batch(
            "plan7", [("", SEQ_1D), ("", "MK"), ("", "")]), "slice"),
        (dense, (it, ot, il, ol), "global")]
    for sm, batch, tables in cases:
        for form, viterbi, reverse in FORMS:
            got = _on_card(sm, batch, viterbi, reverse)
            cfg = sk.sparse_walk.last["plan"]
            assert cfg["tables"] == tables, cfg
            assert sk.sparse_smem_bytes_on_card(cfg) == cfg["smem_bytes"]
            eager = _eager(sm, batch, viterbi, reverse)
            twin = sk.sparse_walk_diagonal(sk.sparse_tables(
                sm, reverse, viterbi), *batch).cpu().numpy()
            if viterbi:
                _equal(got, eager)
                _equal(got, twin)
            else:
                _close(got, eager, CARD_BOUND)
                _close(got, twin, CARD_BOUND)


@pytest.mark.cuda
def test_short_pairs_and_bad_tokens_at_range_edges_on_card():
    """Pairs shorter than a cluster's ranges (blocks that own no position)
    and a token outside the alphabet at a range's first position: along
    the input (9 x 11 at 4 blocks: ranges of 3, x[2] consumed into
    position 3) and along the output where it is the shorter side (13 x 9:
    y[2]); the kernel against the eager walk, each batch bit-equal to its
    pairs' own launches (a pair with an empty side alone: the 1D form)."""
    _card()
    sm = _sm("indel", device="cuda")
    short = [("AC", "G"), ("A", "CGTACG"), ("", "A"), ("G", "")]
    for pairs, side in (([("ACGTTGCAA", "TTGCAACGGTA")] + short, 0),
                        ([("ACGTTGCAAGTCA", "TTGCAACGG")] + short, 1)):
        batch = _batch("indel", pairs)
        batch[side][0, 2] = 99 if side == 0 else -4
        for form, viterbi, reverse in FORMS:
            for cluster in (4, 16):
                got = _on_card(sm, batch, viterbi, reverse, cluster=cluster)
                assert sk.sparse_walk.last["plan"]["swap"] == bool(side)
                eager = _eager(sm, batch, viterbi, reverse)
                if viterbi:
                    _equal(got, eager)
                else:
                    _close(got, eager, CARD_BOUND)
                one = np.concatenate([_on_card(
                    sm, tuple(x[b:b + 1] for x in batch), viterbi, reverse,
                    cluster=cluster) for b in range(len(pairs))])
                _equal(got, one)


@pytest.mark.cuda
@pytest.mark.parametrize("viterbi", [False, True])
def test_wide_generator_read_on_card(viterbi):
    """The 512-node Plan7 generator's read of 512 (2,564 states, 529,416
    closure entries: the 1D form on 16 blocks, its lists streamed) against
    the eager walk on the card."""
    _card()
    from machineboss_tpu_torch.core.eval import EvaluatedMachine
    from machineboss_tpu_torch.core.hmmer import HmmerModel
    hmm = HmmerModel()
    hmm.read(testmachines.random_plan7_hmm_text(512, testmachines.AMINO, 0))
    m = hmm.machine(False)
    ev = EvaluatedMachine(m, m.get_param_defs(True))
    sm = sparse.SparseMachine(ev, device="cuda")
    read = testmachines.plan7_reads(testmachines.AMINO, 1, 512, seed=1)[0]
    toks = [ev.output_tokenizer.sym2tok[c] for c in read]
    batch = (np.zeros((1, 0), np.int64), np.array([toks]), [0], [512])
    got = _on_card(sm, batch, viterbi, False)
    cfg = sk.sparse_walk.last["plan"]
    assert (cfg["form"], cfg["cluster"], cfg["tables"]) == ("1d", 16,
                                                            "global")
    eager = _eager(sm, batch, viterbi, False)
    if viterbi:
        _equal(got, eager)
    else:
        _close(got, eager, CARD_BOUND)
