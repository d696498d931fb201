"""The port's sparse COO engine (ops/sparse.py) against the JAX package's.

The same machine and tokens go through both: the segment reductions, the
COO classes, the silent closure against the JAX engine's silent layers,
and Forward, Backward and Viterbi in 1D and 2D, held to the JAX engine at
1e-4 nats and to the float64 host engine at 0.01 nats; impossible pairs
impossible in both (<= -1e29). The JAX engine compiles one program a call,
unrolled over every cell, so its pairs stay at most 4 x 5. The card tests
(marker cuda) hold the card's float32 walk to the same calls on the CPU
in float64 at 1e-3 nats; this file imports the JAX package only inside its
JAX tests.
"""

import json

import numpy as np
import pytest
import torch

from machineboss_tpu_torch import testmachines
from machineboss_tpu_torch.algo.dp_host import ForwardMatrix, ViterbiMatrix
from machineboss_tpu_torch.core.eval import EvaluatedMachine
from machineboss_tpu_torch.core.hmmer import HmmerModel
from machineboss_tpu_torch.core.presets import make_preset
from machineboss_tpu_torch.core.seqpair import NamedSeq, SeqPair
from machineboss_tpu_torch.ops import sparse

JAX_BOUND = 1e-4          # nats: the port's walk against the JAX engine
HOST_BOUND = 0.01         # nats: the f64 host engine (the contract)
FB_BOUND = 1e-3           # nats: Backward total against Forward
CARD_BOUND = 1e-3         # nats: card float32 against CPU float64
NEG = -1e29
_cache = {}


def _plan7(K):
    h = HmmerModel()
    h.read(testmachines.random_plan7_hmm_text(K, testmachines.AMINO, 0))
    return h.machine(False)


MACHINES = {
    "indel": lambda: testmachines.build_indel_transducer(6, list("ACGT")),
    "prot2dna": lambda: make_preset("prot2dna"),
    "allclass": lambda: testmachines.build_allclass_transducer(5,
                                                               list("AC")),
    "plan7": lambda: _plan7(8),
}


def _ev(name):
    """(port EvaluatedMachine, JAX EvaluatedMachine) of one machine."""
    if ("ev", name) not in _cache:
        m = MACHINES[name]()
        ev = EvaluatedMachine(m, m.get_param_defs(True))
        _cache[("ev", name)] = ev
    return _cache[("ev", name)]


def _jev(name):
    from machineboss_tpu.core.eval import EvaluatedMachine as JEvaluated
    from machineboss_tpu.core.machine import Machine as JMachine
    if ("jev", name) not in _cache:
        jm = JMachine.from_json(json.loads(_ev(name).machine.to_json_str()))
        _cache[("jev", name)] = JEvaluated(jm, jm.get_param_defs(True))
    return _cache[("jev", name)]


def _sm(name, dtype=np.float32, device="cpu"):
    key = ("sm", name, np.dtype(dtype).name, device)
    if key not in _cache:
        _cache[key] = sparse.SparseMachine(_ev(name), dtype=dtype,
                                           device=device)
    return _cache[key]


def _jsm(name):
    from machineboss_tpu.ops import sparse as jsparse
    if ("jsm", name) not in _cache:
        _cache[("jsm", name)] = jsparse.SparseMachine(_jev(name))
    return _cache[("jsm", name)]


def _close(port, ref, bound):
    port = np.asarray(port, np.float64)
    ref = np.asarray(ref, np.float64)
    assert port.shape == ref.shape
    assert np.array_equal(port <= NEG / 2, ref <= NEG / 2), (port, ref)
    live = ref > NEG / 2
    if live.any():
        assert np.abs(port[live] - ref[live]).max() <= bound, (port, ref)


def _pair_toks(name, a, b):
    ev = _ev(name)
    return ([ev.input_tokenizer.sym2tok[c] for c in a],
            [ev.output_tokenizer.sym2tok[c] for c in b])


def _host(name, a, b, viterbi=False):
    cls = ViterbiMatrix if viterbi else ForwardMatrix
    return max(cls(_ev(name), SeqPair(NamedSeq("i", list(a)),
                                      NamedSeq("o", list(b)))).log_like(),
               -1e30)


@pytest.mark.parametrize("op", ["segment_max", "segment_logsumexp"])
def test_segment_reductions_match_jax(op):
    """Empty segments included: segment_max gives -inf there, as
    jax.ops.segment_max does; segment_logsumexp gives NEG_INF."""
    import jax.numpy as jnp
    from machineboss_tpu.ops import sparse as jsparse
    rng = np.random.RandomState(4)
    values = rng.normal(0, 30, 200).astype(np.float32)
    values[:20] = -1e30
    ids = rng.randint(0, 40, 200)
    ids[ids == 7] = 8                      # segment 7 stays empty
    got = getattr(sparse, op)(torch.from_numpy(values),
                              torch.from_numpy(ids), 41).numpy()
    ref = np.asarray(getattr(jsparse, op)(jnp.array(values),
                                          jnp.array(ids, jnp.int32), 41))
    assert np.array_equal(np.isneginf(got), np.isneginf(ref))
    fin = np.isfinite(ref)
    np.testing.assert_allclose(got[fin], ref[fin], rtol=0, atol=1e-5)


@pytest.mark.parametrize("name", list(MACHINES))
def test_classes_equal_jax(name):
    sm, jsm = _sm(name), _jsm(name)
    assert sorted(sm.classes) == sorted(jsm.classes)
    for key, (src, dst, lw) in sm.classes.items():
        js, jd, jw = (np.asarray(x) for x in jsm.classes[key])
        assert np.array_equal(src, js) and np.array_equal(dst, jd)
        assert np.array_equal(lw, jw)


@pytest.mark.parametrize("viterbi", [False, True])
@pytest.mark.parametrize("name", ["plan7", "prot2dna"])
def test_closure_equals_the_silent_layers(name, viterbi):
    """The closure applied in one reduction equals the JAX engine's layer
    by layer propagation, forward and reverse, on random cells."""
    import jax.numpy as jnp
    from machineboss_tpu.ops import sparse as jsparse
    sm, jsm = _sm(name), _jsm(name)
    S = sm.n_states
    rng = np.random.RandomState(5)
    cells = rng.normal(-20, 10, (3, S)).astype(np.float32)
    cells[:, rng.rand(S) < 0.3] = -1e30
    got = sm.apply_silent(torch.from_numpy(cells), viterbi).numpy()
    rev = sparse.SparseMachineRev(sm).apply_silent(
        torch.from_numpy(cells), viterbi).numpy()
    jrev = jsparse.SparseMachineRev(jsm)
    for b in range(3):
        c = jnp.array(cells[b])
        ref = jsparse._apply_silent_vit(jsm, c) if viterbi \
            else jsm.apply_silent(c)
        _close(got[b], ref, 1e-5)
        _close(rev[b], jrev.apply_silent(c, viterbi), 1e-5)


@pytest.mark.parametrize("viterbi", [False, True])
def test_class_contrib_matches_jax(viterbi):
    import jax.numpy as jnp
    from machineboss_tpu.ops import sparse as jsparse
    sm, jsm = _sm("prot2dna"), _jsm("prot2dna")
    cell = np.random.RandomState(6).normal(-5, 3, sm.n_states) \
        .astype(np.float32)
    for key in [(1, 1), (3, 0), (0, 2), (0, 0), (30, 30)]:
        got = sm.class_contrib(torch.from_numpy(cell), key, viterbi)
        ref = jsparse._class_contrib(jsm, jnp.array(cell), key, viterbi)
        _close(got.numpy(), ref, 1e-5)
        got = sparse.SparseMachineRev(sm).class_contrib(
            torch.from_numpy(cell), key, viterbi)
        ref = jsparse.SparseMachineRev(jsm).class_contrib(
            jnp.array(cell), key, viterbi)
        _close(got.numpy(), ref, 1e-5)


PAIRS_2D = {"indel": [("ACGT", "TTGCA"), ("", "ACG"), ("GA", "")],
            "prot2dna": [("MK", "ATGAAA"), ("W", "TGGTTA"), ("M", "")],
            "allclass": [("ACCA", "CAAC"), ("C", "")]}


def _jax_2d(name, a, b):
    """The JAX engine's Forward, Backward and Viterbi of one pair
    (computed once a run)."""
    from machineboss_tpu.ops import sparse as jsparse
    key = ("j2d", name, a, b)
    if key not in _cache:
        jsm = _jsm(name)
        it, ot = _pair_toks(name, a, b)
        _cache[key] = (jsparse.forward_2d_sparse(jsm, it, ot),
                       jsparse.backward_2d_sparse(jsm, it, ot),
                       jsparse.viterbi_2d_sparse(jsm, it, ot))
    return _cache[key]


@pytest.mark.parametrize("name", list(PAIRS_2D))
def test_2d_forward_backward_viterbi_match_jax_and_host(name):
    sm = _sm(name)
    for a, b in PAIRS_2D[name]:
        it, ot = _pair_toks(name, a, b)
        got = (sparse.forward_2d_sparse(sm, it, ot),
               sparse.backward_2d_sparse(sm, it, ot),
               sparse.viterbi_2d_sparse(sm, it, ot))
        assert all(isinstance(x, float) for x in got)
        _close(got, _jax_2d(name, a, b), JAX_BOUND)
        host_f, host_v = _host(name, a, b), _host(name, a, b, True)
        _close(got, [host_f, host_f, host_v], HOST_BOUND)
        _close([got[1]], [got[0]], FB_BOUND)
        assert got[2] <= got[0] + 1e-5


def test_impossible_tokens_and_pairs():
    """A token outside the alphabet takes no class (the JAX engine's
    dictionary misses it); a pair no path explains scores <= -1e29."""
    sm = _sm("prot2dna")
    it, ot = _pair_toks("prot2dna", "M", "ATG")
    assert sparse.forward_2d_sparse(sm, it, ot + [99]) <= NEG
    assert sparse.backward_2d_sparse(sm, [99] + it, ot) <= NEG
    _close([sparse.forward_2d_sparse(sm, it, [])],
           [_host("prot2dna", "M", "")], HOST_BOUND)


SEQ_1D = "MKVLAW"


@pytest.mark.parametrize("viterbi", [False, True])
def test_1d_forms_match_jax_and_host(viterbi):
    """forward_1d_sparse and backward_1d_sparse on a seeded 8-node Plan7
    generator (its silent delete chain included)."""
    from machineboss_tpu.ops import sparse as jsparse
    sm, jsm = _sm("plan7"), _jsm("plan7")
    _, toks = _pair_toks("plan7", "", SEQ_1D)
    got = [sparse.forward_1d_sparse(sm, toks, viterbi=viterbi),
           sparse.backward_1d_sparse(sm, toks, viterbi=viterbi)]
    ref = [jsparse.forward_1d_sparse(jsm, toks, viterbi=viterbi),
           jsparse.backward_1d_sparse(jsm, toks, viterbi=viterbi)]
    _close(got, ref, JAX_BOUND)
    _close(got, [_host("plan7", "", SEQ_1D, viterbi)] * 2, HOST_BOUND)


def test_1d_recognizer_side_matches_jax():
    from machineboss_tpu.ops import sparse as jsparse
    js = {"state": [
        {"id": "S", "trans": [{"in": "A", "to": "S", "weight": 0.5},
                              {"in": "C", "to": "T", "weight": 0.3},
                              {"to": "E", "weight": 0.2}]},
        {"id": "T", "trans": [{"in": "A", "to": "S", "weight": 0.6},
                              {"in": "C", "to": "T", "weight": 0.1},
                              {"to": "E", "weight": 0.3}]},
        {"id": "E", "trans": []}]}
    from machineboss_tpu.core.eval import EvaluatedMachine as JEvaluated
    from machineboss_tpu.core.machine import Machine as JMachine
    from machineboss_tpu_torch.core.machine import Machine
    m, jm = Machine.from_json(js), JMachine.from_json(js)
    ev = EvaluatedMachine(m, m.get_param_defs(True))
    sm = sparse.SparseMachine(ev, device="cpu")
    jsm = jsparse.SparseMachine(JEvaluated(jm, jm.get_param_defs(True)))
    toks = [ev.input_tokenizer.sym2tok[c] for c in "ACCA"]
    for viterbi in (False, True):
        _close([sparse.forward_1d_sparse(sm, toks, False, viterbi),
                sparse.backward_1d_sparse(sm, toks, False, viterbi)],
               [jsparse.forward_1d_sparse(jsm, toks, False, viterbi)] * 2,
               JAX_BOUND)


def test_fn3_shaped_profile_matches_host():
    """The 86-node profile of fn3's shape (87 silent layers), Forward and
    Viterbi in 1D against the float64 host engine: no JAX (its unrolled
    program is too large to compile here)."""
    h = HmmerModel()
    h.read(testmachines.fn3_shaped_hmm_text())
    gen = h.machine(False)
    ev = EvaluatedMachine(gen, gen.get_param_defs(True))
    sm = sparse.SparseMachine(ev, device="cpu")
    seq = "ACDEFGHIK"
    toks = [ev.output_tokenizer.sym2tok[c] for c in seq]
    sp = SeqPair(NamedSeq("i", []), NamedSeq("o", list(seq)))
    host_f = ForwardMatrix(ev, sp).log_like()
    host_v = ViterbiMatrix(ev, sp).log_like()
    _close([sparse.forward_1d_sparse(sm, toks),
            sparse.backward_1d_sparse(sm, toks),
            sparse.forward_2d_sparse(sm, [], toks)], [host_f] * 3,
           HOST_BOUND)
    _close([sparse.forward_1d_sparse(sm, toks, viterbi=True),
            sparse.backward_1d_sparse(sm, toks, viterbi=True)], [host_v] * 2,
           HOST_BOUND)


def test_sparse_machine_needs_the_card_without_cuda():
    if torch.cuda.is_available():
        assert sparse.SparseMachine(_ev("indel")).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            sparse.SparseMachine(_ev("indel"))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["prot2dna", "plan7"])
def test_walk_on_card_matches_cpu_f64(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    card = _sm(name, device="cuda")
    cpu = _sm(name, dtype=np.float64)
    pairs = [("MKW", "ATGAAATGG"), ("", "ACG")] if name == "prot2dna" \
        else [("", "MKVLAWCC")]
    for a, b in pairs:
        it, ot = _pair_toks(name, a, b)
        for fn in (sparse.forward_2d_sparse, sparse.backward_2d_sparse,
                   sparse.viterbi_2d_sparse):
            _close([fn(card, it, ot)], [fn(cpu, it, ot)], CARD_BOUND)
        if not a:
            for viterbi in (False, True):
                for fn in (sparse.forward_1d_sparse,
                           sparse.backward_1d_sparse):
                    _close([fn(card, ot, viterbi=viterbi)],
                           [fn(cpu, ot, viterbi=viterbi)], CARD_BOUND)
