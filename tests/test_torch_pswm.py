"""The port's PSWM engines (ops/pswm.py, the PSWM forms of ops/sparse.py)
and alignment-constrained DP (ops/dp_aligned.py) against the JAX
package's.

Dirichlet profiles from a numpy seed. Every function is held to its JAX
twin at 1e-4 nats in both semirings where it takes one; the invariants
are the JAX package's own bounds (tests/test_sparse.py): a one-hot profile
equals the token engine at 1e-4, Backward equals Forward and the sparse
forms equal the dense engine at 1e-3, Viterbi <= Forward. The aligned
Forward is <= the full Forward and the f64 host engine bounds the token
engines at 0.01. The card tests (marker cuda) hold the card's float32
calls to the same calls on the CPU in float64 at 1e-3 nats; this file
imports the JAX package only inside its JAX tests.
"""

import json

import numpy as np
import pytest
import torch

from machineboss_tpu_torch import testmachines
from machineboss_tpu_torch.core.eval import EvaluatedMachine
from machineboss_tpu_torch.ops import dp2d, dp_aligned, pswm, sparse
from machineboss_tpu_torch.ops.lowering import LoweredMachine
from machineboss_tpu_torch.ops.semiring import LOGSUMEXP, MAXPLUS
from one_thread import one_torch_thread  # noqa: F401

JAX_BOUND = 1e-4
FB_BOUND = 1e-3
CARD_BOUND = 1e-3
NEG = -1e29
SEMIRINGS = {"logsumexp": LOGSUMEXP, "maxplus": MAXPLUS}
_cache = {}


def _jsr(name):
    from machineboss_tpu.ops import semiring
    return semiring.LOGSUMEXP if name == "logsumexp" else semiring.MAXPLUS


def _allclass():
    """(ev, lowered) of the all-class transducer over AC."""
    if "ac" not in _cache:
        m = testmachines.build_allclass_transducer(5, list("AC"))
        ev = EvaluatedMachine(m, m.get_param_defs(True))
        _cache["ac"] = (ev, LoweredMachine(ev, dtype=np.float32))
    return _cache["ac"]


def _profile(L, T, seed):
    w = np.random.RandomState(seed).dirichlet(np.ones(T + 1), size=L)
    return np.log(w).astype(np.float32)


def _emit_1d(sr_name):
    """A generator's (n_tok, S, S) emissions (closure not folded) and its
    closure."""
    key = ("1d", sr_name)
    if key not in _cache:
        m = testmachines.build_generator_1d(6, seed=5)
        lm = LoweredMachine(EvaluatedMachine(m, m.get_param_defs(True)))
        _cache[key] = (np.ascontiguousarray(lm.log_trans[0, 1:]),
                       np.asarray(lm.closure_for(sr_name)))
    return _cache[key]


def _close(port, ref, bound):
    port = np.asarray(port, np.float64)
    ref = np.maximum(np.asarray(ref, np.float64), -1e30)
    assert port.shape == ref.shape
    assert np.array_equal(port <= NEG / 2, ref <= NEG / 2), (port, ref)
    live = ref > NEG / 2
    if live.any():
        assert np.abs(port[live] - ref[live]).max() <= bound, (port, ref)


def test_pswm_from_tokens_matches_jax():
    import jax.numpy as jnp
    from machineboss_tpu.ops import pswm as jp
    toks = np.array([2, 0, 1, 3, 3])
    got = pswm.pswm_from_tokens(torch.from_numpy(toks), 4)
    assert np.array_equal(got.numpy(),
                          np.asarray(jp.pswm_from_tokens(jnp.array(toks), 4)))


@pytest.mark.parametrize("sr_name", list(SEMIRINGS))
def test_1d_pswm_matches_jax(sr_name):
    """The transfer matrices, Forward and Backward over a profile with
    padding past its length."""
    import jax.numpy as jnp
    from machineboss_tpu.ops import pswm as jp
    emit, closure = _emit_1d(sr_name)
    prof = _profile(12, emit.shape[0], 3)
    sr, jsr = SEMIRINGS[sr_name], _jsr(sr_name)
    t = [torch.from_numpy(x) for x in (emit, closure, prof)]
    j = [jnp.array(x) for x in (emit, closure, prof)]
    _close(pswm.pswm_transfer_matrices(*t, sr=sr).numpy(),
           jp.pswm_transfer_matrices(*j, sr=jsr), JAX_BOUND)
    for fn in ("forward_1d_pswm", "backward_1d_pswm"):
        got = float(getattr(pswm, fn)(*t, 9, sr=sr))
        _close([got], [float(getattr(jp, fn)(*j, 9, sr=jsr))], JAX_BOUND)
    _close([float(pswm.backward_1d_pswm(*t, 9, sr=sr))],
           [float(pswm.forward_1d_pswm(*t, 9, sr=sr))], FB_BOUND)


@pytest.mark.parametrize("sr_name", list(SEMIRINGS))
def test_2d_pswm_matches_jax(sr_name):
    import jax.numpy as jnp
    from machineboss_tpu.ops import pswm as jp
    _, lm = _allclass()
    mats = [np.asarray(x) for x in lm.matrices_2d(sr_name)]
    ip, op = _profile(4, 2, 11), _profile(5, 2, 12)
    sr, jsr = SEMIRINGS[sr_name], _jsr(sr_name)
    t = [torch.from_numpy(x) for x in mats + [ip, op]]
    j = [jnp.array(x) for x in mats + [ip, op]]
    for fn in ("forward_2d_pswm", "backward_2d_pswm"):
        got = float(getattr(pswm, fn)(*t, 4, 5, sr=sr))
        _close([got], [float(getattr(jp, fn)(*j, 4, 5, sr=jsr))], JAX_BOUND)
    _close([float(pswm.backward_2d_pswm(*t, 4, 5, sr=sr))],
           [float(pswm.forward_2d_pswm(*t, 4, 5, sr=sr))], FB_BOUND)
    for a, b in zip(pswm.reverse_tensors(*t[:4]), jp.reverse_tensors(*j[:4])):
        assert np.array_equal(a.numpy(), np.asarray(b))


def test_one_hot_profiles_equal_the_token_engines():
    _, lm = _allclass()
    mats = [torch.from_numpy(np.asarray(x)) for x in lm.matrices_2d()]
    it, ot = torch.tensor([0, 1, 1, 0]), torch.tensor([1, 0, 1])
    got = pswm.forward_2d_pswm(*mats, pswm.pswm_from_tokens(it, 2),
                               pswm.pswm_from_tokens(ot, 2), 4, 3)
    _close([float(got)], [float(dp2d.forward_2d(*mats, it, ot, 4, 3))],
           JAX_BOUND)
    emit, closure = _emit_1d("logsumexp")
    trans = LOGSUMEXP.matmul(torch.from_numpy(emit),
                             torch.from_numpy(closure))
    toks = torch.tensor([3, 0, 2, 2, 1])
    from machineboss_tpu_torch.ops import dp1d
    _close([float(pswm.forward_1d_pswm(
        torch.from_numpy(emit), torch.from_numpy(closure),
        pswm.pswm_from_tokens(toks, 4), 5))],
        [float(dp1d.forward_1d_scan(trans, torch.from_numpy(closure), toks,
                                    5))], JAX_BOUND)


def _sparse_ac():
    ev, _ = _allclass()
    if "sm" not in _cache:
        _cache["sm"] = sparse.SparseMachine(ev, device="cpu")
    return _cache["sm"]


def _plan7():
    if "plan7" not in _cache:
        from machineboss_tpu_torch.core.hmmer import HmmerModel
        h = HmmerModel()
        h.read(testmachines.random_plan7_hmm_text(8, testmachines.AMINO, 0))
        gen = h.machine(False)
        ev = EvaluatedMachine(gen, gen.get_param_defs(True))
        _cache["plan7"] = (gen, sparse.SparseMachine(ev, device="cpu"))
    return _cache["plan7"]


@pytest.mark.parametrize("form", ["forward_2d", "backward_2d"])
@pytest.mark.parametrize("viterbi", [False, True])
def test_sparse_2d_pswm_matches_jax(form, viterbi):
    from machineboss_tpu.core.eval import EvaluatedMachine as JEvaluated
    from machineboss_tpu.core.machine import Machine as JMachine
    from machineboss_tpu.ops import sparse as jsparse
    ev, _ = _allclass()
    if "jsm" not in _cache:
        jm = JMachine.from_json(json.loads(ev.machine.to_json_str()))
        _cache["jsm"] = jsparse.SparseMachine(
            JEvaluated(jm, jm.get_param_defs(True)))
    ip, op = _profile(3, 2, 21), _profile(4, 2, 22)
    name = form + "_sparse_pswm"
    got = getattr(sparse, name)(_sparse_ac(), ip, op, viterbi=viterbi)
    ref = getattr(jsparse, name)(_cache["jsm"], ip, op, viterbi=viterbi)
    _close([got], [ref], JAX_BOUND)


@pytest.mark.parametrize("form", ["forward_1d", "backward_1d"])
def test_sparse_1d_pswm_matches_jax(form):
    from machineboss_tpu.core.eval import EvaluatedMachine as JEvaluated
    from machineboss_tpu.core.machine import Machine as JMachine
    from machineboss_tpu.ops import sparse as jsparse
    gen, sm = _plan7()
    jm = JMachine.from_json(json.loads(gen.to_json_str()))
    jsm = jsparse.SparseMachine(JEvaluated(jm, jm.get_param_defs(True)))
    prof = _profile(4, 20, 23)
    name = form + "_sparse_pswm"
    _close([getattr(sparse, name)(sm, prof)],
           [getattr(jsparse, name)(jsm, prof)], JAX_BOUND)


def test_sparse_pswm_invariants():
    """The JAX package's test_sparse_pswm_invariants on the all-class
    transducer and the 8-node Plan7 generator."""
    sm = _sparse_ac()
    _, lm = _allclass()
    it, ot = [1, 2, 2], [2, 1, 1, 2]
    in_oh = pswm.pswm_from_tokens(torch.tensor(it) - 1, 2).numpy()
    out_oh = pswm.pswm_from_tokens(torch.tensor(ot) - 1, 2).numpy()
    tok2d = sparse.forward_2d_sparse(sm, it, ot)
    _close([sparse.forward_2d_sparse_pswm(sm, in_oh, out_oh),
            sparse.backward_2d_sparse_pswm(sm, in_oh, out_oh)], [tok2d] * 2,
           JAX_BOUND)
    ip, op = _profile(3, 2, 17), _profile(4, 2, 18)
    f2 = sparse.forward_2d_sparse_pswm(sm, ip, op)
    mats = [torch.from_numpy(np.asarray(x)) for x in lm.matrices_2d()]
    dense = float(pswm.forward_2d_pswm(*mats, torch.from_numpy(ip),
                                       torch.from_numpy(op), 3, 4))
    _close([f2, sparse.backward_2d_sparse_pswm(sm, ip, op)], [dense] * 2,
           FB_BOUND)
    assert sparse.forward_2d_sparse_pswm(sm, ip, op, viterbi=True) \
        <= f2 + 1e-5
    assert sparse.backward_2d_sparse_pswm(sm, ip, op, viterbi=True) \
        <= f2 + 1e-5
    gen, gsm = _plan7()
    toks = [gsm.ev.output_tokenizer.sym2tok[c] for c in "ACDEF"]
    oh = pswm.pswm_from_tokens(torch.tensor(toks) - 1, 20).numpy()
    _close([sparse.forward_1d_sparse_pswm(gsm, oh)],
           [sparse.forward_1d_sparse(gsm, toks)], JAX_BOUND)
    gp = _profile(4, 20, 19)
    f1 = sparse.forward_1d_sparse_pswm(gsm, gp)
    _close([sparse.backward_1d_sparse_pswm(gsm, gp)], [f1], FB_BOUND)
    assert sparse.forward_1d_sparse_pswm(gsm, gp, viterbi=True) <= f1 + 1e-5


def test_forward_aligned_matches_jax_and_bounds():
    """The tie-free machine's alignment: the path-constrained Forward
    against the JAX package's, in both semirings, and below the full
    Forward."""
    import jax.numpy as jnp
    from machineboss_tpu.core.eval import EvaluatedMachine as JEvaluated
    from machineboss_tpu.core.machine import Machine as JMachine
    from machineboss_tpu.ops import dp_aligned as jal
    from machineboss_tpu_torch.algo.dp_host import ForwardMatrix
    m = testmachines.build_tiefree_machine()
    ev = EvaluatedMachine(m, m.get_param_defs(True))
    jm = JMachine.from_json(json.loads(m.to_json_str()))
    jev = JEvaluated(jm, jm.get_param_defs(True))
    sp = testmachines.tiefree_pair()
    ci, co = dp_aligned.alignment_tokens(ev, sp.alignment)
    jci, jco = jal.alignment_tokens(jev, sp.alignment)
    assert np.array_equal(ci, jci) and np.array_equal(co, jco)
    lm = LoweredMachine(ev, dtype=np.float32)
    lt = lm.log_trans
    pad = np.zeros(3, np.int32)
    for sr_name, sr in SEMIRINGS.items():
        cl = lm.closure_for(sr_name)
        got = float(dp_aligned.forward_aligned(
            torch.from_numpy(lt), torch.from_numpy(cl),
            np.concatenate([ci, pad]), np.concatenate([co, pad]), len(ci),
            sr=sr))
        ref = float(jal.forward_aligned(
            jnp.array(lt), jnp.array(cl), jnp.array(np.concatenate([ci, pad])),
            jnp.array(np.concatenate([co, pad])), len(ci), sr=_jsr(sr_name)))
        _close([got], [ref], JAX_BOUND)
    assert got <= ForwardMatrix(ev, sp).log_like() + 1e-5


@pytest.mark.cuda
def test_pswm_engines_on_card_match_cpu_f64():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    _, lm = _allclass()
    m64 = [torch.from_numpy(np.asarray(x, np.float64))
           for x in lm.matrices_2d()]
    ip = torch.from_numpy(_profile(4, 2, 11).astype(np.float64))
    op = torch.from_numpy(_profile(5, 2, 12).astype(np.float64))
    card = [x.float().to(dev) for x in m64 + [ip, op]]
    for fn in (pswm.forward_2d_pswm, pswm.backward_2d_pswm):
        _close([float(fn(*card, 4, 5))], [float(fn(*m64, ip, op, 4, 5))],
               CARD_BOUND)
    emit, closure = _emit_1d("logsumexp")
    e64 = torch.from_numpy(emit.astype(np.float64))
    c64 = torch.from_numpy(closure.astype(np.float64))
    prof = torch.from_numpy(_profile(12, emit.shape[0], 3).astype(np.float64))
    for fn in (pswm.forward_1d_pswm, pswm.backward_1d_pswm):
        _close([float(fn(e64.float().to(dev), c64.float().to(dev),
                         prof.float().to(dev), 9))],
               [float(fn(e64, c64, prof, 9))], CARD_BOUND)
    ev, _ = _allclass()
    sm_card = sparse.SparseMachine(ev, device=dev)
    sm64 = sparse.SparseMachine(ev, dtype=np.float64, device="cpu")
    for fn in (sparse.forward_2d_sparse_pswm, sparse.backward_2d_sparse_pswm):
        _close([fn(sm_card, ip.numpy(), op.numpy())],
               [fn(sm64, ip.numpy(), op.numpy())], CARD_BOUND)
    lt = torch.from_numpy(np.asarray(lm.log_trans, np.float64))
    cl = torch.from_numpy(np.asarray(lm.closure_for(), np.float64))
    ci, co = np.array([1, 2, 0, 1]), np.array([2, 0, 1, 1])
    _close([float(dp_aligned.forward_aligned(lt.float().to(dev),
                                             cl.float().to(dev), ci, co, 4))],
           [float(dp_aligned.forward_aligned(lt, cl, ci, co, 4))], CARD_BOUND)
