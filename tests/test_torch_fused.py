"""The port's generic fused generator (x) transducer DP (ops/fused.py)
against the JAX function and the materialized composition.

Fixtures built in the test: the two-state generator with silent moves and
its noisy transducer of the JAX package's interleaving test, and the toy
Plan7 profile's core machine against the toy noise transducer. Both sides
lower the same machines with their own fused_tensors (held equal bit for
bit), then the same float32 tensors go through the JAX fused_forward and
the port's. Bounds: 1e-5 nats between the two (the same log-space ops in
float32 on values of a few nats), and the reference tests' bounds against
the float64 composed-machine Forward (1e-4 with 8 paired iterations on the
small pair, 1e-2 on the profile).
"""

import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from machineboss_tpu.core.eval import EvaluatedMachine as JEvaluated
from machineboss_tpu.core.machine import Machine as JMachine
from machineboss_tpu.ops.fused import (fused_forward as j_forward,
                                       fused_tensors as j_tensors)
from machineboss_tpu.ops.semiring import MAXPLUS as J_MAXPLUS

from machineboss_tpu_torch import testmachines
from machineboss_tpu_torch.algo.dp_host import ForwardMatrix
from machineboss_tpu_torch.core.eval import EvaluatedMachine
from machineboss_tpu_torch.core.hmmer import HmmerModel
from machineboss_tpu_torch.core.machine import Machine
from machineboss_tpu_torch.core.seqpair import NamedSeq, SeqPair
from machineboss_tpu_torch.ops.fused import fused_forward, fused_tensors
from machineboss_tpu_torch.ops.semiring import MAXPLUS

VS_JAX = 1e-5

GEN = {"state": [
    {"id": "s0", "trans": [
        {"out": "a", "to": "s0", "weight": 0.3},
        {"to": "s1", "weight": 0.55},
        {"out": "b", "to": "s1", "weight": 0.15}]},
    {"id": "s1", "trans": [
        {"out": "b", "to": "s1", "weight": 0.4},
        {"to": "end", "weight": 0.6}]},
    {"id": "end", "trans": []}]}
TD = {"state": [
    {"id": "t", "trans": [
        {"in": "a", "out": "a", "to": "t", "weight": 0.5},
        {"in": "a", "out": "b", "to": "t", "weight": 0.1},
        {"in": "b", "out": "b", "to": "t", "weight": 0.55},
        {"in": "a", "to": "t", "weight": 0.1},
        {"in": "b", "to": "t", "weight": 0.15},
        {"out": "a", "to": "t", "weight": 0.08},
        {"to": "tend", "weight": 0.2}]},
    {"id": "tend", "trans": []}]}
_cache = {}


def fixture(name):
    """(port generator, port transducer, port tensors, JAX tensors, port
    td_ev) of 'small' (the pair above) or 'profile' (the toy Plan7 core
    machine, glocal, against the toy noise transducer)."""
    if name not in _cache:
        if name == "small":
            gen_json, td_json = GEN, TD
        else:
            hmm = HmmerModel()
            hmm.read(testmachines.TOY_HMM_TEXT)
            gen_json = json.loads(hmm.machine(False).to_json_str())
            td_json = testmachines.TOY_TD_JSON
        gen, td = Machine.from_json(gen_json), Machine.from_json(td_json)
        td_ev = EvaluatedMachine(td, td.get_param_defs(True))
        t = fused_tensors(EvaluatedMachine(gen, gen.get_param_defs(True)),
                          td_ev)
        jgen, jtd = JMachine.from_json(gen_json), JMachine.from_json(td_json)
        j = j_tensors(JEvaluated(jgen, jgen.get_param_defs(True)),
                      JEvaluated(jtd, jtd.get_param_defs(True)))
        _cache[name] = (gen, td, t, j, td_ev)
    return _cache[name]


SEQS = {"small": ["a", "b", "ab", "ba", "aab", ""],
        "profile": ["ACG", "AACGT", "GT", "TTACGACG"]}


@pytest.mark.parametrize("name", ["small", "profile"])
def test_fused_tensors_equal(name):
    _, _, t, j, _ = fixture(name)
    for a, b in zip(t, j):
        assert a.dtype == b.dtype == np.float32 and np.array_equal(a, b)
    gen = fixture("small")[0]
    other_td_ev = fixture("profile")[4]
    with pytest.raises(ValueError, match="alphabet"):
        fused_tensors(EvaluatedMachine(gen, gen.get_param_defs(True)),
                      other_td_ev)


@pytest.mark.parametrize("iters", [4, 8])
@pytest.mark.parametrize("name", ["small", "profile"])
def test_fused_forward_matches_jax(name, iters):
    _, _, t, j, td_ev = fixture(name)
    tt = [torch.from_numpy(x) for x in t]
    jj = [jnp.array(x) for x in j]
    s2t = td_ev.output_tokenizer.sym2tok
    for seq in SEQS[name]:
        toks = np.array([s2t[c] - 1 for c in seq], np.int32)
        pad = np.concatenate([toks, np.zeros(3, np.int32)])  # masked tail
        want = float(j_forward(*jj, jnp.array(pad), len(seq),
                               n_pair_iters=iters))
        got = float(fused_forward(*tt, torch.from_numpy(pad), len(seq),
                                  n_pair_iters=iters))
        assert abs(got - want) <= VS_JAX, (seq, want, got)
        unpadded = float(fused_forward(*tt, list(toks), len(seq),
                                       n_pair_iters=iters))
        assert unpadded == got


@pytest.mark.parametrize("name", ["small", "profile"])
def test_fused_forward_maxplus_matches_jax(name):
    _, _, t, j, td_ev = fixture(name)
    tt = [torch.from_numpy(x) for x in t]
    jj = [jnp.array(x) for x in j]
    s2t = td_ev.output_tokenizer.sym2tok
    for seq in SEQS[name][:3]:
        toks = np.array([s2t[c] - 1 for c in seq], np.int32)
        want = float(j_forward(*jj, jnp.array(toks), len(seq), sr=J_MAXPLUS))
        got = float(fused_forward(*tt, torch.from_numpy(toks), len(seq),
                                  sr=MAXPLUS))
        assert abs(got - want) <= VS_JAX, (seq, want, got)


@pytest.mark.parametrize("name,iters,tol", [("small", 8, 1e-4),
                                            ("profile", 4, 1e-2)])
def test_fused_forward_matches_composed(name, iters, tol):
    gen, td, t, _, td_ev = fixture(name)
    tt = [torch.from_numpy(x) for x in t]
    comp = Machine.compose(gen, td)
    ev = EvaluatedMachine(comp, comp.get_param_defs(True))
    s2t = td_ev.output_tokenizer.sym2tok
    for seq in SEQS[name]:
        want = ForwardMatrix(ev, SeqPair(
            NamedSeq("i", []), NamedSeq("o", list(seq)))).log_like()
        toks = torch.tensor([s2t[c] - 1 for c in seq], dtype=torch.int32)
        got = float(fused_forward(*tt, toks, len(seq), n_pair_iters=iters))
        if want == -np.inf:
            assert got < -1e20, (seq, got)
        else:
            assert abs(got - want) < tol, (seq, want, got)
