"""The port's device CTC node scoring (algo/ctc_device.CTCDeviceModel)
against the JAX class and the host PrefixTree's node fill.

On bintern with "12222" (the JAX test's case) and on prot2dna with a
24-nt read, the root and every child of the root equal the host tree's
cells and log prefix probabilities within the JAX test's TOL (1e-3) and
the JAX class's within 1e-4; the model's tensors (float64) equal the JAX
model's arrays (float32) once rounded. On a 96-nt read the JAX class's
float32 prefix cells come out dead where the host's are live; the port's
(float64) equal the host's.
"""

import os

import numpy as np
import pytest

from machineboss_tpu.algo.ctc_device import CTCDeviceModel as JModel
from machineboss_tpu.core.eval import EvaluatedMachine as JEv
from machineboss_tpu.core.machine import Machine as JMachine
from machineboss_tpu.core.presets import make_preset as j_make_preset
from machineboss_tpu_torch.algo.ctc import PrefixTree
from machineboss_tpu_torch.algo.ctc_device import CTCDeviceModel
from machineboss_tpu_torch.core.eval import EvaluatedMachine
from machineboss_tpu_torch.core.machine import Machine
from machineboss_tpu_torch.core.presets import make_preset
from machineboss_tpu_torch.ops.semiring import NEG_INF
from machineboss_tpu_torch.testmachines import prot2dna_pairs

TOL = 1e-3                       # the JAX test's tolerance against the host
JAX_TOL = 1e-4                   # the JAX class's float32 rounding
LONG_TOL = 1e-6                  # float64 against the float64 host
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BINTERN = os.path.join(ROOT, "machineboss_tpu", "data", "presets",
                       "bintern.json")


def _case(name):
    if name == "bintern":
        tm, jm, out = (Machine.from_file(BINTERN),
                       JMachine.from_file(BINTERN), "12222")
    else:
        tm, jm = make_preset("prot2dna"), j_make_preset("prot2dna")
        out = prot2dna_pairs(1, 8, seed=3)[0][1]
    tev = EvaluatedMachine(tm, tm.get_param_defs(True))
    jev = JEv(jm, jm.get_param_defs(True))
    syms = list(out)
    toks = tev.output_tokenizer.tokenize(syms)
    assert toks == jev.output_tokenizer.tokenize(syms)
    return tev, jev, syms, toks


def _cmp(a, b, tol):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    live = b > -1e20
    err = np.abs(np.where(live, a - b, 0))
    assert np.all(err < tol), err.max()
    assert np.all(a[~live] < -1e20)


def _lpp(a, b, tol):
    if b == -np.inf or b < -1e20:
        assert a < -1e20, (a, b)
    else:
        assert abs(a - b) < tol, (a, b)


@pytest.mark.parametrize("name", ["bintern", "prot2dna"])
def test_ctc_device_fill_matches_host_and_jax(name):
    tev, jev, syms, toks = _case(name)
    model = CTCDeviceModel(tev, toks, device="cpu")
    jmodel = JModel(jev, toks)
    tree = PrefixTree(tev, syms)
    root = tree.root
    seq, pref, lpp = model.fill(
        np.zeros((len(syms) + 1, tev.n_states())), 0)
    j_seq, j_pref, j_lpp = jmodel.fill(
        np.zeros((len(syms) + 1, tev.n_states())), 0)
    _cmp(seq, root.seq_cell, TOL)
    _cmp(pref, root.prefix_cell, TOL)
    _lpp(lpp, root.log_prefix_prob, TOL)
    _cmp(seq, j_seq, JAX_TOL)
    _cmp(pref, j_pref, JAX_TOL)
    _lpp(lpp, j_lpp, JAX_TOL)

    # children of the root, every token in one batched pass
    seqs, prefs, lpps = model.fill_all_tokens(root.seq_cell)
    j_seqs, j_prefs, j_lpps = jmodel.fill_all_tokens(root.seq_cell)
    assert seqs.shape == j_seqs.shape == (tev.input_tokenizer.n_tokens() - 1,
                                          len(syms) + 1, tev.n_states())
    assert lpps.shape == j_lpps.shape
    tree._extend_node(root)
    assert len(root.child) == seqs.shape[0]
    for child in root.child:
        t = child.in_tok - 1
        _cmp(seqs[t], child.seq_cell, TOL)
        _cmp(prefs[t], child.prefix_cell, TOL)
        _lpp(lpps[t], child.log_prefix_prob, TOL)
    _cmp(seqs, j_seqs, JAX_TOL)
    _cmp(prefs, j_prefs, JAX_TOL)
    for a, b in zip(lpps, j_lpps):
        _lpp(a, b, JAX_TOL)

    # a second level, through one child, by fill
    child = max(root.child, key=lambda c: c.log_prefix_prob)
    seq2, pref2, lpp2 = model.fill(child.seq_cell, 1)
    j_seq2, j_pref2, j_lpp2 = jmodel.fill(child.seq_cell, 1)
    _cmp(seq2, j_seq2, JAX_TOL)
    _cmp(pref2, j_pref2, JAX_TOL)
    _lpp(lpp2, j_lpp2, JAX_TOL)


@pytest.mark.parametrize("name", ["bintern", "prot2dna"])
def test_ctc_device_tensors_equal_the_jax_arrays(name):
    tev, jev, _, toks = _case(name)
    model = CTCDeviceModel(tev, toks, device="cpu")
    jmodel = JModel(jev, toks)
    for attr in ("a_diag", "a_in", "ls", "prefix_chain", "_sc"):
        got = getattr(model, attr).numpy()
        want = np.asarray(getattr(jmodel, attr))
        assert got.dtype == np.float64 and got.shape == want.shape, attr
        np.testing.assert_array_equal(got.astype(np.float32), want,
                                      err_msg=attr)
    assert (model.S, model.n_in, model.Lo) == (jmodel.S, jmodel.n_in,
                                               jmodel.Lo)
    assert NEG_INF == -1e30


def test_long_read_port_is_the_host_where_jax_prefix_cells_die():
    """prot2dna with a 96-nt read (a 32-aa protein's coding DNA): the JAX
    class's float32 max-shifted products drop every term more than ~87
    nats below a row's maximum, so some of its root prefix cells are dead
    where the host's are live; the port's float64 cells equal the host's
    (seq and prefix cells, the log prefix probability, and the children's
    in one batched pass)."""
    tm, jm = make_preset("prot2dna"), j_make_preset("prot2dna")
    tev = EvaluatedMachine(tm, tm.get_param_defs(True))
    jev = JEv(jm, jm.get_param_defs(True))
    syms = list(prot2dna_pairs(1, 32, seed=0)[0][1])
    toks = tev.output_tokenizer.tokenize(syms)
    tree = PrefixTree(tev, syms)
    root = tree.root
    zeros = np.zeros((len(syms) + 1, tev.n_states()))
    _, j_pref, _ = JModel(jev, toks).fill(zeros, 0)
    live = root.prefix_cell > -1e20
    assert (np.asarray(j_pref)[live] < -1e20).any()
    model = CTCDeviceModel(tev, toks, device="cpu")
    seq, pref, lpp = model.fill(zeros, 0)
    _cmp(seq, root.seq_cell, LONG_TOL)
    _cmp(pref, root.prefix_cell, LONG_TOL)
    _lpp(lpp, root.log_prefix_prob, LONG_TOL)
    seqs, prefs, lpps = model.fill_all_tokens(root.seq_cell)
    tree._extend_node(root)
    for child in root.child:
        t = child.in_tok - 1
        _cmp(seqs[t], child.seq_cell, LONG_TOL)
        _cmp(prefs[t], child.prefix_cell, LONG_TOL)
        _lpp(lpps[t], child.log_prefix_prob, LONG_TOL)
