"""The port's E-step (ops/fwdback.CountModel, parallel/em.device_counts)
against the JAX package's CountModel and the float64 host MachineCounts.

The JAX class differentiates a vmap of its row scan; the port
differentiates the batched scaled wavefront (ops/wavefront_fast.py), the
same function. On the CPU both are held to the host counts at the JAX
tests' rtol 1e-3 / atol 1e-4 (tests/test_device_counts.py), on the silent
tkf91branch, the indel transducer, jukescantor and short prot2dna pairs,
and the port's counts to the JAX class's at the same tolerance, from
identical arrays (convert.count_model_from_numpy). On a generator the JAX
class raises (its row scan indexes the empty a_left); the port's counts
equal the host's. The card tests (marker cuda) hold the card's counts to
the CPU's. This file imports the JAX package only inside its JAX tests.
"""

import json

import numpy as np
import pytest
import torch

from machineboss_tpu_torch import testmachines
from machineboss_tpu_torch.algo.counts import MachineCounts
from machineboss_tpu_torch.algo.dp_host import ForwardMatrix
from machineboss_tpu_torch.convert import count_model_from_numpy
from machineboss_tpu_torch.core.eval import EvaluatedMachine
from machineboss_tpu_torch.core.params import param_assign_from_json
from machineboss_tpu_torch.core.presets import make_preset
from machineboss_tpu_torch.core.seqpair import NamedSeq, SeqPair, SeqPairList
from machineboss_tpu_torch.models import casino
from machineboss_tpu_torch.ops.fwdback import CountModel, tokenize_batch
from machineboss_tpu_torch.ops.semiring import NEG_INF
from machineboss_tpu_torch.parallel.em import device_counts

RTOL, ATOL = 1e-3, 1e-4          # the JAX tests' count tolerance
LL_TOL = 1e-3                    # nats, summed over the batch


def _sp(i, o):
    return SeqPair(NamedSeq("i", list(i)), NamedSeq("o", list(o)))


def _tkf91branch():
    pairs = [("ACGT", "ACGGT"), ("", "AC"), ("GA", ""), ("AACG", "ACCG"),
             ("T", "T")]
    return make_preset("tkf91branch"), \
        {"insRate": 0.1, "delRate": 0.2, "time": 0.5}, pairs


def _indel():
    m = testmachines.build_indel_transducer(6, list("ACGT"))
    pairs = [("ACGTA", "ACTA"), ("GGC", "GAGC"), ("T", "TT"),
             ("CATG", "CAG")]
    return m, None, pairs


def _jukescantor():
    return make_preset("jukescantor"), {"t": 0.3}, \
        [("ACGT", "ACGA"), ("GGTA", "GCTA"), ("C", "C")]


def _prot2dna():
    m = make_preset("prot2dna")
    pairs = testmachines.prot2dna_pairs(3, [4, 6, 5], seed=2,
                                        synonymous=True)
    return m, None, pairs


def _casino():
    return casino.casino_machine(parameterized=False), None, \
        [("", "1666"), ("", "62513"), ("", "6")]


MACHINES = {"tkf91branch": _tkf91branch, "indel": _indel,
            "jukescantor": _jukescantor, "prot2dna": _prot2dna,
            "casino": _casino}
_cache = {}


def _params(m, values, assign):
    """The machine's defaults with the numeric `values` over them."""
    p = m.get_param_defs(True)
    return p.combine(assign(values), True) if values else p


def _case(name):
    """(machine, params, ev, SeqPairList, host MachineCounts)."""
    if name not in _cache:
        m, values, pairs = MACHINES[name]()
        p = _params(m, values, param_assign_from_json)
        ev = EvaluatedMachine(m, p)
        spl = SeqPairList([_sp(i, o) for i, o in pairs])
        _cache[name] = (m, p, ev, spl, MachineCounts(ev, spl))
    return _cache[name]


def _port_counts(ev, spl, device="cpu", weights=None):
    model = CountModel(ev, device=device)
    toks = tokenize_batch(ev, spl.seq_pairs, device=device)
    grads, total, lls = model.counts_and_loglike(*toks, weights=weights)
    return grads.cpu().numpy(), float(total), lls.cpu().numpy()


def _jax_model(name):
    """The JAX package's CountModel on the same machine (carried across as
    JSON text) and its tokenized batch."""
    import jax.numpy as jnp
    from machineboss_tpu.core.eval import EvaluatedMachine as JEvaluated
    from machineboss_tpu.core.machine import Machine as JMachine
    from machineboss_tpu.core.params import param_assign_from_json as jp
    from machineboss_tpu.core.seqpair import NamedSeq as JN, SeqPair as JSP
    from machineboss_tpu.ops.fwdback import CountModel as JCountModel
    from machineboss_tpu.ops.fwdback import tokenize_batch as jtok
    m, _, _, spl, _ = _case(name)
    jm = JMachine.from_json(json.loads(m.to_json_str()))
    jev = JEvaluated(jm, _params(jm, MACHINES[name]()[1], jp))
    pairs = [JSP(JN("i", sp.input.seq), JN("o", sp.output.seq))
             for sp in spl.seq_pairs]
    return JCountModel(jev, dtype=jnp.float32), jtok(jev, pairs)


@pytest.mark.parametrize("name", list(MACHINES))
def test_count_model_arrays_equal_the_jax_class(name):
    """The flat edge list in the host's (state, transIndex) order: the
    same indices, and the same float32 log-weights bit for bit."""
    jmodel, _ = _jax_model(name)
    model = CountModel(_case(name)[2], device="cpu")
    for key in ("src", "dst", "itok", "otok"):
        assert np.array_equal(getattr(model, key).numpy(),
                              np.asarray(getattr(jmodel, key))), key
    jl = np.asarray(jmodel.logw)
    assert jl.dtype == np.float32 and model.logw.dtype == torch.float32
    assert np.array_equal(model.logw.numpy().view(np.int32),
                          jl.view(np.int32))
    assert (model.n_states, model.n_in, model.n_out, model.n_edges) == \
        (jmodel.n_states, jmodel.n_in, jmodel.n_out, jmodel.n_edges)


@pytest.mark.parametrize("name", ["tkf91branch", "indel", "jukescantor",
                                  "prot2dna"])
def test_counts_match_jax_and_host(name):
    """Counts and totals: the port against the host's float64 counts and
    against the JAX class, both from the JAX class's own arrays."""
    _, _, ev, spl, host = _case(name)
    jmodel, jtoks = _jax_model(name)
    jg, jtotal, jlls = jmodel.counts_and_loglike(*jtoks)
    model = count_model_from_numpy(
        *(np.asarray(getattr(jmodel, k)) for k in
          ("src", "dst", "itok", "otok", "logw")),
        jmodel.n_states, jmodel.n_in, jmodel.n_out, device="cpu")
    toks = [torch.tensor(np.asarray(x)) for x in jtoks]
    grads, total, lls = model.counts_and_loglike(*toks)
    flat_host = np.concatenate(host.count)
    np.testing.assert_allclose(grads.numpy(), flat_host, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(grads.numpy(), np.asarray(jg), rtol=RTOL,
                               atol=ATOL)
    assert abs(float(total) - host.loglike) < LL_TOL
    assert abs(float(total) - float(jtotal)) < LL_TOL
    np.testing.assert_allclose(lls.numpy(), np.asarray(jlls), atol=LL_TOL)
    assert np.isfinite(grads.numpy()).all()
    # the port's own model (built from ev) computes the same
    own, own_total, _ = _port_counts(ev, spl)
    np.testing.assert_allclose(own, grads.numpy(), rtol=1e-6, atol=1e-7)


def test_weight_zero_duplicate_changes_nothing():
    """A pair repeated with weight 0 adds nothing to the total or the
    counts (the JAX package pads a sharded batch this way)."""
    _, _, ev, spl, _ = _case("tkf91branch")
    base, total, _ = _port_counts(ev, spl)
    dup = SeqPairList(list(spl.seq_pairs) + [spl.seq_pairs[0]])
    w = torch.ones(len(dup.seq_pairs))
    w[-1] = 0.0
    got, got_total, lls = _port_counts(ev, dup, weights=w)
    assert got_total == pytest.approx(total, abs=1e-5)
    np.testing.assert_allclose(got, base, rtol=1e-5, atol=1e-6)
    assert lls[-1] == pytest.approx(lls[0], abs=1e-5)


def test_impossible_pair_drops_out():
    """A prot2dna pair with a base inserted inside a codon has no path
    (the host Forward gives -inf): its ll is NEG_INF, and the total and
    counts are the other pairs'."""
    _, _, ev, spl, host = _case("prot2dna")
    sp = spl.seq_pairs[0]
    dna = "".join(sp.output.seq)
    bad = _sp("".join(sp.input.seq), dna[:4] + "C" + dna[4:])
    assert ForwardMatrix(ev, bad).log_like() < -1e29
    got, total, lls = _port_counts(
        ev, SeqPairList(list(spl.seq_pairs) + [bad]))
    assert lls[-1] <= NEG_INF / 2 and (lls[:-1] > NEG_INF / 2).all()
    assert np.isfinite(got).all()
    assert abs(total - host.loglike) < LL_TOL
    np.testing.assert_allclose(got, np.concatenate(host.count), rtol=RTOL,
                               atol=ATOL)


def test_generator_jax_raises_port_matches_host():
    """On a generator (empty input side) the JAX class's row scan indexes
    the empty a_left and raises TypeError; the port's batched wavefront
    takes the empty side and its counts equal the host's."""
    _, _, ev, spl, host = _case("casino")
    jmodel, jtoks = _jax_model("casino")
    with pytest.raises(TypeError):
        jmodel.counts_and_loglike(*jtoks)
    got, total, _ = _port_counts(ev, spl)
    np.testing.assert_allclose(got, np.concatenate(host.count), rtol=RTOL,
                               atol=ATOL)
    assert abs(total - host.loglike) < LL_TOL


@pytest.mark.parametrize("name", ["tkf91branch", "casino"])
def test_device_counts_matches_host(name):
    """parallel.em.device_counts returns a host MachineCounts in the
    host's layout, in float64, with loglike the batch total."""
    m, p, _, spl, host = _case(name)
    got = device_counts(m, p, spl, device="cpu")
    assert [c.shape for c in got.count] == [c.shape for c in host.count]
    assert all(c.dtype == np.float64 for c in got.count)
    for s in range(len(host.count)):
        np.testing.assert_allclose(got.count[s], host.count[s], rtol=RTOL,
                                   atol=ATOL)
    assert abs(got.loglike - host.loglike) < LL_TOL


def test_device_counts_mesh_raises_naming_item_8():
    """mesh= runs since the parallel layer was ported (ROADMAP.md queue A;
    tests/test_torch_parallel.py holds it to the JAX function); what
    still raises is a device that contradicts the mesh's, a ValueError
    before any collective."""
    import types
    m, p, _, spl, _ = _case("tkf91branch")
    with pytest.raises(ValueError, match="disagrees with the mesh"):
        device_counts(m, p, spl, mesh=types.SimpleNamespace(
            device_type="cpu"), device="cuda")


def test_default_device_is_the_card():
    """device=None means the CUDA card: without CUDA, CountModel and
    device_counts raise; with it, the model's tensors live on the card."""
    m, p, ev, spl, _ = _case("tkf91branch")
    if torch.cuda.is_available():
        assert CountModel(ev).logw.device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        CountModel(ev)
    with pytest.raises(RuntimeError, match="CUDA"):
        device_counts(m, p, spl)


def test_saved_tensors_stay_per_cell():
    """What autograd keeps for the backward pass grows with the batch's
    cells, not with every cell's token products: the wavefront picks each
    cell's token block by indexing, which keeps the indices, where a
    gather would keep all Ti*To blocks of every diagonal (at prot2dna's
    B=128 x 64 x 192, more than an 80 GB card holds). The batch is
    doubled, so the machine's tables cancel out of the growth."""
    _, _, ev, spl, _ = _case("prot2dna")
    model = CountModel(ev, device="cpu")

    def saved_bytes(pairs):
        toks = tokenize_batch(ev, pairs, device="cpu")
        storages = {}

        def keep(t):
            storages[t.untyped_storage().data_ptr()] = \
                t.untyped_storage().nbytes()
            return t

        logw = model.logw.clone().requires_grad_(True)
        with torch.autograd.graph.saved_tensors_hooks(keep, lambda t: t):
            model.batch_loglike(logw, *toks)
        return sum(storages.values()), toks

    one, toks = saved_bytes(spl.seq_pairs)
    two, _ = saved_bytes(list(spl.seq_pairs) * 2)
    B, Li = toks[0].shape
    n_diag = Li + toks[1].shape[1]
    cell_bytes = B * (Li + 1) * model.n_states * 4   # one (B, W, S) slab
    assert two - one < 12 * cell_bytes * n_diag


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["tkf91branch", "indel"])
def test_counts_on_card_match_cpu(name):
    """The same E-step on the card and on the CPU, float32 both: 1e-5."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    _, _, ev, spl, _ = _case(name)
    cpu, cpu_total, _ = _port_counts(ev, spl, device="cpu")
    card, card_total, _ = _port_counts(ev, spl, device="cuda")
    np.testing.assert_allclose(card, cpu, rtol=1e-5, atol=1e-5)
    assert abs(card_total - cpu_total) < 1e-5 * max(1.0, abs(cpu_total))


@pytest.mark.cuda
def test_device_counts_runs_on_the_card_by_default():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    m, p, _, spl, host = _case("indel")
    got = device_counts(m, p, spl)
    for s in range(len(host.count)):
        np.testing.assert_allclose(got.count[s], host.count[s], rtol=RTOL,
                                   atol=ATOL)
