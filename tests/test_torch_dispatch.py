"""The port's CompiledMachine against the JAX package's.

log_forward_batch: on the CPU, with engine="auto", both packages take their
wavefront engine for every dense 2D machine, structured (prot2dna) or
full-rank: 1e-4 nats (same algorithm, other summation order). With
engine="kernel" the port takes its kernel routes (their plain versions on
the CPU): merged, chained_ragged and the 1D scan, each within 2e-3 nats of
the JAX package's log_forward_batch on the same pairs.

The single-pair API (log_forward, log_viterbi, log_backward_lattice, the
module-level functions) against the JAX class at 1e-4 nats and the f64
host engine at 0.01, each strategy; `_strategy` reads the measured table
of the machine's device type. The card tests (marker cuda) hold the card's
calls to the CPU's float64 ones; this file imports the JAX package only
inside its JAX tests, so they run where there is no JAX.
"""

import json

import numpy as np
import pytest
import torch

from machineboss_tpu_torch import testmachines
from machineboss_tpu_torch.convert import compiled_from_json, \
    lowered_from_numpy
from machineboss_tpu_torch.core.presets import make_preset
from machineboss_tpu_torch.dispatch import CompiledMachine
from machineboss_tpu_torch.ops.host_oracle import forward_2d_f64
from machineboss_tpu_torch.ops.kernels.wavefront_kernel import ragged_span

def JCompiled(*args, **kwargs):
    from machineboss_tpu.dispatch import CompiledMachine
    return CompiledMachine(*args, **kwargs)


def _jmachine(js):
    from machineboss_tpu.core.machine import Machine
    return Machine.from_json(js)


def j_make_preset(name):
    from machineboss_tpu.core.presets import make_preset
    return make_preset(name)


LOWRANK_BOUND = 5e-3
WAVEFRONT_BOUND = 1e-4
KERNEL_ROUTE_BOUND = 2e-3
_cache = {}


def _prot2dna():
    if "p2d" not in _cache:
        _cache["p2d"] = (JCompiled(j_make_preset("prot2dna")),
                         CompiledMachine(make_preset("prot2dna"),
                                         device="cpu"))
    return _cache["p2d"]


def _pairs(B, lo, hi, seed):
    lens = np.random.RandomState(seed).randint(lo, hi + 1, B)
    return testmachines.prot2dna_pairs(B, lens, seed=seed)


def test_log_forward_batch_matches_jax_and_f64():
    jcm, tcm = _prot2dna()
    pairs = _pairs(8, 3, 8, seed=4)
    port = tcm.log_forward_batch(pairs)
    assert tcm.last_route == "wavefront"
    assert port.shape == (8,) and np.isfinite(port).all()
    np.testing.assert_allclose(port, jcm.log_forward_batch(pairs), rtol=0,
                               atol=WAVEFRONT_BOUND)
    mats = [np.asarray(x, np.float64) for x in tcm._host_mats()]
    ref = [forward_2d_f64(*mats, tcm.in_toks(i), tcm.out_toks(o))
           for i, o in pairs]
    np.testing.assert_allclose(port, ref, rtol=0, atol=LOWRANK_BOUND)


def test_router_picks_lowrank_for_prot2dna():
    """The lowrank route is the card's (and engine="kernel"'s) for
    prot2dna; engine="auto" on the CPU takes the wavefront engine, as the
    JAX class does off its accelerator."""
    _, tcm = _prot2dna()
    assert tcm.route() == "wavefront"
    assert tcm.route("kernel") == "lowrank"
    assert tcm.lowrank_ratio() < 0.6
    assert tcm.route("wavefront") == "wavefront"
    on_card = CompiledMachine(make_preset("prot2dna"), device="cpu")
    on_card.device = torch.device("cuda")   # decided before any launch
    assert on_card.route() == "lowrank"


def test_full_rank_cpu_takes_wavefront_like_jax():
    m = testmachines.build_random_transducer(6, list("ACGT"), seed=3)
    tcm = CompiledMachine(m, device="cpu")
    assert tcm.lowrank_ratio() >= 0.6 and tcm.route() == "wavefront"
    jcm = JCompiled(_jmachine(json.loads(m.to_json_str())))
    rng = np.random.RandomState(5)
    pairs = [("".join(rng.choice(list("ACGT"), n)),
              "".join(rng.choice(list("ACGT"), n))) for n in (5, 9, 12)]
    np.testing.assert_allclose(tcm.log_forward_batch(pairs),
                               jcm.log_forward_batch(pairs), rtol=0,
                               atol=WAVEFRONT_BOUND)


def test_bucketed_equals_padded():
    _, tcm = _prot2dna()
    pairs = _pairs(64, 1, 12, seed=6)
    # per-pair arithmetic is the same in every bucket; only the batched
    # matmul shapes differ, which may reorder f32 sums (1e-5 nats)
    np.testing.assert_allclose(tcm.log_forward_batch(pairs, bucket=True),
                               tcm.log_forward_batch(pairs), rtol=0,
                               atol=1e-5)


def _one_d_machine(side="out"):
    return {"state": [
        {"id": "S", "trans": [{side: "A", "to": "S", "weight": 0.5},
                              {side: "C", "to": "T", "weight": 0.3},
                              {"to": "E", "weight": 0.2}]},
        {"id": "T", "trans": [{side: "A", "to": "S", "weight": 0.6},
                              {side: "C", "to": "T", "weight": 0.1},
                              {"to": "E", "weight": 0.3}]},
        {"id": "E", "trans": []}]}


@pytest.mark.parametrize("branch", ["one_d", "sparse", "full_rank_card"])
def test_unported_routes_raise(branch):
    """The routes that used to raise now score: the 1D route, the
    full-rank route on the card, and the non-dense route (pair by pair
    through the sparse engine, as in the JAX package)."""
    if branch == "one_d":
        cm = CompiledMachine(_one_d_machine(), device="cpu")
        res = cm.log_forward_batch([("", "AC")])
        assert cm.last_route == "scan"
        assert res[0] == pytest.approx(np.log(0.5 * 0.3 * 0.3), abs=1e-5)
    elif branch == "sparse":
        cm = CompiledMachine(make_preset("prot2dna"), device="cpu",
                             dense_max_states=16)
        pairs = [("M", "ATG"), ("MK", "ATGAAA"), ("W", "")]
        res = cm.log_forward_batch(pairs)
        assert cm.last_route == "sparse" and res.shape == (3,)
        _, dense = _prot2dna()
        assert dense.is_dense and not cm.is_dense
        ref = dense.log_forward_batch(pairs)
        assert np.array_equal(res <= -1e29, ref <= -1e29)
        live = ref > -1e29
        np.testing.assert_allclose(res[live], ref[live], rtol=0,
                                   atol=WAVEFRONT_BOUND)
    else:
        cm = CompiledMachine(
            testmachines.build_random_transducer(6, list("ACGT"), seed=3),
            device="cpu")
        # the router decides before touching the card
        cm.device = torch.device("cuda")
        assert cm.route() == "fullrank"


def _dense6():
    if "dense6" not in _cache:
        m = testmachines.build_random_transducer(6, list("ACGT"), seed=3)
        _cache["dense6"] = (
            JCompiled(_jmachine(json.loads(m.to_json_str()))),
            CompiledMachine(m, device="cpu"))
    return _cache["dense6"]


def _acgt_pairs(lens, seed):
    rng = np.random.RandomState(seed)
    return [("".join(rng.choice(list("ACGT"), n)),
             "".join(rng.choice(list("ACGT"), n))) for n in lens]


@pytest.mark.parametrize("batch,route", [
    ("uniform", "merged"), ("ragged_b6", "merged"),
    ("ragged_b8", "chained_ragged"), ("ragged_b8_empty", "merged")])
def test_full_rank_kernel_route(batch, route):
    """engine="kernel" on the CPU drives the full-rank router: merged on a
    uniform batch, on a ragged batch with B % 8 != 0 and on one with an
    empty sequence; chained_ragged on a ragged batch of 8."""
    jcm, tcm = _dense6()
    lens = {"uniform": [9] * 8, "ragged_b6": [5, 9, 12, 7, 9, 11],
            "ragged_b8": [5, 9, 12, 7, 9, 11, 6, 10],
            "ragged_b8_empty": [5, 9, 12, 0, 9, 11, 6, 10]}[batch]
    pairs = _acgt_pairs(lens, seed=len(lens) + lens[3])
    # the ragged schedule's cache key carries the chain length and the
    # span of the sorted schedule, rounded up to 64, as the JAX router's
    ragged_key = ("chained_ragged", 8,
                  -(-ragged_span(lens, lens, 8) // 64) * 64) \
        if route == "chained_ragged" else (None, None, None)
    for engine in ("kernel", "pallas"):
        res = tcm.log_forward_batch(pairs, engine=engine)
        assert tcm.last_route == route
        assert ("kernel", len(lens), 16, 16) + ragged_key in tcm._cache
    np.testing.assert_allclose(res, jcm.log_forward_batch(pairs), rtol=0,
                               atol=KERNEL_ROUTE_BOUND)
    mats = [np.asarray(x, np.float64) for x in tcm._host_mats()]
    ref = [forward_2d_f64(*mats, tcm.in_toks(i), tcm.out_toks(o))
           for i, o in pairs]
    np.testing.assert_allclose(res, ref, rtol=0, atol=KERNEL_ROUTE_BOUND)
    # the default engine keeps full-rank machines on the wavefront engine
    # off the card, as the JAX package does
    tcm.log_forward_batch(pairs)
    assert tcm.last_route == "wavefront"


def test_kernel_engine_keeps_structured_machines_on_lowrank():
    _, tcm = _prot2dna()
    assert tcm.route("kernel") == "lowrank" and tcm.route("pallas") == "lowrank"
    tcm.log_forward_batch(_pairs(2, 3, 5, seed=1), engine="kernel")
    assert tcm.last_route == "lowrank"
    with pytest.raises(ValueError, match="engine must be"):
        tcm.route("mosaic")


@pytest.mark.parametrize("engine", ["auto", "kernel"])
@pytest.mark.parametrize("side", ["in", "out"])
def test_one_d_machines_take_the_1d_route(side, engine):
    """An input-empty and an output-empty machine through
    log_forward_batch, against the JAX package's: the sequential scan with
    engine="auto" off the card, the 1D kernel route with "kernel"."""
    js = _one_d_machine(side)
    tcm = CompiledMachine(js, device="cpu")
    jcm = JCompiled(_jmachine(js))
    rng = np.random.RandomState(3)
    seqs = ["".join(rng.choice(list("AC"), n)) for n in (0, 1, 7, 30, 18)]
    pairs = [("", q) if side == "out" else (q, "") for q in seqs]
    res = tcm.log_forward_batch(pairs, engine=engine)
    assert tcm.last_route == ("scan" if engine == "auto" else "scan1d")
    assert res.shape == (5,) and np.isfinite(res).all()
    np.testing.assert_allclose(res, jcm.log_forward_batch(pairs), rtol=0,
                               atol=KERNEL_ROUTE_BOUND)
    # engine="wavefront" keeps a 1D machine on the 2D wavefront engine
    wf = tcm.log_forward_batch(pairs, engine="wavefront")
    assert tcm.last_route == "wavefront"
    np.testing.assert_allclose(wf, res, rtol=0, atol=KERNEL_ROUTE_BOUND)
    with pytest.raises(ValueError, match="engine must be"):
        tcm.log_forward_batch(pairs, engine="mosaic")


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        cm = CompiledMachine(make_preset("prot2dna"))
        assert cm.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            CompiledMachine(make_preset("prot2dna"))


def test_compiled_from_json_round_trip():
    m = j_make_preset("dnapsw")
    params = {k: v for k, v in json.loads(
        m.get_param_defs(True).to_json_str()).items()}
    params.update({"gapOpen": 0.1, "gapExtend": 0.7, "subAA": 0.7,
                   "subCC": 0.6})
    jcm = JCompiled(m, params)
    tcm = compiled_from_json(m.to_json_str(), json.dumps(params),
                             device="cpu")
    rng = np.random.RandomState(7)
    pairs = [("".join(rng.choice(list("ACGT"), a)),
              "".join(rng.choice(list("ACGT"), b)))
             for a, b in ((4, 6), (9, 7), (12, 12))]
    res = tcm.log_forward_batch(pairs)
    assert np.isfinite(res).all()
    np.testing.assert_allclose(res, jcm.log_forward_batch(pairs), rtol=0,
                               atol=WAVEFRONT_BOUND)


def test_lowered_from_numpy_is_exact():
    jcm, _ = _prot2dna()
    mats = [np.asarray(x) for x in jcm.lowered.matrices_2d()]
    tm = lowered_from_numpy(*mats, device="cpu")
    for a, t in zip(mats, tm):
        assert t.dtype == torch.float32 and t.device.type == "cpu"
        assert np.array_equal(a, t.numpy())


# ---- the single-pair API --------------------------------------------------

SINGLE_BOUND = 1e-4       # nats: the port's single-pair call against JAX's
HOST_BOUND = 0.01         # nats: the f64 host engine (the contract)
CARD_BOUND = 1e-3         # nats: card float32 against CPU float64


def _host(cm, a, b, viterbi=False):
    from machineboss_tpu_torch.algo.dp_host import ForwardMatrix, \
        ViterbiMatrix
    from machineboss_tpu_torch.core.seqpair import NamedSeq, SeqPair
    cls = ViterbiMatrix if viterbi else ForwardMatrix
    return max(cls(cm.ev, SeqPair(NamedSeq("i", list(a)),
                                  NamedSeq("o", list(b)))).log_like(), -1e30)


def _agree(a, b, bound):
    """Both impossible (<= -1e29), or within `bound` nats."""
    assert (a <= -1e29) == (b <= -1e29), (a, b)
    assert a <= -1e29 or abs(a - b) <= bound, (a, b)


def _gen(S):
    """A 1D generator of S states and End (S + 1 states)."""
    return testmachines.build_generator_1d(S, seed=S)


def _cuda_row():
    """The card's row: dispatch_table_cuda.json, which autotune_dispatch
    measured on the card."""
    from machineboss_tpu_torch.autotune_dispatch import table_path
    with open(table_path("cuda")) as f:
        return json.load(f)["backends"]["cuda"]


def _row_rule(row, S, L):
    by_s = row["derived"]["assoc_min_L_by_S"]
    if not by_s:
        return "scan"
    nearest = min((int(k) for k in by_s), key=lambda k: abs(k - S))
    return "assoc" if L >= by_s[str(nearest)] else "scan"


def test_strategy_reads_the_table_of_the_device_type(monkeypatch):
    """One process, a CPU machine and a CUDA one: the CPU takes the JAX
    table's `cpu` row (assoc never won: "scan"), the card its measured
    `cuda` row, each from its own cached row; a device type without a row
    takes the default rule (assoc from L=256 at S <= 64)."""
    monkeypatch.setattr(CompiledMachine, "_dispatch_tables",
                        dict(CompiledMachine._dispatch_tables))
    on_card = _row_rule(_cuda_row(), 4, 512)
    cpu = CompiledMachine(_gen(3), device="cpu")
    assert cpu._strategy(0, 512, "auto") == "scan"
    card = CompiledMachine(_gen(3), device="cpu")
    card.device = torch.device("cuda")       # decided before any launch
    assert card._strategy(0, 512, "auto") == on_card
    assert cpu._strategy(0, 512, "auto") == "scan"
    assert cpu._strategy(0, 512, "auto", device_type="cuda") == on_card
    assert card._strategy(0, 512, "auto", device_type="cpu") == "scan"
    assert cpu._strategy(0, 512, "auto", device_type="xpu") == "assoc"
    tables = CompiledMachine._dispatch_tables
    assert tables["cpu"]["derived"]["assoc_min_L_by_S"] == {}
    assert tables["cuda"] == _cuda_row()
    assert tables["xpu"] is None


@pytest.mark.parametrize("S", [3, 70])
@pytest.mark.parametrize("L", [255, 256, 10000])
def test_strategy_rules_match_jax(L, S, monkeypatch):
    """The JAX class on its CPU backend against the port's CPU machine;
    the JAX class fed the port's `cuda` row against the port's `cuda`
    rule; the JAX class's default rule (no table) against a device type
    without a row. 2D machines take "rows", non-dense ones "sparse", an
    explicit strategy is kept."""
    monkeypatch.setattr(CompiledMachine, "_dispatch_tables",
                        dict(CompiledMachine._dispatch_tables))
    jcm = JCompiled(_jmachine(json.loads(_gen(S).to_json_str())))
    tcm = CompiledMachine(_gen(S), device="cpu")
    assert tcm._strategy(0, L, "auto") == jcm._strategy(0, L, "auto")
    old = (type(jcm)._dispatch_table, type(jcm)._dispatch_table_loaded)
    try:
        for table, kind in ((_cuda_row(), "cuda"), (None, "xpu")):
            type(jcm)._dispatch_table, type(jcm)._dispatch_table_loaded = \
                table, True
            assert tcm._strategy(0, L, "auto", device_type=kind) \
                == jcm._strategy(0, L, "auto")
    finally:
        type(jcm)._dispatch_table, type(jcm)._dispatch_table_loaded = old
    assert tcm._strategy(0, L, "rows") == "rows"
    _, p2d = _prot2dna()
    assert p2d._strategy(L, L, "auto") == "rows"
    sparse_cm = CompiledMachine(_gen(S), device="cpu", dense_max_states=2)
    assert sparse_cm._strategy(0, L, "auto") == "sparse"


def _single_case(name):
    """(JAX class, port machine, pairs) for one strategy's fixture."""
    key = ("single", name)
    if key not in _cache:
        if name == "rows":
            m = testmachines.build_allclass_transducer(5, list("AC"))
            # (the JAX row engine cannot take an empty input)
            pairs = [("ACCA", "CAA"), ("CA", "C"), ("C", "")]
            kw = {}
        elif name in ("scan", "assoc"):
            m = _gen(6)
            pairs = [("", "ACGTTGCAAC"), ("", "T")]
            kw = {}
        else:
            m = testmachines.build_indel_transducer(6, list("ACGT"))
            pairs = [("ACG", "TGCA"), ("", "GA")]
            kw = {"dense_max_states": 4}
        js = json.loads(m.to_json_str())
        _cache[key] = (JCompiled(_jmachine(js), **kw),
                       CompiledMachine(m, device="cpu", **kw), pairs)
    return _cache[key]


@pytest.mark.parametrize("strategy", ["rows", "scan", "assoc", "sparse"])
def test_log_forward_and_viterbi_match_jax_and_host(strategy):
    jcm, tcm, pairs = _single_case(strategy)
    for a, b in pairs:
        got = tcm.log_forward(a, b, strategy=strategy)
        assert isinstance(got, float) and tcm.last_route == strategy
        _agree(got, jcm.log_forward(a, b, strategy=strategy), SINGLE_BOUND)
        _agree(got, _host(tcm, a, b), HOST_BOUND)
        vit = tcm.log_viterbi(a, b, strategy=strategy)
        _agree(vit, jcm.log_viterbi(a, b, strategy=strategy), SINGLE_BOUND)
        if strategy != "sparse":
            _agree(vit, _host(tcm, a, b, True), HOST_BOUND)
    if strategy != "assoc":          # "auto" on the CPU takes this one
        a, b = pairs[0]
        auto = tcm.log_forward(a, b)
        assert tcm.last_route == strategy
        assert auto == tcm.log_forward(a, b, strategy=strategy)


def test_sparse_log_viterbi_returns_forward_as_the_reference_does():
    """The JAX class's sparse branch scores Forward whatever `viterbi` is
    (machineboss_tpu/dispatch.py:120-128), so log_viterbi on a non-dense
    machine is the Forward score: the port returns what the JAX class
    returns. The sparse engine's own Viterbi is the max-plus score."""
    from machineboss_tpu_torch.ops import sparse
    jcm, tcm, pairs = _single_case("sparse")
    a, b = pairs[0]
    fwd = tcm.log_forward(a, b)
    vit = tcm.log_viterbi(a, b)
    assert tcm.last_route == "sparse"
    assert abs(vit - jcm.log_viterbi(a, b)) <= SINGLE_BOUND
    assert vit == fwd
    it, ot = [t + 1 for t in tcm.in_toks(a)], [t + 1 for t in tcm.out_toks(b)]
    best = sparse.viterbi_2d_sparse(tcm._cache["sparse"], it, ot)
    assert best <= fwd and fwd - best > 1e-3          # an ambiguous pair
    assert abs(best - _host(tcm, a, b, True)) <= HOST_BOUND


def test_log_backward_lattice_matches_jax():
    jcm, tcm, pairs = _single_case("rows")
    a, b = pairs[0]
    got = tcm.log_backward_lattice(a, b)
    assert got.shape == (len(b) + 1, len(a) + 1, tcm.ev.n_states())
    ref = np.asarray(jcm.log_backward_lattice(a, b))
    live = ref > -1e20
    assert np.array_equal(got.numpy() > -1e20, live)
    assert np.abs(got.numpy()[live] - ref[live]).max() <= SINGLE_BOUND
    assert abs(float(got[0, 0, 0]) - tcm.log_forward(a, b)) <= 5e-3


def test_module_level_functions_match_the_class():
    from machineboss_tpu_torch import dispatch
    _, tcm, pairs = _single_case("rows")
    a, b = pairs[0]
    assert dispatch.log_forward(tcm.machine, a, b, device="cpu") \
        == tcm.log_forward(a, b)
    assert dispatch.log_viterbi(tcm.machine, a, b, device="cpu") \
        == tcm.log_viterbi(a, b)


def test_device_forward_batch_matches_jax():
    """api.device_forward_batch: one batched row-engine call, against the
    JAX package's vmapped forward_2d and the port's single pairs."""
    from machineboss_tpu.api import device_forward_batch as j_dfb
    from machineboss_tpu_torch.api import device_forward_batch
    _, tcm, _ = _single_case("rows")
    pairs = [("ACCA", "CAA"), ("", "CA"), ("C", ""), ("CACAC", "AACCA")]
    js = json.loads(tcm.machine.to_json_str())
    got = device_forward_batch(tcm.machine, pairs, device="cpu")
    assert got.shape == (4,)
    ref = j_dfb(_jmachine(js), pairs)
    np.testing.assert_allclose(got, ref, rtol=0, atol=SINGLE_BOUND)
    single = [tcm.log_forward(a, b) for a, b in pairs]
    np.testing.assert_allclose(got, single, rtol=0, atol=1e-5)


@pytest.mark.parametrize("entry", ["sparse_machine", "tokenize_batch",
                                   "device_forward_batch", "log_forward",
                                   "blocked"])
def test_new_entry_points_need_the_card(entry):
    """device=None means the card: without CUDA each new entry point
    raises, and nothing carries on on the CPU."""
    from machineboss_tpu_torch import api, dispatch
    from machineboss_tpu_torch.core.seqpair import NamedSeq, SeqPair
    from machineboss_tpu_torch.ops import dp1d, fwdback, sparse
    _, tcm, _ = _single_case("rows")
    trans = np.zeros((2, 3, 3), np.float32)
    closure = np.zeros((3, 3), np.float32)
    calls = {
        "sparse_machine": lambda: sparse.SparseMachine(tcm.ev),
        "tokenize_batch": lambda: fwdback.tokenize_batch(
            tcm.ev, [SeqPair(NamedSeq("i", ["A"]), NamedSeq("o", ["C"]))]),
        "device_forward_batch": lambda: api.device_forward_batch(
            tcm.machine, [("A", "C")]),
        "log_forward": lambda: dispatch.log_forward(tcm.machine, "A", "C"),
        "blocked": lambda: dp1d.make_forward_1d_blocked(trans, closure),
    }
    if torch.cuda.is_available():
        pytest.skip("the card is present: the call would run there")
    with pytest.raises(RuntimeError, match="CUDA"):
        calls[entry]()


@pytest.mark.cuda
def test_single_pair_on_card():
    """On the card: the default rule takes assoc for a long 1D sequence
    (and the CPU row of the same process scan), and log_forward on every
    strategy matches the same engine on the CPU in float64."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from machineboss_tpu_torch.ops import dp1d, dp2d, sparse
    from machineboss_tpu_torch.ops.semiring import LOGSUMEXP
    card = CompiledMachine(_gen(6))
    cpu = CompiledMachine(_gen(6), device="cpu")
    assert card.device.type == "cuda"
    assert card._strategy(0, 512, "auto") == "assoc"
    assert cpu._strategy(0, 512, "auto") == "scan"
    rng = np.random.RandomState(1)
    seq = "".join(rng.choice(list("ACGT"), 300))
    got = card.log_forward("", seq)
    assert card.last_route == "assoc"
    trans, closure = (torch.from_numpy(np.asarray(x, np.float64))
                      for x in cpu.lowered.emit_matrices_1d(True))
    toks = torch.tensor(cpu.out_toks(seq))
    want = float(dp1d.forward_1d_scan(trans, closure, toks, len(seq)))
    assert abs(got - want) <= CARD_BOUND
    assert abs(card.log_forward("", seq, strategy="scan") - want) \
        <= CARD_BOUND
    m = testmachines.build_allclass_transducer(5, list("AC"))
    card2, cpu2 = CompiledMachine(m), CompiledMachine(m, device="cpu")
    mats = [torch.from_numpy(np.asarray(x, np.float64))
            for x in cpu2.lowered.matrices_2d()]
    a, b = "ACCAC", "CAAC"
    want = float(dp2d.forward_2d(*mats, torch.tensor(cpu2.in_toks(a)),
                                 torch.tensor(cpu2.out_toks(b)), 5, 4,
                                 sr=LOGSUMEXP))
    assert abs(card2.log_forward(a, b) - want) <= CARD_BOUND
    lat = card2.log_backward_lattice(a, b)
    assert lat.device.type == "cuda"
    assert abs(float(lat[0, 0, 0]) - want) <= CARD_BOUND
    sp_card = CompiledMachine(m, dense_max_states=2)
    sm64 = sparse.SparseMachine(cpu2.ev, dtype=np.float64, device="cpu")
    it = [t + 1 for t in cpu2.in_toks(a)]
    ot = [t + 1 for t in cpu2.out_toks(b)]
    assert abs(sp_card.log_forward(a, b)
               - sparse.forward_2d_sparse(sm64, it, ot)) <= CARD_BOUND
    from machineboss_tpu_torch.api import device_forward_batch
    res = device_forward_batch(m, [(a, b), ("C", "A")])
    assert abs(res[0] - want) <= CARD_BOUND
