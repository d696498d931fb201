"""The port's fused-Plan7 row-solve kernel route
(ops/kernels/fused_plan7_kernel.py) against the JAX Pallas kernel.

fused_plan7_forward_plain (the CPU path of make_fused_plan7_kernel, and the
card's comparison) is held to the JAX package's make_fused_plan7_pallas in
interpret mode and to its flat solver, on the toy profile (B=8, L=7, ragged,
multihit on and off) and on a 19-node amino-acid profile (K not a multiple
of 8, 20 output symbols; also with noise transducers of 1, 3 and 4
states), computing from the JAX class's tables. Bounds:
5e-4 nats against the Pallas kernel (both scaled probability in float32;
the port solves the along-k recurrence by log-depth doubling where the
Pallas kernel multiplies by its closed form, so the sums associate
differently) and 2e-3
against the flat solver (log space; the reference test's bound). On a CUDA
card the kernel is held to the plain version within 1e-3 nats, in both
layouts and every reads-a-block the plan allows, at every transducer size
it is built for, with the tables in shared memory and read from global
memory, and with ten profile nodes a lane. On the CPU the warp layout's
tables (the lanes' node records, the span products) are held to their
float64 definitions, and a host model of the warp layout's arithmetic,
reading them as the kernel does, to the plain version.

The JAX package is imported inside the tests that use it, so that the card
tests run where only torch is installed:
    python -m pytest --noconftest tests/test_torch_fused_plan7_kernel.py -m cuda
"""

import numpy as np
import pytest
import torch

from machineboss_tpu_torch import testmachines
from machineboss_tpu_torch.core.eval import EvaluatedMachine
from machineboss_tpu_torch.core.hmmer import HmmerModel
from machineboss_tpu_torch.core.machine import Machine
from machineboss_tpu_torch.ops.fused_plan7 import Plan7Fused
from machineboss_tpu_torch.ops.kernels import fused_plan7_kernel as fk

VS_PALLAS = 5e-4    # nats, plain vs the JAX kernel in interpret mode
VS_FLAT = 2e-3      # nats, plain vs the flat solvers
CARD_BOUND = 1e-3   # nats, kernel vs plain on the card
VS_F64 = 5e-3       # nats, plain vs the composed machine in float64
# (profile, multihit) with the 2-state transducer; "aminoK/St": K nodes and
# an St-state noise transducer
CASES = [("toy", False), ("toy", True), ("amino19", False),
         ("amino19", True), ("amino19/1", True), ("amino19/3", True),
         ("amino19/4", False)]
IDS = ["toy_single", "toy_multihit", "amino19_single", "amino19_multihit",
       "amino19_St1_multihit", "amino19_St3_multihit", "amino19_St4_single"]


def texts(profile):
    if profile == "toy":
        return testmachines.TOY_HMM_TEXT, testmachines.TOY_TD_JSON
    K, _, St = profile[5:].partition("/")
    return (testmachines.random_plan7_hmm_text(int(K), testmachines.AMINO,
                                               seed=3),
            testmachines.noise_transducer_json(testmachines.AMINO,
                                               int(St or 2)))


def port_model(profile, device="cpu", **config):
    text, td_json = texts(profile)
    hmm = HmmerModel()
    hmm.read(text)
    td = Machine.from_json(td_json)
    ev = EvaluatedMachine(td, td.get_param_defs(True))
    config.setdefault("length", 10.0)
    return Plan7Fused(hmm, ev, mode="plan7", device=device, **config)


def batch(f, B, L, seed):
    """Ragged reads with a read of length 1 and (L permitting) one of the
    full width; pad positions hold token 1 as forward_batch pads."""
    rng = np.random.RandomState(seed)
    toks = rng.randint(1, f.n_out, (B, L)).astype(np.int32)
    lens = rng.randint(1, L + 1, B).astype(np.int32)
    lens[0], lens[1] = 1, L
    for b in range(B):
        toks[b, lens[b]:] = 1
    return toks, lens


def jax_pair(profile, multihit):
    """(JAX Plan7Fused, port Plan7Fused on the CPU computing from the JAX
    one's tables, flat-solver tables included)."""
    from machineboss_tpu.core.eval import EvaluatedMachine as JEvaluated
    from machineboss_tpu.core.hmmer import HmmerModel as JHmmer
    from machineboss_tpu.core.machine import Machine as JMachine
    from machineboss_tpu.ops.fused_plan7 import Plan7Fused as JPlan7
    from machineboss_tpu_torch.convert import plan7_from_numpy
    text, td_json = texts(profile)
    jh = JHmmer()
    jh.read(text)
    jtd = JMachine.from_json(td_json)
    cfg = dict(mode="plan7", multihit=multihit, length=10.0, solver="prefix")
    jf = JPlan7(jh, JEvaluated(jtd, jtd.get_param_defs(True)), **cfg)
    jf._init_flat()
    tf0 = port_model(profile, multihit=multihit, solver="prefix")
    kw = {}
    if multihit:
        kw = {"mb": {n: np.asarray(v) for n, v in jf._mb.items()},
              "mloop_star": np.asarray(jf._mloop_star)}
    tf = plan7_from_numpy(
        tf0.hmm, tf0.td_ev, device="cpu",
        tables={n: np.asarray(v) for n, v in jf._j.items() if v is not None},
        em_stack=np.asarray(jf._em_stack), entry=jf._entry_np, **kw, **cfg)
    return jf, tf


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_plain_matches_pallas_interpret_and_flat(case):
    from machineboss_tpu.ops.pallas.fused_plan7_kernel import \
        make_fused_plan7_pallas
    profile, multihit = case
    jf, tf = jax_pair(profile, multihit)
    assert tf.St == jf.St == (int(profile[8:]) if "/" in profile else 2)
    B, L = (8, 7) if profile == "toy" else (8, 12)
    toks, lens = batch(tf, B, L, seed=1)
    want = make_fused_plan7_pallas(jf, B, L, interpret=True)(toks, lens)
    flat_j = jf.forward_batch_tokens(toks, lens, impl="flat")
    got = fk.make_fused_plan7_kernel(tf, B, L)(toks, lens)
    assert got.dtype == np.float64 and got.shape == (B,)
    assert np.abs(got - want).max() <= VS_PALLAS, (want, got)
    assert np.abs(got - flat_j).max() <= VS_FLAT
    flat_t = tf.forward_batch_tokens(toks, lens, impl="flat")
    assert np.abs(got - flat_t).max() <= VS_FLAT
    # the public entries on the CPU: the kernel route runs the plain version
    for impl in ("kernel", "pallas"):
        again = tf.forward_batch_tokens(toks, lens, impl=impl)
        assert np.array_equal(again, got)
    for o in tf.forward_stream([(toks, lens)] * 2, impl="pallas"):
        assert np.array_equal(o, got)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_prepared_operands_match_the_pallas_factory(case):
    """prepare_fused_plan7's probability-space operands from the port's own
    tables: the shapes of the layout the CUDA source reads, and the values
    the JAX factory bakes (checked through the result above; here the
    doubling's matrices against the prefix matrix they factor)."""
    profile, multihit = case
    f = port_model(profile, multihit=multihit, solver="prefix")
    host = fk.prepare_fused_plan7(f)
    K, St, n_sym = f.K, f.St, f.n_out - 1
    assert (host["K"], host["St"], host["n_sym"]) == (K, St, n_sym)
    assert host["consts"].shape == (4 * St * St + St + 3
                                    + 2 * n_sym * St * St,)
    assert host["ksc"].shape == (len(fk.KSC_NAMES), K)
    assert host["kco"].shape == (len(fk.KCO_NAMES), K, St, St)
    n_lev = fk.n_levels(K)
    assert host["alev"].shape == (n_lev, K, 3 * St, 3 * St)
    assert (1 << n_lev) >= K > (1 << n_lev) // 2
    assert host["emm"].shape == host["emi"].shape == (n_sym, K, St, St)
    assert all(v.dtype == np.float32 for v in host.values()
               if isinstance(v, np.ndarray))
    assert (host["kco"][3:] != 0).any() == multihit
    # carry = b @ t_tri is the solution of carry_k = b_k + carry_{k-1} A_k
    t_tri = np.exp(f._j["t_tri"].double().numpy())
    t_tri[f._j["t_tri"].numpy() < -1e29] = 0.0
    rng = np.random.RandomState(0)
    b = rng.uniform(0, 1, (K, 3 * St))
    carry = b.copy()
    for lev in range(n_lev):
        off = 1 << lev
        assert not host["alev"][lev, :off].any()
        carry[off:] += np.einsum(
            "ks,ksd->kd", carry[:-off], host["alev"][lev, off:], dtype=np.float64)
    np.testing.assert_allclose(carry.reshape(-1), b.reshape(-1) @ t_tri,
                               rtol=1e-5)
    # the kernel's layout of the same matrices, as a card would get it:
    # made at the first ask, beside the warp layout's host tables
    ops = fk.plan7_operands(host, torch.device("cpu"))
    assert ops.tables == {}
    na = 9 * St * St
    w = 4 if na % 4 == 0 else 1
    (alev_k,) = fk.layout_tables(ops, "node_doubling")
    assert alev_k.shape == (n_lev, na // w, K, w)
    for lev in range(n_lev):
        for k in (0, K - 1):
            assert np.array_equal(alev_k[lev, :, k].numpy().reshape(-1),
                                  host["alev"][lev, k].reshape(-1))
    for got, n in zip(fk.layout_tables(ops, "warp"), ("ntab", "span", "pan")):
        assert np.array_equal(got.numpy(), host[n])
    assert set(ops.tables) == {"warp", "node_doubling"}


def test_scan_solver_models_take_the_kernel_route():
    """A profile built with solver='scan' has no prefix matrix; the kernel
    route solves the recurrence itself and serves it all the same."""
    f_scan = port_model("amino19", multihit=True, solver="scan")
    f_pref = port_model("amino19", multihit=True, solver="prefix")
    assert f_scan._kernel_supported()
    toks, lens = batch(f_scan, 6, 10, seed=2)
    a = f_scan.forward_batch_tokens(toks, lens, impl="kernel")
    b = f_pref.forward_batch_tokens(toks, lens, impl="kernel")
    assert np.array_equal(a, b)
    vmap = f_scan.forward_batch_tokens(toks, lens)        # auto: per read
    assert np.abs(a - vmap).max() <= VS_FLAT


@pytest.mark.parametrize("multihit", [False, True])
def test_dead_read_zero_token_and_empty_read(multihit):
    """A read that cannot be emitted is dead in the plain version (-1e30)
    and impossible in the flat solver; token 0 inside a read contributes
    nothing (dead); a read of length 0 scores the empty output."""
    text, _ = texts("toy")
    hmm = HmmerModel()
    hmm.read(text)
    td_json = {"state": [
        {"id": "loop", "trans": [
            {"in": c, "out": c, "to": "loop", "weight": 0.2} for c in "ACGT"]
            + [{"out": "T", "to": "loop", "weight": 0.01},
               {"to": "end", "weight": 0.1}]},
        {"id": "end", "trans": []}]}
    td = Machine.from_json(td_json)
    ev = EvaluatedMachine(td, td.get_param_defs(True))
    # no state of the profile emits C, and the transducer only copies
    for node in hmm.node:
        node.match_emit[1] = node.ins_emit[1] = 0.0
    hmm.null_emit[1] = hmm.ins0_emit[1] = 0.0
    f = Plan7Fused(hmm, ev, mode="plan7", multihit=multihit, length=10.0,
                   device="cpu")
    s2t = ev.output_tokenizer.sym2tok
    toks = np.ones((4, 5), np.int32)
    toks[0, :3] = [s2t["A"], s2t["G"], s2t["T"]]
    toks[1, :3] = [s2t["A"], s2t["C"], s2t["G"]]      # C cannot be emitted
    toks[2, :3] = [s2t["A"], 0, s2t["G"]]             # token 0 in the read
    lens = np.array([3, 3, 3, 0], np.int32)
    got = f.forward_batch_tokens(toks, lens, impl="kernel")
    flat = f.forward_batch_tokens(toks, lens, impl="flat")
    assert got[1] == fk.NEG_INF and got[2] == fk.NEG_INF
    assert flat[1] < -1e29
    assert abs(got[0] - flat[0]) <= VS_FLAT and got[0] > -100
    assert abs(got[3] - flat[3]) <= VS_FLAT and got[3] > -100
    assert abs(got[3] - f.forward([])) <= VS_FLAT
    ops = fk.plan7_operands(fk.prepare_fused_plan7(f), torch.device("cpu"))
    raw = fk.fused_plan7_forward_plain(ops, torch.from_numpy(toks),
                                       torch.from_numpy(lens))
    assert raw.shape == (3, 4) and raw.dtype == torch.float32
    assert raw[2].tolist() == [0.0, 1.0, 1.0, 0.0]
    assert raw[1, 3] == 0.0                            # no row, no exponent


def test_decode():
    out = np.array([[1.5, 0.0, 2.0, 1.0], [-3.0, 5.0, 1.0, 0.0],
                    [0.0, 0.0, 1.0, 0.0]])
    ll = fk.decode(out)
    assert ll[0] == pytest.approx(np.log(1.5) - 3 * np.log(2.0))
    assert ll[1] == fk.NEG_INF and ll[2] == fk.NEG_INF and ll[3] == 0.0
    assert fk.decode(out, 2).shape == (2,)


@pytest.mark.parametrize("St,multihit", [(3, False), (3, True), (4, True)])
def test_plain_matches_the_composed_oracle_for_wider_transducers(St, multihit):
    """3- and 4-state noise transducers on a 5-node DNA profile: the plain
    version against the composed machine's float64 Forward."""
    from machineboss_tpu_torch.algo.dp_host import ForwardMatrix
    from machineboss_tpu_torch.core.seqpair import NamedSeq, SeqPair
    dna = list("ACGT")
    hmm = HmmerModel()
    hmm.read(testmachines.random_plan7_hmm_text(5, dna, seed=3))
    td = Machine.from_json(testmachines.noise_transducer_json(dna, St))
    ev = EvaluatedMachine(td, td.get_param_defs(True))
    f = Plan7Fused(hmm, ev, mode="plan7", multihit=multihit, length=10.0,
                   device="cpu")
    assert f.St == St
    toks, lens = batch(f, 5, 6, seed=4)
    got = f.forward_batch_tokens(toks, lens, impl="kernel")
    comp = Machine.compose(hmm.plan7_machine(multihit=multihit, length=10.0),
                           td)
    cev = EvaluatedMachine(comp, comp.get_param_defs(True))
    t2s = ev.output_tokenizer.tok2sym
    ref = [ForwardMatrix(cev, SeqPair(NamedSeq("i", []), NamedSeq(
        "o", [t2s[x] for x in toks[b, :lens[b]]]))).log_like()
        for b in range(len(lens))]
    assert np.abs(got - np.array(ref)).max() <= VS_F64


# (reads a block, nodes a lane, scan levels, (node records, span products,
# panels) in shared memory) of the warp layout, the default up to
# WARP_DEFAULT_MAX_K = 512 nodes; past that, or when asked for, the
# node-doubling layout's (reads a block, threads a read, tables in smem)
@pytest.mark.parametrize("K,St,n_sym,B,n_sm,layout,expect", [
    (86, 2, 20, 1024, 132, None, (8, 3, 5, (True, True, True))),  # fn3's
    (3, 2, 4, 8, 132, None, (1, 1, 2, (True, True, True))),  # a block a read
    (19, 2, 20, 4000, 132, None, (8, 1, 5, (True, True, True))),  # 8 warps
    (19, 4, 20, 16, 132, None, (1, 1, 5, (True, True, True))),
    (86, 4, 20, 1024, 132, None, (8, 3, 5, (True, True, False))),  # panels
    (128, 2, 20, 1024, 132, None, (8, 4, 5, (True, True, True))),
    (129, 2, 20, 1024, 132, None, (8, 5, 5, (True, True, True))),
    (300, 2, 20, 1024, 132, None, (8, 10, 5, (True, True, False))),
    (300, 3, 20, 1024, 132, None, (8, 10, 5, (True, False, False))),
    (512, 2, 20, 1024, 132, None, (8, 16, 5, (True, True, False))),
    (513, 2, 20, 1024, 132, None, (3, 256, False)),  # past the warp's 512
    (600, 2, 20, 1024, 132, None, (2, 256, False)),
    (300, 2, 20, 1024, 132, "node_doubling", (3, 256, False)),
])
def test_launch_plan(K, St, n_sym, B, n_sm, layout, expect):
    plan = fk.launch_plan(K, St, n_sym, B, n_sm, layout=layout)
    assert plan["layout"] == (layout or fk.default_layout(K))
    assert plan["smem"] <= fk._SMEM_LIMIT
    if plan["layout"] == "node_doubling":
        R, TPR, tables = plan["reads"], plan["threads_per_read"], \
            plan["tables"]
        assert (R, TPR, tables) == expect
        assert R * TPR <= fk._MAX_THREADS and R <= fk._MAX_READS
        assert plan["smem"] == 4 * fk._smem_floats(K, St, n_sym, R, TPR,
                                                   tables)
        return
    assert plan["layout"] == "warp"
    assert (plan["reads"], plan["chunk"], plan["lane_levels"],
            tuple(plan["in_smem"].values())) == expect
    assert plan["chunk"] == -(-K // 32) and plan["reads"] <= 8
    assert (1 << plan["lane_levels"]) >= -(-K // plan["chunk"])
    assert plan["smem"] == 4 * fk.warp_smem_floats(K, St, n_sym,
                                                   plan["in_smem"])


def test_launch_plan_forced_reads_per_block():
    assert fk.launch_plan(3, 2, 4, 8, 132, reads_per_block=8)["reads"] == 8
    with pytest.raises(ValueError, match="reads_per_block"):
        fk.launch_plan(86, 2, 20, 64, 132, reads_per_block=9)
    # 3,000 nodes at 4 states: no read's state fits shared memory, so the
    # node-doubling layout keeps it in global memory; forced, it raises
    with pytest.raises(ValueError, match="shared"):
        fk.launch_plan(3000, 4, 20, 8, 132, state="shared")
    big = fk.launch_plan(3000, 4, 20, 8, 132)
    assert (big["layout"], big["state"], big["tables"]) == \
        ("node_doubling", "global", False)
    assert big["smem"] == 4 * fk._smem_floats(3000, 4, 20, big["reads"], 256,
                                              False, "global")
    # the node-doubling layout keeps its own limits when asked for
    nodes = fk.launch_plan(86, 2, 20, 1024, 132, layout="node_doubling")
    assert (nodes["reads"], nodes["threads_per_read"], nodes["tables"]) == \
        (8, 96, True)
    assert fk.launch_plan(19, 2, 20, 4000, 132,
                          layout="node_doubling")["reads"] == 15
    with pytest.raises(ValueError, match="512"):
        fk.launch_plan(600, 2, 20, 8, 132, layout="warp")
    with pytest.raises(ValueError, match="layout"):
        fk.launch_plan(86, 2, 20, 8, 132, layout="lanes")


@pytest.mark.parametrize("K", [1, 31, 32, 33, 86, 300])
def test_span_products_are_the_float64_products_of_a(K):
    """Level l of lane c holds A_k over the 2^l chunks ending at chunk c,
    multiplied in float64 (A_k = 0 past K); zero below lane 2^l."""
    St = 2
    rng = np.random.RandomState(K)
    a = rng.uniform(0.0, 1.0, (K, 3 * St, 3 * St))
    a *= 0.9 / a.sum(axis=-1, keepdims=True)   # substochastic, as exp(a_mat)
    C = fk.warp_chunk(K)
    n_chunks = -(-K // C)
    span = fk.span_products(a, K)
    assert span.shape == (fk.lane_levels(K), 32, 3 * St, 3 * St)
    assert (1 << len(span)) >= n_chunks and \
        (len(span) == 0 or (1 << (len(span) - 1)) < n_chunks)
    pad = np.concatenate([a, np.zeros((32 * C - K, 3 * St, 3 * St))])
    for lev in range(len(span)):
        for c in range(32):
            if c < (1 << lev):          # no lane c - 2^l to add from
                assert not span[lev, c].any()
                continue
            first = (c - (1 << lev) + 1) * C
            want = np.eye(3 * St)
            for k in range(first, (c + 1) * C):
                want = want @ pad[k]
            np.testing.assert_allclose(span[lev, c], want, rtol=1e-12,
                                       atol=1e-300)
    # laid out as the kernel reads them: (levels, span/4, 32, 4)
    host_span = fk.warp_tables(np.zeros((7, K)), np.zeros((8, K, St, St)), a,
                               np.zeros((1, K, St, St)),
                               np.zeros((1, K, St, St)))[1]
    f = host_span.shape[1] * 4
    got = host_span.transpose(0, 2, 1, 3).reshape(len(span), 32, f)
    np.testing.assert_array_equal(got[..., :9 * St * St],
                                  span.reshape(len(span), 32, 9 * St * St))
    assert not got[..., 9 * St * St:].any()


@pytest.mark.parametrize("case", CASES[:4] + [("amino33", True)],
                         ids=IDS[:4] + ["amino33_multihit"])
def test_warp_tables_hold_each_lanes_nodes(case):
    """ntab and pan, read as the kernel reads them (lane c's j-th node is
    node cC + j, float4 q at [j, q, c]), give back prepare_fused_plan7's
    scalars, matrices, A_k and panels; nodes past K are zero."""
    profile, multihit = case
    f = port_model(profile, multihit=multihit, solver="prefix")
    host = fk.prepare_fused_plan7(f)
    K, St, n_sym = host["K"], host["St"], host["n_sym"]
    C, N = fk.warp_chunk(K), St * St
    ntab, pan = host["ntab"], host["pan"]
    assert ntab.shape == (C, fk._rec_floats(St) // 4, 32, 4)
    assert pan.shape == (n_sym, C, fk._pan_floats(St) // 4, 32, 4)
    a32 = np.exp(f._j["a_mat"].double().numpy())
    a32[f._j["a_mat"].numpy() < -1e29] = 0.0
    for k in range(32 * C):
        c, j = divmod(k, C)
        rec = ntab[j, :, c, :].reshape(-1)
        prec = pan[:, j, :, c, :].reshape(n_sym, -1)
        if k >= K:
            assert not rec.any() and not prec.any()
            continue
        np.testing.assert_array_equal(rec[:7], host["ksc"][:, k])
        np.testing.assert_array_equal(rec[8:8 + 8 * N],
                                      host["kco"][:, k].reshape(-1))
        np.testing.assert_allclose(rec[8 + 8 * N:8 + 17 * N],
                                   a32[k].reshape(-1), rtol=1e-6)
        np.testing.assert_array_equal(prec[:, :N],
                                      host["emm"][:, k].reshape(n_sym, -1))
        np.testing.assert_array_equal(prec[:, N:2 * N],
                                      host["emi"][:, k].reshape(n_sym, -1))


def warp_layout_model(host, toks, lens):
    """The warp layout's row solve in float64 on the host, reading ntab,
    span and pan as csrc/fused_plan7.cu does: a lane-serial pass over each
    lane's chunk, the scan of the chunk ends across the 32 lanes with the
    span products, and a second lane-serial pass from the carry into the
    chunk. Returns (3, B) as the kernel does."""
    K, St, n_sym = host["K"], host["St"], host["n_sym"]
    mh = host["multihit"]
    N, D3 = St * St, 3 * St
    C, n_lev = fk.warp_chunk(K), fk.lane_levels(K)
    ntab, span, pan, c = (host[n].astype(np.float64)
                          for n in ("ntab", "span", "pan", "consts"))

    def rec(tab, lane, j):
        return tab[j, :, lane, :].reshape(-1)

    cloop, enull0, mstar, mbe = (c[i * N:(i + 1) * N].reshape(St, St)
                                 for i in range(4))
    first = c[4 * N:4 * N + St]
    loop_s, exit_s, e_to_c = c[4 * N + St:4 * N + St + 3]
    at = 4 * N + St + 3
    ty0 = c[at:at + n_sym * N].reshape(n_sym, St, St)
    eny0 = c[at + n_sym * N:].reshape(n_sym, St, St)
    out = np.zeros((3, toks.shape[0]))
    for b in range(toks.shape[0]):
        X = np.zeros((32, C, 5, St))
        fl = np.zeros((9, St))
        expo, dead, inv_x = 0, False, 1.0
        for row in range(-1, int(lens[b])):
            y = int(toks[b, row]) - 1 if row >= 0 else -1
            y = y if 0 <= y < n_sym else -1
            ty = ty0[y] if y >= 0 else np.zeros((St, St))
            eny = eny0[y] if y >= 0 else np.zeros((St, St))
            cold_f = fl @ ty
            nx_in = cold_f[0] @ enull0 + fl[0] @ eny + (first if row < 0
                                                         else 0.0)
            nx_hot = nx_in @ cloop
            b0 = exit_s * nx_hot
            bm, bi, ia = (np.zeros((32, C, St)) for _ in range(3))
            loc = np.zeros((32, D3))
            for lane in range(32):
                for j in range(C):
                    r = rec(ntab, lane, j)
                    ks, mats = r[:8], r[8:8 + 8 * N].reshape(8, St, St)
                    A = r[8 + 8 * N:8 + 17 * N].reshape(D3, D3)
                    x = X[lane, j] * inv_x
                    cold = x @ ty
                    p = rec(pan[max(y, 0)], lane, j)
                    hot_m = x[0] @ p[:N].reshape(St, St) if y >= 0 else 0.0
                    hot_i = x[2] @ p[N:2 * N].reshape(St, St) if y >= 0 \
                        else 0.0
                    entry = 0.0 if mh else ks[0]
                    bmx = (entry * b0 + cold[0]) @ mats[0] + hot_m
                    ixa = cold[2] @ mats[1] + hot_i
                    bix = ((ks[1] * bmx + ks[2] * ixa) @ mats[2]) @ mats[1] \
                        + ixa
                    bm[lane, j], bi[lane, j], ia[lane, j] = bmx, bix, ixa
                    X[lane, j] = cold
                    loc[lane] = np.concatenate([bmx, bix, np.zeros(St)]) \
                        + loc[lane] @ A
            for lev in range(n_lev):
                off, prev = 1 << lev, loc.copy()
                for lane in range(off, 32):
                    sp = rec(span[lev][None], lane, 0)[:D3 * D3]
                    loc[lane] = prev[lane] + prev[lane - off] @ \
                        sp.reshape(D3, D3)
            ep = np.zeros(St)
            for lane in range(32):
                p = loc[lane - 1] if lane else np.zeros(D3)
                for j in range(C):
                    r = rec(ntab, lane, j)
                    ks, mats = r[:8], r[8:8 + 8 * N].reshape(8, St, St)
                    A = r[8 + 8 * N:8 + 17 * N].reshape(D3, D3)
                    entry = 0.0 if mh else ks[0]
                    cc = np.concatenate([bm[lane, j], bi[lane, j],
                                         np.zeros(St)]) + p @ A
                    m_h = ks[3] * p[:St] + ks[4] * p[St:2 * St] \
                        + ks[5] * p[2 * St:] + entry * b0
                    i_h = (ks[1] * cc[:St] + ks[2] * ia[lane, j]) @ mats[2]
                    ep += m_h + cc[2 * St:] + ks[6] * cc[St:2 * St]
                    X[lane, j] += np.stack([m_h, cc[:St], i_h,
                                            cc[St:2 * St], cc[2 * St:]])
                    p = cc
            if mh:
                jxb = cold_f[6] @ enull0 + fl[6] @ eny + 0.5 * ep
                b_hot = (b0 + exit_s * (jxb @ cloop)) @ mstar
                be = b_hot @ mbe
                e_hot, jx_hot = ep + be, (jxb + 0.5 * be) @ cloop
                j_hot = loop_s * jx_hot
                for lane in range(32):
                    for j in range(C):
                        mats = rec(ntab, lane, j)[8:8 + 8 * N] \
                            .reshape(8, St, St)
                        for blk in range(5):
                            X[lane, j, blk] += b_hot @ mats[3 + blk]
            else:
                b_hot, e_hot = b0, ep
                jx_hot = j_hot = np.zeros(St)
            cx_hot = (cold_f[4] @ enull0 + fl[4] @ eny + e_to_c * e_hot) \
                @ cloop
            fl = cold_f + np.stack([loop_s * nx_hot, nx_hot, b_hot, e_hot,
                                    loop_s * cx_hot, cx_hot, j_hot, jx_hot,
                                    exit_s * cx_hot])
            if row >= 0:
                m = max(X.max(), fl.max(), 0.0)
                kexp = int(np.frexp(np.float32(m if m > 0 else 1.0))[1]) \
                    + 126
                inv_x = 2.0 ** (127 - kexp)
                fl *= inv_x
                expo += kexp - 127
                dead = dead or not m > 0
        out[:, b] = fl[8, St - 1], expo, float(dead)
    return out


@pytest.mark.parametrize("case", CASES + [("amino33", True),
                                          ("amino40/4", False)],
                         ids=IDS + ["amino33_multihit", "amino40_St4_single"])
def test_warp_layout_host_model_matches_plain(case):
    """The warp layout's arithmetic (chunks of nodes a lane, the span
    scan across lanes) on the host in float64 from its float32 tables,
    against the plain version: the tables' layout and the scan's algebra,
    which only the card runs in CUDA. K=33 and 40 give two nodes a lane,
    K=33 a lane with a padding node."""
    profile, multihit = case
    f = port_model(profile, multihit=multihit, solver="prefix")
    host = fk.prepare_fused_plan7(f)
    toks, lens = batch(f, 4, 6, seed=3)
    toks[2, 0] = 0                                    # a dead read
    ops = fk.plan7_operands(host, torch.device("cpu"))
    plain = fk.fused_plan7_forward_plain(ops, torch.from_numpy(toks),
                                         torch.from_numpy(lens)).numpy()
    model = warp_layout_model(host, toks, lens)
    assert np.array_equal(model[2], plain[2]) and model[2, 2] == 1.0
    assert np.abs(fk.decode(model) - fk.decode(plain)).max() <= 1e-5


def test_unsupported_configurations_raise():
    text, td_json = texts("toy")
    hmm = HmmerModel()
    hmm.read(text)
    td = Machine.from_json(td_json)
    ev = EvaluatedMachine(td, td.get_param_defs(True))
    for cfg in (dict(mode="core"), dict(mode="plan7", semiring="maxplus")):
        f = Plan7Fused(hmm, ev, device="cpu", **cfg)
        assert not f._kernel_supported()
        with pytest.raises(ValueError, match="plan7/local/Forward"):
            f.forward_batch_tokens(np.ones((1, 2), np.int32), [2],
                                   impl="kernel")
    f = port_model("toy")
    with pytest.raises(ValueError, match="shape"):
        fk.make_fused_plan7_kernel(f, 2, 3).device_call(
            torch.ones((2, 4), dtype=torch.int32),
            torch.ones(2, dtype=torch.int32))


# ------------------------------------------------------------- on the card

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("layout,reads_per_block",
                         [("warp", r) for r in (None, 1, 2, 3, 4, 5, 6, 7, 8)]
                         + [("node_doubling", None), ("node_doubling", 8)])
@pytest.mark.parametrize("case", CASES[:4] + [("amino86", True)],
                         ids=IDS[:4] + ["amino86_multihit"])
def test_cuda_kernel_matches_plain(case, layout, reads_per_block):
    dev = _card()
    profile, multihit = case
    f = port_model(profile, device=dev, multihit=multihit)
    ops = fk.plan7_operands(fk.prepare_fused_plan7(f), dev)
    B, L = (8, 7) if profile == "toy" else (16, 24)
    toks, lens = batch(f, B, L, seed=5)
    toks[3, 0] = 0                                    # a dead read
    t = torch.from_numpy(toks).to(dev)
    n = torch.from_numpy(lens).to(dev)
    before = fk.fused_plan7_forward_kernel.launches
    kern = fk.fused_plan7_forward_kernel(ops, t, n, layout=layout,
                                         reads_per_block=reads_per_block)
    torch.cuda.synchronize()
    assert fk.fused_plan7_forward_kernel.launches == before + 1
    plain = fk.fused_plan7_forward_plain(ops, t, n)
    assert torch.equal(kern[2], plain[2]) and kern[2, 3] == 1.0
    kll, pll = fk.decode(kern.cpu().numpy()), fk.decode(plain.cpu().numpy())
    live = pll > -1e29
    assert np.abs(kll[live] - pll[live]).max() <= CARD_BOUND
    assert np.array_equal(kll[~live], pll[~live])
    flat = f.forward_batch_tokens(toks, lens, impl="flat")
    assert np.abs(kll[live] - flat[live]).max() <= VS_FLAT


# what only these reach in csrc/fused_plan7.cu's warp layout: the
# instantiations for 1, 3 and 4 states (records whose matrices straddle
# float4s at 1 and 3), the panels read from global memory (they do not fit
# beside the node records and span products at K=86 with 4 states, nor at
# K=300 with 2 or 3; at K=300 with 3 the span products neither), ten nodes
# a lane (K=300: the local-memory instantiation); each also in the
# node-doubling layout
WIDE = [("amino19/1", True, 16, True), ("amino19/3", True, 16, True),
        ("amino19/3", False, 16, True), ("amino19/4", True, 16, True),
        ("amino86/4", True, 16, False), ("amino300", True, 8, False),
        ("amino300/3", False, 8, False), ("amino300/1", True, 8, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", WIDE, ids=[
    "%s_%s" % (c[0].replace("/", "_St"), "multihit" if c[1] else "single")
    for c in WIDE])
def test_cuda_kernel_other_state_counts_and_table_placements(case):
    dev = _card()
    profile, multihit, B, tables = case
    f = port_model(profile, device=dev, multihit=multihit)
    ops = fk.plan7_operands(fk.prepare_fused_plan7(f), dev)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    plan = fk.launch_plan(f.K, f.St, ops.n_sym, B, n_sm, layout="warp")
    assert plan["in_smem"]["panels"] == tables
    assert (plan["chunk"] > 4) == (f.K == 300)
    toks, lens = batch(f, B, 24, seed=7)
    toks[3, 0] = 0                                    # a dead read
    t = torch.from_numpy(toks).to(dev)
    n = torch.from_numpy(lens).to(dev)
    plain = fk.fused_plan7_forward_plain(ops, t, n)
    pll = fk.decode(plain.cpu().numpy())
    live = pll > -1e29
    assert live.sum() == B - 1
    flat = f.forward_batch_tokens(toks, lens, impl="flat")
    for layout in ("warp", "node_doubling"):
        kern = fk.fused_plan7_forward_kernel(ops, t, n, layout=layout)
        assert torch.equal(kern[2], plain[2]) and kern[2, 3] == 1.0
        kll = fk.decode(kern.cpu().numpy())
        assert np.abs(kll[live] - pll[live]).max() <= CARD_BOUND
        assert np.array_equal(kll[~live], pll[~live])
        assert np.abs(kll[live] - flat[live]).max() <= VS_FLAT


@pytest.mark.cuda
def test_cuda_auto_takes_the_kernel_and_streams():
    dev = _card()
    f = port_model("amino19", device=dev, multihit=True)
    toks, lens = batch(f, 16, 12, seed=6)
    fk.fused_plan7_forward_kernel.launches = 0
    got = f.forward_batch_tokens(toks, lens)
    assert fk.fused_plan7_forward_kernel.launches == 1
    outs = f.forward_stream([(toks, lens)] * 3)
    assert fk.fused_plan7_forward_kernel.launches == 4
    for o in outs:
        assert np.array_equal(o, got)
    cpu = port_model("amino19", multihit=True)
    want = cpu.forward_batch_tokens(toks, lens, impl="kernel")
    assert np.abs(got - want).max() <= CARD_BOUND
    vit = port_model("amino19", device=dev, multihit=True, semiring="maxplus")
    vit.forward_batch_tokens(toks, lens)               # auto: the flat solver
    assert fk.fused_plan7_forward_kernel.launches == 4


@pytest.mark.cuda
def test_cuda_wrapper_refuses_what_the_kernel_does_not_take():
    dev = _card()
    f = port_model("toy", device=dev)
    ops = fk.plan7_operands(fk.prepare_fused_plan7(f), dev)
    toks = torch.ones((2, 4), dtype=torch.int64, device=dev)
    lens = torch.ones(2, dtype=torch.int32, device=dev)
    with pytest.raises((TypeError, ValueError)):
        fk.fused_plan7_forward_kernel(ops, toks, lens)


@pytest.mark.cuda
@pytest.mark.parametrize("case", [("amino86", True), ("amino300/3", False)],
                         ids=["amino86_multihit", "amino300_St3_single"])
def test_cuda_global_state_matches_shared_state(case):
    """The node-doubling layout with each read's state in global memory and
    the per-node tables read from there: the same sums in the same order
    as with them in shared memory, so the result is equal bit for bit."""
    dev = _card()
    profile, multihit = case
    f = port_model(profile, device=dev, multihit=multihit)
    ops = fk.plan7_operands(fk.prepare_fused_plan7(f), dev)
    toks, lens = batch(f, 16, 24, seed=8)
    toks[3, 0] = 0                                    # a dead read
    t = torch.from_numpy(toks).to(dev)
    n = torch.from_numpy(lens).to(dev)
    want = fk.fused_plan7_forward_kernel(ops, t, n, layout="node_doubling",
                                         state="shared")
    got = fk.fused_plan7_forward_kernel(ops, t, n, layout="node_doubling",
                                        state="global")
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("profile", ["amino1200", "amino1000/4"])
def test_cuda_long_profile_matches_plain(profile):
    """A profile past what shared memory holds of a read's state (918
    nodes at 2 states, 512 at 4): the plan keeps the state in global
    memory, and the kernel is within 1e-3 nats of the plain version."""
    dev = _card()
    f = port_model(profile, device=dev, multihit=True)
    ops = fk.plan7_operands(fk.prepare_fused_plan7(f), dev)
    B = 8
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    plan = fk.launch_plan(f.K, f.St, ops.n_sym, B, n_sm)
    assert plan["layout"] == "node_doubling" and plan["state"] == "global"
    assert fk.state_floats_on_card(f.K, f.St) == fk._state_floats(f.K, f.St)
    toks, lens = batch(f, B, 40, seed=9)
    toks[3, 0] = 0                                    # a dead read
    t = torch.from_numpy(toks).to(dev)
    n = torch.from_numpy(lens).to(dev)
    before = fk.fused_plan7_forward_kernel.launches
    kern = fk.fused_plan7_forward_kernel(ops, t, n)
    torch.cuda.synchronize()
    assert fk.fused_plan7_forward_kernel.launches == before + 1
    plain = fk.fused_plan7_forward_plain(ops, t, n)
    assert torch.equal(kern[2], plain[2]) and kern[2, 3] == 1.0
    kll, pll = fk.decode(kern.cpu().numpy()), fk.decode(plain.cpu().numpy())
    live = pll > -1e29
    assert live.sum() == B - 1
    assert np.abs(kll[live] - pll[live]).max() <= CARD_BOUND
