"""The port's other wavefront variants (chained, generic, seqscale,
factored) against the JAX kernels and the f64 oracle.

chained_forward_plain, generic_forward_plain, seqscale_forward_plain and
factored_forward_plain (the CPU paths of make_wavefront_forward with
variant="chained", merged=False, variant="seqscale" and variant="factored")
are held to the JAX package's make_wavefront_forward in its own CPU mode
(interpret=True) and to forward_2d_f64, on numpy-seeded inputs and the
fixtures of tests/test_pallas_kernel.py. Bounds: 2e-3 nats for chained,
generic and seqscale (the merged family's bound in the JAX tests), 5e-3 for
factored (signed SVD factors, as the lowrank kernel) and on the deep chain
with an odd stagger (the odd-start bound). The host prep is held bit-equal
to the tensors the JAX factory hands its kernel. On a CUDA card each kernel
is held to its plain version at 1e-3 nats (the same f32 recurrence, summed
in another order); seqscale bit for bit. On the CPU, the generic kernel's
launch plan is checked, and the seqscale kernel's max bookkeeping is
emulated in torch and held bit-equal to the plain version.

The JAX package is imported inside the tests that use it, so that the card
tests run where only torch is installed:
    python -m pytest --noconftest tests/test_torch_wavefront_variants.py -m cuda
"""

import types

import numpy as np
import pytest
import torch

from machineboss_tpu_torch import testmachines
from machineboss_tpu_torch.core.eval import EvaluatedMachine
from machineboss_tpu_torch.core.machine import Machine
from machineboss_tpu_torch.core.presets import make_preset
from machineboss_tpu_torch.ops.host_oracle import forward_2d_f64
from machineboss_tpu_torch.ops.kernels import wavefront_kernel as wk
from machineboss_tpu_torch.ops.lowering import LoweredMachine
from one_thread import one_torch_thread  # noqa: F401

BOUND = 2e-3         # nats, the merged family vs f64 and vs the JAX kernels
FACTORED_BOUND = 5e-3    # nats, signed SVD factors
ODD_BOUND = 5e-3     # nats, the S=64 deep chain
CARD_BOUND = 1e-3    # nats, kernel vs plain on the card

# the End state has symbol-consuming incoming transitions: no sink trim
UNTRIMMED = {"state": [
    {"id": "s", "trans": [
        {"in": a, "out": b, "to": "t", "weight": 0.3 if a == b else 0.1}
        for a in "AC" for b in "AC"
    ] + [{"in": "A", "out": "C", "to": "e", "weight": 0.2},
         {"out": "A", "to": "e", "weight": 0.05}]},
    {"id": "t", "trans": [
        {"in": "C", "to": "s", "weight": 0.5},
        {"out": "C", "to": "s", "weight": 0.25},
        {"in": "A", "out": "A", "to": "e", "weight": 0.15}]},
    {"id": "e", "trans": []}]}

# the unchained variants' cases (_case sets their shapes and lengths)
CASES = ["indel", "allclass", "dense8", "untrimmed", "edges", "dense6",
         "prot2dna", "odd_start"]
# uniform cases for the chained schedule: name -> chain
CHAINED = {"allclass_c3": 3, "indel_c3": 3, "dense6_c3": 3, "dense6_c1": 1,
           "dense6_c5": 5, "dense8_c2": 2, "impossible_c2": 2}
_cache = {}


def _machine(kind):
    if kind == "indel":
        return testmachines.build_indel_transducer(6, list("ACGT"))
    if kind == "allclass":
        return testmachines.build_allclass_transducer(5, list("AC"))
    if kind == "dense8":
        return testmachines.build_random_transducer(8, list("ACGT"), seed=15)
    if kind == "dense6":
        return testmachines.build_random_transducer(6, list("ACGT"), seed=3)
    if kind == "dense6_7":
        return testmachines.build_random_transducer(6, list("ACGT"), seed=7)
    if kind == "dense64":
        return testmachines.build_random_transducer(64, list("ACGT"),
                                                    seed=42)
    if kind == "untrimmed":
        return Machine.from_json(UNTRIMMED)
    return make_preset("prot2dna")


def _lowered(kind):
    key = ("mats", kind)
    if key not in _cache:
        m = _machine(kind)
        ev = EvaluatedMachine(m, m.get_param_defs(True))
        mats = tuple(np.asarray(x) for x in
                     LoweredMachine(ev, dtype=np.float32).matrices_2d())
        _cache[key] = (ev, mats)
    return _cache[key]


def _case(name):
    """(log-space matrices_2d, it, ot, il, ol) as numpy, from seeds."""
    if name in _cache:
        return _cache[name]
    chained = name in CHAINED or name == "odd_deep"
    kind = {"edges": "allclass", "allclass_c3": "allclass",
            "indel_c3": "indel", "dense6_c3": "dense6_7",
            "dense6_c1": "dense6_7", "dense6_c5": "dense6_7",
            "dense8_c2": "dense8", "impossible_c2": "dense8",
            "odd_deep": "dense64", "odd_start": "dense64"}.get(name, name)
    ev, mats = _lowered(kind)
    n_in, n_out = mats[1].shape[0], mats[2].shape[0]
    B, Li, Lo, seed = {
        "indel": (6, 6, 6, 4), "allclass": (6, 7, 7, 8),
        "edges": (6, 7, 7, 8), "dense8": (2, 20, 20, 6),
        "untrimmed": (5, 6, 6, 11), "dense6": (4, 7, 7, 5),
        "prot2dna": (3, 5, 15, 5), "allclass_c3": (6, 7, 7, 8),
        "indel_c3": (6, 6, 6, 4), "dense6_c3": (12, 6, 6, 3),
        "dense6_c1": (6, 5, 5, 1), "dense6_c5": (5, 7, 7, 5),
        "dense8_c2": (4, 20, 20, 6), "impossible_c2": (4, 6, 8, 2),
        # Lo = 115: an odd stagger, so chain 1 starts on an odd diagonal,
        # and every pair scores below -88 nats
        "odd_deep": (3, 115, 115, 1), "odd_start": (3, 100, 100, 1)}[name]
    rng = np.random.RandomState(seed)
    it = rng.randint(0, n_in, (B, Li)).astype(np.int32)
    ot = rng.randint(0, n_out, (B, Lo)).astype(np.int32)
    il = np.full(B, Li, np.int32)
    ol = np.full(B, Lo, np.int32)
    if kind == "prot2dna":          # proteins and their codon DNA
        pairs = testmachines.prot2dna_pairs(B, Li, seed=seed)
        for n, (p, dna) in enumerate(pairs):
            it[n] = [ev.input_tokenizer.sym2tok[c] - 1 for c in p]
            ot[n] = [ev.output_tokenizer.sym2tok[c] - 1 for c in dna]
    if not chained:
        if name == "allclass":      # ragged, as the JAX package's test
            il[1], ol[1] = Li - 3, Lo - 1
            il[2], ol[2] = Li - 1, Lo - 4
        elif name == "edges":       # empty sides and single cells
            il[:], ol[:] = (0, 0, 5, 1, 1, 0), (0, 5, 0, 1, 0, 1)
        elif name == "untrimmed":
            il[:], ol[:] = (6, 4, 5, 2, 1), (6, 5, 3, 2, 1)
        elif name == "dense6":      # the JAX factored test's ragged pair
            il[1], ol[1] = Li - 2, Lo - 2
        elif name == "odd_start":   # the merged tests' deep chain: the
            il[:] = ol[:] = (56, 53, 99)    # third pair passes -87.9 nats
    _cache[name] = (mats, it, ot, il, ol)
    return _cache[name]


def _f64(name):
    key = ("f64", name)
    if key not in _cache:
        mats, it, ot, il, ol = _case(name)
        m64 = [x.astype(np.float64) for x in mats]
        _cache[key] = np.array([forward_2d_f64(*m64, it[b][:il[b]],
                                               ot[b][:ol[b]])
                                for b in range(len(il))])
    return _cache[key]


def _kw(variant, name):
    if variant == "generic":
        return {"merged": False}
    if variant == "chained":
        return {"variant": "chained",
                "chain": CHAINED.get(name, 3)}
    return {"variant": variant}


def _port(variant, name, device="cpu"):
    mats, it, ot, il, ol = _case(name)
    B, Li = it.shape
    fn = wk.make_wavefront_forward(*mats, B, Li, ot.shape[1], device=device,
                                   **_kw(variant, name))
    return fn(it, ot, il, ol).cpu().numpy()


def _jax(variant, name, **kw):
    import jax.numpy as jnp
    from machineboss_tpu.ops.pallas.wavefront_kernel import \
        make_wavefront_forward as j_make
    mats, it, ot, il, ol = _case(name)
    B, Li = it.shape
    fn = j_make(*mats, B, Li, ot.shape[1], interpret=True,
                **_kw(variant, name), **kw)
    args = (jnp.array(it), jnp.array(ot), jnp.array(il), jnp.array(ol))
    return fn, args


def _assert_close(dev, ref, bound):
    assert len(dev) == len(ref)
    for b in range(len(ref)):
        if ref[b] <= -1e29:
            assert dev[b] <= -1e29, (b, dev[b])
        else:
            assert abs(float(dev[b]) - float(ref[b])) <= bound, \
                (b, dev[b], ref[b])


def _bound(variant, name=None):
    if name == "odd_start":
        return ODD_BOUND
    return FACTORED_BOUND if variant == "factored" else BOUND


VARIANT_CASES = [(v, n) for v in ("generic", "seqscale", "factored")
                 for n in CASES]


@pytest.mark.parametrize("variant,name", VARIANT_CASES)
def test_variant_plain_matches_f64(variant, name):
    _assert_close(_port(variant, name), _f64(name), _bound(variant, name))


@pytest.mark.parametrize("variant,name", VARIANT_CASES)
def test_variant_plain_matches_jax_interpret(variant, name):
    fn, args = _jax(variant, name)
    _assert_close(_port(variant, name), np.array(fn(*args)),
                  _bound(variant, name))


@pytest.mark.parametrize("name", list(CHAINED))
def test_chained_plain_matches_f64(name):
    _assert_close(_port("chained", name), _f64(name), BOUND)


@pytest.mark.parametrize("name", list(CHAINED))
def test_chained_plain_matches_jax_interpret(name):
    fn, args = _jax("chained", name)
    _assert_close(_port("chained", name), np.array(fn(*args)), BOUND)


def test_chained_impossible_pairs_are_impossible():
    # a diag-only machine scores no pair with Li != Lo
    res = _port("chained", "impossible_c2")
    assert (_f64("impossible_c2") <= -1e29).all()
    assert (res <= -1e29).all() and (res == np.float32(-1e30)).all()


def test_chained_odd_stagger_deep_chain():
    """sigma = 117 is odd: chain 1 starts on an odd diagonal, and every
    pair falls below -88 nats, where a chain renormalised on one parity
    only would underflow (docs/tpu_history.md)."""
    ref = _f64("odd_deep")
    assert (ref < -88).all()
    mats, it, ot, il, ol = _case("odd_deep")
    fn = wk.make_wavefront_forward(*mats, 3, 115, 115, device="cpu",
                                   variant="chained", chain=3)
    _assert_close(fn(it, ot, il, ol).numpy(), ref, ODD_BOUND)


def test_chained_ignores_lengths_and_equals_merged():
    """Lengths are ignored; a pair's score is its merged score at (Li, Lo)
    up to the rescale schedule, which reads the absolute diagonal."""
    mats, it, ot, il, ol = _case("dense6_c3")
    ops = wk.merged_operands(wk.prepare_merged(*mats), torch.device("cpu"))
    batch = [torch.from_numpy(x) for x in (it, ot, il, ol)]
    short = [x // 2 for x in batch[2:]]
    res = wk.chained_forward_plain(ops, *batch[:2], *short, n_chain=3)
    assert torch.equal(res, wk.chained_wavefront(ops, *batch, n_chain=3))
    np.testing.assert_allclose(res.numpy(),
                               wk.merged_forward_plain(ops, *batch).numpy(),
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("rescale_every", [1, 2, 3, 8])
def test_chained_rescale_schedule_invariant(rescale_every):
    # rescaling only moves mass between p and its log scale m, so every
    # cadence on the absolute diagonal gives the same scores up to f32
    # rounding (1e-5 nats)
    mats, it, ot, il, ol = _case("dense6_c3")
    ops = wk.merged_operands(wk.prepare_merged(*mats), torch.device("cpu"))
    batch = [torch.from_numpy(x) for x in (it, ot)]
    np.testing.assert_allclose(
        wk.chained_forward_plain(ops, *batch, n_chain=3,
                                 rescale_every=rescale_every).numpy(),
        wk.chained_forward_plain(ops, *batch, n_chain=3).numpy(),
        rtol=0, atol=1e-5)


def test_merged_plain_zero_offset_is_bit_equal():
    mats, it, ot, il, ol = _case("allclass")
    ops = wk.merged_operands(wk.prepare_merged(*mats), torch.device("cpu"))
    batch = [torch.from_numpy(x) for x in (it, ot, il, ol)]
    assert torch.equal(
        wk.merged_forward_plain(ops, *batch),
        wk.merged_forward_plain(ops, *batch,
                                diag_offset=torch.zeros(6, dtype=torch.long)))


def _consts(variant, name, **kw):
    import jax
    fn, args = _jax(variant, name, **kw)
    jit_eqn = [e for e in jax.make_jaxpr(fn)(*args).jaxpr.eqns
               if "jaxpr" in e.params][0]
    return [np.asarray(c) for c in jit_eqn.params["jaxpr"].consts]


@pytest.mark.parametrize("name", ["indel", "allclass", "untrimmed",
                                  "prot2dna"])
def test_prepare_generic_equals_jax_host_tensors(name):
    """split=False: the generic kernel's constants are diag2, left_cat,
    up_cat and closure_t, in that order."""
    diag2, left_cat, up_cat, closure_t = _consts("generic", name,
                                                 split=False)[:4]
    mats = _case(name)[0]
    Ti, To, S, _ = mats[0].shape
    plan = wk.prepare_generic(*mats)
    assert plan["Sa"] == S and not plan["sink"]
    ref = {"up": up_cat.reshape(To, S, S), "left": left_cat.reshape(Ti, S, S),
           "diag": np.array([diag2[to * S:(to + 1) * S, ti * S:(ti + 1) * S]
                             for ti in range(Ti) for to in range(To)])}
    present = dict(zip(("up", "left", "diag"), plan["classes"]))
    for k, m in ref.items():
        if present[k]:
            assert plan["mats"][k].dtype == np.float32
            assert np.array_equal(plan["mats"][k], m), k
        else:
            assert k not in plan["mats"] and not m.any(), k
    assert np.array_equal(plan["closure"], closure_t)
    assert np.array_equal(plan["c0"], closure_t[:, 0])


@pytest.mark.parametrize("name", ["indel", "allclass", "dense8", "prot2dna"])
def test_prepare_seqscale_equals_jax_host_tensors(name):
    """The seqscale kernel is handed m_ud and m_left as bf16 hi/lo pairs
    and c0: the port's float32 m_ud and m_left split the same way give
    them bit for bit."""
    import jax.numpy as jnp
    ud_hi, l_hi, ud_lo, l_lo, c0 = _consts("seqscale", name)[:5]
    mats = _case(name)[0]
    plan = wk.prepare_seqscale(*mats)

    def split(m):
        hi = jnp.asarray(m).astype(jnp.bfloat16)
        return (np.asarray(hi), np.asarray(
            (jnp.asarray(m) - hi.astype(jnp.float32)).astype(jnp.bfloat16)))
    for port, hi, lo in ((plan["m_ud"], ud_hi, ud_lo),
                         (plan["m_left"], l_hi, l_lo)):
        p_hi, p_lo = split(port)
        assert np.array_equal(p_hi.view(np.uint16), hi.view(np.uint16))
        assert np.array_equal(p_lo.view(np.uint16), lo.view(np.uint16))
    assert np.array_equal(plan["c0"], c0[:, 0])
    # the class blocks are the m_ud / m_left blocks, destination x source
    S = plan["Sa"]
    Ti, To = mats[0].shape[:2]
    if "up" in plan["mats"]:
        assert np.array_equal(plan["mats"]["up"][To - 1],
                              plan["m_ud"][(To - 1) * S:, :S])
    if "left" in plan["mats"]:
        assert np.array_equal(plan["mats"]["left"][Ti - 1],
                              plan["m_left"][:, (Ti - 1) * S:])


@pytest.mark.parametrize("name", ["allclass", "dense6", "indel", "prot2dna",
                                  "untrimmed"])
def test_prepare_factored_equals_jax_host_tensors(name):
    """split=False: after the cell-index constant, each class of rank > 0
    gives (mt, mt_lo, e, e_lo), then closure_t and its residue, c0 and
    w."""
    consts = _consts("factored", name, split=False)[1:]
    mats = _case(name)[0]
    plan = wk.prepare_factored(*mats)
    got = []
    for _, mt, e, _ in plan["classes"]:
        got += [mt, e]
    got += [plan["closure"], plan["c0"], plan["w"]]
    ref = consts[0:4 * len(plan["classes"]):2] \
        + [consts[4 * len(plan["classes"])]] + consts[-2:]
    assert len(got) == len(ref) == len(consts) - len(plan["classes"]) * 2 - 1
    for a, b in zip(got, ref):
        assert a.dtype == np.float32
        assert np.array_equal(a.reshape(b.shape), b)
    if name == "prot2dna":
        ranks = {c[0]: c[3] for c in plan["classes"]}
        assert ranks == {"up": 4, "left": 1} and plan["sink"]


def test_prepare_chained_equals_jax_host_tensors():
    """The chained kernel takes prepare_merged's plan, unchanged."""
    from machineboss_tpu_torch.convert import merged_from_jax_layout
    m_ud, m_left, _, _, c0, w = _consts("chained", "allclass_c3",
                                        split=False)[:6]
    mats = _case("allclass_c3")[0]
    plan = wk.prepare_merged(*mats)
    cpu = torch.device("cpu")
    ref = merged_from_jax_layout(m_ud, m_left, c0, w, *mats[0].shape[:2],
                                 plan["classes"], plan["sink"], device=cpu)
    ops = wk.merged_operands(plan, cpu)
    assert ops.names == ref.names
    for k in ops.names:
        assert torch.equal(ops.mats[k], ref.mats[k]), k
    assert torch.equal(ops.c0, ref.c0) and torch.equal(ops.w, ref.w)


def test_cpu_wrappers_take_plain_without_launch():
    mats, it, ot, il, ol = _case("allclass")
    cpu = torch.device("cpu")
    batch = [torch.from_numpy(x) for x in (it, ot, il, ol)]
    merged = wk.merged_operands(wk.prepare_merged(*mats), cpu)
    generic = wk.merged_operands(wk.prepare_generic(*mats), cpu)
    seqscale = wk.merged_operands(wk.prepare_seqscale(*mats), cpu)
    factored = wk.factored_operands(wk.prepare_factored(*mats), cpu)
    for wrapper, plain, ops, kw in (
            (wk.chained_wavefront, wk.chained_forward_plain, merged,
             {"n_chain": 3}),
            (wk.generic_wavefront, wk.generic_forward_plain, generic, {}),
            (wk.seqscale_wavefront, wk.seqscale_forward_plain, seqscale, {}),
            (wk.factored_wavefront, wk.factored_forward_plain, factored,
             {})):
        before = wrapper.launches
        out = wrapper(ops, *batch, **kw)
        assert wrapper.launches == before
        assert torch.equal(out, plain(ops, *batch, **kw))


def test_factory_argument_checks_for_variants():
    mats = _case("dense8")[0]
    with pytest.raises(ValueError, match="multiple of chain"):
        wk.make_wavefront_forward(*mats, 3, 20, 20, device="cpu",
                                  variant="chained", chain=2)
    with pytest.raises(ValueError, match="non-empty"):
        wk.make_wavefront_forward(*mats, 2, 0, 20, device="cpu",
                                  variant="chained", chain=2)
    # chain defaults to 4, as in the JAX factory; `merged` is ignored
    with pytest.raises(ValueError, match="multiple of chain"):
        wk.make_wavefront_forward(*mats, 6, 20, 20, device="cpu",
                                  variant="chained", merged=False)
    mats, it, ot, il, ol = _case("dense8_c2")
    a = wk.make_wavefront_forward(*mats, 4, 20, 20, device="cpu",
                                  variant="chained", merged=False)
    b = wk.make_wavefront_forward(*mats, 4, 20, 20, device="cpu",
                                  variant="chained", merged=True, chain=4)
    assert torch.equal(a(it, ot, il, ol), b(it, ot, il, ol))


def test_chain_one_matches_jax():
    """chain=1: one pair per window, the merged recurrence at (Li, Lo)."""
    import jax.numpy as jnp
    from machineboss_tpu.ops.pallas.wavefront_kernel import \
        make_wavefront_forward as j_make
    mats, it, ot, il, ol = _case("dense6_c1")
    fn = wk.make_wavefront_forward(*mats, 6, 5, 5, device="cpu",
                                   variant="chained", chain=1)
    jfn = j_make(*mats, 6, 5, 5, interpret=True, variant="chained", chain=1)
    _assert_close(fn(it, ot, il, ol).numpy(),
                  np.array(jfn(*(jnp.array(x) for x in (it, ot, il, ol)))),
                  BOUND)


def test_generic_gates_readout_on_a_live_cell():
    """An impossible pair of the diag-only machine (il != ol) comes back
    NEG_INF from the generic walk, as from the JAX kernel."""
    mats, it, ot, il, ol = _case("dense6")
    il = il.copy()
    il[0] = ol[0] - 1
    ops = wk.merged_operands(wk.prepare_generic(*mats), torch.device("cpu"))
    res = wk.generic_forward_plain(
        ops, *[torch.from_numpy(x) for x in (it, ot, il, ol)]).numpy()
    assert res[0] == np.float32(-1e30) and (res[1:] > -1e29).all()


def test_generic_launch_plan_at_dense64():
    """bench.py's dense machine (S = 65, padded to 68): C^T resident, two
    cells a warp in groups of 16 lanes (16 float4 chunks and a 4-state
    tail), room for 4 blocks a multiprocessor; the layout does not depend
    on the lengths (Li = Lo = 200 on the path)."""
    mats = _lowered("dense64")[1]
    ops = wk.merged_operands(wk.prepare_generic(*mats), torch.device("cpu"))
    assert ops.Sa == 65
    cfg = wk.generic_launch_plan(ops)
    assert cfg["cells_per_warp"] == 2 and cfg["chunks"] == 1
    assert cfg["ct_resident"] and cfg["blocks_per_sm"] >= 4
    assert cfg["smem"] == 4 * (68 * 68 + 8 * 2 * 68)
    one = wk.generic_launch_plan(ops, cells_per_warp=1)
    assert one["ct_resident"] and one["blocks_per_sm"] >= 4
    assert one["smem"] == 4 * (68 * 68 + 8 * 68) and one["chunks"] == 1
    l2 = wk.generic_launch_plan(ops, ct_resident=False)
    assert not l2["ct_resident"] and l2["smem"] == 4 * 8 * 2 * 68


@pytest.mark.parametrize("S,cells,chunks,resident", [
    (8, 2, 1, True), (110, 2, 2, True), (120, 2, 2, False),
    (200, 2, 4, False), (300, 1, 4, False), (512, 1, 4, False)])
def test_generic_launch_plan_by_width(S, cells, chunks, resident):
    """C^T stays resident while a block of it still fits 4 a
    multiprocessor (S = 110: exactly), else it is read through L1/L2; two
    cells a warp until a lane would hold more than 4 chunks."""
    cfg = wk.generic_launch_plan(types.SimpleNamespace(Sa=S))
    SaP = -(-S // 4) * 4
    assert (cfg["cells_per_warp"], cfg["chunks"], cfg["ct_resident"]) == \
        (cells, chunks, resident)
    assert cfg["smem"] == 4 * (SaP * SaP * resident + 8 * cells * SaP)
    assert cfg["blocks_per_sm"] >= 4


def test_generic_launch_plan_raises_where_nothing_fits():
    with pytest.raises(ValueError, match="chunks"):
        wk.generic_launch_plan(types.SimpleNamespace(Sa=600))
    with pytest.raises(ValueError, match="chunks"):
        wk.generic_launch_plan(types.SimpleNamespace(Sa=300),
                               cells_per_warp=2)
    with pytest.raises(ValueError, match="shared bytes"):
        wk.generic_launch_plan(types.SimpleNamespace(Sa=300),
                               ct_resident=True)
    with pytest.raises(ValueError, match="cells_per_warp"):
        wk.generic_launch_plan(types.SimpleNamespace(Sa=65),
                               cells_per_warp=4)


def _seqscale_carried(ops, in_toks, out_toks, in_lens, out_lens,
                      rescale_every):
    """seqscale_forward_plain's walk with the kernel's bookkeeping
    (csrc/seqscale_wavefront.cu): the max of diagonal d is the max of the
    values its products write, the max of d-1 is carried from the
    diagonal before (round(max * inv) after a rescale by inv, else its raw
    max), and a class whose source row is all zero is left out."""
    B, Li = in_toks.shape
    Lo = out_toks.shape[1]
    Sa, To = ops.Sa, ops.To
    W = Li + 1
    f32 = torch.float32
    neg = torch.tensor(-1e30, dtype=f32)
    i_idx = torch.arange(W)
    b_idx = torch.arange(B)
    il, ol = in_lens.long(), out_lens.long()
    dfin = il + ol
    x_tok = in_toks.long()[:, torch.clamp(i_idx - 1, 0, max(Li - 1, 0))]
    term = wk._merged_term(ops)
    p1 = torch.zeros((B, W, Sa), dtype=f32)
    p1[:, 0] = ops.c0
    p2 = torch.zeros_like(p1)
    M = torch.zeros(B, dtype=f32)
    carried = torch.full((B,), float(ops.c0.max().clamp(min=0)), dtype=f32)

    def readout(p):
        end = p[b_idx, il, Sa - 1]
        return torch.where(end > 0, M + torch.log(torch.clamp(end, min=1e-37)),
                           neg)

    res = torch.where(dfin == 0, readout(p1), neg)
    zp = torch.zeros((B, 1, Sa), dtype=f32)
    for d in range(1, int(dfin.max()) + 1):
        o_idx = d - i_idx
        in_pair = ((o_idx >= 0)[None, :] & (i_idx[None, :] <= il[:, None])
                   & (o_idx[None, :] <= ol[:, None]))
        y_tok = out_toks.long()[:, torch.clamp(o_idx - 1, 0, max(Lo - 1, 0))]
        has_y = (o_idx >= 1)[None, :, None]
        has_x = (i_idx >= 1)[None, :, None]
        nb = {"up": (p1 * has_y, y_tok),
              "left": (torch.cat([zp, p1[:, :-1]], 1) * has_x, x_tok),
              "diag": (torch.cat([zp, p2[:, :-1]], 1) * (has_x & has_y),
                       x_tok * To + y_tok)}
        cur = torch.zeros((B, W, Sa), dtype=f32)
        for name in ops.names:
            src, tok = nb[name]
            live = (src.amax(dim=2) > 0)[:, :, None]
            cur = cur + torch.where(live, term(name, src, tok),
                                    torch.zeros_like(cur))
        cur = torch.where(in_pair[:, :, None], cur, torch.zeros_like(cur))
        raw = cur.amax(dim=(1, 2))
        if d % rescale_every <= 1:
            mx = torch.maximum(raw, carried)
            f = torch.where(mx > 0, mx, torch.ones_like(mx))
            inv = 1.0 / f
            cur = cur * inv[:, None, None]
            p1 = p1 * inv[:, None, None]
            M = M + torch.log(f)
            carried = raw * inv
        else:
            carried = raw
        res = torch.where(dfin == d, readout(cur), res)
        p2, p1 = p1, cur
    return res


@pytest.mark.parametrize("rescale_every", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("name", ["allclass", "dense8", "edges"])
def test_seqscale_carried_max_is_bit_equal(name, rescale_every):
    """The kernel's max bookkeeping is exact: a positive factor's
    round-to-nearest product is monotone, so the carried max equals the
    max of the scaled values, and all-zero sources add exact zeros. On
    ragged pairs (allclass), pairs with an empty side (edges) and deep
    diag-only pairs with impossible ones (dense8, lengths cut below)."""
    mats, it, ot, il, ol = _case(name)
    il, ol = il.copy(), ol.copy()
    if name == "dense8":
        il[1] -= 3
    ops = wk.merged_operands(wk.prepare_seqscale(*mats), torch.device("cpu"))
    batch = [torch.from_numpy(x) for x in (it, ot, il, ol)]
    ref = wk.seqscale_forward_plain(ops, *batch, rescale_every=rescale_every)
    got = _seqscale_carried(ops, *batch, rescale_every)
    assert torch.equal(got, ref)
    if name == "dense8":
        assert ref[1] == np.float32(-1e30) and ref[0] > -1e29


@pytest.mark.cuda
@pytest.mark.parametrize("variant,name", VARIANT_CASES)
def test_variant_kernel_matches_plain_on_card(variant, name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    wrapper = {"generic": wk.generic_wavefront,
               "seqscale": wk.seqscale_wavefront,
               "factored": wk.factored_wavefront}[variant]
    before = wrapper.launches
    kern = _port(variant, name, device="cuda")
    assert wrapper.launches == before + 1
    _assert_close(kern, _port(variant, name), CARD_BOUND)
    _assert_close(kern, _f64(name), _bound(variant, name))


@pytest.mark.cuda
@pytest.mark.parametrize("grid", [1, 2])
@pytest.mark.parametrize("variant", ["generic", "seqscale", "factored"])
def test_variant_kernel_walks_many_pairs_per_block_on_card(variant, grid):
    """grid=1 sends all six ragged pairs through one block, grid=2 three
    through each. Pair 1 has a bad token and pair 3 a length past the
    padded shape: both come back NaN, and the pairs a block walks after
    them score as the plain version scores them, so the per-pair reset
    (the bad-token flag, the early return) holds."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    mats, it, ot, il, ol = _case("allclass")
    dev = torch.device("cuda")
    wrapper, ops = {
        "generic": (wk.generic_wavefront, wk.merged_operands(
            wk.prepare_generic(*mats), dev)),
        "seqscale": (wk.seqscale_wavefront, wk.merged_operands(
            wk.prepare_seqscale(*mats), dev)),
        "factored": (wk.factored_wavefront, wk.factored_operands(
            wk.prepare_factored(*mats), dev))}[variant]
    plain = _port(variant, "allclass")
    clean = [torch.from_numpy(x).to(dev) for x in (it, ot, il, ol)]
    before = wrapper.launches
    kern = wrapper(ops, *clean, grid=grid).cpu().numpy()
    _assert_close(kern, plain, CARD_BOUND)
    _assert_close(kern, _f64("allclass"), _bound(variant))
    it, il = it.copy(), il.copy()
    it[1, 2] = 9                         # outside the 2-letter alphabet
    il[3] = it.shape[1] + 1
    bad = [torch.from_numpy(x).to(dev) for x in (it, ot, il, ol)]
    kern = wrapper(ops, *bad, grid=grid).cpu().numpy()
    assert wrapper.launches == before + 2
    live = np.array([0, 2, 4, 5])
    assert np.isnan(kern[[1, 3]]).all(), kern
    _assert_close(kern[live], plain[live], CARD_BOUND)


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CHAINED) + ["odd_deep"])
def test_chained_kernel_matches_plain_on_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    mats, it, ot, il, ol = _case(name)
    B, Li = it.shape
    chain = CHAINED.get(name, 3)
    res = {}
    for dev in ("cpu", "cuda"):
        fn = wk.make_wavefront_forward(*mats, B, Li, ot.shape[1], device=dev,
                                       variant="chained", chain=chain)
        before = wk.chained_wavefront.launches
        res[dev] = fn(it, ot, il, ol).cpu().numpy()
        assert wk.chained_wavefront.launches == before + (dev == "cuda")
    _assert_close(res["cuda"], res["cpu"], CARD_BOUND)
    _assert_close(res["cuda"], _f64(name),
                  ODD_BOUND if name == "odd_deep" else BOUND)


@pytest.mark.cuda
@pytest.mark.parametrize("chain", [1, 3, 5, 8, "odd_deep"])
def test_chained_kernel_per_pair_walk_on_card(chain):
    """The chained kernel walks each pair on its chain's absolute-diagonal
    offset: chains 1, 3, 5 and 8 over 120 uniform pairs, and the odd
    stagger's deep chain (three pairs below -88 nats, chain 3), with one
    block walking every pair, two blocks, and the default grid. Every grid
    gives the same scores bit for bit, within the card bound of the plain
    version and within BOUND (ODD_BOUND) of the f64 oracle."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    if chain == "odd_deep":
        mats, it, ot, il, ol = _case("odd_deep")
        n_chain, bound = 3, ODD_BOUND
    else:
        _, mats = _lowered("dense6_7")
        rng = np.random.RandomState(chain)
        it = rng.randint(0, 4, (120, 6)).astype(np.int32)
        ot = rng.randint(0, 4, (120, 6)).astype(np.int32)
        il, ol = np.full(120, 6, np.int32), np.full(120, 6, np.int32)
        n_chain, bound = chain, BOUND
    ops = wk.merged_operands(wk.prepare_merged(*mats), dev)
    batch = [torch.from_numpy(x).to(dev) for x in (it, ot, il, ol)]
    plain = wk.chained_forward_plain(ops, *batch, n_chain=n_chain)
    plain = plain.cpu().numpy()
    runs = []
    for grid in (1, 2, None):
        before = wk.chained_wavefront.launches
        runs.append(wk.chained_wavefront(ops, *batch, n_chain=n_chain,
                                         grid=grid).cpu().numpy())
        assert wk.chained_wavefront.launches == before + 1
    for kern in runs:
        assert np.array_equal(kern, runs[0])
    _assert_close(runs[0], plain, CARD_BOUND)
    m64 = [x.astype(np.float64) for x in mats]
    ref = _f64(chain) if chain == "odd_deep" else np.array(
        [forward_2d_f64(*m64, it[b], ot[b]) for b in range(len(it))])
    _assert_close(runs[0], ref, bound)
    if chain == "odd_deep":
        assert (ref < -88).all()


@pytest.mark.cuda
@pytest.mark.parametrize("layout", [
    {"live_range": False}, {"rescale_pass": True}, {"slots": "shared"},
    {"slots": "global"}])
@pytest.mark.parametrize("chain", [1, 3, 5])
def test_chained_kernel_walk_layouts_on_card(chain, layout):
    """The chained kernel in every walk layout (all cells, the separate
    rescale pass, shared or global slots) on chains 1, 3 and 5 of the
    dense and all-class machines: bit-equal to the plan's layout."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    for which in ("dense6_7", "allclass"):
        mats = _lowered(which)[1]
        n_sym = mats[1].shape[0]
        rng = np.random.RandomState(chain)
        it = rng.randint(0, n_sym, (15, 6)).astype(np.int32)
        ot = rng.randint(0, mats[2].shape[0], (15, 7)).astype(np.int32)
        ops = wk.merged_operands(wk.prepare_merged(*mats), dev)
        batch = [torch.from_numpy(x).to(dev) for x in (it, ot)]
        ref = wk.chained_wavefront(ops, *batch, n_chain=chain).cpu().numpy()
        got = wk.chained_wavefront(ops, *batch, n_chain=chain,
                                   **layout).cpu().numpy()
        assert np.array_equal(got, ref)
        _assert_close(ref, wk.chained_forward_plain(
            ops, *batch, n_chain=chain).cpu().numpy(), CARD_BOUND)


@pytest.mark.cuda
def test_kernels_flag_a_bad_token_as_nan_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    mats, it, ot, il, ol = _case("dense6_c3")
    dev = torch.device("cuda")
    it = it.copy()
    it[4, 2] = 9                         # outside the 4-letter alphabet
    batch = [torch.from_numpy(x).to(dev) for x in (it, ot, il, ol)]
    merged = wk.merged_operands(wk.prepare_merged(*mats), dev)
    for fn in (lambda: wk.chained_wavefront(merged, *batch, n_chain=3),
               lambda: wk.generic_wavefront(wk.merged_operands(
                   wk.prepare_generic(*mats), dev), *batch),
               lambda: wk.seqscale_wavefront(wk.merged_operands(
                   wk.prepare_seqscale(*mats), dev), *batch),
               lambda: wk.factored_wavefront(wk.factored_operands(
                   wk.prepare_factored(*mats), dev), *batch)):
        res = fn().cpu().numpy()
        assert np.isnan(res[4]) and np.isfinite(res[np.arange(12) != 4]).all()


@pytest.mark.cuda
@pytest.mark.parametrize("rescale_every", [1, 2, 3, 8])
def test_seqscale_kernel_is_bit_equal_to_plain_on_card(rescale_every):
    """The diag-only dense8 machine: pair 1 cannot be scored (il != ol: its
    max is 0 on every diagonal, a factor of 1), pair 3 has a token outside
    the alphabet (NaN). The others equal the plain version bit for bit, and
    so do the variants that find the max by a separate pass and that take
    the products of all-zero sources."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    mats, it, ot, il, ol = _case("dense8")
    it, il = np.tile(it, (2, 1)), np.tile(il, 2)
    ot, ol = np.tile(ot, (2, 1)), np.tile(ol, 2)
    il[1] -= 3
    dev = torch.device("cuda")
    ops = wk.merged_operands(wk.prepare_seqscale(*mats), dev)
    clean = [torch.from_numpy(np.ascontiguousarray(x)).to(dev)
             for x in (it, ot, il, ol)]
    plain = wk.seqscale_forward_plain(ops, *clean,
                                      rescale_every=rescale_every)
    plain = plain.cpu().numpy()
    assert plain[1] == np.float32(-1e30) and (plain[[0, 2, 3]] > -1e29).all()
    it = it.copy()
    it[3, 5] = 7
    bad = [torch.from_numpy(np.ascontiguousarray(x)).to(dev)
           for x in (it, ot, il, ol)]
    runs = [wk.seqscale_wavefront(ops, *bad, rescale_every=rescale_every,
                                  **kw).cpu().numpy()
            for kw in ({}, {"max_pass": True}, {"skip_dead": False})]
    live = np.arange(4) != 3
    for kern in runs:
        assert np.isnan(kern[3])
        assert np.array_equal(kern[live], plain[live])


@pytest.mark.cuda
@pytest.mark.parametrize("ct_resident", [True, False])
@pytest.mark.parametrize("cells_per_warp", [1, 2])
@pytest.mark.parametrize("name", ["allclass", "dense8", "odd_start"])
def test_generic_kernel_layouts_on_card(name, cells_per_warp, ct_resident):
    """Every layout of the generic kernel (one or two cells a warp, C^T in
    shared memory or through L1/L2) within 1e-3 nats of the plain version,
    and equal bit for bit to the same layout taking the products of the
    zero cells too; odd_start is the 65-state dense machine, whose 68
    padded states leave a 4-state tail."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    mats, it, ot, il, ol = _case(name)
    dev = torch.device("cuda")
    ops = wk.merged_operands(wk.prepare_generic(*mats), dev)
    batch = [torch.from_numpy(x).to(dev) for x in (it, ot, il, ol)]
    kw = {"cells_per_warp": cells_per_warp, "ct_resident": ct_resident}
    kern = wk.generic_wavefront(ops, *batch, **kw).cpu().numpy()
    _assert_close(kern, _port("generic", name), CARD_BOUND)
    full = wk.generic_wavefront(ops, *batch, skip_dead=False, **kw)
    assert np.array_equal(full.cpu().numpy(), kern)


@pytest.mark.cuda
@pytest.mark.parametrize("S,cells,resident", [
    (100, 1, None), (100, 2, None), (100, 2, False), (130, 1, None),
    (130, 2, None), (300, 1, None)])
def test_generic_kernel_wide_layouts_on_card(S, cells, resident):
    """Machines wider than the dense one, every class present: 104 padded
    states (two cells a warp: 26 chunks over 16 lanes, no tail), 132 (32
    chunks and a 4-state tail; C^T through L1/L2) and 304 (4 chunks a
    lane), against the plain version, with an impossible pair."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    m = testmachines.build_allclass_transducer(S, list("AC"))
    ev = EvaluatedMachine(m, m.get_param_defs(True))
    mats = tuple(np.asarray(x) for x in
                 LoweredMachine(ev, dtype=np.float32).matrices_2d())
    rng = np.random.RandomState(4)
    it = rng.randint(0, 2, (4, 6)).astype(np.int32)
    ot = rng.randint(0, 2, (4, 6)).astype(np.int32)
    il, ol = np.array([6, 4, 6, 0], np.int32), np.array([6, 6, 3, 5], np.int32)
    plain = wk.generic_forward_plain(
        wk.merged_operands(wk.prepare_generic(*mats), torch.device("cpu")),
        *[torch.from_numpy(x) for x in (it, ot, il, ol)]).numpy()
    assert (plain[:2] > -1e29).all() and plain[2] <= -1e29
    dev = torch.device("cuda")
    ops = wk.merged_operands(wk.prepare_generic(*mats), dev)
    cfg = wk.generic_launch_plan(ops, cells, resident)
    assert cfg["chunks"] == {100: {1: 1, 2: 2}, 130: {1: 2, 2: 2},
                             300: {1: 4}}[S][cells]
    kern = wk.generic_wavefront(
        ops, *[torch.from_numpy(x).to(dev) for x in (it, ot, il, ol)],
        cells_per_warp=cells, ct_resident=resident).cpu().numpy()
    _assert_close(kern, plain, CARD_BOUND)
