"""The port's full-rank wavefront (merged, chained_ragged) against the JAX
kernels and the f64 oracle.

merged_forward_plain and chained_ragged_forward_plain (the CPU paths of
make_wavefront_forward) are held to the JAX package's
make_wavefront_forward in its own CPU mode (interpret=True) and to
forward_2d_f64, on the fixtures of tests/test_pallas_kernel.py. Bounds:
2e-3 nats (the JAX tests' own bound for the merged family), 5e-3 on the
odd-start deep chain (its JAX test's bound). The host prep is held
bit-equal to the tensors the JAX factory hands its kernel. On a CUDA card
the kernels are held to the plain versions at 1e-3 nats (the same f32
recurrence, summed in another order).

The JAX package is imported inside the tests that use it, so that the card
tests run where only torch is installed:
    python -m pytest --noconftest tests/test_torch_wavefront_kernel.py -m cuda
"""

import numpy as np
import pytest
import torch

from machineboss_tpu_torch import testmachines
from machineboss_tpu_torch.convert import merged_from_jax_layout
from machineboss_tpu_torch.core.eval import EvaluatedMachine
from machineboss_tpu_torch.core.machine import Machine
from machineboss_tpu_torch.ops.host_oracle import forward_2d_f64
from machineboss_tpu_torch.ops.kernels import wavefront_kernel as wk
from machineboss_tpu_torch.ops.lowering import LoweredMachine

BOUND = 2e-3         # nats, merged family vs f64 and vs the JAX kernels
ODD_BOUND = 5e-3     # nats, the odd-start deep chain (S=64, L=100)
CARD_BOUND = 1e-3    # nats, kernel vs plain on the card

# name -> chain length for the ragged schedule (None: merged only)
CASES = {"indel": None, "allclass": None, "dense8": None, "untrimmed": None,
         "edges": None, "ragged_dense": 4, "ragged_pairhmm": 4,
         "odd_start": 3}
RAGGED = [k for k, v in CASES.items() if v]
_cache = {}

PAIRHMM = {"state": [
    {"id": "s", "trans": [
        {"in": a, "out": b, "to": "s", "weight": 0.4 if a == b else 0.04}
        for a in "ACGT" for b in "ACGT"
    ] + [{"in": a, "to": "s", "weight": 0.01} for a in "ACGT"
    ] + [{"out": b, "to": "s", "weight": 0.01} for b in "ACGT"
    ] + [{"to": "e", "weight": 0.1}]},
    {"id": "e", "trans": []}]}

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


def _case(name):
    """(log-space matrices_2d, it, ot, il, ol) as numpy, from seeds; the
    shapes, seeds and lengths of the JAX package's kernel tests."""
    if name in _cache:
        return _cache[name]
    il = ol = None
    if name == "indel":
        m, n_sym, B, L, seed = \
            testmachines.build_indel_transducer(6, list("ACGT")), 4, 6, 6, 4
    elif name in ("allclass", "edges"):
        m, n_sym, B, L, seed = \
            testmachines.build_allclass_transducer(5, list("AC")), 2, 6, 7, 8
    elif name == "dense8":
        m, n_sym, B, L, seed = testmachines.build_random_transducer(
            8, list("ACGT"), seed=15), 4, 2, 20, 6
    elif name == "untrimmed":
        m, n_sym, B, L, seed = Machine.from_json(UNTRIMMED), 2, 5, 6, 11
    elif name == "ragged_dense":
        m, n_sym, B, L, seed = testmachines.build_random_transducer(
            6, list("ACGT"), seed=3), 4, 8, 14, 1
    elif name == "ragged_pairhmm":
        m, n_sym, B, L, seed = Machine.from_json(PAIRHMM), 4, 8, 14, 2
    else:
        m, n_sym, B, L, seed = testmachines.build_random_transducer(
            64, list("ACGT"), seed=42), 4, 3, 100, 1
    ev = EvaluatedMachine(m, m.get_param_defs(True))
    mats = tuple(np.asarray(x) for x in
                 LoweredMachine(ev, dtype=np.float32).matrices_2d())
    rng = np.random.RandomState(seed)
    nb = 4 if name == "odd_start" else B
    it = rng.randint(0, n_sym, (nb, L)).astype(np.int32)[:B]
    ot = rng.randint(0, n_sym, (nb, L)).astype(np.int32)[:B]
    il = np.full(B, L, np.int32)
    ol = np.full(B, L, np.int32)
    if name == "allclass":          # ragged, as the JAX package's test
        il[1], ol[1] = L - 3, L - 1
        il[2], ol[2] = L - 1, L - 4
    elif name == "untrimmed":
        il[:], ol[:] = (6, 4, 5, 2, 1), (6, 5, 3, 2, 1)
    elif name == "edges":           # empty sides and single cells
        il[:], ol[:] = (0, 0, 5, 1, 1, 0), (0, 5, 0, 1, 0, 1)
    elif name == "ragged_dense":    # diag-only: il == ol
        il = rng.randint(7, L + 1, B).astype(np.int32)
        ol = il.copy()
    elif name == "ragged_pairhmm":
        il = rng.randint(7, L + 1, B).astype(np.int32)
        ol = rng.randint(7, L + 1, B).astype(np.int32)
    elif name == "odd_start":       # the third pair crosses -87.9 nats
        il = np.array([56, 53, 99], np.int32)
        ol = il.copy()
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


def _port(name, variant=None, device="cpu", rescale_every=4):
    mats, it, ot, il, ol = _case(name)
    B, Li = it.shape
    fn = wk.make_wavefront_forward(
        *mats, B, Li, ot.shape[1], device=device, merged=True,
        variant=variant, chain=CASES[name] if variant else None,
        rescale_every=rescale_every)
    return fn(it, ot, il, ol).cpu().numpy()


def _jax(name, variant=None, **kw):
    import jax.numpy as jnp
    from machineboss_tpu.ops.pallas.wavefront_kernel import \
        make_wavefront_forward as j_make
    mats, it, ot, il, ol = _case(name)
    B, Li = it.shape
    fn = j_make(*mats, B, Li, ot.shape[1], interpret=True, merged=True,
                variant=variant, chain=CASES[name] if variant else None,
                **kw)
    args = (jnp.array(it), jnp.array(ot), jnp.array(il), jnp.array(ol))
    return fn, args


def _assert_close(dev, ref, bound):
    for b in range(len(ref)):
        if ref[b] <= -1e29:
            assert dev[b] <= -1e29, (b, dev[b])
        else:
            assert abs(float(dev[b]) - float(ref[b])) <= bound, \
                (b, dev[b], ref[b])


def _bound(name):
    return ODD_BOUND if name == "odd_start" else BOUND


def test_ragged_span_bit_equal():
    from machineboss_tpu.ops.pallas.wavefront_kernel import \
        ragged_span as j_span
    rng = np.random.RandomState(0)
    for B, chain in ((8, 4), (16, 8), (6, 3), (512, 8)):
        il = rng.randint(1, 200, B)
        ol = rng.randint(1, 200, B)
        assert wk.ragged_span(il, ol, chain) == j_span(il, ol, chain)
    # longest first: chains start at 0, 101 and 159; the last one ends last
    assert wk.ragged_span([56, 53, 99], [56, 53, 99], 3) == 159 + 53 + 53 + 1


@pytest.mark.parametrize("name", ["indel", "allclass", "dense8", "untrimmed",
                                  "ragged_pairhmm"])
def test_prepare_merged_equals_jax_host_tensors(name):
    """The JAX factory closes its host tensors into the jitted forward: the
    inner jit's constants are m_ud, m_left, their bf16 residues, c0 and w,
    in the order it passes them to the kernel (split=False: unsplit)."""
    import jax
    fn, args = _jax(name, split=False)
    jit_eqn = [e for e in jax.make_jaxpr(fn)(*args).jaxpr.eqns
               if "jaxpr" in e.params][0]
    m_ud, m_left, _, _, c0, w = [np.asarray(c) for c in
                                 jit_eqn.params["jaxpr"].consts[:6]]
    mats, it, ot, il, ol = _case(name)
    plan = wk.prepare_merged(*mats)
    Ti, To = mats[0].shape[:2]
    cpu = torch.device("cpu")
    ref = merged_from_jax_layout(m_ud, m_left, c0, w, Ti, To,
                                 plan["classes"], plan["sink"], device=cpu)
    ops = wk.merged_operands(plan, cpu)
    assert (ops.Sa, ops.sink) == (ref.Sa, ref.sink)
    assert ops.sink == (name != "untrimmed")
    assert ops.names == ref.names
    for k in ops.names:
        assert ops.mats[k].dtype == torch.float32
        assert torch.equal(ops.mats[k], ref.mats[k]), k
    assert torch.equal(ops.c0, ref.c0) and torch.equal(ops.w, ref.w)
    # and the plain version, fed the JAX package's own numbers, gives the
    # scores of the port's own prep bit for bit
    batch = [torch.from_numpy(x) for x in (it, ot, il, ol)]
    assert torch.equal(wk.merged_forward_plain(ref, *batch),
                       wk.merged_forward_plain(ops, *batch))
    if name == "indel":
        assert plan["classes"] == (True, True, False)
    elif name == "dense8":
        assert plan["classes"] == (False, False, True)
    else:
        assert plan["classes"] == (True, True, True)
    # the unified layout repeats the left class in every row block
    if plan["classes"][1] and any(plan["classes"][::2]):
        Sa = plan["Sa"]
        left_cols = m_ud[:, -Ti * Sa:]
        for rb in range(1, To + 1):
            assert np.array_equal(left_cols[rb * Sa:(rb + 1) * Sa],
                                  left_cols[:Sa])


def test_prepare_merged_degenerate_keeps_up_class():
    # a machine with an alphabet and only a silent transition 0 -> 2
    S = 3
    neg = np.float32(-1e30)
    ad = np.full((2, 2, S, S), neg, np.float32)
    al = np.full((2, S, S), neg, np.float32)
    au = np.full((2, S, S), neg, np.float32)
    cl = np.full((S, S), neg, np.float32)
    np.fill_diagonal(cl, 0.0)
    cl[0, 2] = np.log(0.5)
    plan = wk.prepare_merged(ad, al, au, cl)
    assert plan["classes"] == (True, False, False)
    assert not plan["mats"]["up"].any()
    fn = wk.make_wavefront_forward(ad, al, au, cl, 2, 3, 3, device="cpu",
                                   merged=True)
    res = fn(np.zeros((2, 3), np.int32), np.zeros((2, 3), np.int32),
             np.array([0, 2], np.int32), np.array([0, 1], np.int32)).numpy()
    assert abs(res[0] - np.log(0.5)) < 1e-6 and res[1] <= -1e29


@pytest.mark.parametrize("name", list(CASES))
def test_merged_plain_matches_f64(name):
    _assert_close(_port(name), _f64(name), _bound(name))


@pytest.mark.parametrize("name", list(CASES))
def test_merged_plain_matches_jax_interpret(name):
    fn, args = _jax(name)
    _assert_close(_port(name), np.array(fn(*args)), _bound(name))


@pytest.mark.parametrize("name", RAGGED)
def test_chained_ragged_plain_matches_f64(name):
    res = _port(name, "chained_ragged")
    _assert_close(res, _f64(name), _bound(name))
    if name == "odd_start":
        assert _f64(name)[2] < -87 and res[2] > -1e29


@pytest.mark.parametrize("name", RAGGED)
def test_chained_ragged_plain_matches_jax_interpret(name):
    fn, args = _jax(name, "chained_ragged")
    _assert_close(_port(name, "chained_ragged"), np.array(fn(*args)),
                  _bound(name))


@pytest.mark.parametrize("name", RAGGED)
def test_chained_ragged_scores_keep_batch_order(name):
    # the schedule sorts by length; scores must come back in batch order,
    # equal to what each pair gets when walked in a batch of its own
    mats, it, ot, il, ol = _case(name)
    ops = wk.merged_operands(wk.prepare_merged(*mats), torch.device("cpu"))
    batch = [torch.from_numpy(x) for x in (it, ot, il, ol)]
    ragged = wk.chained_ragged_forward_plain(ops, *batch).numpy()
    order = wk.sorted_order(batch[3]).numpy()
    assert list(ol[order]) == sorted(ol, reverse=True)
    for b in range(len(il)):
        single = wk.merged_forward_plain(
            ops, *[x[b:b + 1] for x in batch]).numpy()
        np.testing.assert_allclose(ragged[b], single[0], rtol=0, atol=1e-5)


@pytest.mark.parametrize("rescale_every", [1, 2, 8])
def test_rescale_schedule_invariant(rescale_every):
    # rescaling only moves mass between p and its log scale m, so every
    # cadence gives the same scores up to f32 rounding (1e-5 nats)
    np.testing.assert_allclose(
        _port("allclass", rescale_every=rescale_every), _port("allclass"),
        rtol=0, atol=1e-5)


def test_cpu_wrappers_take_plain_without_launch():
    mats, it, ot, il, ol = _case("ragged_pairhmm")
    ops = wk.merged_operands(wk.prepare_merged(*mats), torch.device("cpu"))
    batch = [torch.from_numpy(x) for x in (it, ot, il, ol)]
    for wrapper, plain in ((wk.merged_wavefront, wk.merged_forward_plain),
                           (wk.chained_ragged_wavefront,
                            wk.chained_ragged_forward_plain)):
        before = wrapper.launches
        out = wrapper(ops, *batch, grid=1)
        assert wrapper.launches == before
        assert torch.equal(out, plain(ops, *batch))


def test_factory_argument_checks():
    mats = _case("dense8")[0]
    with pytest.raises(ValueError, match="multiple of chain"):
        wk.make_wavefront_forward(*mats, 3, 20, 20, device="cpu",
                                  merged=True, variant="chained_ragged",
                                  chain=2)
    with pytest.raises(ValueError, match="unknown wavefront variant"):
        wk.make_wavefront_forward(*mats, 2, 20, 20, device="cpu",
                                  variant="nope")
    # variant="lowrank" delegates to the lowrank factory
    fn = wk.make_wavefront_forward(*mats, 2, 20, 20, device="cpu",
                                   variant="lowrank")
    _, it, ot, il, ol = _case("dense8")
    _assert_close(fn(it, ot, il, ol).numpy(), _f64("dense8"), 5e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CASES))
def test_merged_kernel_matches_plain_on_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    before = wk.merged_wavefront.launches
    kern = _port(name, device="cuda")
    assert wk.merged_wavefront.launches == before + 1
    _assert_close(kern, _port(name), CARD_BOUND)
    _assert_close(kern, _f64(name), _bound(name))


@pytest.mark.cuda
@pytest.mark.parametrize("grid", [None, 1, 2])
@pytest.mark.parametrize("name", RAGGED)
def test_chained_ragged_kernel_matches_plain_on_card(name, grid):
    """grid=1 forces one block through every pair, longest first: a long
    pair and then shorter ones on the same three diagonal slots."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    mats, it, ot, il, ol = _case(name)
    dev = torch.device("cuda")
    ops = wk.merged_operands(wk.prepare_merged(*mats), dev)
    batch = [torch.from_numpy(x).to(dev) for x in (it, ot, il, ol)]
    before = wk.chained_ragged_wavefront.launches
    kern = wk.chained_ragged_wavefront(ops, *batch, grid=grid).cpu().numpy()
    assert wk.chained_ragged_wavefront.launches == before + 1
    _assert_close(kern, _port(name, "chained_ragged"), CARD_BOUND)
    _assert_close(kern, _f64(name), _bound(name))


# ------------------------------------------------ walk_pair's live cells

# walk_pair's layouts besides the plan's (every lattice cell, the separate
# rescale pass, each place of the diagonal slots)
WALK_LAYOUTS = [{"live_range": False}, {"rescale_pass": True},
                {"slots": "shared"}, {"slots": "global"},
                {"live_range": False, "rescale_pass": True,
                 "slots": "global"}]
LIVE_LENGTHS = [(7, 7), (7, 4), (4, 7), (0, 5), (5, 0), (1, 1), (0, 0),
                (20, 20), (13, 9)]


def walk_live_ranges(names, il, ol):
    """Host mirror of walk_pair's live-range rule for one pair of lengths
    (il, ol) on a machine with the classes `names`. Per diagonal d = 0 ..
    il + ol: the candidate cells [lo, hi] (the union of what the present
    classes reach from the live ranges of d-1 and d-2, inside the lattice;
    lo > hi when none), the live cells among them (a present class reads a
    live neighbour; (0, 0) is live), and the class terms they take (a
    class counted where its neighbour is live). Returns a list of (lo, hi,
    live cells as a sorted list of i, {class: terms})."""
    none = (1 << 29, -(1 << 29))
    ranges, live = [(0, 0)], [{0}]
    out = [(0, 0, [0], dict.fromkeys(names, 0))]
    for d in range(1, il + ol + 1):
        r1 = ranges[d - 1]
        r2 = ranges[d - 2] if d >= 2 else none
        lo, hi = none
        if "up" in names:
            lo, hi = min(lo, r1[0]), max(hi, r1[1])
        if "left" in names:
            lo, hi = min(lo, r1[0] + 1), max(hi, r1[1] + 1)
        if "diag" in names:
            lo, hi = min(lo, r2[0] + 1), max(hi, r2[1] + 1)
        lo, hi = max(lo, d - ol, 0), min(hi, d, il)
        l1 = live[d - 1]
        l2 = live[d - 2] if d >= 2 else set()
        cells, terms = [], dict.fromkeys(names, 0)
        for i in range(lo, hi + 1):
            o = d - i
            nb = {"up": o >= 1 and i in l1, "left": i >= 1 and i - 1 in l1,
                  "diag": i >= 1 and o >= 1 and i - 1 in l2}
            hit = [k for k in names if nb[k]]
            for k in hit:
                terms[k] += 1
            if hit:
                cells.append(i)
        live.append(set(cells))
        ranges.append((min(cells), max(cells)) if cells else none)
        out.append((lo, hi, cells, terms))
    return out


@pytest.mark.parametrize("name", ["indel", "allclass", "dense8"])
def test_walk_live_ranges_match_live_terms(name):
    """The host mirror of walk_pair's rule (candidates from the live
    ranges of the last two diagonals) takes exactly the class terms that
    live_terms counts by reachability, and every reachable cell lies among
    its diagonal's candidates: the indel machine (up and left), the
    all-class one, and the diag-only dense one, whose diagonals hold one
    candidate at most."""
    mats = _case(name)[0]
    names = wk.merged_operands(wk.prepare_merged(*mats),
                               torch.device("cpu")).names
    for il, ol in LIVE_LENGTHS:
        walk = walk_live_ranges(names, il, ol)
        terms, cells = wk.live_terms(names, [il], [ol])
        assert {k: sum(t[k] for *_, t in walk) for k in names} == terms
        assert sum(len(c) for _, _, c, _ in walk) - 1 == cells
        for d, (lo, hi, live, _) in enumerate(walk):
            assert all(lo <= i <= hi for i in live)
            assert all(0 <= d - i <= ol and i <= il for i in live)
        if names == ["diag"]:
            assert all(hi - lo <= 0 for lo, hi, _, _ in walk)
            assert sum(max(0, hi - lo + 1) for lo, hi, _, _ in walk) == \
                (min(il, ol) + 1 if il == ol else
                 sum(1 for lo, hi, _, _ in walk if lo <= hi))


def test_walk_launch_plan_by_shape():
    # the dense 64-state machine at 200 x 200: the rescale inside the
    # products, four blocks a multiprocessor, slots in L2; in shared memory
    # only when asked
    cfg = wk.walk_launch_plan(64, 200, 512, sms=132)
    assert (cfg["rescale_pass"], cfg["slots"], cfg["blocks_per_sm"],
            cfg["grid"]) == (False, "global", 4, 512)
    assert cfg["opts"] == 0 and cfg["live_range"]
    cfg = wk.walk_launch_plan(64, 200, 100, sms=132)
    assert (cfg["slots"], cfg["grid"]) == ("global", 100)
    cfg = wk.walk_launch_plan(64, 200, 100, sms=132, slots="shared")
    assert (cfg["slots"], cfg["blocks_per_sm"], cfg["grid"]) == \
        ("shared", 1, 100)
    assert cfg["opts"] == 4
    assert cfg["slot_bytes"] == 3 * 201 * 65 * 4
    # a state vector wider than a warp's 32 float4s takes the pass
    cfg = wk.walk_launch_plan(132, 64, 512, sms=132)
    assert cfg["rescale_pass"] and cfg["opts"] & 2
    with pytest.raises(ValueError):
        wk.walk_launch_plan(132, 64, 512, rescale_pass=False)
    # slots too large for a block stay in L2
    cfg = wk.walk_launch_plan(64, 2000, 16, sms=132)
    assert cfg["slots"] == "global"
    with pytest.raises(ValueError):
        wk.walk_launch_plan(64, 2000, 16, slots="shared")
    assert wk.walk_launch_plan(64, 200, 512, live_range=False)["opts"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("layout", WALK_LAYOUTS)
@pytest.mark.parametrize("name", list(CASES))
def test_walk_layouts_on_card(name, layout):
    """merged and chained_ragged in every walk layout: bit-equal to the
    plan's layout, within the card bound of the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    mats, it, ot, il, ol = _case(name)
    dev = torch.device("cuda")
    ops = wk.merged_operands(wk.prepare_merged(*mats), dev)
    batch = [torch.from_numpy(x).to(dev) for x in (it, ot, il, ol)]
    for fn, plain in ((wk.merged_wavefront, wk.merged_forward_plain),
                      (wk.chained_ragged_wavefront,
                       wk.chained_ragged_forward_plain)):
        ref = fn(ops, *batch).cpu().numpy()
        for grid in (None, 1):
            got = fn(ops, *batch, grid=grid, **layout).cpu().numpy()
            assert np.array_equal(got, ref)
        _assert_close(ref, plain(ops, *batch).cpu().numpy(), CARD_BOUND)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", [{}] + WALK_LAYOUTS)
def test_walk_flags_a_bad_token_as_nan_on_card(layout):
    """A token outside its alphabet, on either side, makes its pair NaN and
    no other; a pair whose bad token only a dead cell would read is NaN
    too, as every cell of the lattice reads its tokens."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    mats, it, ot, il, ol = _case("allclass")
    dev = torch.device("cuda")
    ops = wk.merged_operands(wk.prepare_merged(*mats), dev)
    it, ot = it.copy(), ot.copy()
    it[1, 2] = 2                   # outside the 2-letter alphabet
    ot[3, il[3] - 1] = -1
    batch = [torch.from_numpy(x).to(dev) for x in (it, ot, il, ol)]
    for fn in (wk.merged_wavefront, wk.chained_ragged_wavefront):
        res = fn(ops, *batch, **layout).cpu().numpy()
        assert np.isnan(res[[1, 3]]).all()
        assert not np.isnan(res[[0, 2, 4, 5]]).any()
