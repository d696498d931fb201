"""The port's 1D scan (ops/kernels/scan1d_kernel.py) against the JAX kernel
and a float64 loop.

scan1d_forward_plain (the CPU path of make_forward_1d_kernel) is held to
the JAX package's make_forward_1d_pallas in its own CPU mode
(interpret=True) and to a float64 probability-space loop, with ragged
lengths, a -1 pad token inside a sequence, a sequence that loses all its
mass, and L long enough for many renormalisations. Bound: 1e-4 nats (f32
products over up to 150 positions; the final log runs in f64 on both
sides). On a CUDA card the kernel is held to the plain version: the
exponents and dead flags equal, the log-likelihoods within 1e-3 nats.

The JAX package is imported inside the tests that use it, so that the card
tests run where only torch is installed:
    python -m pytest --noconftest tests/test_torch_scan1d.py -m cuda
"""

import numpy as np
import pytest
import torch

from machineboss_tpu_torch import testmachines
from machineboss_tpu_torch.convert import scan1d_from_numpy
from machineboss_tpu_torch.core.eval import EvaluatedMachine
from machineboss_tpu_torch.ops.kernels import scan1d_kernel as sk
from machineboss_tpu_torch.ops.lowering import LoweredMachine

BOUND = 1e-4        # nats, plain vs JAX interpret and vs the f64 loop
CARD_BOUND = 1e-3   # nats, kernel vs plain on the card
CASES = ["small", "long", "wide", "ntok20"]
AMINO = "ACDEFGHIKLMNPQRSTVWY"
_cache = {}


def _case(name):
    """(trans, closure, toks, lens) as numpy, from seeds. 'small' is the
    JAX kernel's own CPU size (S=6, L=37, B=5); 'long' has 150 positions
    (37 renormalisations) and a dead sequence; 'wide' has 41 states with
    End, more than a warp's lanes; 'ntok20' a 20-letter alphabet over 10
    states."""
    if name in _cache:
        return _cache[name]
    S, B, L, seed = {"small": (6, 5, 37, 1), "long": (6, 6, 150, 2),
                     "wide": (40, 3, 70, 3), "ntok20": (9, 5, 60, 4)}[name]
    m = testmachines.build_generator_1d(
        S, alphabet=AMINO if name == "ntok20" else "ACGT", seed=seed)
    ev = EvaluatedMachine(m, m.get_param_defs(True))
    trans, closure = (np.asarray(x) for x in LoweredMachine(
        ev, dtype=np.float32).emit_matrices_1d(output_side=True))
    rng = np.random.RandomState(seed)
    toks = rng.randint(0, trans.shape[0], (B, L)).astype(np.int32)
    lens = rng.randint(L // 2, L + 1, B).astype(np.int32)
    lens[0] = L
    if name in ("small", "long", "ntok20"):
        lens[1] = 0
        toks[2, 5] = -1          # a pad token inside a sequence: skipped
        toks[4, lens[4]:] = -1   # and as padding past a sequence's end
    if name == "long":
        toks[3, 40] = trans.shape[0]     # outside the alphabet: no mass
        lens[3] = L
    _cache[name] = (trans, closure, toks, lens)
    return _cache[name]


def _port(name, device="cpu", renorm_every=4):
    trans, closure, toks, lens = _case(name)
    fn = sk.make_forward_1d_kernel(trans, closure, *toks.shape,
                                   device=device, renorm_every=renorm_every)
    return fn(toks, lens)


def _assert_close(got, ref, bound):
    for b in range(len(ref)):
        if ref[b] <= -1e29:
            assert got[b] <= -1e29, (b, got[b])
        else:
            assert abs(got[b] - ref[b]) <= bound, (b, got[b], ref[b])


@pytest.mark.parametrize("name", CASES)
def test_plain_matches_jax_interpret(name):
    import jax.numpy as jnp
    from machineboss_tpu.ops.pallas.scan1d_kernel import \
        make_forward_1d_pallas
    trans, closure, toks, lens = _case(name)
    jfn = make_forward_1d_pallas(trans, closure, *toks.shape, interpret=True)
    got = _port(name)
    assert got.dtype == np.float64 and got.shape == lens.shape
    _assert_close(got, jfn(jnp.array(toks), jnp.array(lens)), BOUND)


@pytest.mark.parametrize("name", CASES)
def test_plain_matches_f64_loop(name):
    trans, closure, toks, lens = _case(name)
    ref = testmachines.forward_1d_f64(trans, closure, toks, lens)
    if name != "wide":
        # the scan adds the shift g back as len * g, as the JAX kernel
        # does, so a skipped position inside a sequence still counts one g
        # (negative tokens are meant for the padding past the length)
        ref[2] += sk.prepare_scan1d(trans, closure)[2]
    got = _port(name)
    _assert_close(got, ref, BOUND)
    if name == "long":
        assert got[3] <= -1e29 and np.isfinite(got[[0, 2, 4, 5]]).all()
        assert got[1] == pytest.approx(np.log(0.05), abs=1e-6)


def test_host_prep_equals_jax_operands():
    """em is the JAX factory's exp-shifted matrix before its transpose,
    c0 its start column, bit for bit (the factory closes them into its
    jitted call as constants)."""
    import jax
    import jax.numpy as jnp
    from machineboss_tpu.ops.pallas.scan1d_kernel import \
        make_forward_1d_pallas
    trans, closure, toks, lens = _case("small")
    B, L = toks.shape
    jfn = make_forward_1d_pallas(trans, closure, B, L, interpret=True)
    jit_eqn = [e for e in jax.make_jaxpr(jfn.device_call)(
        jnp.array(toks), jnp.array(lens)).jaxpr.eqns
        if "jaxpr" in e.params][0]
    consts = {np.asarray(c).shape: np.asarray(c)
              for c in jit_eqn.params["jaxpr"].consts}
    em, c0, g = sk.prepare_scan1d(trans, closure)
    n_tok, S, _ = em.shape
    em_t = consts[(n_tok * S, S)].reshape(n_tok, S, S)
    assert np.array_equal(np.transpose(em, (0, 2, 1)), em_t)
    c0b = [v for k, v in consts.items() if len(k) == 2 and k[0] == S
           and k != (n_tok * S, S)][0]
    assert np.array_equal(c0b[:, 0], c0)
    assert g == float(np.max(trans.astype(np.float64)))
    ops = scan1d_from_numpy(trans, closure, device="cpu")
    assert np.array_equal(ops.em.numpy(), em) and ops.g == g


@pytest.mark.parametrize("renorm_every", [1, 3, 16])
def test_renorm_schedule_is_exact(renorm_every):
    # the scaling is an exact power of two, so the schedule changes no bit
    # of mantissa * 2^exponent as long as nothing underflows
    trans, closure, toks, lens = _case("small")
    ops = scan1d_from_numpy(trans, closure, device="cpu")
    t, n = torch.from_numpy(toks), torch.from_numpy(lens)
    a = sk.scan1d_forward_plain(ops, t, n, renorm_every).double()
    b = sk.scan1d_forward_plain(ops, t, n, 4).double()
    assert torch.equal(a[0] * 2.0 ** a[1], b[0] * 2.0 ** b[1])
    assert torch.equal(a[2], b[2])


def test_exponent_convention_is_the_kernels():
    """A max in [1, 2) leaves the exponent alone; the plain version scales
    by the power of two of the biased-exponent field, as the kernel does,
    not by frexp's (one more)."""
    em = np.zeros((1, 2, 2), np.float32)
    em[0] = [[1.5, 0.0], [0.0, 3.0]]
    ops = sk.scan1d_operands(em, np.array([1.0, 1.0], np.float32), 0.0,
                             torch.device("cpu"))
    toks = torch.zeros((1, 4), dtype=torch.int32)
    out = sk.scan1d_forward_plain(ops, toks, torch.tensor([4]), 1)
    # renormalised every step, the maxima are 3, 4.5, 3.375 and 5.0625:
    # exponents 1 + 2 + 1 + 2, and 3^4 = 81 leaves the mantissa 81 / 64 in
    # [1, 2) (frexp's convention would give 81 / 128 and 7)
    assert float(out[1, 0]) == 6.0
    assert float(out[0, 0]) == 81.0 / 64.0


def test_cpu_wrapper_takes_plain_without_launch():
    trans, closure, toks, lens = _case("small")
    ops = scan1d_from_numpy(trans, closure, device="cpu")
    t, n = torch.from_numpy(toks), torch.from_numpy(lens)
    before = sk.scan1d_forward.launches
    out = sk.scan1d_forward(ops, t, n)
    assert sk.scan1d_forward.launches == before
    assert torch.equal(out, sk.scan1d_forward_plain(ops, t, n))


@pytest.mark.cuda
@pytest.mark.parametrize("threads", [None, 32, 128])
@pytest.mark.parametrize("name", CASES)
def test_kernel_matches_plain_on_card(name, threads):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    trans, closure, toks, lens = _case(name)
    dev = torch.device("cuda")
    ops = scan1d_from_numpy(trans, closure, device=dev)
    t = torch.from_numpy(toks).to(dev)
    n = torch.from_numpy(lens).to(dev)
    before = sk.scan1d_forward.launches
    kern = sk.scan1d_forward(ops, t, n, threads=threads)
    assert sk.scan1d_forward.launches == before + 1
    plain = sk.scan1d_forward_plain(ops, t, n)
    assert torch.equal(kern[1:], plain[1:])      # exponents and dead flags
    _assert_close(sk.scan1d_loglike(kern.cpu().numpy(), lens, ops.g),
                  _port(name), CARD_BOUND)


# ------------------------------------------------ the kernel's plan (CPU)

def csr_to_dense(ent, meta, S):
    """em (n_tok, S, S) float32 rebuilt from scan1d_tables' output: every
    entry whose value is not zero, at its source and its group's
    destination."""
    n_tok, rows, terms, lanes, _ = ent.shape
    em = np.zeros((n_tok, S, S), np.float32)
    vals = ent[..., 1].copy().view(np.float32)
    lg = (meta >> 16) & 15
    for r in range(rows):
        for lane in range(lanes):
            owner = lane & ~((1 << lg[r, lane]) - 1)
            d = meta[r, owner] & 0xFFFF
            for t in range(n_tok):
                for k in range(terms):
                    if vals[t, r, k, lane] != 0:
                        em[t, ent[t, r, k, lane, 0], d] = vals[t, r, k, lane]
    return em


def csr_product(ent, meta, p, tok, S):
    """p @ em[tok] through the tables, as the kernel sums it: each lane's
    segment in order, then its group's segments (float64 numpy)."""
    _, rows, terms, lanes, _ = ent.shape
    vals = ent[tok, ..., 1].copy().view(np.float32).astype(np.float64)
    seg = (np.asarray(p, np.float64)[ent[tok, ..., 0]] * vals).sum(axis=1)
    out = np.zeros(S)
    for r in range(rows):
        for lane in range(lanes):
            d = meta[r, lane] & 0xFFFF
            if d != 0xFFFF:
                g = 1 << ((meta[r, lane] >> 16) & 15)
                out[d] = seg[r, lane:lane + g].sum()
    return out


def _em(name):
    trans, closure, _, _ = _case(name)
    return sk.prepare_scan1d(trans, closure)[0]


def _every_entry(n_tok=4, S=64, seed=7):
    rng = np.random.RandomState(seed)
    return np.exp(rng.uniform(-6.0, -2.0, (n_tok, S, S))).astype(np.float32)


def _dense1d_em():
    rng = np.random.RandomState(42)
    m = testmachines.build_generator_1d(64, rng=rng)
    ev = EvaluatedMachine(m, m.get_param_defs(True))
    trans, closure = (np.asarray(x) for x in LoweredMachine(
        ev, dtype=np.float32).emit_matrices_1d(output_side=True))
    return sk.prepare_scan1d(trans, closure)[0]


EMS = {"small": lambda: _em("small"), "wide": lambda: _em("wide"),
       "ntok20": lambda: _em("ntok20"), "dense1d": _dense1d_em,
       "every_entry": _every_entry}


@pytest.mark.parametrize("lanes", [32, 64, 128])
@pytest.mark.parametrize("which", list(EMS))
def test_csr_rebuilds_em_exactly(which, lanes):
    """Every nonzero of EM[t] sits once in the tables, at its source and
    its group's destination, in source order along a destination's lanes;
    nothing else is nonzero."""
    em = EMS[which]()
    n_tok, S, _ = em.shape
    try:
        plan = sk.scan1d_launch_plan(n_tok, S, sk.column_counts(em), 8,
                                     threads=lanes, mode="csr",
                                     sinks=sk.source_free(em))
    except ValueError:
        return
    # the plan's own layout (csr_pf pads its tables), then others
    for terms in (None, 1, 2, 3, 4, 6, 8, 64):
        cfg = plan if terms is None else dict(plan, terms=terms, mode="csr")
        try:
            ent, meta = sk.scan1d_tables(em, cfg)
        except ValueError:                 # a column longer than a warp
            assert terms * 32 < sk.column_counts(em).max()
            continue
        assert np.array_equal(csr_to_dense(ent, meta, S), em)
        # each destination has exactly one owner lane, and the sources of
        # a destination's segments run in source order
        dest = meta & 0xFFFF
        owned = dest[dest != 0xFFFF]
        assert sorted(owned.tolist()) == list(range(S))
        lg = (meta >> 16) & 15
        rows = meta.shape[0]
        for t in range(n_tok):
            for r in range(rows):
                for l0 in range(lanes):
                    if dest[r, l0] == 0xFFFF:
                        continue
                    g = 1 << lg[r, l0]
                    e = ent[t, r, :, l0:l0 + g]          # (terms, g)
                    vals = e[..., 1].copy().view(np.float32)
                    src = e[..., 0].T.reshape(-1)[vals.T.reshape(-1) != 0]
                    assert np.all(np.diff(src) > 0)
        # the source-free states' rows come after every other row
        live = sk._csr_layout(sk.column_counts(em), lanes, cfg["terms"],
                              sk.source_free(em))[3]
        free = sk.source_free(em)
        assert not free[dest[:live][dest[:live] != 0xFFFF]].any()
        assert free[dest[live:][dest[live:] != 0xFFFF]].all()


@pytest.mark.parametrize("which", list(EMS))
def test_csr_product_equals_dense_product(which):
    em = EMS[which]()
    n_tok, S, _ = em.shape
    cfg = sk.scan1d_launch_plan(n_tok, S, sk.column_counts(em), 256,
                                mode="csr", sinks=sk.source_free(em))
    ent, meta = sk.scan1d_tables(em, cfg)
    rng = np.random.RandomState(0)
    for t in range(n_tok):
        p = rng.rand(S)
        got = csr_product(ent, meta, p, t, S)
        want = p @ em[t].astype(np.float64)
        assert np.allclose(got, want, rtol=1e-12, atol=0)
        # small integers: every sum exact, whatever its order
        pi = rng.randint(0, 8, S).astype(np.float64)
        emi = np.where(em[t] != 0, rng.randint(1, 8, em[t].shape), 0)
        ent_i, meta_i = sk.scan1d_tables(
            np.broadcast_to(emi.astype(np.float32), em.shape).copy(), cfg)
        assert np.array_equal(csr_product(ent_i, meta_i, pi, t, S),
                              pi @ emi)


def test_launch_plan_chooses_by_shape():
    dense1d = _dense1d_em()
    n_tok, S, _ = dense1d.shape
    nnz = sk.column_counts(dense1d)
    assert int((dense1d != 0).sum()) == 4 * 128      # 128 of 65 * 65 a token
    # the 64-state generator: its nonzeros only, one warp a sequence, the
    # entries in registers, two sequences a block over 132 multiprocessors;
    # End, no entry's source, in a row of its own computed only when the
    # max or the readout needs it
    free = sk.source_free(dense1d)
    assert free.nonzero()[0].tolist() == [S - 1]
    cfg = sk.scan1d_launch_plan(n_tok, S, nnz, 256, sinks=free)
    assert (cfg["mode"], cfg["lanes"], cfg["groups"], cfg["grid"]) == \
        ("csr_pf", 32, 2, 128)
    assert cfg["smem_plan"] and cfg["pf_shape"] == [3, 6]
    assert cfg["rows"] <= 3 and cfg["terms"] <= 6
    assert cfg["live_rows"] == cfg["rows"] - 1
    assert cfg["levels"][0] == 0 and cfg["levels"][1] >= 1
    # a block a sequence for a small batch; more sequences a block for a
    # large one, up to 256 threads with the entries in registers
    assert sk.scan1d_launch_plan(n_tok, S, nnz, 8, sinks=free)["groups"] \
        == 1
    assert sk.scan1d_launch_plan(n_tok, S, nnz, 8192,
                                 sinks=free)["groups"] == 8
    # every entry finite: whole dense columns, one a lane
    full = np.full((4, 64), 64)
    cfg = sk.scan1d_launch_plan(4, 64, full, 256)
    assert (cfg["mode"], cfg["lanes"]) == ("dense", 64)
    assert sk.scan1d_launch_plan(4, 64, full, 256, mode="csr")["mode"] \
        == "csr"
    # wider machines take more warps; a plan too large for shared memory
    # is read through the cache
    cfg = sk.scan1d_launch_plan(4, 200, np.full((4, 200), 200), 256)
    assert (cfg["mode"], cfg["lanes"]) == ("dense", 224)
    assert not cfg["smem_plan"]
    cfg = sk.scan1d_launch_plan(4, 600, np.full((4, 600), 600), 256)
    assert (cfg["mode"], cfg["lanes"]) == ("dense", 512)
    cfg = sk.scan1d_launch_plan(4, 600, np.full((4, 600), 12), 256)
    assert cfg["mode"].startswith("csr") and cfg["lanes"] > 32
    # the caller's lanes are kept
    cfg = sk.scan1d_launch_plan(n_tok, S, nnz, 256, threads=128,
                                sinks=free)
    assert cfg["lanes"] == 128 and cfg["warps"] == 4
    assert cfg["groups"] * cfg["lanes"] <= 512
    # the shared bytes: the plan, then each sequence's p, tokens, maxima
    cfg = sk.scan1d_launch_plan(n_tok, S, nnz, 256, sinks=free)
    assert cfg["smem"] == 4 * cfg["plan_words"] + cfg["groups"] * 4 * (
        2 * cfg["SP"] + 4 * 128 + 2 * 32)
    with pytest.raises(ValueError):
        sk.scan1d_launch_plan(4, 5000, np.full((4, 5000), 5000), 256)
    with pytest.raises(ValueError):
        sk.scan1d_launch_plan(n_tok, S, nnz, 256, threads=48)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", [None, "block_barrier", "tokens_global",
                                     "renorm_barrier"])
@pytest.mark.parametrize("mode", [None, "csr", "dense"])
@pytest.mark.parametrize("threads", [None, 32, 64, 128])
@pytest.mark.parametrize("name", CASES)
def test_kernel_layouts_on_card(name, threads, mode, variant):
    """Every layout the plan allows (lanes, sparse lists or dense columns)
    and every variant, held to the plain version as the default layout
    is."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    trans, closure, toks, lens = _case(name)
    dev = torch.device("cuda")
    ops = scan1d_from_numpy(trans, closure, device=dev)
    t = torch.from_numpy(toks).to(dev)
    n = torch.from_numpy(lens).to(dev)
    kern = sk.scan1d_forward(ops, t, n, threads=threads, mode=mode,
                             variant=variant)
    plain = sk.scan1d_forward_plain(ops, t, n)
    assert torch.equal(kern[1:], plain[1:])
    _assert_close(sk.scan1d_loglike(kern.cpu().numpy(), lens, ops.g),
                  sk.scan1d_loglike(plain.cpu().numpy(), lens, ops.g),
                  CARD_BOUND)
