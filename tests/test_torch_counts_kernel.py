"""The E-step's backward (ops/kernels/counts_kernel.py,
csrc/expected_counts.cu): expected counts over the row kernel's Forward
and Backward lattices, under counts_kernel.RowLoglike.

On the CPU: expected_counts_plain on float64 lattices against
torch.autograd.grad through the eager row scan (dp2d.forward_2d_plain),
within 1e-6, on tkf91branch (silent closure), the indel transducer,
jukescantor, short prot2dna pairs and a generator (casino: an empty input
alphabet, which row_scan now takes); a ragged batch against its pairs one
by one (1e-9, float64); an impossible pair and a weight-0 pair drop out;
the kernel's own arithmetic in plain PyTorch (expected_counts_twin, on the
kernel's tables) against the plain version in float32 (1e-4 relative: the
twin takes the closure terms from the incoming and outgoing sums where the
plain version takes logsumexps); the tables; the route rule; the launch and
chunk plans as pure functions; a chunked backward against one chunk; the
rows route against the wavefront route through CountModel. The E-step's
counts against the JAX CountModel and the host are in
tests/test_torch_fwdback.py, which now runs this route.

On a CUDA card (marker cuda): the kernel against its plain version and its
twin on the card's own lattices (1e-5 + 1e-3 relative: float32 terms whose
exponents round at ~|LL| ulp, summed in other orders), the same bits run
to run and with the accumulators in global memory, and a failed launch
raising:
    python -m pytest --noconftest tests/test_torch_counts_kernel.py -m cuda
"""

import numpy as np
import pytest
import torch

from machineboss_tpu_torch import testmachines
from machineboss_tpu_torch.core.eval import EvaluatedMachine
from machineboss_tpu_torch.core.params import param_assign_from_json
from machineboss_tpu_torch.core.presets import make_preset
from machineboss_tpu_torch.core.seqpair import NamedSeq, SeqPair
from machineboss_tpu_torch.models import casino
from machineboss_tpu_torch.ops import dp2d
from machineboss_tpu_torch.ops.fwdback import CountModel, tokenize_batch
from machineboss_tpu_torch.ops.kernels import counts_kernel as ck
from machineboss_tpu_torch.ops.kernels import row_kernel as rk
from machineboss_tpu_torch.ops.semiring import LOGSUMEXP, NEG_INF

from one_thread import one_torch_thread  # noqa: F401

PLAIN_VS_AUTOGRAD = 1e-6         # float64: the same sums, another order
TWIN_VS_PLAIN = 1e-4             # relative, float32 (see the docstring)
CARD_RTOL, CARD_ATOL = 1e-3, 1e-5


def _sp(i, o):
    return SeqPair(NamedSeq("i", list(i)), NamedSeq("o", list(o)))


def _machines():
    tkf = make_preset("tkf91branch")
    jc = make_preset("jukescantor")
    p2d = make_preset("prot2dna")
    cas = casino.casino_machine(parameterized=False)
    return {
        "tkf91branch": (tkf, tkf.get_param_defs(True).combine(
            param_assign_from_json({"insRate": 0.1, "delRate": 0.2,
                                    "time": 0.5}), True),
            [("ACGT", "ACGGT"), ("", "AC"), ("GA", ""), ("AACG", "ACCG"),
             ("T", "T")]),
        "indel": (testmachines.build_indel_transducer(6, list("ACGT")), None,
                  [("ACGTA", "ACTA"), ("GGC", "GAGC"), ("T", "TT"),
                   ("CATG", "CAG")]),
        "jukescantor": (jc, jc.get_param_defs(True).combine(
            param_assign_from_json({"t": 0.3}), True),
            [("ACGT", "ACGA"), ("GGTA", "GCTA"), ("C", "C")]),
        "prot2dna": (p2d, None, testmachines.prot2dna_pairs(
            2, [3, 4], seed=2, synonymous=True)),
        "casino": (cas, None, [("", "1666"), ("", "62513"), ("", "6")]),
    }


_cache = {}


def _case(name, dtype=torch.float64):
    """(model, matrices, tokens, weights) of a machine's pairs."""
    key = (name, dtype)
    if key not in _cache:
        m, params, pairs = _machines()[name]
        ev = EvaluatedMachine(m, params or m.get_param_defs(True))
        model = CountModel(ev, dtype=dtype, device="cpu")
        mats = tuple(x.detach() for x in model.build_tensors(model.logw))
        toks = tokenize_batch(ev, [_sp(i, o) for i, o in pairs],
                              device="cpu")
        g = torch.tensor(np.random.RandomState(3).uniform(
            0.5, 2.0, len(pairs)), dtype=dtype)
        _cache[key] = (model, mats, toks, g)
    return _cache[key]


def _autograd(mats, toks, g):
    """The four gradients of sum_b g_b LL_b through the eager row scan."""
    leaves = [m.clone().requires_grad_(True) for m in mats]
    it, ot, il, ol = toks
    padded = rk.nonempty(*leaves[:3])
    lls = dp2d.forward_2d_plain(*padded, leaves[3], it, ot, il, ol)
    grads = torch.autograd.grad((lls * g).sum(), leaves, allow_unused=True)
    return [torch.zeros_like(m) if d is None else d
            for m, d in zip(mats, grads)]


def _lattices(mats, toks):
    it, ot, il, ol = toks
    return (rk.row_scan(*mats, it, ot, LOGSUMEXP),
            ck.backward_lattices(*mats, it, ot, il, ol))


def _close(got, want, tol, rtol=0.0):
    for a, b in zip(got, want):
        assert a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=tol,
                                   rtol=rtol)


NAMES = ["tkf91branch", "indel", "jukescantor", "prot2dna", "casino"]


@pytest.mark.parametrize("name", NAMES)
def test_plain_equals_autograd_through_the_row_scan(name):
    """The four gradients on float64 lattices equal autograd's through
    dp2d.forward_2d_plain within 1e-6, the closure's too (a silent
    machine, tkf91branch, has finite off-diagonal closure entries)."""
    _, mats, toks, g = _case(name)
    F, Br = _lattices(mats, toks)
    got = ck.expected_counts_plain(F, Br, *mats, *toks, g)
    want = _autograd(mats, toks, g)
    _close(got, want, PLAIN_VS_AUTOGRAD, PLAIN_VS_AUTOGRAD)
    assert all(torch.isfinite(x).all() for x in got)
    assert float(sum(x.sum() for x in got)) > 0
    if name == "tkf91branch":
        off = got[3] - torch.diag(torch.diag(got[3]))
        assert float(off.abs().max()) > 1e-3


def test_backward_lattices_are_dp2ds_per_pair():
    """Br, read in dp2d.backward_2d_lattice's orientation, is each pair's
    own Backward lattice inside its prefix (ragged: each pair reversed at
    its own length), and NEG_INF outside it."""
    _, mats, toks, _ = _case("indel")
    it, ot, il, ol = toks
    Bk = ck.unreversed(
        ck.backward_lattices(*mats, it, ot, il, ol), il, ol)
    for b in range(it.shape[0]):
        li, lo = int(il[b]), int(ol[b])
        want = dp2d.backward_2d_lattice(*mats, it[b, :li], ot[b, :lo])
        np.testing.assert_allclose(Bk[b, :lo + 1, :li + 1].numpy(),
                                   want.numpy(), atol=1e-9)
        assert (Bk[b, lo + 1:] == NEG_INF).all()
        assert (Bk[b, :, li + 1:] == NEG_INF).all()


def test_ragged_batch_equals_its_pairs_one_by_one():
    """A ragged batch padded to its longest pair gives the sum of its
    pairs' gradients, each pair alone at its own length (float64)."""
    _, mats, toks, g = _case("indel")
    it, ot, il, ol = toks
    F, Br = _lattices(mats, toks)
    got = ck.expected_counts_plain(F, Br, *mats, *toks, g)
    want = [torch.zeros_like(m) for m in mats]
    for b in range(it.shape[0]):
        one = (it[b:b + 1, :int(il[b])], ot[b:b + 1, :int(ol[b])],
               il[b:b + 1], ol[b:b + 1])
        for acc, x in zip(want, ck.expected_counts_plain(
                *_lattices(mats, one), *mats, *one, g[b:b + 1])):
            acc += x
    _close(got, want, 1e-9)


def test_impossible_and_weight_zero_pairs_drop_out():
    """A prot2dna pair with a base inserted inside a codon (no path) and
    a pair of weight 0 add nothing and bring no NaN."""
    model, mats, toks, g = _case("prot2dna")
    ev = model.ev
    pairs = _machines()["prot2dna"][2]
    a, dna = pairs[0]
    bad = _sp(a, dna[:4] + "C" + dna[4:])
    sps = [_sp(i, o) for i, o in pairs] + [bad, _sp(*pairs[1])]
    toks2 = tokenize_batch(ev, sps, device="cpu")
    g2 = torch.cat([g, torch.tensor([1.0, 0.0], dtype=g.dtype)])
    F, Br = _lattices(mats, toks2)
    assert F[2, int(toks2[3][2]), int(toks2[2][2]), -1] <= NEG_INF / 2
    got = ck.expected_counts_plain(F, Br, *mats, *toks2, g2)
    want = ck.expected_counts_plain(*_lattices(mats, toks), *mats, *toks, g)
    assert all(torch.isfinite(x).all() for x in got)
    _close(got, want, 1e-9)


@pytest.mark.parametrize("name", NAMES)
def test_twin_matches_plain(name):
    """The kernel's arithmetic (expected_counts_twin on counts_tables)
    against the plain version, float32 lattices: 1e-4 relative."""
    _, mats, toks, g = _case(name, torch.float32)
    F, Br = _lattices(mats, toks)
    tables = ck.counts_tables(*rk.nonempty(*mats[:3]), mats[3])
    sums = ck.expected_counts_twin(tables, F, Br, *toks, g)
    n_in, n_out = mats[1].shape[0], mats[2].shape[0]
    got = ck._unpad(ck.dense_grads(tables, sums, torch.float64), n_in,
                    n_out)
    want = ck.expected_counts_plain(F, Br, *mats, *toks, g)
    _close(got, [w.double() for w in want], 1e-6, TWIN_VS_PLAIN)


def test_tables_list_every_finite_entry_once():
    """Every finite entry of the four matrices is listed once in its
    column with its raw float32 value and its index, the index's flat
    position is the entry's, and the transposed lists hold each row's
    finite destinations."""
    _, mats, _, _ = _case("tkf91branch", torch.float32)
    tables = ck.counts_tables(*mats)
    S = tables.S
    M = torch.cat([mats[0].reshape(-1, S, S), mats[1], mats[2],
                   mats[3][None]])
    fin = M > NEG_INF / 2
    assert tables.n_fin == int(fin.sum())
    src, val, idx, cnt = ck._lists_back(tables.hdr_f, tables.ent_f,
                                        tables.n_mat, S)
    R = src.shape[-1]
    live = torch.arange(R) < cnt[..., None]
    m, j, _ = torch.nonzero(live, as_tuple=True)
    k, e, v = src[live], idx[live], val[live]
    assert torch.equal(torch.sort(e).values, torch.arange(tables.n_fin))
    assert torch.equal(tables.pos[e], (m * S + k) * S + j)
    assert torch.equal(v, M[m, k, j])
    assert torch.equal(cnt[:, :S], fin.sum(1))
    src_t, val_t, idx_t, cnt_t = ck._lists_back(tables.hdr_t, tables.ent_t,
                                                tables.n_mat, S)
    live = torch.arange(src_t.shape[-1]) < cnt_t[..., None]
    m, t, _ = torch.nonzero(live, as_tuple=True)
    assert torch.equal(val_t[live], M[m, t, src_t[live]])
    assert (idx_t[live] == -1).all()
    assert torch.equal(cnt_t[:, :S], fin.sum(2))


def test_route_rule(monkeypatch):
    """rows for float32 and 1..512 states, wavefront for anything else;
    CountModel takes it from the weights' dtype (the wavefront engine, a
    float32 engine, is stubbed for the float64 model), and a forced route
    wins."""
    from machineboss_tpu_torch.ops import fwdback
    for S in (1, 7, 132, 512):
        assert ck.estep_route(torch.float32, S) == "rows"
    assert ck.estep_route(torch.float32, 513) == "wavefront"
    for dt in (torch.float64, torch.float16, torch.bfloat16):
        assert ck.estep_route(dt, 7) == "wavefront"
    calls = []

    def wavefront(a_diag, *rest):
        calls.append(a_diag.dtype)
        return a_diag.sum() * 0.0 + torch.zeros(rest[3].shape[0],
                                                dtype=a_diag.dtype)

    model, _, toks, _ = _case("tkf91branch", torch.float32)
    model.counts_and_loglike(*toks)
    assert model.last_route == "rows"
    monkeypatch.setattr(fwdback, "forward_2d_wavefront_fast", wavefront)
    model64, _, toks64, _ = _case("tkf91branch", torch.float64)
    model64.counts_and_loglike(*toks64)
    assert model64.last_route == "wavefront" and calls == [torch.float64]
    model.route = "wavefront"
    try:
        model.counts_and_loglike(*toks)
        assert model.last_route == "wavefront"
        assert calls == [torch.float64, torch.float32]
    finally:
        model.route = None


@pytest.mark.parametrize("name", ["tkf91branch", "prot2dna", "casino"])
def test_rows_route_equals_the_wavefront_route(name):
    """Through CountModel, float32: the rows route's counts, total and
    lls against the wavefront route's (the function both differentiate),
    at the JAX tests' rtol 1e-3 / atol 1e-4."""
    model, _, toks, _ = _case(name, torch.float32)
    got = model.counts_and_loglike(*toks)
    assert model.last_route == "rows"
    model.route = "wavefront"
    try:
        want = model.counts_and_loglike(*toks)
    finally:
        model.route = None
    np.testing.assert_allclose(got[0].numpy(), want[0].numpy(), rtol=1e-3,
                               atol=1e-4)
    assert abs(float(got[1]) - float(want[1])) < 1e-3
    np.testing.assert_allclose(got[2].numpy(), want[2].numpy(), atol=1e-3)


def test_wavefront_route_saves_per_cell():
    """The wavefront route (forced) keeps what autograd saves per cell,
    not per token block: ops/wavefront_fast.py picks each cell's token
    block by indexing, where a gather would keep all Ti*To blocks of every
    diagonal (at prot2dna's B=128 x 64 x 192, more than an 80 GB card
    holds). The batch is doubled, so the machine's tables cancel out of
    the growth."""
    model, _, _, _ = _case("prot2dna", torch.float32)
    pairs = [_sp(i, o) for i, o in _machines()["prot2dna"][2]]

    def saved_bytes(sps):
        toks = tokenize_batch(model.ev, sps, device="cpu")
        storages = {}

        def keep(t):
            storages[t.untyped_storage().data_ptr()] = \
                t.untyped_storage().nbytes()
            return t

        logw = model.logw.clone().requires_grad_(True)
        with torch.autograd.graph.saved_tensors_hooks(keep, lambda t: t):
            model.batch_loglike(logw, *toks)
        return sum(storages.values()), toks

    model.route = "wavefront"
    try:
        one, toks = saved_bytes(pairs)
        two, _ = saved_bytes(pairs * 2)
        assert model.last_route == "wavefront"
    finally:
        model.route = None
    B, Li = toks[0].shape
    n_diag = Li + toks[1].shape[1]
    cell_bytes = B * (Li + 1) * model.n_states * 4   # one (B, W, S) slab
    assert cell_bytes < two - one < 12 * cell_bytes * n_diag


def test_row_scan_takes_an_empty_input_alphabet():
    """A generator's a_left is (0, S, S): row_scan gives that side one
    impossible token (nonempty), so a batch padded to one input position
    scores each pair of empty input, and a non-empty input has no path."""
    _, mats, toks, _ = _case("casino")
    it, ot, il, ol = toks
    assert mats[1].shape[0] == 0 and it.shape[1] == 1
    d, left, up = rk.nonempty(*mats[:3])
    assert left.shape == (1,) + mats[1].shape[1:] and (left == NEG_INF).all()
    assert d.shape[:2] == (1, mats[2].shape[0]) and up is mats[2]
    lls = rk.row_scan(*mats, it, ot, LOGSUMEXP, lens=(il, ol))
    for b in range(it.shape[0]):
        one = rk.row_scan(*mats, it[b, :0], ot[b, :int(ol[b])], LOGSUMEXP,
                          lens=(torch.tensor(0), ol[b]))
        assert float(lls[b]) == pytest.approx(float(one), abs=1e-9)
    bad = rk.row_scan(*mats, it, ot, LOGSUMEXP, lens=(il + 1, ol))
    assert (bad <= NEG_INF / 2).all()


def test_launch_plan():
    """Accumulators in shared memory while 16 warps' fit beside their
    workspaces, else global with the blocks cut to half the card's
    memory; blocks min(B, SMs); refusals past 512 states and where one
    block's accumulators do not fit."""
    cfg = ck.counts_launch_plan(132, 406, 128)
    assert cfg["acc"] == "shared" and cfg["blocks"] == 128
    assert cfg["smem_bytes"] == 16 * (2 * 132 + 406) * 4 <= ck.SMEM_MAX
    assert cfg["mem_bytes"] == 128 * 406 * 8 + 406 * 8
    assert ck.counts_launch_plan(132, 406, 1000)["blocks"] == ck.SMS
    assert ck.counts_launch_plan(132, 406, 4, sms=2)["blocks"] == 2
    g = ck.counts_launch_plan(132, 406, 128, acc="global")
    assert g["acc"] == "global" and g["smem_bytes"] == 16 * 264 * 4
    assert g["mem_bytes"] == 128 * (16 * 406 * 4 + 406 * 8) + 406 * 8
    big = 4 * 512 * 512 * 25
    cfg = ck.counts_launch_plan(512, big, 1000, mem_bytes=80 * 2 ** 30)
    assert cfg["acc"] == "global"
    assert cfg["blocks"] == (40 * 2 ** 30) // (16 * big * 4)
    assert cfg["smem_bytes"] == 16 * 1024 * 4
    with pytest.raises(ValueError, match="states"):
        ck.counts_launch_plan(513, 10, 4)
    with pytest.raises(ValueError, match="accumulators"):
        ck.counts_launch_plan(512, big, 4, mem_bytes=2 ** 20)
    with pytest.raises(ValueError, match="global"):
        ck.counts_launch_plan(4, 10, 4, acc="shared")


def test_chunk_plan():
    """Pairs a chunk: all without a memory bound; else as many pairs as
    two float32 lattices, a ring and the tokens a pair fit; one pair too
    large raises."""
    S, Li, Lo = 132, 64, 192
    lattice = (Lo + 1) * (Li + 1) * S * 4
    pair = 2 * lattice + 3 * (Li + 1) * (S + 1) * 4 + 16 * (Li + Lo)
    plan = ck.counts_chunk_plan(S, Li, Lo, 128)
    assert plan == {"pairs": 128, "chunks": 1, "pair_bytes": pair,
                    "mem_bytes": 128 * pair}
    plan = ck.counts_chunk_plan(S, Li, Lo, 10000, mem_bytes=80 * 10 ** 9)
    assert plan["pairs"] == 80 * 10 ** 9 // pair == 5990
    assert plan["chunks"] == -(-10000 // plan["pairs"])
    assert plan["mem_bytes"] <= 80 * 10 ** 9
    assert ck.counts_chunk_plan(S, Li, Lo, 3, mem_bytes=pair)["pairs"] == 1
    assert ck.counts_chunk_plan(S, Li, Lo, 0)["chunks"] == 0
    with pytest.raises(ValueError, match="E-step lattices"):
        ck.counts_chunk_plan(S, Li, Lo, 3, mem_bytes=pair - 1)


def test_chunked_backward_equals_one_chunk():
    """estep_backward in chunks of one pair (a memory bound of one pair)
    gives one chunk's gradients; it skips the weight-0 pair."""
    _, mats, toks, g = _case("tkf91branch")
    it, ot, il, ol = toks
    lls = dp2d.forward_2d_plain(*mats, it, ot, il, ol)
    w = g.clone()
    w[1] = 0.0
    one = ck.estep_backward(*mats, *toks, lls, w)
    assert ck.estep_backward.last["chunks"] == 1
    pair = ck.counts_chunk_plan(7, it.shape[1], ot.shape[1], 1)["pair_bytes"]
    got = ck.estep_backward(*mats, *toks, lls, w, mem_bytes=pair)
    assert ck.estep_backward.last == {"pairs": 4, "chunks": 4,
                                      "pairs_per_chunk": 1, "tables_ms": 0.0}
    _close(got, one, 1e-12)


def test_reversed_prefixes():
    toks = torch.tensor([[1, 2, 3, 4], [5, 6, 0, 0], [7, 0, 0, 0]])
    got = ck.reversed_prefixes(toks, torch.tensor([4, 2, 0]))
    assert got.tolist() == [[4, 3, 2, 1], [6, 5, 0, 0], [0, 0, 0, 0]]


def test_cpu_wrapper_is_the_plain_version():
    """expected_counts on CPU tensors returns the plain version's
    gradients bit for bit and counts no launch."""
    _, mats, toks, g = _case("indel", torch.float32)
    F, Br = _lattices(mats, toks)
    before = ck.expected_counts.launches
    got = ck.expected_counts(F, Br, *mats, *toks, g)
    assert ck.expected_counts.launches == before
    for a, b in zip(got, ck.expected_counts_plain(F, Br, *mats, *toks, g)):
        assert torch.equal(a, b)


# ---- on the card

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _on(x, dev):
    return tuple(t.to(dev) for t in x)


@pytest.mark.cuda
@pytest.mark.parametrize("name", NAMES)
def test_kernel_matches_plain_on_card(name):
    """The kernel on the card's own lattices against its plain version and
    its twin on the card; the same bits in a second launch and with the
    accumulators in global memory (the same float32 sums in the same
    order); one block (other float64 partials) within the tolerance."""
    dev = _card()
    _, mats, toks, g = _case(name, torch.float32)
    mats, toks, g = _on(mats, dev), _on(toks, dev), g.to(dev)
    F, Br = _lattices(mats, toks)
    before = ck.expected_counts.launches
    got = ck.expected_counts(F, Br, *mats, *toks, g)
    torch.cuda.synchronize()
    assert ck.expected_counts.launches == before + 1
    plain = ck.expected_counts_plain(F, Br, *mats, *toks, g)
    for a, b in zip(got, plain):
        np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(),
                                   rtol=CARD_RTOL, atol=CARD_ATOL)
    tables = ck.counts_tables(*rk.nonempty(*mats[:3]), mats[3])
    twin = ck._unpad(ck.dense_grads(tables, ck.expected_counts_twin(
        tables, F, Br, *toks, g), torch.float32), mats[1].shape[0],
        mats[2].shape[0])
    for a, b in zip(got, twin):
        np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(),
                                   rtol=CARD_RTOL, atol=CARD_ATOL)
    plan = ck.expected_counts.last["plan"]
    assert ck.counts_smem_bytes_on_card(
        tables.S, tables.n_fin, plan["acc"] == "shared") == \
        plan["smem_bytes"]
    again = ck.expected_counts(F, Br, *mats, *toks, g)
    glob = ck.expected_counts(F, Br, *mats, *toks, g, acc="global")
    assert ck.expected_counts.last["plan"]["acc"] == "global"
    for a, b, c in zip(got, again, glob):
        assert torch.equal(a, b) and torch.equal(a, c)
    for a, b in zip(got, ck.expected_counts(F, Br, *mats, *toks, g,
                                            blocks=1)):
        np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(),
                                   rtol=1e-6, atol=1e-7)


@pytest.mark.cuda
def test_estep_on_card_launches_the_kernels():
    """CountModel's E-step on the card: row_scan three times (the score,
    a Forward and a Backward lattice) and expected_counts once for a
    batch that fits one chunk, and the CPU's counts within 1e-5."""
    dev = _card()
    model, _, toks, _ = _case("indel", torch.float32)
    card = CountModel(model.ev, device=dev)
    rk.row_scan.launches = 0
    ck.expected_counts.launches = 0
    grads, total, _ = card.counts_and_loglike(*_on(toks, dev))
    torch.cuda.synchronize()
    assert card.last_route == "rows"
    assert (rk.row_scan.launches, ck.expected_counts.launches) == (3, 1)
    cpu, cpu_total, _ = model.counts_and_loglike(*toks)
    np.testing.assert_allclose(grads.cpu().numpy(), cpu.numpy(), rtol=1e-5,
                               atol=1e-5)
    assert abs(float(total) - float(cpu_total)) < 1e-4


@pytest.mark.cuda
def test_failed_launch_raises():
    """A launch the kernel refuses (no block) raises, counts nothing."""
    dev = _card()
    _, mats, toks, g = _case("indel", torch.float32)
    mats, toks, g = _on(mats, dev), _on(toks, dev), g.to(dev)
    F, Br = _lattices(mats, toks)
    before = ck.expected_counts.launches
    with pytest.raises(RuntimeError, match="launch failed"):
        ck.expected_counts(F, Br, *mats, *toks, g, blocks=0)
    assert ck.expected_counts.launches == before
    with pytest.raises(TypeError, match="float32"):
        ck.expected_counts(F.double(), Br, *mats, *toks, g)
