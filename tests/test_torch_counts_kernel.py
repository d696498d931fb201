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
kernel's compact lists, strips and reduction order) against the plain
version in float32 (1e-4 relative: the twin takes the closure terms from
the incoming and outgoing sums where the plain version takes logsumexps);
its segmented sums against per-destination sums; the tables; the route
rule; the launch and chunk plans as pure functions; a chunked backward
against one chunk; the rows route against the wavefront route through
CountModel. The E-step's
counts against the JAX CountModel and the host are in
tests/test_torch_fwdback.py, which now runs this route.

On a CUDA card (marker cuda): the kernel against its plain version and its
twin on the card's own lattices (1e-5 + 1e-3 relative: float32 terms whose
exponents round at ~|LL| ulp, summed in other orders), the same bits run
to run and with the sums in global memory, every layout the plan gives
(a pair's units over one block and over many, B = 1, 16, 128, and the
512-state machine's tables in global memory), and a failed launch
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
    """The strips kernel's arithmetic (expected_counts_twin on
    counts_tables, the default plan's units and reduction order, and
    units over 3 rows on two blocks, as the plan gives a larger batch)
    against the plain version, float32 lattices: 1e-4 relative."""
    _, mats, toks, g = _case(name, torch.float32)
    F, Br = _lattices(mats, toks)
    tables = ck.counts_tables(*rk.nonempty(*mats[:3]), mats[3])
    n_in, n_out = mats[1].shape[0], mats[2].shape[0]
    want = ck.expected_counts_plain(F, Br, *mats, *toks, g)
    B, Lo1, Li1, S = F.shape
    for plan in (None, dict(ck.counts_launch_plan(
            S, tables.n_mat, tables.n_fin, B, Li1 - 1, Lo1 - 1, sms=2),
            R=3)):
        sums = ck.expected_counts_twin(tables, F, Br, *toks, g, plan=plan)
        got = ck._unpad(ck.dense_grads(tables, sums, torch.float64), n_in,
                        n_out)
        _close(got, [w.double() for w in want], 1e-6, TWIN_VS_PLAIN)


def _unpack(off, ent):
    """(matrix, state, other, run tail, run head, value, index) of every
    entry of compact lists."""
    off = off.long()
    n = ent.shape[0]
    m = torch.repeat_interleave(torch.arange(len(off) - 1), off[1:] - off[:-1])
    key = ent[:, 0].long()
    return (m, key & 0x3ff, (key >> 16) & 0x3ff, (key >> 10) & 31,
            (key >> 15) & 1, ent[:, 1].contiguous().view(torch.float32),
            torch.arange(n) - off[m])


def test_tables_list_every_finite_entry_once():
    """The compact lists: every finite entry of the four matrices once,
    sorted by (matrix, destination, source) but the closure's S diagonal
    entries leading its list (cdiag), with its raw float32 value,
    and its row (its index among the finite entries) at its flat position
    in pos; each key's run bits (the run's last lane and first flag in its
    group of 32) those of its destination's run, and its group's shuffle
    steps ceil(log2) of the group's longest run; the transposed lists the
    same entries sorted by (matrix, source, destination)."""
    _, mats, _, _ = _case("prot2dna", torch.float32)
    tables = ck.counts_tables(*mats)
    S = tables.S
    M = torch.cat([mats[0].reshape(-1, S, S), mats[1], mats[2],
                   mats[3][None]])
    fin = M > NEG_INF / 2
    n = tables.n_fin
    assert n == int(fin.sum()) and tables.off_f[-1] == n
    assert tables.nbytes == 2 * 4 * (tables.n_mat + 1) + 2 * 8 * n
    for off, ent, by in ((tables.off_f, tables.ent_f, "dst"),
                         (tables.off_t, tables.ent_t, "src")):
        m, a, b, tail, head, val, rank = _unpack(off, ent)
        src, dst = (b, a) if by == "dst" else (a, b)
        order = (m * S + a) * S + b
        if by == "dst":                 # the closure's diagonal leads it
            assert tables.cdiag
            diag = (m == tables.n_mat - 1) & (a == b)
            rest = (m == tables.n_mat - 1) & (a != b)
            order = (m * 2 + rest) * S * S + torch.where(diag, a, a * S + b)
            first = int(off[-2])
            assert torch.equal(a[first:first + S], torch.arange(S))
            assert torch.equal(b[first:first + S], torch.arange(S))
        assert (order[1:] > order[:-1]).all()          # sorted, no repeats
        assert torch.equal(val, M[m, src, dst])
        assert int(fin[m, src, dst].sum()) == n
        lane, group = rank % 32, rank // 32
        same = torch.zeros(n, dtype=torch.bool)
        same[1:] = (m[1:] == m[:-1]) & (a[1:] == a[:-1]) \
            & (group[1:] == group[:-1])
        assert torch.equal(head == 1, ~same)
        last = torch.ones(n, dtype=torch.bool)
        last[:-1] = ~same[1:]
        run = torch.cumsum(~same, 0) - 1
        assert torch.equal(tail, lane[last][run])
        steps = (ent[:, 0].long() >> 26) & 7
        length = torch.zeros(n, dtype=torch.long)
        length[head == 1] = (tail - lane + 1)[head == 1]
        gid = (m * 10 ** 6 + group).tolist()
        longest = {}
        for gkey, ln in zip(gid, length.tolist()):
            longest[gkey] = max(longest.get(gkey, 0), ln)
        want = [(longest[gkey] - 1).bit_length() for gkey in gid]
        assert steps.tolist() == want
        if by == "dst":
            assert torch.equal(tables.pos, (m * S + src) * S + dst)


def test_segmented_sums_match_per_destination_sums():
    """The twin's segmented reduction (run_sums' shuffle tree, add_runs
    group by group, as the kernel adds them) over random terms on
    prot2dna's lists (every matrix, its groups of 32) against a
    plain per-destination sum in float64, within 1e-6, and the same bits
    on a second run."""
    _, mats, _, _ = _case("prot2dna", torch.float32)
    tables = ck.counts_tables(*mats)
    S = tables.S
    for off, ent in ((tables.off_f, tables.ent_f),
                     (tables.off_t, tables.ent_t)):
        key, _, cnt = ck._padded_lists(off, ent, tables.n_mat)
        rng = np.random.RandomState(4)
        t = torch.from_numpy(rng.uniform(0, 1, key.shape)).float()
        t = torch.where(torch.arange(key.shape[1]) < cnt[:, None], t, 0.0)
        def sums():
            return ck.add_runs(torch.zeros((key.shape[0], S)),
                               ck.run_sums(t, key))

        got = sums()
        want = torch.zeros((key.shape[0], S), dtype=torch.float64) \
            .scatter_add_(1, key & 0x3ff, t.double())
        np.testing.assert_allclose(got.double().numpy(), want.numpy(),
                                   rtol=0, atol=1e-6)
        assert torch.equal(got, sums())


def test_route_rule(monkeypatch):
    """rows for float32 and float64 at 1..512 states (float64 on float32
    copies of the matrices), wavefront for more states or another dtype;
    CountModel takes it from the weights' dtype and returns the float64
    model's counts in float64 without calling the wavefront engine
    (stubbed), and a forced route wins."""
    from machineboss_tpu_torch.ops import fwdback
    for dt in (torch.float32, torch.float64):
        for S in (1, 7, 132, 512):
            assert ck.estep_route(dt, S) == "rows"
        assert ck.estep_route(dt, 513) == "wavefront"
    for dt in (torch.float16, torch.bfloat16):
        assert ck.estep_route(dt, 7) == "wavefront"
    calls = []

    def wavefront(a_diag, *rest):
        calls.append(a_diag.dtype)
        return a_diag.sum() * 0.0 + torch.zeros(rest[3].shape[0],
                                                dtype=a_diag.dtype)

    monkeypatch.setattr(fwdback, "forward_2d_wavefront_fast", wavefront)
    model, _, toks, _ = _case("tkf91branch", torch.float32)
    model.counts_and_loglike(*toks)
    assert model.last_route == "rows"
    model64, _, toks64, _ = _case("tkf91branch", torch.float64)
    got = model64.counts_and_loglike(*toks64)
    assert model64.last_route == "rows" and not calls
    assert got[0].dtype == got[2].dtype == torch.float64
    model.route = "wavefront"
    try:
        model.counts_and_loglike(*toks)
        assert model.last_route == "wavefront"
        assert calls == [torch.float32]
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
    """prot2dna (132 states, 105 matrices, 406 finite entries) at 64 x 192:
    strips of 2 cells (STRIP_T), the most warps (16, the launch bound) whose six
    staging rows, tables and shared sums fit a block; units of R rows, R
    leaving each warp of the card 8 units (B=1: 1 row, B=16: 6, B=128:
    the most, 32); every SM a block whatever the batch (B=1: 132 blocks on
    the one pair, B=16: 8.25 a pair, B=128: 1.03); the sums forced
    global; the 512-state machine (25 matrices, 9,199 finite entries: its
    tables past a quarter of a block's shared memory) with tables and
    sums global on 5 warps, a block an SM; refusals past 512 states and
    where one block's global sums pass the card's memory."""
    for B, R, per_pair in ((1, 1, 132.0), (16, 6, 8.25),
                           (128, 32, 132 / 128)):
        cfg = ck.counts_launch_plan(132, 105, 406, B, 64, 192)
        assert (cfg["T"], cfg["R"], cfg["warps"], cfg["threads"]) == \
            (2, R, 16, 512)
        assert cfg["units"] == B * (-(-193 // R)) * 33
        assert cfg["blocks"] == ck.SMS and cfg["blocks_per_sm"] == 1
        assert cfg["blocks_per_pair"] == per_pair
        assert (cfg["tables"], cfg["acc"]) == ("shared", "shared")
        assert cfg["smem_bytes"] == ck.counts_smem_bytes(
            132, 2, 16, 105, 406, True, True) <= ck.SMEM_MAX
        assert cfg["mem_bytes"] == 132 * 406 * 8 + 406 * 8
    seg = 3 * 132 + 8
    assert ck.counts_smem_bytes(132, 2, 16, 105, 406, True, True) == (
        16 * 8 + 16 * 6 * seg * 4 + ((2 * 106 * 4 + 7) & ~7) + 16 * 406
        + 16 * 2 * 132 * 4 + 16 * 406 * 4)
    g = ck.counts_launch_plan(132, 105, 406, 128, 64, 192, acc="global")
    assert (g["tables"], g["acc"], g["warps"]) == ("shared", "global", 16)
    assert g["mem_bytes"] == 132 * (16 * 406 * 4 + 406 * 8) + 406 * 8
    small = ck.counts_launch_plan(132, 105, 406, 1, 3, 2, sms=8)
    assert (small["units"], small["blocks"]) == (6, 1)
    wide = ck.counts_launch_plan(512, 25, 9199, 8, 32, 32,
                                 mem_bytes=80 * 2 ** 30)
    assert (wide["tables"], wide["acc"], wide["T"], wide["R"],
            wide["warps"]) == ("global", "global", 2, 1, 5)
    assert (wide["units"], wide["blocks"]) == (8 * 33 * 17, ck.SMS)
    assert wide["smem_bytes"] == ck.counts_smem_bytes(
        512, 2, 5, 25, 9199, False, False)
    big = 512 * 512
    cfg = ck.counts_launch_plan(512, 25, big, 8, 64, 64,
                                mem_bytes=80 * 2 ** 30)
    assert (cfg["tables"], cfg["acc"], cfg["T"]) == ("global", "global", 2)
    assert cfg["warps"] >= ck.MIN_WARPS
    with pytest.raises(ValueError, match="states"):
        ck.counts_launch_plan(513, 25, 10, 4, 8, 8)
    with pytest.raises(ValueError, match="accumulators"):
        ck.counts_launch_plan(512, 25, big, 4, 8, 8, mem_bytes=2 ** 20)
    with pytest.raises(ValueError, match="global"):
        ck.counts_launch_plan(4, 25, 10, 4, 8, 8, acc="shared")


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


def _equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


def _card_close(got, want, rtol=CARD_RTOL, atol=CARD_ATOL):
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(),
                                   rtol=rtol, atol=atol)


@pytest.mark.cuda
@pytest.mark.parametrize("name", NAMES)
def test_kernel_matches_plain_on_card(name):
    """The kernel on the card's own lattices against its plain version and
    its twin on the card; the same bits in a second launch and with the
    sums in global memory (the same float32 sums in the same order); one
    block (other float64 partials) within the tolerance."""
    dev = _card()
    _, mats, toks, g = _case(name, torch.float32)
    mats, toks, g = _on(mats, dev), _on(toks, dev), g.to(dev)
    F, Br = _lattices(mats, toks)
    before = ck.expected_counts.launches
    got = ck.expected_counts(F, Br, *mats, *toks, g)
    torch.cuda.synchronize()
    assert ck.expected_counts.launches == before + 1
    _card_close(got, ck.expected_counts_plain(F, Br, *mats, *toks, g))
    tables = ck.counts_tables(*rk.nonempty(*mats[:3]), mats[3])
    plan = ck.expected_counts.last["plan"]
    twin = ck._unpad(ck.dense_grads(tables, ck.expected_counts_twin(
        tables, F, Br, *toks, g, plan=plan), torch.float32),
        mats[1].shape[0], mats[2].shape[0])
    _card_close(got, twin)
    assert ck.counts_smem_bytes_on_card(
        tables.S, plan["T"], plan["warps"], tables.n_mat, tables.n_fin,
        plan["tables"] == "shared", plan["acc"] == "shared") == \
        plan["smem_bytes"]
    assert _equal(got, ck.expected_counts(F, Br, *mats, *toks, g))
    again = ck.expected_counts(F, Br, *mats, *toks, g, acc="global")
    assert ck.expected_counts.last["plan"]["acc"] == "global"
    assert _equal(got, again)
    _card_close(got, ck.expected_counts(F, Br, *mats, *toks, g, blocks=1),
                rtol=1e-6, atol=1e-7)


def _prot2dna_batch(B, dev, seed=5):
    """B prot2dna pairs of 2-4 aa (ragged) on the card: the model's
    matrices, tokens, Forward and Backward lattices and weights."""
    model, _, _, _ = _case("prot2dna", torch.float32)
    pairs = testmachines.prot2dna_pairs(B, [2 + k % 3 for k in range(B)],
                                        seed=seed, synonymous=True)
    toks = _on(tokenize_batch(model.ev, [_sp(i, o) for i, o in pairs],
                              device="cpu"), dev)
    mats = tuple(x.detach().to(dev) for x in model.build_tensors(
        model.logw))
    g = torch.ones(B, device=dev)
    return mats, toks, _lattices(mats, toks), g


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 16, 128])
def test_layouts_on_card(B):
    """prot2dna at B = 1, 16 and 128, each on the plan's own rows a unit
    and blocks (a pair's units over many blocks at B = 1): the kernel
    against its plain version, the same bits in a second launch and with
    the sums forced global; one block within the tolerance (its float64
    partials differ); the profile library's units and cells."""
    dev = _card()
    mats, toks, (F, Br), g = _prot2dna_batch(B, dev)
    got = ck.expected_counts(F, Br, *mats, *toks, g)
    plan = ck.expected_counts.last["plan"]
    assert plan["blocks"] == min(ck.SMS, -(-plan["units"] // plan["warps"]))
    _card_close(got, ck.expected_counts_plain(F, Br, *mats, *toks, g))
    assert _equal(got, ck.expected_counts(F, Br, *mats, *toks, g))
    assert _equal(got, ck.expected_counts(F, Br, *mats, *toks, g,
                                          acc="global"))
    _card_close(got, ck.expected_counts(F, Br, *mats, *toks, g, blocks=1),
                rtol=1e-6, atol=1e-7)
    before = ck.expected_counts.launches
    cfg, prof = ck.expected_counts_profile(F, Br, *mats, *toks, g)
    assert ck.expected_counts.launches == before
    il, ol = toks[2].long(), toks[3].long()
    assert int(prof[:, 1].sum()) == int(((il + 1) * (ol + 1)).sum())
    assert (prof[:, 2:] >= 0).all()


@pytest.mark.cuda
def test_512_states_on_card():
    """The 512-state machine (511 states and End), two pairs of 6 x 6:
    the tables past TAB_SHARE of a block's shared memory and the sums,
    both in global memory by the plan; against the plain version, the
    same bits twice."""
    dev = _card()
    m = testmachines.build_random_transducer(511, list("ACGT"))
    ev = EvaluatedMachine(m, m.get_param_defs(True))
    model = CountModel(ev, device=dev)
    mats = tuple(x.detach() for x in model.build_tensors(model.logw))
    assert mats[3].shape == (512, 512)
    rng = np.random.RandomState(6)
    toks = tokenize_batch(ev, [_sp("".join("ACGT"[c] for c in rng.randint(
        0, 4, 6)), "".join("ACGT"[c] for c in rng.randint(0, 4, 6)))
        for _ in range(2)], device=dev)
    g = torch.ones(2, device=dev)
    F, Br = _lattices(mats, toks)
    got = ck.expected_counts(F, Br, *mats, *toks, g)
    plan = ck.expected_counts.last["plan"]
    assert (plan["tables"], plan["acc"]) == ("global", "global")
    _card_close(got, ck.expected_counts_plain(F, Br, *mats, *toks, g))
    assert _equal(got, ck.expected_counts(F, Br, *mats, *toks, g))


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
