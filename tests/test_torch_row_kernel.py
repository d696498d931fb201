"""The row engine's kernel (csrc/row_scan.cu, ops/kernels/row_kernel.py).

On the CPU: the prepared operands and finite-entry lists (row_tables)
against sr.prepare, exactly; the kernel's walk in plain PyTorch
(row_scan_diagonal) against dp2d's plain versions and the JAX row scans
(max-plus bit-equal on every live cell, logsumexp within 1e-5 nats), and
at the edges (an empty sequence, a band edge across a diagonal, a ragged
batch, a token outside the alphabet); the launch plan (the cluster against
the batch and the SM count, the ring in shared or global memory, shared
bytes within a block's 227 KiB, refusals only past the card's memory);
the tables' cache; dp2d's calls on a CPU tensor run the plain versions
(forward_2d_plain, forward_2d_lattice_plain, forward_2d_banded_plain) bit
for bit, one small case a mode against the JAX dp2d function at
tests/test_torch_dp2d.py's bounds, whose fixtures it reuses; an input that
requires grad gets its gradient (the score through counts_kernel.RowLoglike,
the rest through the plain versions), held to autograd through the plain
versions and to jax.grad of the JAX dp2d functions; on a card only the
score has a gradient, and the other calls raise.

On a CUDA card (marker cuda) the kernel against its plain version on the
card, per semiring and call (score, lattice, Backward, banded): logsumexp
within 1e-3 nats on every finite cell, max-plus bit-equal (float32 adds
and maxes of the same terms), impossible cells impossible in both, and
every cluster size and ring layout bit-equal to each other; a long pair
in a narrow band on clusters of 2-16 blocks; the kernel against its CPU
twin on the card; a ragged batch; S = 512; and pairs
whose ring does not fit a block's shared memory, against the float64 host
oracle at 0.01 nats:
    python -m pytest --noconftest tests/test_torch_row_kernel.py -m cuda
"""

import numpy as np
import pytest
import torch

from machineboss_tpu_torch import testmachines
from machineboss_tpu_torch.core.eval import EvaluatedMachine
from machineboss_tpu_torch.ops import dp2d
from machineboss_tpu_torch.ops.host_oracle import forward_2d_f64
from machineboss_tpu_torch.ops.kernels import row_kernel as rk
from machineboss_tpu_torch.ops.lowering import LoweredMachine
from machineboss_tpu_torch.ops.semiring import LOGSUMEXP

from test_torch_dp2d import BOUND, MACHINES, NEW_BOUND, SEMIRINGS, \
    _banded_case, _case, _close

KERNEL_VS_PLAIN = {"logsumexp": 1e-3, "maxplus": 0.0}
F64_BOUND = 0.01
MODES = ["score", "lattice", "backward", "banded"]


TWIN_VS_PLAIN = {"logsumexp": 1e-5, "maxplus": 0.0}


# ---- the launch plan, on the CPU

@pytest.mark.parametrize("S", [4, 132, 512])
def test_plan_takes_every_size_up_to_1e5(S):
    """One pair of L x L up to 10^5: shared bytes within a block's, the
    ring in shared memory while a block's cells of three diagonals fit
    beside the warps' workspaces, else in global memory, for one pair
    and a batch that fills the card."""
    for L in (0, 64, 1000, 10 ** 5):
        for B in (1, 256):
            cfg = rk.row_launch_plan(S, L, L, B)
            assert cfg["smem_bytes"] <= rk.SMEM_MAX
            ncb = cfg["cells_per_block"]
            assert ncb == -(-(L + 1) // cfg["cluster"])
            assert cfg["smem_bytes"] == rk.row_smem_bytes(
                S, ncb, cfg["rows"] == "shared")
            fits = rk.row_smem_bytes(S, ncb, True) <= rk.SMEM_MAX
            assert cfg["rows"] == ("shared" if fits else "global")
            ring = B * 3 * (L + 1) * (S + 1) * 4
            assert cfg["mem_bytes"] == 4 * B + (0 if fits else ring)
            assert cfg["threads"] == 512 and cfg["tables"] == "global"
    assert rk.row_launch_plan(S, 10 ** 5, 10 ** 5, 1)["rows"] == "global"
    assert rk.row_launch_plan(S, 8, 8, 1, rows="global")["rows"] == "global"
    assert rk.row_launch_plan(S, 8, 8, 1, lattice=True,
                              rows="global")["rows"] == "global"


def test_plan_lanes_lattice_and_refusals():
    """The cluster, the lattice's bytes and what the plan refuses (the
    lanes of the earlier layout are gone: a warp takes a cell)."""
    # prot2dna at chip_smoke's width, one pair: 16 blocks of 5 positions
    cfg = rk.row_launch_plan(132, 64, 192, 1)
    assert (cfg["cluster"], cfg["cells_per_block"], cfg["rows"]) == \
        (16, 5, "shared")
    assert cfg["smem_bytes"] == 64 + (16 * (4 * 132 + 3) + 19 * 133) * 4
    # 64 pairs: two blocks a pair; the 3,000 x 3,000 pair of 65 states on
    # 16 blocks keeps its ring in shared memory, on 8 it would not
    assert rk.row_launch_plan(132, 64, 192, 64)["cluster"] == 2
    assert rk.row_launch_plan(65, 3000, 3000, 1)["rows"] == "shared"
    assert rk.row_launch_plan(65, 3000, 3000, 1, cluster=8)["rows"] == \
        "global"
    # a block a pair once the batch fills the card
    assert rk.row_launch_plan(132, 64, 192, 132)["cluster"] == 1
    assert rk.row_launch_plan(132, 64, 192, 132, sms=264)["cluster"] == 2
    lat = rk.row_launch_plan(132, 64, 192, 2, lattice=True)
    assert lat["rows"] == "shared"
    assert lat["mem_bytes"] == 2 * 193 * 65 * 132 * 4
    card = 80 * 10 ** 9
    for S in (65, 132, 512):
        assert rk.row_launch_plan(S, 1 << 22, 1 << 22, 1, mem_bytes=card)
    with pytest.raises(ValueError, match="device bytes"):
        rk.row_launch_plan(64, 10 ** 5, 10 ** 5, 1, lattice=True,
                           mem_bytes=card)
    with pytest.raises(ValueError, match="states"):
        rk.row_launch_plan(513, 8, 8, 1)
    with pytest.raises(ValueError, match="global"):
        rk.row_launch_plan(4, 8, 8, 1, rows="shared")
    with pytest.raises(ValueError, match="cluster"):
        rk.row_launch_plan(4, 8, 8, 1, cluster=17)


@pytest.mark.parametrize("B,sms,Li,want", [
    (1, 132, 64, 16), (8, 132, 64, 16), (9, 132, 64, 8), (16, 132, 64, 8),
    (17, 132, 64, 4), (33, 132, 64, 4), (34, 132, 64, 2), (64, 132, 64, 2),
    (67, 132, 64, 1), (132, 132, 64, 1), (512, 132, 64, 1), (1, 132, 8, 2),
    (1, 132, 2, 1), (1, 16, 3000, 16), (4, 16, 3000, 4), (16, 16, 3000, 1),
    (1, 132, 0, 1)])
def test_plan_cluster_follows_the_batch_and_the_card(B, sms, Li, want):
    """1 where the batch fills the SMs, else the largest power of two up to
    16 that keeps B * cluster within them and MIN_CELLS positions a
    block."""
    cfg = rk.row_launch_plan(65, Li, 100, B, sms=sms)
    assert cfg["cluster"] == want
    assert B * want <= max(sms, B)
    assert want == 1 or (Li + 1) >= rk.MIN_CELLS * want
    assert rk.row_launch_plan(65, Li, 100, B, sms=sms, cluster=16)[
        "cluster"] == 16


def test_plan_stages_the_lists_where_they_fit():
    """The lists in shared memory beside the ring and the workspaces, else
    read from global memory; their bytes count against the card's."""
    cfg = rk.row_launch_plan(132, 64, 192, 1, n_tab=2000)
    assert cfg["tables"] == "shared"
    assert cfg["smem_bytes"] == rk.row_smem_bytes(132, 5, True, 2000)
    big = rk.row_launch_plan(132, 64, 192, 1, n_tab=30000)
    assert big["tables"] == "global" and big["rows"] == "shared"
    assert big["mem_bytes"] == 4 + 30000 * 8
    # the ring goes global before the lists are considered
    glob = rk.row_launch_plan(65, 5000, 5000, 1, cluster=1, n_tab=100)
    assert glob["rows"] == "global" and glob["tables"] == "shared"


# ---- the prepared operands and the CPU twin

def _mats(kind, sr_name):
    """Lowered float32 matrices: prot2dna (S=132), the 64-state ACGT
    machine narrowed to 16 states, the 5-state allclass machine."""
    from machineboss_tpu_torch.core.presets import make_preset
    m = {"prot2dna": lambda: make_preset("prot2dna"),
         "dense16": lambda: testmachines.build_random_transducer(
             16, list("ACGT")),
         "allclass5": lambda: testmachines.build_allclass_transducer(
             5, list("AC"))}[kind]()
    ev = EvaluatedMachine(m, m.get_param_defs(True))
    return tuple(torch.from_numpy(np.asarray(x)) for x in LoweredMachine(
        ev, dtype=np.float32).matrices_2d(sr_name))


@pytest.mark.parametrize("kind", ["prot2dna", "dense16", "allclass5"])
def test_tables_are_the_prepared_operands(kind):
    """Every column's list holds exactly its finite entries' sources in
    ascending order, their values bit-equal to sr.prepare's exponentials
    (max-plus: the entries), the shifts sr.prepare's column maxima."""
    for sr_name, sr in SEMIRINGS.items():
        mats = _mats(kind, sr_name)
        tables = rk.row_tables(*mats, sr)
        src, val, shift, count = rk.row_columns(tables)
        S = mats[3].shape[0]
        M = torch.cat([mats[0].reshape(-1, S, S), mats[1], mats[2],
                       mats[3][None]])
        assert tables.n_mat == M.shape[0]
        prep, cm = (M, torch.zeros(M.shape[0], 1, S)) \
            if sr_name == "maxplus" else sr.prepare(M)
        fin = M > -5e29
        n = fin.sum(1)                                     # (n_mat, S)
        has = n > 0
        assert torch.equal(count[:, :S][has], n[has])
        R = src.shape[-1]
        rank = torch.arange(R)
        live = rank < n[..., None]                         # (n_mat, S, R)
        mm, jj, tt = torch.nonzero(live, as_tuple=True)
        kk = src[:, :S][mm, jj, tt]
        assert fin[mm, kk, jj].all()
        assert int(live.sum()) == int(fin.sum())
        # ascending sources in each column
        assert (src[:, :S][..., 1:] > src[:, :S][..., :-1])[
            live[..., 1:]].all()
        assert torch.equal(val[:, :S][mm, jj, tt].view(torch.int32),
                           prep[mm, kk, jj].contiguous().view(torch.int32))
        assert torch.equal(shift[:, :S][has].view(torch.int32),
                           cm[:, 0, :][has].contiguous().view(torch.int32))
        pad = 0.0 if sr_name == "logsumexp" else float("-inf")
        assert (val[:, :S][~live] == pad).all()


def _twin(mode, tables, it, ot, band=None, lens=None):
    S = tables.S
    if mode == "score":
        return rk.row_scan_diagonal(tables, it, ot, lens=lens or (
            it.shape[-1], ot.shape[-1]))
    if mode == "lattice":
        return rk.row_scan_diagonal(tables, it, ot)
    if mode == "backward":
        eN = torch.full((S,), -1e30, device=tables.tab.device)
        eN[-1] = 0.0
        return rk.row_scan_diagonal(tables, it.flip(-1), ot.flip(-1),
                                    start_vec=eN).flip(-3, -2)
    return rk.row_scan_diagonal(tables, it, ot, lens=(it.shape[-1],
                                                      ot.shape[-1]),
                                band=band)


def _live_close(got, want, tol):
    """Impossible cells impossible in both; live cells within tol (0.0:
    bit for bit)."""
    got, want = torch.as_tensor(got), torch.as_tensor(want)
    assert got.shape == want.shape
    live = want > -1e29
    assert torch.equal(got > -1e29, live)
    if live.any():
        if tol == 0.0:
            assert torch.equal(got[live], want[live])
        else:
            assert float((got[live].double() - want[live].double()).abs()
                         .max()) <= tol


@pytest.mark.parametrize("sr_name", list(SEMIRINGS))
@pytest.mark.parametrize("mode", MODES)
def test_twin_matches_plain_and_jax(mode, sr_name):
    """The diagonal walk on the tables against dp2d's plain version and
    the JAX row scan on the same numpy-seeded pair: max-plus bit-equal on
    every live cell, logsumexp within 1e-5 nats."""
    import jax.numpy as jnp
    from machineboss_tpu.ops import dp2d as jd
    from test_torch_dp2d import _jax_sr
    sr, tol = SEMIRINGS[sr_name], TWIN_VS_PLAIN[sr_name]
    band = None
    if mode == "banded":
        _, _, _, env, it, ot = _banded_case("allclass", 1)
        mats = _case("allclass", sr_name)[1]
        band = (torch.tensor(env.in_start), torch.tensor(env.in_end))
    else:
        _, mats, it, ot = _pair("allclass", sr_name, seed=7, li=6, lo=7)
    tm = [torch.from_numpy(x) for x in mats]
    ti, to = torch.from_numpy(it), torch.from_numpy(ot)
    rev = [m.transpose(-1, -2) for m in tm] if mode == "backward" else tm
    got = _twin(mode, rk.row_tables(*rev, sr), ti, to, band)
    plain = _run(mode, tm, ti, to, sr, band, plain=True)
    _live_close(got, plain, tol)
    jm = [jnp.array(x) for x in mats]
    ji, jo = jnp.array(it), jnp.array(ot)
    if mode == "score":
        ref = jd.forward_2d(*jm, ji, jo, len(it), len(ot), sr=_jax_sr(
            sr_name))
    elif mode == "lattice":
        ref = jd.forward_2d_lattice(*jm, ji, jo, sr=_jax_sr(sr_name))
    elif mode == "backward":
        ref = jd.backward_2d_lattice(*jm, ji, jo, sr=_jax_sr(sr_name))
    else:
        ref = jd.forward_2d_banded(*jm, ji, jo, jnp.array(env.in_start),
                                   jnp.array(env.in_end), len(it), len(ot),
                                   sr=_jax_sr(sr_name))
    _live_close(got, torch.from_numpy(np.array(ref)), tol)


@pytest.mark.parametrize("sr_name", list(SEMIRINGS))
def test_twin_on_prot2dna_and_the_narrowed_dense_machine(sr_name):
    """A short prot2dna pair (S=132: ~230 finite terms a cell of 69,696)
    and the 16-state ACGT machine, score and lattice, against the plain
    version."""
    sr, tol = SEMIRINGS[sr_name], TWIN_VS_PLAIN[sr_name]
    rng = np.random.RandomState(3)
    for kind, li, lo in (("prot2dna", 4, 12), ("dense16", 7, 7)):
        mats = _mats(kind, sr_name)
        tables = rk.row_tables(*mats, sr)
        it = torch.from_numpy(rng.randint(0, mats[1].shape[0], li))
        ot = torch.from_numpy(rng.randint(0, mats[2].shape[0], lo))
        for mode in ("score", "lattice"):
            _live_close(_twin(mode, tables, it, ot),
                        _run(mode, list(mats), it, ot, sr, plain=True), tol)


def test_twin_edges():
    """Li = 0 and Lo = 0; a band whose edge cuts diagonals; a ragged
    batch read at each pair's lengths; a token outside the alphabet,
    clamped as the JAX package's gathers clamp it."""
    for sr_name, sr in SEMIRINGS.items():
        tol = TWIN_VS_PLAIN[sr_name]
        _, mats, it, ot = _pair("allclass", sr_name, seed=5, li=5, lo=6)
        tm = [torch.from_numpy(x) for x in mats]
        tables = rk.row_tables(*tm, sr)
        ti, to = torch.from_numpy(it), torch.from_numpy(ot)
        for a, b in ((ti[:0], to), (ti, to[:0]), (ti[:0], to[:0])):
            for mode in ("score", "lattice"):
                _live_close(_twin(mode, tables, a, b),
                            _run(mode, tm, a, b, sr, plain=True), tol)
        # a band of width one around the diagonal i = o, rows cut short
        lo = len(ot)
        bs = torch.tensor([max(0, o - 1) for o in range(lo + 1)])
        be = torch.tensor([min(len(it) + 1, o + 2) for o in range(lo + 1)])
        _live_close(_twin("banded", tables, ti, to, band=(bs, be)),
                    _run("banded", tm, ti, to, sr, (bs, be), plain=True),
                    tol)
        # a ragged batch, read at each pair's lengths
        rng = np.random.RandomState(4)
        B, Li, Lo = 4, 6, 5
        bi = torch.from_numpy(rng.randint(0, mats[1].shape[0], (B, Li)))
        bo = torch.from_numpy(rng.randint(0, mats[2].shape[0], (B, Lo)))
        il, ol = torch.tensor([6, 0, 3, 2]), torch.tensor([5, 2, 0, 4])
        _live_close(_twin("score", tables, bi, bo, lens=(il, ol)),
                    dp2d.forward_2d_plain(*tm, bi, bo, il, ol, sr=sr), tol)
        # a token past the alphabet: its last symbol; below it: its first
        wild_i, wild_o = ti.clone(), to.clone()
        wild_i[1], wild_o[2] = 99, -3
        clamp_i, clamp_o = ti.clone(), to.clone()
        clamp_i[1], clamp_o[2] = mats[1].shape[0] - 1, 0
        _live_close(_twin("lattice", tables, wild_i, wild_o),
                    _twin("lattice", tables, clamp_i, clamp_o), 0.0)


def test_tables_are_kept_per_operand_tensors():
    """row_tables_cached builds once per set of tensors; a transposed view
    is its own entry; a tensor written in place, or a new tensor, is built
    anew."""
    _, mats, _, _ = _pair("allclass", "logsumexp")
    tm = [torch.from_numpy(x.copy()) for x in mats]
    first, built = rk.row_tables_cached(*tm, LOGSUMEXP)
    assert built
    again, built = rk.row_tables_cached(*tm, LOGSUMEXP)
    assert not built and again is first
    rev = [m.transpose(-1, -2) for m in tm]
    back, built = rk.row_tables_cached(*rev, LOGSUMEXP)
    assert built and back is not first
    assert rk.row_tables_cached(*[m.transpose(-1, -2) for m in tm],
                                LOGSUMEXP) == (back, False)
    tm[3][0, 0] = tm[3][0, 0] - 0.5
    changed, built = rk.row_tables_cached(*tm, LOGSUMEXP)
    assert built and not torch.equal(changed.tab, first.tab)
    fresh = [m.clone() for m in tm]
    assert rk.row_tables_cached(*fresh, LOGSUMEXP)[1]


# ---- the CPU route: the plain versions, bit for bit

def _pair(name, sr_name, seed=11, li=5, lo=7):
    """A pair of (li, lo) fresh tokens for machine `name`, beside the
    fixtures' own (tests/test_torch_dp2d.py's LENS)."""
    ev, mats, _ = _case(name, sr_name)
    rng = np.random.RandomState(seed)
    it = rng.randint(0, mats[1].shape[0], li).astype(np.int32)
    ot = rng.randint(0, mats[2].shape[0], lo).astype(np.int32)
    return ev, mats, it, ot


def _run(mode, mats, it, ot, sr, band=None, plain=False):
    """The port's call of `mode` (plain: the eager version)."""
    if mode == "score":
        fn = dp2d.forward_2d_plain if plain else dp2d.forward_2d
        return fn(*mats, it, ot, it.shape[-1], ot.shape[-1], sr=sr)
    if mode == "lattice":
        fn = dp2d.forward_2d_lattice_plain if plain \
            else dp2d.forward_2d_lattice
        return fn(*mats, it, ot, sr=sr)
    if mode == "backward":
        if plain:
            S = mats[3].shape[-1]
            rev = [m.transpose(-1, -2) for m in mats]
            eN = dp2d._e0(S, mats[3].dtype, sr, mats[3].device, state=S - 1)
            return dp2d.forward_2d_lattice_plain(
                *rev, it.flip(-1), ot.flip(-1), sr=sr,
                start_vec=eN).flip(-3, -2)
        return dp2d.backward_2d_lattice(*mats, it, ot, sr=sr)
    fn = dp2d.forward_2d_banded_plain if plain else dp2d.forward_2d_banded
    return fn(*mats, it, ot, *band, it.shape[-1], ot.shape[-1], sr=sr)


@pytest.mark.parametrize("mode", MODES)
def test_cpu_runs_the_plain_version_and_matches_jax(mode):
    """A CPU tensor takes the eager loop, bit for bit, and no launch is
    counted; one small case a mode against the JAX package's function."""
    import jax.numpy as jnp
    from machineboss_tpu.ops import dp2d as jd
    from machineboss_tpu.ops import semiring as jsr
    sr_name = "logsumexp" if mode in ("backward", "banded") else "maxplus"
    sr, jsr_ = SEMIRINGS[sr_name], getattr(jsr, sr_name.upper())
    band = None
    if mode == "banded":
        _, mats, _, env, it, ot = _banded_case("indel", 2)
        band = (torch.tensor(env.in_start), torch.tensor(env.in_end))
    else:
        _, mats, it, ot = _pair("indel" if mode == "score" else "allclass",
                                sr_name)
    tm = [torch.from_numpy(x) for x in mats]
    ti, to = torch.from_numpy(it), torch.from_numpy(ot)
    before = rk.row_scan.launches
    got = _run(mode, tm, ti, to, sr, band)
    assert rk.row_scan.launches == before
    assert torch.equal(got, _run(mode, tm, ti, to, sr, band, plain=True))
    jm = [jnp.array(x) for x in mats]
    ji, jo = jnp.array(it), jnp.array(ot)
    if mode == "score":
        ref = [float(jd.forward_2d(*jm, ji, jo, len(it), len(ot),
                                   sr=jsr_))]
        got = [float(got)]
    elif mode == "lattice":
        ref = np.asarray(jd.forward_2d_lattice(*jm, ji, jo, sr=jsr_))
    elif mode == "backward":
        ref = np.asarray(jd.backward_2d_lattice(*jm, ji, jo, sr=jsr_))
    else:
        ref = [float(jd.forward_2d_banded(
            *jm, ji, jo, jnp.array(env.in_start), jnp.array(env.in_end),
            len(it), len(ot)))]
        got = [float(got)]
    bound = NEW_BOUND if mode in ("backward", "banded") else BOUND[sr_name]
    _close(np.asarray(got), ref, bound)


GRAD_VS_PLAIN = 1e-5      # float32: the same gradient by another route
GRAD_VS_JAX_RTOL, GRAD_VS_JAX_ATOL = 1e-3, 1e-4   # the JAX count tolerance


def _scalar(mode, out):
    """A scalar of a call's output: the score itself, a lattice's last and
    middle cells' logsumexp over the states."""
    if out.dim() == 0:
        return out
    mid = out[out.shape[0] // 2, out.shape[1] // 2]
    return out[-1, -1].logsumexp(-1) + mid.logsumexp(-1)


def test_an_input_that_requires_grad_gets_its_gradient():
    """Where the matrices require grad, every call returns a result that
    carries a gradient (the logsumexp score through counts_kernel's
    RowLoglike, whose backward is the E-step's expected counts; the
    lattices, the Backward lattice and the banded fill through their
    plain versions under autograd), within 1e-5 of autograd through the
    plain version in all four matrices; the score takes RowLoglike with
    any one matrix requiring grad; no launch is counted on the CPU."""
    from machineboss_tpu_torch.ops.kernels import counts_kernel as ck
    _, mats, it, ot = _pair("allclass", "logsumexp")
    tm = [torch.from_numpy(x) for x in mats]
    ti, to = torch.from_numpy(it), torch.from_numpy(ot)
    band = (torch.zeros(len(ot) + 1, dtype=torch.long),
            torch.full((len(ot) + 1,), len(it) + 1))
    before = rk.row_scan.launches

    def grads(mode, plain, leaves):
        args = [x.clone().requires_grad_(True) if k in leaves else x
                for k, x in enumerate(tm)]
        ck.estep_backward.last = None
        out = _run(mode, args, ti, to, LOGSUMEXP, band, plain=plain)
        assert out.requires_grad
        got = torch.autograd.grad(_scalar(mode, out),
                                  [args[k] for k in leaves])
        if mode == "score" and not plain:
            assert ck.estep_backward.last["pairs"] == 1
        return got

    cases = [(mode, (0, 1, 2, 3)) for mode in MODES] + \
        [("score", (k,)) for k in range(4)]
    for mode, leaves in cases:
        for a, b in zip(grads(mode, False, leaves),
                        grads(mode, True, leaves)):
            np.testing.assert_allclose(a.numpy(), b.numpy(),
                                       atol=GRAD_VS_PLAIN, rtol=0)
    assert rk.row_scan.launches == before
    # the associative rows are not the kernel's: autograd runs through
    got = dp2d.forward_2d(tm[0].clone().requires_grad_(True), *tm[1:], ti,
                          to, len(it), len(ot), assoc=True)
    assert got.requires_grad


def _grad_machine(name):
    from machineboss_tpu_torch.core.params import param_assign_from_json
    from machineboss_tpu_torch.core.presets import make_preset
    if name == "jukescantor":
        m = make_preset("jukescantor")
        params = m.get_param_defs(True).combine(
            param_assign_from_json({"t": 0.3}), True)
    else:
        m = testmachines.build_indel_transducer(6, list("ACGT"))
        params = m.get_param_defs(True)
    ev = EvaluatedMachine(m, params)
    return [np.asarray(x) for x in LoweredMachine(
        ev, dtype=np.float32).matrices_2d("logsumexp")]


@pytest.mark.parametrize("mode", ["score", "lattice"])
@pytest.mark.parametrize("name", ["jukescantor", "indel"])
def test_gradient_matches_jax_grad(name, mode):
    """dp2d.forward_2d (through RowLoglike) and forward_2d_lattice (its
    plain version under autograd) with the four matrices requiring grad:
    their gradients against jax.grad of the JAX package's dp2d functions
    on the same numpy inputs (rtol 1e-3 / atol 1e-4, the JAX count
    tolerance) and within 1e-5 of autograd through forward_2d_plain in
    float64."""
    import jax
    import jax.numpy as jnp
    from machineboss_tpu.ops import dp2d as jd
    mats = _grad_machine(name)
    rng = np.random.RandomState(7)
    it = rng.randint(0, mats[1].shape[0], 4).astype(np.int32)
    ot = rng.randint(0, mats[2].shape[0], 5).astype(np.int32)
    ti, to = torch.from_numpy(it), torch.from_numpy(ot)

    def port(dtype, plain):
        leaves = [torch.from_numpy(x).to(dtype).requires_grad_(True)
                  for x in mats]
        if mode == "score":
            fn = dp2d.forward_2d_plain if plain else dp2d.forward_2d
            out = fn(*leaves, ti, to, len(it), len(ot))
        else:
            fn = dp2d.forward_2d_lattice_plain if plain \
                else dp2d.forward_2d_lattice
            out = fn(*leaves, ti, to)
        return [g.double().numpy() for g in
                torch.autograd.grad(_scalar(mode, out), leaves)]

    def jax_scalar(*jm):
        if mode == "score":
            return jd.forward_2d(*jm, jnp.array(it), jnp.array(ot), len(it),
                                 len(ot))
        lat = jd.forward_2d_lattice(*jm, jnp.array(it), jnp.array(ot))
        mid = lat[lat.shape[0] // 2, lat.shape[1] // 2]
        return jax.nn.logsumexp(lat[-1, -1]) + jax.nn.logsumexp(mid)

    want = jax.grad(jax_scalar, argnums=(0, 1, 2, 3))(
        *[jnp.array(x) for x in mats])
    got = port(torch.float32, False)
    f64 = port(torch.float64, True)
    for g, w, r in zip(got, want, f64):
        np.testing.assert_allclose(g, np.asarray(w, np.float64),
                                   rtol=GRAD_VS_JAX_RTOL,
                                   atol=GRAD_VS_JAX_ATOL)
        np.testing.assert_allclose(g, r, atol=GRAD_VS_PLAIN, rtol=0)


# ---- the kernel on the card

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _lattice_close(got, want, tol):
    """Every finite cell within tol, impossible cells impossible in
    both."""
    got = got.cpu().numpy().astype(np.float64)
    want = want.cpu().numpy().astype(np.float64)
    assert got.shape == want.shape
    assert np.array_equal(got > -1e29, want > -1e29)
    live = want > -1e29
    if live.any():
        assert np.abs(got[live] - want[live]).max() <= tol


def _launched(fn):
    before = rk.row_scan.launches
    out = fn()
    torch.cuda.synchronize()
    assert rk.row_scan.launches == before + 1
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("sr_name", list(SEMIRINGS))
@pytest.mark.parametrize("name", list(MACHINES))
def test_kernel_matches_plain_on_card(name, sr_name, mode):
    dev = _card()
    sr = SEMIRINGS[sr_name]
    if mode == "banded":
        _, mats, _, env, it, ot = _banded_case(name if name != "tiefree"
                                               else "indel", 1)
        band = (torch.tensor(env.in_start, device=dev),
                torch.tensor(env.in_end, device=dev))
        if sr_name == "maxplus":
            mats = _case(name if name != "tiefree" else "indel",
                         "maxplus")[1]
    else:
        _, mats, it, ot = _pair(name, sr_name, li=9, lo=8)
        band = None
    tm = [torch.from_numpy(x).to(dev) for x in mats]
    ti, to = torch.from_numpy(it).to(dev), torch.from_numpy(ot).to(dev)
    got = _launched(lambda: _run(mode, tm, ti, to, sr, band))
    want = _run(mode, tm, ti, to, sr, band, plain=True)
    _lattice_close(got, want, KERNEL_VS_PLAIN[sr_name])
    if mode == "score":
        # every layout takes the same arithmetic: bit for bit
        for rows in (None, "global"):
            for cluster in (None, 1, 2):
                again = _launched(lambda: rk.row_scan(
                    *tm, ti, to, sr, lens=(len(it), len(ot)), rows=rows,
                    cluster=cluster))
                assert torch.equal(again, got)
    if mode in ("lattice", "backward"):
        rev = [m.transpose(-1, -2) for m in tm] if mode == "backward" \
            else tm
        twin = _twin(mode, rk.row_tables(*rev, sr), ti, to)
        _lattice_close(got, twin, KERNEL_VS_PLAIN[sr_name])


@pytest.mark.cuda
@pytest.mark.parametrize("sr_name", list(SEMIRINGS))
def test_ragged_batch_on_card(sr_name):
    """(B, Li) tokens and (B,) lengths: each pair read at its own lengths,
    as the plain version reads it, and as its own single-pair call scores
    it; the batched lattice too."""
    dev = _card()
    sr = SEMIRINGS[sr_name]
    _, mats, _ = _case("indel", sr_name)
    rng = np.random.RandomState(4)
    B, Li, Lo = 5, 9, 11
    it = rng.randint(0, mats[1].shape[0], (B, Li)).astype(np.int32)
    ot = rng.randint(0, mats[2].shape[0], (B, Lo)).astype(np.int32)
    il = np.array([9, 0, 4, 7, 1], np.int32)
    ol = np.array([11, 3, 0, 5, 11], np.int32)
    tm = [torch.from_numpy(x).to(dev) for x in mats]
    ti, to = torch.from_numpy(it).to(dev), torch.from_numpy(ot).to(dev)
    tl = [torch.from_numpy(x).to(dev) for x in (il, ol)]
    got = _launched(lambda: dp2d.forward_2d(*tm, ti, to, *tl, sr=sr))
    want = dp2d.forward_2d_plain(*tm, ti, to, *tl, sr=sr)
    _lattice_close(got, want, KERNEL_VS_PLAIN[sr_name])
    for b in range(B):
        one = dp2d.forward_2d(*tm, ti[b, :il[b]], to[b, :ol[b]], int(il[b]),
                              int(ol[b]), sr=sr)
        assert torch.equal(one, got[b])
    lat = _launched(lambda: dp2d.forward_2d_lattice(*tm, ti, to, sr=sr))
    _lattice_close(lat, dp2d.forward_2d_lattice_plain(*tm, ti, to, sr=sr),
                   KERNEL_VS_PLAIN[sr_name])


@pytest.mark.cuda
@pytest.mark.parametrize("sr_name", list(SEMIRINGS))
@pytest.mark.parametrize("name", ["indel", "allclass"])
def test_banded_clusters_on_card(name, sr_name):
    """forward_2d_banded on a pair of some 80 positions in a narrow
    Envelope (width 2), on clusters of 2, 4 and 16 blocks: for many
    diagonals the blocks right of the band have no live cell at their first
    position and never read their left neighbour's cell, and must still
    keep step with it. Each bit-equal to one block, which holds to the
    plain version."""
    dev = _card()
    sr = SEMIRINGS[sr_name]
    _, mats, _, env, it, ot = _banded_case(name, 2, n_cols=120)
    if sr_name == "maxplus":
        mats = _case(name, "maxplus")[1]
    assert min(len(it), len(ot)) >= 64
    tm = [torch.from_numpy(x).to(dev) for x in mats]
    ti, to = torch.from_numpy(it).to(dev), torch.from_numpy(ot).to(dev)
    band = (torch.tensor(env.in_start, device=dev),
            torch.tensor(env.in_end, device=dev))
    lens = (len(it), len(ot))

    def kernel(cluster):
        return _launched(lambda: rk.row_scan(*tm, ti, to, sr, lens=lens,
                                             band=band, cluster=cluster))

    one = kernel(1)
    want = dp2d.forward_2d_banded_plain(*tm, ti, to, *band, *lens, sr=sr)
    _lattice_close(one, want, KERNEL_VS_PLAIN[sr_name])
    assert float(one) > -1e29
    for cluster in (2, 4, 16):
        got = kernel(cluster)
        plan = rk.row_scan.last["plan"]
        assert (plan["cluster"], plan["rows"]) == (cluster, "shared")
        assert torch.equal(got, one)


def _dense_mats(n_states, sr_name="logsumexp"):
    m = testmachines.build_random_transducer(n_states, list("ACGT"))
    ev = EvaluatedMachine(m, m.get_param_defs(True))
    return tuple(np.asarray(x) for x in LoweredMachine(
        ev, dtype=np.float32).matrices_2d(sr_name))


@pytest.mark.cuda
def test_score_gradient_on_card():
    """dp2d.forward_2d on the card with the matrices requiring grad: the
    score through RowLoglike (the row kernel, then its lattices and
    expected_counts in the backward), one pair and a batch, against
    autograd through the plain version on the card (1e-4 + 1e-3
    relative: float32 counts by other sums); the lattice, Backward and
    banded calls with a matrix requiring grad raise on the card (no
    kernel computes their gradient), launching nothing."""
    from machineboss_tpu_torch.ops.kernels import counts_kernel as ck
    dev = _card()
    _, mats, it, ot = _pair("indel", "logsumexp")
    ti, to = torch.from_numpy(it).to(dev), torch.from_numpy(ot).to(dev)
    for batch in (False, True):
        grads = []
        for plain in (False, True):
            leaves = [torch.from_numpy(x).to(dev).requires_grad_(True)
                      for x in mats]
            fn = dp2d.forward_2d_plain if plain else dp2d.forward_2d
            if batch:
                bi, bo = ti.repeat(3, 1), to.repeat(3, 1)
                n = torch.full((3,), len(it), device=dev)
                out = fn(*leaves, bi, bo, n, n * 0 + len(ot)).sum()
            else:
                out = fn(*leaves, ti, to, len(it), len(ot))
            rk.row_scan.launches = ck.expected_counts.launches = 0
            grads.append(torch.autograd.grad(out, leaves))
            if not plain:
                assert (rk.row_scan.launches,
                        ck.expected_counts.launches) == (2, 1)
        for a, b in zip(*grads):
            np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(),
                                       rtol=1e-3, atol=1e-4)
    band = (torch.zeros(len(ot) + 1, dtype=torch.long, device=dev),
            torch.full((len(ot) + 1,), len(it) + 1, device=dev))
    tm = [torch.from_numpy(x).to(dev) for x in mats]
    rk.row_scan.launches = 0
    for mode in ("lattice", "backward", "banded"):
        args = [tm[0].clone().requires_grad_(True)] + tm[1:]
        with pytest.raises(ValueError, match="gradient"):
            _run(mode, args, ti, to, LOGSUMEXP, band)
    assert rk.row_scan.launches == 0


@pytest.mark.cuda
def test_512_states_on_card():
    """S = 512 (dispatch's DENSE_MAX_STATES: 511 states and End): the
    closure read from global memory, one lane a destination."""
    dev = _card()
    mats = _dense_mats(511)
    assert mats[3].shape == (512, 512)
    rng = np.random.RandomState(2)
    it = rng.randint(0, 4, 12).astype(np.int32)
    ot = rng.randint(0, 4, 12).astype(np.int32)
    tm = [torch.from_numpy(x).to(dev) for x in mats]
    ti, to = torch.from_numpy(it).to(dev), torch.from_numpy(ot).to(dev)
    assert rk.row_launch_plan(512, 12, 12, 1)["cluster"] == 2
    for mode in ("score", "lattice"):
        got = _launched(lambda: _run(mode, tm, ti, to, LOGSUMEXP))
        _lattice_close(got, _run(mode, tm, ti, to, LOGSUMEXP, plain=True),
                       KERNEL_VS_PLAIN["logsumexp"])
    got = float(dp2d.forward_2d(*tm, ti, to, 12, 12))
    _close([got], [forward_2d_f64(*mats, it, ot)], F64_BOUND)


@pytest.mark.cuda
def test_rows_past_shared_memory_on_card():
    """The 64-state ACGT machine (65 states with End) at 500 x 500 on one
    block (three diagonals of 501 cells do not fit beside the warps'
    workspaces: the ring in global memory) and on the plan's cluster of
    eight (shared), and prot2dna at 160 aa x 480 nt, Forward against the
    float64 host oracle."""
    dev = _card()
    mats = _dense_mats(64)
    S = mats[3].shape[0]
    rng = np.random.RandomState(3)
    it = rng.randint(0, 4, 500).astype(np.int32)
    ot = it.copy()
    assert rk.row_launch_plan(S, 500, 500, 1)["rows"] == "shared"
    assert rk.row_launch_plan(S, 500, 500, 1, cluster=1)["rows"] == "global"
    tm = [torch.from_numpy(x).to(dev) for x in mats]
    ti, to = torch.from_numpy(it).to(dev), torch.from_numpy(ot).to(dev)
    got = _launched(lambda: dp2d.forward_2d(*tm, ti, to, 500, 500))
    one = _launched(lambda: rk.row_scan(*tm, ti, to, LOGSUMEXP,
                                        lens=(500, 500), cluster=1))
    assert torch.equal(got, one)
    _close([float(got)], [forward_2d_f64(*mats, it, ot)], F64_BOUND)
    from machineboss_tpu_torch.core.presets import make_preset
    m = make_preset("prot2dna")
    ev = EvaluatedMachine(m, m.get_param_defs(True))
    pm = tuple(np.asarray(x) for x in LoweredMachine(
        ev, dtype=np.float32).matrices_2d())
    (p, dna), = testmachines.prot2dna_pairs(1, 160, seed=3)
    pi = np.array([ev.input_tokenizer.sym2tok[c] - 1 for c in p], np.int32)
    po = np.array([ev.output_tokenizer.sym2tok[c] - 1 for c in dna],
                  np.int32)
    assert rk.row_launch_plan(132, len(pi), len(po), 1,
                              cluster=1)["rows"] == "global"
    tp = [torch.from_numpy(x).to(dev) for x in pm]
    xi, xo = torch.from_numpy(pi).to(dev), torch.from_numpy(po).to(dev)
    got = _launched(lambda: dp2d.forward_2d(*tp, xi, xo, len(pi), len(po)))
    one = _launched(lambda: rk.row_scan(*tp, xi, xo, LOGSUMEXP,
                                        lens=(len(pi), len(po)), cluster=1))
    assert torch.equal(got, one)
    _close([float(got)], [forward_2d_f64(*pm, pi, po)], F64_BOUND)


@pytest.mark.cuda
def test_card_raises_on_what_the_kernel_does_not_take():
    dev = _card()
    _, mats, it, ot = _pair("allclass", "logsumexp")
    tm = [torch.from_numpy(x).to(dev) for x in mats]
    ti, to = torch.from_numpy(it).to(dev), torch.from_numpy(ot).to(dev)
    with pytest.raises(TypeError, match="float32"):
        dp2d.forward_2d(*[m.double() for m in tm], ti, to, len(it), len(ot))
    # the score with a matrix requiring grad has its gradient (RowLoglike,
    # test_score_gradient_on_card); a lattice has none on the card
    with pytest.raises(ValueError, match="gradient"):
        dp2d.forward_2d_lattice(tm[0].clone().requires_grad_(True), *tm[1:],
                                ti, to)
    from machineboss_tpu_torch.ops.semiring import PROB
    with pytest.raises(ValueError, match="semiring"):
        dp2d.forward_2d(*tm, ti, to, len(it), len(ot), sr=PROB)
