"""The row engine's kernel (csrc/row_scan.cu, ops/kernels/row_kernel.py).

On the CPU: the launch plan at S in {4, 132, 512} and lengths up to 10^5
(shared bytes within a block's 227 KiB, the rows past that in global
memory, a lattice past the card's memory refused); dp2d's calls on a CPU
tensor run the plain versions (forward_2d_plain, forward_2d_lattice_plain,
forward_2d_banded_plain) bit for bit, one small case a mode against the
JAX dp2d function at tests/test_torch_dp2d.py's bounds (2e-3 nats
logsumexp and 1e-5 max-plus for the scans, 1e-4 for the Backward lattice
and the banded fill), whose fixtures it reuses; an input that requires
grad raises.

On a CUDA card (marker cuda) the kernel against its plain version on the
card, per semiring and call (score, lattice, Backward, banded): logsumexp
within 1e-3 nats on every finite cell (the kernel's exact per-destination
sums against the plain version's shifted products), max-plus bit-equal
(float32 adds and maxes of the same terms), impossible cells impossible in
both; a ragged batch; S = 512; and pairs whose rows do not fit a block's
shared memory, against the float64 host oracle at 0.01 nats:
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


# ---- the launch plan, on the CPU

@pytest.mark.parametrize("S", [4, 132, 512])
def test_plan_takes_every_size_up_to_1e5(S):
    for L in (0, 64, 1000, 10 ** 5):
        cfg = rk.row_launch_plan(S, L, L, 1)
        assert cfg["smem_bytes"] <= rk.SMEM_MAX
        assert cfg["smem_bytes"] == rk.row_smem_bytes(
            S, L, cfg["closure"] == "shared", cfg["rows"] == "shared")
        fits = rk.row_smem_bytes(S, L, cfg["closure"] == "shared",
                                 True) <= rk.SMEM_MAX
        assert cfg["rows"] == ("shared" if fits else "global")
        row = (L + 1) * S * 4
        assert cfg["mem_bytes"] == 4 + (0 if fits else 2 * row)
        assert cfg["threads"] == 512
    assert rk.row_launch_plan(S, 10 ** 5, 10 ** 5, 1)["rows"] == "global"
    # the closure is shared while it fits beside the two state vectors
    assert rk.row_launch_plan(S, 8, 8, 1)["closure"] == \
        ("global" if S == 512 else "shared")
    assert rk.row_launch_plan(S, 8, 8, 1, rows="global")["rows"] == "global"


def test_plan_lanes_lattice_and_refusals():
    assert [rk._lanes(S) for S in (1, 4, 16, 64, 65, 132, 256, 512)] == \
        [32, 32, 32, 8, 4, 2, 2, 1]
    # prot2dna at chip_smoke's width: both rows and the closure shared
    cfg = rk.row_launch_plan(132, 64, 192, 8)
    assert (cfg["closure"], cfg["rows"], cfg["lanes"]) == \
        ("shared", "shared", 2)
    assert cfg["smem_bytes"] == (2 * 132 + 132 * 132 + 2 * 65 * 132) * 4
    # past 152 positions prot2dna's rows leave shared memory
    assert rk.row_launch_plan(132, 152, 10, 1)["rows"] == "shared"
    assert rk.row_launch_plan(132, 153, 10, 1)["rows"] == "global"
    lat = rk.row_launch_plan(132, 64, 192, 2, lattice=True)
    assert lat["rows"] == "lattice"
    assert lat["mem_bytes"] == 2 * 193 * 65 * 132 * 4
    card = 80 * 10 ** 9
    assert rk.row_launch_plan(512, 10 ** 5, 10 ** 5, 1, mem_bytes=card)
    with pytest.raises(ValueError, match="device bytes"):
        rk.row_launch_plan(64, 10 ** 5, 10 ** 5, 1, lattice=True,
                           mem_bytes=card)
    with pytest.raises(ValueError, match="states"):
        rk.row_launch_plan(513, 8, 8, 1)
    with pytest.raises(ValueError, match="global"):
        rk.row_launch_plan(4, 8, 8, 1, lattice=True, rows="global")


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


def test_an_input_that_requires_grad_raises():
    _, mats, it, ot = _pair("allclass", "logsumexp")
    tm = [torch.from_numpy(x) for x in mats]
    ti, to = torch.from_numpy(it), torch.from_numpy(ot)
    for k in range(4):
        grad = list(tm)
        grad[k] = tm[k].clone().requires_grad_(True)
        for mode in ("score", "lattice", "backward"):
            with pytest.raises(ValueError, match="gradient"):
                _run(mode, grad, ti, to, LOGSUMEXP)
    band = (torch.zeros(len(ot) + 1, dtype=torch.long),
            torch.full((len(ot) + 1,), len(it) + 1))
    with pytest.raises(ValueError, match="gradient"):
        _run("banded", [tm[0].clone().requires_grad_(True)] + tm[1:], ti,
             to, LOGSUMEXP, band)
    # the associative rows are not the kernel's: autograd runs through
    got = dp2d.forward_2d(tm[0].clone().requires_grad_(True), *tm[1:], ti,
                          to, len(it), len(ot), assoc=True)
    assert got.requires_grad


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
        for rows in (None, "global"):
            again = _launched(lambda: rk.row_scan(
                *tm, ti, to, sr, lens=(len(it), len(ot)), rows=rows))
            assert torch.equal(again, got)


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


def _dense_mats(n_states, sr_name="logsumexp"):
    m = testmachines.build_random_transducer(n_states, list("ACGT"))
    ev = EvaluatedMachine(m, m.get_param_defs(True))
    return tuple(np.asarray(x) for x in LoweredMachine(
        ev, dtype=np.float32).matrices_2d(sr_name))


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
    assert rk.row_launch_plan(512, 12, 12, 1)["closure"] == "global"
    for mode in ("score", "lattice"):
        got = _launched(lambda: _run(mode, tm, ti, to, LOGSUMEXP))
        _lattice_close(got, _run(mode, tm, ti, to, LOGSUMEXP, plain=True),
                       KERNEL_VS_PLAIN["logsumexp"])
    got = float(dp2d.forward_2d(*tm, ti, to, 12, 12))
    _close([got], [forward_2d_f64(*mats, it, ot)], F64_BOUND)


@pytest.mark.cuda
def test_rows_past_shared_memory_on_card():
    """The 64-state ACGT machine (65 states with End) at 500 x 500 (two
    rows of 501 cells do not fit beside the closure) and prot2dna at 160
    aa x 480 nt, Forward against the float64 host oracle."""
    dev = _card()
    mats = _dense_mats(64)
    S = mats[3].shape[0]
    rng = np.random.RandomState(3)
    it = rng.randint(0, 4, 500).astype(np.int32)
    ot = it.copy()
    assert rk.row_launch_plan(S, 412, 412, 1)["rows"] == "shared"
    assert rk.row_launch_plan(S, 500, 500, 1)["rows"] == "global"
    tm = [torch.from_numpy(x).to(dev) for x in mats]
    ti, to = torch.from_numpy(it).to(dev), torch.from_numpy(ot).to(dev)
    got = float(_launched(lambda: dp2d.forward_2d(*tm, ti, to, 500, 500)))
    _close([got], [forward_2d_f64(*mats, it, ot)], F64_BOUND)
    from machineboss_tpu_torch.core.presets import make_preset
    m = make_preset("prot2dna")
    ev = EvaluatedMachine(m, m.get_param_defs(True))
    pm = tuple(np.asarray(x) for x in LoweredMachine(
        ev, dtype=np.float32).matrices_2d())
    (p, dna), = testmachines.prot2dna_pairs(1, 160, seed=3)
    pi = np.array([ev.input_tokenizer.sym2tok[c] - 1 for c in p], np.int32)
    po = np.array([ev.output_tokenizer.sym2tok[c] - 1 for c in dna],
                  np.int32)
    assert rk.row_launch_plan(132, len(pi), len(po), 1)["rows"] == "global"
    got = float(_launched(lambda: dp2d.forward_2d(
        *[torch.from_numpy(x).to(dev) for x in pm],
        torch.from_numpy(pi).to(dev), torch.from_numpy(po).to(dev),
        len(pi), len(po))))
    _close([got], [forward_2d_f64(*pm, pi, po)], F64_BOUND)


@pytest.mark.cuda
def test_card_raises_on_what_the_kernel_does_not_take():
    dev = _card()
    _, mats, it, ot = _pair("allclass", "logsumexp")
    tm = [torch.from_numpy(x).to(dev) for x in mats]
    ti, to = torch.from_numpy(it).to(dev), torch.from_numpy(ot).to(dev)
    with pytest.raises(TypeError, match="float32"):
        dp2d.forward_2d(*[m.double() for m in tm], ti, to, len(it), len(ot))
    with pytest.raises(ValueError, match="gradient"):
        dp2d.forward_2d(tm[0].clone().requires_grad_(True), *tm[1:], ti, to,
                        len(it), len(ot))
    from machineboss_tpu_torch.ops.semiring import PROB
    with pytest.raises(ValueError, match="semiring"):
        dp2d.forward_2d(*tm, ti, to, len(it), len(ot), sr=PROB)
