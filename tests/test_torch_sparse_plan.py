"""The sparse walk's launch plan (ops/kernels/sparse_kernel.py,
`sparse_launch_plan`) and a machine whose closure lists span past float32's
exp.

On the CPU: the 2D form's position ranges and the 1D form's state ranges
cover every cell or state once, the ring slots the plan sizes hold every
pair's range, the shared bytes follow the kernel's layout, the tables'
layout is picked by size alone (prot2dna, the 128- and 512-node Plan7
generators), 16-bit gather indices only below 65,536 states; and on a
Plan7 generator with an improbable delete chain (closure lists spanning
more than 100 nats) the kernel's walk in plain PyTorch agrees with the
float64 host engine and with the JAX engine. On the card (marker cuda):
the kernel on that machine against the eager walk. This file imports the
JAX package only inside its JAX test.
"""

import json

import numpy as np
import pytest
import torch

from machineboss_tpu_torch import testmachines
from machineboss_tpu_torch.algo.dp_host import ForwardMatrix, ViterbiMatrix
from machineboss_tpu_torch.core.eval import EvaluatedMachine
from machineboss_tpu_torch.core.hmmer import HmmerModel
from machineboss_tpu_torch.core.presets import make_preset
from machineboss_tpu_torch.core.seqpair import NamedSeq, SeqPair
from machineboss_tpu_torch.ops import sparse
from machineboss_tpu_torch.ops.kernels import sparse_kernel as sk
from one_thread import one_torch_thread  # noqa: F401

HOST_BOUND = 0.01         # nats: the f64 host engine (the contract)
JAX_BOUND = 1e-4          # nats: the port's walk against the JAX engine
EAGER_BOUND = 1e-5        # nats: the twin against the eager walk
CARD_BOUND = 1e-3         # nats: the kernel against the eager walk on the card
NEG = -1e29
_cache = {}


def _plan7(K, text=None):
    h = HmmerModel()
    h.read(text or testmachines.random_plan7_hmm_text(K, testmachines.AMINO,
                                                      0))
    return h.machine(False)


def _long_chain_text(K, seed=0):
    """random_plan7_hmm_text's profile with improbable deletes (m->d and
    d->d 1e-5 at every node but the last): a state's silent closure holds
    paths down the delete chain, 11.5 nats a step."""
    lines = testmachines.random_plan7_hmm_text(K, testmachines.AMINO,
                                               seed).splitlines()

    def row(last):
        m = [1 - 2e-2, 2e-2, 0.0] if last else [1 - 2e-2 - 1e-5, 2e-2, 1e-5]
        d = [1.0, 0.0] if last else [1 - 1e-5, 1e-5]
        return "          " + "  ".join(
            "*" if x <= 0 else "%.5f" % -np.log(x) for x in m + [0.7, 0.3] + d)

    lines[8] = row(False)                 # the begin state's transitions
    for k in range(K):
        lines[11 + 3 * k] = row(k == K - 1)
    return "\n".join(lines) + "\n"


MACHINES = {"prot2dna": lambda: make_preset("prot2dna"),
            "plan7_128": lambda: _plan7(128),
            "plan7_512": lambda: _plan7(512),
            "long_chain": lambda: _plan7(12, _long_chain_text(12))}


def _ev(name):
    if ("ev", name) not in _cache:
        m = MACHINES[name]()
        _cache[("ev", name)] = EvaluatedMachine(m, m.get_param_defs(True))
    return _cache[("ev", name)]


def _sm(name, dtype=np.float32, device="cpu"):
    key = ("sm", name, np.dtype(dtype).name, device)
    if key not in _cache:
        _cache[key] = sparse.SparseMachine(_ev(name), dtype=dtype,
                                           device=device)
    return _cache[key]


def _tables(name, dtype=np.float32):
    return sk.sparse_tables(_sm(name, dtype))


def _close(port, ref, bound):
    port = np.asarray(port, np.float64)
    ref = np.asarray(ref, np.float64)
    assert port.shape == ref.shape
    assert np.array_equal(port <= NEG / 2, ref <= NEG / 2), (port, ref)
    live = ref > NEG / 2
    assert live.any()
    assert np.abs(port[live] - ref[live]).max() <= bound, (port, ref)


def test_state_ranges_cover_every_state_once():
    """The 1D form's ranges: contiguous, one state or more a block, every
    state once, and balanced by state_turns (no block past the mean by
    more than one state's turns)."""
    for name in ("prot2dna", "plan7_128", "plan7_512"):
        z = _tables(name).sizes
        for cluster in (1, 2, 3, 4, 8, 16):
            cfg = sk.sparse_launch_plan(z.S, 0, 100, 1, z, cluster=cluster)
            work = sk.state_turns(z, cfg["lanes_closure"])
            b = cfg["bounds"]
            assert cfg["form"] == "1d" and len(b) == cluster + 1
            owned = np.concatenate([np.arange(b[k], b[k + 1])
                                    for k in range(cluster)])
            assert np.array_equal(owned, np.arange(z.S))
            assert all(b[k + 1] > b[k] for k in range(cluster))
            per = [work[b[k]:b[k + 1]].sum() for k in range(cluster)]
            assert max(per) <= work.sum() / cluster + work.max()
            assert cfg["n_rows"] == max(np.diff(b))
            assert cfg["n_c"] == max(z.state_closure[b[k]:b[k + 1]].sum()
                                     for k in range(cluster))


def test_position_ranges_cover_every_cell_once():
    """The 2D form's ranges, ceil((L + 1) / cluster) positions a block
    along the shorter side for a pair of L there: every position once,
    in no more than the plan's ring slots (ncb); the shorter side is the
    output's where it is shorter (swap)."""
    z = _tables("prot2dna").sizes
    for Li, Lo in ((3, 9), (64, 192), (100, 40), (1, 1)):
        for cluster in (1, 2, 4, 5, 8, 16):
            cfg = sk.sparse_launch_plan(z.S, Li, Lo, 2, z, cluster=cluster)
            assert cfg["swap"] == (Li > Lo)
            assert cfg["W"] == min(Li, Lo) + 1
            for L in range(cfg["W"]):
                n = -(-(L + 1) // cluster)
                assert n <= cfg["ncb"]
                owned = np.concatenate([
                    np.arange(r * n, min((r + 1) * n, L + 1))
                    for r in range(cluster)])
                assert np.array_equal(owned, np.arange(L + 1))


def test_shared_bytes_follow_the_kernel_layout():
    """sparse_smem_bytes, the kernel's smem_layout counted here: 64 bytes
    of mbarriers, then 16-byte aligned sections."""
    z = _tables("prot2dna").sizes
    cfg = sk.sparse_launch_plan(z.S, 64, 192, 4, z)
    S, v = z.S, z.S * 4
    up = (lambda n: -(-n // 16) * 16)
    rows = up(3 * 5 * v) + up(4 * v) + up(16 * v) + up((S + 2) * 4)
    tabs = (up(z.n_emit * 4) + up(z.n_closure * 4)
            + up((z.n_cls * S + 1) * 4) + up((S + 1) * 4) + up(z.n_io * 4)
            + up(z.n_emit * 2) + up(z.n_closure * 2))
    assert cfg["smem_bytes"] == 64 + rows + tabs
    z = _tables("plan7_128").sizes
    cfg = sk.sparse_launch_plan(z.S, 0, 128, 1, z)
    n, e, c = cfg["n_rows"], cfg["n_e"], cfg["n_c"]
    tabs = (up(e * 4) + up(c * 4) + up((z.n_cls * n + 1) * 4)
            + up((n + 1) * 4) + up(z.n_io * 4) + up(e * 2) + up(c * 2))
    assert cfg["smem_bytes"] == 64 + 2 * up(z.S * 4) + up((n + 2) * 4) + tabs


def test_table_layout_by_size():
    """prot2dna's 2D pairs: every table in every block (17.4 KB) beside
    the shared ring; the 128-node generator's read: a block's states'
    lists; the 512-node one's: streamed (its largest slice, ~34k closure
    entries, and the two vectors pass a block); each falling back as the
    shared memory given shrinks, by size alone."""
    z = _tables("prot2dna").sizes
    cfg = sk.sparse_launch_plan(z.S, 64, 192, 4, z)
    assert (cfg["form"], cfg["rows"], cfg["tables"]) == ("2d", "shared",
                                                         "shared")
    small = sk.sparse_launch_plan(z.S, 64, 192, 4, z,
                                  smem_max=cfg["smem_bytes"] - 1)
    assert (small["rows"], small["tables"]) == ("shared", "global")
    lone = sk.sparse_smem_bytes(dict(cfg, rows="global"))
    tiny = sk.sparse_launch_plan(z.S, 64, 192, 4, z, smem_max=lone)
    assert (tiny["rows"], tiny["tables"]) == ("global", "shared")
    assert tiny["smem_bytes"] == lone
    for elt in (4, 8):
        z = _tables("plan7_128").sizes
        cfg = sk.sparse_launch_plan(z.S, 0, 128, 1, z, elt)
        assert (cfg["form"], cfg["cluster"], cfg["tables"]) == ("1d", 16,
                                                                "slice")
        z = _tables("plan7_512").sizes
        cfg = sk.sparse_launch_plan(z.S, 0, 512, 1, z, elt)
        assert (cfg["form"], cfg["cluster"], cfg["tables"]) == ("1d", 16,
                                                                "global")
        assert cfg["n_c"] > 33000
        big = sk.sparse_launch_plan(z.S, 0, 512, 1, z, elt,
                                    smem_max=10 ** 6)
        assert big["tables"] == "slice"
    # a 1D pair whose two vectors pass a block takes the 2D form
    z = _tables("plan7_512").sizes
    cfg = sk.sparse_launch_plan(z.S, 0, 512, 1, z, smem_max=2 * z.S * 4)
    assert (cfg["form"], cfg["rows"]) == ("2d", "global")


def test_gather_indices_are_16_bit_below_65536_states():
    for S, want in ((132, True), (65535, True), (65536, False),
                    (70000, False)):
        z = sk.ListSizes(S=S, n_cls=2, n_io=1,
                         state_emit=np.ones(S, np.int64),
                         state_closure=np.ones(S, np.int64), emit_row=1.0,
                         closure_row=1.0, cell_terms=2.0 * S)
        for Li in (0, 5):
            assert sk.sparse_launch_plan(S, Li, 5, 1, z)["idx16"] is want


def _host(a, b, viterbi=False):
    cls = ViterbiMatrix if viterbi else ForwardMatrix
    return max(cls(_ev("long_chain"), SeqPair(
        NamedSeq("i", list(a)), NamedSeq("o", list(b)))).log_like(), -1e30)


def _long_chain_batch(reads):
    sym = _ev("long_chain").output_tokenizer.sym2tok
    toks = [[sym[c] for c in r] for r in reads]
    ot, ol = sk.pad_tokens(toks)
    return np.zeros((len(reads), 0), np.int64), ot, np.zeros(len(reads)), ol


LONG_READS = ["MKV", "W", "MKVLAWQ", ""]


def test_long_span_lists_twin_matches_host_and_jax():
    """The long delete chain's closure lists span more than 100 nats (a
    term that far below its list's top underflows float32's exp, though
    its source value can make it the largest): the kernel's walk in plain
    PyTorch against the eager walk, the float64 host engine and the JAX
    engine's forward_1d_sparse, in both semirings."""
    from machineboss_tpu.core.eval import EvaluatedMachine as JEvaluated
    from machineboss_tpu.core.machine import Machine as JMachine
    from machineboss_tpu.ops import sparse as jsparse
    sm = _sm("long_chain")
    t = sk.sparse_tables(sm)
    ints = t.ints.numpy()
    coff, cw = ints[t.o_coff:t.o_cls], t.weights.numpy()[t.o_cw:]
    span = max(np.ptp(cw[coff[s]:coff[s + 1]]) for s in range(t.S)
               if coff[s + 1] > coff[s])
    assert span > 100
    jm = JMachine.from_json(json.loads(_ev("long_chain").machine
                                       .to_json_str()))
    jsm = jsparse.SparseMachine(JEvaluated(jm, jm.get_param_defs(True)))
    batch = _long_chain_batch(LONG_READS)
    for viterbi in (False, True):
        got = sk.sparse_walk_diagonal(sk.sparse_tables(sm, False, viterbi),
                                      *batch).numpy()
        eager = [sparse.forward_1d_sparse(sm, batch[1][b, :batch[3][b]],
                                          viterbi=viterbi)
                 for b in range(len(LONG_READS))]
        if viterbi:
            assert np.array_equal(got, eager)
        else:
            _close(got, eager, EAGER_BOUND)
        _close(got, [_host("", r, viterbi) for r in LONG_READS], HOST_BOUND)
        ref = jsparse.forward_1d_sparse(jsm, [int(x) for x in batch[1][0, :3]],
                                        viterbi=viterbi)
        _close(got[:1], [ref], JAX_BOUND)


@pytest.mark.cuda
def test_long_span_lists_on_card():
    """The kernel on the long delete chain against the eager walk on the
    card, Forward and Backward, both semirings, one launch a call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    card = _sm("long_chain", device="cuda")
    batch = _long_chain_batch(LONG_READS)
    for viterbi in (False, True):
        for reverse in (False, True):
            before = sk.sparse_walk.launches
            got = sk.sparse_walk(card, *batch, viterbi, reverse).cpu().numpy()
            assert sk.sparse_walk.launches == before + 1
            assert sk.sparse_walk.last["plan"]["form"] == "1d"
            eager = [sparse._token_walk(card, [], batch[1][b, :batch[3][b]],
                                        viterbi, reverse)
                     for b in range(len(LONG_READS))]
            if viterbi:
                assert np.array_equal(got, eager)
            else:
                _close(got, eager, CARD_BOUND)
