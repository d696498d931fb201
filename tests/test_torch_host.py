"""The port's copied host layer equals the JAX package's exactly.

machineboss_tpu_torch keeps its own copies of the numpy-only modules
(core/*, utils/logsumexp.py, algo/dp_host.py, algo/fused_align.py,
ops/lowering.py, ops/host_oracle.py, the lowrank host prep, the test
fixtures). On the same
machine they must give bit-identical arrays
(np.array_equal): the copies change only import paths, so any difference is
a copying fault. The merged and 1D host preps are held to the JAX
factories' tensors in tests/test_torch_wavefront_kernel.py and
tests/test_torch_scan1d.py. Also here: the build module names a library
by the bytes of its source and of the headers it includes.
"""

import dataclasses
import json
import re

import numpy as np
import pytest

from machineboss_tpu.core.eval import EvaluatedMachine as JEvaluated
from machineboss_tpu.core.presets import make_preset as j_make_preset
from machineboss_tpu.ops.host_oracle import forward_2d_f64 as j_f64
from machineboss_tpu.ops.lowering import LoweredMachine as JLowered
from machineboss_tpu.ops.pallas.lowrank_kernel import (
    lowrank_cost_ratio as j_ratio, prepare_lowrank as j_prepare)

from machineboss_tpu_torch.core.eval import EvaluatedMachine as TEvaluated
from machineboss_tpu_torch.core.presets import make_preset as t_make_preset
from machineboss_tpu_torch.ops.host_oracle import forward_2d_f64 as t_f64
from machineboss_tpu_torch.ops.kernels.lowrank_kernel import (
    lowrank_cost_ratio as t_ratio, prepare_lowrank as t_prepare)
from machineboss_tpu_torch.ops.lowering import LoweredMachine as TLowered
from machineboss_tpu_torch import testmachines

MACHINES = ["prot2dna", "allclass", "dense8", "indel", "generator"]
_cache = {}


def _machines(name):
    """(JAX package machine, port machine) built by each package's own
    code from the same seeds."""
    if name not in _cache:
        if name == "prot2dna":
            pair = (j_make_preset("prot2dna"), t_make_preset("prot2dna"))
        elif name == "allclass":
            from test_pallas_kernel import build_allclass_transducer
            pair = (build_allclass_transducer(5, list("AC")),
                    testmachines.build_allclass_transducer(5, list("AC")))
        elif name == "indel":
            from test_pallas_kernel import build_indel_transducer
            pair = (build_indel_transducer(6, list("ACGT")),
                    testmachines.build_indel_transducer(6, list("ACGT")))
        elif name == "generator":
            pair = (_bench_generator(6), testmachines.build_generator_1d(6))
        else:
            from bench import build_random_transducer
            pair = (build_random_transducer(8, list("ACGT"), seed=15),
                    testmachines.build_random_transducer(8, list("ACGT"),
                                                         seed=15))
        _cache[name] = pair
    return _cache[name]


def _bench_generator(S):
    """The 1D generator as bench.dense1d_workload_run builds it inline
    (its RandomState(42), one draw of destination and weight per symbol)."""
    from machineboss_tpu.core.machine import Machine as JMachine
    rng = np.random.RandomState(42)
    states = []
    for s in range(S):
        trans = [{"out": c, "to": int(rng.randint(0, S - 1)),
                  "weight": round(float(rng.uniform(0.1, 1.0)), 4)}
                 for c in "ACGT" for _ in range(1)]
        trans.append({"to": S, "weight": 0.05})
        states.append({"id": "S%d" % s, "trans": trans})
    states.append({"id": "End", "trans": []})
    return JMachine.from_json({"state": states})


def _mats(name):
    key = ("mats", name)
    if key not in _cache:
        jm, tm = _machines(name)
        jl = JLowered(JEvaluated(jm, jm.get_param_defs(True)),
                      dtype=np.float32)
        tl = TLowered(TEvaluated(tm, tm.get_param_defs(True)),
                      dtype=np.float32)
        _cache[key] = ([np.asarray(x) for x in jl.matrices_2d()],
                       [np.asarray(x) for x in tl.matrices_2d()])
    return _cache[key]


@pytest.mark.parametrize("name", MACHINES)
def test_machine_json_equal(name):
    jm, tm = _machines(name)
    assert json.loads(jm.to_json_str()) == json.loads(tm.to_json_str())


@pytest.mark.parametrize("name", MACHINES)
def test_matrices_2d_equal(name):
    jmats, tmats = _mats(name)
    for a, b in zip(jmats, tmats):
        assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("name", MACHINES)
def test_prepare_lowrank_equal(name):
    jmats, tmats = _mats(name)
    jplan, jm = j_prepare(*jmats)
    tplan, tm = t_prepare(*tmats)
    assert jplan["Sa"] == tplan["Sa"]
    assert np.array_equal(jplan["idx"], tplan["idx"])
    assert np.array_equal(jplan["c0"], tplan["c0"])
    assert [dataclasses.astuple(c) for c in jplan["classes"]] == \
        [dataclasses.astuple(c) for c in tplan["classes"]]
    assert len(jm) == len(tm)
    for (jM, jE), (tM, tE) in zip(jm, tm):
        assert np.array_equal(jM, tM) and np.array_equal(jE, tE)
    if name == "prot2dna":
        # the plan the main path runs: 132 states pruned to 100, a rank-2
        # source-side up class and a rank-1 destination-side left class
        assert tplan["Sa"] == 100
        assert [dataclasses.astuple(c) for c in tplan["classes"]] == [
            ("up", "src", 2, 4, False), ("left", "dest", 1, 20, True)]
        assert tm[0][0].shape == (100, 200) and tm[1][0].shape == (100, 100)


@pytest.mark.parametrize("name", MACHINES)
def test_lowrank_cost_ratio_equal(name):
    jmats, tmats = _mats(name)
    jr = j_ratio(*jmats)[0]
    tr = t_ratio(*tmats)[0]
    assert jr == tr
    if name == "prot2dna":
        assert tr < 0.6


@pytest.mark.parametrize("name", MACHINES)
def test_forward_2d_f64_equal(name):
    jmats, tmats = _mats(name)
    n_in, n_out = tmats[1].shape[0], tmats[2].shape[0]
    rng = np.random.RandomState(3)
    for li, lo in ((4, 12), (7, 5), (0, 3)):
        # a generator has no input alphabet: its input side stays empty
        it = rng.randint(0, n_in, li) if n_in else np.zeros(0, np.int64)
        ot = rng.randint(0, n_out, lo)
        assert j_f64(*jmats, it, ot) == t_f64(*tmats, it, ot)


@pytest.mark.parametrize("name", ["generator", "dense8"])
def test_emit_matrices_1d_equal(name):
    jm, tm = _machines(name)
    jl = JLowered(JEvaluated(jm, jm.get_param_defs(True)), dtype=np.float32)
    tl = TLowered(TEvaluated(tm, tm.get_param_defs(True)), dtype=np.float32)
    for side in (True, False):
        for a, b in zip(jl.emit_matrices_1d(output_side=side),
                        tl.emit_matrices_1d(output_side=side)):
            a, b = np.asarray(a), np.asarray(b)
            assert a.dtype == b.dtype and np.array_equal(a, b)


def test_ragged_lens_equal():
    from bench import _ragged_lens
    for seed, B, L in ((0, 512, 200), (3, 7, 1), (5, 16, 33)):
        a = _ragged_lens(np.random.RandomState(seed), B, L)
        b = testmachines.ragged_lens(np.random.RandomState(seed), B, L)
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_library_name_follows_source_and_header_bytes(tmp_path, monkeypatch):
    """No nvcc needed: the library's name is a hash of the source and of
    every csrc/ file it includes, so editing a shared header renames the
    libraries of the kernels that include it and of no other."""
    import shutil

    from machineboss_tpu_torch.ops.kernels import _build
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", str(csrc))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    assert set(_build.SOURCES) == {
        "lowrank_wavefront", "merged_wavefront", "chained_ragged_wavefront",
        "chained_wavefront", "generic_wavefront", "seqscale_wavefront",
        "factored_wavefront", "scan1d", "viterbi_wavefront",
        "viterbi_banded_wavefront", "lattice_walk", "fused_plan7",
        "row_scan", "expected_counts", "sparse_walk"}
    for name, deps in (("merged_wavefront", 2),
                       ("chained_ragged_wavefront", 2),
                       ("chained_wavefront", 2), ("generic_wavefront", 2),
                       ("seqscale_wavefront", 2), ("factored_wavefront", 2),
                       ("lowrank_wavefront", 2), ("scan1d", 1),
                       ("viterbi_wavefront", 2),
                       ("viterbi_banded_wavefront", 2), ("lattice_walk", 1),
                       ("fused_plan7", 1), ("row_scan", 2),
                       ("expected_counts", 1), ("sparse_walk", 2)):
        files = _build.source_files(name)
        assert len(files) == deps and files[0].endswith(_build.SOURCES[name])
        assert all(f.startswith(str(csrc)) for f in files)
    before = {n: _build._lib_path(n)[1] for n in _build.SOURCES}
    assert len(set(before.values())) == 15
    with open(csrc / "wavefront_common.cuh", "ab") as f:
        f.write(b"\n// edited\n")
    after = {n: _build._lib_path(n)[1] for n in _build.SOURCES}
    changed = {n for n in before if before[n] != after[n]}
    assert changed == {"merged_wavefront", "chained_ragged_wavefront",
                       "chained_wavefront", "generic_wavefront",
                       "seqscale_wavefront"}
    # the tensor-core helpers: the two 3xTF32 kernels and no other
    after = {n: _build._lib_path(n)[1] for n in _build.SOURCES}
    with open(csrc / "tf32_mma.cuh", "ab") as f:
        f.write(b"\n// edited\n")
    changed = {n for n in after if _build._lib_path(n)[1] != after[n]}
    assert changed == {"lowrank_wavefront", "factored_wavefront"}
    after = {n: _build._lib_path(n)[1] for n in _build.SOURCES}
    # the chained schedule walks pair by pair on walk_pair (its strip
    # header is gone), and the cluster helpers both Viterbi fills, the
    # row kernel and the sparse walk use live once, in viterbi_common.cuh
    assert not (csrc / "strip.cuh").exists()
    common = (csrc / "viterbi_common.cuh").read_text()
    sources = [(csrc / f).read_text() for f in _build.SOURCES.values()]
    for helper in ("cluster_rank", "cluster_sync", "peer_addr",
                   "peer_store"):
        define = re.compile(r"__forceinline__ \w+ %s\(" % helper)
        assert len(define.findall(common)) == 1
        assert not any(define.search(src) for src in sources)
    for name in ("viterbi_wavefront", "viterbi_banded_wavefront",
                 "row_scan"):
        src = (csrc / _build.SOURCES[name]).read_text()
        assert "cluster_rank()" in src and "cluster_sync()" in src \
            and "peer_addr(" in src
    with open(csrc / "scan1d.cu", "ab") as f:
        f.write(b"\n// edited\n")
    assert _build._lib_path("scan1d")[1] != after["scan1d"]
    assert _build._lib_path("lowrank_wavefront")[1] == \
        after["lowrank_wavefront"]
    with open(csrc / "viterbi_common.cuh", "ab") as f:
        f.write(b"\n// edited\n")
    changed = {n for n in after if _build._lib_path(n)[1] != after[n]}
    assert changed == {"scan1d", "viterbi_wavefront",
                       "viterbi_banded_wavefront", "row_scan", "sparse_walk"}


# ---- the host side of alignment: utils/logsumexp, core/seqpair, algo/dp_host

VERBATIM = ["utils/logsumexp.py", "core/seqpair.py", "algo/dp_host.py",
            "core/hmmer.py", "algo/fused_align.py", "algo/beam.py",
            "algo/ctc.py", "core/csvprof.py",
            "core/fastseq.py", "core/jphmm.py", "models/__init__.py",
            "models/tkf91.py", "parallel/__init__.py", "core/regex.py",
            "algo/downsample.py", "utils/logger.py", "codegen_impl.py",
            "codegen.py", "native.py", "core/machine.py"]


@pytest.mark.parametrize("rel", VERBATIM)
def test_verbatim_copy_has_the_same_source(rel):
    """These modules import only by relative paths, so the copy is the
    original byte for byte."""
    import os
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "machineboss_tpu", rel), "rb") as f:
        original = f.read()
    with open(os.path.join(root, "machineboss_tpu_torch", rel), "rb") as f:
        assert f.read() == original


def test_logsumexp_table_equal():
    from machineboss_tpu.utils import logsumexp as j_lse
    from machineboss_tpu_torch.utils import logsumexp as t_lse
    assert np.array_equal(j_lse._TABLE, t_lse._TABLE)
    rng = np.random.RandomState(0)
    a = rng.uniform(-30, 2, 200)
    b = rng.uniform(-30, 2, 200)
    a[:5] = -np.inf
    assert np.array_equal(j_lse.lse_vec(a, b), t_lse.lse_vec(a, b))
    assert [j_lse.lse(x, y) for x, y in zip(a, b)] == \
        [t_lse.lse(x, y) for x, y in zip(a, b)]


@pytest.mark.parametrize("width", [None, 0, 2, 50])
def test_envelope_equal(width):
    from machineboss_tpu.core import seqpair as j_sp
    from machineboss_tpu_torch.core import seqpair as t_sp
    rng = np.random.RandomState(4)
    cols = []
    for _ in range(30):
        r = rng.rand()
        a, b = "ACGT"[rng.randint(4)], "ACGT"[rng.randint(4)]
        cols.append((a, b) if r < 0.6 else (a, "") if r < 0.8 else ("", b))
    envs = []
    for mod in (j_sp, t_sp):
        sp = mod.SeqPair(mod.NamedSeq("x", [a for a, _ in cols if a]),
                         mod.NamedSeq("y", [b for _, b in cols if b]), cols)
        env = mod.Envelope(sp, width)
        assert env.fits(sp) and env.connected()
        envs.append((env.in_start, env.in_end, env.n_cells(),
                     env.to_json_str(), sp.to_json_str()))
    assert envs[0] == envs[1]


@pytest.mark.parametrize("name", ["allclass", "indel", "dense8"])
def test_host_dp_matrices_equal(name):
    """The copied host engines fill the same cells and trace the same
    path as the originals."""
    from machineboss_tpu.algo import dp_host as j_dp
    from machineboss_tpu.core.seqpair import NamedSeq as JNamedSeq, \
        SeqPair as JSeqPair
    from machineboss_tpu_torch.algo import dp_host as t_dp
    from machineboss_tpu_torch.core.seqpair import NamedSeq, SeqPair
    jm, tm = _machines(name)
    jev = JEvaluated(jm, jm.get_param_defs(True))
    tev = TEvaluated(tm, tm.get_param_defs(True))
    alphabet = "AC" if name == "allclass" else "ACGT"
    rng = np.random.RandomState(6)
    n = 5 if name == "dense8" else None
    xs = [alphabet[c] for c in rng.randint(0, len(alphabet), n or 5)]
    ys = [alphabet[c] for c in rng.randint(0, len(alphabet), n or 4)]
    jsp = JSeqPair(JNamedSeq("x", xs), JNamedSeq("y", ys))
    tsp = SeqPair(NamedSeq("x", xs), NamedSeq("y", ys))
    for cls in ("ForwardMatrix", "ViterbiMatrix", "BackwardMatrix"):
        a, b = getattr(j_dp, cls)(jev, jsp), getattr(t_dp, cls)(tev, tsp)
        assert np.array_equal(a.cell, b.cell), cls
        assert a.log_like() == b.log_like()
    assert j_dp.RollingForward(jev, jsp).log_like() == \
        t_dp.RollingForward(tev, tsp).log_like()
    jv, tv = j_dp.ViterbiMatrix(jev, jsp), t_dp.ViterbiMatrix(tev, tsp)
    if tv.log_like() > -np.inf:
        assert jv.traceback(jm).to_json_str(jm) == \
            tv.traceback(tm).to_json_str(tm)


def test_viterbi_2d_f64_equal():
    from machineboss_tpu.ops.host_oracle import viterbi_2d_f64 as j_v64
    from machineboss_tpu_torch.ops.host_oracle import viterbi_2d_f64 as t_v64
    jm, tm = _machines("allclass")
    jmats = [np.asarray(x) for x in JLowered(
        JEvaluated(jm, jm.get_param_defs(True)),
        dtype=np.float64).matrices_2d("maxplus")]
    tmats = [np.asarray(x) for x in TLowered(
        TEvaluated(tm, tm.get_param_defs(True)),
        dtype=np.float64).matrices_2d("maxplus")]
    for a, b in zip(jmats, tmats):
        assert np.array_equal(a, b)
    rng = np.random.RandomState(2)
    for li, lo in ((5, 6), (0, 3), (4, 0)):
        it, ot = rng.randint(0, 2, li), rng.randint(0, 2, lo)
        assert j_v64(*jmats, it, ot) == t_v64(*tmats, it, ot)


def test_align_fixtures_equal_the_originals():
    """testmachines.align_pair draws what scripts/bench_align.py draws, and
    the tie-free machine is the one of tests/test_device_align.py."""
    L = 40
    rng = np.random.RandomState(11)
    xs = [("ACGT")[c] for c in rng.randint(0, 4, L)]
    ys = list(xs)
    for k in rng.choice(L, L // 10, replace=False):
        ys[k] = ("ACGT")[rng.randint(0, 4)]
    sp = testmachines.align_pair(L, mutate=0.1, seed=11)
    assert (sp.input.seq, sp.output.seq) == (xs, ys)
    assert sp.alignment == list(zip(xs, ys))
    m = testmachines.build_tiefree_machine()
    assert m.n_states() == 2 and len(m.states[0].trans) == 10
    pair = testmachines.tiefree_pair()
    assert [a for a, _ in pair.alignment if a] == pair.input.seq
    assert [b for _, b in pair.alignment if b] == pair.output.seq


# ---- the host side of fused Plan7: core/hmmer, algo/fused_align, fixtures

def _toy_models(mod_hmmer, mod_machine, mod_eval):
    from machineboss_tpu_torch import testmachines as tm
    hmm = mod_hmmer.HmmerModel()
    hmm.read(tm.TOY_HMM_TEXT)
    td = mod_machine.Machine.from_json(tm.TOY_TD_JSON)
    return hmm, td, mod_eval.EvaluatedMachine(td, td.get_param_defs(True))


@pytest.mark.parametrize("text", ["toy", "amino19", "fn3_shaped"])
def test_hmmer_models_equal(text):
    """Both copies of the HMMER3 importer parse the same text (the toy
    profile, a seeded random one, the fn3-shaped one) into the same model
    and build the same core and Plan7 machines."""
    from machineboss_tpu.core import hmmer as j_hmmer
    from machineboss_tpu_torch.core import hmmer as t_hmmer
    src = {"toy": testmachines.TOY_HMM_TEXT,
           "amino19": testmachines.random_plan7_hmm_text(
               19, testmachines.AMINO, seed=3),
           "fn3_shaped": testmachines.fn3_shaped_hmm_text()}[text]
    jh, th = j_hmmer.HmmerModel(), t_hmmer.HmmerModel()
    jh.read(src)
    th.read(src)
    assert len(th.node) == {"toy": 3, "amino19": 19, "fn3_shaped": 86}[text]
    assert jh.alph == th.alph and jh.null_emit == th.null_emit
    assert jh.ins0_emit == th.ins0_emit
    for a, b in zip(jh.node, th.node):
        for slot in j_hmmer.HmmerNode.__slots__:
            assert getattr(a, slot) == getattr(b, slot), slot
    assert jh.calc_match_occupancy() == th.calc_match_occupancy()
    if text != "fn3_shaped":
        for build in (lambda h: h.machine(True), lambda h: h.machine(False),
                      lambda h: h.plan7_machine(multihit=True, length=10.0)):
            assert json.loads(build(jh).to_json_str()) == \
                json.loads(build(th).to_json_str())


def test_random_plan7_profile_is_normalised():
    """The seeded profile text: every emission row and every source
    state's transitions sum to 1 within the 5 printed decimals, the last
    node has no delete continuation, and the fn3-shaped profile has fn3's
    shape (86 nodes over the 20 amino acids in HMMER's order)."""
    from machineboss_tpu_torch.core.hmmer import HmmerModel
    h = HmmerModel()
    h.read(testmachines.fn3_shaped_hmm_text(seed=0))
    assert len(h.node) == 86 and h.alph == list("ACDEFGHIKLMNPQRSTVWY")
    for n in h.node:
        assert abs(sum(n.match_emit) - 1) < 1e-3
        assert abs(sum(n.ins_emit) - 1) < 1e-3
        assert abs(n.m_to_m + n.m_to_i + n.m_to_d - 1) < 1e-4
        assert abs(n.i_to_m + n.i_to_i - 1) < 1e-4
        assert abs(n.d_to_m + n.d_to_d - 1) < 1e-4
    assert h.node[-1].m_to_d == 0.0 and h.node[-1].d_to_d == 0.0
    assert abs(h.b_to_m1 + h.b_to_i0 + h.b_to_d1 - 1) < 1e-4
    again = testmachines.fn3_shaped_hmm_text(seed=0)
    assert again == testmachines.fn3_shaped_hmm_text()
    assert again != testmachines.fn3_shaped_hmm_text(seed=1)


def test_plan7_fixtures_equal_the_originals():
    """TOY_HMM_TEXT and TOY_TD_JSON are the JAX package's test fixtures and
    golden files; the noise transducer and the reads are bench.py's."""
    import os
    import test_fused_plan7 as orig
    assert testmachines.TOY_HMM_TEXT == orig._HMM
    assert testmachines.TOY_TD_JSON == orig._TD
    # bench.py emits only alph[0] spontaneously; the test fixture also G
    loop, end = orig._TD_PROT["state"]
    assert testmachines.noise_transducer_json(testmachines.AMINO) == {
        "state": [{"id": "loop", "trans": [
            t for t in loop["trans"] if "in" in t or t.get("out") != "G"]},
            end]}
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "tests/golden/fused/toy.hmm")) as f:
        assert f.read() == testmachines.TOY_HMM_TEXT
    with open(os.path.join(root, "tests/golden/fused/noise_td.json")) as f:
        assert json.load(f) == testmachines.TOY_TD_JSON
    rng = np.random.RandomState(0)
    alph = testmachines.AMINO
    want = ["".join(alph[i] for i in rng.randint(0, len(alph), 90))
            for _ in range(5)]
    assert testmachines.plan7_reads(alph, 5, 90, seed=0) == want


@pytest.mark.parametrize("multihit", [False, True])
def test_fused_viterbi_aligner_equal(multihit):
    """The copied float64 product-graph Viterbi scores and aligns as the
    original."""
    from machineboss_tpu.algo import fused_align as j_fa
    from machineboss_tpu.core import eval as j_eval, hmmer as j_hmmer, \
        machine as j_machine
    from machineboss_tpu_torch.algo import fused_align as t_fa
    from machineboss_tpu_torch.core import eval as t_eval, hmmer as t_hmmer, \
        machine as t_machine
    jh, jtd, _ = _toy_models(j_hmmer, j_machine, j_eval)
    th, ttd, _ = _toy_models(t_hmmer, t_machine, t_eval)
    ja = j_fa.FusedViterbiAligner(
        jh.plan7_machine(multihit=multihit, length=10.0), jtd)
    ta = t_fa.FusedViterbiAligner(
        th.plan7_machine(multihit=multihit, length=10.0), ttd)
    for seq in ("A", "ACG", "TTACGACGTT"):
        assert ja.score(seq) == ta.score(seq)


# ---- the single-pair slice: dispatch_table.json and the blocked tables

def test_dispatch_table_copy_is_identical():
    """The port's dispatch_table.json is the JAX package's, byte for byte,
    and the port reads its rows by device type: `cpu` from it, `cuda` from
    the port's own dispatch_table_cuda.json (measured on the card)."""
    import os
    from machineboss_tpu_torch.dispatch import _load_dispatch_table
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "machineboss_tpu", "dispatch_table.json"),
              "rb") as f:
        original = f.read()
    with open(os.path.join(root, "machineboss_tpu_torch",
                           "dispatch_table.json"), "rb") as f:
        assert f.read() == original
    rows = json.loads(original)["backends"]
    assert _load_dispatch_table("cpu") == rows["cpu"]
    with open(os.path.join(root, "machineboss_tpu_torch",
                           "dispatch_table_cuda.json")) as f:
        cuda = json.load(f)["backends"]["cuda"]
    assert "cuda" not in rows
    assert _load_dispatch_table("cuda") == cuda


@pytest.mark.parametrize("k", [None, 1, 3])
def test_block_table_helpers_equal(k):
    """dp1d's numpy-only helpers: _np_log_matmul_batch and
    build_token_block_table give the JAX package's arrays bit for bit."""
    from machineboss_tpu.ops import dp1d as jd
    from machineboss_tpu_torch.ops import dp1d as td
    rng = np.random.RandomState(5)
    S, n_tok = 6, 3
    trans = np.log(rng.dirichlet(np.ones(S), size=(n_tok, S))
                   ).transpose(0, 2, 1)
    trans[0, 1, :] = -1e30                    # a dead row
    a, b = trans[:, None], trans[None]
    assert np.array_equal(td._np_log_matmul_batch(a, b),
                          jd._np_log_matmul_batch(a, b))
    got, gk = td.build_token_block_table(trans, k=k)
    ref, rk = jd.build_token_block_table(trans, k=k)
    assert gk == rk and np.array_equal(got, ref)


# ---- the EM slice: counts and objective, beam and prefix search, csvprof,
# fastseq and jphmm


def _em_pairs(mod):
    return mod.SeqPairList([
        mod.SeqPair(mod.NamedSeq("i", list(a)), mod.NamedSeq("o", list(b)))
        for a, b in (("ACGTAC", "ACGGTC"), ("GAT", "GT"), ("", "A"))])


def test_counts_and_objective_equal():
    """MachineCounts on the same pairs gives the same arrays bit for bit,
    and one M-step of MachineObjective the same parameters."""
    from machineboss_tpu.algo import counts as jc
    from machineboss_tpu.core import seqpair as j_sp
    from machineboss_tpu.core.params import param_assign_from_json as jp
    from machineboss_tpu_torch.algo import counts as tc
    from machineboss_tpu_torch.core import seqpair as t_sp
    from machineboss_tpu_torch.core.params import param_assign_from_json as tp
    seed = {"insRate": 0.1, "delRate": 0.2, "time": 0.5}
    got = []
    for make, evaluated, sp, cnt, assign in (
            (t_make_preset, TEvaluated, t_sp, tc, tp),
            (j_make_preset, JEvaluated, j_sp, jc, jp)):
        m = make("tkf91branch")
        params = m.get_param_defs(True).combine(assign(seed), True)
        counts = cnt.MachineCounts(evaluated(m, params), _em_pairs(sp))
        fitted = cnt.MachineObjective(m, counts, m.cons, assign({})) \
            .optimize(assign(seed))
        got.append((counts, {k: float(fitted.defs[k]) for k in fitted.defs},
                    counts.to_json_str()))
    (tcounts, tfit, tjs), (jcounts, jfit, jjs) = got
    assert tcounts.loglike == jcounts.loglike
    assert all(np.array_equal(a, b)
               for a, b in zip(tcounts.count, jcounts.count))
    assert tfit == jfit and tjs == jjs


def test_beam_and_prefix_trees_equal():
    """BeamSearchMatrix and PrefixTree on jukescantor: the same best
    sequences and the same log probabilities."""
    from machineboss_tpu.algo import beam as jb, ctc as jctc
    from machineboss_tpu.core.params import param_assign_from_json as jp
    from machineboss_tpu_torch.algo import beam as tb, ctc as tctc
    from machineboss_tpu_torch.core.params import param_assign_from_json as tp
    out = []
    for make, evaluated, beam, ctc, assign in (
            (t_make_preset, TEvaluated, tb, tctc, tp),
            (j_make_preset, JEvaluated, jb, jctc, jp)):
        m = make("jukescantor")
        ev = evaluated(m, m.get_param_defs(True).combine(
            assign({"t": 0.4}), True))
        seq = list("ACGTTAGC")
        bs = beam.BeamSearchMatrix(ev, seq, 10)
        tree = ctc.PrefixTree(ev, seq)
        out.append((bs.best_seq(), tree.do_prefix_search(),
                    tree.best_log_seq_prob))
    assert out[0] == out[1]


def test_csvprof_fastseq_jphmm_equal(tmp_path):
    """The CSV profile machines, a FASTA read and the jpHMM built from it
    give the same JSON text."""
    from machineboss_tpu.core import csvprof as jcsv, fastseq as jfs, \
        jphmm as jjp
    from machineboss_tpu_torch.core import csvprof as tcsv, fastseq as tfs, \
        jphmm as tjp
    csv = "A,C,G\n0.5,0.25,0.25\n0.1,0.8,0.1\n0.3,0.3,0.4\n"
    fasta = tmp_path / "aln.fa"
    fasta.write_text(">x desc\nACGT\n>y\nAC-T\n>z\nTCGA\n")
    out = []
    for csvprof, fastseq, jphmm in ((tcsv, tfs, tjp), (jcsv, jfs, jjp)):
        prof = csvprof.CSVProfile()
        prof.read(csv)
        seqs = fastseq.read_fast_seqs(str(fasta))
        flush = [s for s in seqs if "-" not in s.seq]
        out.append((prof.machine().to_json_str(),
                    prof.merging_machine().to_json_str(),
                    [(s.name, s.seq) for s in seqs],
                    jphmm.jphmm(flush).to_json_str()))
    assert out[0] == out[1]


def _norm_group_machine(mod):
    """A one-step generator of A, C, G or T with weights in one norm
    group."""
    return mod.Machine.from_json({
        "state": [{"id": "S", "trans": [
            {"out": c, "to": "E", "weight": "p" + c} for c in "ACGT"]},
            {"id": "E", "trans": []}],
        "cons": {"norm": [["pA", "pC", "pG", "pT"]]}})


def test_counts_copy_differs_only_by_the_seeding_repair():
    """algo/counts.py is the original but for one repair: the M-step's
    seeding of a norm group no longer divides by zero once its leading
    members hold all the mass."""
    import os
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "machineboss_tpu", "algo", "counts.py")) \
            as f:
        original = f.read()
    with open(os.path.join(root, "machineboss_tpu_torch", "algo",
                           "counts.py")) as f:
        copy = f.read()
    old = "                z = 1 - p / (1 - p_sum)\n"
    assert original.count(old) == 1 and old not in copy
    head, tail = original.split(old)
    assert copy.startswith(head) and copy.endswith(tail)
    repair = copy[len(head):len(copy) - len(tail)]
    assert "rest = 1 - p_sum" in repair and \
        "z = 1 - p / rest if rest > 0 else 1.0" in repair


def test_objective_seeding_with_all_mass_in_the_leading_members():
    """A seed (0.5, 0.5, 1e-17, 1e-17) makes 1 - p_sum exactly 0 before
    the third member: the JAX package's M-step raises ZeroDivisionError
    (as a prot2dna fit can, once a codon group's trailing codons fall to
    ~1e-17); the port's seeds the rest at 0 and optimizes to the counts'
    proportions."""
    from machineboss_tpu.algo import counts as jc
    from machineboss_tpu.core import machine as jm
    from machineboss_tpu.core.params import param_assign_from_json as jp
    from machineboss_tpu_torch.algo import counts as tc
    from machineboss_tpu_torch.core import machine as tm
    from machineboss_tpu_torch.core.params import param_assign_from_json as tp
    seed = {"pA": 0.5, "pC": 0.5, "pG": 1e-17, "pT": 1e-17}
    got = []
    for cnt, mod, assign in ((jc, jm, jp), (tc, tm, tp)):
        m = _norm_group_machine(mod)
        counts = cnt.MachineCounts()
        counts.count = [np.array([3.0, 1.0, 0.0, 0.0]), np.zeros(0)]
        objective = cnt.MachineObjective(m, counts, m.cons, assign({}))
        try:
            fitted = objective.optimize(assign(seed))
        except ZeroDivisionError:
            got.append(None)
            continue
        got.append({k: float(fitted.defs[k]) for k in fitted.defs})
    assert got[0] is None
    fit = got[1]
    assert abs(fit["pA"] - 0.75) < 1e-2 and abs(fit["pC"] - 0.25) < 1e-2
    assert abs(sum(fit.values()) - 1.0) < 1e-9 and fit["pG"] < 1e-6


def test_cli_copy_differs_only_by_the_device_option_and_usage():
    """cli.py is the JAX package's command line but for --device (an
    application option passed as device= to the four device entry points,
    and named in the docstring) and _usage, which names the port's module
    as the program."""
    import difflib
    import os
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "machineboss_tpu", "cli.py")) as f:
        original = f.read().splitlines()
    with open(os.path.join(root, "machineboss_tpu_torch", "cli.py")) as f:
        copy = f.read().splitlines()
    removed, added = [], []
    for line in difflib.unified_diff(original, copy, lineterm="", n=0):
        if line.startswith(("---", "+++", "@@")):
            continue
        (removed if line.startswith("-") else added).append(line[1:])
    assert removed == [
        "through the host or TPU DP engines.",
        '                               engine=vm.get("--engine", "host"))',
        "            cm = CompiledMachine(machine, params)",
        "            counts = device_counts(machine, params, data)",
        "                                                 envelopes=envs)",
        '    return ("Usage: mboss [construction|application options...]\\n"',
    ]
    assert added == [
        "through the host or device DP engines (--device: cuda, the default,"
        " or cpu).",
        '    "--device",',
        '                               engine=vm.get("--engine", "host"),',
        '                               device=vm.get("--device"))',
        '            cm = CompiledMachine(machine, params, '
        'device=vm.get("--device"))',
        "            counts = device_counts(machine, params, data,",
        '                                   device=vm.get("--device"))',
        "                                                 envelopes=envs,",
        '                                                 '
        'device=vm.get("--device"))',
        '    return ("Usage: python -m machineboss_tpu_torch"',
        '            " [construction|application options...]\\n"',
    ]
