"""The parallel layer on torch.distributed (machineboss_tpu_torch/parallel)
against the JAX package's shard_map functions and against itself on one
rank.

The port runs in worlds of gloo processes that this file starts as
workers (`python tests/test_torch_parallel.py --worker ...`): a world of
one, whose first mesh starts its own process group, and a world of four
on meshes (4,1,1), (1,4,1), (1,1,4), (2,2,1), (1,2,2) and a (2,2,1) mesh
over the ranks [3, 1, 2, 0], whose axis groups do not list their ranks in
mesh order. Every rank runs every check and writes its results to an
.npz; the tests compare them with the world of one, with the JAX
functions (run here on as many of conftest's virtual CPU devices, at one
mesh shape per function) and with the port's single-device engines. The
module imports jax and machineboss_tpu only inside its JAX helpers, so a
worker loads torch and the port alone.
"""

import functools
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest

from one_thread import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER_TIMEOUT_S = 150
INIT_TIMEOUT_S = 60
DEAD = -1e20                     # below this a score is log(0)

MESHES = {1: {"111": ((1, 1, 1), None), "data": (None, None)},
          4: {"411": ((4, 1, 1), None), "141": ((1, 4, 1), None),
              "data": (None, None),
              "114": ((1, 1, 4), None), "221": ((2, 2, 1), None),
              "122": ((1, 2, 2), None), "221perm": ((2, 2, 1), [3, 1, 2, 0])}}
MESHES_4 = sorted(k for k, (shape, _) in MESHES[4].items() if shape)
DATA_MESH_CHECKS = ("infer", "counts", "fitter")
COMPOSITE_MESHES = {"111", "221"}

INFER_TOL = 1e-5                 # nats: the same f32 engine, other blocks
HOST_TOL = 1e-2                  # nats: f32 device vs the f64 host
COUNTS_TOL = 1e-3                # f32 counts summed in another order
SCAN_TOL = 1e-3                  # nats: 1D scans, log-depth or sequential
DIAG_TOL = 1e-4                  # nats: the same log-space recurrence
FIT_TOL = 1e-6                   # per parameter
KERNEL_TOL = 5e-3                # nats: the JAX test's, for lowrank's SVD


# ------------------------------------------------------------ fixtures
# numpy and the port only: the workers and this process build the same
# inputs from the same seeds

def _seq_pairs(pairs):
    from machineboss_tpu_torch.core.seqpair import NamedSeq, SeqPair
    return [SeqPair(NamedSeq("i", list(x)), NamedSeq("o", list(y)))
            for x, y in pairs]


def _bits(rng, n):
    return "".join("01"[t] for t in rng.randint(0, 2, n))


def infer_case():
    """A diag-only random transducer (a pair of unequal lengths is
    impossible) and 11 pairs, not divisible by 2 or 4."""
    from machineboss_tpu_torch.testmachines import build_random_transducer
    m = build_random_transducer(4, list("01"), seed=4)
    rng = np.random.RandomState(0)
    pairs = []
    for n in range(11):
        li = rng.randint(2, 9)
        lo = li if n % 3 else rng.randint(2, 9)
        pairs.append((_bits(rng, li), _bits(rng, lo)))
    return json.loads(m.to_json_str()), {}, pairs


COUNT_PARAMS = {"p": 0.7, "q": 0.2, "r": 0.05}


def counts_case(n_pairs):
    from machineboss_tpu_torch.testmachines import bitnoise_json
    rng = np.random.RandomState(1)
    pairs = [(_bits(rng, rng.randint(2, 5)), _bits(rng, rng.randint(2, 5)))
             for _ in range(n_pairs)]
    return bitnoise_json(), COUNT_PARAMS, pairs


def generator_1d(n_states, seed):
    """(trans, closure) of a seeded dense generator, float32."""
    from machineboss_tpu_torch.core.eval import EvaluatedMachine
    from machineboss_tpu_torch.ops.lowering import LoweredMachine
    from machineboss_tpu_torch.testmachines import build_generator_1d
    gen = build_generator_1d(n_states, seed=seed)
    ev = EvaluatedMachine(gen, gen.get_param_defs(True))
    return LoweredMachine(ev, dtype=np.float32).emit_matrices_1d(True)


def length_case():
    trans, closure = generator_1d(7, seed=3)
    toks = np.random.RandomState(0).randint(0, trans.shape[0], 16)
    return trans, closure, toks.astype(np.int64), 13


def state_case():
    """S padded to a multiple of 4 with End moved to the last index, as
    tests/test_parallel.py pads it."""
    trans, closure = generator_1d(9, seed=5)
    S, n = closure.shape[0], 4
    Sp = -(-S // n) * n
    tp = np.full((trans.shape[0], Sp, Sp), -1e30, np.float32)
    tp[:, :S, :S] = trans
    cp = np.full((Sp, Sp), -1e30, np.float32)
    cp[:S, :S] = closure
    for a in (tp, cp):
        a[..., [S - 1, Sp - 1], :] = a[..., [Sp - 1, S - 1], :]
        a[..., :, [S - 1, Sp - 1]] = a[..., :, [Sp - 1, S - 1]]
    toks = np.random.RandomState(0).randint(0, trans.shape[0], 12)
    return tp, cp, toks.astype(np.int64), 10


def long_state_case():
    """(toks, length) of 100 positions for state_case's machine."""
    tp = state_case()[0]
    return (np.random.RandomState(1).randint(0, tp.shape[0], 100)
            .astype(np.int64), 100)


def lowered_2d(machine):
    from machineboss_tpu_torch.core.eval import EvaluatedMachine
    from machineboss_tpu_torch.ops.lowering import LoweredMachine
    ev = EvaluatedMachine(machine, machine.get_param_defs(True))
    return tuple(LoweredMachine(ev, dtype=np.float32).matrices_2d())


def diag_cases():
    """{name: (mats, batch)}: tests/test_parallel.py's lattice (B=3, 23 x
    17, lengths [23, 11, 0] / [17, 9, 0]: on this diag-only machine only
    the empty pair lives), the same tokens with equal lengths, every pair
    live, and the all-class machine, whose left and up moves cross the
    bands' boundaries."""
    from machineboss_tpu_torch.testmachines import (build_allclass_transducer,
                                                    build_random_transducer)
    mats = lowered_2d(build_random_transducer(7, list("ACGT"), seed=11))
    rng = np.random.RandomState(5)
    B, Li, Lo = 3, 23, 17
    it = rng.randint(0, 4, (B, Li)).astype(np.int64)
    ot = rng.randint(0, 4, (B, Lo)).astype(np.int64)
    mats_ac = lowered_2d(build_allclass_transducer(5, list("AC")))
    lens = (np.array([Li, 11, 0]), np.array([Lo, 9, 0]))
    return {"jax": (mats, (it, ot) + lens),
            "live": (mats, (it, ot, np.array([17, 9, 5]),
                            np.array([17, 9, 5]))),
            "allclass": (mats_ac, (it % 2, ot % 2) + lens)}


FIT_MACHINE = {"state": [
    {"id": "s", "trans": [
        {"in": "A", "out": "A", "to": "s", "weight": "p_match"},
        {"in": "A", "out": "C", "to": "s", "weight": "p_sub"},
        {"in": "C", "out": "C", "to": "s", "weight": "p_match"},
        {"in": "C", "out": "A", "to": "s", "weight": "p_sub"},
        {"to": "e", "weight": "p_end"}]},
    {"id": "e", "trans": []}],
    "cons": {"norm": [["p_match", "p_sub", "p_end"]]}}


def fit_pairs():
    rng = np.random.RandomState(0)
    pairs = []
    for _ in range(12):
        xs = ["AC"[c] for c in rng.randint(0, 2, rng.randint(3, 7))]
        ys = [x if rng.rand() < 0.8 else "AC"["AC".index(x) ^ 1] for x in xs]
        pairs.append(("".join(xs), "".join(ys)))
    return pairs


KERNEL_VARIANTS = {"merged": dict(variant=None, chain=None, merged=True),
                   "chained": dict(variant="chained", chain=2, merged=True),
                   "lowrank": dict(variant="lowrank", chain=None,
                                   merged=False)}


def kernel_case():
    from machineboss_tpu_torch.testmachines import build_random_transducer
    mats = lowered_2d(build_random_transducer(6, list("AC"), seed=5))
    B, L = 16, 10
    rng = np.random.RandomState(3)
    it = rng.randint(0, mats[0].shape[0], (B, L)).astype(np.int64)
    ot = rng.randint(0, mats[0].shape[1], (B, L)).astype(np.int64)
    return mats, it, ot, np.full((B,), L, np.int64)


def composite_case():
    """The sizes of __graft_entry__.dryrun_multichip: a dnapsw E-step of 16
    pairs, a uniform DNA generator at L=64, one 65 x 63 dnapsw lattice
    (B=3) and a 128-state generator at L=24."""
    from machineboss_tpu_torch.core.eval import EvaluatedMachine
    from machineboss_tpu_torch.core.machine import Machine
    from machineboss_tpu_torch.core.presets import make_preset
    from machineboss_tpu_torch.ops.lowering import LoweredMachine
    m = make_preset("dnapsw")
    ev = EvaluatedMachine(m, m.get_param_defs(True))
    rng = np.random.RandomState(0)
    dna = np.array(list("ACGT"))
    pairs = [("".join(dna[rng.randint(0, 4, rng.randint(6, 12))]),
              "".join(dna[rng.randint(0, 4, rng.randint(6, 12))]))
             for _ in range(16)]
    gen = Machine.concatenate(
        Machine.wild_generator(list("ACGT")).weight_outputs("1/#"),
        Machine.null())
    gen_ev = EvaluatedMachine(gen, gen.get_param_defs(True))
    t1, c1 = LoweredMachine(gen_ev, dtype=np.float32).emit_matrices_1d(True)
    toks1 = rng.randint(0, t1.shape[0], 64).astype(np.int64)
    mats2 = tuple(LoweredMachine(ev, dtype=np.float32).matrices_2d())
    it2 = rng.randint(0, mats2[0].shape[0], (3, 65)).astype(np.int64)
    ot2 = rng.randint(0, mats2[0].shape[1], (3, 63)).astype(np.int64)
    lens2 = (np.array([65, 40, 5]), np.array([63, 37, 4]))
    ts, cs = generator_1d(127, seed=7)
    toks_s = rng.randint(0, ts.shape[0], 24).astype(np.int64)
    return (ev, pairs, (t1, c1, toks1), (mats2, it2, ot2) + lens2,
            (ts, cs, toks_s))


# ---------------------------------------------- the port's checks (workers)

def _np(x):
    return np.asarray(x.detach().cpu().numpy() if hasattr(x, "detach")
                      else x, np.float64)


def _flat_counts(counts):
    return np.concatenate([np.asarray(c, np.float64) for c in counts.count])


def check_infer(mesh):
    from machineboss_tpu_torch.core.eval import EvaluatedMachine
    from machineboss_tpu_torch.core.machine import Machine
    from machineboss_tpu_torch.parallel.infer import forward_batch_sharded
    mj, _, pairs = infer_case()
    m = Machine.from_json(mj)
    ev = EvaluatedMachine(m, m.get_param_defs(True))
    return {"scores": forward_batch_sharded(ev, _seq_pairs(pairs), mesh)}


def check_counts(mesh):
    from machineboss_tpu_torch.api import device_counts_batch
    from machineboss_tpu_torch.core.eval import EvaluatedMachine
    from machineboss_tpu_torch.core.machine import Machine
    from machineboss_tpu_torch.core.params import param_assign_from_json
    from machineboss_tpu_torch.core.seqpair import SeqPairList
    from machineboss_tpu_torch.ops.fwdback import CountModel, tokenize_batch
    from machineboss_tpu_torch.parallel.em import (device_counts,
                                                   sharded_counts_fn)
    from machineboss_tpu_torch.parallel.mesh import mesh_device
    mj, params, pairs = counts_case(8)
    m = Machine.from_json(mj)
    ev = EvaluatedMachine(m, param_assign_from_json(params))
    dev = mesh_device(mesh)
    model = CountModel(ev, device=dev)
    batch = tokenize_batch(ev, _seq_pairs(pairs), device=dev)
    grads, total = sharded_counts_fn(model, mesh)(model.logw, *batch)
    mj5, params5, pairs5 = counts_case(5)
    m5 = Machine.from_json(mj5)
    padded = device_counts(m5, param_assign_from_json(params5),
                           SeqPairList(_seq_pairs(pairs5)), mesh=mesh)
    one = device_counts(m5, param_assign_from_json(params5),
                        SeqPairList(_seq_pairs(pairs5[:1])), mesh=mesh)
    api = device_counts_batch(m5, pairs5, params=params5, mesh=mesh,
                              device=dev)
    try:
        device_counts(m5, param_assign_from_json(params5),
                      SeqPairList(_seq_pairs(pairs5)), mesh=mesh,
                      device="cpu" if dev.type == "cuda" else "cuda")
        disagree = 0.0
    except ValueError:
        disagree = 1.0
    return {"grads": _np(grads), "total": _np(total),
            "padded_counts": _flat_counts(padded),
            "padded_total": np.float64(padded.loglike),
            "one_counts": _flat_counts(one),
            "one_total": np.float64(one.loglike),
            "api_counts": _flat_counts(api),
            "api_total": np.float64(api.loglike),
            "disagree": np.float64(disagree)}


SEMIRINGS = ("LOGSUMEXP", "MAXPLUS")


def check_length(mesh):
    """Both log semirings; "vector" is LOGSUMEXP's."""
    import torch
    from machineboss_tpu_torch.ops import semiring
    from machineboss_tpu_torch.parallel.lengthshard import (
        length_sharded_forward_fn)
    trans, closure, toks, length = length_case()
    out = {}
    for name in SEMIRINGS:
        fn = length_sharded_forward_fn(mesh, sr=getattr(semiring, name),
                                       axis="len")
        out[name] = _np(fn(torch.from_numpy(trans),
                           torch.from_numpy(closure), toks, length))
    out["vector"] = out["LOGSUMEXP"]
    return out


def check_state(mesh):
    """Both log semirings; "score" is LOGSUMEXP's; "long" a sequence of
    long_state_case, past several renormalisations."""
    import torch
    from machineboss_tpu_torch.ops import semiring
    from machineboss_tpu_torch.parallel.stateshard import (
        state_sharded_scan_fn)
    tp, cp, toks, length = state_case()
    out = {"long": _np(state_sharded_scan_fn(mesh)(
        torch.from_numpy(tp), torch.from_numpy(cp), *long_state_case()))}
    for name in SEMIRINGS:
        fn = state_sharded_scan_fn(mesh, sr=getattr(semiring, name),
                                   axis="state")
        out[name] = _np(fn(torch.from_numpy(tp), torch.from_numpy(cp),
                           toks, length))
    out["score"] = out["LOGSUMEXP"]
    return out


def check_diag(mesh):
    from machineboss_tpu_torch.parallel.lengthshard import (
        diag_sharded_wavefront_fn)
    import torch
    fn = diag_sharded_wavefront_fn(mesh)
    return {name: _np(fn(*[torch.from_numpy(x) for x in mats + batch]))
            for name, (mats, batch) in diag_cases().items()}


def check_fitter(mesh):
    from machineboss_tpu_torch.algo.fitter import MachineFitter
    from machineboss_tpu_torch.core.machine import Machine
    from machineboss_tpu_torch.core.seqpair import SeqPairList
    m = Machine.from_json(FIT_MACHINE)
    f = MachineFitter(m, engine="device", mesh=mesh,
                      seed=m.cons.default_params())
    p = f.fit(SeqPairList(_seq_pairs(fit_pairs())), max_iterations=3)
    return {"params": np.array([float(p.defs[k]) for k in sorted(p.defs)]),
            "names": np.array(sorted(p.defs))}


def check_kernels(mesh):
    """Each rank scores its block of the batch with a factory built for the
    block, and the blocks are all-gathered in mesh order."""
    import torch
    from machineboss_tpu_torch.ops.kernels.wavefront_kernel import (
        make_wavefront_forward)
    from machineboss_tpu_torch.parallel.mesh import (all_gather, axis_index,
                                                     axis_size, mesh_device)
    mats, it, ot, lens = kernel_case()
    B, L = it.shape
    n, idx = axis_size(mesh, "data"), axis_index(mesh, "data")
    blk = slice(idx * (B // n), (idx + 1) * (B // n))
    out = {}
    for name, kw in KERNEL_VARIANTS.items():
        local = make_wavefront_forward(*mats, B // n, L, L,
                                       device=mesh_device(mesh), **kw)
        got = local(*(torch.from_numpy(x[blk]) for x in (it, ot, lens,
                                                         lens)))
        out[name] = _np(all_gather(got, mesh, "data").reshape(B))
    return out


def check_composite(mesh):
    """One step of the composite: the E-step over 'data', the 1D scan and
    the lattice over 'len', the state scan over 'state'."""
    import torch
    from machineboss_tpu_torch.ops.fwdback import CountModel, tokenize_batch
    from machineboss_tpu_torch.parallel.em import sharded_counts_fn
    from machineboss_tpu_torch.parallel.lengthshard import (
        diag_sharded_wavefront_fn, length_sharded_forward_fn)
    from machineboss_tpu_torch.parallel.stateshard import (
        state_sharded_scan_fn)
    ev, pairs, one_d, two_d, state = composite_case()
    model = CountModel(ev, device="cpu")
    batch = tokenize_batch(ev, _seq_pairs(pairs), device="cpu")
    grads, total = sharded_counts_fn(model, mesh)(model.logw, *batch)
    t1, c1, toks1 = one_d
    f1d = length_sharded_forward_fn(mesh)(torch.from_numpy(t1),
                                          torch.from_numpy(c1), toks1,
                                          len(toks1))
    f2d = diag_sharded_wavefront_fn(mesh)(
        *[torch.from_numpy(np.asarray(x)) for x in two_d[0] + two_d[1:]])
    ts, cs, toks_s = state
    fs = state_sharded_scan_fn(mesh)(torch.from_numpy(ts),
                                     torch.from_numpy(cs), toks_s,
                                     len(toks_s))
    return {"grads": _np(grads), "total": _np(total), "f1d": _np(f1d),
            "f2d": _np(f2d), "fstate": _np(fs)}


def check_placements(mesh):
    """replicated / batch_sharding place a tensor as P() / P('data')."""
    import torch
    from torch.distributed.tensor import distribute_tensor
    from machineboss_tpu_torch.parallel.mesh import (axis_index,
                                                     batch_sharding,
                                                     replicated)
    x = torch.arange(8, dtype=torch.float32)
    shard = distribute_tensor(x, mesh, batch_sharding(mesh)).to_local()
    rep = distribute_tensor(x, mesh, replicated(mesh)).to_local()
    return {"local/shard": _np(shard), "local/replicated": _np(rep),
            "local/data_index": np.float64(axis_index(mesh, "data"))}


CHECKS = {"infer": check_infer, "counts": check_counts,
          "length": check_length, "state": check_state, "diag": check_diag,
          "fitter": check_fitter, "kernels": check_kernels,
          "placements": check_placements}


def mesh_errors(world):
    """make_mesh's refusals: a shape that does not cover the world, the
    card without CUDA, and a backend that does not fit the device."""
    import torch
    from machineboss_tpu_torch.parallel.mesh import make_mesh
    out = {}
    try:
        make_mesh(data=world + 1, device="cpu")
        out["cover"] = "no error"
    except ValueError as e:
        out["cover"] = str(e)
    try:
        make_mesh(device=None)
        out["card"] = "no error"
    except (RuntimeError, ValueError) as e:
        out["card"] = str(e)
    real = torch.cuda.is_available
    torch.cuda.is_available = lambda: True
    try:
        make_mesh(device="cuda")
        out["backend"] = "no error"
    except ValueError as e:
        out["backend"] = str(e)
    finally:
        torch.cuda.is_available = real
    return {"error/" + k: np.array(v) for k, v in out.items()}


CARD_CHECKS = ("infer", "counts", "length", "state", "diag", "fitter")


def run_worker(rank, world, store, outdir, device):
    """One rank: every check on every mesh of its world, results to
    rank<r>.npz. The world of one starts no group itself: its first mesh
    does (a world of one on a HashStore; NCCL with device "cuda", which
    runs CARD_CHECKS)."""
    import datetime
    import torch
    import torch.distributed as dist
    from machineboss_tpu_torch.parallel.mesh import data_mesh, make_mesh
    torch.set_num_threads(1)
    if world > 1:
        dist.init_process_group(
            "gloo", init_method="file://" + store, rank=rank,
            world_size=world,
            timeout=datetime.timedelta(seconds=INIT_TIMEOUT_S))
    results, seconds = {}, {}
    on_card = device == "cuda"
    for name, (shape, devices) in sorted(MESHES[world].items()):
        if shape is None:
            mesh = data_mesh(devices, device=None if on_card else "cpu")
            checks = {k: CHECKS[k] for k in DATA_MESH_CHECKS}
        else:
            mesh = make_mesh(*shape, devices=devices,
                             device=None if on_card else "cpu")
            checks = dict(CHECKS)
        if name in COMPOSITE_MESHES:
            checks["composite"] = check_composite
        if on_card:
            checks = {k: v for k, v in checks.items() if k in CARD_CHECKS}
        for cname, check in sorted(checks.items()):
            t0 = time.perf_counter()
            for k, v in check(mesh).items():
                results["%s/%s/%s" % (name, cname, k)] = v
            seconds["%s/%s" % (name, cname)] = time.perf_counter() - t0
    if not on_card:
        results.update(mesh_errors(world))
    results["loaded/jax"] = np.array(sorted(
        m for m in sys.modules
        if m.split(".")[0] in ("jax", "jaxlib", "machineboss_tpu")), str)
    results["seconds"] = np.array(json.dumps(seconds))
    dist.destroy_process_group()
    np.savez(os.path.join(outdir, "rank%d.npz" % rank), **results)


# --------------------------------------------------------- the launcher

class World:
    """N worker processes on one file:// store, started at once."""

    def __init__(self, n, outdir, device="cpu"):
        self.n, self.outdir = n, str(outdir)
        os.makedirs(self.outdir, exist_ok=True)
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        env.update(GLOO_SOCKET_IFNAME="lo", OMP_NUM_THREADS="1",
                   MKL_NUM_THREADS="1")
        store = os.path.join(self.outdir, "store")
        self.t0 = time.monotonic()
        self.procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--worker", str(r),
             str(n), store, self.outdir, device],
            cwd=ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True) for r in range(n)]
        self._results = None

    def results(self):
        """Every rank's results; fails with the workers' errors."""
        if self._results is None:
            errors = []
            for r, p in enumerate(self.procs):
                left = max(1.0, WORKER_TIMEOUT_S -
                           (time.monotonic() - self.t0))
                try:
                    _, err = p.communicate(timeout=left)
                except subprocess.TimeoutExpired:
                    self.kill()
                    _, err = p.communicate()
                    errors.append("rank %d timed out:\n%s" % (r, err[-3000:]))
                    continue
                if p.returncode:
                    errors.append("rank %d exit %d:\n%s"
                                  % (r, p.returncode, err[-3000:]))
            if errors:
                self.kill()
                pytest.fail("\n".join(errors))
            self._results = [
                dict(np.load(os.path.join(self.outdir, "rank%d.npz" % r)))
                for r in range(self.n)]
        return self._results

    def kill(self):
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.communicate()


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    base = tmp_path_factory.mktemp("worlds")
    w = {n: World(n, base / ("world%d" % n)) for n in (1, 4)}
    yield w
    for world in w.values():
        world.kill()


def _port(worlds, n, mesh, check, key, rank=0):
    return worlds[n].results()[rank]["%s/%s/%s" % (mesh, check, key)]


def _close(got, want, tol, what):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert np.array_equal(got <= DEAD, want <= DEAD), (what, got, want)
    live = want > DEAD
    err = float(np.abs(got[live] - want[live]).max()) if live.any() else 0.0
    assert err <= tol, (what, err, tol)


# ------------------------------------------------------ the JAX functions

def _jax_mesh(shape):
    import jax
    from jax.sharding import Mesh
    n = int(np.prod(shape))
    return Mesh(np.array(jax.devices()[:n]).reshape(shape),
                ("data", "len", "state"))


def _jax_ev(machine_json, params):
    from machineboss_tpu.core.eval import EvaluatedMachine
    from machineboss_tpu.core.machine import Machine
    from machineboss_tpu.core.params import param_assign_from_json
    m = Machine.from_json(machine_json)
    return m, EvaluatedMachine(m, param_assign_from_json(params) if params
                               else m.get_param_defs(True))


def _jax_pairs(pairs):
    from machineboss_tpu.core.seqpair import NamedSeq, SeqPair
    return [SeqPair(NamedSeq("i", list(x)), NamedSeq("o", list(y)))
            for x, y in pairs]


@functools.lru_cache(None)
def jax_infer():
    from machineboss_tpu.algo.dp_host import ForwardMatrix
    from machineboss_tpu.parallel.infer import forward_batch_sharded
    mj, params, pairs = infer_case()
    _, ev = _jax_ev(mj, params)
    sp = _jax_pairs(pairs)
    host = np.array([ForwardMatrix(ev, p).log_like() for p in sp])
    return forward_batch_sharded(ev, sp, _jax_mesh((4, 1, 1))), host


@functools.lru_cache(None)
def jax_counts():
    import jax.numpy as jnp
    from machineboss_tpu.core.seqpair import SeqPairList
    from machineboss_tpu.ops.fwdback import CountModel, tokenize_batch
    from machineboss_tpu.parallel.em import device_counts, sharded_counts_fn
    mesh = _jax_mesh((4, 1, 1))
    mj, params, pairs = counts_case(8)
    _, ev = _jax_ev(mj, params)
    model = CountModel(ev, dtype=jnp.float32)
    grads, total = sharded_counts_fn(model, mesh)(
        model.logw, *tokenize_batch(ev, _jax_pairs(pairs)))
    mj5, params5, pairs5 = counts_case(5)
    m5, _ = _jax_ev(mj5, params5)
    padded = device_counts(m5, _jax_params(params5),
                           SeqPairList(_jax_pairs(pairs5)), mesh=mesh)
    return (np.asarray(grads, np.float64), float(total),
            np.concatenate([np.asarray(c, np.float64)
                            for c in padded.count]), padded.loglike)


def _jax_params(params):
    from machineboss_tpu.core.params import param_assign_from_json
    return param_assign_from_json(params)


@functools.lru_cache(None)
def jax_length(semiring="LOGSUMEXP"):
    import jax.numpy as jnp
    from machineboss_tpu.ops import semiring as j_semiring
    from machineboss_tpu.parallel.lengthshard import length_sharded_forward_fn
    trans, closure, toks, length = length_case()
    fn = length_sharded_forward_fn(_jax_mesh((1, 4, 1)),
                                   sr=getattr(j_semiring, semiring),
                                   axis="len")
    return np.asarray(fn(jnp.asarray(trans), jnp.asarray(closure),
                         jnp.asarray(toks, jnp.int32), jnp.int32(length)),
                      np.float64)


@functools.lru_cache(None)
def jax_state(semiring="LOGSUMEXP"):
    import jax.numpy as jnp
    from machineboss_tpu.ops import semiring as j_semiring
    from machineboss_tpu.parallel.stateshard import state_sharded_scan_fn
    tp, cp, toks, length = state_case()
    fn = state_sharded_scan_fn(_jax_mesh((1, 1, 4)),
                               sr=getattr(j_semiring, semiring),
                               axis="state")
    return float(fn(jnp.asarray(tp), jnp.asarray(cp),
                    jnp.asarray(toks, jnp.int32), jnp.int32(length)))


@functools.lru_cache(None)
def jax_diag():
    import jax.numpy as jnp
    from machineboss_tpu.parallel.lengthshard import diag_sharded_wavefront_fn
    fn = diag_sharded_wavefront_fn(_jax_mesh((1, 4, 1)))
    return {name: np.asarray(fn(*[jnp.asarray(x) for x in mats],
                                *[jnp.asarray(x, jnp.int32) for x in batch]),
                             np.float64)
            for name, (mats, batch) in diag_cases().items()}


@functools.lru_cache(None)
def jax_fit():
    from machineboss_tpu.algo.fitter import MachineFitter
    from machineboss_tpu.core.machine import Machine
    from machineboss_tpu.core.seqpair import SeqPairList
    m = Machine.from_json(FIT_MACHINE)
    f = MachineFitter(m, engine="device", mesh=_jax_mesh((2, 2, 1)),
                      seed=m.cons.default_params())
    p = f.fit(SeqPairList(_jax_pairs(fit_pairs())), max_iterations=3)
    return {k: float(p.defs[k]) for k in p.defs}


# ---------------------------------------------------------------- tests

@pytest.mark.parametrize("mesh", MESHES_4)
def test_infer_matches_one_rank_and_jax(worlds, mesh):
    got = _port(worlds, 4, mesh, "infer", "scores")
    one = _port(worlds, 1, "111", "infer", "scores")
    jax_scores, host = jax_infer()
    _close(got, one, INFER_TOL, "N vs 1")
    _close(got, jax_scores, INFER_TOL, "port vs JAX")
    assert np.array_equal(got <= DEAD, host == -np.inf)
    live = host > -np.inf
    assert live.sum() >= 6 and (~live).sum() >= 2
    assert float(np.abs(got[live] - host[live]).max()) <= HOST_TOL


@pytest.mark.parametrize("mesh", MESHES_4)
def test_counts_match_one_rank_and_jax(worlds, mesh):
    """sharded_counts_fn on 8 pairs; device_counts(mesh=) and
    api.device_counts_batch(mesh=) on 5 (padded with weight-0 pairs to
    8 on four data shards)."""
    grads_j, total_j, padded_j, padded_total_j = jax_counts()
    for key, want in (("grads", grads_j), ("total", total_j),
                      ("padded_counts", padded_j),
                      ("padded_total", padded_total_j)):
        got = _port(worlds, 4, mesh, "counts", key)
        assert np.isfinite(got).all(), key
        _close(got, _port(worlds, 1, "111", "counts", key), COUNTS_TOL,
               key + " N vs 1")
        _close(got, want, COUNTS_TOL, key + " port vs JAX")
    for key in ("counts", "total"):
        assert np.array_equal(_port(worlds, 4, mesh, "counts", "api_" + key),
                              _port(worlds, 4, mesh, "counts",
                                    "padded_" + key))
    # a device that contradicts the mesh's is a ValueError
    assert float(_port(worlds, 4, mesh, "counts", "disagree")) == 1.0


def test_padded_counts_equal_the_unpadded_batch(worlds):
    """5 pairs on 4 data shards: the 3 weight-0 pairs add nothing (and
    no NaN) to the counts or the total of one device's 5-pair call."""
    import torch
    from machineboss_tpu_torch.core.machine import Machine
    from machineboss_tpu_torch.core.params import param_assign_from_json
    from machineboss_tpu_torch.core.seqpair import SeqPairList
    from machineboss_tpu_torch.parallel.em import device_counts
    mj, params, pairs = counts_case(5)
    single = device_counts(Machine.from_json(mj),
                           param_assign_from_json(params),
                           SeqPairList(_seq_pairs(pairs)), device="cpu",
                           dtype=torch.float32)
    got = _port(worlds, 4, "411", "counts", "padded_counts")
    _close(got, _flat_counts(single), COUNTS_TOL, "padded vs single")
    assert abs(float(_port(worlds, 4, "411", "counts", "padded_total"))
               - single.loglike) <= COUNTS_TOL


def test_one_pair_on_four_data_shards(worlds):
    """One pair padded to four: the padding repeats the pair three times
    (the JAX function takes the first `pad` rows, which one pair cannot
    give, and shard_map refuses the batch: ROADMAP queue C)."""
    from machineboss_tpu_torch.core.machine import Machine
    from machineboss_tpu_torch.core.params import param_assign_from_json
    from machineboss_tpu_torch.core.seqpair import SeqPairList
    from machineboss_tpu_torch.parallel.em import device_counts
    mj, params, pairs = counts_case(5)
    single = device_counts(Machine.from_json(mj),
                           param_assign_from_json(params),
                           SeqPairList(_seq_pairs(pairs[:1])), device="cpu")
    _close(_port(worlds, 4, "411", "counts", "one_counts"),
           _flat_counts(single), COUNTS_TOL, "one pair")
    assert abs(float(_port(worlds, 4, "411", "counts", "one_total"))
               - single.loglike) <= COUNTS_TOL


@pytest.mark.parametrize("mesh", MESHES_4)
def test_length_sharded_matches_one_rank_jax_and_scan(worlds, mesh):
    import torch
    from machineboss_tpu_torch.ops import dp1d
    got = _port(worlds, 4, mesh, "length", "vector")
    _close(got, _port(worlds, 1, "111", "length", "vector"), SCAN_TOL,
           "N vs 1")
    _close(got, jax_length(), SCAN_TOL, "port vs JAX")
    trans, closure, toks, length = length_case()
    scan = float(dp1d.forward_1d_scan(torch.from_numpy(trans),
                                      torch.from_numpy(closure),
                                      torch.from_numpy(toks), length))
    assert scan > DEAD and abs(got[-1] - scan) <= SCAN_TOL


@pytest.mark.parametrize("mesh", MESHES_4)
def test_state_sharded_matches_one_rank_jax_and_scan(worlds, mesh):
    import torch
    from machineboss_tpu_torch.ops import dp1d
    got = float(_port(worlds, 4, mesh, "state", "score"))
    assert abs(got - float(_port(worlds, 1, "111", "state", "score"))) \
        <= SCAN_TOL
    assert abs(got - jax_state()) <= SCAN_TOL
    tp, cp, toks, length = state_case()
    scan = float(dp1d.forward_1d_scan(torch.from_numpy(tp),
                                      torch.from_numpy(cp),
                                      torch.from_numpy(toks), length))
    assert scan > DEAD and abs(got - scan) <= SCAN_TOL
    # 100 positions: the shifts' float64 sum against the float64 oracle
    from machineboss_tpu_torch.testmachines import forward_1d_f64
    long_toks, long_len = long_state_case()
    long = float(_port(worlds, 4, mesh, "state", "long"))
    assert abs(long - float(_port(worlds, 1, "111", "state", "long"))) \
        <= SCAN_TOL
    assert abs(long - forward_1d_f64(tp, cp, long_toks[None],
                                     [long_len])[0]) <= SCAN_TOL


@pytest.mark.parametrize("mesh", MESHES_4)
def test_diag_sharded_matches_one_rank_jax_and_wavefront(worlds, mesh):
    import torch
    from machineboss_tpu_torch.ops.wavefront import forward_2d_wavefront
    want_jax = jax_diag()
    for name, (mats, batch) in diag_cases().items():
        got = _port(worlds, 4, mesh, "diag", name)
        _close(got, _port(worlds, 1, "111", "diag", name), DIAG_TOL,
               name + " N vs 1")
        _close(got, want_jax[name], DIAG_TOL, name + " port vs JAX")
        local = forward_2d_wavefront(
            *[torch.from_numpy(x) for x in mats],
            *[torch.from_numpy(x) for x in batch])
        _close(got, _np(local), DIAG_TOL, name + " vs forward_2d_wavefront")
    for name in ("live", "allclass"):
        assert (_port(worlds, 4, mesh, "diag", name) > DEAD).all(), name


@pytest.mark.parametrize("semiring", SEMIRINGS)
def test_scans_in_both_semirings_match_jax(worlds, semiring):
    """The length- and state-sharded scans in LOGSUMEXP and MAXPLUS, on
    the meshes with two axes of size 2, against the JAX functions."""
    for mesh in ("221", "122", "221perm"):
        _close(_port(worlds, 4, mesh, "length", semiring),
               jax_length(semiring), SCAN_TOL, mesh + " length")
        assert abs(float(_port(worlds, 4, mesh, "state", semiring))
                   - jax_state(semiring)) <= SCAN_TOL, mesh


@pytest.mark.parametrize("mesh", MESHES_4)
def test_fitter_on_a_mesh_matches_one_rank_and_jax(worlds, mesh):
    names = [str(k) for k in _port(worlds, 4, mesh, "fitter", "names")]
    got = dict(zip(names, _port(worlds, 4, mesh, "fitter", "params")))
    one = dict(zip(names, _port(worlds, 1, "111", "fitter", "params")))
    want = jax_fit()
    assert set(got) == set(want) and got
    for k in got:
        assert abs(got[k] - one[k]) <= FIT_TOL, (k, got[k], one[k])
        assert abs(got[k] - want[k]) <= FIT_TOL, (k, got[k], want[k])


@pytest.mark.parametrize("mesh", MESHES_4)
@pytest.mark.parametrize("variant", sorted(KERNEL_VARIANTS))
def test_kernels_on_data_blocks_match_one_call(worlds, mesh, variant):
    """merged, chained (chain 2) and lowrank, each rank scoring its block
    of B=16 through the factory, against the factory's one call on the
    whole batch (tests/test_parallel.py's Pallas test, on the port)."""
    import torch
    from machineboss_tpu_torch.ops.kernels.wavefront_kernel import (
        make_wavefront_forward)
    mats, it, ot, lens = kernel_case()
    B, L = it.shape
    full = make_wavefront_forward(*mats, B, L, L, device="cpu",
                                  **KERNEL_VARIANTS[variant])
    ref = _np(full(*(torch.from_numpy(x) for x in (it, ot, lens, lens))))
    got = _port(worlds, 4, mesh, "kernels", variant)
    assert np.isfinite(ref).all() and np.isfinite(got).all()
    _close(got, ref, KERNEL_TOL, variant)
    _close(got, _port(worlds, 1, "111", "kernels", variant), KERNEL_TOL,
           variant + " N vs 1")


@pytest.mark.parametrize("world,mesh", [(1, "111"), (4, "221")])
def test_composite_step_matches_one_device(worlds, world, mesh):
    """__graft_entry__'s composite step on the (2,2,1) mesh and on one
    rank: each sharded result equals its single-device engine."""
    import torch
    from machineboss_tpu_torch.ops import dp1d
    from machineboss_tpu_torch.ops.fwdback import CountModel, tokenize_batch
    from machineboss_tpu_torch.ops.wavefront import forward_2d_wavefront
    ev, pairs, (t1, c1, toks1), two_d, (ts, cs, toks_s) = composite_case()
    model = CountModel(ev, device="cpu")
    g_ref, t_ref, _ = model.counts_and_loglike(
        *tokenize_batch(ev, _seq_pairs(pairs), device="cpu"))

    def port(key):
        return _port(worlds, world, mesh, "composite", key)

    np.testing.assert_allclose(port("total"), _np(t_ref), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(port("grads"), _np(g_ref), rtol=1e-4,
                               atol=1e-5)
    f1d_ref = float(dp1d.forward_1d_scan(torch.from_numpy(t1),
                                         torch.from_numpy(c1),
                                         torch.from_numpy(toks1), len(toks1)))
    assert np.isfinite(port("f1d")).all()
    assert abs(port("f1d")[-1] - f1d_ref) <= SCAN_TOL
    fs_ref = float(dp1d.forward_1d_scan(torch.from_numpy(ts),
                                        torch.from_numpy(cs),
                                        torch.from_numpy(toks_s),
                                        len(toks_s)))
    assert abs(float(port("fstate")) - fs_ref) <= SCAN_TOL
    mats2, it2, ot2, il2, ol2 = two_d
    f2d_ref = forward_2d_wavefront(*[torch.from_numpy(np.asarray(x))
                                     for x in (*mats2, it2, ot2, il2, ol2)])
    _close(port("f2d"), _np(f2d_ref), DIAG_TOL, "2D")
    assert (port("f2d") > DEAD).all()


@pytest.mark.parametrize("n", [1, 4])
def test_every_rank_holds_the_same_results(worlds, n):
    """Outputs are replicated: every rank's equal rank 0's bit for bit
    (placements, one block per rank, apart)."""
    ranks = worlds[n].results()
    for r, res in enumerate(ranks[1:], 1):
        for k, v in ranks[0].items():
            if k == "seconds" or "/local/" in k:
                continue
            assert np.array_equal(res[k], v), (r, k)


def test_placements_shard_and_replicate(worlds):
    """On the meshes whose axes list their ranks in increasing order:
    distribute_tensor scatters a Shard(0) block in the axis group's rank
    order, which on 221perm is not the mesh's (mesh.batch_sharding)."""
    for r, res in enumerate(worlds[4].results()):
        for mesh in MESHES_4:
            if MESHES[4][mesh][1] is not None:
                continue
            idx = int(res["%s/placements/local/data_index" % mesh])
            n = MESHES[4][mesh][0][0]
            x = np.arange(8.0)
            assert np.array_equal(res["%s/placements/local/shard" % mesh],
                                  x[idx * (8 // n):(idx + 1) * (8 // n)])
            assert np.array_equal(
                res["%s/placements/local/replicated" % mesh], x)


@pytest.mark.parametrize("n", [1, 4])
def test_make_mesh_refuses(worlds, n):
    """No fallback: device=None is the card, which a CPU-only torch
    refuses and a gloo world refuses where there is a card."""
    import torch
    res = worlds[n].results()[0]
    assert "does not cover %d devices" % n in str(res["error/cover"])
    assert ("needs the nccl backend" if torch.cuda.is_available()
            else "CUDA is not available") in str(res["error/card"])
    assert "needs the nccl backend" in str(res["error/backend"])


@pytest.mark.parametrize("n", [1, 4])
def test_workers_load_no_jax(worlds, n):
    for res in worlds[n].results():
        assert res["loaded/jax"].size == 0, res["loaded/jax"]


@pytest.mark.parametrize("n", [1, 4])
@pytest.mark.parametrize("check,key", [("infer", "scores"),
                                       ("counts", "padded_counts"),
                                       ("fitter", "params")])
def test_data_mesh_matches_one_rank(worlds, n, check, key):
    """data_mesh(): a one-axis mesh over the world."""
    _close(_port(worlds, n, "data", check, key),
           _port(worlds, 1, "111", check, key),
           {"infer": INFER_TOL, "counts": COUNTS_TOL,
            "fitter": FIT_TOL}[check], check)


def test_world_of_one_starts_its_own_group(worlds):
    """The world-of-one worker called no init_process_group: its first
    make_mesh started the group, and its results are the one-rank
    reference the other tests read."""
    res = worlds[1].results()
    assert len(res) == 1
    assert "111/infer/scores" in res[0]


@pytest.mark.cuda
def test_world_of_one_on_the_card(tmp_path):
    """The world-of-one checks on the card (NCCL, make_mesh with
    device=None) against the same checks in a world of one on the CPU."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cpu = World(1, tmp_path / "cpu")
    card = World(1, tmp_path / "card", device="cuda")
    want, got = cpu.results()[0], card.results()[0]
    for key, tol in (("infer/scores", INFER_TOL), ("counts/grads", COUNTS_TOL),
                     ("counts/total", COUNTS_TOL),
                     ("length/vector", SCAN_TOL), ("state/score", SCAN_TOL),
                     ("diag/live", DIAG_TOL), ("fitter/params", FIT_TOL)):
        _close(got["111/" + key], want["111/" + key], tol, key)


if __name__ == "__main__" and len(sys.argv) > 1 and sys.argv[1] == "--worker":
    sys.path.insert(0, ROOT)
    run_worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5],
               sys.argv[6])
