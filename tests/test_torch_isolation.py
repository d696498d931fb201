"""machineboss_tpu_torch and chip_smoke.py import neither jax nor anything
of machineboss_tpu: the port keeps its own copies of what it needs."""

import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "machineboss_tpu_torch")
FORBIDDEN = re.compile(
    r"^\s*(import|from)\s+(jax|jaxlib|machineboss_tpu)(\.|\s|$)", re.M)

_PROBE = r"""
import importlib, pkgutil, sys
import machineboss_tpu_torch as pkg
names = [m.name for m in
         pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "machineboss_tpu"))
print(len(names), ",".join(bad))
"""


def _sources():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, files in os.walk(PKG):
        out += [os.path.join(dirpath, f) for f in files if f.endswith(".py")]
    return out


def test_importing_the_port_loads_no_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    fields = res.stdout.strip().split(" ")
    n_mods, bad = int(fields[0]), fields[1] if len(fields) > 1 else ""
    # every .py file but the package's own __init__ is one module imported
    assert n_mods == len(_sources()) - 2
    assert bad == "", bad


def test_alignment_modules_are_among_the_probed():
    """The probe walks the package: the alignment slice's modules are in
    it, so importing them is what loaded no jax."""
    rel = {os.path.relpath(p, PKG) for p in _sources()[1:]}
    assert {"algo/viterbi_device.py", "algo/traceback_device.py",
            "algo/dp_host.py", "ops/kernels/viterbi_kernel.py",
            "ops/wavefront.py", "ops/dp2d.py", "core/seqpair.py",
            "utils/logsumexp.py"} <= rel


def test_no_jax_import_in_port_sources():
    hits = []
    for path in _sources():
        with open(path) as f:
            for m in FORBIDDEN.finditer(f.read()):
                hits.append("%s: %s" % (os.path.relpath(path, ROOT),
                                        m.group(0).strip()))
    assert not hits, hits


def test_fused_plan7_modules_are_among_the_probed():
    """The fused Plan7 slice's modules are in the walked package too, and
    importing them alone loads neither jax nor machineboss_tpu."""
    rel = {os.path.relpath(p, PKG) for p in _sources()[1:]}
    assert {"ops/fused_plan7.py", "ops/fused.py", "api.py",
            "ops/kernels/fused_plan7_kernel.py", "core/hmmer.py",
            "algo/fused_align.py"} <= rel
    probe = ("import machineboss_tpu_torch.ops.fused_plan7, "
             "machineboss_tpu_torch.ops.kernels.fused_plan7_kernel, "
             "machineboss_tpu_torch.api, machineboss_tpu_torch.ops.fused, "
             "machineboss_tpu_torch.algo.fused_align, sys; "
             "assert 'jax' not in sys.modules "
             "and 'machineboss_tpu' not in sys.modules")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", probe], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr


def test_wavefront_variant_modules_are_among_the_probed():
    """The 2D Forward variants' modules are in the walked package, and
    importing them alone loads neither jax nor machineboss_tpu."""
    rel = {os.path.relpath(p, PKG) for p in _sources()[1:]}
    assert {"ops/kernels/wavefront_kernel.py", "ops/kernels/lowrank_kernel.py",
            "ops/kernels/plain_walk.py", "ops/kernels/factorize.py"} <= rel
    probe = ("import machineboss_tpu_torch.ops.kernels.wavefront_kernel "
             "as wk, machineboss_tpu_torch.ops.kernels.lowrank_kernel as lk, "
             "sys; "
             "[getattr(wk, n) for n in ('chained_wavefront', "
             "'generic_wavefront', 'seqscale_wavefront', "
             "'factored_wavefront', 'prepare_generic', 'prepare_seqscale', "
             "'prepare_factored')]; lk.lowrank_chained_wavefront; "
             "assert 'jax' not in sys.modules "
             "and 'machineboss_tpu' not in sys.modules")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", probe], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr


def test_every_kernel_source_is_built_and_calls_no_library():
    """Every csrc/*.cu is a library that _build.py builds, and every csrc
    file includes only CUDA's runtime header, stdint.h and the package's
    own headers: no PyTorch, cuBLAS, cuDNN or CUTLASS kernel."""
    from machineboss_tpu_torch.ops.kernels import _build
    csrc = os.path.join(PKG, "csrc")
    sources = sorted(f for f in os.listdir(csrc) if f.endswith(".cu"))
    assert sorted(_build.SOURCES.values()) == sources
    assert len(sources) == 15
    local = set(os.listdir(csrc))
    for name in os.listdir(csrc):
        with open(os.path.join(csrc, name)) as f:
            text = f.read()
        for inc in re.findall(r'^\s*#\s*include\s*[<"]([^>"]+)[>"]', text,
                              re.M):
            assert inc in local | {"cuda_runtime.h", "stdint.h"}, (name, inc)
        assert not re.search(r"\b(cublas|cudnn)\w*\s*\(|"
                             r"\b(cutlass|cute|torch|at|c10)::", text), name


def test_single_pair_modules_are_among_the_probed():
    """The single-pair and sparse slice's modules and the dispatch-table
    tool are in the walked package, both dispatch tables ship beside
    dispatch.py, and importing them alone loads neither jax nor
    machineboss_tpu."""
    rel = {os.path.relpath(p, PKG) for p in _sources()[1:]}
    assert {"ops/sparse.py", "ops/pswm.py", "ops/dp_aligned.py",
            "ops/dp1d.py", "ops/dp2d.py", "ops/fwdback.py",
            "ops/kernels/sparse_kernel.py", "dispatch.py",
            "autotune_dispatch.py"} <= rel
    for name in ("dispatch_table.json", "dispatch_table_cuda.json"):
        assert os.path.exists(os.path.join(PKG, name))
    probe = ("import machineboss_tpu_torch.ops.sparse, "
             "machineboss_tpu_torch.ops.kernels.sparse_kernel, "
             "machineboss_tpu_torch.ops.pswm, "
             "machineboss_tpu_torch.ops.dp_aligned, "
             "machineboss_tpu_torch.autotune_dispatch, "
             "machineboss_tpu_torch.dispatch as d, sys; "
             "assert d._load_dispatch_table('cpu') is not None; "
             "assert d._load_dispatch_table('cuda') is not None; "
             "assert 'jax' not in sys.modules "
             "and 'machineboss_tpu' not in sys.modules")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", probe], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr


def test_em_modules_are_among_the_probed():
    """The EM slice's modules (the E-step, the fitter, the rest of the api
    and the model families, with their host copies) are in the walked
    package, and importing them alone loads neither jax nor
    machineboss_tpu."""
    rel = {os.path.relpath(p, PKG) for p in _sources()[1:]}
    assert {"parallel/__init__.py", "parallel/em.py", "algo/fitter.py",
            "algo/counts.py", "algo/beam.py", "algo/ctc.py",
            "core/csvprof.py", "core/fastseq.py", "core/jphmm.py",
            "models/__init__.py", "models/casino.py", "models/ctc.py",
            "models/pairhmm.py", "models/profile.py",
            "models/tkf91.py"} <= rel
    probe = ("import machineboss_tpu_torch.parallel.em, "
             "machineboss_tpu_torch.algo.fitter, "
             "machineboss_tpu_torch.api as a, "
             "machineboss_tpu_torch.models as m, sys; "
             "[getattr(a, n) for n in ('load_machine', 'save_machine', "
             "'forward_loglike', 'viterbi_loglike', 'viterbi_align', "
             "'forward_backward_counts', 'baum_welch_fit', 'beam_decode', "
             "'beam_encode', 'prefix_decode', 'prefix_encode', "
             "'device_forward_batch', 'device_counts_batch', "
             "'fused_plan7_forward')]; "
             "[getattr(m, n) for n in m.__all__]; "
             "assert 'jax' not in sys.modules "
             "and 'machineboss_tpu' not in sys.modules")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", probe], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr


def test_cli_slice_modules_are_among_the_probed():
    """The command line's slice (the CLI and its host modules, profiling,
    the neural DP and the device CTC scorer) is in the walked package;
    importing those modules alone, and running the package as
    `python -m machineboss_tpu_torch`, loads neither jax nor
    machineboss_tpu."""
    rel = {os.path.relpath(p, PKG) for p in _sources()[1:]}
    assert {"cli.py", "__main__.py", "codegen.py", "codegen_impl.py",
            "core/regex.py", "algo/downsample.py", "utils/logger.py",
            "utils/profiling.py", "ops/exprjit.py", "ops/dp_neural.py",
            "algo/ctc_device.py"} <= rel
    probe = ("import machineboss_tpu_torch.cli, "
             "machineboss_tpu_torch.utils.profiling, "
             "machineboss_tpu_torch.ops.exprjit, "
             "machineboss_tpu_torch.ops.dp_neural, "
             "machineboss_tpu_torch.algo.ctc_device, sys; "
             "assert 'jax' not in sys.modules "
             "and 'machineboss_tpu' not in sys.modules")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", probe], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    # the module entry, run with python -X importtime: every module it
    # imported is named on stderr
    res = subprocess.run([sys.executable, "-X", "importtime", "-m",
                          "machineboss_tpu_torch", "--preset", "null"],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr
    loaded = {line.rsplit("|", 1)[-1].strip()
              for line in res.stderr.splitlines() if "|" in line}
    assert "machineboss_tpu_torch.cli" in loaded
    assert not {m for m in loaded
                if m.split(".")[0] in ("jax", "jaxlib", "machineboss_tpu")}


def test_parallel_modules_are_among_the_probed():
    """The parallel layer's modules (the mesh, data-parallel inference,
    the length- and state-sharded scans, the E-step) and the native core's
    bridge are in the walked package, and importing them alone loads
    neither jax nor machineboss_tpu."""
    rel = {os.path.relpath(p, PKG) for p in _sources()[1:]}
    assert {"parallel/mesh.py", "parallel/infer.py",
            "parallel/lengthshard.py", "parallel/stateshard.py",
            "parallel/em.py", "native.py"} <= rel
    probe = ("import machineboss_tpu_torch.parallel.mesh, "
             "machineboss_tpu_torch.parallel.infer, "
             "machineboss_tpu_torch.parallel.lengthshard, "
             "machineboss_tpu_torch.parallel.stateshard, "
             "machineboss_tpu_torch.parallel.em, "
             "machineboss_tpu_torch.native, sys; "
             "assert 'jax' not in sys.modules "
             "and 'machineboss_tpu' not in sys.modules")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", probe], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
