"""Build and load the port's CUDA kernels.

Each source in `csrc/` is compiled with nvcc for sm_90a into a shared
library with a plain C interface, at first use, under the package's
`build/` directory (listed in .gitignore), and loaded with ctypes. A
phase-profile library (PROFILES) is the same source built with
PROFILE_FLAG. The library name carries a hash of its source and of every
file under `csrc/` that the source includes, so an edited source or header
is rebuilt and a stale library is never loaded. `build_all` starts one
nvcc process per source, all at once, and waits for them together.
"""

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")

# kernel name -> source file under csrc/
SOURCES = {"lowrank_wavefront": "lowrank_wavefront.cu",
           "merged_wavefront": "merged_wavefront.cu",
           "chained_ragged_wavefront": "chained_ragged_wavefront.cu",
           "chained_wavefront": "chained_wavefront.cu",
           "generic_wavefront": "generic_wavefront.cu",
           "seqscale_wavefront": "seqscale_wavefront.cu",
           "factored_wavefront": "factored_wavefront.cu",
           "scan1d": "scan1d.cu",
           "viterbi_wavefront": "viterbi_wavefront.cu",
           "viterbi_banded_wavefront": "viterbi_banded_wavefront.cu",
           "lattice_walk": "lattice_walk.cu",
           "fused_plan7": "fused_plan7.cu",
           "row_scan": "row_scan.cu",
           "expected_counts": "expected_counts.cu",
           "sparse_walk": "sparse_walk.cu"}

# phase-profile library -> the kernel whose source it builds, with
# PROFILE_FLAG: the kernel's clock64 counters, never in a path's library
PROFILES = {"lattice_walk_profile": "lattice_walk",
            "fused_plan7_profile": "fused_plan7",
            "row_scan_profile": "row_scan",
            "expected_counts_profile": "expected_counts",
            "sparse_walk_profile": "sparse_walk"}
PROFILE_FLAG = "-DPHASE_PROFILE"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              "-I", CSRC]

_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.M)

_loaded = {}     # kernel name -> ctypes.CDLL
build_logs = {}  # kernel name -> nvcc output of the build in this process


def _nvcc():
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                           "csrc/ at first use and need the CUDA toolkit")
    return path


def source_files(name):
    """The source of kernel `name` and every file under csrc/ that it
    includes with quotes, directly or through another header, in the order
    found."""
    files = [os.path.join(CSRC, SOURCES[PROFILES.get(name, name)])]
    for path in files:
        with open(path, "rb") as f:
            text = f.read()
        for inc in _INCLUDE.findall(text):
            dep = os.path.join(CSRC, inc.decode())
            if os.path.exists(dep) and dep not in files:
                files.append(dep)
    return files


def _lib_path(name):
    files = source_files(name)
    h = hashlib.sha256()
    for path in files:
        with open(path, "rb") as f:
            h.update(f.read())
    return files[0], os.path.join(BUILD_DIR, "lib%s_%s.so"
                                  % (name, h.hexdigest()[:12]))


def build_all(names=None):
    """Compile every named kernel (default: every path's; a name of
    PROFILES builds that kernel's phase profile) that has no current
    library, one nvcc process per source, concurrently. Returns the wall
    seconds spent; raises RuntimeError with nvcc's output on failure."""
    names = list(SOURCES) if names is None else list(names)
    t0 = time.perf_counter()
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = []
    for name in names:
        src, lib = _lib_path(name)
        if os.path.exists(lib):
            continue
        tmp = "%s.%d.tmp" % (lib, os.getpid())
        flags = NVCC_FLAGS + ([PROFILE_FLAG] if name in PROFILES else [])
        cmd = [_nvcc()] + flags + ["-o", tmp, src]
        procs.append((name, lib, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for name, lib, tmp, proc in procs:
        log, _ = proc.communicate()
        build_logs[name] = log
        if proc.returncode != 0:
            failed.append("%s (nvcc exit %d):\n%s"
                          % (name, proc.returncode, log))
            continue
        os.replace(tmp, lib)
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return time.perf_counter() - t0


def load(name):
    """The ctypes library of kernel `name`, built first if needed."""
    if name not in _loaded:
        _, lib = _lib_path(name)
        if not os.path.exists(lib):
            build_all([name])
        _loaded[name] = ctypes.CDLL(lib)
    return _loaded[name]
