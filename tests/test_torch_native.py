"""The port's bridge to the native host core (machineboss_tpu_torch/native.py,
a verbatim copy of the JAX package's) against the port's Python host
layer: every native op byte-identical to the Python one, as
tests/test_native_parity.py holds the JAX package's, on in-repo machines.

The library is built from native/*.cpp with g++ into a temporary
directory once per module, never into native/ (a library there would
switch on the JAX package's own native tests), and the port's
native._SO_PATH points at it. Skips without g++.
"""

import itertools
import json
import os
import shutil
import subprocess

import pytest

from machineboss_tpu_torch import native
from machineboss_tpu_torch.core.machine import Machine
from machineboss_tpu_torch.core.presets import make_preset
from machineboss_tpu_torch.testmachines import (
    bitnoise_json, build_generator_1d, build_indel_transducer,
    build_random_transducer)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD_TIMEOUT_S = 300


@pytest.fixture(scope="module")
def library(tmp_path_factory):
    """native/*.cpp built into a temporary libmbcore.so (one g++ a source,
    at once, then the link), loaded by the port's bridge."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the native core")
    out = tmp_path_factory.mktemp("native")
    flags = ["-O2", "-std=c++17", "-fPIC"]
    srcs = ["api.cpp", "machine.cpp"]
    procs = [subprocess.Popen(["g++", *flags, "-c", "-o",
                               str(out / (s + ".o")),
                               os.path.join(ROOT, "native", s)],
                              stderr=subprocess.PIPE, text=True)
             for s in srcs]
    for p in procs:
        _, err = p.communicate(timeout=BUILD_TIMEOUT_S)
        assert p.returncode == 0, err
    so = out / "libmbcore.so"
    subprocess.run(["g++", "-shared", "-o", str(so)] +
                   [str(out / (s + ".o")) for s in srcs], check=True,
                   timeout=BUILD_TIMEOUT_S)
    saved = (native._SO_PATH, native._LIB, native._LIB_TRIED)
    native._SO_PATH, native._LIB, native._LIB_TRIED = str(so), None, False
    assert native.available()
    yield native
    native._SO_PATH, native._LIB, native._LIB_TRIED = saved


@pytest.fixture
def python_only(monkeypatch):
    monkeypatch.setenv("MB_NATIVE", "0")
    return monkeypatch


def machines():
    """Binary machines of every shape the repo builds: a channel with
    parameter weights, a diag-only transducer, an indel transducer, a
    generator, and a silent-path generator."""
    gen = Machine.concatenate(
        Machine.wild_generator(list("01")).weight_outputs("1/#"),
        Machine.null())
    return {"bitnoise": Machine.from_json(bitnoise_json()),
            "random": build_random_transducer(3, list("01"), seed=1),
            "indel": build_indel_transducer(3, list("01"), seed=2),
            "generator": build_generator_1d(3, alphabet="01", seed=3),
            "wild": gen}


def jtext(m):
    """State-graph JSON text (the native core's contract; funcs/cons are
    carried by the Python wrapper, not the library)."""
    m2 = m.clone()
    m2.funcs = type(m2.funcs)()
    m2.cons = type(m2.cons)()
    return m2.to_json_str()


COMPOSE = [("bitnoise", "bitnoise"), ("bitnoise", "random"),
           ("indel", "bitnoise"), ("random", "indel"),
           ("generator", "bitnoise"), ("wild", "indel")]


@pytest.mark.parametrize("a,b", COMPOSE)
def test_native_compose_parity(library, python_only, a, b):
    ms = machines()
    py = Machine.compose(ms[a], ms[b])
    assert library.compose_json(jtext(ms[a]), jtext(ms[b]), 2) == jtext(py)


TRANSFORMS = [
    ("advance_sort", lambda m: m.advance_sort()),
    ("advancing", lambda m: m.advancing_machine()),
    ("drop_silent_back", lambda m: m.drop_silent_back_transitions()),
    ("ergodic", lambda m: m.ergodic_machine()),
    ("waiting", lambda m: m.waiting_machine()),
    ("eliminate_silent", lambda m: m.eliminate_silent_transitions()),
    ("merge_equivalent", lambda m: m.merge_equivalent_states()),
    ("reverse", lambda m: m.reverse()),
    ("transpose", lambda m: m.transpose()),
    ("zero_or_one", lambda m: Machine.zero_or_one(m)),
    ("kleene_plus", lambda m: Machine.kleene_plus(m)),
    ("kleene_star", lambda m: Machine.kleene_star(m)),
]


@pytest.mark.parametrize("op,py_fn", TRANSFORMS,
                         ids=[t[0] for t in TRANSFORMS])
def test_native_transform_parity(library, python_only, op, py_fn):
    ms = machines()
    ms["composed"] = Machine.compose(ms["generator"], ms["bitnoise"])
    ms["bintern"] = make_preset("bintern")
    for name, m in ms.items():
        assert library.transform_json(jtext(m), op) == jtext(py_fn(m)), \
            (op, name)


@pytest.mark.parametrize("op,py_fn", [("concat", Machine.concatenate),
                                      ("union", Machine.take_union)])
def test_native_combine_parity(library, python_only, op, py_fn):
    ms = machines()
    for a, b in itertools.combinations(sorted(ms), 2):
        assert library.combine_json(op, jtext(ms[a]), jtext(ms[b])) == \
            jtext(py_fn(ms[a], ms[b])), (op, a, b)


def test_native_intersect_parity(library, python_only):
    """Intersect of recognizer projections (empty output alphabets)."""
    ms = machines()
    for a, b in (("bitnoise", "random"), ("indel", "bitnoise"),
                 ("random", "random")):
        ra, rb = ms[a].silence_output(), ms[b].silence_output()
        assert library.combine_json("intersect", jtext(ra), jtext(rb),
                                    cycle_strategy=2) == \
            jtext(Machine.intersect(ra, rb)), (a, b)


def test_native_wired_into_the_port(library, python_only):
    """MB_NATIVE=1 routes the port's Machine.compose and transforms through
    the library (core/machine.py's _native_lib): the same machines,
    funcs and cons included, as the Python path."""
    from machineboss_tpu_torch.core import machine as core_machine
    ms = machines()
    a, b = ms["bitnoise"], ms["indel"]
    assert core_machine._native_lib() is None
    py = Machine.compose(a, b)
    py_es = py.eliminate_silent_transitions()
    py_me = py.merge_equivalent_states()
    python_only.setenv("MB_NATIVE", "1")
    assert core_machine._native_lib() is library
    nat = Machine.compose(a, b)
    assert jtext(nat) == jtext(py)
    assert nat.funcs.defs == py.funcs.defs
    assert json.loads(nat.to_json_str(show_params=True)) == \
        json.loads(py.to_json_str(show_params=True))
    assert jtext(nat.eliminate_silent_transitions()) == jtext(py_es)
    assert jtext(nat.merge_equivalent_states()) == jtext(py_me)
