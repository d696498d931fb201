"""The port's command line (machineboss_tpu_torch/cli.py) against the JAX
package's, run in process as the oracle.

Host commands print byte-equal stdout and stderr and exit with the same
status: every preset, the stack operations, the machine printers, the
regexes, the downsamplers, HMMER import, host inference, training,
encoding and decoding, the fused engine and failures. --codegen writes
byte-equal files. The port's --engine device --device cpu is held to the
JAX package's --engine device (which runs its device engines on the CPU):
loglikes within 1e-4 nats, the same alignments, counts within the E-step's
tolerance. Without --device and without CUDA the device engine exits 1
and prints no score. The card test (marker cuda) holds the CLI's prot2dna
loglikes to a direct log_forward_batch. This file imports the JAX package
only inside the tests that run it.
"""

import contextlib
import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from machineboss_tpu_torch import cli as t_cli
from machineboss_tpu_torch.core.presets import preset_names
from machineboss_tpu_torch.core.seqpair import NamedSeq, SeqPair, SeqPairList
from machineboss_tpu_torch.models import casino
from machineboss_tpu_torch.testmachines import (build_generator_1d,
                                                prot2dna_pairs)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FUSED = os.path.join(ROOT, "tests", "golden", "fused")
LL_TOL = 1e-4                    # nats: float32 device engines, two ports
RTOL, ATOL = 1e-3, 1e-4          # the E-step's count tolerance


def _run(main, args):
    """(status, stdout, stderr) of one in-process CLI call."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        status = main(list(args))
    return status, out.getvalue(), err.getvalue()


BINDING = ("-P", "--params", "-F", "--functions")


def _jax_main():
    """The JAX CLI's main, each call on the preset cache as it found it.
    Given parameters without inference, the JAX CLI sets them on its one
    cached preset machine, which later calls in this worker would then
    print (a reference defect the port does not copy; ROADMAP queue C)."""
    import copy
    from machineboss_tpu import cli as j_cli
    from machineboss_tpu.core import presets as j_presets

    def main(argv):
        if not any(a in BINDING for a in argv):
            return j_cli.main(argv)
        kept = copy.deepcopy(j_presets._cache)
        try:
            return j_cli.main(argv)
        finally:
            j_presets._cache.clear()
            j_presets._cache.update(kept)
    return main


def _spl(pairs):
    return SeqPairList([SeqPair(NamedSeq("x%d" % n, list(a)),
                                NamedSeq("y%d" % n, list(b)))
                        for n, (a, b) in enumerate(pairs)]).to_json_str()


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")

    def write(name, text):
        path = str(d / name)
        with open(path, "w") as f:
            f.write(text)
        return path

    rng = np.random.RandomState(5)
    rolls = ["".join(rng.choice(list("123456"), 40)) for _ in range(3)]
    gen = build_generator_1d(6, seed=2)
    out_reads = ["".join(rng.choice(list("ACGT"), 30)) for _ in range(3)]
    return {
        "pairs": write("pairs.json", _spl(prot2dna_pairs(3, [4, 5, 6],
                                                         seed=7))),
        "casino": write("casino.json",
                        casino.casino_machine(True).to_json_str()),
        "casino_cons": write("casino-cons.json", json.dumps(
            {"prob": ["pEnd", "changeToLoadedDie", "changeToFairDie",
                      "loadedP6"]})),
        "casino_seed": write("casino-seed.json", json.dumps(
            casino.DEFAULTS)),
        "rolls": write("rolls.json", _spl([("", r) for r in rolls])),
        "jc_params": write("jc-params.json", json.dumps({"t": 0.3})),
        "gen1d": write("gen1d.json", gen.to_json_str()),
        "reads": write("reads.fa", "".join(">r%d\n%s\n" % (n, s)
                                           for n, s in enumerate(out_reads))),
        "dir": str(d),
    }


def _fmt(args, files):
    return [a.format(**files) for a in args]


HOST_CASES = {
    # stack operations
    "compose": ["--generate-chars", "ACG", "--preset", "compdna"],
    "compose_m": ["--generate-chars", "AC", "-m", "--preset", "jukescantor"],
    "concatenate": ["--generate-chars", "AC", "--concatenate",
                    "--generate-chars", "GT"],
    "union": ["--generate-chars", "A", "--union", "--generate-chars", "CG"],
    "intersect": ["--recognize-wild", "AC", "--intersect",
                  "--recognize-chars", "ACA"],
    "kleene_star": ["--generate-chars", "AC", "--kleene-star"],
    "kleene_plus": ["--generate-chars", "AC", "--kleene-plus"],
    "loop": ["--generate-chars", "A", "--loop", "--generate-chars", "C"],
    "reverse": ["--generate-chars", "ACGT", "--reverse"],
    "revcomp": ["--generate-chars", "ACGG", "--revcomp"],
    "transpose": ["--preset", "jukescantor", "--transpose"],
    "eliminate": ["--preset", "dnapsw", "--eliminate"],
    "flank": ["--generate-chars", "AC", "--flank", "--generate-wild", "G"],
    "weight": ["--generate-chars", "A", "--concatenate", "-w", "0.5"],
    "parens": ["(", "--generate-chars", "A", "--union", "--generate-chars",
               "C", ")", "--kleene-star"],
    # printers
    "stats": ["--preset", "dnapsw", "--stats"],
    "graphviz": ["--preset", "compdna", "--graphviz"],
    "evaluate": ["--preset", "dnapsw", "-U", "--evaluate"],
    "evaluate_params": ["--preset", "jukescantor", "--params",
                        "{jc_params}", "--evaluate"],
    "show_params": ["--preset", "dnapsw", "--show-params"],
    "define_exprs": ["--preset", "tkf91branch", "--define-exprs"],
    "name_states": ["--generate-chars", "AC", "--name-states"],
    "save": ["--preset", "compdna", "--save", "{dir}/saved.json",
             "--stats"],
    # regexes, downsampling, HMMER
    "regex": ["-X", "A(C|G)*T"],
    "dna_regex": ["--dna-regex", "AC[GT]"],
    "aa_regex": ["--aa-regex", "MK.L"],
    # (--downsample-path and -frac sample with an unseeded generator, as
    # the JAX package does: their machine has one path to keep)
    "downsample_size": ["--generate-chars", "AC", "--union",
                        "--generate-chars", "GTA", "--downsample-size",
                        "0.5", "--seed", "1"],
    "downsample_prob": ["--generate-chars", "AC", "--union",
                        "--generate-chars", "GTA", "--downsample-prob",
                        "0.1", "--seed", "1"],
    "downsample_path": ["--generate-chars", "ACGT", "--downsample-path",
                        "2", "--seed", "1"],
    "downsample_frac": ["--generate-chars", "ACGT", "--downsample-frac",
                        "0.5", "--seed", "1"],
    "hmmer": ["-H", os.path.join(FUSED, "toy.hmm")],
    # host inference
    "loglike": ["--preset", "prot2dna", "-U", "--data", "{pairs}",
                "--loglike"],
    "viterbi": ["--preset", "prot2dna", "-U", "--data", "{pairs}",
                "--viterbi"],
    "align": ["--preset", "prot2dna", "-U", "--data", "{pairs}", "--align"],
    "align_wiggle": ["--preset", "prot2dna", "-U", "--data", "{pairs}",
                     "--align", "--wiggle-room", "3"],
    "counts": ["--preset", "prot2dna", "-U", "--data", "{pairs}",
               "--counts"],
    "loglike_chars": ["--preset", "prot2dna", "-U", "--input-chars", "MKV",
                      "--output-chars", "ATGAAAGTT", "--loglike",
                      "--viterbi"],
    "loglike_fasta": ["{gen1d}", "--output-fasta", "{reads}", "--loglike"],
    "train": ["{casino}", "--constraints", "{casino_cons}", "--params",
              "{casino_seed}", "--data", "{rolls}", "--train"],
    # encoding and decoding
    "prefix_decode": ["--preset", "bintern", "--output-chars", "12222",
                      "--prefix-decode"],
    "beam_decode": ["--preset", "bintern", "--output-chars", "12222",
                    "--beam-decode"],
    "random_encode": ["--preset", "bintern", "--input-chars", "101",
                      "--random-encode", "--seed", "42"],
    "prefix_encode": ["--preset", "bintern", "--input-chars", "101",
                      "--prefix-encode"],
    "viterbi_encode": ["--preset", "hamming74", "--viterbi-encode",
                       "--input-chars", "00010010"],
    # the fused engine
    "fused": ["--engine", "fused", "--hmmer-plan7",
              os.path.join(FUSED, "toy.hmm"),
              os.path.join(FUSED, "noise_td.json"), "--data",
              os.path.join(FUSED, "reads.json"), "--viterbi", "--align"],
    "fused_composed": ["--hmmer-plan7", os.path.join(FUSED, "toy.hmm"),
                       os.path.join(FUSED, "noise_td.json"), "--data",
                       os.path.join(FUSED, "reads.json"), "--viterbi",
                       "--align"],
    # failures: exit 1, the same message
    "fail_unknown": ["--no-such-option"],
    "fail_preset": ["--preset", "nosuch"],
    "fail_missing_arg": ["--generate-chars"],
    "fail_missing_machine": ["--concatenate", "--preset", "null"],
    "fail_unmatched": ["(", "--preset", "null"],
    "fail_undefined_param": ["--preset", "prot2dna", "--input-chars", "MK",
                             "--output-chars", "ATGAAA", "--loglike"],
    "fail_fused_loglike": ["--engine", "fused", os.path.join(FUSED,
                                                             "toy.hmm"),
                           os.path.join(FUSED, "noise_td.json"),
                           "--loglike"],
    "fail_data_no_inference": ["--preset", "prot2dna", "-U", "--data",
                               "{pairs}"],
    "fail_train_no_cons": ["{casino}", "--data", "{rolls}", "--train"],
}


@pytest.fixture(autouse=True)
def _python_transforms(monkeypatch):
    """The JAX package's machine transforms would take its optional native
    library where one is built; the port's are Python only."""
    monkeypatch.setenv("MB_NATIVE", "0")


@pytest.mark.parametrize("case", ["preset_" + p for p in preset_names()]
                         + sorted(HOST_CASES))
def test_host_command_is_byte_equal(case, files):
    if case.startswith("preset_"):
        args = ["--preset", case[len("preset_"):]]
    else:
        args = _fmt(HOST_CASES[case], files)
    want = _run(_jax_main(), args)
    saved = os.path.join(files["dir"], "saved.json")
    saved_jax = open(saved).read() if "--save" in args else None
    got = _run(t_cli.main, args)
    assert got == want
    assert (want[0] == 1) == case.startswith("fail_")
    if not case.startswith("fail_"):
        assert want[1]
    if saved_jax is not None:
        assert open(saved).read() == saved_jax


def test_help_names_the_port():
    status, out, _ = _run(t_cli.main, ["--help"])
    assert status == 0
    assert out.startswith("Usage: python -m machineboss_tpu_torch ")
    j_status, j_out, _ = _run(_jax_main(), ["--help"])
    assert j_out.splitlines()[1:] == out.splitlines()[1:]


@pytest.mark.parametrize("target", ["--cpp64", "--cpp32", "--js", "--wgsl"])
def test_codegen_writes_byte_equal_files(target, tmp_path):
    outs = {}
    for name, main in (("jax", _jax_main()), ("port", t_cli.main)):
        d = tmp_path / name
        args = ["--preset", "jukescantor", "-U", "--codegen", str(d), target]
        assert _run(main, args) == (0, "", "")
        outs[name] = {f: (d / f).read_bytes() for f in sorted(os.listdir(d))}
    assert outs["port"] == outs["jax"] and outs["port"]


def _scores(text):
    return {(a, b): float(v) for a, b, v in json.loads(text)}


def _device_pair(args, files):
    args = _fmt(args, files)
    want = _run(_jax_main(), args + ["--engine", "device"])
    got = _run(t_cli.main, args + ["--engine", "device", "--device", "cpu"])
    assert want[0] == got[0] == 0, (want[2], got[2])
    return want[1], got[1]


@pytest.mark.parametrize("case", ["prot2dna", "generator_1d"])
def test_device_loglike_matches_jax(case, files):
    args = (["--preset", "prot2dna", "-U", "--data", "{pairs}"]
            if case == "prot2dna" else ["{gen1d}", "--output-fasta",
                                        "{reads}"]) + ["--loglike"]
    want, got = _device_pair(args, files)
    w, g = _scores(want), _scores(got)
    assert list(w) == list(g)
    for k in w:
        assert abs(w[k] - g[k]) <= LL_TOL, (k, w[k], g[k])


@pytest.mark.parametrize("wiggle", [None, 3])
def test_device_align_matches_jax(wiggle, files):
    args = ["--preset", "prot2dna", "-U", "--data", "{pairs}", "--viterbi",
            "--align"] + (["--wiggle-room", str(wiggle)] if wiggle else [])
    want, got = _device_pair(args, files)
    w_vit, w_align = want.split("]\n", 1)
    g_vit, g_align = got.split("]\n", 1)
    w, g = _scores(w_vit + "]"), _scores(g_vit + "]")
    assert list(w) == list(g)
    for k in w:
        assert abs(w[k] - g[k]) <= LL_TOL, (k, w[k], g[k])
    assert g_align == w_align
    # and the host engine aligns them the same way
    host = _run(t_cli.main, _fmt(args, files))
    assert host[1].split("]\n", 1)[1] == g_align


def test_device_counts_match_jax(files):
    want, got = _device_pair(["--preset", "prot2dna", "-U", "--data",
                              "{pairs}", "--counts"], files)
    w, g = json.loads(want), json.loads(got)
    assert list(w) == list(g)
    np.testing.assert_allclose([g[k] for k in g], [w[k] for k in w],
                               rtol=RTOL, atol=ATOL)


def test_device_train_matches_host(files):
    """--train --engine device --device cpu fits what the host engine
    fits."""
    args = _fmt(["{casino}", "--constraints", "{casino_cons}", "--params",
                 "{casino_seed}", "--data", "{rolls}", "--train"], files)
    host = _run(t_cli.main, args)
    dev = _run(t_cli.main, args + ["--engine", "device", "--device", "cpu"])
    assert host[0] == dev[0] == 0
    h, d = json.loads(host[1]), json.loads(dev[1])
    assert list(h) == list(d)
    np.testing.assert_allclose([d[k] for k in d], [h[k] for k in h],
                               atol=1e-3)


@pytest.mark.parametrize("app", ["--loglike", "--viterbi", "--align",
                                 "--counts"])
def test_device_engine_without_a_card_does_not_fall_back(app, files):
    """The device engine runs on the card unless --device cpu is given:
    without CUDA the run ends through the CLI's error path, exit 1, with
    utils/device.py's message, and prints no score."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device exists")
    status, out, err = _run(t_cli.main, _fmt(
        ["--preset", "prot2dna", "-U", "--data", "{pairs}", app,
         "--engine", "device"], files))
    assert status == 1 and out == ""
    assert err.startswith("CUDA is not available; pass device='cpu'")
    status, out, err = _run(t_cli.main, _fmt(
        ["--preset", "prot2dna", "-U", "--data", "{pairs}", app,
         "--engine", "device", "--device", "meta"], files))
    assert status == 1 and out == "" and "unsupported device" in err


def test_module_entry_runs_as_a_subprocess():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["MB_NATIVE"] = "0"
    for module in ("machineboss_tpu_torch", "machineboss_tpu_torch.cli"):
        res = subprocess.run([sys.executable, "-m", module, "--preset",
                              "null"], cwd=ROOT, env=env,
                             capture_output=True, text=True, timeout=300)
        assert res.returncode == 0, res.stderr
        assert res.stdout == _run(_jax_main(), ["--preset", "null"])[1]


@pytest.mark.cuda
def test_cli_loglike_on_the_card_equals_log_forward_batch(tmp_path):
    """The CLI's prot2dna loglikes on 16 pairs print the strings a direct
    log_forward_batch call gives."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from machineboss_tpu_torch.core.presets import make_preset
    from machineboss_tpu_torch.dispatch import CompiledMachine
    from machineboss_tpu_torch.utils.jsonfmt import infinity_safe_string
    pairs = prot2dna_pairs(16, 32, seed=3)
    path = tmp_path / "pairs.json"
    path.write_text(_spl(pairs))
    status, out, err = _run(t_cli.main, ["--preset", "prot2dna", "-U",
                                         "--data", str(path), "--loglike",
                                         "--engine", "device"])
    assert status == 0, err
    m = make_preset("prot2dna")
    lls = CompiledMachine(m, m.get_param_defs(True)).log_forward_batch(pairs)
    printed = [row[2] for row in json.loads(out)]
    assert [json.loads(infinity_safe_string(float(v))) for v in lls] == \
        printed


def test_profiling_trace_if_writes_a_chrome_trace(tmp_path):
    """utils/profiling.trace_if writes a Chrome trace of the block's CPU
    activity into its directory, and is a no-op for a falsy one; timed
    reports the section's seconds."""
    from machineboss_tpu_torch.utils import profiling
    with profiling.trace_if(None):
        pass
    with profiling.trace_if(""):
        pass
    trace_dir = tmp_path / "trace"
    with profiling.trace_if(str(trace_dir)):
        torch.ones(64).cumsum(0)
    traces = sorted(trace_dir.glob("*.pt.trace.json"))
    assert len(traces) == 1
    events = json.loads(traces[0].read_text())["traceEvents"]
    assert any("cumsum" in e.get("name", "") for e in events)
    msgs = []
    with profiling.timed("section", msgs.append):
        pass
    assert len(msgs) == 1 and msgs[0].startswith("section: ")


def test_bound_parameters_leave_the_preset_cache_alone(tmp_path):
    """-P without inference binds the printed machine's parameters. The
    port's make_preset hands out copies, so a later make_preset in the
    process gets the preset unbound; the JAX CLI binds its cached machine
    in place (its cache entry is restored afterwards)."""
    from machineboss_tpu import cli as j_cli
    from machineboss_tpu.core import presets as j_presets
    from machineboss_tpu_torch.core import presets as t_presets
    params = tmp_path / "t.json"
    params.write_text(json.dumps({"t": 0.25}))
    argv = ["--preset", "jukescantor", "-P", str(params)]
    saved = j_presets._cache.pop("jukescantor", None)
    try:
        port = _run(t_cli.main, argv)
        assert port == _run(j_cli.main, argv)
        assert port[0] == 0 and '"t":0.25' in port[1].replace(" ", "")
        assert "t" not in t_presets.make_preset("jukescantor").funcs.defs
        assert j_presets.make_preset("jukescantor").funcs.defs["t"] == 0.25
    finally:
        if saved is None:
            j_presets._cache.pop("jukescantor", None)
        else:
            j_presets._cache["jukescantor"] = saved
