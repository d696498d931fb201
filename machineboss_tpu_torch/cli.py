"""boss-compatible command-line interface.

A stack-based expression language over machines (ref: target/boss.cpp):
construction options push machines, postfix operators transform the top of
stack, infix operators combine, and adjacent machines reduce by composition.
Application options run inference (train/align/loglike/counts/encode/decode)
through the host or device DP engines (--device: cuda, the default, or cpu).
"""

import json
import math
import sys

import numpy as np

from .core import weight as W
from .core.machine import Machine, SUM_SILENT_CYCLES, BREAK_SILENT_CYCLES, \
    LEAVE_SILENT_CYCLES, MachinePath
from .core.params import Params, Constraints, param_assign_from_json, \
    param_funcs_from_json
from .core.seqpair import SeqPair, SeqPairList, NamedSeq
from .core.eval import EvaluatedMachine
from .core.exprparse import parse_weight_expr
from .core.fastseq import read_fast_seqs, split_to_chars
from .core.presets import make_preset, preset_names
from .core.hmmer import HmmerModel
from .core.jphmm import jphmm
from .core.csvprof import CSVProfile
from .core.regex import RegexParser, DNA_ALPHABET, RNA_ALPHABET, AA_ALPHABET
from .algo.dp_host import ForwardMatrix, ViterbiMatrix, RollingForward
from .algo.counts import MachineCounts
from .algo.fitter import MachineFitter
from .algo.beam import BeamSearchMatrix, DEFAULT_BEAM_WIDTH
from .algo.ctc import PrefixTree
from .utils.jsonfmt import infinity_safe_string, write_escaped

NEG_INF = -math.inf

_ALIASES = {
    "<<": "--generate-chars", ">>": "--recognize-chars", "=>": "--compose",
    ".": "--concatenate", "&&": "--intersect", "||": "--union",
    "?": "--zero-or-one", "*": "--kleene-star", "+": "--kleene-plus",
    "?+": "--loop", "#": "--weight", "~": "--revcomp",
    "(": "--begin", ")": "--end",
    "--recip": "--reciprocal", "--concat": "--concatenate", "--or": "--union",
}

_SHORT_OPTS = {
    "-h": "--help", "-v": "--verbose", "-d": "--debug", "-b": "--monochrome",
    "-l": "--load", "-p": "--preset", "-g": "--generate-chars",
    "-a": "--recognize-chars", "-w": "--weight", "-X": "--regex",
    "-H": "--hmmer", "-J": "--jphmm",
    "-z": "--zero-or-one", "-k": "--kleene-star", "-K": "--kleene-plus",
    "-e": "--reverse", "-r": "--revcomp", "-t": "--transpose",
    "-n": "--eliminate",
    "-m": "--compose", "-c": "--concatenate", "-i": "--intersect",
    "-u": "--union", "-o": "--loop", "-f": "--flank",
    "-B": "--begin", "-E": "--end",
    "-S": "--save", "-G": "--graphviz", "-U": "--use-defaults",
    "-P": "--params", "-F": "--functions", "-N": "--constraints",
    "-D": "--data", "-I": "--input-fasta", "-O": "--output-fasta",
    "-T": "--train", "-R": "--wiggle-room", "-A": "--align",
    "-V": "--viterbi", "-L": "--loglike", "-C": "--counts",
    "-Z": "--beam-decode", "-Y": "--beam-encode",
}

_PRESET_ALPH = {"dna": DNA_ALPHABET, "rna": RNA_ALPHABET, "aa": AA_ALPHABET}

# options (with value arity) handled by the application phase, not the
# machine-construction stack language
_APP_OPTS_VAL = {
    "--verbose", "--debug", "--save", "--params", "--functions",
    "--constraints", "--data", "--input-fasta", "--input-json",
    "--input-chars", "--output-fasta", "--output-json", "--output-chars",
    "--wiggle-room", "--beam-width", "--prefix-backtrack", "--decode-steps",
    "--seed", "--codegen", "--inseq", "--outseq", "--engine",
    "--device",
}
_APP_OPTS_FLAG = {
    "--help", "--monochrome", "--graphviz", "--dot-no-merge", "--dot-show-io",
    "--stats", "--evaluate", "--define-exprs", "--show-params",
    "--use-defaults", "--name-states", "--train", "--align", "--viterbi",
    "--loglike", "--counts", "--beam-decode", "--prefix-decode",
    "--viterbi-decode", "--cool-decode", "--mcmc-decode", "--beam-encode",
    "--prefix-encode", "--viterbi-encode", "--random-encode",
    "--cpp64", "--cpp32", "--js", "--wgsl", "--showcells", "--compileviterbi",
}


class CLIError(Exception):
    pass


def _load_json(path):
    with open(path) as f:
        return json.load(f)


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    try:
        return _run(argv)
    except Exception as e:  # mirror reference: message to stderr, exit 1
        sys.stderr.write(str(e) + "\n")
        return 1


def _run(argv):
    # ------------------------------------------------- split app vs machine args
    vm = {}
    machine_args = []
    i = 0
    while i < len(argv):
        arg = argv[i]
        canon = _SHORT_OPTS.get(arg, arg)
        if canon in _APP_OPTS_VAL:
            i += 1
            if i >= len(argv):
                raise CLIError("Missing argument for " + arg)
            if canon in ("--params", "--functions", "--constraints", "--data",
                         "--debug"):
                vm.setdefault(canon, []).append(argv[i])
            else:
                vm[canon] = argv[i]
        elif canon in _APP_OPTS_FLAG:
            vm[canon] = True
        else:
            machine_args.append(arg)
        i += 1

    if "--help" in vm:
        sys.stdout.write(_usage())
        return 0

    rng_seed = int(vm["--seed"]) if "--seed" in vm else None
    rng = np.random.RandomState(rng_seed)

    if vm.get("--engine") == "fused":
        return _run_fused(machine_args, vm)

    machine = _build_machine(machine_args)
    if machine is None:
        sys.stdout.write(_usage())
        sys.stdout.write("Please specify a transducer\n")
        return 1

    # ------------------------------------------------------ params/constraints
    seed = Params()
    for path in vm.get("--params", []):
        seed = seed.combine(param_assign_from_json(_load_json(path)), True)
    funcs = Params()
    for path in vm.get("--functions", []):
        funcs = funcs.combine(param_funcs_from_json(_load_json(path)), True)
    constraints = Constraints()
    for path in vm.get("--constraints", []):
        constraints = constraints.combine(
            Constraints.from_json(_load_json(path)))

    params_specified = ("--params" in vm or "--functions" in vm)
    encoding = any(k in vm for k in ("--prefix-encode", "--beam-encode",
                                     "--viterbi-encode", "--random-encode"))
    decoding = any(k in vm for k in ("--prefix-decode", "--cool-decode",
                                     "--viterbi-decode", "--mcmc-decode",
                                     "--beam-decode"))
    dp_requested = any(k in vm for k in ("--train", "--loglike", "--viterbi",
                                         "--align", "--counts"))
    inference = dp_requested or encoding or decoding
    eval_requested = "--evaluate" in vm
    if params_specified and (eval_requested or not inference):
        machine.funcs = machine.funcs.combine(funcs, True).combine(seed, True)
        machine.cons = machine.cons.combine(constraints)

    if eval_requested:
        ev = EvaluatedMachine(
            machine, machine.get_param_defs("--use-defaults" in vm))
        machine = ev.explicit_machine()
        funcs = Params()
        seed = Params()
        constraints = Constraints()

    stats_requested = "--stats" in vm
    if stats_requested:
        sys.stdout.write(
            "%d states, %d transitions (%d IO-conditioned), %d parameters\n"
            % (machine.n_states(), machine.n_transitions(),
               machine.n_conditioned_transitions(), len(machine.params())))

    def show_machine(f):
        if "--graphviz" in vm:
            f.write(machine.to_dot_str(
                merge_edges="--dot-no-merge" not in vm,
                abbreviate_labels="--dot-show-io" not in vm))
        else:
            f.write(machine.to_json_str(
                memoize_repeated="--define-exprs" in vm,
                show_params="--show-params" in vm,
                use_state_ids="--name-states" in vm))

    if "--save" in vm:
        with open(vm["--save"], "w") as f:
            show_machine(f)
    elif not inference and not stats_requested and "--codegen" not in vm:
        show_machine(sys.stdout)

    if "--codegen" in vm:
        from .codegen import run_codegen
        run_codegen(machine, vm)

    # ----------------------------------------------------------------- data
    data = SeqPairList()
    for path in vm.get("--data", []):
        for sp in SeqPairList.from_json(_load_json(path)).seq_pairs:
            data.seq_pairs.append(sp)

    in_seqs = []
    out_seqs = []
    if "--input-fasta" in vm:
        for fs in read_fast_seqs(vm["--input-fasta"]):
            in_seqs.append(NamedSeq(fs.name, split_to_chars(fs.seq)))
    if "--output-fasta" in vm:
        for fs in read_fast_seqs(vm["--output-fasta"]):
            out_seqs.append(NamedSeq(fs.name, split_to_chars(fs.seq)))
    if "--input-chars" in vm:
        s = vm["--input-chars"]
        in_seqs.append(NamedSeq(s, split_to_chars(s)))
    if "--output-chars" in vm:
        s = vm["--output-chars"]
        out_seqs.append(NamedSeq(s, split_to_chars(s)))
    if "--input-json" in vm:
        in_seqs.append(NamedSeq.from_json(_load_json(vm["--input-json"])))
    if "--output-json" in vm:
        out_seqs.append(NamedSeq.from_json(_load_json(vm["--output-json"])))

    input_empty = machine.input_empty()
    output_empty = machine.output_empty()
    if not in_seqs and ((input_empty and ((output_empty and inference)
                                          or out_seqs))
                        or encoding or decoding):
        in_seqs.append(NamedSeq())
    if not out_seqs and ((in_seqs and output_empty) or encoding):
        out_seqs.append(NamedSeq())
    for i_seq in in_seqs:
        for o_seq in out_seqs:
            data.seq_pairs.append(SeqPair(
                NamedSeq(i_seq.name, i_seq.seq),
                NamedSeq(o_seq.name, o_seq.seq)))

    no_io = machine.input_empty() and machine.output_empty()
    if inference and not data.seq_pairs and no_io:
        data.seq_pairs.append(SeqPair())
    got_data = bool(data.seq_pairs)
    if got_data and not inference:
        raise CLIError("No point in specifying input/output data without"
                       " --train, --loglike, --counts, --align, --*-encode,"
                       " or --*-decode")

    # ------------------------------------------------------------------ train
    if "--train" in vm:
        if not ((("--constraints" in vm) or not machine.cons.empty())
                and (got_data or no_io)):
            raise CLIError("To fit parameters, please specify a constraints"
                           " file and (for machines with input/output) a data"
                           " file")
        fitter = MachineFitter(machine=machine,
                               engine=vm.get("--engine", "host"),
                               device=vm.get("--device"))
        if "--constraints" in vm:
            fitter.constraints = constraints
        fitter.constants = funcs
        fitter.seed = fitter.all_constraints().default_params() \
                            .combine(seed, True)
        if "--wiggle-room" in vm:
            params = fitter.fit(data, width=int(vm["--wiggle-room"]))
        else:
            params = fitter.fit(data)
        sys.stdout.write(params.to_json_str() + "\n")
    else:
        params = funcs.combine(seed).combine(
            machine.get_param_defs("--use-defaults" in vm))

    # ---------------------------------------------------------------- loglike
    if "--loglike" in vm:
        ev = EvaluatedMachine(machine, params)
        device_lls = None
        if vm.get("--engine") == "device":
            from .dispatch import CompiledMachine
            cm = CompiledMachine(machine, params, device=vm.get("--device"))
            scorable = [sp for sp in data.seq_pairs if ev.can_tokenize(sp)]
            lls = cm.log_forward_batch(
                [("".join(sp.input.seq), "".join(sp.output.seq))
                 for sp in scorable]) if scorable else []
            device_lls = {id(sp): float(v)
                          for sp, v in zip(scorable, lls)}
        out = ["["]
        for n, sp in enumerate(data.seq_pairs):
            ll = NEG_INF
            if device_lls is not None:
                ll = device_lls.get(id(sp), NEG_INF)
            elif ev.can_tokenize(sp):
                ll = RollingForward(ev, sp).log_like()
            out.append((",\n " if n else "")
                       + '["%s","%s",%s]' % (write_escaped(sp.input.name),
                                             write_escaped(sp.output.name),
                                             infinity_safe_string(ll)))
        out.append("]\n")
        sys.stdout.write("".join(out))

    # ----------------------------------------------------------------- counts
    if "--counts" in vm:
        ev = EvaluatedMachine(machine, params)
        if vm.get("--engine") == "device":
            from .parallel.em import device_counts
            counts = device_counts(machine, params, data,
                                   device=vm.get("--device"))
        else:
            counts = MachineCounts(ev, data)
        sys.stdout.write(counts.param_counts_json_str(machine, params) + "\n")

    # ----------------------------------------------------------- align/viterbi
    if "--align" in vm or "--viterbi" in vm:
        if not got_data:
            raise CLIError("To align sequences, please specify a data file")
        ev = EvaluatedMachine(machine, params)
        use_device = vm.get("--engine") == "device"
        wiggle = int(vm["--wiggle-room"]) if "--wiggle-room" in vm else None

        def _env_for(sp):
            from .core.seqpair import Envelope
            return Envelope(sp, wiggle) if wiggle is not None else None

        device_mats = {}
        if use_device:
            from .algo.viterbi_device import device_viterbi_matrices
            scorable = [sp for sp in data.seq_pairs if ev.can_tokenize(sp)]
            if scorable:
                envs = ([_env_for(sp) for sp in scorable]
                        if wiggle is not None else None)
                filled = device_viterbi_matrices(ev, scorable,
                                                 envelopes=envs,
                                                 device=vm.get("--device"))
                device_mats = {id(sp): vm_ for sp, vm_ in zip(scorable,
                                                              filled)}
        vit_out = ["["]
        align_results = SeqPairList()
        for n, sp in enumerate(data.seq_pairs):
            vit_ll = NEG_INF
            if ev.can_tokenize(sp):
                vit = device_mats[id(sp)] if use_device \
                    else ViterbiMatrix(ev, sp, env=_env_for(sp))
                vit_ll = vit.log_like()
                if vit_ll > NEG_INF:
                    path = vit.path(machine)
                    align_results.seq_pairs.append(SeqPair.from_path(
                        path, machine, sp.input.name, sp.output.name))
            vit_out.append((",\n " if n else "")
                           + '["%s","%s",%s]'
                           % (write_escaped(sp.input.name),
                              write_escaped(sp.output.name),
                              infinity_safe_string(vit_ll)))
        vit_out.append("]\n")
        if "--viterbi" in vm:
            sys.stdout.write("".join(vit_out))
        if "--align" in vm:
            sys.stdout.write(align_results.to_json_str() + "\n")

    max_backtrack = (int(vm["--prefix-backtrack"])
                     if "--prefix-backtrack" in vm else None)

    # ----------------------------------------------------------------- encode
    if encoding:
        if not got_data:
            raise CLIError("To encode an output sequence, please specify an"
                           " input sequence file")
        trans = machine.transpose().advance_sort().advancing_machine()
        decode_trans = (trans.decode_sort()
                        if ("--beam-encode" in vm or "--viterbi-encode" in vm)
                        else trans)
        silent_trans = (decode_trans.silence_input()
                        if "--viterbi-encode" in vm else decode_trans)
        ev = EvaluatedMachine(silent_trans, params)
        results = SeqPairList()
        for sp in data.seq_pairs:
            if sp.output.seq:
                raise CLIError("You cannot specify output sequences when"
                               " encoding; the goal of encoding is to"
                               " generate %s output for a given input"
                               % ("random" if "--random-encode" in vm
                                  else "the most likely"))
            if "--beam-encode" in vm:
                bw = int(vm.get("--beam-width", DEFAULT_BEAM_WIDTH))
                beam = BeamSearchMatrix(ev, sp.input.seq, bw)
                encoded = beam.best_seq()
            elif "--viterbi-encode" in vm:
                tsp = sp.transpose()
                vit = ViterbiMatrix(ev, tsp)
                path = vit.path(silent_trans)
                encoded = EvaluatedMachine.decode(path, decode_trans, params)
            else:
                tree = PrefixTree(ev, list(sp.input.seq), max_backtrack)
                if "--random-encode" in vm:
                    encoded = tree.sample_seq(rng)
                else:
                    encoded = tree.do_prefix_search()
            results.seq_pairs.append(SeqPair(
                NamedSeq(sp.input.name, sp.input.seq),
                NamedSeq("output", encoded)))
        sys.stdout.write(results.to_json_str() + "\n")

    # ----------------------------------------------------------------- decode
    if decoding:
        if not got_data:
            raise CLIError("To decode an input sequence, please specify an"
                           " output sequence file")
        decode_trans = (machine.decode_sort() if "--beam-decode" in vm
                        else machine)
        silent_trans = (decode_trans.silence_input()
                        if "--viterbi-decode" in vm else decode_trans)
        ev = EvaluatedMachine(silent_trans, params)
        results = SeqPairList()
        for sp in data.seq_pairs:
            if sp.input.seq:
                raise CLIError("You cannot specify input sequences when"
                               " decoding; the goal of decoding is to impute"
                               " the most likely input for a given output")
            if "--beam-decode" in vm:
                bw = int(vm.get("--beam-width", DEFAULT_BEAM_WIDTH))
                beam = BeamSearchMatrix(ev, sp.output.seq, bw)
                decoded = beam.best_seq()
            elif "--viterbi-decode" in vm:
                vit = ViterbiMatrix(ev, sp)
                path = vit.path(silent_trans)
                decoded = EvaluatedMachine.decode(path, decode_trans, params)
            else:
                tree = PrefixTree(ev, sp.output.seq, max_backtrack)
                if "--cool-decode" in vm or "--mcmc-decode" in vm:
                    steps = int(vm.get("--decode-steps", 10))
                    decoded = tree.do_annealed_search(
                        rng, steps, "--cool-decode" in vm)
                else:
                    decoded = tree.do_prefix_search()
            results.seq_pairs.append(SeqPair(
                NamedSeq("input", decoded),
                NamedSeq(sp.output.name, sp.output.seq)))
        sys.stdout.write(results.to_json_str() + "\n")

    return 0


# ---------------------------------------------------------------------------
# machine-construction stack language


def _build_machine(args, fused_pair=False):
    """Build the machine stack. With fused_pair=True (--engine fused) the
    FINAL top-level composition is left unreduced and the (generator,
    transducer) pair is returned instead — the fused engines score/align
    without ever materializing the composition."""
    from collections import deque
    args = deque(args)
    machines = []

    def reduce_machines():
        m = machines.pop()
        while machines:
            m = Machine.compose(machines.pop(), m, True, True,
                                SUM_SILENT_CYCLES)
        return m

    def next_machine_for_command(last_command):
        if not args:
            raise CLIError("Missing argument for " + last_command
                           if last_command else "Missing command")
        arg = args.popleft()

        def get_arg():
            if not args:
                raise CLIError("Missing argument for " + arg)
            return args.popleft()

        def pop_machine():
            if not machines or last_command:
                raise CLIError("Missing machine for " + arg)
            return machines.pop()

        def next_machine():
            return next_machine_for_command(arg)

        def revcomp_machine(r):
            out_alph = set(r.output_alphabet())
            preset = make_preset("comprna" if ("U" in out_alph
                                              or "u" in out_alph)
                                 else "compdna")
            return Machine.compose(r.reverse(), preset, True, True,
                                   SUM_SILENT_CYCLES)

        # --generate-one-dna style alphabet shorthands
        import re as _re
        m_alph = _re.match(
            r"^--(generate|recognize|echo)-(one|wild|iid|uniform)-(dna|rna|aa)$",
            arg)
        if m_alph:
            args.appendleft(_PRESET_ALPH[m_alph.group(3)])
            arg = "--%s-%s" % (m_alph.group(1), m_alph.group(2))

        if arg in _ALIASES:
            arg = _ALIASES[arg]
        command = _SHORT_OPTS.get(arg, arg)

        if not command.startswith("-"):
            m = Machine.from_file(command)
        elif command == "--load":
            m = Machine.from_file(get_arg())
        elif command == "--preset":
            m = make_preset(get_arg())
        elif command == "--generate-json":
            seq = NamedSeq.from_json(_load_json(get_arg()))
            m = Machine.generator(seq.seq, seq.name)
        elif command == "--generate-fasta":
            seqs = read_fast_seqs(get_arg())
            if len(seqs) != 1:
                raise CLIError("--generate-fasta file must contain exactly"
                               " one FASTA-format sequence")
            m = Machine.generator(split_to_chars(seqs[0].seq), seqs[0].name)
        elif command == "--generate-chars":
            seq = get_arg()
            m = Machine.generator(split_to_chars(seq), seq)
        elif command == "--generate-wild":
            m = Machine.wild_generator(split_to_chars(get_arg()))
        elif command == "--generate-iid":
            m = Machine.wild_generator(split_to_chars(get_arg())) \
                       .weight_outputs()
        elif command == "--generate-uniform":
            m = Machine.wild_generator(split_to_chars(get_arg())) \
                       .weight_outputs(W.UNIFORM_PRIOR_MACRO)
        elif command == "--generate-one":
            m = Machine.wild_single_generator(split_to_chars(get_arg()))
        elif command == "--recognize-json":
            seq = NamedSeq.from_json(_load_json(get_arg()))
            m = Machine.recognizer(seq.seq, seq.name)
        elif command == "--recognize-fasta":
            seqs = read_fast_seqs(get_arg())
            if len(seqs) != 1:
                raise CLIError("--recognize-fasta file must contain exactly"
                               " one FASTA-format sequence")
            m = Machine.recognizer(split_to_chars(seqs[0].seq), seqs[0].name)
        elif command == "--recognize-chars":
            seq = get_arg()
            m = Machine.recognizer(split_to_chars(seq), seq)
        elif command == "--recognize-wild":
            m = Machine.wild_recognizer(split_to_chars(get_arg()))
        elif command == "--recognize-iid":
            m = Machine.wild_recognizer(split_to_chars(get_arg())) \
                       .weight_inputs()
        elif command == "--recognize-uniform":
            m = Machine.wild_recognizer(split_to_chars(get_arg())) \
                       .weight_inputs(W.UNIFORM_PRIOR_MACRO)
        elif command == "--recognize-one":
            m = Machine.wild_single_recognizer(split_to_chars(get_arg()))
        elif command == "--echo-wild":
            m = Machine.wild_echo(split_to_chars(get_arg()))
        elif command == "--echo-uniform":
            m = Machine.wild_echo(split_to_chars(get_arg())) \
                       .weight_inputs(W.UNIFORM_PRIOR_MACRO)
        elif command == "--echo-one":
            m = Machine.wild_single_echo(split_to_chars(get_arg()))
        elif command == "--echo-chars":
            seq = get_arg()
            m = Machine.echo(split_to_chars(seq), seq)
        elif command == "--echo-fasta":
            seqs = read_fast_seqs(get_arg())
            if len(seqs) != 1:
                raise CLIError("--echo-fasta file must contain exactly one"
                               " FASTA-format sequence")
            m = Machine.echo(split_to_chars(seqs[0].seq), seqs[0].name)
        elif command == "--echo-json":
            seq = NamedSeq.from_json(_load_json(get_arg()))
            m = Machine.echo(seq.seq, seq.name)
        elif command == "--sort":
            m = pop_machine().advance_sort().advancing_machine()
        elif command == "--sort-fast":
            m = pop_machine().advance_sort().drop_silent_back_transitions()
        elif command == "--sort-cyclic":
            m = pop_machine().advance_sort()
        elif command == "--joint-norm":
            m = pop_machine().normalize_jointly()
        elif command == "--cond-norm":
            m = pop_machine().normalize_conditionally()
        elif command == "--decode-sort":
            m = pop_machine().decode_sort()
        elif command == "--encode-sort":
            m = pop_machine().encode_sort()
        elif command == "--full-sort":
            m = pop_machine().toposort()
        elif command == "--compose":
            m = Machine.compose(pop_machine(), next_machine(), True, True,
                                SUM_SILENT_CYCLES)
        elif command == "--compose-fast":
            m = Machine.compose(pop_machine(), next_machine(), True, True,
                                BREAK_SILENT_CYCLES)
        elif command == "--compose-cyclic":
            m = Machine.compose(pop_machine(), next_machine(), True, True,
                                LEAVE_SILENT_CYCLES)
        elif command == "--flank":
            central = pop_machine()
            flanking = next_machine()
            m = Machine.concatenate(
                Machine.concatenate(flanking, central), flanking)
        elif command == "--concatenate":
            m = Machine.concatenate(pop_machine(), next_machine())
        elif command == "--intersect":
            m = Machine.intersect(pop_machine(), next_machine(),
                                  SUM_SILENT_CYCLES)
        elif command == "--intersect-fast":
            m = Machine.intersect(pop_machine(), next_machine(),
                                  BREAK_SILENT_CYCLES)
        elif command == "--intersect-cyclic":
            m = Machine.intersect(pop_machine(), next_machine(),
                                  LEAVE_SILENT_CYCLES)
        elif command == "--union":
            m = Machine.take_union(pop_machine(), next_machine())
        elif command == "--zero-or-one":
            m = Machine.zero_or_one(pop_machine()).advance_sort()
        elif command == "--kleene-star":
            m = Machine.kleene_star(pop_machine()).advance_sort()
        elif command == "--kleene-plus":
            m = Machine.kleene_plus(pop_machine()).advance_sort()
        elif command == "--count-copies":
            m = Machine.kleene_count(pop_machine(), get_arg()).advance_sort()
        elif command == "--repeat":
            n_reps = int(get_arg())
            if n_reps <= 0:
                raise CLIError("--repeat requires minimum one repetition")
            m = Machine.repeat(pop_machine(), n_reps)
        elif command == "--loop":
            m = Machine.kleene_loop(pop_machine(), next_machine()) \
                       .advance_sort()
        elif command == "--eliminate":
            m = pop_machine().eliminate_silent_transitions()
        elif command == "--eliminate-states":
            m = pop_machine().eliminate_redundant_states()
        elif command == "--merge-states":
            m = pop_machine().merge_equivalent_states()
        elif command == "--strip-names":
            m = pop_machine().strip_names()
        elif command == "--pad":
            m = pop_machine().pad_with_null_states()
        elif command == "--reverse":
            m = pop_machine().reverse()
        elif command == "--revcomp":
            m = revcomp_machine(pop_machine())
        elif command == "--double-strand":
            half = W.reciprocal(W.int_constant(2))
            r = pop_machine()
            m = Machine.take_union(r, revcomp_machine(r), half, half)
        elif command == "--transpose":
            m = pop_machine().transpose()
        elif command in ("--downsample-size", "--downsample-prob",
                         "--downsample-path", "--downsample-frac"):
            from .algo.downsample import downsample_cli
            m = downsample_cli(pop_machine(), command, get_arg())
        elif command in ("--flank-input-wild", "--flank-output-wild",
                         "--flank-either-wild", "--flank-both-wild",
                         "--flank-input-geom", "--flank-output-geom"):
            core = pop_machine()
            if command == "--flank-input-wild":
                flank = Machine.wild_recognizer(core.input_alphabet())
            elif command == "--flank-output-wild":
                flank = Machine.wild_generator(core.output_alphabet())
            elif command == "--flank-either-wild":
                flank = Machine.take_union(
                    Machine.wild_recognizer(core.input_alphabet()),
                    Machine.wild_generator(core.output_alphabet()))
            elif command == "--flank-both-wild":
                flank = Machine.concatenate(
                    Machine.wild_recognizer(core.input_alphabet()),
                    Machine.wild_generator(core.output_alphabet()))
            elif command == "--flank-input-geom":
                flank = Machine.wild_recognizer(core.input_alphabet()) \
                    .weight_inputs(W.UNIFORM_PRIOR_MACRO) \
                    .weight_inputs_geometrically(get_arg())
            else:
                flank = Machine.wild_generator(core.output_alphabet()) \
                    .weight_outputs(W.UNIFORM_PRIOR_MACRO) \
                    .weight_outputs_geometrically(get_arg())
            return Machine.concatenate(flank,
                                       Machine.concatenate(core, flank))
        elif command == "--weight":
            m = Machine.single_transition(parse_weight_expr(get_arg()))
        elif command == "--weight-input":
            m = pop_machine().weight_inputs(get_arg())
        elif command == "--weight-output":
            m = pop_machine().weight_outputs(get_arg())
        elif command == "--weight-input-geom":
            m = pop_machine().weight_inputs_geometrically(get_arg())
        elif command == "--weight-output-geom":
            m = pop_machine().weight_outputs_geometrically(get_arg())
        elif command == "--reciprocal":
            m = pop_machine().pointwise_reciprocal()
        elif command == "--begin":
            pushed = machines[:]
            machines.clear()
            while True:
                if not args:
                    raise CLIError("Unmatched '" + arg + "'")
                nxt = args[0]
                if nxt in ("--end", "-E", ")"):
                    break
                push_next_machine()
            args.popleft()  # consume the end token
            if not machines:
                raise CLIError("Empty '" + arg + "' ... ')'")
            m = reduce_machines()
            machines.clear()
            machines.extend(pushed)
        elif command == "--end":
            raise CLIError("Unmatched '" + arg + "'")
        elif command == "--regex":
            m = RegexParser().parse(get_arg())
        elif command == "--dna-regex":
            m = RegexParser(white="", nonwhite=DNA_ALPHABET).parse(get_arg())
        elif command == "--rna-regex":
            m = RegexParser(white="", nonwhite=RNA_ALPHABET).parse(get_arg())
        elif command == "--aa-regex":
            m = RegexParser(white="", nonwhite=AA_ALPHABET).parse(get_arg())
        elif command == "--silence-input":
            m = pop_machine().silence_input()
        elif command == "--silence-output":
            m = pop_machine().silence_output()
        elif command == "--copy-input-to-output":
            m = pop_machine().project_input_to_output()
        elif command == "--copy-output-to-input":
            m = pop_machine().project_output_to_input()
        elif command == "--hmmer":
            m = HmmerModel.from_file(get_arg()).machine(True)
        elif command == "--hmmer-global":
            m = HmmerModel.from_file(get_arg()).machine(False)
        elif command == "--hmmer-plan7":
            m = HmmerModel.from_file(get_arg()).plan7_machine(False)
        elif command == "--hmmer-multihit":
            m = HmmerModel.from_file(get_arg()).plan7_machine(True)
        elif command == "--jphmm":
            m = jphmm(read_fast_seqs(get_arg()))
        elif command == "--generate-csv":
            m = CSVProfile.from_file(get_arg()).machine()
        elif command == "--recognize-csv":
            m = CSVProfile.from_file(get_arg()).machine().transpose()
        elif command == "--recognize-merge-csv":
            m = CSVProfile.from_file(get_arg()).merging_machine().transpose()
        else:
            raise CLIError("Unknown option: " + arg)
        return m

    def push_next_machine():
        machines.append(next_machine_for_command(""))
        if len(machines) > 1:
            if fused_pair and len(machines) == 2 and not args:
                return                       # keep the final pair unreduced
            machines.append(reduce_machines())

    while args:
        push_next_machine()

    if not machines:
        return None
    if fused_pair:
        if len(machines) != 2:
            raise CLIError("--engine fused requires a two-machine stack"
                           " (generator transducer)")
        return machines[0], machines[1]
    return reduce_machines()




def _run_fused(machine_args, vm):
    """--engine fused: Viterbi scores and alignments of reads against a
    generator (x) transducer stack WITHOUT materializing the composition
    (algo/fused_align.py — the composed state space is never built, which
    is the point for large profiles). Supports --viterbi and --align with
    the usual --data/--output-* inputs and --params/--functions files;
    alignment path metadata uses the implicit product machine's state ids
    (the same [gen, td] pair names compose() would assign — see
    FusedAlignment.path_json_str)."""
    from .algo.fused_align import FusedViterbiAligner

    for k in ("--train", "--counts", "--codegen", "--save", "--evaluate",
              "--loglike"):
        if k in vm:
            raise CLIError("--engine fused does not support " + k +
                           " (use --engine device for Forward paths)")
    if not ("--viterbi" in vm or "--align" in vm):
        raise CLIError("--engine fused requires --viterbi or --align")

    pair = _build_machine(machine_args, fused_pair=True)
    if pair is None:
        sys.stdout.write(_usage())
        sys.stdout.write("Please specify a transducer\n")
        return 1
    gen, td = pair
    if gen.input_alphabet():
        raise CLIError("--engine fused requires the left machine to be a"
                       " generator (empty input alphabet)")

    seed = Params()
    for path in vm.get("--params", []):
        seed = seed.combine(param_assign_from_json(_load_json(path)), True)
    funcs = Params()
    for path in vm.get("--functions", []):
        funcs = funcs.combine(param_funcs_from_json(_load_json(path)), True)
    user = funcs.combine(seed)
    use_defaults = "--use-defaults" in vm
    gp = user.combine(gen.get_param_defs(use_defaults))
    tp = user.combine(td.get_param_defs(use_defaults))

    reads = []                              # (input_name, NamedSeq)
    for path in vm.get("--data", []):
        for sp in SeqPairList.from_json(_load_json(path)).seq_pairs:
            if sp.input.seq:
                raise CLIError("--engine fused scores output-only data"
                               " (the generator side has no input)")
            reads.append((sp.input.name,
                          NamedSeq(sp.output.name, sp.output.seq)))
    if "--output-fasta" in vm:
        for fs in read_fast_seqs(vm["--output-fasta"]):
            reads.append(("", NamedSeq(fs.name, split_to_chars(fs.seq))))
    if "--output-chars" in vm:
        s = vm["--output-chars"]
        reads.append(("", NamedSeq(s, split_to_chars(s))))
    if "--output-json" in vm:
        reads.append(("", NamedSeq.from_json(
            _load_json(vm["--output-json"]))))
    if not reads:
        raise CLIError("To align sequences, please specify a data file")

    aligner = FusedViterbiAligner(gen, td, gen_params=gp, td_params=tp)
    vit_out = ["["]
    align_out = []
    for n, (in_name, ns) in enumerate(reads):
        ll = NEG_INF
        try:
            a = aligner.align(ns.seq)
            ll = a.score
        except (ValueError, KeyError):
            a = None
        if a is not None and "--align" in vm:
            sp = SeqPair(NamedSeq(in_name, []), NamedSeq(ns.name, ns.seq),
                         a.alignment_columns(),
                         {"path": json.loads(a.path_json_str())})
            align_out.append(sp)
        vit_out.append((",\n " if n else "")
                       + '["%s","%s",%s]'
                       % (write_escaped(in_name), write_escaped(ns.name),
                          infinity_safe_string(ll)))
    vit_out.append("]\n")
    if "--viterbi" in vm:
        sys.stdout.write("".join(vit_out))
    if "--align" in vm:
        spl = SeqPairList()
        spl.seq_pairs = align_out
        sys.stdout.write(spl.to_json_str() + "\n")
    return 0

def _usage():
    return ("Usage: python -m machineboss_tpu_torch"
            " [construction|application options...]\n"
            "Presets: " + ", ".join(preset_names()) + "\n"
            "See README for the full option list (boss-compatible CLI).\n")


if __name__ == "__main__":
    sys.exit(main())
