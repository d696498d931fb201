"""Named preset machines (ref: src/preset.cpp + js/ generator scripts).

Most presets are generated programmatically through the machine algebra,
mirroring the reference's own build process (Makefile:200-235): pair-HMMs
from the PSW generator, codon translators from the codon-usage table, and
the GeneWise-style prot2dna/psw2dna machines by live composition. A few
hand-authored models (bintern, hamming codes, TKF91, Jukes-Cantor, ternary
DNA) ship as JSON data files.
"""

import copy
import json
import os
from functools import lru_cache

from .machine import Machine

_DATA = os.path.join(os.path.dirname(__file__), "..", "data")

DNA = "ACGT"
AA = "ACDEFGHIKLMNPQRSTVWY"

PRESET_NAMES = [
    "null", "compdna", "comprna", "dnapsw", "protpsw", "translate",
    "prot2dna", "psw2dna", "iupacdna", "iupacaa", "dna2rna", "rna2dna",
    "bintern", "terndna", "jukescantor", "dnapswnbr", "tkf91root",
    "tkf91branch", "tolower", "toupper", "hamming31", "hamming74",
]

_COMP_DNA = {"A": "T", "C": "G", "G": "C", "T": "A", "U": "A",
             "R": "Y", "Y": "R", "S": "S", "W": "W", "K": "M", "M": "K",
             "B": "V", "V": "B", "D": "H", "H": "D", "N": "N", "X": "X"}
_COMP_RNA = {"A": "U", "C": "G", "G": "C", "U": "A", "T": "A",
             "R": "Y", "Y": "R", "S": "S", "W": "W", "K": "M", "M": "K",
             "B": "V", "V": "B", "D": "H", "H": "D", "N": "N", "X": "X"}

_IUPAC_DNA = {"A": "A", "C": "C", "G": "G", "T": "T", "R": "AG", "Y": "CT",
              "S": "GC", "W": "AT", "K": "GT", "M": "AC", "B": "CGT",
              "D": "AGT", "H": "ACT", "V": "ACG", "N": "ACGT"}


def _comp_machine(name, table):
    trans = []
    for c, d in table.items():
        trans.append({"in": c, "out": d, "to": name})
        # lowercase complements follow the uppercase block
    for c, d in table.items():
        trans.append({"in": c.lower(), "out": d.lower(), "to": name})
    return {"state": [{"id": name, "trans": trans}]}


def _echo_table_machine(table, state_id=None):
    st = {"n": 0, "trans": [{"to": 0, "in": c, "out": d}
                            for c, d in table]}
    if state_id is not None:
        st = {"n": 0, "id": state_id, "trans": st["trans"]}
    return {"state": [st]}


def _not(p):
    return {"not": p}


def _not_sub(p):
    # the js generators write 1-p as {"-":[true,p]}
    return {"-": [True, p]}


def _times(*exprs):
    out = exprs[0]
    for e in exprs[1:]:
        out = {"*": [out, e]}
    return out


def _make_psw(alph, name, mix=None, irrev=False):
    """Affine-gap pair HMM generator (mirrors js/makepsw.js semantics)."""
    alph = list(alph)
    iota = [""] if mix is None else [str(k + 1) for k in range(int(mix))]
    gap = "ins" if irrev else "gap"
    gap_open = lambda k: gap + "Open" + k
    gap_extend = lambda k: gap + "Extend" + k
    dgap = "del" if irrev else "gap"
    del_open = lambda k: dgap + "Open" + k
    del_extend = lambda k: dgap + "Extend" + k
    not_ins_open = (("not" + gap.capitalize() + "Open") if mix
                    else _not(gap + "Open"))
    not_del_open = (("not" + dgap.capitalize() + "Open") if mix
                    else _not(dgap + "Open"))

    states = [{"id": name + "-S",
               "trans": [{"to": name + "-I" + k, "weight": gap_open(k)}
                         for k in iota]
               + [{"to": name + "-W", "weight": not_ins_open}]}]
    states += [{"id": name + "-J" + k,
                "trans": [{"to": name + "-I" + k, "weight": gap_extend(k)},
                          {"to": name + "-W", "weight": _not(gap_extend(k))}]}
               for k in iota]
    states += [{"id": name + "-W",
                "trans": [{"to": name + "-M", "weight": not_del_open}]
                + [{"to": name + "-D" + k, "weight": del_open(k)}
                   for k in iota]}]
    states += [{"id": name + "-X" + k,
                "trans": [{"to": name + "-D" + k, "weight": del_extend(k)},
                          {"to": name + "-M", "weight": _not(del_extend(k))}]}
               for k in iota]
    states += [{"id": name + "-I" + k,
                "trans": [{"out": c, "to": name + "-J" + k,
                           "weight": "eqm" + c} for c in alph]}
               for k in iota]
    states += [{"id": name + "-M",
                "trans": [{"to": name + "-E"}]
                + [{"in": c, "out": d, "to": name + "-S",
                    "weight": "sub" + c + d}
                   for c in alph for d in alph]}]
    states += [{"id": name + "-D" + k,
                "trans": [{"to": name + "-E"}]
                + [{"in": c, "to": name + "-X" + k} for c in alph]}
               for k in iota]
    states += [{"id": name + "-E"}]

    if mix:
        prob = [gap_extend(k) for k in iota]
        if irrev:
            prob += [del_extend(k) for k in iota]
    else:
        prob = (["insOpen", "insExtend", "delOpen", "delExtend"] if irrev
                else ["gapOpen", "gapExtend"])
    norm = [["eqm" + c for c in alph]]
    norm += [["sub" + c + d for d in alph] for c in alph]
    if mix:
        norm += [[gap_open(k) for k in iota] + [not_ins_open]]
        if irrev:
            norm += [[del_open(k) for k in iota] + [not_del_open]]
    return {"state": states, "cons": {"prob": prob, "norm": norm}}


@lru_cache(maxsize=None)
def _codon_table():
    aa2codons = {}
    codon2aa = {}
    codon_freq = {}
    codons = []
    with open(os.path.join(_DATA, "codon-usage.txt")) as f:
        for line in f:
            parts = line.split(" ")
            if len(parts) < 3:
                continue
            codon, aa, freq = parts[0], parts[1], parts[2]
            if len(codon) == 3 and len(aa) == 1 and aa != "*":
                codon = codon.upper()
                aa = aa.upper()
                aa2codons.setdefault(aa, []).append(codon)
                codon_freq[codon] = float(freq)
                codon2aa[codon] = aa
                codons.append(codon)
    return aa2codons, codon2aa, codon_freq, codons


def _translate(name="translate", echo=()):
    """Codon-to-amino-acid translator (mirrors js/translate.js)."""
    aa2codons, codon2aa, codon_freq, codons = _codon_table()
    cod23 = sorted({c[1:] for c in codons})
    cod3 = sorted({c[2:] for c in codons})

    def param(aa, codon):
        return aa + "_" + codon

    start = []
    for cod in codons:
        t = {"in": codon2aa[cod], "to": name + "-" + cod}
        if len(aa2codons[codon2aa[cod]]) > 1:
            t["weight"] = param(codon2aa[cod], cod)
        start.append(t)
    for tok in echo:
        start.append({"in": tok, "out": tok, "to": name + "-start"})
    start.append({"to": name + "-end"})

    states = [{"id": name + "-start", "trans": start}]
    states += [{"id": name + "-" + c,
                "trans": [{"out": c[0], "to": name + "-" + c[1:]}]}
               for c in sorted(codons)]
    states += [{"id": name + "-" + c,
                "trans": [{"out": c[0], "to": name + "-" + c[1:]}]}
               for c in cod23]
    states += [{"id": name + "-" + c,
                "trans": [{"out": c, "to": name + "-start"}]}
               for c in cod3]
    states += [{"id": name + "-end"}]
    norm = [[param(a, c) for c in aa2codons[a]] for a in sorted(aa2codons)]
    return {"state": states, "cons": {"norm": norm}}


def _pswint(psw_flag):
    """Protein-to-intron-annotated-codon machine (mirrors js/lib/pswint.js)."""
    alph = list(AA)
    name = "pswint"
    start_state = name + "-S" if psw_flag else name + "-M"

    def intron_states(prefix):
        p = name + "-" + prefix
        return [
            {"id": p + "-intron",
             "trans": [{"to": p + "-BB", "out": "intron", "weight": {"/": [1, 3]}},
                       {"to": p + "-IB", "out": "base", "weight": {"/": [1, 3]}},
                       {"to": p + "-BI", "out": "base", "weight": {"/": [1, 3]}}]},
            {"id": p + "-BB", "trans": [{"out": "base", "to": p + "-B"}]},
            {"id": p + "-B", "trans": [{"out": "base", "to": name + "-" + prefix}]},
            {"id": p + "-IB", "trans": [{"out": "intron", "to": p + "-B"}]},
            {"id": p + "-BI", "trans": [{"out": "base", "to": p + "-I"}]},
            {"id": p + "-I", "trans": [{"out": "intron", "to": name + "-" + prefix}]},
        ]

    cons = {"prob": ["intron"]}
    states = []
    if psw_flag:
        cons = {"prob": ["gapOpen", "gapExtend", "intron"],
                "norm": [["eqm" + c for c in alph]]
                + [["sub" + c + d for d in alph] for c in alph]}
        states += [
            {"id": name + "-S",
             "trans": [{"to": name + "-I", "weight": "gapOpen"},
                       {"to": name + "-W", "weight": _not_sub("gapOpen")}]},
            {"id": name + "-I",
             "trans": [{"out": c, "to": name + "-J",
                        "weight": _times(_not_sub("intron"), "eqm" + c)}
                       for c in alph]
             + [{"to": name + "-I-intron", "weight": "intron"}]},
            {"id": name + "-J",
             "trans": [{"to": name + "-I", "weight": "gapExtend"},
                       {"to": name + "-W", "weight": _not_sub("gapExtend")}]},
            {"id": name + "-W",
             "trans": [{"to": name + "-M", "weight": _not_sub("gapOpen")},
                       {"to": name + "-D", "weight": "gapOpen"}]},
        ]
    m_trans = [{"to": name + "-E"}]
    for c in alph:
        if psw_flag:
            m_trans += [{"in": c, "out": d, "to": start_state,
                         "weight": _times(_not_sub("intron"), "sub" + c + d)}
                        for d in alph]
        else:
            m_trans += [{"in": c, "out": c, "to": start_state,
                         "weight": _not_sub("intron")}]
        m_trans.append({"in": c, "to": name + "-M-intron", "weight": "intron"})
    states += [{"id": name + "-M", "trans": m_trans}]
    if psw_flag:
        states += [
            {"id": name + "-D",
             "trans": [{"to": name + "-E"}]
             + [{"in": c, "to": name + "-X"} for c in alph]},
            {"id": name + "-X",
             "trans": [{"to": name + "-D", "weight": "gapExtend"},
                       {"to": name + "-M", "weight": _not_sub("gapExtend")}]},
        ]
    states += intron_states("M")
    if psw_flag:
        states += intron_states("I")
    states += [{"id": name + "-E"}]
    return {"state": states, "cons": cons}


def _simple_introns():
    prot = list(DNA)
    return {"state": [
        {"id": "si-S",
         "trans": [{"in": c, "out": c, "to": "si-S"} for c in prot]
         + [{"in": "base", "out": "base", "to": "si-S"},
            {"in": "intron", "out": "G", "to": "si-donor"},
            {"to": "si-E"}]},
        {"id": "si-donor", "trans": [{"out": "T", "to": "si-intron"}]},
        {"id": "si-intron",
         "trans": [{"out": "base", "to": "si-intron", "weight": "extendIntron"},
                   {"out": "A", "to": "si-acceptor",
                    "weight": _not_sub("extendIntron")}]},
        {"id": "si-acceptor", "trans": [{"out": "G", "to": "si-S"}]},
        {"id": "si-E"}],
        "cons": {"prob": ["extendIntron"]}}


def _flankbase():
    return {"state": [
        {"id": "flank-start",
         "trans": [{"to": "flank-emit", "weight": "flankExtend"},
                   {"to": "flank-end", "weight": _not_sub("flankExtend")}]},
        {"id": "flank-emit", "trans": [{"out": "base", "to": "flank-start"}]},
        {"id": "flank-end"}],
        "cons": {"prob": ["flankExtend"]}}


def _base2acgt():
    return {"state": [
        {"id": "bases",
         "trans": [{"in": c, "out": c, "to": "bases"} for c in DNA]
         + [{"in": "base", "out": c, "to": "bases", "weight": "p" + c}
            for c in DNA]}],
        "cons": {"norm": [["p" + c for c in DNA]]}}


def _iupacdna():
    trans = []
    for c, ds in _IUPAC_DNA.items():
        for d in ds:
            trans.append({"to": 0, "in": c, "out": d})
    return {"state": [{"n": 0, "trans": trans}]}


def _iupacaa():
    aa = list(AA)
    return {"state": [{"n": 0,
                       "trans": [{"to": 0, "in": c, "out": c} for c in aa]
                       + [{"to": 0, "in": "X", "out": c} for c in aa]}]}


def _case_machine(to_upper):
    trans = []
    for cc in range(32, 127):
        in_c = chr(cc)
        if to_upper:
            out_c = chr(cc - 32) if ord("a") <= cc <= ord("z") else in_c
        else:
            out_c = chr(cc + 32) if ord("A") <= cc <= ord("Z") else in_c
        trans.append({"to": 0, "in": in_c, "out": out_c})
    return {"state": [{"n": 0, "trans": trans}]}


def _dna2(alph=DNA, name="dna2"):
    """Dinucleotide-context pair HMM (mirrors js/dna2.js)."""
    alph = list(alph)

    def mat(l, r):
        return "mat" + l + r

    def ins(l, r):
        return "ins" + l + r

    def dele(l, r):
        return "del" + l + r

    eqm = lambda i: "eqm" + i
    sub = lambda i, j, l, r: "pSub" + i + j + "_" + l + r
    ins_open = lambda l, r: "pInsOpen_" + l + r
    ins_ext = lambda l, r: "pInsExt_" + l + r
    ins_char = lambda i, l, r: "pInsChar" + i + "_" + l + r
    del_open = lambda l, r: "pDelOpen_" + l + r
    del_char = lambda j, l, r: "pDelChar" + j + "_" + l + r
    ins_open_char = lambda i, l, r: _times(ins_open(l, r), ins_char(i, l, r))
    ins_ext_char = lambda i, l, r: _times(ins_ext(l, r), ins_char(i, l, r))
    del_open_char = lambda j, l, r: _times(del_open(l, r), del_char(j, l, r))
    del_ext_char = del_char

    start = {"id": "start", "trans": []}
    states = [start]
    norms, probs = [], []
    for l in alph:
        for r in alph:
            start["trans"].append({"to": mat(l, r), "weight": eqm(l)})
            mat_trans = [{"to": "end", "weight": eqm(r)}]
            ins_trans = [{"to": "end", "weight": _times(_not_sub(ins_ext(l, r)),
                                                        eqm(r))}]
            del_trans = [{"to": "end", "weight": eqm(r)}]
            for c in alph:
                for d in alph:
                    mat_trans.append({"to": mat(r, c), "in": r, "out": d,
                                      "weight": _times(
                                          _not_sub(del_open_char(r, l, c)),
                                          _not_sub(ins_open(l, r)),
                                          sub(r, d, l, c))})
                    ins_trans.append({"to": mat(r, c), "in": r, "out": d,
                                      "weight": _times(
                                          _not_sub(ins_ext(l, r)),
                                          sub(r, d, l, c))})
                    del_trans.append({"to": mat(r, c), "in": r, "out": d,
                                      "weight": _times(
                                          _not_sub(del_ext_char(r, l, c)),
                                          _not_sub(ins_open(l, r)),
                                          sub(r, d, l, c))})
                mat_trans.append({"to": dele(r, c), "in": r,
                                  "weight": del_open_char(r, l, c)})
                mat_trans.append({"to": ins(l, r), "out": c,
                                  "weight": _times(
                                      _not_sub(del_open_char(r, l, c)),
                                      ins_open_char(c, l, r))})
                ins_trans.append({"to": ins(l, r), "out": c,
                                  "weight": ins_ext_char(c, l, r)})
                del_trans.append({"to": dele(r, c), "in": r,
                                  "weight": del_ext_char(r, l, c)})
                del_trans.append({"to": ins(l, r), "out": c,
                                  "weight": _times(
                                      _not_sub(del_ext_char(r, l, c)),
                                      ins_open_char(c, l, r))})
            states += [{"id": mat(l, r), "trans": mat_trans},
                       {"id": ins(l, r), "trans": ins_trans},
                       {"id": dele(l, r), "trans": del_trans}]
            for c in alph:
                norms.append([sub(c, d, l, r) for d in alph])
            norms.append([ins_char(c, l, r) for c in alph])
            probs += [ins_open(l, r), ins_ext(l, r), del_open(l, r)]
            probs += [del_char(c, l, r) for c in alph]
    states.append({"id": "end"})
    norms.append([eqm(c) for c in alph])
    return {"state": states, "cons": {"norm": norms, "prob": probs}}


# --------------------------------------------------------------------------
# dna2.js quirk: mat/ins/del transitions reference states matXY for context
# pairs; note the js pushes three states per (l,r) but transitions reference
# states from other (l,r) pairs -- all states exist after the full loop.


def _load_data(name):
    with open(os.path.join(_DATA, "presets", name + ".json")) as f:
        return json.load(f)


def _genewise(inner_name):
    """Compose the GeneWise-style protein-to-DNA machine
    (mirrors Makefile:228-232): flankbase . (inner => translate-spliced
    => simple_introns) . flankbase => base2acgt."""
    flank = _machine("flankbase")
    inner = _machine(inner_name)
    ts = Machine.from_json(_translate(echo=("base", "intron")))
    si = Machine.from_json(_simple_introns())
    group = Machine.compose(Machine.compose(inner, ts), si)
    m = Machine.concatenate(flank, group)
    m = Machine.concatenate(m, _machine("flankbase"))
    return Machine.compose(m, _machine("base2acgt"))


_BUILDERS = {
    "null": lambda: {"state": [{"n": 0}]},
    "compdna": lambda: _comp_machine("CompDNA", _COMP_DNA),
    "comprna": lambda: _comp_machine("CompRNA", _COMP_RNA),
    "dnapsw": lambda: _make_psw(DNA, "dnapsw"),
    "protpsw": lambda: _make_psw(AA, "protpsw"),
    "dnapsw_mix2": lambda: _make_psw(DNA, "dnapsw_mix2", mix=2),
    "translate": lambda: _translate(),
    "iupacdna": _iupacdna,
    "iupacaa": _iupacaa,
    "dna2rna": lambda: _echo_table_machine(
        [("A", "A"), ("C", "C"), ("G", "G"), ("T", "U")], "DNA_to_RNA"),
    "rna2dna": lambda: _echo_table_machine(
        [("A", "A"), ("C", "C"), ("G", "G"), ("U", "T")], "RNA_to_DNA"),
    "tolower": lambda: _case_machine(False),
    "toupper": lambda: _case_machine(True),
    "dnapswnbr": _dna2,
    "flankbase": _flankbase,
    "base2acgt": _base2acgt,
    "pint": lambda: _pswint(False),
    "pswint": lambda: _pswint(True),
    "simple_introns": _simple_introns,
    "translate-spliced": lambda: _translate(echo=("base", "intron")),
}

_DATA_PRESETS = {"bintern", "terndna", "jukescantor", "tkf91root",
                 "tkf91branch", "hamming31", "hamming74"}

_cache = {}


def _machine(name):
    if name in _cache:
        return _cache[name]
    if name == "prot2dna":
        m = _genewise("pint")
    elif name == "psw2dna":
        m = _genewise("pswint")
    elif name in _DATA_PRESETS:
        m = Machine.from_json(_load_data(name))
    elif name in _BUILDERS:
        m = Machine.from_json(_BUILDERS[name]())
    else:
        raise ValueError("Unknown preset: %s" % name)
    _cache[name] = m
    return m


def make_preset(name):
    """A fresh copy of the named preset: the cached machine stays as it
    was built, whatever a caller assigns on the copy (the command line's
    -P sets its funcs)."""
    return copy.deepcopy(_machine(name))


def preset_names():
    return list(PRESET_NAMES)
