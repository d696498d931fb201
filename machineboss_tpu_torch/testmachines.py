"""Seeded machines and pair batches for tests and chip_smoke.py.

Copies of the fixtures the JAX package's bench and tests build (the random
dense transducer, the dense 1D generator and the ragged length sampler of
bench.py, the all-class and indel transducers of
tests/test_pallas_kernel.py), the prot2dna pair sampler and a float64 1D
oracle, the mutated long pair of scripts/bench_align.py, the tie-free
machine of tests/test_device_align.py and a bitnoise-shaped channel, so
that the port's checks need nothing outside this package.
"""

import json
import os

import numpy as np

from .core.machine import Machine
from .core.seqpair import NamedSeq, SeqPair

# standard genetic code (for sampling plausible DNA against prot2dna)
CODONS = {
    "A": "GCT", "C": "TGT", "D": "GAT", "E": "GAA", "F": "TTT",
    "G": "GGT", "H": "CAT", "I": "ATT", "K": "AAA", "L": "CTG",
    "M": "ATG", "N": "AAT", "P": "CCG", "Q": "CAA", "R": "CGT",
    "S": "TCT", "T": "ACT", "V": "GTG", "W": "TGG", "Y": "TAT",
}


def build_random_transducer(n_states, alphabet, seed=42):
    """Random dense transducer in the reference benchmark's shape."""
    rng = np.random.RandomState(seed)
    states = []
    for s in range(n_states + 1):
        if s == n_states:
            states.append({"id": "End", "trans": []})
            continue
        trans = []
        for in_sym in alphabet:
            for out_sym in alphabet:
                dest = int(rng.randint(0, n_states - 1))
                w = round(float(rng.uniform(0.1, 1.0)), 4)
                trans.append({"in": in_sym, "out": out_sym, "to": dest,
                              "weight": w})
        trans.append({"to": n_states,
                      "weight": round(float(rng.uniform(0.01, 0.1)), 4)})
        states.append({"id": "S%d" % s, "trans": trans})
    return Machine.from_json({"state": states})


def build_allclass_transducer(n_states, alphabet, seed=9):
    """Machine with all three transition classes (in+out, in-only,
    out-only)."""
    m = build_random_transducer(n_states, alphabet, seed=seed)
    js = json.loads(m.to_json_str())
    for s in js["state"][:-1]:
        s["trans"].append({"in": alphabet[0], "to": 0, "weight": 0.11})
        s["trans"].append({"out": alphabet[-1], "to": 1, "weight": 0.13})
    return Machine.from_json(js)


def build_indel_transducer(n_states, alphabet, seed=13):
    """Transducer with ONLY input-consuming and output-emitting transitions
    (no in+out "diag" class)."""
    rng = np.random.RandomState(seed)
    states = []
    for s in range(n_states + 1):
        if s == n_states:
            states.append({"id": "End", "trans": []})
            continue
        trans = []
        for sym in alphabet:
            trans.append({"in": sym, "to": int(rng.randint(0, n_states)),
                          "weight": round(float(rng.uniform(0.1, 0.5)), 4)})
            trans.append({"out": sym, "to": int(rng.randint(0, n_states)),
                          "weight": round(float(rng.uniform(0.1, 0.5)), 4)})
        trans.append({"to": n_states,
                      "weight": round(float(rng.uniform(0.01, 0.1)), 4)})
        states.append({"id": "S%d" % s, "trans": trans})
    return Machine.from_json({"state": states})


def build_generator_1d(n_states, alphabet="ACGT", seed=42, rng=None):
    """Random dense generator (output side only) in the shape of the
    reference grid's largest 1D config: one transition per symbol from
    every state, and a 0.05 exit to End. Draws from `rng` when given, so a
    caller can go on drawing tokens from the same stream."""
    if rng is None:
        rng = np.random.RandomState(seed)
    S = n_states
    states = []
    for s in range(S):
        trans = [{"out": c, "to": int(rng.randint(0, S - 1)),
                  "weight": round(float(rng.uniform(0.1, 1.0)), 4)}
                 for c in alphabet for _ in range(1)]
        trans.append({"to": S, "weight": 0.05})
        states.append({"id": "S%d" % s, "trans": trans})
    states.append({"id": "End", "trans": []})
    return Machine.from_json({"state": states})


def ragged_lens(rng, B, L):
    """Realistic read-batch raggedness: uniform in [L/2, L]."""
    return rng.randint(max(L // 2, 1), L + 1, B).astype(np.int32)


def forward_1d_f64(trans, closure, toks, lens):
    """Float64 oracle of the batched 1D Forward: trans (n_tok, S, S) and
    closure (S, S) log-space as lowering.emit_matrices_1d returns them,
    toks (B, L) 0-based (a negative token is a skipped position), lens
    (B,). Probability space with a per-step renormalisation whose logs are
    summed; returns (B,) log-likelihoods read at state S-1 (-1e30 for a
    sequence without mass)."""
    t64 = np.asarray(trans, np.float64)
    c64 = np.asarray(closure, np.float64)
    em = np.where(t64 > -1e29, np.exp(np.minimum(t64, 700.0)), 0.0)
    toks = np.asarray(toks)
    lens = np.asarray(lens)
    B, L = toks.shape
    S = c64.shape[0]
    p = np.tile(np.where(c64[0] > -1e29, np.exp(c64[0]), 0.0), (B, 1))
    scale = np.zeros(B)
    for d in range(min(int(lens.max()), L) if B else 0):
        tok = toks[:, d]
        keep = (d < lens) & (tok >= 0)
        known = (tok >= 0) & (tok < em.shape[0])
        cur = np.einsum("bs,bsd->bd", p,
                        em[np.clip(tok, 0, max(em.shape[0] - 1, 0))])
        cur[~known] = 0.0
        m = cur.max(axis=1)
        ok = m > 0
        cur[ok] /= m[ok, None]
        inc = np.where(ok, np.log(np.where(ok, m, 1.0)), 0.0)
        p = np.where(keep[:, None], cur, p)
        scale = np.where(keep, scale + inc, scale)
    end = p[:, S - 1]
    with np.errstate(divide="ignore"):
        return np.where(end > 0, np.log(np.maximum(end, 1e-300)) + scale,
                        -1e30)


def _synonymous_codons():
    """{amino acid: its sense codons, sorted}, from the codon-usage table
    the prot2dna preset is built from."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                        "codon-usage.txt")
    table = {}
    with open(path) as f:
        for line in f:
            codon, aa = line.split()[:2]
            if aa != "*":
                table.setdefault(aa, []).append(codon)
    return {aa: sorted(c) for aa, c in table.items()}


def prot2dna_pairs(B, lengths, seed=0, synonymous=False, flank=0):
    """B (protein, DNA) string pairs: random proteins of the given
    lengths (an int or a length-B sequence) and their codon DNA, each
    amino acid's codon fixed (CODONS) or, with synonymous=True, drawn
    uniformly from its synonymous codons, so that the pairs carry codon
    usage for an EM fit to learn. flank > 0 puts 0 to `flank` random
    bases on each side of the coding DNA, as genomic DNA around a gene
    has, for the preset's flank states to model."""
    rng = np.random.RandomState(seed)
    aas = sorted(CODONS)
    syn = _synonymous_codons() if synonymous else None
    lens = np.broadcast_to(np.asarray(lengths), (B,))
    pairs = []
    for n in range(B):
        prot = "".join(aas[i] for i in rng.randint(0, len(aas), int(lens[n])))
        if syn is None:
            dna = "".join(CODONS[a] for a in prot)
        else:
            dna = "".join(syn[a][rng.randint(0, len(syn[a]))] for a in prot)
        if flank:
            left, right = ("".join("ACGT"[c] for c in rng.randint(
                0, 4, rng.randint(0, flank + 1))) for _ in range(2))
            dna = left + dna + right
        pairs.append((prot, dna))
    return pairs


def align_pair(L, mutate=0.1, seed=11, alphabet="ACGT"):
    """One SeqPair for alignment runs: a random sequence of L symbols, a
    copy with a fraction `mutate` of its positions redrawn, and the
    column-by-column alignment of the two, from which
    Envelope(pair, width) cuts its band."""
    rng = np.random.RandomState(seed)
    n_sym = len(alphabet)
    xs = [alphabet[c] for c in rng.randint(0, n_sym, L)]
    ys = list(xs)
    for k in rng.choice(L, int(L * mutate), replace=False):
        ys[k] = alphabet[rng.randint(0, n_sym)]
    return SeqPair(NamedSeq("x", xs), NamedSeq("y", ys), list(zip(xs, ys)))


def build_tiefree_machine():
    """A one-state pair machine over ACG whose weights make the optimal
    alignment of its test pair unique: float32 fill noise cannot flip an
    exact tie."""
    return Machine.from_json({"state": [
        {"id": "s", "trans": [
            {"in": "A", "out": "A", "to": "s", "weight": 0.47},
            {"in": "A", "out": "C", "to": "s", "weight": 0.09},
            {"in": "C", "out": "C", "to": "s", "weight": 0.39},
            {"in": "C", "out": "A", "to": "s", "weight": 0.11},
            {"in": "G", "out": "G", "to": "s", "weight": 0.3},
            {"in": "A", "to": "s", "weight": 0.05},
            {"in": "C", "to": "s", "weight": 0.03},
            {"in": "G", "to": "s", "weight": 0.04},
            {"out": "A", "to": "s", "weight": 0.02},
            {"to": "e", "weight": 0.1}]},
        {"id": "e", "trans": []}]})


def tiefree_pair():
    """The pair aligned by build_tiefree_machine in the JAX package's CLI
    test: the deleted symbol (G) appears exactly once."""
    cols = [("A", "A"), ("C", "C"), ("A", "A"), ("G", ""), ("C", "C"),
            ("C", "C")]
    return SeqPair(NamedSeq("x", list("ACAGCC")), NamedSeq("y", list("ACACC")),
                   cols)


def bitnoise_json():
    """A binary noisy channel of the shape of boss's t/machine/bitnoise.json
    with no silent transition: a start state S and an end state E, each
    copying a bit with weight p and flipping it with weight q into E, and
    E also deleting or inserting a bit with weight r. Scored by the neural
    DP, whose silent closure it never reaches."""
    def moves(dest):
        out = []
        for a in "01":
            for b in "01":
                out.append({"in": a, "out": b, "to": dest,
                            "weight": "p" if a == b else "q"})
        return out
    indels = [{"in": a, "to": "E", "weight": "r"} for a in "01"] + \
        [{"out": b, "to": "E", "weight": "r"} for b in "01"]
    return {"state": [{"id": "S", "trans": moves("E")},
                      {"id": "E", "trans": moves("E") + indels}]}


# ------------------------------------------------ fused Plan7 read scoring

AMINO = list("ACDEFGHIKLMNPQRSTVWY")       # HMMER's amino-acid order

# the 3-node DNA profile and the noise transducer of the JAX package's
# tests/test_fused_plan7.py (also tests/golden/fused/toy.hmm, noise_td.json);
# HMMER3 stores -ln(p), '*' = impossible
TOY_HMM_TEXT = """\
HMMER3/f [3.1b2 | February 2015]
NAME  toy
LENG  3
ALPH  DNA
HMM          A        C        G        T
            m->m     m->i     m->d     i->m     i->i     d->m     d->d
  COMPO   1.38629  1.38629  1.38629  1.38629
          1.38629  1.38629  1.38629  1.38629
          0.10536  2.35388  2.99573  0.61519  0.77653  0.00000  *
      1   0.22314  2.30259  2.99573  2.99573      1 a - - -
          1.38629  1.38629  1.38629  1.38629
          0.16252  2.30259  2.99573  0.51083  0.91629  0.35667  1.20397
      2   2.99573  0.35667  2.30259  1.89712      2 c - - -
          1.09861  1.60944  1.60944  1.38629
          0.22314  1.89712  2.99573  0.40048  1.10866  0.30111  1.35667
      3   2.30259  2.99573  0.28768  1.89712      3 g - - -
          1.38629  1.38629  1.38629  1.38629
          0.01005  4.60517  *        0.45676  1.00239  0.00000  *
//
"""

TOY_TD_JSON = {"state": [
    {"id": "loop", "trans": [
        {"in": "A", "out": "A", "to": "loop", "weight": 0.5},
        {"in": "A", "out": "C", "to": "loop", "weight": 0.1},
        {"in": "C", "out": "C", "to": "loop", "weight": 0.5},
        {"in": "C", "out": "G", "to": "loop", "weight": 0.1},
        {"in": "G", "out": "G", "to": "loop", "weight": 0.5},
        {"in": "G", "out": "T", "to": "loop", "weight": 0.1},
        {"in": "T", "out": "T", "to": "loop", "weight": 0.5},
        {"in": "T", "out": "A", "to": "loop", "weight": 0.1},
        {"in": "A", "to": "loop", "weight": 0.08},
        {"in": "C", "to": "loop", "weight": 0.08},
        {"in": "G", "to": "loop", "weight": 0.06},
        {"in": "T", "to": "loop", "weight": 0.06},
        {"out": "A", "to": "loop", "weight": 0.03},
        {"out": "G", "to": "loop", "weight": 0.02},
        {"to": "end", "weight": 0.12}]},
    {"id": "end", "trans": []}]}


def random_plan7_hmm_text(K, alph, seed=0):
    """HMMER3 text of a seeded random profile of K nodes over `alph`, to be
    parsed by core.hmmer.HmmerModel.read: per node a Dirichlet match and
    insert emission row, seven transition probabilities normalised per
    source state (m->m/i/d, i->m/i, d->m/d; the last node has no m->d and
    no d->d), a COMPO line, the node-0 insert and begin lines. Scores are
    -ln p with 5 decimals; '*' is probability zero."""
    rng = np.random.RandomState(seed)
    A = len(alph)

    def scores(p):
        return "  ".join("*" if x <= 0 else "%.5f" % (0.0 - np.log(x)) for x in p)

    def transitions(last):
        m = rng.dirichlet([20.0, 1.0, 1.0])
        i = rng.dirichlet([2.0, 1.0])
        d = rng.dirichlet([2.0, 1.0])
        if last:
            m = np.array([m[0] / (m[0] + m[1]), m[1] / (m[0] + m[1]), 0.0])
            d = np.array([1.0, 0.0])
        return np.concatenate([m, i, d])

    lines = ["HMMER3/f [3.1b2 | February 2015]", "NAME  random%d" % K,
             "LENG  %d" % K, "ALPH  %s" % ("amino" if A == 20 else "DNA"),
             "HMM          " + "        ".join(alph),
             "            m->m     m->i     m->d     i->m     i->i     "
             "d->m     d->d",
             "  COMPO   " + scores(rng.dirichlet(np.full(A, 5.0))),
             "          " + scores(rng.dirichlet(np.full(A, 5.0))),
             "          " + scores(transitions(False))]
    for k in range(K):
        match = rng.dirichlet(np.full(A, 0.3))
        lines.append("%7d   %s  %6d %s - - -"
                     % (k + 1, scores(match), k + 1,
                        alph[int(np.argmax(match))].lower()))
        lines.append("          " + scores(rng.dirichlet(np.full(A, 5.0))))
        lines.append("          " + scores(transitions(k == K - 1)))
    lines.append("//")
    return "\n".join(lines) + "\n"


def fn3_shaped_hmm_text(seed=0):
    """A seeded random profile of the shape of Pfam's fn3 (86 nodes over
    the 20 amino acids), standing in for the fn3.hmm file."""
    return random_plan7_hmm_text(86, AMINO, seed)


def noise_transducer_json(alph, n_states=2):
    """The two-state noisy identity transducer of bench.py's plan7
    workload: per symbol a copy (0.03) and a silent absorption (0.005), one
    spontaneous emission of alph[0] (0.01), and the exit (0.28).

    n_states > 2 gives a ring of n_states - 1 such noise states before the
    end (a copy moves to the ring's next state, state i emits alph[i] and
    its weights are scaled by 1 + i / 4); n_states = 1 is the lone noise
    state, which is also the end."""
    m = max(n_states - 1, 1)
    names = ["loop"] if m == 1 else ["loop%d" % i for i in range(m)]
    states = []
    for i, name in enumerate(names):
        w = 1.0 + i / 4.0
        trans = []
        for a in alph:
            trans.append({"in": a, "out": a, "to": names[(i + 1) % m],
                          "weight": 0.03 * w})
            trans.append({"in": a, "to": name, "weight": 0.005 * w})
        trans.append({"out": alph[i], "to": name, "weight": 0.01 * w})
        if n_states > 1:
            trans.append({"to": "end", "weight": 0.28 * w})
        states.append({"id": name, "trans": trans})
    if n_states > 1:
        states.append({"id": "end", "trans": []})
    return {"state": states}


def plan7_reads(alph, B, Lr, seed=0):
    """B uniform random reads of length Lr over `alph`, as bench.py's
    plan7 workload draws them."""
    rng = np.random.RandomState(seed)
    return ["".join(alph[i] for i in rng.randint(0, len(alph), Lr))
            for _ in range(B)]
