"""Seeded machines and pair batches for tests and chip_smoke.py.

Copies of the fixtures the JAX package's bench and tests build (the random
dense transducer, the dense 1D generator and the ragged length sampler of
bench.py, the all-class and indel transducers of
tests/test_pallas_kernel.py), the prot2dna pair sampler and a float64 1D
oracle, the mutated long pair of scripts/bench_align.py and the tie-free
machine of tests/test_device_align.py, so that the port's checks need
nothing outside this package.
"""

import json

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


def prot2dna_pairs(B, lengths, seed=0):
    """B (protein, DNA) string pairs: random proteins of the given
    lengths (an int or a length-B sequence) and their codon DNA."""
    rng = np.random.RandomState(seed)
    aas = sorted(CODONS)
    lens = np.broadcast_to(np.asarray(lengths), (B,))
    pairs = []
    for n in range(B):
        prot = "".join(aas[i] for i in rng.randint(0, len(aas), int(lens[n])))
        pairs.append((prot, "".join(CODONS[a] for a in prot)))
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
