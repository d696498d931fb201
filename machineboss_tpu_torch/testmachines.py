"""Seeded machines and pair batches for tests and chip_smoke.py.

Copies of the fixtures the JAX package's bench and tests build (the random
dense transducer of bench.py, the all-class transducer of
tests/test_pallas_kernel.py) and the prot2dna pair sampler, so that the
port's checks need nothing outside this package.
"""

import json

import numpy as np

from .core.machine import Machine

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
