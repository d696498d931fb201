"""The port's kernel factories take the JAX factories' keywords.

The JAX factories carry knobs of the TPU layout (matrix-unit precision,
VMEM chunks, Pallas interpret mode, the bf16 hi/lo split, the 1D unroll,
the token-scale product). bench.py passes some of them; the port's
factories accept each with the JAX default and ignore it, so a call with
bench.py's keywords gives the same scores, bit for bit, as one without.
"""

import numpy as np
import pytest
import torch

from machineboss_tpu_torch import testmachines
from machineboss_tpu_torch.core.eval import EvaluatedMachine
from machineboss_tpu_torch.core.presets import make_preset
from machineboss_tpu_torch.ops.kernels import lowrank_kernel as lk
from machineboss_tpu_torch.ops.kernels import scan1d_kernel as sk
from machineboss_tpu_torch.ops.kernels import viterbi_kernel as vk
from machineboss_tpu_torch.ops.kernels import wavefront_kernel as wk
from machineboss_tpu_torch.ops.lowering import LoweredMachine


def _mats(machine, semiring="logsumexp"):
    ev = EvaluatedMachine(machine, machine.get_param_defs(True))
    return tuple(np.asarray(x) for x in LoweredMachine(
        ev, dtype=np.float32).matrices_2d(semiring))


def _batch(mats, B, Li, Lo, seed):
    rng = np.random.RandomState(seed)
    it = rng.randint(0, mats[1].shape[0], (B, Li)).astype(np.int32)
    ot = rng.randint(0, mats[2].shape[0], (B, Lo)).astype(np.int32)
    il = rng.randint(1, Li + 1, B).astype(np.int32)
    ol = rng.randint(1, Lo + 1, B).astype(np.int32)
    il[0], ol[0] = Li, Lo
    return it, ot, il, ol


# bench.py:553-557 and :589-597 (n_chunks, split, merged, variant, chain,
# n_abs_hint), plus the JAX factory's precision and interpret
FORWARD = {
    "merged": {"merged": True},
    "generic": {"merged": False},
    "chained_ragged": {"variant": "chained_ragged", "chain": 4,
                       "n_abs_hint": 64},
    "chained": {"variant": "chained", "chain": 2},
    "lowrank": {"variant": "lowrank"},
    "lowrank_chained": {"variant": "lowrank", "chain": 2},
}
TPU_KW = {"precision": "highest", "n_chunks": 2, "interpret": True,
          "split": False}


@pytest.mark.parametrize("kind", list(FORWARD))
def test_wavefront_factory_takes_bench_keywords(kind):
    machine = make_preset("prot2dna") if kind.startswith("lowrank") \
        else testmachines.build_random_transducer(6, list("ACGT"), seed=3)
    mats = _mats(machine)
    B, Li, Lo = 4, 5, 7
    batch = _batch(mats, B, Li, Lo, seed=len(kind))
    base = wk.make_wavefront_forward(*mats, B, Li, Lo, device="cpu",
                                     **FORWARD[kind])(*batch)
    got = wk.make_wavefront_forward(*mats, B, Li, Lo, device="cpu",
                                    **FORWARD[kind], **TPU_KW)(*batch)
    assert torch.isfinite(base).any()
    assert torch.equal(got, base)


def test_lowrank_factory_takes_the_jax_keywords():
    mats = _mats(make_preset("prot2dna"))
    batch = _batch(mats, 3, 4, 12, seed=2)
    base = lk.make_lowrank_forward(*mats, 3, 4, 12, device="cpu")(*batch)
    got = lk.make_lowrank_forward(*mats, 3, 4, 12, "highest", 2, True, False,
                                  sc_fma=False, device="cpu")(*batch)
    assert torch.equal(got, base)


def test_viterbi_factories_take_interpret():
    mats = _mats(testmachines.build_random_transducer(6, list("ACGT"),
                                                      seed=3), "maxplus")
    it, ot, _, _ = _batch(mats, 3, 6, 6, seed=5)
    base = vk.make_wavefront_viterbi(*mats, 3, 6, 6, device="cpu")(it, ot)
    got = vk.make_wavefront_viterbi(*mats, 3, 6, 6, n_chunks=2,
                                    interpret=True, device="cpu")(it, ot)
    assert torch.equal(got, base)
    lo, hi = np.zeros(13, int), np.full(13, 7)
    band = vk.make_wavefront_viterbi_banded(*mats, 6, 6, lo, hi,
                                            device="cpu")
    band_i = vk.make_wavefront_viterbi_banded(*mats, 6, 6, lo, hi,
                                              interpret=True, device="cpu")
    assert np.array_equal(band_i(it[0], ot[0]), band(it[0], ot[0]))


def test_1d_factory_has_the_jax_name_and_keywords():
    m = testmachines.build_generator_1d(6, seed=1)
    ev = EvaluatedMachine(m, m.get_param_defs(True))
    trans, closure = (np.asarray(x) for x in LoweredMachine(
        ev, dtype=np.float32).emit_matrices_1d(output_side=True))
    rng = np.random.RandomState(1)
    toks = rng.randint(0, trans.shape[0], (4, 20)).astype(np.int32)
    lens = np.array([20, 7, 13, 0], np.int32)
    base = sk.make_forward_1d_kernel(trans, closure, 4, 20,
                                     device="cpu")(toks, lens)
    # bench.py:272-275
    got = sk.make_forward_1d_pallas(trans, closure, 4, 20, unroll=8,
                                    renorm_every=4, split=None,
                                    interpret=True, device="cpu")(toks, lens)
    assert sk.make_forward_1d_pallas is sk.make_forward_1d_kernel
    assert np.array_equal(got, base)
