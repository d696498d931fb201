"""Sequence-length padding buckets (counterpart of machineboss_tpu's
ops/fwdback.py; only `pad_bucket` is ported so far, the CountModel E-step
and the batch tokenizer are still to come)."""


def pad_bucket(n, ratio=1.5, base=8):
    """Geometric padding bucket (ref seq.py pad_length semantics: lengths
    rounded up to powers of `ratio` to bound recompilation on ragged
    batches)."""
    b = base
    while b < n:
        b = int(b * ratio) + 1
    return b
