"""Model families built on the machine algebra + device DP engines.

Each module is a ready-to-use family mirroring a reference workload
(BASELINE.json / tutorial / examples):

  - casino: occasionally-dishonest-casino HMM (tutorial/casino*.json)
  - pairhmm: dnapsw/protpsw/prot2dna/psw2dna pairwise aligners
  - profile: HMMER Plan7, CSV/PSWM, jumping-profile HMMs
  - ctc: CTC basecaller (merging machine + prefix decode + EM)
  - tkf91: TKF91 statistical alignment (root/branch/pair)
"""

from . import casino, ctc, pairhmm, profile, tkf91  # noqa: F401

__all__ = ["casino", "ctc", "pairhmm", "profile", "tkf91"]
