"""FASTA/FASTQ sequence I/O (ref: src/fastseq.{h,cpp}, htslib kseq).

Pure-Python reader handling FASTA ('>') and FASTQ ('@') records, gzip
transparently, multi-line sequences, and quality strings.
"""

import gzip


class FastSeq:
    __slots__ = ("name", "comment", "seq", "qual")

    def __init__(self, name="", comment="", seq="", qual=""):
        self.name = name
        self.comment = comment
        self.seq = seq
        self.qual = qual

    @classmethod
    def from_seq(cls, seq, name=""):
        return cls(name=name, seq=seq)

    def length(self):
        return len(self.seq)

    def to_fasta(self, width=0):
        header = ">" + self.name + ((" " + self.comment) if self.comment else "")
        if width and width > 0:
            body = "\n".join(self.seq[i:i + width]
                             for i in range(0, len(self.seq), width))
        else:
            body = self.seq
        return header + "\n" + body + "\n"


def _open_maybe_gzip(path):
    with open(path, "rb") as probe:
        magic = probe.read(2)
    if magic == b"\x1f\x8b":
        return gzip.open(path, "rt")
    return open(path, "r")


def read_fast_seqs(path):
    """Read all FASTA/FASTQ records from a file."""
    seqs = []
    with _open_maybe_gzip(path) as f:
        lines = iter(f.read().splitlines())
    cur = None
    fastq_mode = False
    pending_qual = False
    for line in lines:
        if not line:
            continue
        if pending_qual:
            cur.qual += line
            if len(cur.qual) >= len(cur.seq):
                pending_qual = False
            continue
        if line[0] in ">@":
            fastq_mode = line[0] == "@"
            fields = line[1:].split(None, 1)
            cur = FastSeq(name=fields[0] if fields else "",
                          comment=fields[1] if len(fields) > 1 else "")
            seqs.append(cur)
        elif line[0] == "+" and fastq_mode and cur is not None:
            pending_qual = True
        elif cur is not None:
            cur.seq += line.strip()
    return seqs


def split_to_chars(s):
    """Each character becomes one symbol (ref util splitToChars)."""
    return list(s)
