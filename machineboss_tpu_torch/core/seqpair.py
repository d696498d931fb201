"""Sequence pairs, alignment paths, and banded-DP envelopes.

Host-side data model for DP inputs (ref: src/seqpair.{h,cpp}). The Envelope
is the banded-DP region: per output row y, the half-open input interval
[inStart[y], inEnd[y]). On device, envelopes lower to block masks over the
DP lattice (ops/dp2d.py).
"""

from ..utils.jsonfmt import write_escaped

DEFAULT_INPUT_NAME = "input"
DEFAULT_OUTPUT_NAME = "output"


class NamedSeq:
    __slots__ = ("name", "seq")

    def __init__(self, name="", seq=None):
        self.name = name
        self.seq = list(seq) if seq else []

    @classmethod
    def from_json(cls, j):
        from .schema import validate_or_die
        validate_or_die("namedsequence", j)
        return cls(j.get("name", ""), [str(s) for s in j["sequence"]])

    def read_json_with_default_seq(self, j, default_seq):
        if "name" in j:
            self.name = j["name"]
        if "sequence" in j:
            seq = [str(s) for s in j["sequence"]]
            if seq != list(default_seq):
                raise ValueError(
                    "Sequence pair mismatch\nSequence: %s\nExpected: %s"
                    % (seq, default_seq))
            self.seq = seq
        else:
            self.seq = list(default_seq)

    def to_json_str(self):
        return '{"name":"%s","sequence":[%s]}' % (
            self.name, ",".join('"%s"' % s for s in self.seq))


class SeqPair:
    def __init__(self, input=None, output=None, alignment=None, metadata=None):
        self.input = input if input is not None else NamedSeq()
        self.output = output if output is not None else NamedSeq()
        self.alignment = list(alignment) if alignment else []
        self.metadata = metadata

    @classmethod
    def from_json(cls, j):
        from .schema import validate_or_die
        validate_or_die("seqpair", j)
        sp = cls()
        sp.input.name = DEFAULT_INPUT_NAME
        sp.output.name = DEFAULT_OUTPUT_NAME
        if "alignment" in j:
            in_seq, out_seq = [], []
            for col in j["alignment"]:
                in_sym, out_sym = col[0], col[1]
                if in_sym:
                    in_seq.append(in_sym)
                if out_sym:
                    out_seq.append(out_sym)
                sp.alignment.append((in_sym, out_sym))
            if "input" in j:
                sp.input.read_json_with_default_seq(j["input"], in_seq)
            else:
                sp.input.seq = in_seq
            if "output" in j:
                sp.output.read_json_with_default_seq(j["output"], out_seq)
            else:
                sp.output.seq = out_seq
            if "meta" in j:
                sp.metadata = j["meta"]
        else:
            sp.input = NamedSeq.from_json(j["input"])
            sp.output = NamedSeq.from_json(j["output"])
            if "meta" in j:
                sp.metadata = j["meta"]
        return sp

    def to_json_str(self):
        out = ['{"input":', self.input.to_json_str(),
               ',"output":', self.output.to_json_str()]
        if self.alignment:
            out.append(',"alignment":[')
            out.append(",".join('["%s","%s"]' % (write_escaped(a),
                                                 write_escaped(b))
                                for a, b in self.alignment))
            out.append("]")
        if self.metadata is not None:
            from ..utils.jsonfmt import json_dumps_compact
            out.append(',"meta":' + json_dumps_compact(self.metadata))
        out.append("}")
        return "".join(out)

    @staticmethod
    def alignment_from_path(path):
        return [(t.in_, t.out) for t in path.trans if not t.is_silent()]

    @classmethod
    def from_path(cls, path, machine, input_name=DEFAULT_INPUT_NAME,
                  output_name=DEFAULT_OUTPUT_NAME):
        import json as _json
        alignment = cls.alignment_from_path(path)
        meta = {"path": _json.loads(path.to_json_str(machine))}
        return cls(NamedSeq(input_name, [a for a, b in alignment if a]),
                   NamedSeq(output_name, [b for a, b in alignment if b]),
                   alignment, meta)

    def transpose(self):
        sp = SeqPair()
        sp.input = NamedSeq(self.output.name, self.output.seq)
        sp.output = NamedSeq(self.input.name, self.input.seq)
        sp.alignment = [(b, a) for a, b in self.alignment]
        sp.metadata = self.metadata
        return sp


class Envelope:
    """Banded DP region: inStart[y] <= x < inEnd[y] for each output row y."""

    def __init__(self, sp=None, width=None):
        self.clear()
        if sp is not None:
            if sp.alignment:
                if width is None:
                    self.init_path(sp.alignment)
                else:
                    self.init_path_area(sp.alignment, width)
            else:
                self.init_full(sp)
            if not self.fits(sp):
                raise ValueError("Envelope/sequence mismatch")

    def clear(self):
        self.in_len = 0
        self.out_len = 0
        self.in_start = [0]
        self.in_end = [1]

    def init_full(self, sp):
        self.clear()
        self.in_len = len(sp.input.seq)
        self.out_len = len(sp.output.seq)
        self.in_start = [0] * (self.out_len + 1)
        self.in_end = [self.in_len + 1] * (self.out_len + 1)

    def init_path(self, cols):
        self.clear()
        for a, b in cols:
            got_in, got_out = bool(a), bool(b)
            if not got_in and got_out:
                self.in_start.append(self.in_end[-1] - 1)
                self.in_end.append(self.in_end[-1])
                self.out_len += 1
            elif got_in and not got_out:
                self.in_end[-1] += 1
                self.in_len += 1
            elif got_in and got_out:
                self.in_start.append(self.in_end[-1])
                self.in_end.append(self.in_end[-1] + 1)
                self.in_len += 1
                self.out_len += 1

    def init_path_area(self, cols, width):
        self.clear()
        match = []
        n_before = [0]
        for a, b in cols:
            got_in, got_out = bool(a), bool(b)
            if got_in and got_out:
                match.append(self.in_len)
            if got_in:
                self.in_len += 1
            if got_out:
                self.out_len += 1
                n_before.append(len(match))
        self.in_start = []
        self.in_end = []
        for j in range(self.out_len + 1):
            i_start, i_end = 0, self.in_len + 1
            if n_before[j] > width:
                i_start = match[n_before[j] - width - 1] + 1
            n_after = len(match) - n_before[j]
            if n_after > width:
                i_end = match[n_before[j] + width] + 1
            self.in_start.append(i_start)
            self.in_end.append(i_end)

    def contains(self, x, y):
        return (0 <= y <= self.out_len
                and self.in_start[y] <= x < self.in_end[y])

    def fits(self, sp):
        return (self.in_len == len(sp.input.seq)
                and self.out_len == len(sp.output.seq))

    @staticmethod
    def _overlapping(s1, e1, s2, e2):
        return not (s1 >= e2 or s2 >= e1)

    def connected(self):
        conn = self._overlapping(self.in_start[0], self.in_end[0], 0, 1)
        for y in range(1, self.out_len + 1):
            if not conn:
                break
            conn = conn and self._overlapping(
                self.in_start[y - 1], self.in_end[y - 1] + 1,
                self.in_start[y], self.in_end[y])
        return conn and self._overlapping(
            self.in_start[self.out_len], self.in_end[self.out_len],
            self.in_len, self.in_len + 1)

    def offsets(self):
        result = [0]
        for y in range(self.out_len + 1):
            result.append(result[-1] + self.in_end[y] - self.in_start[y])
        return result

    def n_cells(self):
        return self.offsets()[-1]

    @classmethod
    def full(cls, sp):
        env = cls()
        env.init_full(sp)
        return env

    def to_json_str(self):
        return "[" + ",".join("[%d,%d]" % (self.in_start[j], self.in_end[j])
                              for j in range(self.out_len + 1)) + "]"


class SeqPairList:
    def __init__(self, seq_pairs=None):
        self.seq_pairs = list(seq_pairs) if seq_pairs else []

    @classmethod
    def from_json(cls, j):
        from .schema import validate_or_die
        validate_or_die("seqpairlist", j)
        return cls([SeqPair.from_json(sp) for sp in j])

    def envelopes(self, width=None):
        return [Envelope(sp, width) for sp in self.seq_pairs]

    def to_json_str(self):
        return "[" + ",\n ".join(sp.to_json_str() for sp in self.seq_pairs) + "]"
