"""Regular-expression to recognizer-machine importer.

A recursive-descent PEG matcher with the same grammar and machine-building
actions as the reference (ref: src/grammars/regex.abnf, actions in
src/parsers.cpp:9-300): char classes, ranges, presets (\\d \\s \\S .),
quantifiers (* + {n} {n,m}), alternation groups, and ^/$ anchors with
dot-star flanks when unanchored. Alphabet is configurable (text/DNA/RNA/AA).
"""

from .machine import Machine
from .fastseq import split_to_chars

DNA_ALPHABET = "ACGT"
RNA_ALPHABET = "ACGU"
AA_ALPHABET = "ACDEFGHIKLMNPQRSTVWY"


class _Fail(Exception):
    pass


class RegexParser:
    def __init__(self, white=" \t\n", nonwhite=None):
        self.white = white
        if nonwhite is None:
            nonwhite = "".join(chr(c) for c in range(ord("!"), ord("~") + 1))
        self.nonwhite = nonwhite

    def alphabet(self):
        return self.white + self.nonwhite

    # ------------------------------------------------------------- quantify

    @staticmethod
    def _quantify(m, min_max):
        lo, hi = min_max
        if lo == -1:
            return Machine.kleene_star(m)
        if lo == -2:
            return Machine.kleene_plus(m)
        qm = Machine.null()
        for _ in range(lo, hi):
            qm = Machine.zero_or_one(Machine.concatenate(m, qm))
        for _ in range(lo):
            qm = Machine.concatenate(m, qm)
        return qm

    # ------------------------------------------------------------- parsing

    def parse(self, text):
        self.text = text
        self.pos = 0
        alph_vec = split_to_chars(self.alphabet())
        self.alph_vec = alph_vec
        dot_star = Machine.wild_recognizer(alph_vec)

        carets = self._begin_anchor()
        m = self._regex_body()
        dollars = self._end_anchor()
        if self.pos != len(text):
            raise ValueError("In regular expression %r position %d:"
                             " syntax error" % (text, self.pos))
        if not carets:
            m = Machine.concatenate(dot_star, m)
        if dollars:
            if dollars > 1:
                m = Machine.concatenate(
                    m, Machine.recognizer(["$"] * (dollars - 1)))
        else:
            m = Machine.concatenate(m, dot_star)
        return m.eliminate_redundant_states().strip_names()

    def _peek(self):
        return self.text[self.pos] if self.pos < len(self.text) else ""

    def _eat(self, s):
        if self.text.startswith(s, self.pos):
            self.pos += len(s)
            return True
        return False

    def _begin_anchor(self):
        return 1 if self._eat("^") else 0

    def _end_anchor(self):
        n = 0
        while self._eat("$"):
            n += 1
        return n

    def _regex_body(self):
        save = self.pos
        try:
            return self._nonempty_regex_body()
        except _Fail:
            self.pos = save
            return Machine.null()

    def _nonempty_regex_body(self):
        save = self.pos
        # choice 1: DOLLAR NONEMPTY_REGEX_BODY  (literal '$')
        if self._eat("$"):
            try:
                rest = self._nonempty_regex_body()
                return Machine.concatenate(Machine.recognizer(["$"]), rest)
            except _Fail:
                self.pos = save
        # choice 2: QUANT_SYMBOLS REGEX_BODY (always concatenated; redundant
        # null states are eliminated at the end, as in the reference)
        m = self._quant_symbols()
        rest = self._regex_body()
        return Machine.concatenate(m, rest)

    def _quant_symbols(self):
        m = self._quant_symbol()
        save = self.pos
        try:
            rest = self._quant_symbols()
            return Machine.concatenate(m, rest)
        except _Fail:
            self.pos = save
            return m

    def _quant_symbol(self):
        save = self.pos
        # SYMBOL QUANTIFIER
        try:
            m = self._symbol()
            q = self._quantifier()
            return self._quantify(m, q)
        except _Fail:
            self.pos = save
        # TOP_SYMBOL
        return self._top_symbol()

    def _symbol(self):
        if self._eat("$"):
            return Machine.recognizer(["$"])
        return self._top_symbol()

    def _top_symbol(self):
        if self._peek() == "$":
            raise _Fail()
        return self._machine_symbol()

    def _machine_symbol(self):
        save = self.pos
        for fn in (self._negated_char_class, self._char_class,
                   self._implicit_char_class, self._alternation,
                   self._machine_char):
            try:
                return fn()
            except _Fail:
                self.pos = save
        raise _Fail()

    def _machine_char(self):
        c = self._escaped_or_single_char()
        return Machine.wild_single_recognizer([c])

    def _quantifier(self):
        if self._eat("*"):
            return (-1, -1)
        if self._eat("+"):
            return (-2, -2)
        save = self.pos
        if self._eat("{"):
            try:
                lo = self._integer()
                if self._eat("}"):
                    return (lo, lo)
                if self._eat(","):
                    hi = self._integer()
                    if self._eat("}"):
                        return (lo, hi)
            except _Fail:
                pass
            self.pos = save
        raise _Fail()

    def _integer(self):
        start = self.pos
        if self._peek() == "0":
            self.pos += 1
            return 0
        if not self._peek().isdigit():
            raise _Fail()
        while self._peek().isdigit():
            self.pos += 1
        return int(self.text[start:self.pos])

    def _char_class(self):
        if not self._eat("["):
            raise _Fail()
        chars = self._chars()
        if not self._eat("]"):
            raise _Fail()
        return Machine.wild_single_recognizer(split_to_chars(chars))

    def _negated_char_class(self):
        if not self._eat("[") or not self._eat("^"):
            raise _Fail()
        chars = self._chars()
        if not self._eat("]"):
            raise _Fail()
        negated = set(split_to_chars(chars))
        nc = [sym for sym in self.alph_vec if sym not in negated]
        return Machine.wild_single_recognizer(nc)

    def _implicit_char_class(self):
        s = self._preset_char_class()
        return Machine.wild_single_recognizer(split_to_chars(s))

    def _preset_char_class(self):
        if self._eat("\\d"):
            return "0123456789"
        if self._eat("\\s"):
            return self.white
        if self._eat("\\S"):
            return self.nonwhite
        if self._eat("."):
            return self.alphabet()
        raise _Fail()

    def _chars(self):
        s = self._char()
        while True:
            save = self.pos
            try:
                s += self._char()
            except _Fail:
                self.pos = save
                return s

    def _char(self):
        save = self.pos
        try:
            return self._preset_char_class()
        except _Fail:
            self.pos = save
        try:
            b = self._char_inside_class()
            if self._eat("-"):
                e = self._char_inside_class()
                if ord(e) < ord(b):
                    raise ValueError("illegal range in character class")
                return "".join(chr(c) for c in range(ord(b), ord(e) + 1))
            self.pos = save
        except _Fail:
            self.pos = save
        return self._char_inside_class()

    def _char_inside_class(self):
        if self._peek() == "]" or self._peek() == "":
            raise _Fail()
        return self._escaped_or_single_char()

    def _escaped_or_single_char(self):
        save = self.pos
        if self._eat("\\"):
            c = self._peek()
            # octal
            rest = self.text[self.pos:self.pos + 3]
            if len(rest) >= 3 and rest[0] in "012" and rest[1] in "01234567" \
                    and rest[2] in "01234567":
                self.pos += 3
                return chr(int(rest, 8))
            if len(rest) >= 2 and rest[0] in "01234567" and rest[1] in "01234567":
                self.pos += 2
                return chr(int(rest[:2], 8))
            if c == "x":
                hx = self.text[self.pos + 1:self.pos + 3]
                if len(hx) == 2 and all(h in "0123456789abcdefABCDEF"
                                        for h in hx):
                    self.pos += 3
                    return chr(int(hx, 16))
                self.pos = save
                raise _Fail()
            if c == "":
                self.pos = save
                raise _Fail()
            self.pos += 1
            return {"n": "\n", "r": "\r", "t": "\t"}.get(c, c)
        if self._peek() == "":
            raise _Fail()
        c = self._peek()
        self.pos += 1
        return c

    def _alternation(self):
        if not self._eat("("):
            raise _Fail()
        m = self._alt_options()
        if not self._eat(")"):
            raise _Fail()
        return m

    def _alt_options(self):
        m = self._alt_symbols()
        if self._eat("|"):
            rest = self._alt_options()
            return Machine.take_union(m, rest)
        return m

    def _alt_symbols(self):
        save = self.pos
        try:
            m = self._alt_symbol()
        except _Fail:
            self.pos = save
            return Machine.null()
        rest = self._alt_symbols()
        return Machine.concatenate(m, rest)

    def _alt_symbol(self):
        if self._peek() in ("|", ")"):
            raise _Fail()
        return self._quant_alt_symbol()

    def _quant_alt_symbol(self):
        m = self._machine_symbol()
        save = self.pos
        try:
            q = self._quantifier()
            return self._quantify(m, q)
        except _Fail:
            self.pos = save
            return m
