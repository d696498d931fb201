"""Infix weight-expression parser.

Grammar and semantics mirror the reference PEG grammar
(ref: src/grammars/expr.h, actions in src/parsers.cpp:307-456):

  Term    <- Factor (('+' Factor) / ('-' Factor))*
  Factor  <- Power (('*' Power) / ('/' Power))*
  Power   <- Primary ('^' Primary)?
  Primary <- '(' Term ')' / 'exp(...)' / 'e^Primary' / 'log(...)'
           / '!' Primary / '-' Primary / Number / '$'identifier

Notes kept for parity:
  - numeric literals go through float32 rounding (C++ stof), so e.g. "0.1"
    parses to 0.100000001490116 exactly as the reference does
  - '$name' yields the bare param name (no '$' prefix)
  - a-b is built as add(a, minus(b)) which folds to subtract(a, b)
"""

import re
import struct

from . import weight as W

_NUMBER_RE = re.compile(
    r"[-+]?(?:(?:\d+\.\d+|\.\d+|\d+)(?:[eE][-+]?\d+)?)")
_IDENT_RE = re.compile(r"[a-zA-Z][a-zA-Z0-9]*")


def _stof(s):
    """C++ std::stof: parse then round to float32."""
    return struct.unpack("f", struct.pack("f", float(s)))[0]


class _Parser:
    def __init__(self, text):
        self.text = text
        self.pos = 0

    def error(self, msg):
        raise ValueError("In weight expression %r position %d: %s"
                         % (self.text, self.pos, msg))

    def ws(self):
        while self.pos < len(self.text) and self.text[self.pos] in " \t\r\n":
            self.pos += 1

    def peek(self):
        return self.text[self.pos] if self.pos < len(self.text) else ""

    def eat(self, s):
        if self.text.startswith(s, self.pos):
            self.pos += len(s)
            return True
        return False

    def expect(self, s):
        if not self.eat(s):
            self.error("expected %r" % s)

    def term(self):
        self.ws()
        w = self.factor()
        while True:
            if self.eat("+"):
                self.ws()
                w = W.add(w, self.factor())
            elif self.eat("-"):
                self.ws()
                w = W.add(w, W.minus(self.factor()))
            else:
                return w

    def factor(self):
        w = self.power()
        while True:
            if self.eat("*"):
                self.ws()
                w = W.multiply(w, self.power())
            elif self.eat("/"):
                self.ws()
                w = W.multiply(w, W.reciprocal(self.power()))
            else:
                return w

    def power(self):
        a = self.primary()
        if self.eat("^"):
            self.ws()
            b = self.primary()
            return W.power(a, b)
        return a

    def primary(self):
        w = self._primary_inner()
        self.ws()
        return w

    def _primary_inner(self):
        if self.eat("("):
            w = self.term()
            self.expect(")")
            return w
        if self.text.startswith("exp", self.pos):
            save = self.pos
            self.pos += 3
            self.ws()
            if self.eat("("):
                self.ws()
                w = self.term()
                self.ws()
                self.expect(")")
                return W.exp_of(w)
            self.pos = save
        if self.peek() == "e":
            save = self.pos
            self.pos += 1
            self.ws()
            if self.eat("^"):
                self.ws()
                return W.exp_of(self.primary())
            self.pos = save
        if self.text.startswith("log", self.pos):
            save = self.pos
            self.pos += 3
            self.ws()
            if self.eat("("):
                self.ws()
                w = self.term()
                self.ws()
                self.expect(")")
                return W.log_of(w)
            self.pos = save
        if self.eat("!"):
            self.ws()
            return W.negate(self.primary())
        if self.eat("-"):
            self.ws()
            return W.minus(self.primary())
        m = _NUMBER_RE.match(self.text, self.pos)
        if m:
            self.pos = m.end()
            return W.double_constant(_stof(m.group()))
        if self.eat("$"):
            m = _IDENT_RE.match(self.text, self.pos)
            if not m:
                self.error("expected identifier after '$'")
            self.pos = m.end()
            return m.group()
        self.error("expected expression")


def parse_weight_expr(text):
    p = _Parser(text)
    w = p.term()
    p.ws()
    if p.pos != len(p.text):
        p.error("trailing characters")
    return w
