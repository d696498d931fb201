"""Code generators: specialized Forward/Viterbi source for a fixed machine.

Equivalent role to the reference compiler (ref: src/compiler.{h,cpp}): the
machine's transition structure is unrolled into straight-line source with
parameters resolved at runtime, so the generated program needs no machine
JSON, no interpreter, and no framework — just a C++ compiler (or a JS
runtime, or a WebGPU device for the WGSL target).

Numeric semantics match the framework's host interpreter exactly (the same
table-interpolated log-sum-exp), so generated programs reproduce golden
outputs bit-for-bit after standard rounding.

Input/output sequence types: String (character sequence), IntVec (token
ids), Profile (PSWM matrix with per-position symbol weights; column layout
[symbols..., epsilon] as produced by the CSV profile reader).
"""

import os

from .core import weight as W

SEQ_STRING = "string"
SEQ_INTVEC = "intvec"
SEQ_PROFILE = "profile"


def seq_type_for(flag, alphabet):
    if not flag:
        is_char = all(len(s) == 1 for s in alphabet)
        return SEQ_STRING if is_char else SEQ_INTVEC
    c = flag[0].lower()
    if c == "s":
        return SEQ_STRING
    if c == "i":
        return SEQ_INTVEC
    if c == "p":
        return SEQ_PROFILE
    raise ValueError("Sequence type must be S (string), I (integer vector)"
                     " or P (profile weight matrix)")


# ---------------------------------------------------------------------------
# expression emission


def _emit_expr_cpp(w, out):
    if w is None:
        out.append("0")
    elif isinstance(w, bool):
        out.append("1" if w else "0")
    elif isinstance(w, (int, float)):
        out.append(repr(float(w)))
    elif isinstance(w, str):
        out.append('getParam(params, "%s")' % w)
    else:
        op = w[0]
        if op == "log":
            out.append("std::log(")
            _emit_expr_cpp(w[1], out)
            out.append(")")
        elif op == "exp":
            out.append("std::exp(")
            _emit_expr_cpp(w[1], out)
            out.append(")")
        elif op == "pow":
            out.append("std::pow(")
            _emit_expr_cpp(w[1], out)
            out.append(",")
            _emit_expr_cpp(w[2], out)
            out.append(")")
        else:
            out.append("(")
            _emit_expr_cpp(w[1], out)
            out.append({"*": "*", "+": "+", "-": "-", "/": "/"}[op])
            _emit_expr_cpp(w[2], out)
            out.append(")")


def _emit_expr_js(w, out):
    if w is None:
        out.append("0")
    elif isinstance(w, bool):
        out.append("1" if w else "0")
    elif isinstance(w, (int, float)):
        out.append(repr(float(w)))
    elif isinstance(w, str):
        out.append('getParam(params, "%s")' % w)
    else:
        op = w[0]
        if op in ("log", "exp"):
            out.append("Math.%s(" % op)
            _emit_expr_js(w[1], out)
            out.append(")")
        elif op == "pow":
            out.append("Math.pow(")
            _emit_expr_js(w[1], out)
            out.append(",")
            _emit_expr_js(w[2], out)
            out.append(")")
        else:
            out.append("(")
            _emit_expr_js(w[1], out)
            out.append({"*": "*", "+": "+", "-": "-", "/": "/"}[op])
            _emit_expr_js(w[2], out)
            out.append(")")


def expr_to_cpp(w):
    out = []
    _emit_expr_cpp(w, out)
    return "".join(out)


def expr_to_js(w):
    out = []
    _emit_expr_js(w, out)
    return "".join(out)


# ---------------------------------------------------------------------------
# shared machine analysis


class _GenInfo:
    def __init__(self, machine):
        self.machine = machine
        self.in_alph = machine.input_alphabet()
        self.out_alph = machine.output_alphabet()
        self.in_tok = {s: i + 1 for i, s in enumerate(self.in_alph)}
        self.out_tok = {s: i + 1 for i, s in enumerate(self.out_alph)}
        self.n_states = machine.n_states()
        # flat transition list: (weight_id, src, dst, in_tok, out_tok)
        self.weights = []  # unique weight expressions
        self._weight_ids = {}
        self.trans = []
        for s, ms in enumerate(machine.states):
            for t in ms.trans:
                defs_bound = W.bind(t.weight, machine.funcs.defs)
                wid = self._weight_ids.get(defs_bound)
                if wid is None:
                    wid = len(self.weights)
                    self.weights.append(defs_bound)
                    self._weight_ids[defs_bound] = wid
                self.trans.append((wid, s, t.dest,
                                   self.in_tok.get(t.in_, 0),
                                   self.out_tok.get(t.out, 0)))


_CPP_RUNTIME = r"""// machine-specific Forward/Viterbi kernel.
// Self-contained C++17; numeric semantics identical to the framework's
// host interpreter (table-interpolated log-sum-exp, precision 1e-4,
// cutoff 10).
#pragma once
#include <cmath>
#include <cstdint>
#include <limits>
#include <map>
#include <stdexcept>
#include <string>
#include <vector>

namespace mbgen {

static const double kNegInf = -std::numeric_limits<double>::infinity();

struct LseTable {
  std::vector<double> t;
  LseTable() : t(100002) {
    for (int n = 0; n < 100002; ++n) t[n] = std::log1p(std::exp(-n * 1e-4));
  }
};

inline double lse_unary(double x) {
  static const LseTable table;
  if (x >= 10.0 || std::isnan(x) || std::isinf(x)) return 0.0;
  if (x < 0) return -x;
  int n = (int)(x / 1e-4);
  double f0 = table.t[n], f1 = table.t[n + 1];
  double dx = x - n * 1e-4;
  return f0 + (f1 - f0) * (dx / 1e-4);
}

inline double lse(double a, double b) {
  double mx, diff;
  if (a == b) { mx = a; diff = 0; }
  else if (a < b) { mx = b; diff = b - a; }
  else { mx = a; diff = a - b; }
  return mx + lse_unary(diff);
}

inline double max_reduce(double a, double b) { return a > b ? a : b; }

inline double getParam(const std::map<std::string, double>& params,
                       const std::string& name) {
  auto it = params.find(name);
  if (it == params.end())
    throw std::runtime_error("Parameter " + name + " not defined");
  return it->second;
}

}  // namespace mbgen
"""


_CPP_SOFTPLUS_RUNTIME = r"""// Int-log SoftPlus arithmetic (reference semantics: src/softplus.h —
// IntLog = round(log/1e-4), cached softplus table with cutoff 10, and a
// genuine 32/64-bit width distinction: the 32-bit build clamps at
// 0x1FFFFFFF*1e-4 = 53687 nats, the 64-bit at 0x1FFFFFFFFFFFFFFF*1e-4).
#pragma once
#include <cmath>
#include <cstdint>
#include <limits>
#include <map>
#include <stdexcept>
#include <string>
#include <vector>

namespace mbgen {

#ifdef MBGEN_INTLOG32
typedef int32_t IntLog;
static const IntLog kIntLogInf = 0x1FFFFFFF;
#else
typedef int64_t IntLog;
static const IntLog kIntLogInf = 0x1FFFFFFFFFFFFFFFLL;
#endif
static const double kIntLogPrecision = 1e-4;
static const double kLogInf = kIntLogPrecision * (double) kIntLogInf;
static const long   kSpCacheEntries = 100001;  // 10 / 1e-4 + 1

inline IntLog log_to_int(double x) {
  return (x <= -kLogInf ? -kIntLogInf
          : (x >= kLogInf ? kIntLogInf
             : (IntLog) (.5 + x / kIntLogPrecision)));
}

inline double int_to_log(IntLog x) {
  return (x <= -kIntLogInf ? -std::numeric_limits<double>::infinity()
          : (x >= kIntLogInf ? std::numeric_limits<double>::infinity()
             : kIntLogPrecision * (double) x));
}

inline IntLog int_log(double p) {
  return p > 0 ? log_to_int(std::log(p)) : -kIntLogInf;
}

inline IntLog bound_intlog(IntLog x) {
  return x < -kIntLogInf ? -kIntLogInf : (x > kIntLogInf ? kIntLogInf : x);
}

inline double getParam(const std::map<std::string, double>& params,
                       const std::string& name) {
  auto it = params.find(name);
  if (it == params.end())
    throw std::runtime_error("Parameter " + name + " not defined");
  return it->second;
}

struct SoftPlus {
  std::vector<IntLog> cache;
  SoftPlus() : cache(kSpCacheEntries) {
    for (long n = 0; n < kSpCacheEntries; ++n)
      cache[n] = log_to_int(std::log1p(std::exp(-(kIntLogPrecision * n))));
  }
  inline IntLog sp_neg(IntLog x) const {
    return x >= kSpCacheEntries ? 0 : cache[x];
  }
  inline IntLog lse_canonical(IntLog larger, IntLog smaller) const {
    return (smaller <= -kIntLogInf || larger >= kIntLogInf)
        ? bound_intlog(larger) : larger + sp_neg(larger - smaller);
  }
  inline IntLog lse(IntLog a, IntLog b) const {
    return a > b ? lse_canonical(a, b) : lse_canonical(b, a);
  }
  static inline IntLog max_reduce(IntLog a, IntLog b) {
    return bound_intlog(a > b ? a : b);
  }
};

}  // namespace mbgen
"""


class CPlusPlusCompiler:
    """Emits a self-contained C++ computeForward in the reference's int-log
    SoftPlus arithmetic (ref src/softplus.h:9-21, src/compiler.cpp):
    weights and cells are integer logs at 1e-4 precision, log-sum-exp is a
    cached integer softplus lookup, and is_64bit selects a genuine
    int32_t/int64_t IntLog width with matching clamp range."""

    filename_suffix = ".cpp"
    header_suffix = ".h"

    def __init__(self, is_64bit=True):
        self.is_64bit = is_64bit
        self.show_cells = False
        self.use_max_reduce = False

    def compile_forward(self, machine, x_type, y_type, out_dir,
                        func_name="computeForward"):
        info = _GenInfo(machine)
        os.makedirs(out_dir, exist_ok=True)
        header = self._emit(info, x_type, y_type, func_name)
        with open(os.path.join(out_dir, func_name + ".h"), "w") as f:
            f.write(header)

    def _seq_arg(self, seq_type, name):
        if seq_type == SEQ_STRING:
            return "const std::string& %s" % name
        if seq_type == SEQ_INTVEC:
            return "const std::vector<int>& %s" % name
        return "const std::vector<std::vector<double>>& %s" % name

    def _emit(self, info, x_type, y_type, func_name):
        L = []
        if not self.is_64bit:
            L.append("#define MBGEN_INTLOG32 1\n")
        L.append(_CPP_SOFTPLUS_RUNTIME)
        L.append("namespace mbgen {\n")
        S = info.n_states

        # tokenizers
        def emit_tokenizer(alph, tag):
            L.append("inline int %sTok(char c) {\n  switch (c) {\n" % tag)
            for i, sym in enumerate(alph):
                L.append("    case '%s': return %d;\n"
                         % (sym.replace("\\", "\\\\").replace("'", "\\'"),
                            i + 1))
            L.append("    default: throw std::runtime_error(\"bad symbol\");"
                     "\n  }\n}\n")

        if x_type == SEQ_STRING:
            emit_tokenizer(info.in_alph, "x")
        if y_type == SEQ_STRING:
            emit_tokenizer(info.out_alph, "y")

        L.append("double %s(%s, %s, const std::map<std::string,double>&"
                 " params) {\n"
                 % (func_name, self._seq_arg(x_type, "x"),
                    self._seq_arg(y_type, "y")))

        L.append("  static const SoftPlus sp;\n")
        # transition weights as integer logs
        for wid, w in enumerate(info.weights):
            L.append("  const IntLog w%d = int_log(%s);\n"
                     % (wid, expr_to_cpp(w)))

        # tokenized inputs
        if x_type == SEQ_STRING:
            L.append("  std::vector<int> xs;\n"
                     "  for (char c : x) xs.push_back(xTok(c));\n")
        elif x_type == SEQ_INTVEC:
            L.append("  const std::vector<int>& xs = x;\n")
        if y_type == SEQ_STRING:
            L.append("  std::vector<int> ys;\n"
                     "  for (char c : y) ys.push_back(yTok(c));\n")
        elif y_type == SEQ_INTVEC:
            L.append("  const std::vector<int>& ys = y;\n")
        lx = "x.size()" if x_type != SEQ_PROFILE else "x.size()"
        ly = "y.size()" if y_type != SEQ_PROFILE else "y.size()"
        L.append("  const size_t Lx = %s, Ly = %s;\n" % (lx, ly))
        L.append("  std::vector<std::vector<IntLog>> buf0(Lx+1,"
                 " std::vector<IntLog>(%d, -kIntLogInf)), buf1 = buf0;\n"
                 % S)

        def cell(row, ix, d):
            return "%s[%s][%d]" % (row, ix, d)

        def tok_test(seq_type, arr, pos, tok):
            if seq_type == SEQ_PROFILE:
                return None  # handled by weight lookup
            return "%s[%s] == %d" % (arr, pos, tok)

        reduce_fmt = ("%s = SoftPlus::max_reduce(%s, %s);"
                      if self.use_max_reduce else "%s = sp.lse(%s, %s);")

        def emit_term(acc, src_cell, extra, cond):
            term = "bound_intlog(%s + %s)" % (src_cell, extra)
            line = reduce_fmt % (acc, acc, term)
            if cond:
                line = "if (%s) %s" % (cond, line)
            return "        " + line + "\n"

        # main fill loop: iy rows, ix cols, states ascending
        L.append("""  for (size_t iy = 0; iy <= Ly; ++iy) {
    std::vector<std::vector<IntLog>>& cur = (iy & 1) ? buf1 : buf0;
    std::vector<std::vector<IntLog>>& prev = (iy & 1) ? buf0 : buf1;
    for (size_t ix = 0; ix <= Lx; ++ix) {
      for (int d = 0; d < %d; ++d) cur[ix][d] = -kIntLogInf;
      if (ix == 0 && iy == 0) cur[0][0] = 0;\n""" % S)

        # group incoming transitions per destination state (ascending);
        # order: match, input-only, output-only, silent (interpreter order)
        incoming = {d: [] for d in range(S)}
        for wid, s, d, it, ot in info.trans:
            incoming[d].append((wid, s, it, ot))

        for d in range(S):
            entries = incoming[d]
            cases = {"match": [], "in": [], "out": [], "silent": []}
            for wid, s, it, ot in entries:
                if it and ot:
                    cases["match"].append((wid, s, it, ot))
                elif it:
                    cases["in"].append((wid, s, it, ot))
                elif ot:
                    cases["out"].append((wid, s, it, ot))
                else:
                    cases["silent"].append((wid, s, it, ot))
            if not entries and d != 0:
                continue
            L.append("      {\n        IntLog acc = cur[ix][%d];\n" % d)
            for wid, s, it, ot in cases["match"]:
                conds = ["ix > 0", "iy > 0"]
                ex = "w%d" % wid
                if x_type == SEQ_PROFILE:
                    ex += " + int_log(x[ix-1][%d])" % it
                else:
                    conds.append("xs[ix-1] == %d" % it)
                if y_type == SEQ_PROFILE:
                    ex += " + int_log(y[iy-1][%d])" % ot
                else:
                    conds.append("ys[iy-1] == %d" % ot)
                L.append(emit_term("acc", cell("prev", "ix-1", s), ex,
                                   " && ".join(conds)))
            for wid, s, it, ot in cases["in"]:
                conds = ["ix > 0"]
                ex = "w%d" % wid
                if x_type == SEQ_PROFILE:
                    ex += " + int_log(x[ix-1][%d])" % it
                else:
                    conds.append("xs[ix-1] == %d" % it)
                L.append(emit_term("acc", cell("cur", "ix-1", s), ex,
                                   " && ".join(conds)))
            for wid, s, it, ot in cases["out"]:
                conds = ["iy > 0"]
                ex = "w%d" % wid
                if y_type == SEQ_PROFILE:
                    ex += " + int_log(y[iy-1][%d])" % ot
                else:
                    conds.append("ys[iy-1] == %d" % ot)
                L.append(emit_term("acc", cell("prev", "ix", s), ex,
                                   " && ".join(conds)))
            for wid, s, it, ot in cases["silent"]:
                L.append(emit_term("acc", cell("cur", "ix", s),
                                   "w%d" % wid, None))
            L.append("        cur[ix][%d] = acc;\n      }\n" % d)
        if self.show_cells:
            L.append('      for (int d = 0; d < %d; ++d)\n'
                     '        fprintf(stderr, "cell(%%zu,%%zu,%%d) = %%g\\n",'
                     ' ix, iy, d, int_to_log(cur[ix][d]));\n' % S)
        L.append("""    }
  }
  return int_to_log(((Ly & 1) ? buf1 : buf0)[Lx][%d]);
}

}  // namespace mbgen
""" % (S - 1))
        return "".join(L)


class JavaScriptCompiler:
    """Emits a self-contained JS module (ref JavaScriptCompiler)."""

    def __init__(self):
        self.show_cells = False
        self.use_max_reduce = False

    def compile_forward(self, machine, x_type, y_type, out_dir,
                        func_name="computeForward"):
        info = _GenInfo(machine)
        os.makedirs(out_dir, exist_ok=True)
        src = self._emit(info, x_type, y_type, func_name)
        with open(os.path.join(out_dir, func_name + ".js"), "w") as f:
            f.write(src)

    def _emit(self, info, x_type, y_type, func_name):
        S = info.n_states
        reduce_fn = "maxReduce" if self.use_max_reduce else "lse"
        L = ["""// machine-specific Forward/Viterbi kernel (generated).
function lseUnary(x) {
  if (x >= 10 || !isFinite(x)) return 0;
  if (x < 0) return -x;
  return Math.log1p(Math.exp(-x));
}
function lse(a, b) {
  if (a === -Infinity) return b;
  if (b === -Infinity) return a;
  var mx = Math.max(a, b);
  return mx + lseUnary(Math.abs(a - b));
}
function maxReduce(a, b) { return Math.max(a, b); }
function getParam(params, name) {
  if (!(name in params)) throw new Error("Parameter " + name + " not defined");
  return params[name];
}
"""]
        in_map = {s: i + 1 for i, s in enumerate(info.in_alph)}
        out_map = {s: i + 1 for i, s in enumerate(info.out_alph)}
        L.append("var xTokMap = %s;\n"
                 % str(in_map).replace("'", '"'))
        L.append("var yTokMap = %s;\n"
                 % str(out_map).replace("'", '"'))
        L.append("function %s(x, y, params) {\n" % func_name)
        for wid, w in enumerate(info.weights):
            L.append("  var w%d = Math.log(%s);\n" % (wid, expr_to_js(w)))
        if x_type == SEQ_PROFILE:
            L.append("  var xs = x;\n  var Lx = x.length;\n")
        else:
            L.append('  var xs = (typeof x === "string"'
                     ' ? x.split("").map(function(c){return xTokMap[c];})'
                     " : x);\n  var Lx = xs.length;\n")
        if y_type == SEQ_PROFILE:
            L.append("  var ys = y;\n  var Ly = y.length;\n")
        else:
            L.append('  var ys = (typeof y === "string"'
                     ' ? y.split("").map(function(c){return yTokMap[c];})'
                     " : y);\n  var Ly = ys.length;\n")
        L.append("""  function newRow() {
    var r = [];
    for (var i = 0; i <= Lx; ++i) {
      r.push(new Array(%d).fill(-Infinity));
    }
    return r;
  }
  var buf0 = newRow(), buf1 = newRow();
  for (var iy = 0; iy <= Ly; ++iy) {
    var cur = (iy & 1) ? buf1 : buf0;
    var prev = (iy & 1) ? buf0 : buf1;
    for (var ix = 0; ix <= Lx; ++ix) {
      for (var d = 0; d < %d; ++d) cur[ix][d] = -Infinity;
      if (ix === 0 && iy === 0) cur[0][0] = 0;
""" % (S, S))
        incoming = {d: [] for d in range(S)}
        for wid, s, d, it, ot in info.trans:
            incoming[d].append((wid, s, it, ot))

        def term(acc, src, extra, cond):
            line = "%s = %s(%s, %s + %s);" % (acc, reduce_fn, acc, src, extra)
            if cond:
                line = "if (%s) %s" % (cond, line)
            return "      " + line + "\n"

        for d in range(S):
            entries = incoming[d]
            if not entries and d != 0:
                continue
            L.append("      var acc%d = cur[ix][%d];\n" % (d, d))
            for wid, s, it, ot in entries:
                conds = []
                ex = "w%d" % wid
                src = None
                if it and ot:
                    conds += ["ix > 0", "iy > 0"]
                    src = "prev[ix-1][%d]" % s
                elif it:
                    conds += ["ix > 0"]
                    src = "cur[ix-1][%d]" % s
                elif ot:
                    conds += ["iy > 0"]
                    src = "prev[ix][%d]" % s
                else:
                    src = "cur[ix][%d]" % s
                if it:
                    if x_type == SEQ_PROFILE:
                        ex += " + Math.log(xs[ix-1][%d])" % it
                    else:
                        conds.append("xs[ix-1] === %d" % it)
                if ot:
                    if y_type == SEQ_PROFILE:
                        ex += " + Math.log(ys[iy-1][%d])" % ot
                    else:
                        conds.append("ys[iy-1] === %d" % ot)
                L.append(term("acc%d" % d, src, ex, " && ".join(conds)))
            L.append("      cur[ix][%d] = acc%d;\n" % (d, d))
        L.append("""    }
  }
  return ((Ly & 1) ? buf1 : buf0)[Lx][%d];
}
if (typeof module !== "undefined") module.exports = { %s: %s };
""" % (S - 1, func_name, func_name))
        return "".join(L)


def compile_wgsl(machine, out_dir, func_name="computeForward"):
    """Emit a WGSL wavefront compute shader + ES module wrapper
    (ref WGSLCompiler::compile). One dispatch per anti-diagonal; one
    invocation per lattice cell; token-conditioned transition weights in a
    storage buffer."""
    info = _GenInfo(machine)
    os.makedirs(out_dir, exist_ok=True)
    S = info.n_states
    n_in = len(info.in_alph) + 1
    n_out = len(info.out_alph) + 1
    shader = """// generated wavefront Forward shader
struct Dims { lx: u32, ly: u32, d: u32, pad: u32 };
@group(0) @binding(0) var<uniform> dims: Dims;
@group(0) @binding(1) var<storage, read> logTrans: array<f32>; // [nIn][nOut][S][S]
@group(0) @binding(2) var<storage, read> xs: array<u32>;
@group(0) @binding(3) var<storage, read> ys: array<u32>;
@group(0) @binding(4) var<storage, read_write> cells: array<f32>; // [(lx+1)*(ly+1)*S]

const S: u32 = %du;
const N_IN: u32 = %du;
const N_OUT: u32 = %du;
const NEG_INF: f32 = -3.0e38;

fn lse(a: f32, b: f32) -> f32 {
  if (a <= NEG_INF * 0.5) { return b; }
  if (b <= NEG_INF * 0.5) { return a; }
  let mx = max(a, b);
  return mx + log(1.0 + exp(-abs(a - b)));
}

fn lt(i: u32, o: u32, s: u32, d: u32) -> f32 {
  return logTrans[((i * N_OUT + o) * S + s) * S + d];
}

fn cellIdx(ix: u32, iy: u32, s: u32) -> u32 {
  return (iy * (dims.lx + 1u) + ix) * S + s;
}

@compute @workgroup_size(64)
fn forwardDiagonal(@builtin(global_invocation_id) gid: vec3<u32>) {
  let k = gid.x;            // index along the anti-diagonal
  let d = dims.d;           // current diagonal
  let ix = k;
  if (ix > dims.lx || ix > d) { return; }
  let iy = d - ix;
  if (iy > dims.ly) { return; }
  let xt = select(0u, xs[ix - 1u] , ix > 0u);
  let yt = select(0u, ys[iy - 1u] , iy > 0u);
  for (var s2: u32 = 0u; s2 < S; s2 = s2 + 1u) {
    var acc = NEG_INF;
    if (ix == 0u && iy == 0u && s2 == 0u) { acc = 0.0; }
    for (var s: u32 = 0u; s < S; s = s + 1u) {
      if (ix > 0u && iy > 0u) {
        acc = lse(acc, cells[cellIdx(ix - 1u, iy - 1u, s)] + lt(xt, yt, s, s2));
      }
      if (ix > 0u) {
        acc = lse(acc, cells[cellIdx(ix - 1u, iy, s)] + lt(xt, 0u, s, s2));
      }
      if (iy > 0u) {
        acc = lse(acc, cells[cellIdx(ix, iy - 1u, s)] + lt(0u, yt, s, s2));
      }
    }
    // silent transitions resolved in ascending state order within the cell
    for (var s: u32 = 0u; s < s2; s = s + 1u) {
      acc = lse(acc, cells[cellIdx(ix, iy, s)] + lt(0u, 0u, s, s2));
    }
    cells[cellIdx(ix, iy, s2)] = acc;
  }
}
""" % (S, n_in, n_out)
    with open(os.path.join(out_dir, func_name + ".wgsl"), "w") as f:
        f.write(shader)
    module = """// generated ES module wrapper for the WGSL Forward shader
export async function %s(device, logTrans, xs, ys) {
  // host driver: upload buffers, dispatch forwardDiagonal for each
  // anti-diagonal d = 0..lx+ly, read back final cell.
  throw new Error("wire this wrapper to your WebGPU pipeline helper");
}
""" % func_name
    with open(os.path.join(out_dir, func_name + ".mjs"), "w") as f:
        f.write(module)
