"""C++-compatible number / string formatting helpers.

The reference toolkit (machineboss) emits JSON with iostream formatting:
  - weight constants with setprecision(15)    (ref: src/weight.cpp:470)
  - log-likelihoods with default precision 6  (ref: src/jsonio.h:14-22)
  - DP cells with setprecision(5)             (ref: src/dpmatrix.defs.h:39-53)
  - strings escaped byte-wise                 (ref: src/util.cpp write_escaped)

Golden-file parity requires reproducing those exact textual forms.
"""

import math

_HEXDIG = "0123456789ABCDEF"


def cpp_double(x, sig=15):
    """Format a float the way C++ `ostream << setprecision(sig)` does (%g semantics)."""
    if isinstance(x, bool):
        return "1" if x else "0"
    if isinstance(x, int):
        return str(x)
    if math.isinf(x):
        return "inf" if x > 0 else "-inf"
    if math.isnan(x):
        return "nan"
    s = "%.*g" % (sig, x)
    # C++ prints exponents with at least 2 digits, as does %g in Python; but
    # Python may produce e.g. '1e-05' which matches C++ '1e-05'. Nothing to fix.
    return s


def cpp_double6(x):
    """Default-precision C++ ostream formatting (6 significant digits)."""
    return cpp_double(x, sig=6)


def infinity_safe_string(x):
    """Mirror of reference toInfinitySafeString (src/jsonio.h:14)."""
    if x == math.inf:
        return '"Infinity"'
    if x == -math.inf:
        return '"-Infinity"'
    return cpp_double6(x)


def write_escaped(s):
    """Byte-wise string escaping identical to reference util.cpp write_escaped."""
    out = []
    for ch in s.encode("utf-8").decode("latin-1"):
        c = ord(ch)
        if 0x20 <= c <= 0x7E and ch not in ('\\', '"'):
            out.append(ch)
        elif ch == '"':
            out.append('\\"')
        elif ch == '\\':
            out.append('\\\\')
        elif ch == '\t':
            out.append('\\t')
        elif ch == '\r':
            out.append('\\r')
        elif ch == '\n':
            out.append('\\n')
        else:
            out.append('\\x' + _HEXDIG[c >> 4] + _HEXDIG[c & 0xF])
    return "".join(out)


def json_dumps_compact(obj):
    """nlohmann::json dump() compatible compact serialization (no spaces,
    object keys sorted as in std::map)."""
    import json as _json
    return _json.dumps(obj, separators=(",", ":"), sort_keys=True,
                       ensure_ascii=False)
