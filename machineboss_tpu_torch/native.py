"""ctypes bridge to the native host core (native/libmbcore.so).

The native library implements the hot host-side graph operations (compose,
advance-sort, advancing-machine, ergodic trim) with hash-consed expression
arenas; outputs are byte-identical to the Python implementations, which
remain the reference and the fallback when the library is not built.

Build with: make -C native
"""

import ctypes
import json
import os

_LIB = None
_LIB_TRIED = False

_SO_PATH = os.path.join(os.path.dirname(__file__), "..", "native",
                        "libmbcore.so")


def load_library():
    global _LIB, _LIB_TRIED
    if _LIB_TRIED:
        return _LIB
    _LIB_TRIED = True
    if not os.path.exists(_SO_PATH):
        return None
    lib = ctypes.CDLL(_SO_PATH)
    lib.mb_compose.restype = ctypes.c_void_p
    lib.mb_compose.argtypes = [ctypes.c_char_p, ctypes.c_char_p,
                               ctypes.c_int]
    lib.mb_transform.restype = ctypes.c_void_p
    lib.mb_transform.argtypes = [ctypes.c_char_p]
    lib.mb_combine.restype = ctypes.c_void_p
    lib.mb_combine.argtypes = [ctypes.c_char_p]
    lib.mb_free.argtypes = [ctypes.c_void_p]
    _LIB = lib
    return lib


def available():
    return load_library() is not None


def _take_string(lib, ptr):
    try:
        return ctypes.string_at(ptr).decode("utf-8")
    finally:
        lib.mb_free(ptr)


def compose_json(a_json_text, b_json_text, cycle_strategy=2):
    """Compose two machine JSON documents natively; returns machine JSON
    text in the framework's canonical format."""
    lib = load_library()
    if lib is None:
        raise RuntimeError("native library not built (make -C native)")
    ptr = lib.mb_compose(a_json_text.encode(), b_json_text.encode(),
                         cycle_strategy)
    out = _take_string(lib, ptr)
    if out.startswith('{"error"'):
        raise RuntimeError(json.loads(out)["error"])
    return out


def transform_json(machine_json_text, op, **kwargs):
    lib = load_library()
    if lib is None:
        raise RuntimeError("native library not built (make -C native)")
    req = {"op": op, "machine": json.loads(machine_json_text)}
    req.update(kwargs)
    ptr = lib.mb_transform(json.dumps(req).encode())
    out = _take_string(lib, ptr)
    if out.startswith('{"error"'):
        raise RuntimeError(json.loads(out)["error"])
    return out


def combine_json(op, a_json_text, b_json_text, **kwargs):
    """Two-machine native constructions:
    op in {'concat', 'union', 'intersect'}."""
    lib = load_library()
    if lib is None:
        raise RuntimeError("native library not built (make -C native)")
    d = {"op": op, "a": json.loads(a_json_text),
         "b": json.loads(b_json_text)}
    d.update(kwargs)
    req = json.dumps(d)
    ptr = lib.mb_combine(req.encode())
    out = _take_string(lib, ptr)
    if out.startswith('{"error"'):
        raise RuntimeError(json.loads(out)["error"])
    return out
