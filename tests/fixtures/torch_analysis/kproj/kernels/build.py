"""KERNEL-CONTRACT fixture: the ctypes view of each C entry point.

'short_list' declares one int argtype too few.  Parsed by the rule engine
in tests, never imported.
"""
import ctypes

SOURCES = ("good", "short_list", "short_call", "fallback", "unchecked")
_P = ctypes.c_void_p
_I = ctypes.c_int
ENTRY_POINTS = {
    "good": ("good_launch", [_I] + [_P] * 2 + [_I, _P]),
    "short_list": ("short_list_launch", [_I] + [_P] * 2 + [_P]),
    "short_call": ("short_call_launch", [_I, _P, _P, _I, _P]),
    "fallback": ("fallback_launch", [_I] + [_P] * 2 + [_I] + [_P]),
    "unchecked": ("unchecked_launch", [_I, _P, _P, _I, _P]),
}
