"""KERNEL-CONTRACT fixture: the wrappers.  'short_call' launches with one
argument too few; 'fallback' gives way to the plain version when the
launch fails.  Parsed by the rule engine in tests, never imported."""
from kernels import build, ref

LAUNCHES = {"good": 0, "short_list": 0, "short_call": 0, "fallback": 0,
            "unchecked": 0}


def _launch(name, *args):
    build.library(name).launch(*args)
    LAUNCHES[name] += 1


def _on_cpu(*tensors):
    return all(t.device.type == "cpu" for t in tensors)


def good(x):
    if _on_cpu(x):
        return ref.good(x)
    y = x.new_empty(x.shape)
    _launch("good", 0, x.data_ptr(), y.data_ptr(), x.numel(), None)
    return y


def short_list(x):
    if _on_cpu(x):
        return ref.short_list(x)
    y = x.new_empty(x.shape)
    args = (x.data_ptr(), y.data_ptr(), x.numel(), None)
    _launch("short_list", 0, *args)
    return y


def short_call(x):
    if _on_cpu(x):
        return ref.short_call(x)
    y = x.new_empty(x.shape)
    _launch("short_call", 0, x.data_ptr(), y.data_ptr(), None)
    return y


def fallback(x):
    y = x.new_empty(x.shape)
    try:
        _launch("fallback", 0, x.data_ptr(), y.data_ptr(), x.numel(), None)
    except RuntimeError:
        return ref.fallback(x)
    return y


def unchecked(x):
    if _on_cpu(x):
        return ref.unchecked(x)
    y = x.new_empty(x.shape)
    _launch("unchecked", 0, x.data_ptr(), y.data_ptr(), x.numel(), None)
    return y
