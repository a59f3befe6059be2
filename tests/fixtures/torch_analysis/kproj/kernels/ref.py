"""KERNEL-CONTRACT fixture: the plain versions.  Parsed by the rule engine
in tests, never imported."""


def good(x):
    return x


def short_list(x):
    return x


def short_call(x):
    return x


def fallback(x):
    return x


def unchecked(x):
    return x
