"""KERNEL-CONTRACT fixture: the on-card check, which holds every kernel but
'unchecked' against its plain version.  Parsed by the rule engine in
tests, never imported."""
from kernels import ops, ref


def kernel_phase(x):
    for want, got in ((ref.good(x), ops.good(x)),
                      (ref.short_list(x), ops.short_list(x)),
                      (ref.short_call(x), ops.short_call(x)),
                      (ref.fallback(x), ops.fallback(x))):
        assert (want == got).all()
