"""KERNEL-CONTRACT fixture: a test holding every wrapper against its
plain version.  Named without a test_ prefix so pytest never collects it."""
from kernels import ops, ref


def check_wrappers(x):
    for want, got in ((ref.good(x), ops.good(x)),
                      (ref.short_list(x), ops.short_list(x)),
                      (ref.short_call(x), ops.short_call(x)),
                      (ref.fallback(x), ops.fallback(x)),
                      (ref.unchecked(x), ops.unchecked(x))):
        assert (want == got).all()
