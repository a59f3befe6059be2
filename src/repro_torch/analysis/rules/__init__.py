"""Rule modules — importing this package populates the registry."""
from . import deprecation, hostsync, kernels, obsgate, rng  # noqa: F401
