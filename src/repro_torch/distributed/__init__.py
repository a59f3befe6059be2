"""Distributed pieces of the port: the sharded step's collectives
(:mod:`.collectives`) and GPipe over a mesh axis (:mod:`.pipeline`)."""
from repro_torch.distributed.pipeline import gpipe_spmd_pipeline  # noqa: F401
