"""Observability of the port: the :class:`Tracker` every layer reports
through (:mod:`repro_torch.obs.tracker`)."""
from repro_torch.obs.tracker import (  # noqa: F401
    NOOP, NULL_SPAN, SCHEMA_VERSION, CompositeTracker, InMemoryTracker,
    JsonlTracker, NoopTracker, Tracker, read_jsonl, replay)
