"""Multi-tenant paged serving of the PyTorch port: streaming admission
with SLO-aware preemption, chunked prefill, per-request sampling,
speculative decoding, ``n > 1`` parallel completions, and the live adapter
lifecycle (hot-swap banks, serve-while-train)."""
from repro_torch.serve.engine import (  # noqa: F401
    BASE_ADAPTER, AdmissionEvent, PreemptionEvent, Request, ServeEngine)
from repro_torch.serve.lifecycle import (  # noqa: F401
    AdapterFeed, AdapterLifecycle, BankSwapEvent)
from repro_torch.serve.kv_cache import (  # noqa: F401
    OutOfPages, PagedKVCache, TRASH_PAGE)
from repro_torch.serve.sampling import (  # noqa: F401
    MAX_LOGPROBS, SamplingParams, TokenLogprobs)
from repro_torch.serve.scheduler import (  # noqa: F401
    StreamScheduler, TokenCostModel)
from repro_torch.serve.spec import BASE_DRAFT, SpecConfig  # noqa: F401
from repro_torch.obs.tracker import (  # noqa: F401
    NOOP, NULL_SPAN, SCHEMA_VERSION, CompositeTracker, InMemoryTracker,
    JsonlTracker, NoopTracker, Tracker, read_jsonl, replay)
