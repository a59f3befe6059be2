"""Multi-tenant paged serving of the PyTorch port."""
from repro_torch.serve.engine import (  # noqa: F401
    AdmissionEvent, BASE_ADAPTER, Request, ServeEngine,
)
from repro_torch.serve.kv_cache import (  # noqa: F401
    OutOfPages, PagedKVCache, TRASH_PAGE,
)
