"""LM serving of the port: the continuous-batching engine over a paged KV
cache (``repro.serve`` minus the partition service)."""
from repro_torch.serve.engine import ServeEngine  # noqa: F401
from repro_torch.serve.paging import (  # noqa: F401
    OutOfPagesError,
    PageManager,
    PagingSpec,
)
