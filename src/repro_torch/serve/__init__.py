"""Serving of the port (``repro.serve``): the continuous-batching LM engine
over a paged KV cache, and the multi-tenant partition service (bucketed
batch solves, the routed V-cycle, keyed warm resubmits, watchdog
supervision)."""
from repro_torch.serve.engine import ServeEngine  # noqa: F401
from repro_torch.serve.paging import (  # noqa: F401
    OutOfPagesError,
    PageManager,
    PagingSpec,
)
from repro_torch.serve.partition_service import (  # noqa: F401
    Bucket,
    PartitionService,
    ServiceResult,
    stack_device_batch,
)
