"""repro_torch.serve: the screening service (``repro/serve``, DESIGN.md §10).

A submission daemon over one ``PoolSession``: clients submit
``RunSpec``/``CampaignSpec``s and get ``Ticket``s back at once; the
queue merges compatible submissions into shared dispatches (admission
batching), and a content-addressed result cache, shared with the
reference's on disk, answers repeat submissions with zero dispatches."""
from repro_torch.serve.cache import (CACHE_VERSION, CacheEntry, ResultCache,
                                     cell_digest)
from repro_torch.serve.queue import (CANCELLED, DONE, FAILED, QUEUED,
                                     RUNNING, SubmissionQueue, Ticket,
                                     admission_key, spec_cells)

__all__ = [
    "CACHE_VERSION", "CacheEntry", "ResultCache", "cell_digest",
    "SubmissionQueue", "Ticket", "admission_key", "spec_cells",
    "QUEUED", "RUNNING", "DONE", "CANCELLED", "FAILED",
]
