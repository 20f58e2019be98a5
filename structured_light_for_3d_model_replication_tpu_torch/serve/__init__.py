"""Continuous-batching reconstruction service, one replica (counterpart of
the JAX package's ``serve/``).

Data path::

    client ── POST /submit ──▶ AdmissionQueue (bounded; priorities,
                               deadlines, reject-with-retry-after)
                   │
                   ▼
             BucketBatcher     pads (H, W) up to a configured bucket,
                               coalesces same-bucket jobs into B ∈
                               {1, 2, 4, 8} batches, flushes on
                               batch-full or max-linger
                   │
                   ▼
             ProgramCache      ``models/pipeline.reconstruct_batch`` bound
                               to one (bucket, batch, device), built and
                               run once on a zero batch at warmup; LRU
                               eviction, hit/miss counters; pinned staging
                   │
                   ▼
             DeviceWorker(s)   launch the batch (the ``decode_maps``
                               kernel once per batch on the card), read
                               back once, per-job postprocess (compact →
                               PLY, or the models/meshing tail → STL),
                               per-job fault containment on the health
                               taxonomy

The HTTP front end is a stdlib ``ThreadingHTTPServer``, metrics ride
`utils/trace.MetricsRegistry`, and errors are `health.ScanFault` subclasses
so one poisoned stack degrades that job, not the process.

Entry points: ``python -m structured_light_for_3d_model_replication_tpu_torch.cli
serve`` (front end), :class:`~.service.ReconstructionService` (in-process),
:class:`~.client.ServeClient` (stdlib client). The fleet tier (``fleet.py``,
``router.py``), several devices, the sharded tier and peer caches come with
ROADMAP Queue 1 step 4(b).
"""

from .batcher import Batch, BucketBatcher, BucketKey, bucket_for
from .blobstore import (
    BlobFaultPlan,
    BlobStore,
    FaultyBlobStore,
    HTTPObjectClient,
    InMemoryObjectClient,
    LocalDirStore,
    ObjectStore,
    ObjectStoreServer,
    open_blob_store,
)
from .cache import ContentCache, ProgramCache, ProgramKey, content_key
from .client import ServeClient, TransportError
from .governor import BreakerOpenError, CircuitBreaker, GovernorParams, \
    LoadShedError, OverloadGovernor
from .jobs import (
    AdmissionQueue,
    Job,
    JobRejected,
    QueueClosedError,
    QueueFullError,
    ServeError,
    StackFormatError,
)
from .lanes import DeviceLane, DeviceLanePool
from .service import ReconstructionService, ServeConfig, ServeHTTPServer
from .sessions import SessionLimitError, SessionManager, UnknownSessionError
from .store import JournalStore, RecoveredState, SessionStreamStore, \
    read_live_state
from .tenants import TenantQuotaError, TenantQuotas
from .worker import DeviceWorker

__all__ = [
    "AdmissionQueue",
    "Batch",
    "BlobFaultPlan",
    "BlobStore",
    "BreakerOpenError",
    "BucketBatcher",
    "BucketKey",
    "CircuitBreaker",
    "ContentCache",
    "FaultyBlobStore",
    "HTTPObjectClient",
    "InMemoryObjectClient",
    "LocalDirStore",
    "ObjectStore",
    "ObjectStoreServer",
    "TenantQuotaError",
    "TenantQuotas",
    "open_blob_store",
    "DeviceLane",
    "DeviceLanePool",
    "DeviceWorker",
    "GovernorParams",
    "Job",
    "JobRejected",
    "JournalStore",
    "LoadShedError",
    "OverloadGovernor",
    "ProgramCache",
    "ProgramKey",
    "QueueClosedError",
    "QueueFullError",
    "ReconstructionService",
    "RecoveredState",
    "ServeClient",
    "ServeConfig",
    "ServeError",
    "ServeHTTPServer",
    "SessionLimitError",
    "SessionManager",
    "SessionStreamStore",
    "StackFormatError",
    "TransportError",
    "UnknownSessionError",
    "bucket_for",
    "content_key",
    "read_live_state",
]
