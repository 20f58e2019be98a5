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
:class:`~.client.ServeClient` (stdlib client). The fleet tier runs:
:class:`~.fleet.PeerCacheClient` (peers' content caches),
:class:`~.router.FleetRouter` (consistent-hash admission, sticky sessions,
handoff to a survivor) and ``cli serve --router``. Several devices and
the sharded tier come with ROADMAP Queue 1 step 4(c).
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
from .fleet import (
    FaultyPeerTransport,
    HashRing,
    PeerCacheClient,
    PeerFaultPlan,
    PeerTransport,
)
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
from .router import FleetRouter, PinBoard, RouterHTTPServer
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
    "PinBoard",
    "TenantQuotaError",
    "TenantQuotas",
    "open_blob_store",
    "DeviceLane",
    "DeviceLanePool",
    "DeviceWorker",
    "FaultyPeerTransport",
    "FleetRouter",
    "GovernorParams",
    "HashRing",
    "Job",
    "JobRejected",
    "JournalStore",
    "LoadShedError",
    "OverloadGovernor",
    "PeerCacheClient",
    "PeerFaultPlan",
    "PeerTransport",
    "ProgramCache",
    "ProgramKey",
    "QueueClosedError",
    "QueueFullError",
    "ReconstructionService",
    "RecoveredState",
    "RouterHTTPServer",
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
