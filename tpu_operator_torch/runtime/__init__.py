"""The operator's runtime: the client contract, the in-memory fake
apiserver, the informer cache, the workqueue, tracing, and the manager
that drives reconcilers from watch events (the reference's
``tpu_operator/runtime/__init__.py`` exports, less ``EvictionBlockedError``,
which comes with the upgrade controller)."""

from .client import (  # noqa: F401
    AlreadyExistsError,
    ApiError,
    Client,
    ConflictError,
    InvalidError,
    ListOptions,
    NotFoundError,
    PagedList,
    ServerUnavailableError,
    TooManyRequestsError,
    WatchEvent,
)
from .cache import CachedClient, Index  # noqa: F401
from .fake import FakeClient  # noqa: F401
from .manager import (  # noqa: F401
    Controller,
    Manager,
    Reconciler,
    Request,
    Result,
    any_event,
    enqueue_constant,
    enqueue_object,
    enqueue_owner,
    generation_changed,
    label_changed,
)
from .manager import (  # noqa: F401
    ThrottledWriteClient,
    env_shards,
    shard_of,
)
from .tracing import TRACER, Tracer, TracingClient  # noqa: F401
from .workqueue import (  # noqa: F401
    LANE_BULK,
    LANE_HEALTH,
    LANE_PLACEMENT,
    LANES,
    RateLimiter,
    WorkQueue,
    WriteBudget,
)
