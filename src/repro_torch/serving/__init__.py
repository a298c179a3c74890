"""Serving engines of the port: ``DecodeEngine``, continuous batching
over fixed decode-state slots with its request lifecycle, speculative
rounds, prefix cache and fork (``engine.py``, ``lifecycle.py``,
``speculative.py``, ``prefix_cache.py``, through the backends of
``backends/``), its write-ahead ``Journal`` (``journal.py``) and the
``FleetEngine`` of replicated slot groups with failover (``fleet.py``),
and ``LookupEngine``, the paper's encode-once / look-up-many memory
serving, with ``HedgedLookup`` over its replicas (``lookup_engine.py``)."""

from repro_torch.serving.backends import (  # noqa: F401
    DecodeBackend,
    FixedStateBackend,
    Mamba2Backend,
    RWKV6Backend,
    SoftmaxKVBackend,
    backend_for_config,
    get_backend_cls,
    list_backends,
    register_backend,
)
from repro_torch.serving.engine import (  # noqa: F401
    Completion,
    DecodeEngine,
    EngineStats,
    Request,
)
from repro_torch.serving.fleet import (  # noqa: F401
    FleetEngine,
    ReplicaState,
    fleet_demo_config,
)
from repro_torch.serving.journal import (  # noqa: F401
    Journal,
    read_journal,
)
from repro_torch.serving.lifecycle import (  # noqa: F401
    SHED_POLICIES,
    STATUS_CANCELLED,
    STATUS_DEADLINE,
    STATUS_FAILED,
    STATUS_OK,
    STATUS_SHED,
    Checkpoint,
    FaultInjector,
    InjectedCrash,
    SuspendedRequest,
)
from repro_torch.serving.lookup_engine import (  # noqa: F401
    HedgedLookup,
    LinearLookupBackend,
    LookupBackend,
    LookupEngine,
    LookupRequest,
    LookupResult,
    LookupStats,
    SoftmaxLookupBackend,
    get_lookup_backend,
    register_lookup_backend,
)
from repro_torch.serving.speculative import (  # noqa: F401
    DraftProvider,
    ModelDraft,
    NgramDraft,
    ReplayDraft,
)
