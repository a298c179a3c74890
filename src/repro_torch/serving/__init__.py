"""Serving engines of the port: ``DecodeEngine``, continuous batching
over fixed decode-state slots (``engine.py``, through the backends of
``backends/``), and ``LookupEngine``, the paper's encode-once /
look-up-many memory serving (``lookup_engine.py``)."""

from repro_torch.serving.backends import (  # noqa: F401
    DecodeBackend, FixedStateBackend, backend_for_config, register_backend,
)
from repro_torch.serving.engine import (  # noqa: F401
    Completion, DecodeEngine, EngineStats, Request,
)
from repro_torch.serving.lookup_engine import (  # noqa: F401
    LookupEngine, get_lookup_backend, register_lookup_backend,
)
