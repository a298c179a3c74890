"""DecodeBackend registry (port of ``repro/serving/backends/__init__.py``):
the seam between the engine's scheduling and a family's state layout.

Importing this package registers the ported backends; dispatch goes
through :func:`backend_for_config` (by priority, so import order never
decides). Ported: ``FixedStateBackend`` (the linear and gated-linear
families), ``SoftmaxKVBackend`` (the softmax baseline's KV cache) and
``RWKV6Backend`` (pure RWKV-6 stacks); the Mamba-2 backend is not
(ROADMAP A.4).
"""

from repro_torch.serving.backends.base import (  # noqa: F401
    DecodeBackend,
    backend_for_config,
    register_backend,
)
# concrete backends (import = register)
from repro_torch.serving.backends.fixed_state import (  # noqa: F401
    FixedStateBackend,
)
from repro_torch.serving.backends.rwkv6 import (  # noqa: F401
    RWKV6Backend,
)
from repro_torch.serving.backends.softmax_kv import (  # noqa: F401
    SoftmaxKVBackend,
)
