"""DecodeBackend registry (port of ``repro/serving/backends/__init__.py``):
the seam between the engine's scheduling and a family's state layout.

Importing this package registers the ported backends; dispatch goes
through :func:`backend_for_config` (by priority, so import order never
decides): ``FixedStateBackend`` (the linear and gated-linear families,
hybrids with Mamba-2 blocks among them), ``SoftmaxKVBackend`` (the
softmax baseline's KV cache), ``Mamba2Backend`` (pure Mamba-2 stacks)
and ``RWKV6Backend`` (pure RWKV-6 stacks); ``list_backends`` and
``get_backend_cls`` read the registry.
"""

from repro_torch.serving.backends.base import (  # noqa: F401
    DecodeBackend,
    backend_for_config,
    get_backend_cls,
    list_backends,
    register_backend,
)
# concrete backends (import = register)
from repro_torch.serving.backends.fixed_state import (  # noqa: F401
    FixedStateBackend,
)
from repro_torch.serving.backends.mamba2 import (  # noqa: F401
    Mamba2Backend,
)
from repro_torch.serving.backends.rwkv6 import (  # noqa: F401
    RWKV6Backend,
)
from repro_torch.serving.backends.softmax_kv import (  # noqa: F401
    SoftmaxKVBackend,
)
