"""Architecture registry of the port. Importing this package registers
every architecture it serves; ``get_config("<id>")`` / ``--arch <id>``
selects one."""

from repro_torch.configs.base import (  # noqa: F401
    ModelConfig, get_config, get_smoke_config,
)

from repro_torch.configs import qwen3_0_6b  # noqa: F401
