"""Architecture registry of the port. Importing this package registers
every architecture it serves; ``get_config("<id>")`` / ``--arch <id>``
selects one."""

from repro_torch.configs.base import (  # noqa: F401
    ModelConfig, MoEConfig, RWKVConfig, SSMConfig, ShapeConfig, SHAPES,
    get_config, get_smoke_config, list_architectures,
)

# one module per architecture (registration side effects)
from repro_torch.configs import deepseek_moe_16b    # noqa: F401
from repro_torch.configs import qwen3_moe_235b_a22b  # noqa: F401
from repro_torch.configs import qwen3_0_6b           # noqa: F401
from repro_torch.configs import llama3_2_vision_90b  # noqa: F401
from repro_torch.configs import musicgen_large       # noqa: F401
from repro_torch.configs import yi_34b               # noqa: F401
from repro_torch.configs import internlm2_20b        # noqa: F401
from repro_torch.configs import phi3_mini_3_8b       # noqa: F401
from repro_torch.configs import rwkv6_1_6b           # noqa: F401
from repro_torch.configs import zamba2_7b            # noqa: F401
from repro_torch.configs import paper_qa             # noqa: F401
