"""Training runtime of the port (``repro/runtime``): step builders and
the training loop with straggler telemetry. No checkpointing yet."""

from repro_torch.runtime.steps import (  # noqa: F401
    make_eval_step, make_train_step,
)
from repro_torch.runtime.train_loop import (  # noqa: F401
    InjectedFailure, TrainLoop, TrainLoopConfig,
)
