"""Training runtime of the port (``repro/runtime``): step builders, the
fault-tolerant training loop (auto-resume, async and preemption
checkpoints, failure injection), straggler detection and the elastic
re-mesh planner."""

from repro_torch.runtime.elastic import (  # noqa: F401
    accum_for_batch, plan_mesh_shape,
)
from repro_torch.runtime.steps import (  # noqa: F401
    make_decode_step, make_eval_step, make_prefill_step, make_train_step,
)
from repro_torch.runtime.straggler import StragglerDetector  # noqa: F401
from repro_torch.runtime.train_loop import (  # noqa: F401
    InjectedFailure, TrainLoop, TrainLoopConfig,
)
