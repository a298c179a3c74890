"""Pipeline parallelism (port of ``repro/pipeline``): a GPipe schedule
over a ``stage`` mesh axis."""

from repro_torch.pipeline.gpipe import (  # noqa: F401
    gpipe_loss_fn, make_pipeline_mesh, pipeline_compatible,
    place_pipeline_params,
)
