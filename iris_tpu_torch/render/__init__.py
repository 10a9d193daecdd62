from iris_tpu_torch.render.integrator import (  # noqa: F401
    path_tracing,
    path_tracing_det_diff,
    path_tracing_det_spec,
    path_tracing_single,
    trace_indirect,
)
