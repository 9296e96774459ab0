from repro_torch.workload.generator import (  # noqa: F401
    gamma_trace,
    time_varying_trace,
    cv_ramp_trace,
    rate_ramp_trace,
)
from repro_torch.workload.slo_classes import (  # noqa: F401
    ClassedTrace,
    SLOClass,
    classed_trace,
)
from repro_torch.workload.traces import autoscale_derived_trace  # noqa: F401
