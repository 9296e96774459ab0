from repro_torch.workload.generator import gamma_trace  # noqa: F401
from repro_torch.workload.slo_classes import (  # noqa: F401
    ClassedTrace,
    SLOClass,
    classed_trace,
)
