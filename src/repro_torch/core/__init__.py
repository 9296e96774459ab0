"""Control plane of the port: hardware menu, pipeline spec, profiler
(measured, and the reference's analytic backend), traffic envelopes, the Estimator, the Planner and the Tuner
(copies of the reference's ``repro.core``)."""

from repro_torch.core.envelope import (  # noqa: F401
    TrafficEnvelope,
    envelope_windows,
)
from repro_torch.core.hardware import (  # noqa: F401
    HARDWARE_MENU,
    HardwareType,
    cheaper_hardware,
    get_hardware,
)
from repro_torch.core.pipeline import (  # noqa: F401
    SOURCE,
    Edge,
    Pipeline,
    PipelineConfig,
    Stage,
    StageConfig,
    linear_pipeline,
)
from repro_torch.core.profiler import (  # noqa: F401
    ModelProfile,
    ModelSpec,
    ProfileStore,
    profile_model_analytic,
    profile_model_measured,
)

# Estimator/Planner re-exports are lazy (PEP 562): estimator and planner
# pull in repro_torch.sim, which itself imports repro_torch.core.pipeline —
# importing them eagerly here would make `import repro_torch.sim` fail
# when it runs before `import repro_torch.core` (circular package init).
_LAZY_EXPORTS = {
    "Estimator": "repro_torch.core.estimator",
    "SimResult": "repro_torch.core.estimator",
    "Planner": "repro_torch.core.planner",
    "PlannerResult": "repro_torch.core.planner",
}


def __getattr__(name):
    module = _LAZY_EXPORTS.get(name)
    if module is None:
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(module), name)
