from repro_torch.baselines.coarse_grained import (  # noqa: F401
    CGPlanner,
    CGTuner,
    cg_plan,
)
from repro_torch.baselines.ds2 import DS2Tuner  # noqa: F401
