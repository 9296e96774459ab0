"""repro_torch.sim — the unified incremental discrete-event simulation core.

A copy of the reference's ``repro.sim``: one engine for the Estimator
façade and the Planner/BeamPlanner/AnnealedPlanner search loops.

* :mod:`repro_torch.sim.engine`   — SimEngine + TraceSession (incremental
  per-stage memoization, ``simulate_delta`` / ``simulate_many``,
  ``stage_states`` queue snapshots)
* :mod:`repro_torch.sim.queueing` — pluggable per-stage policies: ``fifo``
  (paper + timeout batching), ``edf`` (deadline scheduling),
  ``slo-drop`` (SLO-aware load shedding w/ reprogrammable shed margin)
* :mod:`repro_torch.sim.result`   — per-query SimResult (+ dropped mask),
  per-epoch EpochTelemetry / StageTelemetry control records
* :mod:`repro_torch.sim.control`  — closed-loop Tuner co-simulation: epoch
  stepping (ControlLoopSession), ControlEvent, replica cost timelines
* :mod:`repro_torch.sim.torch_backend` — the planner's device sweep: the
  FIFO fill on the hand-written CUDA kernel (``kernels/csrc/sim_fill.cu``,
  a thread per candidate) and the (hw, batch, replica, timeout) grid
  scored in one launch, bit-identical to the numpy kernels. Opt in per
  session via ``SimEngine.session(..., backend="torch", device=...)``
  (default ``"numpy"``); eligible ``percentile_many`` grids then fill on
  the card (``device=None``; on a host without a GPU that raises) or
  through the kernel's plain torch version (``device="cpu"``).
"""

from repro_torch.sim.control import (  # noqa: F401
    ClosedLoopResult,
    ControlEvent,
    ControlLoopSession,
    NoOpController,
    ScheduleController,
    replica_cost_timeline,
)
from repro_torch.sim.engine import (  # noqa: F401
    DEFAULT_RPC_DELAY_S,
    SimEngine,
    StageState,
    TraceSession,
)
from repro_torch.sim.queueing import (  # noqa: F401
    QUEUE_POLICIES,
    get_policy,
    simulate_stage,
)
from repro_torch.sim.result import (  # noqa: F401
    EpochTelemetry,
    SimResult,
    StageTelemetry,
)
