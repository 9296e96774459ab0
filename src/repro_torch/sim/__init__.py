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

The device planner sweep comes with a torch backend; until then the
engine runs the numpy fill only.
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
