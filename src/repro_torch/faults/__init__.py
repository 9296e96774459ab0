"""Deterministic fault injection for both serving worlds: a copy of the
reference's ``repro.faults``, held bit-equal to it by
``tests/test_torch_faults.py``.

`repro_torch.faults` defines seedable fault schedules — replica crashes,
straggler slowdown windows, transient per-batch stage errors — plus the
recovery policy (bounded exponential-backoff retries, optional hedged
duplicates near the deadline) that both backends honor:

* the discrete-event engine folds a :class:`FaultSchedule` into its
  per-stage simulation (``repro_torch.faults.simstage``) and into the
  cone cache keys (``TraceSession._stage_key``), exactly like replica/
  shed/policy schedules;
* the wall-clock executor (:mod:`repro_torch.serving.executor`) kills and
  slows real workers on the same schedule — threads, or with
  ``backend="process"`` worker processes it SIGKILLs — and runs the same
  retry/hedge/requeue machinery on live requests.

Everything is deterministic under a fixed seed (per-stage substreams),
so a fault scenario replays bit-identically in simulation and lands on
the same final fleet when the closed-loop tuner re-provisions around it
(``chip_smoke.py`` phase 4f checks this on the card).
"""

from repro_torch.faults.schedule import (
    Fault,
    FaultSchedule,
    InjectedFault,
    RecoveryPolicy,
    StageFaults,
    crash,
    straggle,
    transient,
)

__all__ = [
    "Fault",
    "FaultSchedule",
    "InjectedFault",
    "RecoveryPolicy",
    "StageFaults",
    "crash",
    "straggle",
    "transient",
]
