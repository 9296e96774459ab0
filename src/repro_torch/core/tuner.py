"""High-frequency Tuner (§5): a copy of the reference's
``repro.core.tuner`` (``tests/test_torch_control.py`` holds its events
equal to the reference's).

Detects arrival-process deviations from the planned workload via traffic
envelopes and re-scales per-model replica counts within seconds.

Scale-up: if any current-envelope rate exceeds the planned envelope, take
the max violating rate r_max and set, per model m,

    k_m = ceil( r_max * s_m / (mu_m * rho_m) )

where s_m is the scale factor, mu_m the single-replica throughput in the
model's current (hw, batch) configuration, and rho_m the max-provisioning
ratio computed at plan time — the "slack" the Planner decided model m
needs to absorb bursts:

    rho_m = (lambda_plan * s_m) / (k_m_plan * mu_m)

(at r_max = lambda_plan this recovers exactly the planned replica count).

Scale-down: conservative — 15 s hysteresis after any configuration change
(3x the 5 s replica activation time), lambda_new = max rate over the last
30 s in 5 s windows, and the pipeline-min rho_p = min_m rho_m.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.control import ControlEvent
from repro_torch.core.envelope import TrafficEnvelope
from repro_torch.core.pipeline import Pipeline, PipelineConfig
from repro_torch.core.profiler import ProfileStore
from repro_torch.sim.result import EpochTelemetry

REPLICA_ACTIVATION_S = 5.0
DOWNSCALE_HYSTERESIS_S = 15.0   # 3x activation time (§5)
DOWNSCALE_OBS_WINDOW_S = 30.0
DOWNSCALE_SUBWINDOW_S = 5.0


@dataclasses.dataclass
class TunerPlanInfo:
    """Everything the Planner hands the Tuner at deployment time (§5)."""

    planned_envelope: TrafficEnvelope
    mu: Dict[str, float]            # single-replica throughput per stage
    rho: Dict[str, float]           # max-provisioning ratio per stage
    scale_factors: Dict[str, float]
    planned_replicas: Dict[str, int]
    service_time_s: float

    @staticmethod
    def from_plan(pipeline: Pipeline, config: PipelineConfig,
                  profiles: ProfileStore, sample_arrivals: np.ndarray,
                  service_time_s: float) -> "TunerPlanInfo":
        arr = np.asarray(sample_arrivals, dtype=np.float64)
        # lam = n / (max - min) diverges when the span is ~0 (0, 1, or
        # simultaneous arrivals); a degenerate sample carries no planned
        # rate, so fall back to rho = 1 (no burst slack: scale exactly to
        # demand) — a tiny rho floor here would make _replicas_for_rate,
        # which divides by rho, explode to millions of replicas on the
        # first real traffic
        duration = float(arr.max() - arr.min()) if arr.size > 1 else 0.0
        lam = arr.size / duration if duration > 1e-9 else 0.0
        s = pipeline.scale_factors()
        mu, rho, k = {}, {}, {}
        for stage, cfg in config.stage_configs.items():
            prof = profiles.get(pipeline.stages[stage].model_id)
            mu_m = prof.throughput(cfg.hardware, cfg.batch_size)
            mu[stage] = mu_m
            k[stage] = cfg.replicas
            lam_m = lam * s[stage]
            rho[stage] = max(lam_m / (cfg.replicas * mu_m), 1e-6) \
                if lam > 0.0 else 1.0
        env = TrafficEnvelope.from_trace(arr, service_time_s)
        return TunerPlanInfo(env, mu, rho, s, k, service_time_s)


class Tuner:
    """Stateful controller; call ``step`` on a fixed cadence (e.g. 1 s)."""

    def __init__(self, plan: TunerPlanInfo,
                 envelope_horizon_s: float = 60.0,
                 min_replicas: int = 1):
        self.plan = plan
        self.horizon = envelope_horizon_s
        self.min_replicas = min_replicas
        self.current: Dict[str, int] = dict(plan.planned_replicas)
        # deployment counts as a configuration change: hysteresis applies
        # from t=0, so the tuner cannot scale DOWN off a sliver of
        # history (a 1 s trace read as a 30 s window halves the fleet)
        self.last_change_t: float = 0.0
        self.rho_p: float = min(plan.rho.values())
        self.events: List[Tuple[float, str, str, int]] = []  # (t, kind, stage, delta)

    # -- required replicas for a given per-pipeline ingress rate ----------
    def _replicas_for_rate(self, rate: float, stage: str, rho: float) -> int:
        s_m = self.plan.scale_factors[stage]
        mu_m = self.plan.mu[stage]
        # the 1e-9 slack keeps the §5 identity k(lambda_plan) == k_plan
        # exact: rho is stored as a float quotient, so the re-division can
        # land one ulp above the integer and ceil would over-scale by one
        # (pinned by the property suite in tests/test_tuner_loop.py)
        return max(self.min_replicas,
                   math.ceil(rate * s_m / (mu_m * rho) - 1e-9))

    def scale_up_targets(self, r_max: float) -> Dict[str, int]:
        """Per-stage replica targets for a violating envelope rate
        ``r_max`` (§5 scale-up rule): never below the current counts."""
        return {
            stage: max(self.current[stage],
                       self._replicas_for_rate(r_max, stage,
                                               self.plan.rho[stage]))
            for stage in self.current
        }

    def detect_violation(self, now: float, arrivals_so_far: np.ndarray
                         ) -> Tuple[bool, float]:
        """Envelope detection over the trailing horizon: (exceeded, r_max)."""
        recent = arrivals_so_far[arrivals_so_far > now - self.horizon]
        cur_env = TrafficEnvelope.from_trace(recent, self.plan.service_time_s)
        return self.plan.planned_envelope.exceeded_by(cur_env)

    def downscale_rate(self, now: float, arrivals_so_far: np.ndarray,
                       obs_window_s: float = DOWNSCALE_OBS_WINDOW_S,
                       subwindow_s: float = DOWNSCALE_SUBWINDOW_S) -> float:
        """lambda_new for the conservative scale-down rule: the max rate
        over the trailing ``obs_window_s`` in ``subwindow_s`` windows."""
        obs = arrivals_so_far[arrivals_so_far > now - obs_window_s]
        if obs.size == 0:
            return 0.0
        edges = np.arange(now - obs_window_s, now + subwindow_s, subwindow_s)
        counts, _ = np.histogram(obs, bins=edges)
        return float(counts.max()) / subwindow_s

    def step(self, now: float, arrivals_so_far: np.ndarray
             ) -> Dict[str, int]:
        """Observe ingress arrivals up to `now`; return target replica counts.

        The caller (live cluster / real frontend) applies the deltas, adding
        REPLICA_ACTIVATION_S before a new replica serves traffic.
        """
        arr = arrivals_so_far
        target = dict(self.current)

        # ---- scale up (immediate) ----------------------------------------
        exceeded, r_max = self.detect_violation(now, arr)
        if exceeded:
            for stage, k_needed in self.scale_up_targets(r_max).items():
                if k_needed > target[stage]:
                    target[stage] = k_needed

        up = {s: k for s, k in target.items() if k > self.current[s]}
        if up:
            for stage, k in up.items():
                self.events.append((now, "up", stage, k - self.current[stage]))
                self.current[stage] = k
            self.last_change_t = now
            return dict(self.current)

        # ---- scale down (hysteresis-guarded) ------------------------------
        if now - self.last_change_t < DOWNSCALE_HYSTERESIS_S:
            return dict(self.current)
        if now < DOWNSCALE_OBS_WINDOW_S:
            # no full observation window yet — the windowed-max rate
            # would undercount and trigger a spurious scale-down
            return dict(self.current)
        lam_new = self.downscale_rate(now, arr)
        changed = False
        for stage in target:
            k_needed = self._replicas_for_rate(lam_new, stage, self.rho_p)
            if k_needed < self.current[stage]:
                self.events.append(
                    (now, "down", stage, k_needed - self.current[stage]))
                self.current[stage] = k_needed
                changed = True
        if changed:
            self.last_change_t = now
        return dict(self.current)


def run_tuner_offline(
    tuner: Tuner,
    arrivals: np.ndarray,
    t_end: Optional[float] = None,
    interval_s: float = 1.0,
    activation_delay_s: float = REPLICA_ACTIVATION_S,
) -> Dict[str, List[Tuple[float, int]]]:
    """Drive the tuner over a full trace; emit per-stage replica events.

    The Tuner's decisions depend only on the ingress arrival process (§5),
    so the full scaling schedule can be computed ahead of the pipeline
    simulation and handed to the Estimator engine as replica_schedules.
    Scale-ups take effect after `activation_delay_s`; scale-downs are
    immediate (replicas drain and retire).
    """
    arrivals = np.asarray(arrivals, dtype=np.float64)
    t_end = t_end if t_end is not None else (
        float(arrivals.max()) if arrivals.size else 0.0)
    schedules: Dict[str, List[Tuple[float, int]]] = {
        s: [] for s in tuner.current
    }
    before = dict(tuner.current)
    t = interval_s
    while t <= t_end + 1e-9:
        seen = arrivals[arrivals <= t]
        after = tuner.step(t, seen)
        for stage, k in after.items():
            delta = k - before[stage]
            if delta > 0:
                schedules[stage].append((t + activation_delay_s, delta))
            elif delta < 0:
                schedules[stage].append((t, delta))
        before = after
        t += interval_s
    # scale-ups land at t + activation_delay_s while scale-downs land at
    # t, so a down issued within activation_delay_s of an up would appear
    # *before* it in emission order — the engine's _ReplicaPool.apply_events
    # assumes a time-sorted (t, +/-1) stream, so merge-sort each schedule
    for evs in schedules.values():
        evs.sort(key=lambda e: e[0])
    return schedules


# -- closed-loop controllers (repro_torch.sim.control epoch stepping) ------------


class OpenLoopTunerController:
    """Adapter: drives the ingress-only :class:`Tuner` through the
    closed-loop runner (:class:`repro_torch.sim.control.ControlLoopSession`).

    Feedback telemetry is ignored by construction — each epoch boundary
    calls ``tuner.step(t, arrivals <= t)`` exactly as
    :func:`run_tuner_offline` does, so the accumulated schedule is
    guaranteed identical to the precomputed one (guarded in
    ``tests/test_tuner_loop.py``). This is the bridge that lets the old
    open-loop path and new closed-loop controllers run under one driver.
    """

    def __init__(self, tuner: Tuner,
                 activation_delay_s: float = REPLICA_ACTIVATION_S):
        self.tuner = tuner
        self.activation_delay_s = activation_delay_s

    @property
    def current(self) -> Dict[str, int]:
        return dict(self.tuner.current)

    def step(self, tele: EpochTelemetry) -> List[ControlEvent]:
        now = tele.t_end
        before = dict(self.tuner.current)
        after = self.tuner.step(now, tele.ingress_prefix)
        events: List[ControlEvent] = []
        for stage, k in after.items():
            delta = k - before[stage]
            if delta > 0:
                events.append(ControlEvent(
                    now, now + self.activation_delay_s, stage, "up", delta))
            elif delta < 0:
                events.append(ControlEvent(now, now, stage, "down", delta))
        return events


class ClosedLoopTuner(Tuner):
    """Telemetry-driven Tuner: §5's envelope rules plus engine feedback.

    ``step(telemetry) -> [ControlEvent]`` consumes one
    :class:`~repro_torch.sim.result.EpochTelemetry` record per control epoch
    and layers four feedback behaviors on the ingress-only base rules.
    The interface is the runtime-agnostic controller contract
    (:mod:`repro_torch.control`): the same instance drives the co-simulation
    loop (:class:`repro_torch.sim.control.ControlLoopSession`) and the real
    thread-pool executor (:class:`repro_torch.serving.loop.LiveControlLoop`)
    unchanged — ``chip_smoke.py`` phase 4d scales the served cascade's
    replicas on the card with it.

    * **corroborated scale-up** — the ingress-only tuner trusts the
      envelope unconditionally; because the envelope carries a 60 s
      memory while the scale-down rate window forgets in 30 s, every
      absorbed burst leaves it in a down/up oscillation (downscale,
      re-detect the stale violation, re-upscale — observed on every
      spike trace). With engine feedback a violation is only acted on
      when *something corroborates it*: live backlog, observed misses,
      or a trailing short-window ingress rate above the planned rate.
      A true onset always corroborates (the rate or the queue is up);
      a stale echo of a drained burst never does.
    * **backlog-drain boost** — queue depths are observable, so when a
      stage's backlog exceeds ``queue_grace_s`` seconds of its current
      fleet's service capacity (the regime after a spike outruns the
      activation delay), request enough extra replicas to drain it
      within ``drain_target_s`` while absorbing the current offered
      rate. The envelope rule provisions for the violating *rate* only
      and is blind to the queue already accumulated during the
      activation gap; under low-burstiness overload (r_max close to
      the sustained rate) that leaves a many-second drain during which
      every queued query misses. The boost sizes itself against the
      queue *projected at activation time* (current backlog plus the
      activation delay's worth of inflow the still-active fleet cannot
      absorb) and then holds off one activation delay before boosting
      again, so it neither fights the gap with stale numbers nor
      ladders requests against replicas that are still spinning up.
    * **telemetry-gated early scale-down** — the open-loop rule needs a
      30 s max-rate window because ingress alone cannot prove the system
      has digested a burst; observed (near-)empty queues can, so with
      backlog below ``down_backlog_grace_s`` seconds of service the
      trailing-rate window shrinks to ``down_obs_window_s``. The
      ``DOWNSCALE_HYSTERESIS_S`` guard is inherited untouched (a
      property-tested invariant).
    * **admission control** — for stages running the ``slo-drop``
      policy (``shed_stages``), sustained observed misses raise the
      shed margin to ``shed_margin_s`` (drop queries ``margin`` short
      of viability, keeping queues from poisoning viable work) and
      recovery lowers it back to 0. Shed events land immediately: no
      activation delay applies to turning work away.

    Replica invariants (property-tested): scale-up targets are monotone
    in the violating rate, the planned rate recovers the planned counts,
    no scale-down fires within ``DOWNSCALE_HYSTERESIS_S`` of any
    replica-configuration change, and counts never fall below
    ``min_replicas`` (>= 1).
    """

    def __init__(self, plan: TunerPlanInfo,
                 envelope_horizon_s: float = 60.0,
                 min_replicas: int = 1,
                 activation_delay_s: float = REPLICA_ACTIVATION_S,
                 drain_target_s: float = 5.0,
                 queue_grace_s: float = 1.0,
                 down_obs_window_s: float = 15.0,
                 down_backlog_grace_s: float = 1.0,
                 max_replicas: Optional[int] = None,
                 shed_stages: Tuple[str, ...] = (),
                 shed_margin_s: float = 0.02,
                 shed_on_miss: float = 0.05,
                 shed_off_miss: float = 0.005,
                 shed_patience: int = 3,
                 up_rate_slack: float = 1.15,
                 up_miss_floor: float = 0.01,
                 failure_recovery: bool = True):
        super().__init__(plan, envelope_horizon_s, min_replicas)
        self.activation_delay_s = activation_delay_s
        self.up_rate_slack = up_rate_slack
        self.up_miss_floor = up_miss_floor
        # sustained planned rate: the widest envelope window's rate
        self.lam_plan = (float(plan.planned_envelope.rates[-1])
                         if plan.planned_envelope.windows.size else 0.0)
        self.drain_target_s = drain_target_s
        self.queue_grace_s = queue_grace_s
        self.down_obs_window_s = down_obs_window_s
        self.down_backlog_grace_s = down_backlog_grace_s
        self.max_replicas = max_replicas
        self.shed_stages = tuple(shed_stages)
        self.shed_margin_s = shed_margin_s
        self.shed_on_miss = shed_on_miss
        self.shed_off_miss = shed_off_miss
        self.shed_patience = max(int(shed_patience), 1)
        self.shed_active = False
        self.last_boost_t = 0.0  # deployment: boosts wait one activation
        self._shed_hot = 0
        self._shed_cool = 0
        # failure-aware re-provisioning: observed capacity loss (the
        # telemetry `alive` field falling below the target) emits
        # replacement ups through the same ControlEvent path
        self.failure_recovery = failure_recovery
        # in-flight scale-ups (t_effective, n) per stage — replicas the
        # fold has already promised but telemetry cannot see yet; the
        # loss computation must not mistake them for crashes
        self._pending_ups: Dict[str, List[Tuple[float, int]]] = {}

    # -- feedback signals --------------------------------------------------
    def _backlog_seconds(self, tele: EpochTelemetry) -> float:
        """Total queued work, in seconds of current-fleet service."""
        total = 0.0
        for stage, st in tele.stages.items():
            mu = self.plan.mu[stage]
            k = max(self.current[stage], 1)
            total += st.queue_depth / (mu * k)
        return total

    def step(self, tele: EpochTelemetry) -> List[ControlEvent]:  # type: ignore[override]
        now = tele.t_end
        epoch_len = max(tele.t_end - tele.t_start, 1e-9)
        arr = tele.ingress_prefix
        events: List[ControlEvent] = []
        target = dict(self.current)

        # ---- envelope scale-up (§5 rule, telemetry-corroborated) --------
        exceeded, r_max = self.detect_violation(now, arr)
        if exceeded:
            # 2 s subwindows: wide enough that same-law sampling noise
            # stays inside the slack, narrow enough that a genuine step
            # or burst trips it within one control epoch
            r_recent = self.downscale_rate(now, arr, obs_window_s=6.0,
                                           subwindow_s=2.0)
            rate_elevated = r_recent > self.up_rate_slack * self.lam_plan
            corroborated = (
                rate_elevated
                or tele.miss_fraction > self.up_miss_floor
                or self._backlog_seconds(tele) > self.queue_grace_s)
            if corroborated:
                # distress without an elevated ingress rate means the
                # envelope's r_max is (or may be) a stale echo of an
                # already-absorbed burst: respond to the rate actually
                # observed, and let the backlog boost size the drain
                r_eff = r_max if rate_elevated else min(
                    r_max, max(r_recent, self.lam_plan))
                for stage, k in self.scale_up_targets(r_eff).items():
                    if k > target[stage]:
                        target[stage] = k

        # ---- backlog-drain boost (feedback) -----------------------------
        boosted = False
        if now >= self.last_boost_t + self.activation_delay_s:
            rate = tele.ingress / epoch_len
            for stage, st in tele.stages.items():
                mu = self.plan.mu[stage]
                active = max(st.replicas, self.min_replicas)
                if st.queue_depth <= self.queue_grace_s * mu * active:
                    continue
                inflow = rate * self.plan.scale_factors[stage]
                # queue the fleet will face when a boost activates: the
                # current backlog plus whatever the activation delay adds
                # beyond what the currently-active replicas absorb
                q_proj = st.queue_depth + max(
                    inflow - active * mu, 0.0) * self.activation_delay_s
                k_drain = math.ceil(
                    (q_proj / self.drain_target_s + inflow) / mu)
                k_drain = max(self.min_replicas, k_drain)
                if k_drain > target[stage]:
                    target[stage] = k_drain
                    boosted = True

        if self.max_replicas is not None:
            cap = max(self.max_replicas, self.min_replicas)
            for stage in target:
                target[stage] = min(target[stage], cap)

        up = {s: k for s, k in target.items() if k > self.current[s]}
        for stage, k in up.items():
            delta = k - self.current[stage]
            self.current[stage] = k
            self.events.append((now, "up", stage, delta))
            events.append(ControlEvent(
                now, now + self.activation_delay_s, stage, "up", delta))
            self._pending_ups.setdefault(stage, []).append(
                (now + self.activation_delay_s, delta))
        if up:
            self.last_change_t = now
            if boosted:
                self.last_boost_t = now

        # ---- failure recovery (capacity-loss replacement ups) -----------
        if self.failure_recovery:
            for stage, st in tele.stages.items():
                alive = getattr(st, "alive", -1)
                if alive is None or alive < 0:
                    continue        # telemetry without fault tracking
                pend = [(te, n) for (te, n)
                        in self._pending_ups.get(stage, []) if te > now]
                self._pending_ups[stage] = pend
                # current = the count the control schedule will reach
                # once every pending up activates; alive = what the
                # fleet actually carries now. The difference beyond the
                # still-activating ups is crash loss to replace.
                # Replacement ups do NOT bump self.current — the intent
                # is unchanged; the fold's schedule absorbs the deltas.
                lost = (self.current[stage] - alive
                        - sum(n for _, n in pend))
                if lost > 0:
                    t_eff = now + self.activation_delay_s
                    pend.append((t_eff, lost))
                    self.events.append((now, "up", stage, lost))
                    events.append(ControlEvent(now, t_eff, stage, "up",
                                               lost))
                    self.last_change_t = now

        # ---- admission control (slo-drop shed margin) -------------------
        if self.shed_stages:
            overloaded = tele.miss_fraction >= self.shed_on_miss
            recovered = (tele.miss_fraction <= self.shed_off_miss
                         and self._backlog_seconds(tele)
                         <= self.down_backlog_grace_s)
            self._shed_hot = self._shed_hot + 1 if overloaded else 0
            self._shed_cool = self._shed_cool + 1 if recovered else 0
            if not self.shed_active and self._shed_hot >= self.shed_patience:
                self.shed_active = True
                for stage in self.shed_stages:
                    self.events.append((now, "shed", stage,
                                        self.shed_margin_s))
                    events.append(ControlEvent(now, now, stage, "shed",
                                               self.shed_margin_s))
            elif self.shed_active and self._shed_cool >= self.shed_patience:
                self.shed_active = False
                for stage in self.shed_stages:
                    self.events.append((now, "shed", stage, 0.0))
                    events.append(ControlEvent(now, now, stage, "shed", 0.0))

        # ---- scale down (hysteresis-guarded, telemetry-gated) -----------
        if up or now - self.last_change_t < DOWNSCALE_HYSTERESIS_S:
            return events
        if now < self.down_obs_window_s:
            return events
        if self._backlog_seconds(tele) > self.down_backlog_grace_s:
            # ingress may look calm while queues still carry a burst —
            # exactly the blind spot the open-loop 30 s window papers
            # over; with telemetry we simply refuse to scale down
            return events
        lam_new = self.downscale_rate(now, arr, self.down_obs_window_s)
        changed = False
        for stage in self.current:
            # per-stage rho, not the pipeline-min rho_p: the base rule's
            # conservatism guards against imbalance ingress can't see
            # (one stage overprovisioned by design pins every OTHER
            # stage's scale-down target above its current count
            # forever); with verified-empty queues the stage's own
            # planned slack is the right target
            k_needed = self._replicas_for_rate(lam_new, stage,
                                               self.plan.rho[stage])
            if k_needed < self.current[stage]:
                delta = k_needed - self.current[stage]
                self.current[stage] = k_needed
                self.events.append((now, "down", stage, delta))
                events.append(ControlEvent(now, now, stage, "down", delta))
                changed = True
        if changed:
            self.last_change_t = now
        return events
