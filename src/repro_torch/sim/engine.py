"""Unified incremental discrete-event engine (the one simulation core).

Every consumer — the Estimator façade (:mod:`repro_torch.core.estimator`)
and the Planner/BeamPlanner/AnnealedPlanner search — drives this engine.
A copy of the reference's ``repro.sim.engine``. Its device grid runs on
the port's CUDA fill kernel: a session opened with ``backend="torch"``
scores eligible candidate grids in ``percentile_many`` through
:func:`repro_torch.sim.torch_backend.grid_stage_percentiles` on the
session's ``device``, where the reference's ``backend="jax"`` goes
through ``repro.sim.jax_backend`` (``"jax"`` raises here). Fault
schedules (:class:`repro_torch.faults.FaultSchedule`) run as the
reference's do. ``tests/test_torch_plan.py`` and
``tests/test_torch_sim_backend.py`` hold it bit-identical to the
reference.

Engine design (recorded in EXPERIMENTS.md §Perf): the paper implements a
global event heap over the whole pipeline. Because (a) routing is
feed-forward (DAG) and (b) the centralized batched queue at a stage
depends only on that stage's input arrival times and its own replica
schedule, we simulate *stage-by-stage in topological order*; each stage
is one single-queue / R-server / batch-service system handled by a
pluggable queueing policy (:mod:`repro_torch.sim.queueing`).

Incremental re-simulation: a :class:`TraceSession` binds the engine to
one arrival trace and memoizes per-stage outcomes keyed on the stage's
*configuration cone* — the (hardware, batch, replicas, timeout, policy,
schedule) of the stage and every ancestor. A planner action that mutates
one stage therefore re-simulates only that stage's downstream cone; all
sibling branches and upstream stages are cache hits. Combined with the
LUT/routing-draw caches this is what makes thousands of candidate
evaluations per plan cheap (the reference's ``BENCH_engine.json``
records a ≥5x plan wall-clock win on its CPU host), while remaining
bit-identical to full re-simulation.
"""

from __future__ import annotations

import collections
from typing import Dict, Iterable, List, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.core.pipeline import SOURCE, Pipeline, PipelineConfig
from repro_torch.core.policy import effective_max_batch as _effective_max_batch
from repro_torch.core.profiler import ProfileStore
from repro_torch.device import resolve_device
from repro_torch.sim.queueing import simulate_stage
from repro_torch.sim.result import SimResult

# Per-hop RPC/serialization delay. The frontend adapters (Fig. 13) override
# this: the "tfs"-style frontend carries extra serialization overhead.
DEFAULT_RPC_DELAY_S = 0.0005

Schedule = Sequence[Tuple[float, int]]
Schedules = Dict[str, Schedule]
# piecewise-constant shed-margin schedules for slo-drop stages
# (see the repro_torch.sim.queueing module docstring)
ShedSchedule = Sequence[Tuple[float, float]]
ShedSchedules = Dict[str, ShedSchedule]
# piecewise queueing-policy switch schedules (repro_torch.core.policy): a stage
# with a non-empty schedule simulates through the policy-core scalar
# path (repro_torch.sim.queueing.switched) instead of its dedicated kernel
PolicySchedule = Sequence[Tuple[float, str]]
PolicySchedules = Dict[str, PolicySchedule]


def _sched_key(sched: Optional[Schedule]) -> Tuple:
    return tuple((float(t), int(d)) for t, d in sched) if sched else ()


def _shed_key(sched: Optional[ShedSchedule]) -> Tuple:
    return tuple((float(t), float(m)) for t, m in sched) if sched else ()


def _policy_key(sched: Optional[PolicySchedule]) -> Tuple:
    return tuple((float(t), str(p)) for t, p in sched) if sched else ()


def _fault_key(spec) -> Tuple:
    """Cache-key component for one stage's fault spec
    (:class:`repro_torch.faults.schedule.StageFaults`); faults change stage
    outcomes just like replica/shed/policy schedules, so they must reach
    the cone keys (KEY01)."""
    if spec is None:
        return ()
    return (int(spec.seed), spec.recovery.key(), tuple(
        (str(kind), float(t0), float(t1), float(v))
        for kind, t0, t1, v in spec.events))


class SimEngine:
    """Stateless pipeline simulator + shared caches (LUTs, routing draws).

    Use :meth:`simulate` for one-shot runs, or open a :meth:`session` on a
    trace to get incremental re-simulation across many configurations.
    """

    def __init__(
        self,
        pipeline: Pipeline,
        profiles: ProfileStore,
        rpc_delay_s: float = DEFAULT_RPC_DELAY_S,
        seed: int = 0,
    ):
        self.pipeline = pipeline
        self.profiles = profiles
        self.rpc_delay_s = rpc_delay_s
        self.seed = seed
        self._topo = pipeline.toposort()
        self._edges_in: Dict[str, List] = {
            s: [e for e in pipeline.edges if e.dst == s] for s in self._topo
        }
        # ancestors incl. self (topo-ordered) — the memoization cone
        anc_sets: Dict[str, set] = {}
        for s in self._topo:
            ups: set = {s}
            for e in self._edges_in[s]:
                if e.src != SOURCE:
                    ups |= anc_sets[e.src]
            anc_sets[s] = ups
        topo_idx = {s: i for i, s in enumerate(self._topo)}
        self._cone: Dict[str, Tuple[str, ...]] = {
            s: tuple(sorted(anc_sets[s], key=topo_idx.__getitem__))
            for s in self._topo
        }
        self._descendants: Dict[str, Tuple[str, ...]] = {
            s: tuple(t for t in self._topo if s in anc_sets[t])
            for s in self._topo
        }
        self._longest_path = pipeline.longest_path_stages()
        self._lut_cache: Dict[Tuple[str, str, int], np.ndarray] = {}
        self._draw_cache: Dict[int, Dict[Tuple[str, str], np.ndarray]] = {}
        self._service_time_cache: Dict[Tuple, float] = {}

    # -- shared caches ------------------------------------------------------
    def latency_lut(self, stage: str, hardware: str, max_batch: int
                    ) -> np.ndarray:
        model_id = self.pipeline.stages[stage].model_id
        key = (model_id, hardware, max_batch)
        lut = self._lut_cache.get(key)
        if lut is None:
            prof = self.profiles.get(model_id)
            lut = prof.latency_lut(hardware, max_batch)
            self._lut_cache[key] = lut
        return lut

    def edge_draws(self, n: int) -> Dict[Tuple[str, str], np.ndarray]:
        """Pre-sampled Bernoulli outcomes per (edge, query).

        Fixed seed => identical routing across candidate configurations
        (the paper reuses one sample trace across the whole search), and
        across repeat calls, so draws are cached per trace length.
        """
        draws = self._draw_cache.get(n)
        if draws is None:
            rng = np.random.default_rng(self.seed)
            draws = {}
            for e in self.pipeline.edges:
                if e.probability >= 1.0:
                    draws[(e.src, e.dst)] = np.ones(n, dtype=bool)
                else:
                    draws[(e.src, e.dst)] = rng.random(n) < e.probability
            self._draw_cache[n] = draws
        return draws

    # -- public API ---------------------------------------------------------
    def session(self, arrivals: np.ndarray,
                slo_s: Optional[Union[float, np.ndarray]] = None,
                class_ids: Optional[np.ndarray] = None,
                class_names: Optional[Sequence[str]] = None,
                max_cache_entries: int = 512,
                max_cache_bytes: Optional[int] = None,
                max_accum_bytes: Optional[int] = None,
                backend: str = "numpy",
                device=None) -> "TraceSession":
        """Bind the engine to one trace for incremental re-simulation.

        ``slo_s`` may be a scalar (uniform SLO, the paper's setting) or a
        per-query vector for mixed SLO classes; ``class_ids`` /
        ``class_names`` tag queries for per-class ``SimResult``
        breakdowns (see :mod:`repro_torch.workload.slo_classes`).
        ``max_accum_bytes=0`` disables the prefix-accumulator cache
        (the pre-batching assembly behavior; benchmarks use it as the
        honest "loop path" baseline).

        ``backend="torch"`` selects the CUDA fill kernel
        (:mod:`repro_torch.sim.torch_backend`) on ``device`` (None: CUDA,
        which raises on a host without a GPU; ``"cpu"`` runs the
        kernel's plain torch version): single-stage simulations stay on
        numpy below the kernel's crossover, and
        :meth:`TraceSession.percentile_many` additionally routes
        eligible single-stage candidate grids through one device launch.
        Bit-identical either way.
        """
        return TraceSession(self, arrivals, slo_s=slo_s,
                            class_ids=class_ids, class_names=class_names,
                            max_cache_entries=max_cache_entries,
                            max_cache_bytes=max_cache_bytes,
                            max_accum_bytes=max_accum_bytes,
                            backend=backend, device=device)

    def simulate(
        self,
        config: PipelineConfig,
        arrivals: np.ndarray,
        replica_schedules: Optional[Schedules] = None,
        slo_s: Optional[Union[float, np.ndarray]] = None,
        class_ids: Optional[np.ndarray] = None,
        class_names: Optional[Sequence[str]] = None,
        shed_schedules: Optional[ShedSchedules] = None,
        policy_schedules: Optional[PolicySchedules] = None,
        fault_schedules=None,
    ) -> SimResult:
        """One-shot simulation (fresh session; no cross-call memoization)."""
        return self.session(arrivals, slo_s=slo_s, class_ids=class_ids,
                            class_names=class_names).simulate(
            config, replica_schedules=replica_schedules,
            shed_schedules=shed_schedules,
            policy_schedules=policy_schedules,
            fault_schedules=fault_schedules)

    def service_time(self, config: PipelineConfig) -> float:
        """Sum of batch-size-configured latencies along the longest path
        (queueing excluded) — Alg. 1's `ServiceTime`. Memoized on the
        path's (hw, batch) assignment."""
        key = tuple((s, config[s].hardware, config[s].batch_size)
                    for s in self._longest_path)
        cached = self._service_time_cache.get(key)
        if cached is None:
            total = 0.0
            for stage in self._longest_path:
                cfg = config[stage]
                prof = self.profiles.get(self.pipeline.stages[stage].model_id)
                total += prof.batch_latency(cfg.hardware, cfg.batch_size)
                total += self.rpc_delay_s
            cached = total + self.rpc_delay_s
            self._service_time_cache[key] = cached
        return cached

    def descendants(self, stage: str) -> Tuple[str, ...]:
        """`stage` plus everything downstream of it (the re-sim cone)."""
        return self._descendants[stage]


class StageState:
    """Per-query view of one stage's queue for control-loop telemetry.

    All arrays are aligned to the query index of the bound trace:
    ``visited`` marks queries that reach the stage, ``ready`` their
    input-queue arrival instants (0 where not visited), ``completion``
    their stage completion (-inf not visited, +inf shed), ``dropped``
    the stage's shed mask (or None).
    """

    __slots__ = ("visited", "ready", "completion", "dropped")

    def __init__(self, visited, ready, completion, dropped):
        self.visited = visited
        self.ready = ready
        self.completion = completion
        self.dropped = dropped


class _StageEntry:
    __slots__ = ("visited", "completion", "batches", "dropped", "nbytes")

    def __init__(self, visited, completion, batches, dropped):
        self.visited = visited
        self.completion = completion
        self.batches = batches
        self.dropped = dropped        # None or full-length bool mask
        self.nbytes = (visited.nbytes + completion.nbytes + batches.nbytes
                       + (dropped.nbytes if dropped is not None else 0))


class TraceSession:
    """The engine bound to one arrival trace, with per-stage memoization.

    ``simulate`` / ``simulate_delta`` / ``simulate_many`` share one
    cache: evaluating a candidate that differs from any previously-seen
    configuration in one stage re-simulates only that stage's downstream
    cone. ``stats`` counts actual stage simulations vs cache hits so
    callers (and tests) can verify incrementality.
    """

    # stage-cache byte budget: entries hold full-trace-length arrays, so
    # a pure entry-count cap would scale memory with trace length
    # (512 entries x an hour-long trace ~ GBs); evict to stay under this
    DEFAULT_CACHE_BYTES = 256 * 1024 * 1024
    # accumulator (prefix) cache: one last_done array per distinct
    # stage-key prefix — smaller entries, tighter budget
    DEFAULT_ACCUM_BYTES = 64 * 1024 * 1024

    def __init__(self, engine: SimEngine, arrivals: np.ndarray,
                 slo_s: Optional[Union[float, np.ndarray]] = None,
                 class_ids: Optional[np.ndarray] = None,
                 class_names: Optional[Sequence[str]] = None,
                 max_cache_entries: int = 512,
                 max_cache_bytes: Optional[int] = None,
                 max_accum_bytes: Optional[int] = None,
                 backend: str = "numpy",
                 device=None):
        if backend not in ("numpy", "torch"):
            raise ValueError(f"unknown backend {backend!r}; "
                             f"have ('numpy', 'torch')")
        self.backend = backend
        # the torch backend's device, resolved now so that a session that
        # cannot reach it raises before it simulates anything
        self.device = resolve_device(device) if backend == "torch" else None
        # the last device grid's counts (torch_backend
        # .grid_stage_percentiles): chunks, launches, lanes, queries
        self.grid_split: Dict[str, int] = {}
        self.engine = engine
        self.arrivals = np.asarray(arrivals, dtype=np.float64)
        self.n = int(self.arrivals.shape[0])
        self.slo_s = slo_s
        # scalar slo_s = uniform deadline (seed semantics, bit-identical:
        # arrivals + scalar and arrivals + broadcast vector are the same
        # float64 adds); a (n,) vector carries mixed per-query SLO classes
        if slo_s is None:
            self.slo_per_query: Optional[np.ndarray] = None
            self.deadline: Optional[np.ndarray] = None
        else:
            slo_arr = np.asarray(slo_s, dtype=np.float64)
            if slo_arr.ndim == 0:
                slo_arr = np.full(self.n, float(slo_arr))
            elif slo_arr.shape != (self.n,):
                raise ValueError(
                    f"slo_s must be a scalar or shape ({self.n},) vector, "
                    f"got shape {slo_arr.shape}")
            self.slo_per_query = slo_arr
            self.deadline = self.arrivals + slo_arr
        if class_ids is None:
            self.class_ids: Optional[np.ndarray] = None
        else:
            self.class_ids = np.asarray(class_ids, dtype=np.int64)
            if self.class_ids.shape != (self.n,):
                raise ValueError(
                    f"class_ids must have shape ({self.n},), got "
                    f"{self.class_ids.shape}")
        self.class_names = tuple(class_names) if class_names else None
        self.draws = engine.edge_draws(self.n)
        self.max_cache_entries = max_cache_entries
        self.max_cache_bytes = (max_cache_bytes if max_cache_bytes is not None
                                else self.DEFAULT_CACHE_BYTES)
        self._cache_bytes = 0
        self._stage_cache: "collections.OrderedDict[Tuple, _StageEntry]" = \
            collections.OrderedDict()
        # scalar percentile memo; capped too (keys are full config tuples,
        # and long annealing sessions evaluate thousands of configs)
        self._pctl_cache: "collections.OrderedDict[Tuple, float]" = \
            collections.OrderedDict()
        self._max_pctl_entries = max(4096, 8 * max_cache_entries)
        # prefix-accumulator cache: (last_done, dropped) keyed on the
        # topo-ordered tuple of stage keys up to a stage. Candidates that
        # share a configuration prefix (the planner's probe grids differ
        # in one stage) skip the shared part of result assembly, not just
        # the shared stage simulations. 0 bytes disables it (the
        # pre-batching "loop" behavior, kept honest for benchmarks).
        self.max_accum_bytes = (max_accum_bytes if max_accum_bytes is not None
                                else self.DEFAULT_ACCUM_BYTES)
        self._accum_cache: "collections.OrderedDict[Tuple, Tuple]" = \
            collections.OrderedDict()
        self._accum_bytes = 0
        self.stats = {"full_sims": 0, "stage_sims": 0, "stage_hits": 0,
                      "accum_hits": 0}

    # -- cache keys ---------------------------------------------------------
    def _stage_key(self, stage: str, config: PipelineConfig,
                   schedules: Optional[Schedules],
                   shed_schedules: Optional[ShedSchedules] = None,
                   policy_schedules: Optional[PolicySchedules] = None,
                   fault_schedules=None) -> Tuple:
        # StageConfig.key() is the single source of truth for config
        # identity — new StageConfig knobs invalidate these caches
        # automatically instead of silently colliding. The backend token
        # keeps device- and host-computed entries apart (they are
        # bit-identical by contract, but a parity regression must not be
        # maskable by a cache hit from the other backend).
        sched = schedules or {}
        shed = shed_schedules or {}
        pols = policy_schedules or {}
        faults = fault_schedules
        return (stage, self.backend, tuple(
            (s, config[s].key(), _sched_key(sched.get(s)),
             _shed_key(shed.get(s)), _policy_key(pols.get(s)),
             _fault_key(faults.stage(s) if faults else None))
            for s in self.engine._cone[stage]
        ))

    @staticmethod
    def config_key(config: PipelineConfig,
                   schedules: Optional[Schedules] = None,
                   shed_schedules: Optional[ShedSchedules] = None,
                   policy_schedules: Optional[PolicySchedules] = None
                   ) -> Tuple:
        if not schedules and not shed_schedules and not policy_schedules:
            return config.cache_key()
        return (config.cache_key(), tuple(sorted(
            (s, _sched_key(sch)) for s, sch in (schedules or {}).items())),
            tuple(sorted((s, _shed_key(sch))
                         for s, sch in (shed_schedules or {}).items())),
            tuple(sorted((s, _policy_key(sch))
                         for s, sch in (policy_schedules or {}).items())))

    # -- simulation ---------------------------------------------------------
    def _stage_ready(
        self,
        stage: str,
        visited: Dict[str, np.ndarray],
        completion: Dict[str, np.ndarray],
    ) -> Tuple[np.ndarray, np.ndarray]:
        """(visited mask, ready times) of a stage's input queue, from its
        parents' outcomes. Factored out of the stage simulation so the
        control-loop telemetry (:meth:`stage_states`) reconstructs the
        exact same queue the policy saw."""
        engine = self.engine
        n = self.n
        vis = np.zeros(n, dtype=bool)
        ready = np.zeros(n, dtype=np.float64)
        for e in engine._edges_in[stage]:
            deliver = completion[e.src] + engine.rpc_delay_s
            active = visited[e.src] & self.draws[(e.src, e.dst)]
            # shed queries complete at +inf and never reach children
            # (-inf = not visited, already excluded by the visited mask)
            active &= np.isfinite(completion[e.src])
            # AND-join over active parents
            ready = np.where(active, np.maximum(ready, deliver), ready)
            vis |= active
        return vis, ready

    def _simulate_stage_entry(
        self,
        stage: str,
        config: PipelineConfig,
        schedules: Optional[Schedules],
        visited: Dict[str, np.ndarray],
        completion: Dict[str, np.ndarray],
        shed_schedules: Optional[ShedSchedules] = None,
        policy_schedules: Optional[PolicySchedules] = None,
        fault_schedules=None,
    ) -> _StageEntry:
        engine = self.engine
        n = self.n
        vis, ready = self._stage_ready(stage, visited, completion)
        k = int(vis.sum())
        if k == 0:
            return _StageEntry(vis, np.full(n, -np.inf),
                               np.zeros(0, dtype=np.int64), None)
        cfg = config[stage]
        lut = engine.latency_lut(stage, cfg.hardware, cfg.batch_size)
        idx = np.nonzero(vis)[0]
        order = idx[np.argsort(ready[idx], kind="stable")]
        sorted_ready = ready[order]
        sorted_deadline = (self.deadline[order]
                           if self.deadline is not None else None)
        # a stage with a policy-switch schedule routes through the
        # policy-core scalar path; everything else hits its dedicated
        # (vectorized/hoisted) kernel as before
        done_sorted, batches, dropped_sorted = simulate_stage(
            getattr(cfg, "policy", "fifo"),
            sorted_ready, lut, cfg.batch_size, cfg.replicas,
            (schedules or {}).get(stage),
            getattr(cfg, "timeout_s", 0.0), sorted_deadline,
            (shed_schedules or {}).get(stage),
            (policy_schedules or {}).get(stage),
            backend=self.backend,
            fault_spec=(fault_schedules.stage(stage)
                        if fault_schedules else None),
            device=self.device,
        )
        comp = np.full(n, -np.inf)
        comp[order] = done_sorted
        drop_mask = None
        if dropped_sorted.any():
            drop_mask = np.zeros(n, dtype=bool)
            drop_mask[order] = dropped_sorted
        return _StageEntry(vis, comp, batches, drop_mask)

    def simulate(
        self,
        config: PipelineConfig,
        replica_schedules: Optional[Schedules] = None,
        shed_schedules: Optional[ShedSchedules] = None,
        policy_schedules: Optional[PolicySchedules] = None,
        fault_schedules=None,
    ) -> SimResult:
        """Run the trace through the configured pipeline.

        Per-stage results are memoized on the stage's configuration cone,
        so repeat calls with partially-overlapping configurations only
        simulate the stages whose cone actually changed.

        ``fault_schedules`` (a :class:`repro_torch.faults.FaultSchedule`)
        adds deterministic crash/straggle/error disruptions; its per-stage
        components are part of the cone cache keys.
        """
        engine = self.engine
        n = self.n
        self.stats["full_sims"] += 1
        visited: Dict[str, np.ndarray] = {SOURCE: np.ones(n, dtype=bool)}
        completion: Dict[str, np.ndarray] = {SOURCE: self.arrivals}
        # ingress counts as t0; np.where below never mutates, so the
        # arrivals array itself is a safe accumulator base
        last_done = self.arrivals
        per_stage_batches: Dict[str, np.ndarray] = {}
        dropped: Optional[np.ndarray] = None
        accum_on = self.max_accum_bytes > 0
        acc_key: Tuple = ()

        for stage in engine._topo:
            skey = self._stage_key(stage, config, replica_schedules,
                                   shed_schedules, policy_schedules,
                                   fault_schedules)
            ent = self._stage_cache.get(skey)
            if ent is None:
                ent = self._simulate_stage_entry(
                    stage, config, replica_schedules, visited, completion,
                    shed_schedules, policy_schedules, fault_schedules)
                self._stage_cache[skey] = ent
                self._cache_bytes += ent.nbytes
                self.stats["stage_sims"] += 1
                while self._stage_cache and (
                        len(self._stage_cache) > self.max_cache_entries
                        or self._cache_bytes > self.max_cache_bytes):
                    _, old = self._stage_cache.popitem(last=False)
                    self._cache_bytes -= old.nbytes
            else:
                self._stage_cache.move_to_end(skey)
                self.stats["stage_hits"] += 1
            visited[stage] = ent.visited
            completion[stage] = ent.completion
            per_stage_batches[stage] = ent.batches
            if accum_on:
                acc_key = acc_key + (skey,)
                cached = self._accum_cache.get(acc_key)
                if cached is not None:
                    self._accum_cache.move_to_end(acc_key)
                    self.stats["accum_hits"] += 1
                    last_done, dropped = cached
                    continue
            vis = ent.visited
            if vis.any():
                last_done = np.where(
                    vis, np.maximum(last_done, ent.completion), last_done)
            if ent.dropped is not None:
                dropped = (ent.dropped if dropped is None
                           else dropped | ent.dropped)
            if accum_on:
                self._accum_store(acc_key, last_done, dropped)

        latency = last_done - self.arrivals + engine.rpc_delay_s  # reply hop
        return SimResult(self.arrivals, latency, per_stage_batches, dropped,
                         class_ids=self.class_ids,
                         class_names=self.class_names,
                         slo_s=self.slo_per_query)

    def stage_states(
        self,
        config: PipelineConfig,
        replica_schedules: Optional[Schedules] = None,
        shed_schedules: Optional[ShedSchedules] = None,
        policy_schedules: Optional[PolicySchedules] = None,
        fault_schedules=None,
    ) -> Dict[str, StageState]:
        """Per-stage queue views for the configured simulation — what the
        closed-loop telemetry (the tuner's epoch stepping) samples at epoch
        boundaries. Runs (or replays from the stage cache) the same
        simulation as :meth:`simulate`; the ready times are reconstructed
        with the identical :meth:`_stage_ready` computation, so queue
        depths derived from them match what the queueing policy saw."""
        engine = self.engine
        n = self.n
        visited: Dict[str, np.ndarray] = {SOURCE: np.ones(n, dtype=bool)}
        completion: Dict[str, np.ndarray] = {SOURCE: self.arrivals}
        out: Dict[str, StageState] = {}
        for stage in engine._topo:
            skey = self._stage_key(stage, config, replica_schedules,
                                   shed_schedules, policy_schedules,
                                   fault_schedules)
            ent = self._stage_cache.get(skey)
            if ent is None:
                ent = self._simulate_stage_entry(
                    stage, config, replica_schedules, visited, completion,
                    shed_schedules, policy_schedules, fault_schedules)
                self._stage_cache[skey] = ent
                self._cache_bytes += ent.nbytes
                self.stats["stage_sims"] += 1
                while self._stage_cache and (
                        len(self._stage_cache) > self.max_cache_entries
                        or self._cache_bytes > self.max_cache_bytes):
                    _, old = self._stage_cache.popitem(last=False)
                    self._cache_bytes -= old.nbytes
            else:
                self._stage_cache.move_to_end(skey)
            vis, ready = self._stage_ready(stage, visited, completion)
            visited[stage] = ent.visited
            completion[stage] = ent.completion
            out[stage] = StageState(vis, ready, ent.completion, ent.dropped)
        return out

    def _accum_store(self, acc_key: Tuple, last_done: np.ndarray,
                     dropped: Optional[np.ndarray]) -> None:
        nb = last_done.nbytes + (dropped.nbytes if dropped is not None else 0)
        self._accum_cache[acc_key] = (last_done, dropped)
        self._accum_bytes += nb
        while self._accum_cache and self._accum_bytes > self.max_accum_bytes:
            _, (old_ld, old_dr) = self._accum_cache.popitem(last=False)
            self._accum_bytes -= old_ld.nbytes + (
                old_dr.nbytes if old_dr is not None else 0)

    def simulate_delta(
        self,
        config: PipelineConfig,
        changed_stage: Optional[str] = None,
    ) -> SimResult:
        """Re-simulate after mutating ``changed_stage`` of a previously
        simulated configuration: only the changed stage's downstream cone
        is recomputed (everything else hits the per-stage cache).

        ``changed_stage`` is a documentation/verification hint — the cone
        cache keys make the incrementality automatic either way.
        """
        return self.simulate(config)

    def simulate_many(
        self,
        configs: Iterable[PipelineConfig],
        replica_schedules: Optional[Schedules] = None,
        shed_schedules: Optional[ShedSchedules] = None,
    ) -> List[SimResult]:
        """Batched candidate evaluation (the planner's scoring surface).

        The candidate set is grouped by shared cone keys implicitly:
        every distinct stage entry is simulated exactly once (stage
        cache), result assembly is shared across candidates with common
        configuration prefixes (accumulator cache), and duplicate
        candidates collapse to one evaluation. Element-wise equal to
        ``[self.simulate(c) for c in configs]`` — property-tested in
        ``tests/test_sim_engine.py``.
        """
        seen: Dict[Tuple, SimResult] = {}
        out: List[SimResult] = []
        for config in configs:
            ck = self.config_key(config, replica_schedules, shed_schedules)
            res = seen.get(ck)
            if res is None:
                res = self.simulate(config, replica_schedules,
                                    shed_schedules)
                seen[ck] = res
            out.append(res)
        return out

    def percentile_many(
        self,
        configs: Sequence[PipelineConfig],
        p: float,
        replica_schedules: Optional[Schedules] = None,
    ) -> List[float]:
        """Percentile scoring for a candidate set — what the planner's
        probe grids and binary searches consume. One scalar per
        candidate; each miss simulates through the same shared machinery
        as ``simulate_many`` (stage entries computed once per distinct
        cone, assembly shared across common prefixes, results memoized
        in the percentile cache).

        With ``backend="torch"`` a candidate set that varies exactly one
        *sink* FIFO stage — the shape of every planner probe grid and
        lockstep replica search — is additionally scored by two launches
        a chunk, the CUDA fill and select kernels
        (:func:`repro_torch.sim.torch_backend
        .grid_stage_percentiles`): the fixed stages simulate once on
        host, the varied stage's (lut, batch, replicas, timeout) grid
        fills on the device, a warp a candidate, each candidate's two
        order statistics are selected there, and the host interpolates
        the percentiles. Bit-identical to the host loop; ineligible sets
        fall through to it.
        """
        configs = list(configs)
        if self.backend == "torch" and not replica_schedules:
            out = self._grid_percentile_many(configs, p)
            if out is not None:
                return out
        return [self.percentile(c, p, replica_schedules) for c in configs]

    def _grid_percentile_many(self, configs: List[PipelineConfig],
                              p: float) -> Optional[List[float]]:
        """Device-grid scoring of an eligible candidate set, or None.

        Eligible: enough uncached distinct candidates and a long enough
        trace to beat the launch and copies; the candidates differ in
        exactly one stage; that stage is a sink (no descendants), so
        every other stage's entry is candidate-invariant and the
        accumulated completion maximum over the rest of the pipeline is
        a single shared array; the varied stage runs plain FIFO with a
        static pool and non-negative profiled latencies (the sorted-pool
        kernel's contract).
        """
        from repro_torch.sim import torch_backend

        uncached: Dict[Tuple, PipelineConfig] = {}
        for c in configs:
            ck = self.config_key(c)
            if (self.backend, ck, p) not in self._pctl_cache:
                uncached.setdefault(ck, c)
        if len(uncached) < torch_backend._GRID_MIN_CANDIDATES:
            return None
        cands = list(uncached.values())
        pivot = cands[0]
        engine = self.engine
        varied = [s for s in engine._topo
                  if any(c[s].key() != pivot[s].key() for c in cands[1:])]
        if len(varied) != 1:
            return None
        s = varied[0]
        if engine._descendants[s] != (s,):
            return None
        luts: List[np.ndarray] = []
        effs: List[int] = []
        reps: List[int] = []
        touts: List[float] = []
        for c in cands:
            cfg = c[s]
            if (getattr(cfg, "policy", "fifo") != "fifo"
                    or cfg.replicas < 1):
                return None
            lut = engine.latency_lut(s, cfg.hardware, cfg.batch_size)
            eff = _effective_max_batch(lut, cfg.batch_size)
            if float(np.min(lut[1:eff + 1])) < 0.0:
                return None
            luts.append(lut)
            effs.append(eff)
            reps.append(int(cfg.replicas))
            touts.append(float(getattr(cfg, "timeout_s", 0.0)))
        # host pass over the candidate-invariant stages: populate/reuse
        # their cache entries and accumulate the completion maximum.
        # Skipping the sink is exact — `last_done` is an element-wise
        # max, so folding the sink's completions in afterwards commutes.
        n = self.n
        visited: Dict[str, np.ndarray] = {SOURCE: np.ones(n, dtype=bool)}
        completion: Dict[str, np.ndarray] = {SOURCE: self.arrivals}
        base_last = self.arrivals
        for stage in engine._topo:
            if stage == s:
                continue
            skey = self._stage_key(stage, pivot, None)
            ent = self._stage_cache.get(skey)
            if ent is None:
                ent = self._simulate_stage_entry(stage, pivot, None,
                                                 visited, completion)
                self._stage_cache[skey] = ent
                self._cache_bytes += ent.nbytes
                self.stats["stage_sims"] += 1
                while self._stage_cache and (
                        len(self._stage_cache) > self.max_cache_entries
                        or self._cache_bytes > self.max_cache_bytes):
                    _, old = self._stage_cache.popitem(last=False)
                    self._cache_bytes -= old.nbytes
            else:
                self._stage_cache.move_to_end(skey)
                self.stats["stage_hits"] += 1
            visited[stage] = ent.visited
            completion[stage] = ent.completion
            if ent.visited.any():
                base_last = np.where(
                    ent.visited, np.maximum(base_last, ent.completion),
                    base_last)
        vis, ready = self._stage_ready(s, visited, completion)
        k = int(vis.sum())
        if k < torch_backend._GRID_MIN_QUERIES:
            return None
        idx = np.nonzero(vis)[0]
        order = idx[np.argsort(ready[idx], kind="stable")]
        vals = torch_backend.grid_stage_percentiles(
            ready[order], order, base_last, self.arrivals,
            engine.rpc_delay_s, luts, effs, reps, touts, p, self.device,
            split=self.grid_split)
        self.stats["full_sims"] += len(cands)
        self.stats["stage_sims"] += len(cands)
        for ck, v in zip(uncached, vals):
            self._pctl_cache[(self.backend, ck, p)] = float(v)
        while len(self._pctl_cache) > self._max_pctl_entries:
            self._pctl_cache.popitem(last=False)
        return [self.percentile(c, p) for c in configs]

    def percentile(self, config: PipelineConfig, p: float,
                   replica_schedules: Optional[Schedules] = None,
                   shed_schedules: Optional[ShedSchedules] = None) -> float:
        """Memoized latency percentile per full configuration (the scalar
        the planner's feasibility checks consume — subsumes the seed
        planner's whole-config ``_cache``)."""
        key = (self.backend,
               self.config_key(config, replica_schedules, shed_schedules), p)
        val = self._pctl_cache.get(key)
        if val is None:
            val = self.simulate(config, replica_schedules,
                                shed_schedules).percentile(p)
            self._pctl_cache[key] = val
            if len(self._pctl_cache) > self._max_pctl_entries:
                self._pctl_cache.popitem(last=False)
        else:
            self._pctl_cache.move_to_end(key)
        return val

    def class_percentile(self, config: PipelineConfig, p: float,
                         class_id: int,
                         replica_schedules: Optional[Schedules] = None
                         ) -> float:
        """Memoized latency percentile over one class's queries — the
        scalar the multi-class planner objective consumes. One cache miss
        simulates once and fills the entry for EVERY class (the planner
        always probes all classes per candidate), so the per-candidate
        cost stays one simulation regardless of class count. A class with
        no queries reports 0.0 (trivially feasible)."""
        if self.class_ids is None:
            raise ValueError("session has no class_ids; open the session "
                             "with class tags for per-class percentiles")
        cfg_key = (self.backend, self.config_key(config, replica_schedules))
        key = (cfg_key, p, ("class", int(class_id)))
        val = self._pctl_cache.get(key)
        if val is None:
            res = self.simulate(config, replica_schedules)
            for cid in np.unique(self.class_ids):
                sel = res.latency[self.class_ids == cid]
                v = float(np.percentile(sel, p)) if sel.size else 0.0
                self._pctl_cache[(cfg_key, p, ("class", int(cid)))] = v
            while len(self._pctl_cache) > self._max_pctl_entries:
                self._pctl_cache.popitem(last=False)
            val = self._pctl_cache.get(key)
            if val is None:          # class absent from the trace
                val = 0.0
                self._pctl_cache[key] = val
        else:
            self._pctl_cache.move_to_end(key)
        return val
