"""Low-frequency Planner (§4.3): greedy constrained cost minimization.

Phase 1 (Alg. 1 `Initialize`): latency-minimizing feasible configuration —
batch=1, lowest-latency hardware per stage; if the bare service time
already exceeds the SLO the constraint is infeasible. Otherwise replicate
the throughput bottleneck until the Estimator deems the pipeline feasible.

Phase 2 (Alg. 2 `MinimizeCost`): repeatedly apply, over all stages, the
single action from {IncreaseBatch (x2), RemoveReplica, DowngradeHW} that
maximally decreases cost while remaining feasible per the Estimator.
IncreaseBatch never changes cost; per the paper it is taken (at equal
cost) because it unlocks subsequent replica removals. DowngradeHW runs a
localized re-initialization of the downgraded stage (batch and replicas
re-searched on the cheaper hardware).

Guarantees at termination (§4.3): (1) if a feasible configuration exists
under the menu, one is returned; (2) no single action reduces cost without
violating the SLO.

Search-loop engineering: every candidate the
greedy loop, the downgrade binary search, and the annealer evaluate
differs from its incumbent in exactly ONE stage, so all feasibility
checks run through one incremental :class:`repro_torch.sim.TraceSession` —
only the mutated stage's downstream cone is re-simulated, and repeated
whole configurations are scalar cache hits (this subsumes the seed
planner's private whole-config ``_cache``). On top of that, candidate
*sets* — the downgrade action's (hw, batch) probe grid, its replica
binary searches (run in lockstep), and the :class:`BeamPlanner`
frontier — are scored through the session's batched ``percentile_many``
surface. Outputs are bit-identical to full re-simulation.

A copy of the reference's ``repro.core.planner``. ``backend="torch"``
scores the downgrade and beam probe grids with the port's CUDA fill
kernel on ``device`` (:mod:`repro_torch.sim.torch_backend`), where the
reference's ``backend="jax"`` uses its XLA scan: the same decisions from
bit-identical feasibility values. ``tests/test_torch_plan.py`` and
``tests/test_torch_sim_backend.py`` hold every plan, cost and estimated
percentile equal to the reference's.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np

from repro_torch.core.estimator import Estimator
from repro_torch.core.hardware import cheaper_hardware, get_hardware
from repro_torch.core.pipeline import Pipeline, PipelineConfig, StageConfig
from repro_torch.core.profiler import ProfileStore
from repro_torch.device import resolve_device

MAX_REPLICAS_PER_STAGE = 512
MAX_BATCH = 128


class _ScalarSession:
    """Feasibility session for estimator-like objects without an engine
    session (e.g. a frozen seed oracle): whole-config p-th percentile
    memo over full re-simulations — exactly the seed planner's cache."""

    def __init__(self, estimator, arrivals: np.ndarray):
        self.estimator = estimator
        self.arrivals = arrivals
        self._pctl: Dict[Tuple, float] = {}
        self.stats = {"full_sims": 0, "stage_sims": 0, "stage_hits": 0}

    @staticmethod
    def _key(config: PipelineConfig) -> Tuple:
        if hasattr(config, "cache_key"):
            return config.cache_key()
        return tuple(sorted(
            (s, c.hardware, c.batch_size, c.replicas)
            for s, c in config.stage_configs.items()))

    def percentile(self, config: PipelineConfig, p: float) -> float:
        key = (self._key(config), p)
        val = self._pctl.get(key)
        if val is None:
            self.stats["full_sims"] += 1
            val = self.estimator.simulate(
                config, self.arrivals).percentile(p)
            self._pctl[key] = val
        return val

    def percentile_many(self, configs, p: float):
        """Same batched-scoring surface as TraceSession (memo-backed
        loop here — the oracle has no shared-entry machinery)."""
        return [self.percentile(c, p) for c in configs]


@dataclasses.dataclass
class PlannerResult:
    feasible: bool
    config: Optional[PipelineConfig]
    cost_per_hr: float
    estimated_p99: float
    iterations: int
    simulations: int
    # per-class estimated percentile latency, set by plan_classed() only
    per_class_p: Optional[Dict[str, float]] = None

    def describe(self) -> str:
        if not self.feasible:
            return "INFEASIBLE under the current hardware menu/SLO"
        assert self.config is not None
        txt = (f"{self.config.describe()}\n  est. P99 = "
               f"{self.estimated_p99 * 1e3:.1f} ms "
               f"({self.iterations} iters, {self.simulations} sims)")
        if self.per_class_p:
            txt += "".join(f"\n  class {name}: P = {p * 1e3:.1f} ms"
                           for name, p in self.per_class_p.items())
        return txt


class Planner:
    def __init__(self, pipeline: Pipeline, profiles: ProfileStore,
                 estimator: Optional[Estimator] = None,
                 percentile: float = 99.0, policy: str = "fifo",
                 backend: str = "numpy", failure_headroom: int = 0,
                 device=None):
        if backend not in ("numpy", "torch"):
            raise ValueError(f"unknown backend {backend!r}; "
                             f"have ('numpy', 'torch')")
        self.pipeline = pipeline
        self.profiles = profiles
        self.estimator = estimator or Estimator(pipeline, profiles)
        self.percentile = percentile
        # survivable-failure headroom: after the cost search converges,
        # every stage is grown (post-pass, see _harden) until the plan
        # stays SLO-feasible with `failure_headroom` replicas removed —
        # over-provisioning for crash tolerance
        self.failure_headroom = int(failure_headroom)
        # queueing policy stamped on every stage of the search space —
        # "edf" lets a multi-class plan serve tight-deadline traffic from
        # fewer replicas (deadline scheduling instead of overprovisioning)
        self.policy = policy
        # simulation backend for the session's candidate scoring: "torch"
        # routes the downgrade/beam probe grids through the CUDA fill
        # kernel on `device` (resolved here, so a planner that cannot
        # reach its card raises before it plans) — same plan decisions,
        # bit-identical feasibility values
        self.backend = backend
        self.device = resolve_device(device) if backend == "torch" else None
        self._session = None
        self._session_token = None
        # scale factors are a pure function of the (immutable) pipeline:
        # computed once per planner, not once per action probe
        self._scale_cache: Optional[Dict[str, float]] = None
        # set by plan_classed() for the duration of the search: feasibility
        # then means EVERY class meets its own percentile deadline
        self._classed = None

    # ---------------------------------------------------------------- utils
    def _stage_hw_options(self, stage: str) -> List[str]:
        st = self.pipeline.stages[stage]
        prof = self.profiles.get(st.model_id)
        return [h for h in st.hardware_options if prof.supports(h)]

    def _best_hardware(self, stage: str) -> str:
        """Lowest batch-1 latency (Alg. 1 line 5)."""
        prof = self.profiles.get(self.pipeline.stages[stage].model_id)
        return min(self._stage_hw_options(stage),
                   key=lambda h: prof.batch_latency(h, 1))

    def _open_session(self, arrivals: np.ndarray) -> None:
        """One incremental session per plan() call: all candidate
        evaluations share the per-stage memoization."""
        if hasattr(self.estimator, "session"):
            # pass the backend only when non-default: other session()
            # implementers (adapters, test doubles) need not know the kwarg
            kw = {} if self.backend == "numpy" else {
                "backend": self.backend, "device": self.device}
            if self._classed is not None:
                t = self._classed
                self._session = self.estimator.session(
                    arrivals, slo_s=t.slo_per_query,
                    class_ids=t.class_ids, class_names=t.class_names, **kw)
            else:
                self._session = self.estimator.session(arrivals, **kw)
        else:  # estimator-like object without an engine (seed oracle)
            if self._classed is not None:
                raise ValueError(
                    "multi-class planning requires an engine-backed "
                    "estimator (got a session-less estimator)")
            self._session = _ScalarSession(self.estimator, arrivals)
        self._session_token = self._trace_token(arrivals)

    @staticmethod
    def _trace_token(arrivals: np.ndarray) -> Tuple:
        """Cheap trace identity: repeated probes against the bound trace
        must not pay an O(n) array compare per call. The id() is backed
        by the endpoint fingerprint so a recycled address cannot silently
        alias a different trace of the same length."""
        n = arrivals.shape[0]
        return (id(arrivals), n,
                float(arrivals[0]) if n else 0.0,
                float(arrivals[-1]) if n else 0.0)

    def _ensure_session(self, arrivals: np.ndarray) -> None:
        """Bind a session to `arrivals` unless one already is (lets
        initialize() be called directly, not only via plan())."""
        if self._session is None or \
                self._session_token != self._trace_token(arrivals):
            self._open_session(arrivals)

    def _scale_factors(self) -> Dict[str, float]:
        if self._scale_cache is None:
            self._scale_cache = self.pipeline.scale_factors()
        return self._scale_cache

    @property
    def _sims(self) -> int:
        return self._session.stats["full_sims"] if self._session else 0

    def _p99(self, config: PipelineConfig) -> float:
        """Percentile latency on the session's bound trace (the arrivals
        handed to plan(); this is the incremental simulate_delta path)."""
        return self._session.percentile(config, self.percentile)

    def _feasible(self, config: PipelineConfig, slo: float) -> bool:
        if self._classed is not None:
            # multi-class objective: every class meets its OWN percentile
            # deadline (the scalar `slo` threaded through the search loops
            # is the min over classes, used only for service-time
            # prefilters — a necessary condition for the tightest class)
            return all(
                self._session.class_percentile(config, self.percentile, cid)
                <= c.slo_s
                for cid, c in enumerate(self._classed.classes))
        return self._p99(config) <= slo

    def _feasible_many(self, configs: List[PipelineConfig], slo: float
                       ) -> List[bool]:
        """Batched feasibility: one ``percentile_many`` call scores the
        whole candidate set against the session's shared stage entries
        (identical booleans to per-config ``_feasible``)."""
        if not configs:
            return []
        if self._classed is not None:
            return [self._feasible(c, slo) for c in configs]
        vals = self._session.percentile_many(configs, self.percentile)
        return [v <= slo for v in vals]

    def _throughput(self, config: PipelineConfig, stage: str) -> float:
        cfg = config[stage]
        prof = self.profiles.get(self.pipeline.stages[stage].model_id)
        return cfg.replicas * prof.throughput(cfg.hardware, cfg.batch_size)

    def _harden(self, config: PipelineConfig, slo: float) -> PipelineConfig:
        """Failure-headroom post-pass: grow each stage until the plan
        would stay feasible after losing ``failure_headroom`` replicas
        of that stage (single-stage failure model — the planner's
        survivable-failure target). Runs AFTER the cost search so the
        headroom rides the cheapest feasible shape rather than steering
        it; a stage is left at ``MAX_REPLICAS_PER_STAGE`` if even the
        cap cannot buy the headroom (best effort)."""
        f = self.failure_headroom
        if f <= 0:
            return config
        for stage in self.pipeline.stages:
            while True:
                k = config[stage].replicas
                if k - f >= 1:
                    probe = config.copy()
                    probe[stage].replicas = k - f
                    if self._feasible(probe, slo):
                        break
                if k + 1 > MAX_REPLICAS_PER_STAGE:
                    break
                config[stage].replicas = k + 1
        return config

    # ------------------------------------------------------------ Algorithm 1
    def initialize(self, arrivals: np.ndarray, slo: float
                   ) -> Optional[PipelineConfig]:
        arrivals = np.asarray(arrivals, dtype=np.float64)
        self._ensure_session(arrivals)
        config = PipelineConfig({
            s: StageConfig(self._best_hardware(s), 1, 1, policy=self.policy)
            for s in self.pipeline.stages
        })
        if self.estimator.service_time(config) > slo:
            return None  # infeasible: bare service time exceeds the SLO
        scale = self._scale_factors()
        while not self._feasible(config, slo):
            # throughput bottleneck, demand-normalized by scale factor
            bottleneck = min(
                config.stage_configs,
                key=lambda s: self._throughput(config, s) / max(scale[s], 1e-9),
            )
            config[bottleneck].replicas += 1
            if config[bottleneck].replicas > MAX_REPLICAS_PER_STAGE:
                return None
        return config

    # ---------------------------------------------------- Algorithm 2 actions
    def _action_increase_batch(self, config: PipelineConfig, stage: str
                               ) -> Optional[PipelineConfig]:
        cfg = config[stage]
        if cfg.batch_size * 2 > MAX_BATCH:
            return None
        new = config.copy()
        new[stage].batch_size *= 2
        return new

    def _action_remove_replica(self, config: PipelineConfig, stage: str
                               ) -> Optional[PipelineConfig]:
        if config[stage].replicas <= 1:
            return None
        new = config.copy()
        new[stage].replicas -= 1
        return new

    def _downgrade_grid(self, config: PipelineConfig, stage: str,
                        arrivals: np.ndarray, slo: float):
        """One (config, stage) downgrade job: the statically-prefiltered
        (hw, batch, k0, k_cap) probe grid plus its candidate constructor,
        or None when no cheaper option survives the prefilters (cost cap
        + bare service time + required throughput). Split from the
        search so :class:`BeamPlanner` can concatenate every frontier
        member's grids into ONE lockstep search per round."""
        cfg = config[stage]
        options = [h for h in cheaper_hardware(cfg.hardware)
                   if h in self._stage_hw_options(stage)]
        if not options:
            return None
        prof = self.profiles.get(self.pipeline.stages[stage].model_id)
        scale = self._scale_factors()[stage]
        duration = float(arrivals.max() - arrivals.min()) if arrivals.size > 1 else 1.0
        lam_m = arrivals.size * scale / max(duration, 1e-9)
        old_stage_cost = get_hardware(cfg.hardware).cost_per_hr * cfg.replicas

        def with_k(hw: str, batch: int, k: int) -> PipelineConfig:
            cand = config.copy()
            cand.stage_configs[stage] = dataclasses.replace(
                cfg, hardware=hw, batch_size=batch, replicas=k)
            return cand

        grid: List[Tuple[str, int, int, int]] = []   # (hw, batch, k0, k_cap)
        for hw in options:
            hw_cost = get_hardware(hw).cost_per_hr
            # replicas beyond which the downgrade cannot reduce total cost
            k_cap = int(math.floor((old_stage_cost - 1e-9) / hw_cost))
            for batch in prof.batch_sizes:
                if batch > MAX_BATCH:
                    continue
                # prefilter: bare service time must fit before simulating
                if self.estimator.service_time(with_k(hw, batch, 1)) > slo:
                    continue
                mu = prof.throughput(hw, batch)
                k0 = max(1, math.ceil(lam_m / mu))
                if k0 > k_cap:
                    continue
                grid.append((hw, batch, k0, k_cap))
        if not grid:
            return None
        return (with_k, grid, config.cost_per_hr())

    def _downgrade_search_many(self, jobs: List, slo: float
                               ) -> List[Optional[PipelineConfig]]:
        """Lockstep replica search over the union of downgrade jobs.

        One ``percentile_many`` call decides every grid point's
        feasibility at its cost cap, then the survivors binary-search
        their minimal replica counts in lockstep — one batched call per
        halving round, across ALL jobs at once. Feasibility is monotone
        in replicas, so predicate values (and hence each job's returned
        candidate) match the sequential per-job formulation exactly."""
        flat: List[Tuple[int, str, int, int, int]] = []
        for j, (with_k, grid, _) in enumerate(jobs):
            flat.extend((j, hw, b, k0, k_cap) for hw, b, k0, k_cap in grid)
        feas = self._feasible_many(
            [jobs[j][0](hw, b, k_cap) for j, hw, b, _, k_cap in flat], slo)
        search = [[j, hw, b, k0, k_cap]
                  for (j, hw, b, k0, k_cap), ok in zip(flat, feas) if ok]
        while True:
            open_i = [i for i, (_, _, _, lo, hi) in enumerate(search)
                      if lo < hi]
            if not open_i:
                break
            mids = [(search[i][3] + search[i][4]) // 2 for i in open_i]
            ok_mid = self._feasible_many(
                [jobs[search[i][0]][0](search[i][1], search[i][2], m)
                 for i, m in zip(open_i, mids)], slo)
            for i, m, ok in zip(open_i, mids, ok_mid):
                if ok:
                    search[i][4] = m
                else:
                    search[i][3] = m + 1

        best: List[Optional[PipelineConfig]] = [None] * len(jobs)
        for j, hw, b, lo, _ in search:
            cand = jobs[j][0](hw, b, lo)
            if cand.cost_per_hr() < jobs[j][2] - 1e-12 and (
                    best[j] is None
                    or cand.cost_per_hr() < best[j].cost_per_hr()):
                best[j] = cand
        return best

    def _action_downgrade_hw(self, config: PipelineConfig, stage: str,
                             arrivals: np.ndarray, slo: float
                             ) -> Optional[PipelineConfig]:
        """Localized re-init + cost minimization on cheaper hardware (§4.3).

        The whole (hw, batch) probe grid is scored through the session's
        ``percentile_many`` surface (one feasibility call at the cost
        caps, then lockstep replica halving — see
        :meth:`_downgrade_search_many`). Each probe still simulates once
        on a miss; the win is that the whole grid shares the session's
        stage-entry, assembly-prefix, and percentile caches — and, on the
        torch backend, scores as one launch of the fill kernel. Selection
        order and predicate values match the sequential formulation
        exactly (same returned candidate)."""
        job = self._downgrade_grid(config, stage, arrivals, slo)
        if job is None:
            return None
        return self._downgrade_search_many([job], slo)[0]

    # ------------------------------------------------------------ Algorithm 2
    def plan(self, arrivals: np.ndarray, slo: float) -> PlannerResult:
        arrivals = np.asarray(arrivals, dtype=np.float64)
        self._open_session(arrivals)
        config = self.initialize(arrivals, slo)
        if config is None:
            return PlannerResult(False, None, math.inf, math.inf, 0, self._sims)

        iterations = 0
        while True:
            iterations += 1
            current_cost = config.cost_per_hr()
            best: Optional[PipelineConfig] = None
            best_cost = current_cost
            best_is_batch = False
            for stage in self.pipeline.stages:
                candidates: List[Tuple[Optional[PipelineConfig], bool]] = [
                    (self._action_increase_batch(config, stage), True),
                    (self._action_remove_replica(config, stage), False),
                    (self._action_downgrade_hw(config, stage, arrivals, slo),
                     False),
                ]
                for cand, is_batch in candidates:
                    if cand is None:
                        continue
                    c = cand.cost_per_hr()
                    if c > best_cost + 1e-12:
                        continue
                    if not self._feasible(cand, slo):
                        continue
                    if c < best_cost - 1e-12:
                        best, best_cost, best_is_batch = cand, c, is_batch
                    elif is_batch and best is None and c <= current_cost + 1e-12:
                        # cost-neutral batch increase: taken only when no
                        # strictly cost-reducing action exists (§4.3)
                        best, best_cost, best_is_batch = cand, c, True
            if best is None:
                break
            config = best

        config = self._harden(config, slo)
        p99 = self._p99(config)
        return PlannerResult(True, config, config.cost_per_hr(), p99,
                             iterations, self._sims)

    # ------------------------------------------------- multi-class objective
    def plan_classed(self, trace, **plan_kwargs) -> PlannerResult:
        """Provision for a mixed per-query SLO workload.

        ``trace`` is a :class:`repro_torch.workload.slo_classes.ClassedTrace`:
        interleaved arrival stream plus per-query class tags, each class
        carrying its own latency SLO. The search is the paper's greedy
        loop (or the annealed refinement on :class:`AnnealedPlanner`)
        with the feasibility predicate replaced by the multi-class
        objective — the configured percentile of EVERY class must meet
        that class's own deadline — while cost is minimized across the
        mix. Service-time prefilters use the tightest class's SLO (a
        necessary condition, so no feasible configuration is pruned).

        Uniform-SLO degenerate case: with one class this reduces exactly
        to ``plan(trace.arrivals, slo)`` feasibility-wise (one constraint
        over all queries).
        """
        if not getattr(trace, "classes", None):
            raise ValueError("plan_classed needs a ClassedTrace with >=1 "
                             "SLOClass")
        self._classed = trace
        try:
            result = self.plan(trace.arrivals, trace.min_slo_s,
                               **plan_kwargs)
            if result.feasible:
                result.per_class_p = {
                    c.name: self._session.class_percentile(
                        result.config, self.percentile, cid)
                    for cid, c in enumerate(trace.classes)
                }
            return result
        finally:
            self._classed = None


# ---------------------------------------------------------------------------
# Beyond-paper: beam-search refinement over the Alg. 2 action set
# ---------------------------------------------------------------------------

class BeamPlanner(Planner):
    """Greedy (Alg. 1+2) followed by a k-wide beam search.

    Where the greedy loop commits to the single best action per
    iteration, the beam keeps the ``beam_width`` cheapest feasible
    configurations reached so far and expands *all* of their actions —
    so an early cost-neutral move (e.g. a batch increase on a stage the
    greedy rule never favors) can pay off several actions later. The
    whole frontier's successor set is scored per round through the
    session's ``percentile_many`` surface, whose shared stage-entry /
    assembly-prefix / percentile caches are what make the wider search
    affordable.

    Guarantees: the greedy fixed point is computed first on the same
    incremental session (its probes stay cache-hot for the beam) and is
    only ever *improved on* — the returned plan is feasible and costs at
    most the greedy plan, preserving both §4.3 guarantees.
    """

    def __init__(self, pipeline: Pipeline, profiles: ProfileStore,
                 estimator: Optional[Estimator] = None,
                 percentile: float = 99.0, policy: str = "fifo",
                 beam_width: Optional[int] = None, max_rounds: int = 64,
                 backend: str = "numpy", device=None):
        super().__init__(pipeline, profiles, estimator=estimator,
                         percentile=percentile, policy=policy,
                         backend=backend, device=device)
        if beam_width is None:
            # device-scored grids make candidates cheap: default to a
            # wider frontier on the torch backend (the reference's 8 on
            # its "jax" backend)
            beam_width = 8 if backend == "torch" else 4
        if beam_width < 1:
            raise ValueError(f"beam_width must be >= 1, got {beam_width}")
        self.beam_width = beam_width
        self.max_rounds = max_rounds

    def plan(self, arrivals: np.ndarray, slo: float) -> PlannerResult:
        arrivals = np.asarray(arrivals, dtype=np.float64)
        greedy = super().plan(arrivals, slo)
        if not greedy.feasible:
            return greedy
        best = greedy.config
        best_cost = greedy.cost_per_hr

        init = self.initialize(arrivals, slo)   # cache-hot replay
        frontier: List[PipelineConfig] = []
        visited = set()
        for cfg in (init, greedy.config):
            key = cfg.cache_key()
            if key not in visited:
                visited.add(key)
                frontier.append(cfg)

        stages = list(self.pipeline.stages)
        rounds = 0
        while frontier and rounds < self.max_rounds:
            rounds += 1
            # expand every frontier member's full action set; feasibility
            # for the flat moves is decided by ONE batched scoring call,
            # and every (member, stage) downgrade grid joins ONE union
            # lockstep search instead of a search per pair
            flat: List[PipelineConfig] = []
            kept: List[PipelineConfig] = []   # pre-verified (downgrades)
            jobs: List = []
            for cfg in frontier:
                for stage in stages:
                    for cand in (self._action_increase_batch(cfg, stage),
                                 self._action_remove_replica(cfg, stage)):
                        if cand is None:
                            continue
                        key = cand.cache_key()
                        if key not in visited:
                            visited.add(key)
                            flat.append(cand)
                    job = self._downgrade_grid(cfg, stage, arrivals, slo)
                    if job is not None:
                        jobs.append(job)
            for dg in self._downgrade_search_many(jobs, slo):
                if dg is not None:
                    key = dg.cache_key()
                    if key not in visited:
                        visited.add(key)
                        kept.append(dg)
            feas = self._feasible_many(flat, slo)
            kept.extend(c for c, ok in zip(flat, feas) if ok)
            if not kept:
                break
            kept.sort(key=lambda c: c.cost_per_hr())
            frontier = kept[:self.beam_width]
            front_cost = frontier[0].cost_per_hr()
            if front_cost < best_cost - 1e-12:
                best, best_cost = frontier[0], front_cost

        best = self._harden(best, slo)
        best_cost = best.cost_per_hr()
        p = self._p99(best)
        return PlannerResult(True, best, best_cost, p,
                             greedy.iterations + rounds, self._sims)


# ---------------------------------------------------------------------------
# Beyond-paper: simulated-annealing refinement
# ---------------------------------------------------------------------------

class AnnealedPlanner(Planner):
    """Greedy (Alg. 1+2) followed by simulated-annealing refinement.

    The paper notes (§7.2) that the greedy optimizer "occasionally finds
    sub-optimal configurations, as it makes locally optimal decisions".
    This variant escapes those local optima with random joint moves —
    re-batching one stage WHILE re-replicating another — which no single
    greedy action can express. Feasibility stays Estimator-checked, so
    guarantee (1) is preserved; guarantee (2) holds for the returned
    config because annealing only ever returns configs at least as cheap
    as the greedy fixed point.
    """

    def plan(self, arrivals: np.ndarray, slo: float,
             steps: int = 150, t0: float = 0.3,
             seed: int = 0) -> PlannerResult:
        greedy = super().plan(arrivals, slo)
        if not greedy.feasible:
            return greedy
        rng = np.random.default_rng(seed)
        arrivals = np.asarray(arrivals, dtype=np.float64)
        cur = greedy.config.copy()
        cur_cost = cur.cost_per_hr()
        best, best_cost = cur.copy(), cur_cost
        stages = list(self.pipeline.stages)

        def neighbor(cfg: PipelineConfig) -> Optional[PipelineConfig]:
            new = cfg.copy()
            for _ in range(int(rng.integers(1, 3))):  # 1-2 joint moves
                stage = stages[int(rng.integers(len(stages)))]
                sc = new[stage]
                move = int(rng.integers(4))
                if move == 0 and sc.batch_size * 2 <= MAX_BATCH:
                    sc.batch_size *= 2
                elif move == 1 and sc.batch_size > 1:
                    sc.batch_size //= 2
                elif move == 2:
                    sc.replicas = max(1, sc.replicas
                                      + int(rng.choice([-1, 1])))
                else:
                    opts = self._stage_hw_options(stage)
                    sc_hw = opts[int(rng.integers(len(opts)))]
                    new.stage_configs[stage] = dataclasses.replace(
                        sc, hardware=sc_hw)
            return new

        for i in range(steps):
            temp = t0 * (1.0 - i / steps) + 1e-6
            cand = neighbor(cur)
            cost = cand.cost_per_hr()
            # Metropolis on relative cost; only feasible moves accepted
            if cost <= cur_cost or rng.random() < math.exp(
                    -(cost - cur_cost) / (temp * max(cur_cost, 1e-9))):
                if self._feasible(cand, slo):
                    cur, cur_cost = cand, cost
                    if cost < best_cost - 1e-12:
                        best, best_cost = cand.copy(), cost
        best = self._harden(best, slo)
        best_cost = best.cost_per_hr()
        p99 = self._p99(best)
        return PlannerResult(True, best, best_cost, p99,
                             greedy.iterations + steps, self._sims)
