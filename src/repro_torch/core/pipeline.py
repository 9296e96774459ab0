"""Prediction-pipeline DAG specification (§2).

A pipeline is a DAG whose vertices are models (or basic data transforms)
and whose edges carry dataflow. Conditional control flow (Social Media /
Video Monitoring / TF Cascade motifs) is captured by per-edge traversal
probabilities; the Profiler folds those into per-model *scale factors*
``s_m`` — the unconditional probability that a query entering the pipeline
visits model m (§4.1).

A copy of the reference's pipeline spec. The same structure is consumed
by the Estimator (simulation), the Planner (configuration search), the
Tuner (scaling decisions) and the executor (serving).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

from repro_torch.core.hardware import HARDWARE_MENU, get_hardware


@dataclasses.dataclass(frozen=True)
class Stage:
    """One vertex: a model reference plus serving-relevant metadata."""

    name: str
    model_id: str                  # key into the profile store / model zoo
    # Candidate hardware for this stage. Data transforms that cannot use an
    # accelerator (paper Fig. 3 "preprocess") list only "cpu-1".
    hardware_options: Tuple[str, ...] = tuple(h.name for h in HARDWARE_MENU)

    def __post_init__(self):
        for hw in self.hardware_options:
            get_hardware(hw)  # validate eagerly


@dataclasses.dataclass(frozen=True)
class Edge:
    src: str                       # stage name ("__source__" for ingress)
    dst: str
    probability: float = 1.0       # conditional traversal probability

    def __post_init__(self):
        if not (0.0 < self.probability <= 1.0):
            raise ValueError(f"edge {self.src}->{self.dst}: bad p={self.probability}")


SOURCE = "__source__"


@dataclasses.dataclass
class Pipeline:
    """Immutable DAG description (configuration lives in PipelineConfig)."""

    name: str
    stages: Dict[str, Stage]
    edges: List[Edge]

    def __post_init__(self):
        names = set(self.stages)
        for e in self.edges:
            if e.src != SOURCE and e.src not in names:
                raise ValueError(f"edge src {e.src!r} not a stage")
            if e.dst not in names:
                raise ValueError(f"edge dst {e.dst!r} not a stage")
        self._toposort()  # raises on cycles

    # -- graph helpers ----------------------------------------------------
    def children(self, stage: str) -> List[Edge]:
        return [e for e in self.edges if e.src == stage]

    def parents(self, stage: str) -> List[Edge]:
        return [e for e in self.edges if e.dst == stage]

    def entry_edges(self) -> List[Edge]:
        return [e for e in self.edges if e.src == SOURCE]

    def sinks(self) -> List[str]:
        has_out = {e.src for e in self.edges}
        return [s for s in self.stages if s not in has_out]

    def _toposort(self) -> List[str]:
        indeg = {s: 0 for s in self.stages}
        for e in self.edges:
            if e.src != SOURCE:
                indeg[e.dst] += 1
        ready = sorted([s for s, d in indeg.items() if d == 0])
        order: List[str] = []
        while ready:
            s = ready.pop()
            order.append(s)
            for e in self.children(s):
                indeg[e.dst] -= 1
                if indeg[e.dst] == 0:
                    ready.append(e.dst)
        if len(order) != len(self.stages):
            raise ValueError(f"pipeline {self.name!r} has a cycle")
        return order

    def toposort(self) -> List[str]:
        return self._toposort()

    # -- scale factors (§4.1) ---------------------------------------------
    def scale_factors(self) -> Dict[str, float]:
        """Unconditional visit probability per stage.

        s_m = sum over incoming edges of s_parent * p_edge, capped at 1
        (join semantics: a query visits a stage at most once).
        """
        s: Dict[str, float] = {name: 0.0 for name in self.stages}
        for stage in self.toposort():
            p = 0.0
            for e in [e for e in self.edges if e.dst == stage]:
                p_src = 1.0 if e.src == SOURCE else s[e.src]
                p += p_src * e.probability
            s[stage] = min(1.0, p)
        return s

    def longest_path_stages(self) -> List[str]:
        """Stages on the longest (max #stages) source->sink path."""
        best: Dict[str, Tuple[int, List[str]]] = {}
        for stage in self.toposort():
            incoming = [e for e in self.edges if e.dst == stage]
            cand: Tuple[int, List[str]] = (1, [stage])
            for e in incoming:
                if e.src != SOURCE and e.src in best:
                    n, path = best[e.src]
                    if n + 1 > cand[0]:
                        cand = (n + 1, path + [stage])
            best[stage] = cand
        return max(best.values(), key=lambda t: t[0])[1] if best else []


# -- per-stage and whole-pipeline configuration ---------------------------


@dataclasses.dataclass
class StageConfig:
    """The three control dimensions per model (§1), plus two beyond-paper
    knobs consumed by the simulation engine (:mod:`repro_torch.sim`):

    * ``timeout_s`` — batch-formation timeout: hold a batch open up to
      ``timeout_s`` from the head-of-line arrival to trade head latency
      for per-replica throughput (0 = the paper's greedy batching).
    * ``policy`` — per-stage queueing policy name from
      ``repro_torch.sim.queueing.QUEUE_POLICIES``: ``"fifo"`` (paper),
      ``"edf"`` (earliest-deadline-first), or ``"slo-drop"`` (SLO-aware
      load shedding). The simulator and the executor run all three.
    """

    hardware: str
    batch_size: int
    replicas: int
    timeout_s: float = 0.0
    policy: str = "fifo"

    def __post_init__(self):
        get_hardware(self.hardware)
        if self.batch_size < 1 or self.replicas < 1 or self.timeout_s < 0:
            raise ValueError(f"bad StageConfig {self}")
        if not isinstance(self.policy, str) or not self.policy:
            raise ValueError(f"bad queueing policy in StageConfig {self}")

    def copy(self) -> "StageConfig":
        return StageConfig(self.hardware, self.batch_size, self.replicas,
                           self.timeout_s, self.policy)

    def key(self) -> Tuple:
        """Hashable identity used by simulation/planner caches."""
        return (self.hardware, self.batch_size, self.replicas,
                self.timeout_s, self.policy)


@dataclasses.dataclass
class PipelineConfig:
    """A full assignment of StageConfig per stage."""

    stage_configs: Dict[str, StageConfig]

    def copy(self) -> "PipelineConfig":
        return PipelineConfig(
            {k: v.copy() for k, v in self.stage_configs.items()}
        )

    def cost_per_hr(self) -> float:
        return sum(
            get_hardware(c.hardware).cost_per_hr * c.replicas
            for c in self.stage_configs.values()
        )

    def cache_key(self) -> Tuple:
        """Hashable whole-config identity (stage order independent)."""
        return tuple(sorted(
            (s, c.key()) for s, c in self.stage_configs.items()))

    def __getitem__(self, stage: str) -> StageConfig:
        return self.stage_configs[stage]

    def describe(self) -> str:
        rows = [
            f"  {name:24s} hw={c.hardware:10s} batch={c.batch_size:<4d} "
            f"replicas={c.replicas}"
            for name, c in sorted(self.stage_configs.items())
        ]
        return "\n".join(rows + [f"  total cost: ${self.cost_per_hr():.2f}/hr"])


def linear_pipeline(name: str, model_ids: Sequence[str],
                    hardware_options: Optional[Mapping[str, Sequence[str]]] = None
                    ) -> Pipeline:
    """Convenience builder for chain pipelines (Image Processing motif)."""
    hardware_options = hardware_options or {}
    stages = {}
    edges = []
    prev = SOURCE
    for i, mid in enumerate(model_ids):
        sname = f"s{i}_{mid}"
        opts = tuple(hardware_options.get(mid, ())) or tuple(
            h.name for h in HARDWARE_MENU
        )
        stages[sname] = Stage(sname, mid, opts)
        edges.append(Edge(prev, sname))
        prev = sname
    return Pipeline(name, stages, edges)
