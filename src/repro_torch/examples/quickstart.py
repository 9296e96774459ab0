"""Quickstart: provision an ML prediction pipeline with InferLine.

Plans the paper's Social Media pipeline (bound to the assigned
architectures) against a synthetic bursty workload, deploys it to the
discrete-event cluster, and serves a held-out trace with the
high-frequency Tuner in the loop.

The port's copy of ``examples/quickstart.py``: the same constants, steps and
printed lines, over ``repro_torch``'s numpy copies of the planner, the
Estimator, the Tuner and the simulated cluster. It runs on no device.

Run:  PYTHONPATH=src python -m repro_torch.examples.quickstart
"""

from repro_torch.configs.pipelines import get_motif
from repro_torch.core.estimator import Estimator
from repro_torch.core.planner import Planner
from repro_torch.core.tuner import Tuner, TunerPlanInfo, run_tuner_offline
from repro_torch.serving.cluster import LiveClusterSim
from repro_torch.workload.generator import gamma_trace, rate_ramp_trace

SLO = 0.15          # 150 ms end-to-end P99 target
LAMBDA, CV = 120.0, 1.5


def main() -> None:
    bound = get_motif("social-media")
    pipe, profiles = bound.pipeline, bound.profiles
    print(f"pipeline: {pipe.name}  stages: {list(pipe.stages)}")
    print(f"scale factors: "
          f"{ {k: round(v, 2) for k, v in pipe.scale_factors().items()} }\n")

    # --- low-frequency planning (Profiler -> Estimator -> Planner) -------
    sample = gamma_trace(LAMBDA, CV, duration_s=60, seed=0)
    planner = Planner(pipe, profiles)
    plan = planner.plan(sample, SLO)
    print("planner result:")
    print(plan.describe(), "\n")
    assert plan.feasible

    # --- deploy + serve with the high-frequency Tuner ---------------------
    est = Estimator(pipe, profiles)
    info = TunerPlanInfo.from_plan(pipe, plan.config, profiles, sample,
                                   est.service_time(plan.config))
    live = rate_ramp_trace(LAMBDA, 2 * LAMBDA, CV, pre_s=30, ramp_s=30,
                           post_s=60, seed=1)
    sim = LiveClusterSim(pipe, profiles, plan.config, SLO)
    static = sim.run(live)
    tuned = sim.run(live, schedule_fn=lambda arr: run_tuner_offline(
        Tuner(info), arr))

    print(f"live serving of a {LAMBDA}->{2*LAMBDA} qps ramp:")
    print(f"  static plan : miss={static.miss_rate:7.4f} "
          f"mean cost=${static.mean_cost_per_hr():.2f}/hr")
    print(f"  with Tuner  : miss={tuned.miss_rate:7.4f} "
          f"mean cost=${tuned.mean_cost_per_hr():.2f}/hr")
    print(f"  tuner scale events: "
          f"{sum(len(v) for v in tuned.replica_timeline.values())}")


if __name__ == "__main__":
    main()
