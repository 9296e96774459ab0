"""Traffic-spike autoscaling walkthrough (the Fig. 6 scenario, small).

Serves an AutoScale-derived real-workload trace through the Video
Monitoring pipeline and prints a timeline of the Tuner's decisions:
which envelope window tripped, which stages scaled, and the cost curve
— the mechanics of §5 made visible.

The port's copy of ``examples/autoscale_spike.py``: the same constants,
steps and printed lines, over ``repro_torch``'s numpy copies of the
planner, the Estimator, the Tuner and the simulated cluster. It runs on
no device.

Run:  PYTHONPATH=src python -m repro_torch.examples.autoscale_spike
"""

import numpy as np

from repro_torch.configs.pipelines import get_motif
from repro_torch.core.envelope import TrafficEnvelope
from repro_torch.core.estimator import Estimator
from repro_torch.core.planner import Planner
from repro_torch.core.tuner import Tuner, TunerPlanInfo, run_tuner_offline
from repro_torch.serving.cluster import LiveClusterSim
from repro_torch.workload.traces import (autoscale_derived_trace,
                                         split_plan_serve)

SLO = 0.2
MAX_QPS = 80.0


def main() -> None:
    bound = get_motif("video-monitoring")
    pipe, profiles = bound.pipeline, bound.profiles

    trace = autoscale_derived_trace("big_spike", max_qps=MAX_QPS, seed=7)
    plan_trace, serve_trace = split_plan_serve(trace, 0.25)
    print(f"trace: {trace.size} queries over {trace.max():.0f}s "
          f"(plan on first 25%)\n")

    plan = Planner(pipe, profiles).plan(plan_trace, SLO)
    print("planned configuration:")
    print(plan.describe(), "\n")

    est = Estimator(pipe, profiles)
    info = TunerPlanInfo.from_plan(pipe, plan.config, profiles, plan_trace,
                                   est.service_time(plan.config))
    print("planned traffic envelope (multi-timescale, §5):")
    print(info.planned_envelope.describe(), "\n")

    tuner = Tuner(info)
    sim = LiveClusterSim(pipe, profiles, plan.config, SLO)
    run = sim.run(serve_trace,
                  schedule_fn=lambda arr: run_tuner_offline(tuner, arr))

    print("tuner events (first 12):")
    for t, kind, stage, delta in tuner.events[:12]:
        print(f"  t={t:7.1f}s  {kind:4s}  {stage:12s}  {delta:+d}")
    print(f"  ... {len(tuner.events)} total\n")

    # live envelope at the spike peak vs plan
    peak_t = serve_trace[np.argmax(np.convolve(
        np.histogram(serve_trace, bins=int(serve_trace.max()))[0],
        np.ones(5), "same"))]
    recent = serve_trace[(serve_trace > peak_t - 60) & (serve_trace <= peak_t)]
    live_env = TrafficEnvelope.from_trace(recent, info.service_time_s)
    exceeded, r_max = info.planned_envelope.exceeded_by(live_env)
    print(f"envelope at spike peak (t={peak_t:.0f}s): exceeded={exceeded} "
          f"r_max={r_max:.1f} qps\n")

    print(f"result: attainment={run.attainment*100:.2f}%  "
          f"total=${run.total_cost():.2f}  "
          f"mean=${run.mean_cost_per_hr():.2f}/hr")
    static = sim.run(serve_trace)
    print(f"static would be: attainment={static.attainment*100:.2f}%  "
          f"mean=${static.mean_cost_per_hr():.2f}/hr")


if __name__ == "__main__":
    main()
