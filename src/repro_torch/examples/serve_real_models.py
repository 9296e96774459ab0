"""End-to-end example: serve real models with a closed-loop Tuner.

The port's copy of ``examples/serve_real_models.py``, the system's own
entry point, with the reference's constants, steps and printed lines. It
deploys real models (two assigned architectures) on this host with the
real thread-pool executor:

  1. build both stages of the cascade (``serving.stage.make_stage``),
  2. measured-profile both models with the Profiler's wall-clock backend,
  3. plan the two-stage cascade with the Planner against the profile,
  4. deploy the planned config to PipelineExecutor (real centralized
     policy-aware batched queues + replica threads), serve a Poisson
     trace of batched requests and report latency vs the Estimator's
     prediction (Fig. 8 fidelity),
  5. close the loop: a traffic spike hits the running pipeline and the
     ClosedLoopTuner -- the same controller used in co-simulation --
     scales the real replica fleet through the LiveControlLoop.

On the card (the default) both stages run at published width
(xlstm-125m, llama3.2-1b, seeded random weights) on ``h100-1``: a batch
is one CUDA graph replay of its power-of-two bucket, the profile covers
batches 1-128, and each stage captures a replica slot for each of the
Tuner's ``MAX_REPLICAS``, so every replica replays on its own stream.
``--device cpu`` takes the reference's smoke configs on ``cpu-1`` and its
profile of batches 1-16.

Run:  PYTHONPATH=src python -m repro_torch.examples.serve_real_models \\
          [--device cpu]
"""

import argparse
from typing import Any, Dict, Tuple

import numpy as np

from repro_torch.configs import get_arch, get_smoke
from repro_torch.core.estimator import Estimator
from repro_torch.core.pipeline import linear_pipeline
from repro_torch.core.planner import Planner
from repro_torch.core.profiler import ProfileStore, profile_model_measured
from repro_torch.core.tuner import ClosedLoopTuner, TunerPlanInfo
from repro_torch.serving.executor import PipelineExecutor
from repro_torch.serving.loop import LiveControlLoop
from repro_torch.serving.stage import SEQ, make_stage
from repro_torch.workload.generator import gamma_trace

SLO = 0.25          # 250 ms end-to-end
LAMBDA = 30.0       # queries/s
MAX_REPLICAS = 4    # the ClosedLoopTuner's cap
ARCHES = {"stage_a": "xlstm-125m", "stage_b": "llama3.2-1b"}
# (hardware, profiled batch sizes) a device serves on
SETUP = {"cuda": ("h100-1", (1, 2, 4, 8, 16, 32, 64, 128)),
         "cpu": ("cpu-1", (1, 2, 4, 8, 16))}


def main(device: str = "cuda", sample_s: float = 20.0, live_s: float = 15.0,
         tune_sample_s: float = 60.0,
         spike_s: Tuple[float, float, float] = (8.0, 5.0, 17.0)
         ) -> Dict[str, Any]:
    """Steps 1-5 on ``device``; the durations are those of the traces the
    Planner, the live serve, the Tuner's plan info and the spike's three
    phases take. Returns the stages, the plan, the live serve's latencies
    and answers, and the closed loop's result. Raises SystemExit if no
    configuration is feasible or a live request goes unanswered."""
    hw, batch_sizes = SETUP[device]
    full = device == "cuda"
    names = [(get_arch if full else get_smoke)(a).name
             for a in ARCHES.values()]
    print(f"building models ({' -> '.join(names)} cascade)")
    stages = {sid: make_stage(arch, device, full=full, seed=0)
              for sid, arch in ARCHES.items()}
    if full:
        # a replay serves each batch: capture the buckets before profiling
        for st in stages.values():
            st.warmup(max(batch_sizes))

    print("profiling (measured wall-clock backend) ...")
    store = ProfileStore()
    for sid, st in stages.items():
        store.add(profile_model_measured(sid, st.profile_fn, hw,
                                         batch_sizes=batch_sizes))
    for mid in ARCHES:
        p = store.get(mid)
        print(f"  {mid}: lat(b=1)={p.batch_latency(hw, 1)*1e3:.1f}ms "
              f"lat(b=8)={p.batch_latency(hw, 8)*1e3:.1f}ms "
              f"max_thru={p.max_throughput(hw):.1f} qps")

    pipe = linear_pipeline("cascade", list(ARCHES),
                           {sid: [hw] for sid in ARCHES})
    sample = gamma_trace(LAMBDA, 1.0, sample_s, seed=0)
    plan = Planner(pipe, store).plan(sample, SLO)
    print("\nplanned configuration:")
    print(plan.describe())
    if not plan.feasible:
        raise SystemExit("infeasible on this host; lower LAMBDA")

    print("\nwarming batch buckets (pow2 up to 128) ...")
    for st in stages.values():
        # on the card: a slot of graphs for every replica the Tuner may add
        st.warmup(128, slots=MAX_REPLICAS)

    print(f"deploying to the real executor and serving {live_s:g} s of "
          f"traffic...")
    solo = {s: store.get(pipe.stages[s].model_id).batch_latency(hw, 1)
            for s in pipe.stages}
    ex = PipelineExecutor(pipe, plan.config,
                          {sid: st.run_batch for sid, st in stages.items()},
                          solo_latency_s=solo)
    live = gamma_trace(LAMBDA, 1.0, live_s, seed=1)

    def payload(i: int) -> np.ndarray:
        return np.ones((SEQ,), np.int32) * (i % 50)

    try:
        lat = ex.serve_trace(live, payload, slo_s=SLO)
        outputs = ex.outputs()
        if not np.isfinite(lat).all():
            raise SystemExit(f"{int((~np.isfinite(lat)).sum())} of "
                             f"{lat.size} queries unanswered")

        est = Estimator(pipe, store)
        predicted = est.simulate(plan.config, live)
        print(f"\nserved {lat.size} queries:")
        print(f"  measured  p50={np.percentile(lat, 50)*1e3:7.1f}ms  "
              f"p99={np.percentile(lat, 99)*1e3:7.1f}ms  "
              f"miss={float((lat > SLO).mean()):.4f}")
        print(f"  estimator p50={predicted.percentile(50)*1e3:7.1f}ms  "
              f"p99={predicted.p99*1e3:7.1f}ms (Fig. 8 fidelity check)")
        print(f"  mean batch sizes: "
              f"{ {k: round(v, 1) for k, v in ex.batch_stats().items()} }")

        # ---- close the loop on the running pipeline ---------------------
        # the ClosedLoopTuner drives REAL threads through the same
        # step(EpochTelemetry) interface it uses in co-simulation; a 3x
        # traffic spike should scale the fleet up, then drain it back down
        print("\nclosed loop: 3x spike against the live executor ...")
        service = est.service_time(plan.config)
        info = TunerPlanInfo.from_plan(
            pipe, plan.config, store,
            gamma_trace(LAMBDA, 1.0, tune_sample_s, seed=2), service)
        tuner = ClosedLoopTuner(info, max_replicas=MAX_REPLICAS)
        loop = LiveControlLoop(ex, SLO, epoch_s=1.0, service_time_s=service)
        # the tail outlives DOWNSCALE_HYSTERESIS_S so the drain-and-retire
        # half of the lifecycle shows up too
        before, peak, after = spike_s
        spike = np.concatenate([
            gamma_trace(LAMBDA, 1.0, before, seed=3),
            before + gamma_trace(3 * LAMBDA, 0.7, peak, seed=4),
            before + peak + gamma_trace(LAMBDA, 1.0, after, seed=5)])
        run = loop.run(spike, tuner, payload)
        print(f"  served {run.latency.size} queries, "
              f"miss={run.miss_rate:.4f}, released={run.released}")
        for ev in run.events:
            print(f"  t={ev.t:5.1f}s  {ev.kind:6s} {ev.stage:16s} "
                  f"value={ev.value:+.0f}")
        for stage, tl in run.replica_timeline.items():
            print(f"  {stage} replicas: " +
                  " -> ".join(f"{c}@{t:.0f}s" for t, c in tl))
    finally:
        ex.shutdown()
    return {"stages": stages, "plan": plan, "trace": live, "latency": lat,
            "outputs": outputs, "predicted": predicted, "loop": run}


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=tuple(SETUP))
    main(ap.parse_args().device)
