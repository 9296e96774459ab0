#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU, end to end.

Run from the repository root on a machine with a CUDA GPU and the CUDA
toolkit:

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

1. print the card's name and power limit, build the CUDA kernels;
2. hold each kernel against its plain PyTorch version on the card, at
   the served shapes and at edge shapes (f32 2e-5/2e-5, bf16 3e-2/3e-2),
   and time kernel, plain version and one PyTorch library call; for
   decode attention also at the hybrid's step shape, the cluster sizes
   the card holds, the host cost of each step of its wrapper and its
   device time at every cluster size its plan could pick; for the scan
   its grid against the CTAs an SM holds (the waves), at the hybrid's
   prefill chunk and step shape in f32 and bf16, with a bound that
   counts its exponentials on the special-function units; for flash
   attention also the f32 forward against the same attention in f64
   where its sums run long (whisper's 2048 x 1500 cross-attention,
   pixtral's 4096 keys; 1e-5 of each row's largest entry), the
   forward's logsumexp and the backward kernel
   against their plain versions (f32 5e-4, bf16 3e-2) at the training
   shape, at edge shapes and at phases 15 and 16's training shapes
   (whisper's encoder over 1500 frames and its cross-attention, pixtral
   at 4096, MLA at 4096 with 32 heads a rank), and at the training
   shape the backward's
   time beside its plain version's, SDPA's backward and its bound, and
   the forward with its logsumexp against the forward without; the
   flash and decode shapes of phase 12's whisper-small and pixtral-12b
   (the encoder's non-causal B 8 x 1500, the cross-attention over 1500
   frames at 64 query rows and at one, pixtral's causal prefill of
   1088; decode at 12/12 heads D 64 and 32/8 D 128), each held against
   its plain version and timed beside SDPA, and the decode-time
   cross-attention also through decode attention at valid_len 1500;
3. check the port's forward, and its prefill + greedy decode, on the
   card against its plain CPU path on the smoke configs (xLSTM's decode
   with its carried state, whisper with stub frames, pixtral with stub
   patch embeddings among them), build both
   cascade stages at full published width (xlstm-125m 12L x 768,
   llama3.2-1b 16L x 2048, seeded random weights), capture each stage's
   CUDA graphs (one a power-of-two bucket, 1-128), hold every bucket's
   replay against the eager forward (logits bit for bit, or within
   1e-5, and the answer), and profile the replays at batch sizes 1-128
   on ``h100-1`` (the Planner's batches, so the plan reads no
   extrapolated latency);
4. serve a Poisson trace through the two-stage executor on a fixed
   configuration, with every kernel launch counter zeroed just before
   and read just after, check every answer, and print the Estimator's
   p50/p99 for the same configuration and trace beside the measured;
4b. plan, then serve the plan (steps 2-4 of
   ``examples/serve_real_models.py``, with its 30 qps and 250 ms SLO):
   the Planner provisions the cascade on ``h100-1`` from the profile
   measured in phase 3 over a 20 s sample trace (it fails the run if no
   configuration is feasible, or if a planned batch lies past the
   largest profiled one), the executor serves 15 s of live traffic on
   the planned configuration with the same answer and launch-count
   checks as phase 4, and the measured p50/p99/miss are printed beside
   the Estimator's p50/p99 on the same trace (the paper's Fig. 8);
4c. serve each stage alone, as a one-stage pipeline, on its planned
   configuration and phase 4b's live trace, with the same checks, its
   measured p50/p99/miss beside the Estimator's: what one stage does
   without the other on the host;
4d. close the loop (step 5 of the example): capture 4 replica slots a
   stage (own graphs, buffers and stream each), then the
   ``ClosedLoopTuner(max_replicas=4)`` drives ``LiveControlLoop`` over
   the executor serving the plan through the example's 3x spike, with
   the same answer, launch-count and batch-cap checks, no request
   released and at least one scale-up; its events, replica timelines,
   p50/p99, miss and $/hr are printed beside those of the co-simulated
   twin (``ControlLoopSession``) on the same trace, and beside the same
   spike served with no controller, window by window;
4e. what a replica adds on one card: 1, 2 and 4 threads replaying one
   stage's batch of 8 at once, each on its own slot, for both stages;
4f. the process backend on this card (the slots past the first freed
   first): a worker process per stage answers a fixed batch bit-equal to
   this process's stage, with the IPC a batch costs; then phase 4b's plan
   served from spawned worker processes, one a replica, through 4b's
   live trace while a FaultSchedule SIGKILLs each stage's worker mid-run
   and ClosedLoopTuner(failure_recovery=True) buys the replacement,
   beside the co-simulated twin on the same trace and schedule: every
   request delivered exactly once, the killed pids gone, every answer,
   the workers' launch counts, and the live final fleet equal to the
   twin's; spawn-to-ready per worker, p50/p99/miss against the twin's,
   device memory per process;
4g. with at least 4 cards (else it says why it did not run): (a) 4
   worker processes a stage, one a card, answering phase 4e's batch of 8
   from 1, 2 and 4 of them at once; (b) phase 4d's spike served with
   each stage's replicas placed one a card, beside the twin;
5. trace one replay per stage with torch.profiler: the device's busy
   share of the stage's batch latency, the kernels that fill it, and a
   check that the port's kernels in it are one forward's; then both
   stages' replays from two threads at once, on their own streams (as
   served) and on one stream;
6. decode with the full-width llama3.2-1b: prefill 8 prompts of 512
   tokens into a 1024-slot cache and take 64 greedy decode steps, with
   the counters zeroed before and read after the prefill and the steps;
   hold every step's logits against the port's forward over the same
   576 tokens, and time and trace a step;
7. the same with the expert-free one-period Jamba-1.5-Large hybrid at
   its published widths (7 Mamba layers and 1 attention layer, d_model
   8192, every FFN dense of width 24576): prefill 8 x 512 tokens, 32
   greedy steps against the forward over 544 tokens, the stage latency
   at 32 tokens for batch sizes 1-8, a traced step and the peak memory;
8. the remaining decoder-only families at published widths, f32, seeded
   random weights, the hybrid freed first; each model prints its
   parameters, GB, build time and peak memory. (a) granite-moe-1b-a400m
   and phi3-mini-3.8b whole, as served stages: graphs at buckets 1-128
   held against the eager forward, the profile 1-128 on ``h100-1``, a
   plan for each stage alone at phase 4b's 30 qps and 250 ms SLO served
   through the executor beside the Estimator, then prefill 8 x 512 and
   greedy steps against the forward; (b) deepseek-v3-671b cut to its
   first dense layer and one MoE layer (256 experts, top-8 + shared,
   MTP depth 1; widths unchanged): the forward with its aux (routers +
   MTP), then prefill 8 x 512 through the flash kernel at D 192 / Dv
   128 and greedy steps of the absorbed decode; (c) granite-34b cut to
   8 layers and qwen2-72b to 4: prefill and greedy decode (decode
   attention at G 48 with D 128, and G 8 with QKV bias). A MoE model's
   decode check runs with every expert's capacity at its group's token
   count (drop-free, as a decode step is), since a prefill at capacity
   1.25 drops the assignments that come last in the batch's order, and
   a dropped token's logits are by design not a decode step's;
9. the planner's device sweep (the reference's ``bench_planner_scale
   --backend jax``) through the fill kernel ``sim_fill`` and the select
   kernel ``sim_select``: (a) the fill held bit for bit against its
   plain version on the card and the numpy fill, static pools at eff 1 /
   8 / 128 and 1 / 3 / 16 / 32 replicas (in registers) and 512 (in
   shared memory) with and without a timeout on 4096-query queues in
   three load regimes, ties, +inf arrivals and one query, dynamic pools
   with scale-up and scale-down events, and its latency rows against the
   plain assembly; the select against its plain version and
   np.partition on rows with ties, +inf and FAR_FUTURE tails, one value,
   a shared segment (k < n) and all values equal, and on both of its
   paths (rows at the cluster's capacity -1, at it and +1, odd k, one
   lane, NaN), at p 0, 50, 99 and 100, two calls bit-equal; then, with
   every counter zeroed before and read after, (b) the
   1200-candidate sink sweep on an hour of bursty image-processing
   traffic with numpy and with torch (cold, warm), equal with ``==``,
   its wall times and the warm run's split (inputs, fill, select, copy
   back, host lerp, the rest), timed from outside the sim package: the
   host clock around the sweep, the uploads, the copy back and the lerp,
   CUDA events around each kernel; two launches a chunk, (C, 2) doubles
   copied back and no np.partition; and (c) Planner and BeamPlanner
   plans on the four motifs, numpy against torch with the grid's
   thresholds as they are and with every grid sent to the card; then
   each kernel's device time and its plain version's at the sweep's
   shape, the select's beside ``torch.kthvalue`` with its path, cluster
   size, resident clusters and bytes read, its launches by path, and
   (d) one fill,
   numpy against the kernel forced on, at 4096, 32768 and 262144
   queries;
10. train llama3.2-1b at published width on one card (16L x 2048, f32,
   remat, AdamW(lr=1e-3), seeded random weights): (a) one train step on
   the smoke config on the card against the CPU (loss, every leaf's
   gradient and first moment); (b) at full width, B 2 x 512, one step's
   gradients through the kernels against the plain versions on the card,
   per leaf within 5e-4 of the leaf's largest entry; (c) the main path:
   ``make_train_step`` on ``batches(cfg, 2, 4096)`` (train_4k's length,
   its batch of 256 cut to 2), one warm-up and 8 timed steps, each
   step's launches exact (rmsnorm 65, flash forward 32, backward 16),
   ms a step, tokens/s, peak memory, the device's busy share of a traced
   step, and the losses: finite, the mean of the last 3 below the first;
11. with at least four cards, sharded serving over NCCL, four ranks
   spawned one a card (``repro_torch.models.parallel``: TP over
   ``model``, FSDP over ``data``): (a) qwen2-72b cut to phase 8's 4
   layers, f32, the same seeded weights on one card and split over (1,
   4) and (2, 2): the forward's logits of 8 x 32, prefill 8 x 512 and 16
   greedy steps into 1024 slots, within 1e-4 (max |dlogit| / max
   |logit|) of the one-card run with every greedy token equal; (b)
   granite-moe-1b-a400m whole on (1, 4), drop-free, the same bar; (c)
   qwen2-72b whole, 80 layers at published width in bf16 (the dry-run's
   serving policy), each card drawing its own shards: prefill 8 x 512
   into 1024 slots and 32 greedy steps, their times, tokens/s, each
   card's peak, one traced step's busy and NCCL shares on rank 0, and
   each rank's launches (every rank must launch flash, decode attention
   and rmsnorm, exactly as the config implies); (d) the port's dry-run of
   (c) on the (1, 4) mesh beside (c)'s measured peak; (e) granite-34b's
   sequence-split decode; (f)-(i) DeepSeek-V3 and Jamba cut and whole;
   (j) xlstm-125m, (k) whisper-small (1500 stub frames a row) and (l)
   pixtral-12b whole (40 layers, 1024 stub patches a row, rank 0's
   weights broadcast a leaf at a time), f32 at published width, against
   one card on both meshes at (a)'s bar ((j): the same weights and
   batches also run in f64; its forward is held to the f64 run at (a)'s
   bar, its prefill and steps to the one-card run at (a)'s bar and to
   the f64 run at 1.1 times the one-card run's own distance from it,
   its tokens to the one-card run's),
   phase 12's prompts, each mesh's shards a card, peak and seconds
   logged. On fewer cards it prints "not run";
12. the recurrent, encoder-decoder and image families at published
   width, f32, seeded random weights, each freed before the next: (a)
   xlstm-125m, prefill 8 x 512 and 64 greedy steps through its carried
   state; (b) whisper-small (12 + 12 layers x 768), 8 x 1500 stub frames
   through the encoder, a 64-token prompt into 448 slots and 64 greedy
   steps over the cross cache; (c) pixtral-12b, all 40 layers (49 GB of
   f32 weights), 4 x (1024 stub patch embeddings + 64 text tokens) into
   1152 slots and 32 greedy steps. Each as phase 6: the launches of a
   prefill and the steps exact, every step's logits against the port's
   forward over the same tokens and features, the greedy tokens equal,
   the prefill and step times, tokens/s, a traced step's busy share and
   the peak memory, with the card's name and power limit;
13. train the hybrid: the expert-free Jamba-1.5-Large at published
   width cut to its period's blocks [3:5] (one Mamba layer with its
   dense FFN, the attention layer: 2,836,250,624 parameters, f32, remat,
   AdamW(lr=1e-3)), as phase 10: (a) one train step on Jamba's smoke
   config (drop-free, its scan in two chunks) on the card against the
   CPU; (b) B 1 x 512, the gradients through the kernels against the
   plain versions on the card; (c) the main path on ``batches(cfg, 1,
   4096)`` (train_4k's length, its batch cut to 1): one warm-up and 8
   timed steps, each step's launches exact (rmsnorm 9, flash forward 2
   and backward 1, the scan's forward 32 and backward 16), ms a step,
   tokens/s, peak memory, a traced step's busy share and top kernels,
   the losses finite and falling; phase 2 holds the scan's backward
   kernel (``csrc/mamba_scan_bwd.cu``) against its plain reverse
   recurrence at the training chunk and edge shapes (f32 5e-4, bf16 3e-2
   of each output's largest entry; two calls bit-equal) and times it;
   phases 3-9 and 12 must launch no backward kernel;
14. the examples on the card, each as its own process (``python -m
   repro_torch.examples.<name>``): ``serve_real_models`` at its default,
   published width on ``h100-1`` (its exit code, its plan, every live
   query answered, the closed loop's scale-up, nothing released; its
   measured p50/p99/miss beside the Estimator's) and ``train_arch --arch
   jamba-1.5-large-398b --steps 100`` (it learns and round-trips its
   checkpoint), with each one's wall time;
15. train the MoE and encoder-decoder families at published width on one
   card, f32, remat, AdamW(lr=1e-3), as phase 10: granite-moe-1b-a400m
   (B 2 x 4096; (a) and (b) drop-free, (c) at its published capacity
   factor 1.25) and whisper-small (B 8 x 2048 tokens, 1500 stub frames a
   row); (b) at B 1 x 512; (c) one warm-up and 4 timed steps, launches a
   step exact (granite-moe 97 rmsnorm, 48 flash forward, 24 backward;
   whisper 122 / 72 / 36), ms a step, tokens/s, TFLOP/s of 6 N T, the
   peak beside the port's dry-run of the same step, a traced step, the
   losses finite and falling. Where a MoE's gradients are held against
   another run's, that run's routes are replayed (``Routes``): a near
   tie between experts that rounding flips moves a token's gradient;
16. with at least four cards, training sharded over NCCL, four ranks
   spawned as in phase 11: (a) granite-moe-1b-a400m whole, drop-free, B
   2 x 4096, and (b) pixtral-12b cut to 2 layers at full width, B 2 x
   (1024 stub patches + 3072 tokens), each one make_train_step with
   AdamW on (1, 4) and (2, 2) against one card: the loss, every
   gradient leaf made whole and every first moment within 5e-4 of the
   leaf's largest entry; (c) deepseek-v3-671b 1 dense + 1 MoE layer with
   MTP, f32, drop-free, on (1, 4), B 1 x 512: each rank's gradients
   through the kernels against the plain versions on the same cards;
   (d) pixtral-12b whole, f32, B 1 x (1024 + 3072), and (e) the DeepSeek
   cut under the dry-run's training policy (bf16 parameters and compute)
   at its published capacity, B 1 x 4096, each on (1, 4) from
   ``init_local``: one warm-up and 3 timed steps, launches exact on
   every rank, ms a step, tokens/s, each card's peak beside the port's
   dry-run, one traced step's busy and NCCL shares, the collectives of a
   step, the losses finite, falling and the same on every rank. On
   fewer cards it prints "not run".

The line before the last is a JSON object with one record per kernel;
the last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import functools
import gc
import json
import operator
import os
import re
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch.core.hardware import (  # noqa: E402
    H100_HBM_BW,
    H100_PEAK_FLOPS_BF16,
    H100_PEAK_FLOPS_F32,
    H100_PEAK_FLOPS_F64,
    H100_PEAK_FLOPS_TF32,
    get_hardware,
)
from repro_torch.core.estimator import Estimator  # noqa: E402
from repro_torch.core.pipeline import (  # noqa: E402
    PipelineConfig,
    StageConfig,
    linear_pipeline,
)
from repro_torch.core.planner import BeamPlanner, Planner  # noqa: E402
from repro_torch.core.profiler import (  # noqa: E402
    ProfileStore,
    profile_model_measured,
)
from repro_torch.core.tuner import (  # noqa: E402
    REPLICA_ACTIVATION_S,
    ClosedLoopTuner,
    TunerPlanInfo,
)
from repro_torch.faults import FaultSchedule, RecoveryPolicy, crash  # noqa: E402
from repro_torch.configs import get_arch, get_smoke, without_experts  # noqa: E402
from repro_torch.configs.pipelines import MOTIFS, get_motif  # noqa: E402
from repro_torch.kernels import _build, ref  # noqa: E402
from repro_torch.kernels import decode_attention as da_mod  # noqa: E402
from repro_torch.kernels import flash_attention as fa_mod  # noqa: E402
from repro_torch.kernels import mamba_scan as ms_mod  # noqa: E402
from repro_torch.kernels import rmsnorm as rms_mod  # noqa: E402
from repro_torch.kernels import sim_fill, sim_select  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.model import AUDIO_FEAT_DIM, IMAGE_FEAT_DIM  # noqa: E402
from repro_torch.models.config import dense_segments  # noqa: E402
from repro_torch.kernels import ops as kernel_ops  # noqa: E402
from repro_torch.train import AdamW, make_train_step  # noqa: E402
from repro_torch.train.trainer import value_and_grad  # noqa: E402
from repro_torch.train.data import batches  # noqa: E402
from repro_torch.train.tree import leaves as tree_leaves, tree_map  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    SEQ,
    LiveControlLoop,
    PipelineExecutor,
    ProcessReplicaPool,
    ProcessStage,
    make_stage,
    worker_counts,
)
from repro_torch.sim import (  # noqa: E402
    ControlLoopSession,
    NoOpController,
    SimEngine,
    simulate_stage,
)
from repro_torch.sim import torch_backend  # noqa: E402
from repro_torch.workload import gamma_trace  # noqa: E402

TOL = {torch.float32: dict(atol=2e-5, rtol=2e-5),
       torch.bfloat16: dict(atol=3e-2, rtol=3e-2)}
PEAK = {torch.float32: H100_PEAK_FLOPS_F32,
        torch.bfloat16: H100_PEAK_FLOPS_BF16}
SERVE_BATCH = 8                 # StageConfig.batch_size of the served run
SERVE_QPS, SERVE_S, SLO_S = 20.0, 10.0, 0.25
# examples/serve_real_models.py: LAMBDA, the sample trace the Planner
# provisions for and the live trace served on its plan
PLAN_QPS, PLAN_SAMPLE_S, PLAN_LIVE_S = 30.0, 20.0, 15.0
PROFILE_BATCHES = (1, 2, 4, 8, 16, 32, 64, 128)
# examples/serve_real_models.py step 5: the Tuner's cap, its sample trace
# and control epoch; the spike is spike_trace()
TUNE_MAX_REPLICAS, TUNE_SAMPLE_S, TUNE_EPOCH_S = 4, 60.0, 1.0
SLOT_THREADS = (1, 2, 4)        # phases 4e, 4g: replicas at once
# phase 4f: when each stage's worker is SIGKILLed (mid-epoch, after 4b's
# live trace has filled both stages), the bound on a fleet of workers
# becoming ready, round trips timed a stage, and the ring's depth (the
# batches a killed worker can hold)
PROC_CRASH_T = (4.5, 6.5)
PROC_READY_S = 300.0
PROC_REPS = 20
PROC_RING = 2
GPU_CARDS = 4                   # phase 4g: one replica a card
STAGES = ("xlstm-125m", "llama3.2-1b")
DECODE_BATCH, PROMPT, SMAX, STEPS = 8, 512, 1024, 64
HYBRID = "jamba-1.5-large-398b"
HYBRID_STEPS = 32
HYBRID_BATCHES = (1, 2, 4, 8)
# phase 8: the served families, DeepSeek's two-layer cut, the depth cuts
FAMILY_STAGES = ("granite-moe-1b-a400m", "phi3-mini-3.8b")
DEEPSEEK = "deepseek-v3-671b"
DEPTH_CUTS = (("granite-34b", 8), ("qwen2-72b", 4))
FAMILY_STEPS = 16
DROP_FREE_GROUPS = 2 * DECODE_BATCH     # MoE groups of a decode check
# phase 9: the reference's device-planner benchmark
# (benchmarks/bench_planner_scale.py --backend jax): the sweep's motif,
# trace and grid, the plans' trace and SLOs, the crossover's lengths,
# and the queries of the reference's sweep trace (its artifact)
SWEEP_MOTIF = "image-processing"
SWEEP_TRACE = dict(lam=30.0, cv=4.0, duration_s=3600.0, seed=11)
SWEEP_QUERIES_REF = 107487
SWEEP_HW = ("tpu-v5e-16", "tpu-v5e-8", "tpu-v5e-4")
SWEEP_BATCHES = (1, 2, 4, 8, 16)
SWEEP_REPLICAS = tuple(range(1, 17))
SWEEP_TIMEOUTS = (0.0, 0.005, 0.01, 0.025, 0.05)
PLAN_TRACE = dict(lam=200.0, cv=4.0, duration_s=60.0, seed=10)
CROSSOVER_K = (4096, 32768, 262144)
FILL_K = 4096                   # phase 9a's queues
COUNTERS = {"rmsnorm": rms_mod.counter, "flash_attention": fa_mod.counter,
            "decode_attention": da_mod.counter,
            "mamba_scan": ms_mod.counter}
# the port's kernels, by the function names a profiler trace shows
PORT_KERNELS = ("rmsnorm_kernel", "rmsnorm_row_kernel", "flash_fwd_kernel",
                "decode_", "mamba_scan_kernel", "mamba_step_kernel",
                "flash_bwd_", "mamba_scan_bwd")
# phase 11: sharded serving over NCCL on four cards: qwen2-72b cut to
# phase 8's depth and granite-moe whole, each against its one-card run,
# on these meshes; granite-34b cut to phase 8's depth on (1, 4), whose
# one KV head puts the cache's sequence over model; qwen2-72b whole at
# the dry-run's serving policy
PAR_CARDS = 4
PAR_CUT = dict(DEPTH_CUTS)["qwen2-72b"]
PAR_SPLIT_CUT = dict(DEPTH_CUTS)["granite-34b"]
PAR_MESHES = ((1, 4), (2, 2))
PAR_FWD = (8, 32)               # the forward's batch x tokens
PAR_STEPS, PAR_WHOLE_STEPS = 16, 32
PAR_REL = 1e-4                  # max |dlogit| / max |logit|
# phase 11 (j): a sharded run's prefill and steps may sit at most this
# times as far from the f64 run as the one-card f32 run does. Every f32
# run of xlstm-125m sits 1.8-4.7e-4 from f64 there (the CPU, the plain
# versions on the card, one card, both meshes: PERF.md section 6), since
# its group norm scales a tiny row up, so no f32 run meets PAR_REL
# against f64; the steps also stay within PAR_REL of the one-card run
PAR_F64_MARGIN = 1.1
PAR_JOIN_S = 900
# phase 11 (f)-(i), the two models no card holds, over the same meshes:
# (f) deepseek-v3-671b cut as phase 8 (b) cuts it (its first dense layer
# and one MoE layer, MTP's module, f32) and (g) jamba-1.5-large-398b with
# its experts, its period's blocks [3:5] (a Mamba layer with its MoE, the
# attention layer with its dense FFN), f32, each against one card, with
# rank 0's weights broadcast a leaf at a time; (h) deepseek-v3-671b at
# the most layers four cards hold, bf16 (the dry-run's serving policy):
# 3 dense + 9 MoE layers, 107,169,357,824 parameters, 54.44 GB of shards
# a card; (i) one whole period of Jamba, its 4 MoE layers, f32:
# 45,120,667,648 parameters, 45.12 GB of shards a card
PAR_DEEPSEEK_CUT = (1, 1)       # dense, MoE layers
PAR_HYBRID_BLOCKS = (3, 5)
PAR_DEEPSEEK_WHOLE = (3, 9)
# phase 11 (j)-(l): xlstm-125m, whisper-small (1500 stub frames a row)
# and pixtral-12b whole (40 layers, 49.0 GB in f32; 1024 stub patches a
# row, rank 0's weights broadcast a leaf at a time) at published width,
# f32, each against one card on both meshes: (arch, batch, text prompt,
# cache slots) as phase 12 decodes them
PAR_FAMILIES = (("j", "xlstm-125m", DECODE_BATCH, PROMPT, SMAX),
                ("k", "whisper-small", DECODE_BATCH, 64, 448),
                ("l", "pixtral-12b", 4, 64, 1152))
# phase 10: llama3.2-1b trained at published width, f32 (the reference's
# dtype), remat on as the dry-run sets it for every train shape
# (src/repro/launch/shapes.py:124-127); train_4k's sequence length with
# its batch of 256 cut to 2 to fit one card; the example's AdamW(lr=1e-3)
TRAIN_ARCH = "llama3.2-1b"
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 2, 4096, 8
TRAIN_LR = 1e-3
GRAD_SEQ = 512                  # the kernels-vs-plain gradient check
# the backward's bar against its plain version (the reference's bar for
# its flash VJP against the oracle's autodiff, tests/test_kernels.py:213)
BWD_TOL = {torch.float32: dict(atol=5e-4, rtol=5e-4),
           torch.bfloat16: dict(atol=3e-2, rtol=3e-2)}
SMOKE_TRAIN_SEQ = 64            # the smoke step against the CPU
# phase 13: the expert-free Jamba (configs.without_experts) at published
# width cut in depth to its period's blocks [3:5], one Mamba layer (its
# MoE FFN made dense) and the attention layer: 2,836,250,624 parameters,
# 45.38 GB of f32 parameters, gradients and two AdamW moments (the whole
# period's 142.1 GB does not fit one card); train_4k's length with its
# batch cut to 1: 16 scan chunks of 256 a Mamba layer
HYBRID_TRAIN_BLOCKS = (3, 5)
HYBRID_TRAIN_BATCH, HYBRID_TRAIN_SEQ = 1, 4096
HYBRID_SMOKE_SEQ = 128          # the smoke step's scan in two chunks of 64
# phase 14: the examples, each a process of its own
EXAMPLE_TRAIN_ARGS = ("--arch", HYBRID, "--steps", "100")
EXAMPLE_TIMEOUT_S = 420
# phase 15: the MoE and encoder-decoder families trained at published
# width on one card, f32, remat, as phase 10: (arch, batch, text tokens a
# row), train_4k's length (whisper: its decoder half, beside the data
# pipeline's encoder_max_frames stub frames) with the batch cut to fit;
# (b) at B 1 x GRAD_SEQ; fewer timed steps than phase 10, for the
# script's time limit
P15_RUNS = (("granite-moe-1b-a400m", 2, 4096), ("whisper-small", 8, 2048))
P15_STEPS = 4
# phase 16: training sharded over NCCL on four cards, f32 unless said:
# (a) granite-moe-1b-a400m whole, drop-free, and (b) pixtral-12b cut to
# P16_PIXTRAL_CUT layers, each one step against one card on PAR_MESHES at
# (batch, text tokens a row); (c) DeepSeek 1 + 1 with MTP, drop-free, on
# (1, 4), the kernels against the plain versions on the same cards; (d)
# pixtral-12b whole, f32, and (e) DeepSeek 1 + 1 under the dry-run's
# training policy (bf16 parameters and compute, remat) at the published
# capacity, each trained on (1, 4) for 1 + P16_STEPS steps and one traced
P16_AGAINST = (("a", "granite-moe-1b-a400m", 2, 4096),
               ("b", "pixtral-12b", 2, 3072))
P16_PIXTRAL_CUT = 2
P16_DEEPSEEK_GRAD = (1, GRAD_SEQ)
P16_WHOLE = (("d", "pixtral-12b", 1, 3072), ("e", DEEPSEEK, 1, 4096))
P16_STEPS = 3
# phase 12: (arch, batch, text prompt, cache slots, greedy steps) at
# published width; whisper takes encoder_max_frames (30 s) of stub
# frames, pixtral its 1024 stub patch embeddings before the prompt
P12_RUNS = (("xlstm-125m", DECODE_BATCH, PROMPT, SMAX, 64),
            ("whisper-small", DECODE_BATCH, 64, 448, 64),
            ("pixtral-12b", 4, 64, 1152, 32))


def _layers(segments) -> list:
    return [b for seg in segments for b in seg.blocks
            for _ in range(seg.repeat)]


def _norms(blocks) -> int:
    """A norm before every block's core and before its MLP or MoE."""
    return len(blocks) + sum(b.ffn != "none" for b in blocks)


def launches_per_forward(cfg, seq: int, mtp: bool = False,
                         encoder: bool = True) -> dict:
    """Launches of one forward or prefill over ``seq`` tokens: a norm
    before every block's core and before its MLP or MoE, plus the final
    norm (33 for llama3.2-1b, 13 for xlstm-125m, 17 for the one-period
    hybrid, 81 for pixtral-12b); one flash attention per attention
    block; one scan per Mamba block and chunk of ``min(ssm_chunk, seq)``
    tokens (one chunk when ``seq`` is not a multiple). With ``mtp``, the
    forward's MTP module adds its block's two norms, its own norm and a
    flash call (MLA's latent norms are plain, as the reference's are).
    An encoder-decoder config adds, a decoder attention block, the
    cross-attention's norm and flash call, and with ``encoder`` the
    encoder's norms, its final norm and a flash call a layer (whisper:
    62 norms, 36 flash)."""
    blocks = _layers(cfg.segments)
    enc = _layers(cfg.encoder_segments) if encoder else []
    attn = sum(b.kind == "attn" for b in blocks)
    cross = attn if cfg.is_encoder_decoder else 0
    chunk = min(cfg.ssm_chunk, seq)
    chunks = seq // chunk if seq % chunk == 0 else 1
    return {"rmsnorm": _norms(blocks) + 1 + 3 * mtp + cross
            + (_norms(enc) + 1 if enc else 0),
            "flash_attention": attn + mtp + cross
            + sum(b.kind == "attn" for b in enc),
            "decode_attention": 0,
            "mamba_scan": chunks * sum(b.kind == "mamba" for b in blocks)}


def launches_per_step(cfg) -> dict:
    """Launches of one decode step: decode attention where the forward
    runs self-attention through flash (MLA's absorbed decode is plain
    torch, as the reference's), one scan per Mamba block; no encoder,
    and a decoder block's cross-attention over the cached frames stays
    flash with one query row (the reference's route), so whisper's step
    is 37 norms, 12 decode attention and 12 flash."""
    per = launches_per_forward(cfg, 1, encoder=False)
    self_attn = sum(b.kind == "attn" for b in _layers(cfg.segments))
    per["decode_attention"] = 0 if cfg.use_mla else self_attn
    per["flash_attention"] -= self_attn
    return per


def log(msg: str) -> None:
    print(msg, flush=True)


def counts() -> dict:
    return {name: c.count for name, c in COUNTERS.items()}


def bwd_counts() -> tuple:
    """Launches of the two backward kernels so far."""
    return fa_mod.bwd_counter.count, ms_mod.bwd_counter.count


def reset_counts() -> None:
    for c in COUNTERS.values():
        c.reset()


def nvidia_smi(query: str = "name,power.limit") -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 200, warmup: int = 20) -> float:
    """Mean device time per call over back-to-back calls, CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def time_in_turns(fns, iters, rounds: int = 5) -> list:
    """The best of ``rounds`` :func:`time_ms` readings of each function,
    taken in turns (a b c, c b a, ...) so that both sides of a
    comparison meet the same host and card state."""
    best = [float("inf")] * len(fns)
    for r in range(rounds):
        order = range(len(fns)) if r % 2 == 0 else reversed(range(len(fns)))
        for i in order:
            best[i] = min(best[i], time_ms(fns[i], iters=iters[i],
                                           warmup=min(20, iters[i])))
    return best


def rand(gen: torch.Generator, shape, dtype) -> torch.Tensor:
    return torch.randn(shape, generator=gen, device="cuda").to(dtype)


def assert_close(got: torch.Tensor, exp: torch.Tensor, dtype,
                 what: str) -> float:
    err = float((got.float() - exp.float()).abs().max()) if got.numel() \
        else 0.0
    torch.testing.assert_close(got.float(), exp.float(), **TOL[dtype],
                               msg=lambda m: f"{what}: {m}")
    return err


# ---------------------------------------------------------------- phase 2

def check_rmsnorm(gen: torch.Generator) -> None:
    for dtype in (torch.float32, torch.bfloat16):
        for d in (768, 2048, 8192):
            for rows in (32, 512, 7):
                x = rand(gen, (rows, d), dtype)
                g = rand(gen, (d,), dtype)
                got = rms_mod.rmsnorm(x, g)
                torch.cuda.synchronize()
                err = assert_close(got, ref.rmsnorm_ref(x, g), dtype,
                                   f"rmsnorm rows={rows} D={d} {dtype}")
                log(f"  rmsnorm  rows={rows:4d} D={d:4d} {str(dtype):14s} "
                    f"max_abs_err={err:.3e}  ok")


FLASH_CASES = (
    # (name, b, sq, sk, h, kv, d, dv, causal, window)
    ("llama B=1", 1, 32, 32, 32, 8, 64, 64, True, 0),
    ("llama B=8", 8, 32, 32, 32, 8, 64, 64, True, 0),
    ("Sq<Sk", 1, 64, 160, 32, 8, 64, 64, True, 0),
    ("window 16", 2, 96, 96, 8, 2, 64, 64, True, 16),
    ("D!=Dv", 1, 64, 64, 4, 2, 128, 64, True, 0),
    ("D!=Dv small", 2, 48, 48, 4, 1, 64, 32, True, 0),
    ("ragged 40x40", 2, 40, 40, 4, 2, 64, 64, True, 0),
    ("full Sk=96", 1, 32, 96, 4, 4, 64, 64, False, 0),
    ("MQA 200", 1, 200, 200, 8, 1, 64, 64, True, 0),
    ("MHA G=1", 2, 64, 64, 8, 8, 64, 64, True, 0),
    # 37 positions x 3 heads = 111 packed rows: the last q tile is ragged
    ("G=3 ragged", 2, 37, 37, 6, 2, 64, 64, True, 0),
    ("Sq<Sk window", 1, 50, 120, 8, 2, 64, 128, True, 24),
    ("Sq>Sk", 1, 48, 16, 4, 1, 32, 32, True, 0),
    ("llama prefill", 8, 512, 512, 32, 8, 64, 64, True, 0),
    # the hybrid's attention layer: 64 q heads over 8, D = Dv = 128
    ("hybrid B=2", 2, 512, 512, 64, 8, 128, 128, True, 0),
    ("hybrid 544", 1, 544, 544, 64, 8, 128, 128, True, 0),
    # DeepSeek-V3's MLA, its K/V expanded a head: G 1 at 128 heads, D 192
    # (128 + 64 RoPE dims), Dv 128
    ("MLA scoring", 8, 32, 32, 128, 128, 192, 128, True, 0),
    ("MLA prefill", 2, 512, 512, 128, 128, 192, 128, True, 0),
    ("MLA ragged", 2, 77, 200, 128, 128, 192, 128, True, 0),
)


# the split-sequence decode's calls (Parallel.split_decode): one query
# row, every head, against one rank's slice of a cache whose sequence is
# split over model, with each row's logsumexp, non-causal; granite-34b's
# 48 heads on its one KV head at (1, 4) (SMAX / 4 slots a rank, phase
# 11 (e)) and qwen2-72b's 64 on 8 on model 16 (a slice partly valid)
FLASH_LSE_CASES = (
    # (name, b, sk, h, kv, d)
    ("split gr-34b", DECODE_BATCH, SMAX // PAR_CARDS, 48, 1, 128),
    ("split qwen2", DECODE_BATCH, 37, 64, 8, 128),
)


def check_flash(gen: torch.Generator) -> None:
    for dtype in (torch.float32, torch.bfloat16):
        for name, b, sq, sk, h, kv, d, dv, causal, window in FLASH_CASES:
            q = rand(gen, (b, sq, h, d), dtype)
            k = rand(gen, (b, sk, kv, d), dtype)
            v = rand(gen, (b, sk, kv, dv), dtype)
            got = fa_mod.flash_attention(q, k, v, causal=causal,
                                         window=window)
            torch.cuda.synchronize()
            exp = ref.flash_attention_ref(q, k, v, causal=causal,
                                          window=window)
            err = assert_close(got, exp, dtype, f"flash {name} {dtype}")
            log(f"  flash    {name:13s} {str(dtype):14s} "
                f"max_abs_err={err:.3e}  ok")
        for name, b, sk, h, kv, d in FLASH_LSE_CASES:
            q = rand(gen, (b, 1, h, d), dtype)
            k = rand(gen, (b, sk, kv, d), dtype)
            v = rand(gen, (b, sk, kv, d), dtype)
            got, lse = fa_mod.flash_attention_with_lse(q, k, v, causal=False)
            torch.cuda.synchronize()
            exp, exp_lse = ref.flash_attention_ref(q, k, v, causal=False,
                                                   return_lse=True)
            err = assert_close(got, exp, dtype, f"flash {name} {dtype}")
            torch.testing.assert_close(
                lse, exp_lse, **TOL[torch.float32],
                msg=lambda m: f"flash {name} {dtype} lse: {m}")
            lse_err = float((lse - exp_lse).abs().max())
            log(f"  flash    {name:13s} {str(dtype):14s} "
                f"max_abs_err={err:.3e}, lse {lse_err:.3e}  ok")


# the f32 forward's O against the same attention run in f64 where its P
# V sums run long: whisper's cross-attention (2048 queries over 1500
# frames) and pixtral's 4096 keys. Each row (a query at a head) is held
# to its own largest |O|, since a causal row's O shrinks as it sees more
# keys. With P V added straight into O, the MMAs' truncating f32
# accumulation left such rows 2.4e-05 / 5.4e-05 off; through a tile of
# its own, 4.7e-06 / 5.6e-06 (tools/flash_fwd_vs_parent.py, PERF.md)
FLASH_F64_CASES = (
    # (name, b, sq, sk, h, kv, d, dv, causal)
    ("whisper cross", 2, 2048, 1500, 12, 12, 64, 64, False),
    ("pixtral 4096", 1, 4096, 4096, 32, 8, 128, 128, True),
)
FLASH_F64_REL = 1e-5


def flash_f64_errors(fn=None) -> list:
    """(name, worst row's max |O - O_f64| / max |O_f64|, the same over
    the whole output) for each of FLASH_F64_CASES, on f32 inputs drawn
    from a generator of their own; ``fn(q, k, v, causal)`` is the
    forward under test, the kernel by default."""
    if fn is None:
        def fn(q, k, v, causal):
            return fa_mod.flash_attention(q, k, v, causal=causal)
    gen = torch.Generator(device="cuda").manual_seed(5)
    out = []
    for name, b, sq, sk, h, kv, d, dv, causal in FLASH_F64_CASES:
        q = rand(gen, (b, sq, h, d), torch.float32)
        k = rand(gen, (b, sk, kv, d), torch.float32)
        v = rand(gen, (b, sk, kv, dv), torch.float32)
        got = fn(q, k, v, causal).double()
        with Float64():
            exp = ref.flash_attention_ref(q, k, v, causal=causal)
        diff = (got - exp).abs()
        out.append((name, float((diff.amax(-1) / exp.abs().amax(-1)).max()),
                    float(diff.max() / exp.abs().max())))
        del q, k, v, got, exp, diff
    return out


def check_flash_against_f64() -> None:
    plain = flash_f64_errors(lambda q, k, v, causal: ref.flash_attention_ref(
        q, k, v, causal=causal))
    for (name, row, whole), (_, p_row, _) in zip(flash_f64_errors(), plain):
        log(f"  flash    {name:13s} f32 against f64: worst row "
            f"{row:.3e} of its largest |O| (bar {FLASH_F64_REL:g}; the "
            f"plain version in f32 {p_row:.3e}), whole output {whole:.3e}")
        if not row <= FLASH_F64_REL:
            raise RuntimeError(f"flash {name} f32 against f64: {row:.3e}")


# the backward at the training shape and at edge shapes: the reference's
# five cases (tests/test_kernels.py:183-189, B 2, D 64), G 1 / 2 / 4,
# window 64, D 128, MLA's D 192 / Dv 128, Sq > Sk (rows that see no key)
FLASH_BWD_CASES = (
    # (name, b, sq, sk, h, kv, d, dv, causal, window)
    ("train 4k", TRAIN_BATCH, TRAIN_SEQ, TRAIN_SEQ, 32, 8, 64, 64, True, 0),
    ("ref 256 G1", 2, 256, 256, 4, 4, 64, 64, True, 0),
    ("ref 128x384 G2", 2, 128, 384, 4, 2, 64, 64, True, 0),
    ("ref full G4", 2, 256, 256, 4, 1, 64, 64, False, 0),
    ("ref window 64", 2, 256, 256, 8, 2, 64, 64, True, 64),
    ("ref 100x200", 2, 100, 200, 4, 2, 64, 64, True, 0),
    ("D 128 G 8", 2, 192, 192, 64, 8, 128, 128, True, 0),
    ("MLA 192/128", 1, 160, 160, 16, 16, 192, 128, True, 0),
    ("D!=Dv 64/32", 2, 70, 90, 6, 3, 64, 32, True, 16),
    ("Sq>Sk", 1, 48, 16, 4, 1, 32, 32, True, 0),
    # phases 15 and 16's training shapes: whisper's encoder (1500 frames,
    # not a multiple of a tile) and its cross-attention over them,
    # pixtral's self-attention, MLA at 4096 with 32 heads a rank
    ("whisper enc", 8, 1500, 1500, 12, 12, 64, 64, False, 0),
    ("whisper cross", 8, 2048, 1500, 12, 12, 64, 64, False, 0),
    ("pixtral 4k", 1, 4096, 4096, 32, 8, 128, 128, True, 0),
    ("MLA 4k 32h", 1, 4096, 4096, 32, 32, 192, 128, True, 0),
)


def flash_bwd_inputs(gen, b, sq, sk, h, kv, d, dv, causal, window, dtype):
    """q, k, v, the kernel's forward (out, lse) and a dO."""
    q = rand(gen, (b, sq, h, d), dtype)
    k = rand(gen, (b, sk, kv, d), dtype)
    v = rand(gen, (b, sk, kv, dv), dtype)
    out, lse = fa_mod._launch(q, k, v, causal, window, None, want_lse=True)
    return q, k, v, out, lse, rand(gen, (b, sq, h, dv), dtype)


def check_flash_bwd(gen: torch.Generator) -> None:
    """The forward's lse against the plain version's, then the backward
    kernel against its plain version on the same (q, k, v, out, lse,
    dO), f32 5e-4 and bf16 3e-2; a row that sees no key gets zero dQ."""
    for dtype in (torch.float32, torch.bfloat16):
        for name, b, sq, sk, h, kv, d, dv, causal, window in FLASH_BWD_CASES:
            q, k, v, out, lse, do = flash_bwd_inputs(
                gen, b, sq, sk, h, kv, d, dv, causal, window, dtype)
            exp_out, exp_lse = ref.flash_attention_ref(
                q, k, v, causal=causal, window=window, return_lse=True)
            assert_close(out, exp_out, dtype, f"flash {name} out")
            seen = torch.isfinite(exp_lse)
            if not torch.equal(seen, torch.isfinite(lse)):
                raise RuntimeError(f"flash {name}: lse is +inf on other "
                                   f"rows than the plain version's")
            lse_err = float((lse[seen] - exp_lse[seen]).abs().max())
            torch.testing.assert_close(
                lse[seen], exp_lse[seen], **TOL[torch.float32],
                msg=lambda m: f"flash {name} {dtype} lse: {m}")
            before = fa_mod.bwd_counter.count
            got = fa_mod._launch_bwd(q, k, v, out, lse, do, causal, window,
                                     None)
            torch.cuda.synchronize()
            if fa_mod.bwd_counter.count != before + 1:
                raise RuntimeError("flash backward: the call did not count "
                                   "one launch")
            exp = ref.flash_attention_bwd_ref(q, k, v, out, lse, do,
                                              causal=causal, window=window)
            errs = []
            for what, g, e in zip(("dq", "dk", "dv"), got, exp):
                errs.append(float((g.float() - e.float()).abs().max()))
                torch.testing.assert_close(
                    g.float(), e.float(), **BWD_TOL[dtype],
                    msg=lambda m: f"flash bwd {name} {dtype} {what}: {m}")
            if not seen.all() and got[0][~seen].abs().max() != 0:
                raise RuntimeError(f"flash bwd {name}: a row that sees no "
                                   f"key has a nonzero dQ")
            again = ""
            if name == FLASH_BWD_CASES[0][0]:
                # deterministic: no atomics, a fixed order of every sum
                if not all(torch.equal(a, b) for a, b in zip(
                        got, fa_mod._launch_bwd(q, k, v, out, lse, do,
                                                causal, window, None))):
                    raise RuntimeError(f"flash bwd {name} {dtype}: two "
                                       f"calls differ")
                again = "; a second call bit-equal"
            log(f"  flash bwd {name:14s} {str(dtype):14s} lse "
                f"{lse_err:.3e} dq/dk/dv max_abs_err "
                f"{errs[0]:.3e}/{errs[1]:.3e}/{errs[2]:.3e}{again}  ok")
            del q, k, v, out, lse, do, got, exp


def flash_bwd_work(b, sq, sk, h, kv, d, dv, dtype, causal=True, window=0):
    """(bytes, operations, executed operations) of one backward call: q,
    k, v, out, dO and lse read once, dQ, dK, dV written once; 2 (3 D +
    2 Dv) operations per (query, key) pair the mask keeps (S, dP, dV, dK,
    dQ), the bound's count; the kernel executes 2 (4 D + 3 Dv), since its
    dQ kernel computes S and dP again (7 products)."""
    esz = torch.finfo(dtype).bits // 8
    nbytes = (2 * b * sq * h * (d + dv) + 2 * b * sk * kv * (d + dv)) * esz \
        + b * sq * h * 4
    pairs = int(ref.causal_mask_ref(sq, sk, window, offset=sk - sq).sum()) \
        if causal else sq * sk
    return (nbytes, b * h * pairs * 2 * (3 * d + 2 * dv),
            b * h * pairs * 2 * (4 * d + 3 * dv))


def time_flash_bwd(gen: torch.Generator) -> dict:
    """The backward's record at the training shape, f32: the kernel, its
    plain version and SDPA's backward (autograd on the same dO, the
    library yardstick); beside it the forward with its lse against the
    forward without, and the same in bf16."""
    name, b, sq, sk, h, kv, d, dv, causal, window = FLASH_BWD_CASES[0]
    record = None
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, out, lse, do = flash_bwd_inputs(
            gen, b, sq, sk, h, kv, d, dv, causal, window, dtype)
        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_(True)
                      for t in (q, k, v))
        ot = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                            enable_gqa=True)
        dot = do.transpose(1, 2)
        got = fa_mod._launch_bwd(q, k, v, out, lse, do, causal, window, None)
        exp = ref.flash_attention_bwd_ref(q, k, v, out, lse, do)
        err = max(float((g.float() - e.float()).abs().max())
                  for g, e in zip(got, exp))
        lib = torch.autograd.grad(ot, (qt, kt, vt), dot, retain_graph=True)
        lib_err = max(float((g.transpose(1, 2).float() - e.float()).abs()
                            .max()) for g, e in zip(lib, exp))
        del got, exp, lib
        ms = time_in_turns((
            lambda: fa_mod._launch_bwd(q, k, v, out, lse, do, causal,
                                       window, None),
            lambda: ref.flash_attention_bwd_ref(q, k, v, out, lse, do),
            lambda: torch.autograd.grad(ot, (qt, kt, vt), dot,
                                        retain_graph=True),
            lambda: fa_mod._launch(q, k, v, causal, window, None,
                                   want_lse=True),
            lambda: fa_mod._launch(q, k, v, causal, window, None)),
            (10, 3, 10, 10, 10), rounds=3)
        nbytes, nops, exec_ops = flash_bwd_work(b, sq, sk, h, kv, d, dv,
                                                dtype)
        bytes_ms = nbytes / H100_HBM_BW * 1e3
        if dtype == torch.float32:
            # f32-accurate products: 3xTF32 on the tensor cores, the
            # kernel's arithmetic, is the least time (as for the
            # forward); f32 FMA on the CUDA cores would take ops / 67
            # TFLOP/s
            ops_ms = 3 * nops / H100_PEAK_FLOPS_TF32 * 1e3
            fma_ms = nops / H100_PEAK_FLOPS_F32 * 1e3
            passes = (f" ({3 * exec_ops / ms[0] / 1e9:.1f} of TF32 in 3 "
                      f"passes)")
        else:
            ops_ms = nops / H100_PEAK_FLOPS_BF16 * 1e3
            fma_ms = nops / H100_PEAK_FLOPS_F32 * 1e3
            passes = ""
        log(f"  flash bwd at the {name} shape B={b} S={sq} {h}/{kv} heads "
            f"D={d} {str(dtype)[6:]}: kernel {ms[0]:.4f} ms, plain "
            f"{ms[1]:.4f} ms, SDPA backward {ms[2]:.4f} ms (differs from "
            f"the plain version by {lib_err:.3e}; not asserted), bound "
            f"{max(bytes_ms, ops_ms):.4f} ms ({nops:.4g} operations; "
            f"{'bytes' if bytes_ms >= ops_ms else 'operations'}), f32 FMA "
            f"bound {fma_ms:.4f} ms; executed {exec_ops:.4g} operations "
            f"(7 products) at {exec_ops / ms[0] / 1e9:.1f} TFLOP/s{passes}; "
            f"forward with lse {ms[3]:.4f} ms, without {ms[4]:.4f} ms; "
            f"max_abs_err {err:.3e}")
        if dtype == torch.float32:
            record = {
                "name": "flash_attention_bwd", "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/"
                          "flash_attention_bwd.cu",
                "replaces": "src/repro/kernels/xla_flash.py:163",
                "launches": 0, "max_abs_err": err, "ms": ms[0],
                "plain_ms": ms[1], "bound_ms": max(bytes_ms, ops_ms),
                "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                "library_ms": ms[2]}
        del q, k, v, out, lse, do, qt, kt, vt, ot, dot
    args = flash_bwd_inputs(gen, b, sq, sk, h, kv, d, dv, causal, window,
                            torch.float32)
    report_trace(f"flash bwd at the {name} shape",
                 cuda_events(lambda: fa_mod._launch_bwd(
                     *args, causal, window, None)), record["ms"])
    return record


DECODE_CASES = (
    # (b, smax, h, kv, d, valid lengths, window)
    (1, 512, 4, 4, 64, (1, 511, 512), 0),
    (2, 1024, 8, 2, 64, (1, 511, 512), 0),
    (4, 512, 4, 1, 128, (1, 511, 512), 0),
    (1, 512, 4, 4, 64, (400,), 128),
    (2, 1024, 8, 2, 64, (400,), 128),
    (4, 512, 4, 1, 128, (400,), 128),
    (8, 1024, 32, 8, 64, (1, 513, 1024), 0),   # llama3.2-1b served shape
    (2, 600, 32, 8, 64, (1, 577, 600), 0),     # Smax of no block multiple
    (8, 1024, 64, 8, 128, (1, 513, 544), 0),   # the hybrid's decode shape
    (2, 1024, 48, 1, 128, (1, 777, 1024), 0),  # G = 48 (granite-34b)
    (2, 512, 12, 2, 64, (1, 301, 512), 0),     # G = 6
    (2, 512, 17, 1, 64, (300,), 0),            # G = 17: groups 4, 4, 4, 4, 1
    (1, 8192, 32, 8, 64, (8192,), 0),          # the 8-CTA cluster cap
)


def check_decode(gen: torch.Generator) -> None:
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for dtype in (torch.float32, torch.bfloat16):
        for b, smax, h, kv, d, vls, window in DECODE_CASES:
            q = rand(gen, (b, 1, h, d), dtype)
            k = rand(gen, (b, smax, kv, d), dtype)
            v = rand(gen, (b, smax, kv, d), dtype)
            for vl in vls:
                got = da_mod.decode_attention(q, k, v, vl, window=window)
                torch.cuda.synchronize()
                exp = ref.decode_attention_ref(q, k, v, vl, window=window)
                name = (f"B={b} Smax={smax} {h}/{kv}h D={d} vl={vl} "
                        f"window={window}")
                err = assert_close(got, exp, dtype, f"decode {name} {dtype}")
                lo = max(0, vl - window) if window > 0 else 0
                plan = da_mod.split_plan(b, kv, vl - lo, sms, h // kv)
                log(f"  decode   {name:42s} {str(dtype):14s} "
                    f"max_abs_err={err:.3e} plan {plan}  ok")
    # the plan reaches the cluster cap at 8192 keys of one sequence
    if da_mod.split_plan(1, 8, 8192, sms, 4)[0] != da_mod.MAX_SPLITS:
        raise RuntimeError("decode: 8192 keys do not reach the 8-CTA "
                           "cluster cap")
    for h, kv, d in ((32, 8, 64), (64, 8, 128), (48, 1, 128)):
        groups = -(-h // kv // da_mod.HEADS_PER_CTA)
        fits = {str(dt)[6:]: da_mod.max_active_clusters(
            dt, h, kv, d, d, da_mod.MAX_SPLITS, groups)
            for dt in (torch.float32, torch.bfloat16)}
        if min(fits.values()) < 1:
            raise RuntimeError(f"decode: a cluster of 8 does not fit at "
                               f"{h}/{kv} heads D={d}: {fits}")
        log(f"  decode   clusters of 8 CTAs the card holds at once "
            f"(cudaOccupancyMaxActiveClusters), {h}/{kv} heads D={d}: "
            f"{fits}")


MAMBA_CASES = (
    # (b, L, D, N): the reference's sweep (tests/test_kernels.py), then
    # the hybrid's prefill chunk and decode step
    (2, 512, 256, 16), (1, 256, 128, 32), (3, 384, 192, 16),
    (2, 128, 256, 8), (8, 256, 16384, 16), (8, 1, 16384, 16),
)
STATE_TOL = dict(atol=5e-5, rtol=5e-5)


def scan_inputs(gen: torch.Generator, b: int, length: int, d: int, n: int,
                dtype) -> list:
    """dt, x, b, c in ``dtype``, a and h0 in f32, drawn as the
    reference's kernel sweep draws them."""
    return [F.softplus(rand(gen, (b, length, d), torch.float32) * 0.3
                       ).to(dtype),
            rand(gen, (b, length, d), dtype),
            (rand(gen, (b, length, n), torch.float32) * 0.5).to(dtype),
            (rand(gen, (b, length, n), torch.float32) * 0.5).to(dtype),
            -torch.exp(rand(gen, (d, n), torch.float32) * 0.3),
            rand(gen, (b, d, n), torch.float32) * 0.1]


def check_mamba(gen: torch.Generator) -> None:
    for dtype in (torch.float32, torch.bfloat16):
        for b, length, d, n in MAMBA_CASES:
            args = scan_inputs(gen, b, length, d, n, dtype)
            y, h = ms_mod.mamba_scan(*args)
            torch.cuda.synchronize()
            ye, he = ref.mamba_scan_ref(*args)
            name = f"B={b} L={length} D={d} N={n}"
            err = assert_close(y, ye, dtype, f"mamba_scan y {name} {dtype}")
            torch.testing.assert_close(
                h, he, **STATE_TOL,
                msg=lambda m: f"mamba_scan h {name} {dtype}: {m}")
            log(f"  mamba    {name:28s} {str(dtype):14s} "
                f"max_abs_err={err:.3e} h {float((h - he).abs().max()):.3e}"
                f"  ok")
    # the state carried across calls: two halves == one call
    dt, x, bm, cm, a, h0 = scan_inputs(gen, 8, 512, 16384, 16,
                                       torch.float32)
    y, h = ms_mod.mamba_scan(dt, x, bm, cm, a, h0)
    y1, h1 = ms_mod.mamba_scan(*(t[:, :256].contiguous()
                                 for t in (dt, x, bm, cm)), a, h0)
    y2, h2 = ms_mod.mamba_scan(*(t[:, 256:].contiguous()
                                 for t in (dt, x, bm, cm)), a, h1)
    torch.cuda.synchronize()
    err = assert_close(torch.cat([y1, y2], dim=1), y, torch.float32,
                       "mamba_scan two halves vs one call")
    torch.testing.assert_close(h2, h, **STATE_TOL)
    log(f"  mamba    two chained halves of L=512 vs one call: "
        f"max_abs_err={err:.3e}  ok")


# the scan's backward: (label, b, L, D, N, A's scale): the hybrid's
# training chunk, then L 1, L off a segment of 16 steps, N 8 and 64, D off
# a CTA of 64 channels, a dt A far below exp's range, eight rows of the
# chunk, N 64 at its width, and D off a CTA of 32 channels (N 64)
MAMBA_BWD_CASES = (
    ("training chunk", 1, 256, 16384, 16, 1.0),
    ("L=1", 3, 1, 16384, 16, 1.0),
    ("L off a segment", 2, 37, 4096, 16, 1.0),
    ("N=8", 2, 300, 4096, 8, 1.0),
    ("N=64", 2, 37, 1024, 64, 1.0),
    ("D off a CTA", 2, 70, 190, 16, 1.0),
    ("dt A << 0", 2, 64, 4096, 16, 1000.0),
    ("B=8", 8, 256, 16384, 16, 1.0),
    ("N=64 D=16384", 1, 64, 16384, 64, 1.0),
    ("D off a CTA N=64", 2, 33, 48, 64, 1.0),
)

def scan_bwd_inputs(gen, b, length, d, n, dtype, a_scale=1.0) -> list:
    """dt, x, b, c, a, h0 as :func:`scan_inputs` (A times ``a_scale``),
    and the cotangents dy in ``dtype`` and dh in f32."""
    args = scan_inputs(gen, b, length, d, n, dtype)
    args[4] = args[4] * a_scale
    return args + [rand(gen, (b, length, d), dtype),
                   rand(gen, (b, d, n), torch.float32)]


def check_mamba_bwd(gen: torch.Generator) -> None:
    """The scan's backward kernel against its plain reverse recurrence on
    the same inputs, f32 and bf16, within BWD_TOL's rtol of each output's
    largest entry (an entry near zero carries the absolute error of the
    sums that reach it), one counted launch a call; at the training chunk
    two calls bit-equal."""
    for dtype in (torch.float32, torch.bfloat16):
        bar = BWD_TOL[dtype]["rtol"]
        for name, b, length, d, n, a_scale in MAMBA_BWD_CASES:
            args = scan_bwd_inputs(gen, b, length, d, n, dtype, a_scale)
            before = ms_mod.bwd_counter.count
            got = ms_mod._launch_bwd(*args)
            torch.cuda.synchronize()
            if ms_mod.bwd_counter.count != before + 1:
                raise RuntimeError("scan backward: the call did not count "
                                   "one launch")
            exp = ref.mamba_scan_bwd_ref(*args)
            errs = leaf_errors(got, exp)
            if not max(errs) <= bar or not all(
                    bool(torch.isfinite(g.float()).all()) for g in got):
                raise RuntimeError(
                    f"mamba_scan bwd {name} {dtype}: relative errors "
                    f"ddt/dx/db/dc/da/dh0 {errs} (bar {bar})")
            again = ""
            if name == MAMBA_BWD_CASES[0][0]:
                if not all(torch.equal(g, h) for g, h in zip(
                        got, ms_mod._launch_bwd(*args))):
                    raise RuntimeError(f"mamba_scan bwd {name} {dtype}: two "
                                       f"calls differ")
                again = "; a second call bit-equal"
            log(f"  mamba bwd {name:16s} B={b} L={length} D={d} N={n} "
                f"{str(dtype)[6:]}: ddt/dx/db/dc/da/dh0 within "
                f"{', '.join(f'{e:.2e}' for e in errs)} of their largest "
                f"entries (bar {bar}){again}  ok")
            del args, got, exp


def scan_bwd_work(b, length, d, n, dtype) -> tuple:
    """(bytes, least ms of the exponentials) of one backward call: dt, x,
    dy read and ddt, dx written once, b, c read and db, dc written once
    in ``dtype``; a and da, h0, dh and dh0 in f32; B L D N exponentials
    (every a_t), 16 a clock per SM."""
    esz = torch.finfo(dtype).bits // 8
    nbytes = (5 * b * length * d + 4 * b * length * n) * esz \
        + (2 * d * n + 3 * b * d * n) * 4
    return nbytes, b * length * d * n / ex2_rate() * 1e3


def scan_bwd_plan_line(b, length, d, n, dtype) -> None:
    """The backward's grid, residency, exponentials and workspace at
    these sizes."""
    grid, per_sm = ms_mod.bwd_launch_plan(dtype, b, length, d, n)
    seg = ms_mod.BWD_SEGMENT
    segs = -(-length // seg)
    log(f"  mamba bwd plan B={b} L={length} D={d} N={n} "
        f"{str(dtype)[6:]}: grid {grid} CTAs of "
        f"{ms_mod.BWD_THREADS[n]} threads, {per_sm} CTAs "
        f"({per_sm * ms_mod.BWD_THREADS[n] // 32} warps) an SM "
        f"(cudaOccupancyMaxActiveBlocksPerMultiprocessor); "
        f"{((segs - 1) * seg + length) / length:.4f} exponentials a "
        f"(b, t, d, n) (pass 1 over {(segs - 1) * seg} steps, the replay "
        f"over {length}); workspace "
        f"{4 * ms_mod.bwd_workspace_floats(b, length, d, n)} bytes; one "
        f"dB/dC partial a CTA a step")


def time_mamba_bwd(gen: torch.Generator) -> dict:
    """The scan backward's record at the hybrid's training chunk (B 1, L
    256, D 16384, N 16), f32: the kernel against its plain reverse
    recurrence in turns, its bound, its device time a launch of each of
    its kernels; the same in bf16 beside it, and the kernel at eight
    rows of the chunk. No single PyTorch call computes it."""
    name, b, length, d, n, _ = MAMBA_BWD_CASES[0]
    record = None
    spin = torch.cuda.Stream()   # the traces' prelude (cuda_events)
    for dtype in (torch.float32, torch.bfloat16):
        scan_bwd_plan_line(b, length, d, n, dtype)
        args = scan_bwd_inputs(gen, b, length, d, n, dtype)
        errs = [float((g.float() - e.float()).abs().max()) for g, e in zip(
            ms_mod._launch_bwd(*args), ref.mamba_scan_bwd_ref(*args))]
        ms = time_in_turns((lambda: ms_mod._launch_bwd(*args),
                            lambda: ref.mamba_scan_bwd_ref(*args)),
                           (50, 3), rounds=3)
        nbytes, ex2_ms = scan_bwd_work(b, length, d, n, dtype)
        bytes_ms = nbytes / H100_HBM_BW * 1e3
        log(f"  mamba bwd at the {name} B={b} L={length} D={d} N={n} "
            f"{str(dtype)[6:]}: kernel {ms[0]:.4f} ms, plain {ms[1]:.4f} "
            f"ms, bound {max(bytes_ms, ex2_ms):.6f} ms (bytes "
            f"{bytes_ms:.6f}, ex2 {ex2_ms:.6f}: "
            f"{'bytes' if bytes_ms >= ex2_ms else 'operations'}); "
            f"max_abs_err {max(errs):.3e}")
        if dtype == torch.float32:
            record = {
                "name": "mamba_scan_bwd", "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/mamba_scan_bwd.cu",
                "replaces": "src/repro/kernels/ops.py:101",
                "launches": 0, "max_abs_err": max(errs), "ms": ms[0],
                "plain_ms": ms[1], "bound_ms": max(bytes_ms, ex2_ms),
                "bound_by": "bytes" if bytes_ms >= ex2_ms else "operations",
                "library_ms": None}
        report_trace(f"mamba bwd at the {name} {str(dtype)[6:]}",
                     cuda_events(lambda: ms_mod._launch_bwd(*args), calls=10,
                                 prelude=spin), ms[0], calls=10)
        del args
    # eight rows of the chunk: the kernel alone (its plain version is in
    # check_mamba_bwd), f32
    b8 = 8
    scan_bwd_plan_line(b8, length, d, n, torch.float32)
    args = scan_bwd_inputs(gen, b8, length, d, n, torch.float32)
    ms8 = time_ms(lambda: ms_mod._launch_bwd(*args), iters=20, warmup=3)
    nbytes, ex2_ms = scan_bwd_work(b8, length, d, n, torch.float32)
    bytes_ms = nbytes / H100_HBM_BW * 1e3
    log(f"  mamba bwd at B={b8} L={length} D={d} N={n} float32: kernel "
        f"{ms8:.4f} ms ({ms8 / b8:.4f} ms a row, the training chunk's "
        f"{record['ms']:.4f}), bound {max(bytes_ms, ex2_ms):.6f} ms")
    report_trace(f"mamba bwd at B={b8}",
                 cuda_events(lambda: ms_mod._launch_bwd(*args), calls=5,
                             prelude=spin), ms8, calls=5)
    del args
    return record


def kernel_record(name, source, replaces, kernel_fn, plain_fn, library_fn,
                  nbytes, nops, dtype, plain_iters: int = 200,
                  ops_ms=None) -> dict:
    """Time a kernel, its plain version and, where one PyTorch call
    computes the same function (``library_fn``, else None), that call.
    The bound's operations take ``nops`` at the dtype's peak unless
    ``ops_ms`` gives their least time."""
    got, exp = kernel_fn(), plain_fn()
    torch.cuda.synchronize()
    err = assert_close(got, exp, dtype, f"{name} timed shape")
    if library_fn is not None:
        lib_err = float((library_fn().float() - exp.float()).abs().max())
        log(f"  {name}: library call differs from the plain version by "
            f"{lib_err:.3e} (a yardstick of time only; not asserted)")
    bytes_ms = nbytes / H100_HBM_BW * 1e3
    if ops_ms is None:
        ops_ms = nops / PEAK[dtype] * 1e3
    fns = [kernel_fn, plain_fn] + ([library_fn] if library_fn else [])
    ms = time_in_turns(fns, [200, plain_iters, 200][:len(fns)])
    return {
        "name": name, "route": "cuda", "source": source,
        "replaces": replaces, "launches": 0, "max_abs_err": err,
        "ms": ms[0], "plain_ms": ms[1],
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": ms[2] if library_fn else None,
    }


def flash_work(b, sq, sk, h, kv, d, dv, dtype, causal=True, window=0):
    """(bytes, operations, least ms of the operations) of one flash call:
    q and out once, k and v once; 2 (D + Dv) operations per (query, key)
    pair the mask keeps."""
    esz = torch.finfo(dtype).bits // 8
    nbytes = (b * sq * h * (d + dv) + b * sk * kv * (d + dv)) * esz
    pairs = int(ref.causal_mask_ref(sq, sk, window, offset=sk - sq).sum()) \
        if causal else sq * sk
    ops = b * h * pairs * 2 * (d + dv)
    if dtype == torch.float32:
        # f32-accurate products on this card: one TF32 pass misses the
        # repo's 2e-5 bar ~50x, so the least time is the 3xTF32 split,
        # three tensor-core passes (less than f32 FMA at 67 TFLOP/s)
        return nbytes, ops, 3 * ops / H100_PEAK_FLOPS_TF32 * 1e3
    return nbytes, ops, ops / H100_PEAK_FLOPS_BF16 * 1e3


def time_kernels(gen: torch.Generator) -> list:
    """Kernel records at the served shapes: batch SERVE_BATCH of SEQ
    tokens through llama3.2-1b (rows = 256, D = 2048; flash B = 8,
    32 q heads over 8 kv heads, head_dim 64), decode at DECODE_BATCH
    against SMAX slots, and the scan at the hybrid's prefill chunk
    (B 8, L 256, D 16384, N 16), f32."""
    dtype = torch.float32
    rows, d = SERVE_BATCH * SEQ, 2048
    x, g = rand(gen, (rows, d), dtype), rand(gen, (d,), dtype)
    esz = x.element_size()
    records = [kernel_record(
        "rmsnorm", "src/repro_torch/kernels/csrc/rmsnorm.cu",
        "src/repro/kernels/rmsnorm.py:28",
        lambda: rms_mod.rmsnorm(x, g), lambda: ref.rmsnorm_ref(x, g),
        lambda: F.rms_norm(x, (d,), g, 1e-6),
        nbytes=(2 * rows * d + d) * esz, nops=4 * rows * d, dtype=dtype)]
    for r2, d2 in ((rows, 768), (DECODE_BATCH * PROMPT, 8192)):
        # the xlstm's rows, and the hybrid's d_model (a CTA per row)
        xs, gs = rand(gen, (r2, d2), dtype), rand(gen, (d2,), dtype)
        ms = time_in_turns((
            lambda: rms_mod.rmsnorm(xs, gs), lambda: ref.rmsnorm_ref(xs, gs),
            lambda: F.rms_norm(xs, (d2,), gs, 1e-6)), (200, 200, 200))
        log(f"  rmsnorm at rows={r2} D={d2}: kernel {ms[0]:.4f} ms, plain "
            f"{ms[1]:.4f} ms, F.rms_norm {ms[2]:.4f} ms, bound "
            f"{(2 * xs.numel() + d2) * esz / H100_HBM_BW * 1e3:.6f} ms "
            f"(bytes)")
        del xs, gs
    report_trace(f"rmsnorm at rows={rows} D={d}",
                 cuda_events(lambda: rms_mod.rmsnorm(x, g), calls=20),
                 records[-1]["ms"], calls=20)

    # prefill attention: llama3.2-1b's (32 q heads over 8, D 64), the
    # hybrid's (64 over 8, D 128), B 8 x 512 tokens, and DeepSeek-V3's
    # MLA (128 over 128, D 192, Dv 128) at its prefill (B 8 x 512) and
    # scoring (B 8 x 32) shapes, f32 and bf16. SDPA takes Dv != D (its
    # math or memory-efficient backend), so MLA has a library time too.
    for label, b, s, h, kv, hd, dv in (
            ("llama prefill", DECODE_BATCH, PROMPT, 32, 8, 64, 64),
            ("hybrid prefill", DECODE_BATCH, PROMPT, 64, 8, 128, 128),
            ("MLA prefill", DECODE_BATCH, PROMPT, 128, 128, 192, 128),
            ("MLA scoring", SERVE_BATCH, SEQ, 128, 128, 192, 128)):
        for dt in (torch.float32, torch.bfloat16):
            q = rand(gen, (b, s, h, hd), dt)
            k = rand(gen, (b, s, kv, hd), dt)
            v = rand(gen, (b, s, kv, dv), dt)
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            assert_close(fa_mod.flash_attention(q, k, v),
                         ref.flash_attention_ref(q, k, v), dt,
                         f"flash at the {label}")
            nbytes, _, ops_ms = flash_work(b, s, s, h, kv, hd, dv, dt)
            bytes_ms = nbytes / H100_HBM_BW * 1e3
            ms = time_in_turns((
                lambda: fa_mod.flash_attention(q, k, v),
                lambda: ref.flash_attention_ref(q, k, v),
                lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True, enable_gqa=True)),
                (20, 5, 20))
            log(f"  flash at the {label} B={b} S={s} {h}/{kv} heads D={hd} "
                f"Dv={dv} {str(dt)[6:]}: kernel {ms[0]:.4f} ms, plain "
                f"{ms[1]:.4f} ms, F.scaled_dot_product_attention "
                f"{ms[2]:.4f} ms, bound {max(bytes_ms, ops_ms):.6f} ms ("
                f"{'bytes' if bytes_ms >= ops_ms else 'operations'})")
            if label.startswith("MLA") and dt == torch.float32:
                report_trace(f"flash at the {label}",
                             cuda_events(lambda: fa_mod.flash_attention(
                                 q, k, v), calls=10), ms[0], calls=10)
            del q, k, v, qt, kt, vt

    b, s, h, kv, hd = SERVE_BATCH, SEQ, 32, 8, 64
    q = rand(gen, (b, s, h, hd), dtype)
    k = rand(gen, (b, s, kv, hd), dtype)
    v = rand(gen, (b, s, kv, hd), dtype)
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    nbytes, nops, ops_ms = flash_work(b, s, s, h, kv, hd, hd, dtype)
    records.append(kernel_record(
        "flash_attention", "src/repro_torch/kernels/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention.py:78",
        lambda: fa_mod.flash_attention(q, k, v, causal=True),
        lambda: ref.flash_attention_ref(q, k, v, causal=True),
        lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True).transpose(1, 2),
        nbytes=nbytes, nops=nops, dtype=dtype, ops_ms=ops_ms))
    report_trace("flash_attention at the served shape",
                 cuda_events(lambda: fa_mod.flash_attention(q, k, v),
                             calls=20), records[-1]["ms"], calls=20)

    # decode: DECODE_BATCH sequences, a full cache of SMAX slots
    b, smax, vl = DECODE_BATCH, SMAX, SMAX
    q = rand(gen, (b, 1, h, hd), dtype)
    k = rand(gen, (b, smax, kv, hd), dtype)
    v = rand(gen, (b, smax, kv, hd), dtype)
    # the library call's own layout (B, heads, S, D), made outside the
    # timing, and the slot mask as a boolean attention mask
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    slots = (torch.arange(smax, device="cuda") < vl)[None, None, None, :]
    records.append(kernel_record(
        "decode_attention", "src/repro_torch/kernels/csrc/decode_attention.cu",
        "src/repro/kernels/decode_attention.py:72",
        lambda: da_mod.decode_attention(q, k, v, vl),
        lambda: ref.decode_attention_ref(q, k, v, vl),
        lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=slots, enable_gqa=True).transpose(1, 2),
        nbytes=(q.numel() + 2 * b * vl * kv * hd + q.numel()) * esz,
        nops=b * h * vl * 2 * (hd + hd), dtype=dtype))
    report_trace(f"decode_attention at valid_len {vl}",
                 cuda_events(lambda: da_mod.decode_attention(q, k, v, vl),
                             calls=20), records[-1]["ms"], calls=20)
    del q, k, v, qt, kt, vt
    # beside the record: the served shape in bf16, and the hybrid's step
    # shape (64/8 heads, D 128, valid_len 544) in both dtypes
    for label, h2, kv2, hd2, vl2 in (("served", h, kv, hd, SMAX),
                                     ("hybrid", 64, 8, 128, 544)):
        for dt in (torch.float32, torch.bfloat16):
            if label == "served" and dt == dtype:
                continue                    # the record above
            decode_line(gen, label, b, smax, h2, kv2, hd2, vl2, dt)

    # the scan at the hybrid's prefill chunk; no single PyTorch call
    # computes a selective scan, so it has no library time
    b, length, d, n = 8, 256, 16384, 16
    args = scan_inputs(gen, b, length, d, n, dtype)
    nbytes, ops_ms = scan_work(b, length, d, n, dtype)
    records.append(kernel_record(
        "mamba_scan", "src/repro_torch/kernels/csrc/mamba_scan.cu",
        "src/repro/kernels/mamba_scan.py:72",
        lambda: ms_mod.mamba_scan(*args)[0],
        lambda: ref.mamba_scan_ref(*args)[0], None,
        nbytes=nbytes, nops=7 * b * length * d * n, dtype=dtype,
        plain_iters=5, ops_ms=ops_ms))
    report_trace(f"mamba_scan at B={b} L={length} D={d} N={n}",
                 cuda_events(lambda: ms_mod.mamba_scan(*args), calls=20),
                 records[-1]["ms"], calls=20)
    del args
    # the record's shape again with its grid and what sets its bound, the
    # decode step's shape (L = 1), and both in bf16
    for dt in (torch.float32, torch.bfloat16):
        for steps in (length, 1):
            scan_line(gen, b, steps, d, n, dt)
    for r in records:
        lib = "—" if r["library_ms"] is None else f"{r['library_ms']:.4f} ms"
        log(f"  {r['name']:16s} kernel {r['ms']:.4f} ms  plain "
            f"{r['plain_ms']:.4f} ms  library {lib}  "
            f"bound {r['bound_ms']:.6f} ms ({r['bound_by']})")
    return records


def decode_line(gen, label, b, smax, h, kv, hd, vl, dtype) -> None:
    """Log decode attention at one shape: kernel, plain version and SDPA
    (CUDA events in turns), the bound, and the kernel's device time per
    launch from a trace."""
    q = rand(gen, (b, 1, h, hd), dtype)
    k = rand(gen, (b, smax, kv, hd), dtype)
    v = rand(gen, (b, smax, kv, hd), dtype)
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    slots = (torch.arange(smax, device="cuda") < vl)[None, None, None, :]
    assert_close(da_mod.decode_attention(q, k, v, vl),
                 ref.decode_attention_ref(q, k, v, vl), dtype,
                 f"decode {label} {dtype}")
    esz = q.element_size()
    bytes_ms = (2 * q.numel() + 2 * b * vl * kv * hd) * esz / H100_HBM_BW \
        * 1e3
    ops_ms = 4 * b * h * vl * hd / PEAK[dtype] * 1e3
    ms = time_in_turns((
        lambda: da_mod.decode_attention(q, k, v, vl),
        lambda: ref.decode_attention_ref(q, k, v, vl),
        lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=slots, enable_gqa=True)), (200, 50, 200))
    log(f"  decode_attention at the {label} shape B={b} Smax={smax} "
        f"vl={vl} {h}/{kv} heads D={hd} {str(dtype)[6:]}: kernel "
        f"{ms[0]:.4f} ms, plain {ms[1]:.4f} ms, "
        f"F.scaled_dot_product_attention {ms[2]:.4f} ms, bound "
        f"{max(bytes_ms, ops_ms):.6f} ms "
        f"({'bytes' if bytes_ms >= ops_ms else 'operations'})")
    report_trace(f"decode_attention at the {label} shape {str(dtype)[6:]}",
                 cuda_events(lambda: da_mod.decode_attention(q, k, v, vl),
                             calls=20), ms[0], calls=20)


# phase 12's flash shapes: (label, b, sq, sk, h, kv, d, causal)
FAMILY_FLASH = (
    ("whisper encoder", DECODE_BATCH, 1500, 1500, 12, 12, 64, False),
    ("whisper cross prefill", DECODE_BATCH, 64, 1500, 12, 12, 64, False),
    ("whisper cross decode", DECODE_BATCH, 1, 1500, 12, 12, 64, False),
    ("pixtral prefill", 4, 1088, 1088, 32, 8, 128, True),
)
# phase 12's decode-attention shapes: (label, b, smax, h, kv, d, valid_len
# at the last step)
FAMILY_DECODE = (("whisper step", DECODE_BATCH, 448, 12, 12, 64, 128),
                 ("pixtral step", 4, 1152, 32, 8, 128, 1120))


def time_family_shapes(gen: torch.Generator) -> None:
    """Phase 12's attention shapes in f32, none of which an earlier
    phase holds: each flash call against its plain version (2e-5) and
    timed beside it and SDPA, each decode shape through
    :func:`decode_line`; and whisper's decode-time cross-attention (one
    query row over 1500 frames) through flash, the reference's route,
    beside decode attention at valid_len 1500 on the same tensors."""
    dtype = torch.float32
    for label, b, sq, sk, h, kv, d, causal in FAMILY_FLASH:
        q = rand(gen, (b, sq, h, d), dtype)
        k = rand(gen, (b, sk, kv, d), dtype)
        v = rand(gen, (b, sk, kv, d), dtype)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        err = assert_close(
            fa_mod.flash_attention(q, k, v, causal=causal),
            ref.flash_attention_ref(q, k, v, causal=causal), dtype,
            f"flash at the {label}")
        nbytes, _, ops_ms = flash_work(b, sq, sk, h, kv, d, d, dtype, causal)
        bytes_ms = nbytes / H100_HBM_BW * 1e3
        iters = 200 if sq == 1 else 20
        ms = time_in_turns((
            lambda: fa_mod.flash_attention(q, k, v, causal=causal),
            lambda: ref.flash_attention_ref(q, k, v, causal=causal),
            lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal, enable_gqa=True)),
            (iters, 5, iters))
        log(f"  flash at the {label} B={b} Sq={sq} Sk={sk} {h}/{kv} heads "
            f"D={d} {'causal' if causal else 'full'} f32: max_abs_err="
            f"{err:.3e}, kernel {ms[0]:.4f} ms, plain {ms[1]:.4f} ms, "
            f"F.scaled_dot_product_attention {ms[2]:.4f} ms, bound "
            f"{max(bytes_ms, ops_ms):.6f} ms "
            f"({'bytes' if bytes_ms >= ops_ms else 'operations'})")
        if sq == 1:
            # the same function through the decode kernel: every one of
            # the sk slots valid, no window
            err = assert_close(da_mod.decode_attention(q, k, v, sk),
                               ref.flash_attention_ref(q, k, v,
                                                       causal=False),
                               dtype, f"decode at the {label}")
            dms = time_in_turns((
                lambda: da_mod.decode_attention(q, k, v, sk),
                lambda: fa_mod.flash_attention(q, k, v, causal=False)),
                (200, 200))
            log(f"  the {label} through decode_attention at valid_len "
                f"{sk}: max_abs_err={err:.3e} against the plain flash, "
                f"{dms[0]:.4f} ms against flash's {dms[1]:.4f} ms (in "
                f"turns)")
        del q, k, v, qt, kt, vt
    for label, b, smax, h, kv, d, vl in FAMILY_DECODE:
        decode_line(gen, label, b, smax, h, kv, d, vl, dtype)


def scan_work(b, length, d, n, dtype) -> tuple:
    """(bytes, least ms of the operations) of one scan call: dt, x, y and
    B, C once in ``dtype``, A, h0 and h_out once in f32; the operations
    are the larger of ~7 f32 operations per (b, t, d, n) at the f32 peak
    and B L D N exponentials on the special-function units, 16 a clock
    per SM at the card's maximum SM clock."""
    esz = torch.finfo(dtype).bits // 8
    nbytes = (3 * b * length * d + 2 * b * length * n) * esz \
        + (d * n + 2 * b * d * n) * 4
    elems = b * length * d * n
    return nbytes, max(7 * elems / H100_PEAK_FLOPS_F32,
                       elems / ex2_rate()) * 1e3


def ex2_rate() -> float:
    """Exponentials a second on the card's special-function units: 16 a
    clock per SM at ``clocks.max.sm``."""
    mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return 16 * sms * mhz * 1e6


def scan_line(gen, b, length, d, n, dtype) -> None:
    """Log the scan at one shape: its grid against the CTAs the card holds
    at once, kernel and plain version (CUDA events in turns), the bound
    and what sets it, and the kernel's device time per launch."""
    args = scan_inputs(gen, b, length, d, n, dtype)
    y, h = ms_mod.mamba_scan(*args)
    ye, he = ref.mamba_scan_ref(*args)
    assert_close(y, ye, dtype, f"mamba_scan {dtype} L={length}")
    torch.testing.assert_close(h, he, **STATE_TOL)
    nbytes, ops_ms = scan_work(b, length, d, n, dtype)
    bytes_ms = nbytes / H100_HBM_BW * 1e3
    ex2_ms = b * length * d * n / ex2_rate() * 1e3
    grid, per_sm = ms_mod.launch_plan(dtype, b, length, d, n)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    ms = time_in_turns((lambda: ms_mod.mamba_scan(*args),
                        lambda: ref.mamba_scan_ref(*args)),
                       (200, 5 if length > 1 else 50))
    by = "bytes" if bytes_ms >= ops_ms else \
        "ex2" if ex2_ms >= ops_ms else "f32 operations"
    log(f"  mamba_scan at B={b} L={length} D={d} N={n} {str(dtype)[6:]}: "
        f"grid {grid} CTAs, {per_sm} CTAs an SM, "
        f"{grid / (per_sm * sms):.3f} waves; kernel {ms[0]:.4f} ms, plain "
        f"{ms[1]:.4f} ms, bound {max(bytes_ms, ops_ms):.6f} ms (bytes "
        f"{bytes_ms:.6f}, ex2 {ex2_ms:.6f}, f32 operations "
        f"{7 * b * length * d * n / H100_PEAK_FLOPS_F32 * 1e3:.6f}: {by})")
    report_trace(f"mamba_scan at L={length} {str(dtype)[6:]}",
                 cuda_events(lambda: ms_mod.mamba_scan(*args), calls=20),
                 ms[0], calls=20)


LAUNCH_CALLS = 10_000


def host_us(fn, calls: int = LAUNCH_CALLS) -> float:
    """Host-clock microseconds per call over ``calls`` back-to-back calls
    of ``fn``, synchronised at the end."""
    for _ in range(100):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / calls * 1e6


def time_launch_path(gen: torch.Generator) -> None:
    """Host cost of each step of the rmsnorm wrapper's launch path at the
    served 256 x 2048 f32, LAUNCH_CALLS calls each, beside the whole
    wrapper and ``F.rms_norm``; the steps the wrapper took before this
    redesign are timed too. The launcher is timed with 0 rows: it returns
    before launching, so the device never holds the host clock back."""
    rows, d = SERVE_BATCH * SEQ, 2048
    x, g = rand(gen, (rows, d), torch.float32), rand(gen, (d,), torch.float32)
    out = torch.empty_like(x)
    dev = x.get_device()
    fn = _build.entry("rmsnorm_f32")
    xp, gp, op, st = x.data_ptr(), g.data_ptr(), out.data_ptr(), \
        _build.stream(dev)
    probe = _build.LaunchCounter()
    held = getattr(ctypes.PyDLL(str(_build.BUILD_DIR / _build.LIB_NAME)),
                   "rmsnorm_f32")
    held.argtypes, held.restype = _build.SIGNATURES["rmsnorm_f32"]
    steps = (
        ("loop and lambda call (baseline)", lambda: None),
        ("device type and grad route", lambda: (
            x.device.type not in ("cuda", "cpu"), torch.is_grad_enabled()
            and (x.requires_grad or g.requires_grad))),
        ("checks: dtype, shape, device, contiguity", lambda: (
            rms_mod.KERNEL_DTYPES.get(x.dtype), x.shape[-1],
            g.shape != (d,), g.get_device() != dev, x.is_contiguous(),
            g.dtype != x.dtype, g.is_contiguous())),
        ("data_ptr x2 and alignment", lambda: (x.data_ptr()
                                               | g.data_ptr()) % 16),
        ("torch.empty_like", lambda: torch.empty_like(x)),
        ("(alternative) x.new_empty(x.shape)", lambda: x.new_empty(x.shape)),
        ("(alternative) torch.empty(shape, dtype, device)",
         lambda: torch.empty(x.shape, dtype=x.dtype, device=x.device)),
        ("(yardstick) torch.neg: one allocation, one launch",
         lambda: torch.neg(x)),
        ("_build.entry (cached binding)", lambda: _build.entry(
            "rmsnorm_f32")),
        ("_build.stream (raw handle)", lambda: _build.stream(dev)),
        ("ctypes call with 0 rows (no launch)",
         lambda: fn(xp, gp, op, 0, d, 1e-6, st)),
        ("(alternative) the same through PyDLL (GIL held)",
         lambda: held(xp, gp, op, 0, d, 1e-6, st)),
        ("ctypes call with the launch", lambda: fn(xp, gp, op, rows, d,
                                                   1e-6, st)),
        ("counter.add", probe.add),
        ("before: scale.to(dtype).contiguous()",
         lambda: g.to(x.dtype).contiguous()),
        ("before: _build.load() + getattr", lambda: getattr(
            _build.load(), "rmsnorm_f32")),
        ("before: torch.cuda.current_stream(device).cuda_stream",
         lambda: torch.cuda.current_stream(x.device).cuda_stream),
    )
    for name, step in steps:
        log(f"  launch path: {name:55s} {host_us(step):7.3f} us")
    for r2, d2 in ((rows, d), (rows, 768)):
        xs, gs = rand(gen, (r2, d2), torch.float32), rand(gen, (d2,),
                                                         torch.float32)
        log(f"  launch path: rmsnorm wrapper at {r2} x {d2}: "
            f"{host_us(lambda: rms_mod.rmsnorm(xs, gs)):.3f} us per call, "
            f"F.rms_norm "
            f"{host_us(lambda: F.rms_norm(xs, (d2,), gs, 1e-6)):.3f} us "
            f"(host clock, {LAUNCH_CALLS} back-to-back calls)")


def sweep_decode_splits(gen: torch.Generator) -> None:
    """Device us per launch of the decode kernel at the served and the
    hybrid's step shapes, f32 and bf16, for every cluster size the plan
    could pick (the C entry called with each plan), beside the plan's
    own pick: the record behind ``CTAS_PER_SM``."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    fwd = _build.entry("decode_attention_fwd")
    st = _build.stream(0)
    for label, b, smax, h, kv, hd, vl in (
            ("served", DECODE_BATCH, SMAX, 32, 8, 64, SMAX),
            ("hybrid", DECODE_BATCH, SMAX, 64, 8, 128, 544)):
        for dt in (torch.float32, torch.bfloat16):
            q = rand(gen, (b, 1, h, hd), dt)
            k = rand(gen, (b, smax, kv, hd), dt)
            v = rand(gen, (b, smax, kv, hd), dt)
            out = torch.empty_like(q)
            pick = da_mod.split_plan(b, kv, vl, sms, h // kv)
            groups, tiles = pick[2], -(-vl // da_mod.TILE)
            cells = []
            for splits in range(1, da_mod.MAX_SPLITS + 1):
                chunk = -(-tiles // splits) * da_mod.TILE
                if -(-vl // chunk) != splits:
                    continue                    # an empty chunk
                args = (q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        out.data_ptr(), da_mod.KERNEL_DTYPES[dt], b, smax, h,
                        kv, hd, hd, 0, vl, splits, chunk, groups,
                        hd ** -0.5, st)

                def call(args=args):
                    _build.check(fwd(*args), "decode_attention")
                events = cuda_events(call, calls=20)
                us = sum(e.self_device_time_total for e in events) / max(
                    1, sum(e.count for e in events))
                mark = "*" if (splits, chunk) == pick[:2] else ""
                cells.append(f"{splits}{mark}: {us:.2f}")
            log(f"  decode splits sweep, {label} {str(dt)[6:]} (device us "
                f"per launch by cluster size; * the plan): "
                + ", ".join(cells))
            del q, k, v, out


def time_decode_launch_path(gen: torch.Generator) -> None:
    """Host cost of each step of the decode wrapper's launch path,
    LAUNCH_CALLS calls each, at the served q (B 8, 32/8 heads, D 64, f32),
    beside the steps the two-kernel wrapper took before. The launcher is
    timed with B = 0 (it returns before launching) and launching at B 1,
    32 slots, 4/1 heads (a few us of device time, under the host's), so
    the device never holds the host clock back; the whole wrapper is
    timed at that small shape and at the served one (there the device's
    time sets the pace)."""
    b, h, kv, hd = DECODE_BATCH, 32, 8, 64
    q = rand(gen, (b, 1, h, hd), torch.float32)
    k = rand(gen, (b, SMAX, kv, hd), torch.float32)
    v = rand(gen, (b, SMAX, kv, hd), torch.float32)
    qs = rand(gen, (1, 1, 4, hd), torch.float32)
    ks = rand(gen, (1, 32, 1, hd), torch.float32)
    dev = q.get_device()
    fn = _build.entry("decode_attention_fwd")
    st = _build.stream(dev)
    qp, kp, vp = q.data_ptr(), k.data_ptr(), v.data_ptr()
    out = torch.empty_like(q)
    op = out.data_ptr()
    small = (qs.data_ptr(), ks.data_ptr(), ks.data_ptr(), op)
    plan = da_mod.split_plan(1, 1, 32, 132, 4)
    probe = _build.LaunchCounter()
    steps = (
        ("loop and lambda call (baseline)", lambda: None),
        ("checks: valid_len, shapes, dtype, device, contiguity", lambda: (
            isinstance(SMAX, torch.Tensor), operator.index(SMAX), q.dim(),
            k.dim(), v.dim(), q.shape, v.shape, k.shape != (b, SMAX, kv, hd),
            h % kv, hd > 128, da_mod.KERNEL_DTYPES.get(q.dtype),
            k.dtype != q.dtype, v.dtype != q.dtype,
            q.device == k.device == v.device, q.is_contiguous(),
            k.is_contiguous(), v.is_contiguous())),
        ("data_ptr x2 and alignment", lambda: (k.data_ptr()
                                               | v.data_ptr()) % 16),
        ("get_device, cached SM count, split_plan", lambda: da_mod.split_plan(
            b, kv, SMAX, da_mod._sm_count(q.get_device()), h // kv)),
        ("torch.empty_like (out)", lambda: torch.empty_like(q)),
        ("_build.entry (cached binding)", lambda: _build.entry(
            "decode_attention_fwd")),
        ("_build.stream (raw handle)", lambda: _build.stream(dev)),
        ("ctypes call with B = 0 (no launch)",
         lambda: fn(qp, kp, vp, op, 0, 0, SMAX, h, kv, hd, hd, 0, SMAX, 8,
                    128, 1, 0.125, st)),
        ("ctypes call with the cluster launch (B 1, 32 slots, 4/1 heads)",
         lambda: fn(*small, 0, 1, 32, 4, 1, hd, hd, 0, 32, *plan, 0.125,
                    st)),
        ("counter.add", probe.add),
        ("before: get_device_properties().multi_processor_count",
         lambda: torch.cuda.get_device_properties(
             q.device).multi_processor_count),
        ("before: torch.empty x2 (ml, acc scratch)", lambda: (
            torch.empty((b * kv * 4 * 4 * 2,), dtype=torch.float32,
                        device=q.device),
            torch.empty((b * kv * 4 * 4 * hd,), dtype=torch.float32,
                        device=q.device))),
    )
    for name, step in steps:
        log(f"  decode launch path: {name:62s} {host_us(step):7.3f} us")
    log(f"  decode launch path: wrapper at B 1, 32 slots, 4/1 heads "
        f"{host_us(lambda: da_mod.decode_attention(qs, ks, ks, 32)):.3f} "
        f"us per call; at the served shape "
        f"{host_us(lambda: da_mod.decode_attention(q, k, v, SMAX)):.3f} "
        f"us (host clock, {LAUNCH_CALLS} back-to-back calls)")


def cuda_events(fn, calls: int = 1, prelude=None) -> list:
    """The CUDA kernels of a torch.profiler trace of ``calls`` calls of
    ``fn``, which runs once before, outside the trace. Every call
    launches a kernel, but the profiler has recorded none, or fewer than
    the calls, when it first traced the decode kernel: such a trace is
    taken again, up to three times in all. With ``prelude`` (a stream),
    the trace opens with 20 spin kernels of ~25 us on that stream, left
    out of the result: the profiler has dropped the first few records of
    a trace (up to six in a graph replay late in the run), and they are
    then the spin kernels' records."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            if prelude is not None:
                with torch.cuda.stream(prelude):
                    for _ in range(20):
                        torch.cuda._sleep(50_000)
                prelude.synchronize()
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and "spin_kernel" not in e.key]
        if sum(e.count for e in events) >= calls:
            break
    return events


def report_trace(label: str, kernels: list, wall_ms: float,
                 calls: int = 1) -> None:
    """Log what a trace of ``calls`` calls (``kernels``, from
    :func:`cuda_events`) shows against ``wall_ms``, one call's time taken
    without the profiler: the device's busy share of it, the six kernels
    with the most device time per call, and the device time per launch
    of the port's own kernels."""
    if not kernels:
        log(f"  {label}: device time not measured (the profiler "
            f"recorded no CUDA kernel)")
        return
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / calls
    log(f"  {label}: {sum(e.count for e in kernels) // calls} kernel "
        f"launches per call, device busy {busy_ms:.3f} ms of "
        f"{wall_ms:.3f} ms ({busy_ms / wall_ms:.1%}; idle "
        f"{1 - busy_ms / wall_ms:.1%})")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]:
        log(f"    {e.self_device_time_total / 1e3 / calls:8.3f} ms  "
            f"x{e.count // calls:<5d} {e.key[:90]}")
    per_name: dict = {}
    for e in kernels:
        name = kernel_name(e.key)
        if name.startswith(PORT_KERNELS):
            us, n = per_name.get(name, (0.0, 0))
            per_name[name] = (us + e.self_device_time_total, n + e.count)
    for name, (us, n) in per_name.items():
        log(f"    {name}: {us / n:.2f} us of device time per launch, "
            f"x{n // calls}, {us / 1e3 / calls:.3f} ms per call "
            f"({us / 1e3 / calls / busy_ms:.1%} of the busy time)")


def kernel_name(key: str) -> str:
    """The function name of a profiler's kernel key, e.g.
    ``decode_attention_kernel`` of ``void (anonymous namespace)::
    decode_attention_kernel<float, 2, 4>(float const*, ...)``."""
    name = re.search(r"(\w+)(<|\(|$)", key.split("::")[-1])
    return name.group(1) if name else key[:40]


# ---------------------------------------------------------------- phase 3

def smoke_cfg(arch: str):
    """The smoke config; the hybrid's in the expert-free one-period form
    that phase 7 runs at full width."""
    return without_experts(get_smoke(arch)) if arch == HYBRID \
        else get_smoke(arch)


def smoke_batch(cfg, tok: torch.Tensor, frames: int = 0) -> dict:
    """``tok`` with the stub features of an encoder-decoder config
    (``frames`` frames, default its encoder_max_frames) or an image
    config (its image tokens), seeded, on the CPU."""
    rng = np.random.default_rng(1)
    batch = {"tokens": tok}
    if cfg.is_encoder_decoder:
        batch["frames"] = torch.from_numpy(rng.standard_normal(
            (tok.shape[0], frames or cfg.encoder_max_frames,
             AUDIO_FEAT_DIM), dtype=np.float32))
    if cfg.num_image_tokens:
        batch["image_feats"] = torch.from_numpy(rng.standard_normal(
            (tok.shape[0], cfg.num_image_tokens, IMAGE_FEAT_DIM),
            dtype=np.float32))
    return batch


def check_forward_against_cpu() -> None:
    """The port's forward through the kernels on the card agrees with its
    plain path on the CPU, same parameters, smoke configs (the hybrid
    over two scan chunks of 64; whisper over its 64 stub frames, pixtral
    after its 16 stub patch embeddings)."""
    for arch, s in (("llama3.2-1b", 32), ("llama3.2-1b-sw", 96),
                    ("xlstm-125m", 32), (HYBRID, 128),
                    ("phi3-mini-3.8b", 32), ("qwen2-72b", 32),
                    ("granite-34b", 32), ("granite-moe-1b-a400m", 96),
                    (DEEPSEEK, 32), ("whisper-small", 32),
                    ("pixtral-12b", 32)):
        cfg = smoke_cfg(arch)
        cpu_model = build_model(cfg, "cpu")
        params = cpu_model.init(torch.Generator().manual_seed(0))
        gpu_model = build_model(cfg, "cuda")
        gpu_params = _tree_to(params, "cuda")
        batch = smoke_batch(cfg, torch.from_numpy(np.random.default_rng(
            0).integers(0, cfg.vocab_size, (2, s), dtype=np.int64)))
        with torch.inference_mode():
            exp, _ = cpu_model.forward(params, batch)
            got, _ = gpu_model.forward(gpu_params, batch_on(batch, "cuda"))
        got = got.cpu()
        err = float((got - exp).abs().max())
        torch.testing.assert_close(got, exp, atol=1e-4, rtol=1e-4,
                                   msg=lambda m: f"{arch} forward: {m}")
        log(f"  {arch:15s} smoke forward cuda vs cpu: max_abs_err="
            f"{err:.3e} (tol 1e-4)  ok")


def check_decode_against_cpu() -> None:
    """The port's prefill + greedy decode through the kernels on the card
    agrees with its plain path on the CPU, same parameters and tokens,
    smoke configs: llama3.2-1b, and llama3.2-1b-sw with a prompt longer
    than its 64-slot window and steps that wrap the ring, the hybrid
    with a prompt of two scan chunks and 8 steps past it, the dense,
    MoE and MLA families of phase 8 (MLA's absorbed decode is plain on
    both sides; its prefill runs the flash kernel), xLSTM with a prompt
    of two mLSTM chunks and 8 steps of its carried state, whisper over 8
    stub frames (fewer than its 64) with the cross-attention over them
    at each step, and pixtral after its 16 stub patch embeddings, its
    positions counting them."""
    for arch, prompt, steps in (("llama3.2-1b", 9, 3),
                                ("llama3.2-1b-sw", 96, 40), (HYBRID, 128, 8),
                                ("phi3-mini-3.8b", 9, 3), ("qwen2-72b", 9, 3),
                                ("granite-34b", 9, 3),
                                ("granite-moe-1b-a400m", 9, 3),
                                (DEEPSEEK, 9, 3), ("xlstm-125m", 128, 8),
                                ("whisper-small", 9, 3),
                                ("pixtral-12b", 9, 3)):
        cfg = smoke_cfg(arch)
        cpu_model, gpu_model = build_model(cfg, "cpu"), build_model(cfg,
                                                                    "cuda")
        params = cpu_model.init(torch.Generator().manual_seed(0))
        gpu_params = _tree_to(params, "cuda")
        batch = smoke_batch(cfg, torch.from_numpy(np.random.default_rng(
            0).integers(0, cfg.vocab_size, (2, prompt), dtype=np.int64)),
            frames=8)
        npfx = cfg.num_image_tokens
        smax = npfx + prompt + steps
        err = 0.0
        with torch.inference_mode():
            exp, state = cpu_model.prefill(params, batch, smax)
            got, gpu_state = gpu_model.prefill(gpu_params,
                                               batch_on(batch, "cuda"), smax)
            for i in range(steps + 1):
                got = got.cpu()
                err = max(err, float((got - exp).abs().max()))
                torch.testing.assert_close(
                    got, exp, atol=1e-4, rtol=1e-4,
                    msg=lambda m: f"{arch} decode step {i}: {m}")
                if not torch.equal(got.argmax(-1), exp.argmax(-1)):
                    raise RuntimeError(f"{arch}: greedy tokens differ at "
                                       f"step {i}")
                if i == steps:
                    break
                nxt = exp.argmax(-1)
                pos = npfx + prompt + i
                exp, state = cpu_model.decode_step(params, nxt, pos, state)
                got, gpu_state = gpu_model.decode_step(
                    gpu_params, nxt.to("cuda"), pos, gpu_state)
        log(f"  {arch:15s} smoke prefill {prompt} + {steps} decode steps "
            f"cuda vs cpu: max_abs_err={err:.3e} (tol 1e-4)  ok")


def _tree_to(tree, device, copy: bool = False):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device, copy) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_tree_to(v, device, copy) for v in tree)
    return tree.to(device, copy=copy)


def build_and_profile():
    """Build both stages at full width, capture their CUDA graphs (one a
    power-of-two bucket up to the largest profiled batch), hold every
    bucket's replay against the eager forward, and profile the replays."""
    stages, store = {}, ProfileStore()
    for arch in STAGES:
        t0 = time.perf_counter()
        st = make_stage(arch, "cuda", full=True, seed=0)
        n_params = sum(t.numel() for t in _leaves(st.params))
        with torch.inference_mode():
            logits, _ = st.model.forward(st.params, {"tokens": torch.ones(
                (2, SEQ), dtype=torch.int32, device=st.model.device)})
        if logits.shape != (2, SEQ, st.cfg.vocab_size) or \
                not bool(torch.isfinite(logits).all()):
            raise RuntimeError(f"{arch}: bad full-width logits "
                               f"{tuple(logits.shape)}")
        t1 = time.perf_counter()
        st.warmup(max(PROFILE_BATCHES))
        capture_s = time.perf_counter() - t1
        check_replays(arch, st)
        store.add(profile_model_measured(arch, st.profile_fn, "h100-1",
                                         batch_sizes=PROFILE_BATCHES))
        stages[arch] = st
        log(f"  {arch}: {st.cfg.num_layers}L d_model={st.cfg.d_model} "
            f"vocab={st.cfg.vocab_size} params={n_params}; "
            f"{len(st.graphs)} CUDA graphs {sorted(st.graphs)} captured in "
            f"{capture_s:.1f} s, one replay launching "
            f"{ {c_name(c): k for c, k in st.graphs[SERVE_BATCH].launches} }"
            f" ({time.perf_counter() - t0:.1f} s to build, capture, check, "
            f"profile)")
    log(f"  device memory after capture: "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated, "
        f"{torch.cuda.memory_reserved() / 1e9:.2f} GB reserved")
    log("  batch  " + "  ".join(f"{a + ' ms':>16s} {'qps':>8s}"
                                for a in STAGES))
    for bsz in PROFILE_BATCHES:
        cells = []
        for arch in STAGES:
            lat = store.get(arch).batch_latency("h100-1", bsz)
            cells.append(f"{lat * 1e3:16.3f} {bsz / lat:8.1f}")
        log(f"  {bsz:5d}  " + "  ".join(cells))
    return stages, store


def c_name(counter) -> str:
    return next(n for n, c in COUNTERS.items() if c is counter)


def check_replays(arch, st) -> None:
    """A replay's logits against the eager forward's on the same tokens,
    at every bucket: bit for bit, or within 1e-5 (then the log says so);
    the answer against the eager argmax; the launches each replay adds
    against those of one forward."""
    want = {name: k for name, k in launches_per_forward(st.cfg, SEQ).items()
            if k}
    equal, near = [], []
    for b, bucket in sorted(st.graphs.items()):
        got_launches = {c_name(c): k for c, k in bucket.launches}
        if got_launches != want:
            raise RuntimeError(f"{arch} bucket {b}: captured launches "
                               f"{got_launches} != {want}")
        rows = np.random.default_rng(b).integers(
            0, st.cfg.vocab_size, (b, SEQ), dtype=np.int32)
        out = np.stack(st.run_batch(list(rows)))
        with torch.inference_mode():
            exp, _ = st.model.forward(st.params, {"tokens": torch.from_numpy(
                rows).to(st.model.device)})
            nxt = exp[:, -1].argmax(-1).cpu().numpy()
            if torch.equal(bucket.logits, exp):
                equal.append(b)
            else:
                err = float((bucket.logits - exp).abs().max())
                if not err <= 1e-5:
                    raise RuntimeError(f"{arch} bucket {b}: replay logits "
                                       f"differ from eager by {err:.3e}")
                near.append(f"{b} ({err:.3e})")
        if not (np.array_equal(out[:, :-1], rows[:, 1:])
                and np.array_equal(out[:, -1], nxt)):
            raise RuntimeError(f"{arch} bucket {b}: the replay's answer is "
                               f"not the eager forward's")
        del exp
    log(f"  {arch}: replay logits bit-equal to the eager forward at buckets "
        f"{equal}; within 1e-5 at {near or 'none'}; every answer equal")


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, tuple):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


# ------------------------------------------------------------ phases 4, 4b

def cascade_pipeline(arches=STAGES):
    return linear_pipeline("cascade", list(arches),
                           {a: ["h100-1"] for a in arches})


def serve_config(stages, pipe, config, arrivals) -> tuple:
    """Serve ``arrivals`` through the executor on ``config`` (a chain of
    the stages, in ``pipe``'s order), with the launch counters zeroed just
    before and read just after; check every answer, the exact launch
    counts and each stage's batch cap. Returns (latencies, launches)."""
    arches = [st.model_id for st in pipe.stages.values()]
    ex = PipelineExecutor(pipe, config,
                          {a: stages[a].run_batch for a in arches})
    payload = payload_fn(stages, arches)
    try:
        reset_counts()
        lat = ex.serve_trace(arrivals, payload)
        launches = counts()
        outs = ex.outputs()
        sizes = ex.batch_sizes()
    finally:
        if not ex.shutdown():
            raise RuntimeError("executor workers did not stop")
    if not np.isfinite(lat).all():
        raise RuntimeError(f"{int((~np.isfinite(lat)).sum())} of "
                           f"{lat.size} requests unanswered")
    check_answers(stages, arches, outs, payload)
    check_batches(stages, arches, config, sizes, launches)
    return lat, launches


def payload_fn(stages, arches):
    vocab = stages[arches[0]].cfg.vocab_size

    def payload(i: int) -> np.ndarray:
        return np.random.default_rng(1000 + i).integers(
            0, vocab, SEQ, dtype=np.int32)
    return payload


def check_answers(stages, arches, outs, payload) -> None:
    """Each answer of a chain of ``arches``: request i's window shifted
    by one a stage, each stage's argmax appended inside its vocabulary."""
    vocabs = [stages[a].cfg.vocab_size for a in arches]
    k = len(arches)
    for i, out in enumerate(outs):
        p = payload(i)
        if not (isinstance(out, np.ndarray) and out.shape == (SEQ,)
                and out.dtype == np.int32):
            raise RuntimeError(f"request {i}: bad answer {out!r}")
        if not (np.array_equal(out[:SEQ - k], p[k:])
                and all(0 <= out[SEQ - k + j] < v
                        for j, v in enumerate(vocabs))):
            raise RuntimeError(f"request {i}: answer is not the chain of "
                               f"shifted windows: {out}")


def check_batches(stages, arches, config, sizes, launches) -> None:
    """The launches counted during a run against those of the batches it
    served, and each batch against its stage's cap."""
    n_batches = {a: int(sizes[f"s{i}_{a}"].size)
                 for i, a in enumerate(arches)}
    per_fwd = {a: launches_per_forward(stages[a].cfg, SEQ) for a in arches}
    expect = {name: sum(per_fwd[a][name] * n_batches[a] for a in arches)
              for name in COUNTERS}
    if launches != expect:
        raise RuntimeError(f"kernel launches during serving {launches} != "
                           f"{expect} expected from {n_batches} batches")
    for s, v in sizes.items():
        if int(v.max()) > config[s].batch_size:
            raise RuntimeError(f"{s}: a batch exceeded "
                               f"{config[s].batch_size}: {v}")
    mean_batch = {s: round(float(v.mean()), 3) for s, v in sizes.items()}
    log(f"  batches per stage {n_batches}, mean batch size {mean_batch}")
    log(f"  kernel launches during serving {launches} (expected {expect})")


def latency_line(lat: np.ndarray, pipe, store, config,
                 arrivals: np.ndarray) -> str:
    """The measured p50/p99/miss beside the Estimator's p50/p99 for the
    same configuration and trace (the paper's Fig. 8 comparison)."""
    predicted = Estimator(pipe, store).simulate(config, arrivals)
    if predicted.latency.shape != lat.shape or \
            not np.isfinite(predicted.latency).all():
        raise RuntimeError("the Estimator did not answer every request")
    return (f"measured p50 {np.percentile(lat, 50) * 1e3:.2f} ms  p99 "
            f"{np.percentile(lat, 99) * 1e3:.2f} ms  miss(SLO "
            f"{SLO_S * 1e3:g} ms) {float((lat > SLO_S).mean()):.4f} | "
            f"estimator p50 {predicted.percentile(50) * 1e3:.2f} ms  p99 "
            f"{predicted.p99 * 1e3:.2f} ms")


def serve(stages, store) -> dict:
    pipe = cascade_pipeline()
    config = PipelineConfig({s: StageConfig("h100-1", SERVE_BATCH, 1)
                             for s in pipe.stages})
    arrivals = gamma_trace(SERVE_QPS, 1.0, SERVE_S, seed=1)
    lat, launches = serve_config(stages, pipe, config, arrivals)
    log(f"  served {lat.size} requests at {SERVE_QPS:g} qps for "
        f"{SERVE_S:g} s: "
        f"{latency_line(lat, pipe, store, config, arrivals)}")
    return launches


def plan_and_serve(stages, store, arches=STAGES) -> tuple:
    """Steps 2-4 of examples/serve_real_models.py on the card: plan the
    chain of ``arches`` (the cascade, or one stage alone) from the
    measured profile, check that every planned batch lies within the
    profile, serve the planned configuration, and print the Estimator's
    prediction beside the measured latency. Returns (the launches, the
    plan's configuration)."""
    pipe = cascade_pipeline(arches)
    sample = gamma_trace(PLAN_QPS, 1.0, PLAN_SAMPLE_S, seed=0)
    t0 = time.perf_counter()
    plan = Planner(pipe, store).plan(sample, SLO_S)
    plan_s = time.perf_counter() - t0
    log(f"  planned for {sample.size} sample requests at {PLAN_QPS:g} qps "
        f"(SLO {SLO_S * 1e3:g} ms) in {plan_s * 1e3:.1f} ms of planner "
        f"wall time:")
    for line in plan.describe().splitlines():
        log("  " + line)
    if not plan.feasible:
        raise RuntimeError("the Planner found no feasible configuration "
                           "for the measured profile")
    # no latency the plan was priced at is an extrapolation of the table
    for s in pipe.stages:
        if plan.config[s].batch_size > max(PROFILE_BATCHES):
            raise RuntimeError(
                f"{s}: planned batch {plan.config[s].batch_size} lies past "
                f"the largest profiled batch {max(PROFILE_BATCHES)}")
    log(f"  every planned batch is within the profile (<= "
        f"{max(PROFILE_BATCHES)})")
    live = gamma_trace(PLAN_QPS, 1.0, PLAN_LIVE_S, seed=1)
    lat, launches = serve_config(stages, pipe, plan.config, live)
    log(f"  served {lat.size} requests at {PLAN_QPS:g} qps for "
        f"{PLAN_LIVE_S:g} s on the plan: "
        f"{latency_line(lat, pipe, store, plan.config, live)}")
    return launches, plan.config


def serve_each_alone(stages, store, config) -> dict:
    """Each stage served alone, as a one-stage pipeline, on its planned
    StageConfig and the live trace of phase 4b, measured against the
    Estimator on the same trace: how much of a gap comes from one stage,
    and how much from the cascade sharing the host. Returns the
    launches."""
    live = gamma_trace(PLAN_QPS, 1.0, PLAN_LIVE_S, seed=1)
    total = dict.fromkeys(COUNTERS, 0)
    for i, arch in enumerate(STAGES):
        pipe = cascade_pipeline((arch,))
        alone = PipelineConfig({f"s0_{arch}": config[f"s{i}_{arch}"]})
        lat, launches = serve_config(stages, pipe, alone, live)
        c = alone[f"s0_{arch}"]
        log(f"  {arch} alone ({c.hardware}, batch {c.batch_size}, "
            f"{c.replicas} replica): served {lat.size} "
            f"requests at {PLAN_QPS:g} qps for {PLAN_LIVE_S:g} s: "
            f"{latency_line(lat, pipe, store, alone, live)}")
        for name, n in launches.items():
            total[name] += n
    return total


# ----------------------------------------------------------- phases 4d, 4e

def spike_trace() -> np.ndarray:
    """The spike of examples/serve_real_models.py step 5: 8 s at the
    planned 30 qps, 5 s at 3x with cv 0.7, then 17 s at 30 qps."""
    return np.concatenate([
        gamma_trace(PLAN_QPS, 1.0, 8, seed=3),
        8.0 + gamma_trace(3 * PLAN_QPS, 0.7, 5, seed=4),
        13.0 + gamma_trace(PLAN_QPS, 1.0, 17, seed=5)])


def warm_slots(stages) -> None:
    """Capture TUNE_MAX_REPLICAS replica slots a stage, before any
    executor runs: every replica the Tuner adds replays its own graphs
    on its own stream."""
    t0 = time.perf_counter()
    for arch in STAGES:
        stages[arch].warmup(max(PROFILE_BATCHES), slots=TUNE_MAX_REPLICAS)
    n = {a: [len(s.graphs) for s in stages[a].pool.slots] for a in STAGES}
    log(f"  replica slots captured in {time.perf_counter() - t0:.1f} s, "
        f"graphs per slot {n}; device memory "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated, "
        f"{torch.cuda.memory_reserved() / 1e9:.2f} GB reserved")


def serve_spike(stages, pipe, config, service, solo, controller,
                spike) -> tuple:
    """Serve ``spike`` through the live control loop with ``controller``
    on a fresh executor of ``config``, the launch counters zeroed just
    before and read just after; check that nothing was released, every
    answer, the launch counts and each batch's cap. Returns (the run,
    the launches)."""
    arches = [st.model_id for st in pipe.stages.values()]
    ex = PipelineExecutor(pipe, config,
                          {a: stages[a].run_batch for a in arches},
                          solo_latency_s=solo)
    payload = payload_fn(stages, arches)
    answers: dict = {}
    ex.on_request_done = lambda r: answers.__setitem__(r.rid, r.payload)
    loop = LiveControlLoop(ex, SLO_S, epoch_s=TUNE_EPOCH_S,
                           service_time_s=service)
    try:
        reset_counts()
        run = loop.run(spike, controller, payload)
        launches = counts()
        sizes = ex.batch_sizes()
        lags = ex.injection_stats()
    finally:
        if not ex.shutdown():
            raise RuntimeError("executor workers did not stop")
    lat = run.latency
    # the loop injects up to its last epoch boundary, as the reference's
    if run.released or not np.isfinite(lat).all() or lat.size != int(
            (spike <= run.telemetry[-1].t_end).sum()):
        raise RuntimeError(f"{run.released} released, "
                           f"{int((~np.isfinite(lat)).sum())} unanswered of "
                           f"{lat.size} ({spike.size} in the trace)")
    check_answers(stages, arches, [answers.get(i) for i in range(lat.size)],
                  payload)
    check_batches(stages, arches, config, sizes, launches)
    log(f"  served {lat.size} requests of the spike's {spike.size} (those "
        f"up to the last of {len(run.telemetry)} control epochs of "
        f"{TUNE_EPOCH_S:g} s): measured p50 "
        f"{np.percentile(lat, 50) * 1e3:.2f} ms  p99 "
        f"{np.percentile(lat, 99) * 1e3:.2f} ms  miss {run.miss_rate:.4f}  "
        f"released {run.released}  mean ${run.mean_cost_per_hr():.2f}/hr; "
        f"injection lag p99 {lags['p99_lag_s'] * 1e3:.3f} ms, max "
        f"{lags['max_lag_s'] * 1e3:.3f} ms")
    return run, launches


def close_the_loop(stages, store, config) -> dict:
    """Step 5 of examples/serve_real_models.py on the card: the
    ClosedLoopTuner drives the live executor serving the planned cascade
    through the example's 3x spike (at least one scale-up is checked),
    then the co-simulated twin runs a fresh, identical tuner on the same
    trace, and the same spike is served once more with no controller
    (the planned fleet throughout) to show what the scaling did on one
    card. Returns the launches of both runs."""
    pipe = cascade_pipeline()
    service = Estimator(pipe, store).service_time(config)
    info = TunerPlanInfo.from_plan(
        pipe, config, store,
        gamma_trace(PLAN_QPS, 1.0, TUNE_SAMPLE_S, seed=2), service)
    solo = {s: store.get(pipe.stages[s].model_id).batch_latency("h100-1", 1)
            for s in pipe.stages}
    spike = spike_trace()
    log(f"  the Tuner: service time {service * 1e3:.2f} ms (the "
        f"Estimator's), sample {TUNE_SAMPLE_S:g} s at {PLAN_QPS:g} qps, "
        f"max_replicas {TUNE_MAX_REPLICAS}")
    run, launches = serve_spike(stages, pipe, config, service, solo,
                                ClosedLoopTuner(
                                    info, max_replicas=TUNE_MAX_REPLICAS),
                                spike)
    if not any(e.kind == "up" for e in run.events):
        raise RuntimeError("the Tuner issued no scale-up on a 3x spike")
    log_events("live", run.events)
    for s, tl in run.replica_timeline.items():
        log(f"  live {s} replicas: "
            + " -> ".join(f"{c}@{t:.1f}s" for t, c in tl))
    log(f"  live mean batch "
        f"{ {s: round(v, 3) for s, v in run.batch_stats().items()} }")

    twin = ControlLoopSession(pipe, store, config, SLO_S).run(
        spike, ClosedLoopTuner(info, max_replicas=TUNE_MAX_REPLICAS))
    log_events("twin", twin.events)
    for s, tl in twin.replica_timeline.items():
        log(f"  twin {s} replicas: "
            + " -> ".join(f"{c}@{t:.1f}s" for t, c in tl))
    log(f"  twin: estimated p50 {twin.sim.percentile(50) * 1e3:.2f} ms  "
        f"p99 {twin.sim.p99 * 1e3:.2f} ms  miss {twin.miss_rate:.4f}  "
        f"mean ${twin.mean_cost_per_hr():.2f}/hr")
    log(f"  final fleet: live "
        f"{ {s: tl[-1][1] for s, tl in run.replica_timeline.items()} }, "
        f"twin { {s: tl[-1][1] for s, tl in twin.replica_timeline.items()} }"
        f"; events live {len(run.events)}, twin {len(twin.events)}")
    log("  the same spike with no controller (one replica a stage "
        "throughout):")
    static, static_launches = serve_spike(stages, pipe, config, service,
                                          solo, NoOpController(), spike)
    # where the tail lies: the spike's edges and each event's landing
    edges = sorted({0.0, 8.0, 13.0, float(spike.max()) + 1e-6}
                   | {float(e.t_effective) for e in run.events})
    latency_by_window("live", run.arrival, run.latency, edges)
    latency_by_window("twin", twin.sim.arrival, twin.sim.latency, edges)
    latency_by_window("no controller", static.arrival, static.latency,
                      edges)
    log(f"  cost: each h100-1 replica is priced as a card of its own "
        f"(${get_hardware('h100-1').cost_per_hr:.2f}/hr, an assumption), "
        f"while all {TUNE_MAX_REPLICAS * len(pipe.stages)} replica slots "
        f"of both stages run on this one card")
    return {name: n + static_launches[name]
            for name, n in launches.items()}


def latency_by_window(label: str, arrival, lat, edges) -> None:
    cells = []
    for lo, hi in zip(edges[:-1], edges[1:]):
        m = (arrival >= lo) & (arrival < hi)
        if m.any():
            cells.append(f"[{lo:.0f}, {hi:.0f}) s n={int(m.sum())} p50 "
                         f"{np.percentile(lat[m], 50) * 1e3:.2f} p99 "
                         f"{np.percentile(lat[m], 99) * 1e3:.2f}")
    log(f"  {label} latency ms by arrival window: " + "; ".join(cells))


def log_events(label: str, events) -> None:
    for e in events:
        log(f"  {label} t={e.t:5.1f}s  {e.kind:4s} {e.stage:16s} "
            f"{e.value:+g}  effective {e.t_effective:.1f}s")


def replicas_on_one_card(stages, reps: int = 30) -> None:
    """What a second, third and fourth replica of a stage add on one
    card: 1, 2 and 4 threads at once, each replaying the bucket of
    SERVE_BATCH on its own slot (its own graph and stream, each replay
    followed by a synchronize of that stream), host clock. Prints the
    batches a second all threads served and the ms a replay, against one
    thread alone."""
    for arch in STAGES:
        slots = stages[arch].pool.slots
        cells, base = [], None
        for n in SLOT_THREADS:
            per = [0.0] * n
            start = threading.Barrier(n + 1)

            def run(k: int) -> None:
                slot = slots[k]
                graph = slot.graphs[SERVE_BATCH].graph
                with torch.cuda.stream(slot.stream):
                    graph.replay()
                    slot.stream.synchronize()
                    start.wait()
                    t0 = time.perf_counter()
                    for _ in range(reps):
                        graph.replay()
                        slot.stream.synchronize()
                    per[k] = (time.perf_counter() - t0) / reps * 1e3

            threads = [threading.Thread(target=run, args=(k,))
                       for k in range(n)]
            for t in threads:
                t.start()
            start.wait()
            t0 = time.perf_counter()
            for t in threads:
                t.join()
            rate = n * reps / (time.perf_counter() - t0)
            ms = sum(per) / n
            base = base or (rate, ms)
            cells.append(f"{n}: {rate:.1f} batches/s ({rate / base[0]:.2f}x),"
                         f" {ms:.3f} ms a replay ({ms / base[1]:.2f}x)")
        log(f"  {arch} replicas replaying a batch of {SERVE_BATCH} at once, "
            f"each on its own slot: " + "; ".join(cells))


# ----------------------------------------------------------- phases 4f, 4g

def device_used_gb() -> list:
    """GB in use on each card, by every process (cudaMemGetInfo). In a
    container nvidia-smi may not tell its processes apart, so a worker's
    footprint is the rise it causes."""
    out = []
    for k in range(torch.cuda.device_count()):
        free, total = torch.cuda.mem_get_info(k)
        out.append((total - free) / 1e9)
    return out


def gb_line(used: list) -> str:
    return ", ".join(f"cuda:{k} {g:.2f} GB" for k, g in enumerate(used))


def proc_specs(arches, cards, max_batch: int, counts_dir) -> dict:
    """The process backend's stage fns: each stage built at full width
    from seed 0 (the parent's weights) in every worker, on the least
    loaded of ``cards``, warmed up to ``max_batch``."""
    return {a: ProcessStage(a, full=True, seed=0, devices=tuple(cards),
                            max_batch=max_batch, counts_dir=str(counts_dir))
            for a in arches}


def wait_for_workers(ex, pipe) -> None:
    """Wait, at most PROC_READY_S, until every stage's replica target is
    served by a live worker process; a worker that failed to start fails
    the run."""
    deadline = time.perf_counter() + PROC_READY_S
    while not all(ex.live_process_count(s) == ex.replica_target(s)
                  for s in pipe.stages):
        ex.check_worker_failures("the worker processes' start")
        if time.perf_counter() > deadline:
            raise RuntimeError(
                f"worker processes not ready within {PROC_READY_S:g} s: "
                f"{ {s: ex.live_process_count(s) for s in pipe.stages} }")
        time.sleep(0.1)


def log_spawns(ex, pipe) -> list:
    """Print each worker's card and spawn-to-ready time beside the
    Tuner's activation delay; returns every worker's pid."""
    pids = []
    for s in pipe.stages:
        spawns = ex.worker_spawns(s)
        pids += [pid for pid, _, _ in spawns]
        log(f"  {s} workers, spawn to ready: " + ", ".join(
            f"pid {pid} on {dev} {t:.2f} s" for pid, dev, t in spawns)
            + f" (a replica the Tuner adds serves {REPLICA_ACTIVATION_S:g}"
            f" s after its event)")
    return pids


def pid_gone(pid: int) -> bool:
    return not Path(f"/proc/{pid}").exists()


def check_child_counts(stages, arches, counts_dir, sizes, kills) -> dict:
    """The launch counts the worker processes wrote: each worker's
    launches exactly one forward's times the batches it served, and each
    stage's workers' batches those the executor formed, less at most
    PROC_RING batches a SIGKILLed worker had in flight. Returns the
    launches summed over the workers."""
    total = dict.fromkeys(COUNTERS, 0)
    served = dict.fromkeys(arches, 0)
    for (arch, pid), c in worker_counts(counts_dir).items():
        per = launches_per_forward(stages[arch].cfg, SEQ)
        want = {k: per[k] * c["batches"] for k in COUNTERS}
        got = {k: c[k] for k in COUNTERS}
        if got != want:
            raise RuntimeError(f"{arch} worker {pid}: launches {got} != "
                               f"{want} of {c['batches']} batches")
        served[arch] += c["batches"]
        for k in COUNTERS:
            total[k] += got[k]
    for i, a in enumerate(arches):
        formed = int(sizes[f"s{i}_{a}"].size)
        if not formed - PROC_RING * kills.get(a, 0) <= served[a] <= formed:
            raise RuntimeError(f"{a}: workers served {served[a]} batches, "
                               f"the executor formed {formed}")
    log(f"  worker launches {total}: one forward's per batch in every "
        f"worker; batches served by the workers {served}")
    return total


def worker_matches_the_parent(stages) -> None:
    """A worker process per stage, on cuda:0, answers a fixed batch of
    SERVE_BATCH as the parent's in-process stage does, bit for bit, with
    one forward's launches; then the round trip through the ring against
    a replay in this process (best of PROC_REPS each): the IPC a batch
    costs."""
    with tempfile.TemporaryDirectory() as counts_dir:
        for arch in STAGES:
            st = stages[arch]
            pool = ProcessReplicaPool(ProcessStage(
                arch, full=True, seed=0, devices=("cuda:0",),
                max_batch=SERVE_BATCH, counts_dir=counts_dir))
            try:
                used0 = device_used_gb()[0]
                rep = pool.spawn()
                footprint = device_used_gb()[0] - used0
                rows = list(np.random.default_rng(7).integers(
                    0, st.cfg.vocab_size, (SERVE_BATCH, SEQ),
                    dtype=np.int32))
                got, exp = rep.run(rows), st.run_batch(rows)
                if not all(g.dtype == e.dtype and np.array_equal(g, e)
                           for g, e in zip(got, exp)):
                    raise RuntimeError(f"{arch}: the worker's answers differ "
                                       f"from the parent's stage")
                c = worker_counts(counts_dir)[(arch, rep.pid)]
                per = launches_per_forward(st.cfg, SEQ)
                if {k: c[k] for k in COUNTERS} != per or c["batches"] != 1:
                    raise RuntimeError(f"{arch} worker launches {c} != one "
                                       f"forward's {per}")
                ring, local = [], []
                for _ in range(PROC_REPS):
                    t0 = time.perf_counter()
                    rep.run(rows)
                    ring.append(time.perf_counter() - t0)
                    t0 = time.perf_counter()
                    st.run_batch(rows)
                    local.append(time.perf_counter() - t0)
                ts = rep.transport_stats()
                batches = ts.typed_batches + ts.pickle_batches
                log(f"  {arch}: a worker on cuda:0 (pid {rep.pid}, ready in "
                    f"{rep.ready_s:.2f} s, {footprint:.2f} GB of device "
                    f"memory with its graphs to {SERVE_BATCH}) answers a "
                    f"batch of {SERVE_BATCH} "
                    f"bit-equal to this process's stage, one forward's "
                    f"launches; a batch through the ring {min(ring) * 1e3:.3f}"
                    f" ms against {min(local) * 1e3:.3f} ms in this process "
                    f"(best of {PROC_REPS}): {(min(ring) - min(local)) * 1e3:.3f}"
                    f" ms of IPC, {ts.bytes_copied / batches:.0f} bytes "
                    f"copied a batch, both ways, parent side")
            finally:
                pool.close_all()
            if not pid_gone(rep.pid):
                raise RuntimeError(f"{arch} worker {rep.pid} outlived its "
                                   f"pool")


def serve_processes(stages, pipe, config, specs, counts_dir, controller,
                    trace, service, solo, faults=None) -> dict:
    """Serve ``trace`` through the live control loop with ``controller``
    on a process-backend executor of ``config`` (one worker process a
    replica, built from ``specs``), after every worker is ready. Checks:
    every request delivered exactly once and answered with the chain of
    shifted windows, nothing released, each batch within its cap, the
    workers' launch counts, every worker reaped at the end, and every
    scheduled crash a dead pid. Returns what the caller prints."""
    arches = [st.model_id for st in pipe.stages.values()]
    used0 = device_used_gb()
    ex = PipelineExecutor(pipe, config, specs, solo_latency_s=solo,
                          faults=faults, backend="process")
    payload = payload_fn(stages, arches)
    answers: dict = {}
    delivered: dict = {}
    lock = threading.Lock()

    def on_done(r) -> None:
        with lock:
            answers[r.rid] = r.payload
            delivered[r.rid] = delivered.get(r.rid, 0) + 1

    ex.on_request_done = on_done
    loop = LiveControlLoop(ex, SLO_S, epoch_s=TUNE_EPOCH_S,
                           service_time_s=service,
                           drain_timeout_s=PROC_READY_S)
    try:
        t0 = time.perf_counter()
        wait_for_workers(ex, pipe)
        used = device_used_gb()
        log(f"  {sum(config[s].replicas for s in pipe.stages)} worker "
            f"processes ready {time.perf_counter() - t0:.1f} s after the "
            f"executor started them; the workers hold "
            f"{gb_line([u - b for u, b in zip(used, used0)])} (their rise "
            f"in device memory), every process {gb_line(used)}")
        if any(v for c in worker_counts(counts_dir).values()
               for v in c.values()):
            raise RuntimeError("a worker counted launches before the run")
        reset_counts()
        run = loop.run(trace, controller, payload)
        parent = counts()
        killed = {s: ex.killed_worker_pids(s) for s in pipe.stages}
        sizes = ex.batch_sizes()
        fleet = {s: tl[-1][1] for s, tl in ex.replica_timeline.items()}
        deltas = ex.fault_deltas()
        dataplane = ex.dataplane_stats()
        lags = ex.injection_stats()
        memory = gb_line(device_used_gb())
        pids = log_spawns(ex, pipe)
    finally:
        if not ex.shutdown(join_timeout_s=60.0):
            raise RuntimeError("executor workers did not stop")
    if any(parent.values()):
        raise RuntimeError(f"the parent launched kernels while the workers "
                           f"served: {parent}")
    lat = run.latency
    n = lat.size
    # the loop injects up to its last epoch boundary (an arrival the
    # injector reached before the loop stopped it may follow)
    if run.released or not np.isfinite(lat).all() or not int(
            (trace <= run.telemetry[-1].t_end).sum()) <= n <= trace.size:
        raise RuntimeError(f"{run.released} released, "
                           f"{int((~np.isfinite(lat)).sum())} unanswered of "
                           f"{n} ({trace.size} in the trace)")
    if sorted(delivered) != list(range(n)) or \
            any(v != 1 for v in delivered.values()):
        raise RuntimeError(f"delivery was not exactly once: "
                           f"{ {r: v for r, v in delivered.items() if v != 1} }"
                           f", {n - len(delivered)} never delivered")
    check_answers(stages, arches, [answers.get(i) for i in range(n)],
                  payload)
    for s, v in sizes.items():
        if int(v.max()) > config[s].batch_size:
            raise RuntimeError(f"{s}: a batch exceeded its cap")
    kills = {pipe.stages[s].model_id: -sum(d for _, d in deltas[s])
             for s in pipe.stages}
    scheduled = {pipe.stages[s].model_id: (
        sum(k for _, k in faults.stage(s).crashes())
        if faults and faults.stage(s) else 0) for s in pipe.stages}
    signalled = {pipe.stages[s].model_id: len(killed[s])
                 for s in pipe.stages}
    if not kills == scheduled == signalled:
        raise RuntimeError(f"crashes landed {kills}, scheduled {scheduled}, "
                           f"worker processes SIGKILLed {signalled}")
    stray = [p for p in pids if not pid_gone(p)]
    if stray:
        raise RuntimeError(f"worker processes left running: {stray}")
    launches = check_child_counts(stages, arches, counts_dir, sizes, kills)
    per_batch = {s: (d.bytes_copied / max(1, d.typed_batches
                                          + d.pickle_batches))
                 for s, d in dataplane.items()}
    log(f"  delivered {n} of {n} requests exactly once; every answer the "
        f"chain of shifted windows; SIGKILLed pids {killed}, gone; every "
        f"worker reaped")
    log(f"  live: p50 {np.percentile(lat, 50) * 1e3:.2f} ms  p99 "
        f"{np.percentile(lat, 99) * 1e3:.2f} ms  miss {run.miss_rate:.4f}  "
        f"mean ${run.mean_cost_per_hr():.2f}/hr; injection lag p99 "
        f"{lags['p99_lag_s'] * 1e3:.3f} ms; data plane "
        + ", ".join(f"{s} {b:.0f} bytes copied a batch (parent side)"
                    for s, b in per_batch.items())
        + f"; device memory in use before shutdown: {memory}")
    return {"run": run, "fleet": fleet, "launches": launches}


def twin_line(label: str, twin) -> None:
    log(f"  {label}: estimated p50 {twin.sim.percentile(50) * 1e3:.2f} ms  "
        f"p99 {twin.sim.p99 * 1e3:.2f} ms  miss {twin.miss_rate:.4f}  "
        f"mean ${twin.mean_cost_per_hr():.2f}/hr")


def twin_fleet(config, twin, faults=None) -> dict:
    """The twin's final fleet: the plan, less the crashes, plus the
    control schedule's deltas (the executor's timeline counts both)."""
    return {s: config[s].replicas
            - (sum(k for _, k in faults.stage(s).crashes())
               if faults and faults.stage(s) else 0)
            + sum(d for _, d in twin.replica_schedules.get(s, ()))
            for s in config.stage_configs}


def processes_under_faults(stages, store, config) -> dict:
    """Phase 4b's plan served by the process backend on this card, one
    worker a replica, through 4b's live trace, while a FaultSchedule
    SIGKILLs the worker of each stage mid-run (PROC_CRASH_T) and
    ClosedLoopTuner(failure_recovery=True) buys each replacement; the
    co-simulated twin runs the same trace and schedule. The live final
    fleet must equal the twin's. Returns the workers' launches."""
    pipe = cascade_pipeline()
    service = Estimator(pipe, store).service_time(config)
    info = TunerPlanInfo.from_plan(
        pipe, config, store,
        gamma_trace(PLAN_QPS, 1.0, TUNE_SAMPLE_S, seed=2), service)
    solo = {s: store.get(pipe.stages[s].model_id).batch_latency("h100-1", 1)
            for s in pipe.stages}
    live = gamma_trace(PLAN_QPS, 1.0, PLAN_LIVE_S, seed=1)

    def schedule() -> FaultSchedule:
        return FaultSchedule([crash(s, t) for s, t in
                              zip(pipe.stages, PROC_CRASH_T)], seed=0,
                             recovery=RecoveryPolicy())

    log(f"  crashes {[(s, t) for s, t in zip(pipe.stages, PROC_CRASH_T)]}"
        f" (SIGKILL), recovery {RecoveryPolicy()}")
    max_batch = max(config[s].batch_size for s in pipe.stages)
    with tempfile.TemporaryDirectory() as counts_dir:
        out = serve_processes(
            stages, pipe, config,
            proc_specs(STAGES, ("cuda:0",), max_batch, counts_dir),
            counts_dir, ClosedLoopTuner(info, failure_recovery=True), live,
            service, solo, faults=schedule())
    run = out["run"]
    log_events("live", run.events)
    twin = ControlLoopSession(pipe, store, config, SLO_S).run(
        live, ClosedLoopTuner(info, failure_recovery=True),
        faults=schedule())
    log_events("twin", twin.events)
    twin_line("twin", twin)
    fleet = twin_fleet(config, twin, schedule())
    log(f"  final fleet: live {out['fleet']}, twin {fleet}")
    if out["fleet"] != fleet:
        raise RuntimeError(f"the live final fleet {out['fleet']} is not "
                           f"the twin's {fleet}")
    edges = sorted({0.0, float(live.max()) + 1e-6}
                   | {float(t) for t in PROC_CRASH_T}
                   | {float(e.t_effective) for e in run.events})
    latency_by_window("live", run.arrival, run.latency, edges)
    latency_by_window("twin", twin.sim.arrival, twin.sim.latency, edges)
    return out["launches"]


def processes_on_their_own_cards(stages, reps: int = 30) -> None:
    """Phase 4g (a), the counterpart of 4e across cards: GPU_CARDS worker
    processes a stage, one a card, each answering the fixed batch of
    SERVE_BATCH bit-equal to this process's stage; then 1, 2 and 4 of
    them at once, each fed by its own thread through its ring: batches a
    second against one, and ms a batch. Every worker's launches are
    checked against the batches it served."""
    cards = tuple(f"cuda:{k}" for k in range(GPU_CARDS))
    with tempfile.TemporaryDirectory() as counts_dir:
        pools = {a: ProcessReplicaPool(ProcessStage(
            a, full=True, seed=0, devices=cards, max_batch=SERVE_BATCH,
            counts_dir=counts_dir)) for a in STAGES}
        reps_by = {a: [None] * GPU_CARDS for a in STAGES}
        errors = []

        def start(a: str, k: int) -> None:
            try:
                reps_by[a][k] = pools[a].spawn()
            except Exception as e:  # noqa: BLE001 — re-raised below
                errors.append(e)

        try:
            used0 = device_used_gb()
            t0 = time.perf_counter()
            threads = [threading.Thread(target=start, args=(a, k))
                       for a in STAGES for k in range(GPU_CARDS)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(PROC_READY_S)
            if errors or any(r is None for v in reps_by.values() for r in v):
                raise RuntimeError(f"workers failed to start: {errors}")
            log(f"  {GPU_CARDS} workers a stage ready in "
                f"{time.perf_counter() - t0:.1f} s: " + "; ".join(
                    f"{a} " + ", ".join(f"{r.device} {r.ready_s:.2f} s"
                                        for r in reps_by[a])
                    for a in STAGES))
            used = device_used_gb()
            log(f"  the workers hold "
                f"{gb_line([u - b for u, b in zip(used, used0)])} (their "
                f"rise in device memory), every process {gb_line(used)}")
            for a in STAGES:
                if len({r.device for r in reps_by[a]}) != GPU_CARDS:
                    raise RuntimeError(f"{a}: workers placed on "
                                       f"{[r.device for r in reps_by[a]]}")
                rows = list(np.random.default_rng(7).integers(
                    0, stages[a].cfg.vocab_size, (SERVE_BATCH, SEQ),
                    dtype=np.int32))
                exp = stages[a].run_batch(rows)
                for r in reps_by[a]:
                    if not all(np.array_equal(g, e)
                               for g, e in zip(r.run(rows), exp)):
                        raise RuntimeError(f"{a} worker on {r.device}: "
                                           f"answers differ from cuda:0's")
                cells, base = [], None
                for n in SLOT_THREADS:
                    per = [0.0] * n
                    gate = threading.Barrier(n + 1)

                    def run(k: int) -> None:
                        rep = reps_by[a][k]
                        rep.run(rows)
                        gate.wait()
                        t1 = time.perf_counter()
                        for _ in range(reps):
                            rep.run(rows)
                        per[k] = (time.perf_counter() - t1) / reps * 1e3

                    threads = [threading.Thread(target=run, args=(k,))
                               for k in range(n)]
                    for t in threads:
                        t.start()
                    gate.wait()
                    t1 = time.perf_counter()
                    for t in threads:
                        t.join()
                    rate = n * reps / (time.perf_counter() - t1)
                    ms = sum(per) / n
                    base = base or (rate, ms)
                    cells.append(f"{n}: {rate:.1f} batches/s "
                                 f"({rate / base[0]:.2f}x), {ms:.3f} ms a "
                                 f"batch ({ms / base[1]:.2f}x)")
                log(f"  {a} worker processes, one a card, each answering a "
                    f"batch of {SERVE_BATCH} through its ring: "
                    + "; ".join(cells))
            for (arch, pid), c in worker_counts(counts_dir).items():
                per = launches_per_forward(stages[arch].cfg, SEQ)
                if {k: c[k] for k in COUNTERS} != \
                        {k: per[k] * c["batches"] for k in COUNTERS}:
                    raise RuntimeError(f"{arch} worker {pid}: launches {c}")
        finally:
            for pool in pools.values():
                pool.close_all()
    stray = [r.pid for v in reps_by.values() for r in v
             if r is not None and not pid_gone(r.pid)]
    if stray:
        raise RuntimeError(f"worker processes left running: {stray}")


def spike_on_four_cards(stages, store, config) -> dict:
    """Phase 4g (b): phase 4d's spike, verbatim, served by the process
    backend with each stage's replicas placed one a card, under
    ClosedLoopTuner(max_replicas=4), beside the twin. Returns the
    workers' launches."""
    pipe = cascade_pipeline()
    service = Estimator(pipe, store).service_time(config)
    info = TunerPlanInfo.from_plan(
        pipe, config, store,
        gamma_trace(PLAN_QPS, 1.0, TUNE_SAMPLE_S, seed=2), service)
    solo = {s: store.get(pipe.stages[s].model_id).batch_latency("h100-1", 1)
            for s in pipe.stages}
    spike = spike_trace()
    cards = tuple(f"cuda:{k}" for k in range(GPU_CARDS))
    max_batch = max(config[s].batch_size for s in pipe.stages)
    with tempfile.TemporaryDirectory() as counts_dir:
        out = serve_processes(
            stages, pipe, config,
            proc_specs(STAGES, cards, max_batch, counts_dir), counts_dir,
            ClosedLoopTuner(info, max_replicas=TUNE_MAX_REPLICAS), spike,
            service, solo)
    run = out["run"]
    if not any(e.kind == "up" for e in run.events):
        raise RuntimeError("the Tuner issued no scale-up on a 3x spike")
    log_events("live", run.events)
    for s, tl in run.replica_timeline.items():
        log(f"  live {s} replicas: "
            + " -> ".join(f"{c}@{t:.1f}s" for t, c in tl))
    log(f"  live mean batch "
        f"{ {s: round(v, 3) for s, v in run.batch_stats().items()} }")
    twin = ControlLoopSession(pipe, store, config, SLO_S).run(
        spike, ClosedLoopTuner(info, max_replicas=TUNE_MAX_REPLICAS))
    log_events("twin", twin.events)
    for s, tl in twin.replica_timeline.items():
        log(f"  twin {s} replicas: "
            + " -> ".join(f"{c}@{t:.1f}s" for t, c in tl))
    twin_line("twin", twin)
    log(f"  final fleet: live {out['fleet']}, twin "
        f"{twin_fleet(config, twin)}; events live {len(run.events)}, twin "
        f"{len(twin.events)}")
    edges = sorted({0.0, 8.0, 13.0, float(spike.max()) + 1e-6}
                   | {float(e.t_effective) for e in run.events})
    latency_by_window("live", run.arrival, run.latency, edges)
    latency_by_window("twin", twin.sim.arrival, twin.sim.latency, edges)
    return out["launches"]


# ---------------------------------------------------------------- phase 5

def trace(stages, store) -> None:
    """Device time of one replay of the bucket of SERVE_BATCH per stage,
    summed over the CUDA kernels torch.profiler records, against the
    stage's profiled batch latency (taken without the profiler); the
    port's kernels in the trace must be those of one forward. Then both
    stages' replays from two threads at once, on their own streams and on
    one stream."""
    for arch in STAGES:
        st = stages[arch]
        want = {k: launches_per_forward(st.cfg, SEQ)[k]
                for k in ("rmsnorm", "flash_attention")}
        # a trace that still lacks some of the port's kernels is taken
        # again, up to three times in all
        for attempt in range(3):
            events = cuda_events(lambda: st.profile_fn(SERVE_BATCH),
                                 prelude=st.stream)
            seen = dict.fromkeys(want, 0)
            for e in events:
                name = kernel_name(e.key)
                if name.startswith("rmsnorm"):
                    seen["rmsnorm"] += e.count
                elif name == "flash_fwd_kernel":
                    seen["flash_attention"] += e.count
            if seen == want:
                break
            log(f"  {arch}: the trace recorded the port's kernels {seen}, "
                f"one forward launches {want}: tracing again")
        else:
            raise RuntimeError(f"{arch}: the replay's traces show the port's "
                               f"kernels {seen}, one forward launches {want}")
        report_trace(
            f"{arch} replay of a batch of {SERVE_BATCH}", events,
            store.get(arch).batch_latency("h100-1", SERVE_BATCH) * 1e3)
        log(f"  {arch}: the replay's trace holds the kernels of one forward "
            f"{seen}")
    concurrent_replays(stages)


def concurrent_replays(stages, reps: int = 20) -> None:
    """Host-clock ms per replay (each followed by a synchronize of its
    stream) of the bucket of SERVE_BATCH of each stage: alone, then both
    stages from two threads at once, first each on its stage's own stream
    (as served), then both on the default stream."""
    buckets = {a: stages[a].graphs[SERVE_BATCH] for a in STAGES}

    def run(arch, stream, out) -> None:
        with torch.cuda.stream(stream):
            t0 = time.perf_counter()
            for _ in range(reps):
                buckets[arch].graph.replay()
                stream.synchronize()
            out[arch] = (time.perf_counter() - t0) / reps * 1e3

    for label, streams in (
            ("own streams", {a: stages[a].stream for a in STAGES}),
            ("one stream", {a: torch.cuda.default_stream() for a in STAGES})):
        alone, both = {}, {}
        for arch in STAGES:
            run(arch, streams[arch], alone)
        threads = [threading.Thread(target=run, args=(a, streams[a], both))
                   for a in STAGES]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wall = (time.perf_counter() - t0) * 1e3
        log(f"  replays of a batch of {SERVE_BATCH}, {label}: alone "
            + ", ".join(f"{a} {alone[a]:.3f} ms" for a in STAGES)
            + "; both stages at once from two threads "
            + ", ".join(f"{a} {both[a]:.3f} ms" for a in STAGES)
            + f" a replay, {wall:.1f} ms for {reps} of each")


# ------------------------------------------------------------ phases 6, 7

def decode_and_check(model, params, steps: int, b: int = DECODE_BATCH,
                     prompt_len: int = PROMPT, smax: int = SMAX,
                     extra=None) -> tuple:
    """Greedy decode at full width: prefill ``b`` prompts of
    ``prompt_len`` tokens (default DECODE_BATCH x PROMPT) into ``smax``
    slots (a cold call, then the best of 3 warm ones), then ``steps``
    decode steps, with the counters zeroed just before and read just
    after each warm prefill and the steps, and held to the launches the
    config implies. ``extra`` holds the stub features an
    encoder-decoder or image config takes (``frames``,
    ``image_feats``); an image prefix's positions come before the
    prompt's, so step i is at position prefix + prompt_len + i. Every
    step's logits are held against the port's forward over the same
    prompt_len + ``steps`` tokens and features, and every greedy token
    against the forward's argmax (a position whose top-2 gap is below
    the max abs error may differ; the log says so). Traces one prefill
    and one more step. Returns (one prefill's launches, the steps'
    launches, the step's ms)."""
    cfg = model.cfg
    extra = extra or {}
    npfx = extra["image_feats"].shape[1] if "image_feats" in extra else 0
    prompt = torch.from_numpy(np.random.default_rng(7).integers(
        0, cfg.vocab_size, (b, prompt_len))).to("cuda")

    def prefill():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = model.prefill(params, {"tokens": prompt, **extra}, smax)
        torch.cuda.synchronize()
        return time.perf_counter() - t0, out

    with torch.inference_mode():
        cold_s, _ = prefill()
        warm_s = []
        want_pre = launches_per_forward(cfg, npfx + prompt_len)
        for _ in range(3):
            reset_counts()
            t, (logits, state) = prefill()
            pre = counts()
            if pre != want_pre:
                raise RuntimeError(f"prefill launches {pre} != {want_pre}")
            warm_s.append(t)
        outs, toks = [logits], [logits.argmax(-1)]
        reset_counts()
        t0 = time.perf_counter()
        for i in range(steps):
            logits, state = model.decode_step(params, toks[-1],
                                              npfx + prompt_len + i, state)
            outs.append(logits)
            toks.append(logits.argmax(-1))
        torch.cuda.synchronize()
        decode_s = time.perf_counter() - t0
        step_counts = counts()
        want = {k: v * steps for k, v in launches_per_step(cfg).items()}
        if step_counts != want:
            raise RuntimeError(f"decode launches {step_counts} != {want}")

        seq = torch.cat([prompt] + toks[:steps], dim=1)
        full, _ = model.forward(params, {"tokens": seq, **extra,
                                         "enable_mtp": False})
        err, refs = 0.0, []
        for i, out in enumerate(outs):      # text position prompt_len-1+i
            ref_logits = full[:, prompt_len - 1 + i]
            refs.append(ref_logits)
            got = out[:, 0]
            if not bool(torch.isfinite(got).all()) or \
                    got.shape != (b, cfg.vocab_size):
                raise RuntimeError(f"decode step {i}: bad logits "
                                   f"{tuple(got.shape)}")
            err = max(err, float((got - ref_logits).abs().max()))
            torch.testing.assert_close(
                got, ref_logits, atol=5e-4, rtol=1e-3,
                msg=lambda m: f"decode step {i} vs forward: {m}")
        agree, near_ties = 0, []
        for i, ref_logits in enumerate(refs):
            same = toks[i][:, 0] == ref_logits.argmax(-1)
            agree += int(same.sum())
            top2 = ref_logits.topk(2, dim=-1).values
            gap = top2[:, 0] - top2[:, 1]
            for row in torch.nonzero(~same).flatten().tolist():
                if float(gap[row]) >= err:
                    raise RuntimeError(
                        f"step {i} row {row}: greedy token differs from the "
                        f"forward's argmax with a top-2 gap of "
                        f"{float(gap[row]):.3e} >= max abs error {err:.3e}")
                near_ties.append((i, row, float(gap[row])))
        del full, refs

        step_ms = decode_s / steps * 1e3
        feats = "".join(f" + {k} {tuple(v.shape)}" for k, v in extra.items())
        log(f"  prefill B={b} x {prompt_len} tokens{feats} into {smax} "
            f"slots: {min(warm_s) * 1e3:.3f} ms (best of 3 warm calls; "
            f"the first, cold call {cold_s * 1e3:.3f} ms); launches {pre}")
        log(f"  {steps} greedy decode steps: {step_ms:.3f} ms per step, "
            f"{b * steps / decode_s:.1f} tokens/s; launches "
            f"{step_counts} (expected {want})")
        log(f"  logits of prefill and every step vs forward over "
            f"{seq.shape[1]} tokens{feats}: max_abs_err={err:.3e} (atol "
            f"5e-4, rtol 1e-3); greedy tokens equal to the forward's "
            f"argmax: {agree} of {b * len(outs)}")
        for i, row, gap in near_ties:
            log(f"  step {i} row {row}: greedy token differs from the "
                f"forward's argmax at a top-2 gap of {gap:.3e}, below the "
                f"max abs error")

        report_trace(f"one prefill of B={b} x {prompt_len}{feats}",
                     cuda_events(lambda: model.prefill(
                         params, {"tokens": prompt, **extra}, smax)),
                     min(warm_s) * 1e3)
        # the step after the last, at valid_len npfx + prompt_len + steps
        # + 1 (run twice at that position: the second writes the same
        # slot; a recurrent state takes the step twice)
        tok, pos = toks[-1], npfx + prompt_len + steps
        report_trace(
            f"one decode step at valid_len {pos + 1}",
            cuda_events(lambda: model.decode_step(params, tok, pos, state)),
            step_ms)
    return pre, step_counts, step_ms


def hybrid_full_width() -> tuple:
    """The expert-free one-period Jamba at published widths, seeded random
    weights: greedy decode as in phase 6 with HYBRID_STEPS steps, the
    stage latency at SEQ tokens by batch size, and the peak memory.
    Returns (one prefill's launches, the steps' launches)."""
    torch.cuda.reset_peak_memory_stats()
    cfg = without_experts(get_arch(HYBRID))
    t0 = time.perf_counter()
    model = build_model(cfg, "cuda")
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    kinds = "".join("A" if b.kind == "attn" else "M"
                    for b in cfg.segments[0].blocks)
    log(f"  {cfg.name}: {cfg.num_layers}L ({kinds}) d_model={cfg.d_model} "
        f"{cfg.num_heads}/{cfg.num_kv_heads} heads of "
        f"{cfg.resolved_head_dim} d_ff={cfg.d_ff} vocab={cfg.vocab_size} "
        f"params={n_params} ({n_params * 4 / 1e9:.1f} GB f32) built in "
        f"{time.perf_counter() - t0:.1f} s")
    pre, steps, _ = decode_and_check(model, params, HYBRID_STEPS)

    @torch.inference_mode()
    def forward(b: int) -> None:
        model.forward(params, {"tokens": torch.ones(
            (b, SEQ), dtype=torch.int32, device="cuda")})
        torch.cuda.synchronize()

    for b in HYBRID_BATCHES:
        forward(b)                                  # warm each shape
    prof = profile_model_measured(cfg.name, forward, "h100-1",
                                  batch_sizes=HYBRID_BATCHES)
    log("  stage latency (forward over 32 tokens, best of 3): " + ", ".join(
        f"B={b} {prof.batch_latency('h100-1', b) * 1e3:.3f} ms "
        f"({b / prof.batch_latency('h100-1', b):.1f} qps)"
        for b in HYBRID_BATCHES))
    log(f"  peak device memory {torch.cuda.max_memory_allocated() / 1e9:.2f}"
        f" GB (torch.cuda.max_memory_allocated)")
    return pre, steps


# ---------------------------------------------------------------- phase 8

def drop_free(cfg):
    """``cfg`` with room for every routed assignment, for a decode check:
    the forward's tokens in DROP_FREE_GROUPS groups, each expert's
    capacity its group's token count (capacity_factor E / k); a decode
    step's group of DECODE_BATCH tokens is drop-free at any factor (the
    floor at 64 tokens). Widths, experts and top-k are the config's."""
    if not cfg.num_experts:
        return cfg
    return dataclasses.replace(
        cfg, capacity_factor=cfg.num_experts / cfg.num_experts_per_tok,
        moe_groups=DROP_FREE_GROUPS)


def model_line(cfg, params, built_s: float) -> int:
    """Log a full-width model's shape, parameters and GB; returns the
    parameter count."""
    n = sum(t.numel() for t in _leaves(params))
    gb = sum(t.numel() * t.element_size() for t in _leaves(params)) / 1e9
    heads = (f"MLA {cfg.num_heads} heads, D {cfg.qk_head_dim} Dv "
             f"{cfg.v_head_dim}" if cfg.use_mla else
             f"{cfg.num_heads}/{cfg.num_kv_heads} heads of "
             f"{cfg.resolved_head_dim}")
    moe = (f", {cfg.num_experts} experts top-{cfg.num_experts_per_tok} of "
           f"{cfg.moe_d_ff}" + (f" + {cfg.num_shared_experts} shared"
                                if cfg.num_shared_experts else "")
           if cfg.num_experts else "")
    log(f"  {cfg.name}: {cfg.num_layers}L d_model={cfg.d_model} {heads} "
        f"d_ff={cfg.d_ff}{moe} vocab={cfg.vocab_size}"
        f"{' mtp=' + str(cfg.mtp_depth) if cfg.mtp_depth else ''}: "
        f"params={n} ({gb:.2f} GB {str(cfg.pdtype)[6:]}) built in "
        f"{built_s:.1f} s")
    return n


def peak_line(label: str) -> None:
    log(f"  {label}: peak device memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB "
        f"(torch.cuda.max_memory_allocated)")


def decode_check(model, params) -> dict:
    """decode_and_check on ``model``'s config made drop-free (the same
    parameters); returns the launches of one warm prefill plus the
    steps'."""
    checked = model if not model.cfg.num_experts else \
        build_model(drop_free(model.cfg), "cuda")
    if checked is not model:
        log(f"  decode check with capacity_factor "
            f"{checked.cfg.capacity_factor:g} in {DROP_FREE_GROUPS} groups "
            f"(drop-free; the model's own is "
            f"{model.cfg.capacity_factor:g})")
    pre, steps, _ = decode_and_check(checked, params, FAMILY_STEPS)
    return {k: pre[k] + steps[k] for k in pre}


def add_counts(total: dict, more: dict) -> None:
    for k, n in more.items():
        total[k] += n


def family_stages() -> dict:
    """Phase 8 (a): granite-moe and phi3-mini whole, as served stages:
    graphs, replays against eager, the profile, a plan for each alone
    served beside the Estimator, and the decode check. Returns the
    launches of the serves, the prefills and the steps."""
    total = dict.fromkeys(COUNTERS, 0)
    for arch in FAMILY_STAGES:
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        st = make_stage(arch, "cuda", full=True, seed=0)
        torch.cuda.synchronize()
        model_line(st.cfg, st.params, time.perf_counter() - t0)
        t1 = time.perf_counter()
        st.warmup(max(PROFILE_BATCHES))
        log(f"  {len(st.graphs)} CUDA graphs {sorted(st.graphs)} captured "
            f"in {time.perf_counter() - t1:.1f} s, one replay launching "
            f"{ {c_name(c): k for c, k in st.graphs[SERVE_BATCH].launches} }")
        check_replays(arch, st)
        store = ProfileStore()
        store.add(profile_model_measured(arch, st.profile_fn, "h100-1",
                                         batch_sizes=PROFILE_BATCHES))
        log("  profile on h100-1: " + ", ".join(
            f"b={b} {store.get(arch).batch_latency('h100-1', b) * 1e3:.3f} "
            f"ms" for b in PROFILE_BATCHES))
        stages = {arch: st}
        served, _ = plan_and_serve(stages, store, (arch,))
        add_counts(total, served)
        add_counts(total, decode_check(st.model, st.params))
        peak_line(arch)
        del st, stages, store
        gc.collect()
        torch.cuda.empty_cache()
    return total


def deepseek_cut(dense: int, moe: int):
    """deepseek-v3-671b with ``dense`` dense layers and ``moe`` MoE
    layers, widths, experts and MTP as published."""
    full = get_arch(DEEPSEEK)
    d, m = full.segments
    return dataclasses.replace(
        full, name=f"{full.name}-{dense}+{moe}L",
        segments=(dataclasses.replace(d, repeat=dense),
                  dataclasses.replace(m, repeat=moe)))


def deepseek_two_layers() -> dict:
    """Phase 8 (b): deepseek-v3-671b cut to its first dense layer and one
    MoE layer, widths, experts and MTP unchanged. The forward with its
    aux (routers + MTP) at batch 8 x PROMPT, the positions whose logits
    capacity 1.25 changed against the drop-free forward, then the decode
    check (prefill through the flash kernel at D 192 / Dv 128, the
    absorbed decode). Returns its launches."""
    full = get_arch(DEEPSEEK)
    cfg = deepseek_cut(1, 1)
    log(f"  reduced: {full.num_layers} layers -> 2 (one dense, one MoE); "
        f"widths, 256 experts, top-8, shared expert and MTP as published")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = build_model(cfg, "cuda")
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    model_line(cfg, params, time.perf_counter() - t0)
    tokens = torch.from_numpy(np.random.default_rng(11).integers(
        0, cfg.vocab_size, (DECODE_BATCH, PROMPT))).to("cuda")
    total = dict.fromkeys(COUNTERS, 0)
    with torch.inference_mode():
        reset_counts()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        logits, aux = model.forward(params, {"tokens": tokens})
        torch.cuda.synchronize()
        fwd_s = time.perf_counter() - t1
        got = counts()
        want = launches_per_forward(cfg, PROMPT, mtp=True)
        if got != want:
            raise RuntimeError(f"forward launches {got} != {want}")
        add_counts(total, got)
        _, router_aux = model.forward(params, {"tokens": tokens,
                                               "enable_mtp": False})
        if logits.shape != (DECODE_BATCH, PROMPT, cfg.vocab_size) or \
                not bool(torch.isfinite(logits).all()):
            raise RuntimeError(f"{cfg.name}: bad logits "
                               f"{tuple(logits.shape)}")
        aux, router_aux = float(aux), float(router_aux)
        if not (np.isfinite(aux) and aux > router_aux > 0):
            raise RuntimeError(f"{cfg.name}: aux {aux} (routers "
                               f"{router_aux}) is not finite and positive "
                               f"with an MTP loss on top")
        free, _ = build_model(drop_free(cfg), "cuda").forward(
            params, {"tokens": tokens, "enable_mtp": False})
        moved = int(((logits - free).abs().amax(-1) > 1e-3).sum())
        log(f"  forward B={DECODE_BATCH} x {PROMPT} with MTP: "
            f"{fwd_s * 1e3:.1f} ms, launches {got}; logits finite; aux "
            f"{aux:.6f} = routers {router_aux:.6f} + MTP "
            f"{aux - router_aux:.6f}; capacity "
            f"{cfg.capacity_factor:g} changed {moved} of "
            f"{DECODE_BATCH * PROMPT} positions' logits (> 1e-3) against "
            f"the drop-free forward")
        del logits, free
    add_counts(total, decode_check(model, params))
    peak_line(cfg.name)
    del model, params
    gc.collect()
    torch.cuda.empty_cache()
    return total


def depth_cuts() -> dict:
    """Phase 8 (c): granite-34b and qwen2-72b cut in depth, widths
    unchanged: the decode check. Returns their launches."""
    total = dict.fromkeys(COUNTERS, 0)
    for arch, layers in DEPTH_CUTS:
        full = get_arch(arch)
        cfg = dataclasses.replace(full, name=f"{full.name}-{layers}L",
                                  segments=dense_segments(layers))
        log(f"  reduced: {arch} {full.num_layers} layers -> {layers}; "
            f"widths as published")
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        model = build_model(cfg, "cuda")
        params = model.init(torch.Generator(device="cuda").manual_seed(0))
        torch.cuda.synchronize()
        model_line(cfg, params, time.perf_counter() - t0)
        add_counts(total, decode_check(model, params))
        peak_line(cfg.name)
        del model, params
        gc.collect()
        torch.cuda.empty_cache()
    return total


# ---------------------------------------------------------------- phase 9
def fill_queue(regime: str, k: int, seed: int = 7) -> np.ndarray:
    """The three load regimes of the reference's fill benchmark
    (``bench_planner_scale._bench_fill_kernel``: underloaded with tie
    runs, calm/burst mixed, one saturating burst), at ``k`` queries."""
    rng = np.random.default_rng(seed)
    if regime == "underloaded":
        gaps = rng.exponential(1 / 140.0, k)
        gaps[rng.random(k) < 0.2] = 0.0
        return np.cumsum(gaps)
    if regime == "mixed":
        return np.cumsum(np.where(rng.random(k) < 0.5,
                                  rng.exponential(1 / 600.0, k),
                                  rng.exponential(1 / 60.0, k)))
    return np.zeros(k)


def fill_lut(max_batch: int) -> np.ndarray:
    """The benchmark's LUT, 4 ms + 0.5 ms a query, to ``max_batch``."""
    return np.array([0.0] + [0.004 + 0.0005 * b
                             for b in range(1, max_batch + 1)])


# the fill's four layouts: eff 1 / 8 / 128 x replicas 1 / 3 / 16 / 512,
# without and with a timeout (a pool of 512 puts every lane's pool in
# shared memory, an eff of 128 has each step load its window of the
# queue), the same with at most 32 replicas (pools in registers), and
# both with effs of at most 32 (the queue in register windows)
FILL_LANES = [(e, r, t) for e in (1, 8, 128) for r in (1, 3, 16, 512)
              for t in (0.0, 0.005)]
REG_LANES = [(e, r, t) for e in (1, 8, 128) for r in (1, 3, 16, 32)
             for t in (0.0, 0.005)]
WIN_LANES = [(e, r, t) for e in (1, 2, 8, 32) for r in (1, 3, 16, 32)
             for t in (0.0, 0.005)]
WIN_SHARED_LANES = [(e, r, t) for e in (1, 2, 8, 32) for r in (1, 33, 512)
                    for t in (0.0, 0.005)]
SELECT_P = (0.0, 50.0, 99.0, 100.0)
RPC_S = 0.0015                  # phase 9a's rpc delay


def lanes_on_card(ready: np.ndarray, lanes) -> list:
    """(ready_pad, luts, eff, timeouts, pools) on the card for lanes of
    (eff, replicas, timeout)."""
    effs = [e for e, _, _ in lanes]
    arrays = torch_backend.lane_inputs(
        [fill_lut(e) for e in effs], effs, [r for _, r, _ in lanes],
        [t for _, _, t in lanes])
    pad = np.concatenate([ready, np.full(max(effs), np.inf)])
    return [torch.from_numpy(a).cuda() for a in (pad, *arrays)]


def hold_static(label: str, ready: np.ndarray, lanes) -> None:
    """One launch of the grid kernel over ``lanes`` of (eff, replicas,
    timeout) on one queue, held bit for bit against the plain version on
    the card and, lane by lane, against the numpy fill; then its latency
    rows against the plain assembly."""
    pad, luts, eff, tmo, pools = lanes_on_card(ready, lanes)
    k = ready.size
    done, batches, nb = sim_fill.fill_static(pad, k, luts, eff, tmo,
                                             pools.clone(), True)
    p_done, p_batches, p_nb = sim_fill.fill_static_ref(
        pad, k, luts, eff, tmo, pools.clone(), True)
    torch.cuda.synchronize()
    # a row of batch sizes holds its lane's n_batches; the rest is unset
    if not (torch.equal(done, p_done) and torch.equal(nb, p_nb) and all(
            torch.equal(batches[i, :n], p_batches[i, :n])
            for i, n in enumerate(nb.tolist()))):
        raise RuntimeError(f"sim_fill differs from its plain version: "
                           f"{label}")
    done_h, batches_h, nb_h = (t.cpu().numpy() for t in (done, batches, nb))
    for i, (e, r, t) in enumerate(lanes):
        want_done, want_batches, _ = simulate_stage(
            "fifo", ready, fill_lut(e), e, r, None, t)
        if not (np.array_equal(done_h[i], want_done) and np.array_equal(
                batches_h[i, :nb_h[i]], want_batches)):
            raise RuntimeError(f"sim_fill differs from the numpy fill: "
                               f"{label}, eff {e}, {r} replicas, timeout {t}")
    # finite arrivals, as the engine's are (a queue's +inf is a
    # completion upstream that never comes), and base_last after them
    rng = np.random.default_rng(k)
    arrivals = np.maximum(np.where(np.isfinite(ready), ready, 0.0)
                          - rng.gamma(2.0, 0.004, k), 0.0)
    base_last = arrivals + rng.gamma(2.0, 0.01, k)
    bl, arr = (torch.from_numpy(a).cuda() for a in (base_last, arrivals))
    lat = sim_fill.fill_latency(pad, k, luts, eff, tmo, pools.clone(), bl,
                                arr, RPC_S)
    want = sim_fill.fill_latency_ref(pad, k, luts, eff, tmo, pools.clone(),
                                     bl, arr, RPC_S)
    if not torch.equal(lat, want):
        raise RuntimeError(f"sim_fill's latency rows differ from the plain "
                           f"assembly: {label}")
    where = "registers" if pools.shape[1] <= 32 else "shared memory"
    queue = "register windows" if luts.shape[1] <= 33 else "loads a step"
    log(f"  {label}: {len(lanes)} lanes, k={k}, pools in {where}, queue "
        f"in {queue}, one "
        f"launch: bit-equal to the plain version and the numpy fill "
        f"(batches a lane {int(nb_h.min())}-{int(nb_h.max())}); latency "
        f"rows bit-equal to the plain assembly")


def select_rows() -> dict:
    """Phase 9a's rows for the select: name -> (row, shared segment)."""
    rng = np.random.default_rng(11)
    lat = rng.gamma(2.0, 0.05, 5000)
    empty = np.empty(0)
    return {
        "ties": (np.repeat(rng.uniform(0.01, 0.2, 40), 125), empty),
        "+inf tail": (np.concatenate([lat, np.full(60, np.inf)]), empty),
        "FAR_FUTURE tail": (np.concatenate([lat, np.full(90, 1e18)]), empty),
        "n = 1": (np.array([0.75]), empty),
        "k < n": (lat[:3000], lat[3000:] + 0.5),
        "all equal": (np.full(4000, 0.125), empty),
    }


def select_cases() -> dict:
    """Phase 9a's rows for the select's two paths: name -> (rows,
    shared segment). The cluster's capacity -1, at it and +1 (the stream
    path), odd k with a segment (every second row starts 8-byte
    aligned), one lane, NaN."""
    rng = np.random.default_rng(33)
    empty = np.empty(0)
    cases = {}
    for offset in (-1, 0, 1):
        m = 5001
        rows = rng.gamma(2.0, 0.05, (3, sim_select.CLUSTER_CAP + offset - m))
        rows[1, -3000:] = 1e18
        rows[2] = np.round(rows[2], 3)
        cases[f"capacity {offset:+d}"] = (rows, rng.gamma(2.0, 0.05, m) + 0.2)
    cases["odd k"] = (rng.gamma(2.0, 0.05, (7, 107487)),
                      rng.gamma(2.0, 0.05, 11))
    cases["lanes 1"] = (rng.gamma(2.0, 0.05, (1, 20001)), empty)
    rows = rng.gamma(2.0, 0.05, (4, 3001))
    rows[0, ::97] = np.nan
    rows[1, -40:] = np.nan
    rows[3, :] = np.nan
    cases["NaN"] = (rows, empty)
    return cases


def check_selects() -> None:
    """Phase 9a: the select kernel against its plain version on the card
    and np.partition (NaN last), with ``==``, at every p of SELECT_P:
    three orders of each of select_rows(), and select_cases(). Each call
    is one launch down the path that k + m picks, and a second call is
    bit-equal."""
    cases = {name: (np.stack([row, row[::-1].copy(), np.sort(row)]), seg)
             for name, (row, seg) in select_rows().items()}
    cases.update(select_cases())
    for name, (rows, seg) in cases.items():
        rows_d, seg_d = (torch.from_numpy(a).cuda() for a in (rows, seg))
        lanes, n = rows.shape[0], rows.shape[1] + seg.size
        path = sim_select.path(n)
        plan = sim_select.plan(rows.shape[1], seg.size, lanes)
        if plan["path"] != path:
            raise RuntimeError(f"sim_select: the wrapper's path {path} is "
                               f"not the kernel's {plan}")
        for p in SELECT_P:
            prev, nxt, _ = torch_backend._quantile_params(n, p)
            before = (sim_select.counter.count,
                      sim_select.path_counters[path].count)
            got = sim_select.select(rows_d, seg_d, prev, nxt)
            again = sim_select.select(rows_d, seg_d, prev, nxt)
            if (sim_select.counter.count - before[0],
                    sim_select.path_counters[path].count - before[1]) != \
                    (2, 2):
                raise RuntimeError(f"sim_select: not one {path} launch a "
                                   f"call: {name}")
            plain = sim_select.select_ref(rows_d, seg_d, prev, nxt)
            part = np.partition(np.concatenate(
                [rows, np.broadcast_to(seg, (lanes, seg.size))], 1),
                (prev, nxt) if nxt > prev else (prev,), axis=1)
            if not (torch.equal(got.view(torch.int64),
                                again.view(torch.int64))
                    and torch.equal(got.isnan(), plain.isnan())
                    and torch.equal(got.nan_to_num(), plain.nan_to_num())
                    and np.array_equal(got.cpu().numpy(),
                                       part[:, [prev, nxt]],
                                       equal_nan=True)):
                raise RuntimeError(f"sim_select differs: {name}, p {p}")
        log(f"  select, {name}: {lanes} x k={rows.shape[1]}, segment "
            f"{seg.size}, {path} path ({plan['cluster']} CTA(s) a "
            f"candidate, {plan['smem']} B of dynamic shared memory each), "
            f"p {', '.join(f'{p:g}' for p in SELECT_P)}: equal (==) to "
            f"the plain version and np.partition, two calls bit-equal")


def check_fills() -> None:
    """Phase 9a: the fill against its plain version and the numpy fill,
    static and dynamic, at the edges of what the planner gives it; its
    latency rows; the select."""
    for regime in ("underloaded", "mixed", "saturated"):
        for lanes in (FILL_LANES, REG_LANES, WIN_LANES, WIN_SHARED_LANES):
            hold_static(f"static, {regime}", fill_queue(regime, FILL_K),
                        lanes)
    # each edge in the four layouts: the pool of 512 in shared memory or
    # none, an eff of 128 or 32
    edge = [(1, 1, 0.0), (8, 3, 0.01), (128, 2, 0.0), (8, 512, 0.005)]
    edge_win = [(1, 1, 0.0), (8, 3, 0.01), (32, 2, 0.0), (8, 512, 0.005)]
    for lanes in (edge, edge[:3], edge_win, edge_win[:3]):
        hold_static("static, ties", np.sort(np.concatenate(
            [np.cumsum(np.full(300, 0.002)), np.full(100, 0.3)])), lanes)
        hold_static("static, +inf arrivals", np.concatenate(
            [np.cumsum(np.full(200, 0.003)), np.full(20, np.inf)]), lanes)
        hold_static("static, k = 1", np.array([0.25]), lanes)
    ready = fill_queue("mixed", FILL_K, seed=3)
    old = torch_backend._FILL_THRESHOLD
    torch_backend._FILL_THRESHOLD = 0
    try:
        for reps, events, e, t in (
                (1, [(2.0, 2), (6.0, -1), (9.0, 1)], 8, 0.0),
                (0, [(1.0, 3)], 128, 0.005),
                (2, [(3.0, -2)], 8, 0.0),
                (4, [(0.5, -3), (0.5, 2), (12.0, -2)], 128, 0.0)):
            got = simulate_stage("fifo", ready, fill_lut(e), e, reps, events,
                                 t, backend="torch", device="cuda")
            want = simulate_stage("fifo", ready, fill_lut(e), e, reps,
                                  events, t)
            args = torch_backend.dynamic_inputs(
                ready, fill_lut(e), e, reps, events, t, torch.device("cuda"))
            copy = [x.clone() if torch.is_tensor(x) else x for x in args]
            k_done, _, k_n = sim_fill.fill_dynamic(*args)
            p_done, _, p_n = sim_fill.fill_dynamic_ref(*copy)
            if not (all(np.array_equal(a, b) for a, b in zip(got, want))
                    and torch.equal(k_done, p_done)
                    and torch.equal(k_n, p_n)):
                raise RuntimeError(f"the dynamic fill differs: {reps} "
                                   f"replicas, events {events}")
            log(f"  dynamic, {reps} replicas, events {events}, eff {e}, "
                f"timeout {t}: bit-equal to the plain version and the numpy "
                f"fill ({int(k_n[0])} batches)")
    finally:
        torch_backend._FILL_THRESHOLD = old
    check_selects()


def sweep_grid() -> tuple:
    """The reference's ``_bench_device_grid``: 3 hw x 5 batches x 16
    replicas x 5 timeouts on the sink of image-processing, over an hour
    of bursty traffic."""
    bound = get_motif(SWEEP_MOTIF)
    pipe = bound.pipeline
    arr = gamma_trace(SWEEP_TRACE["lam"], SWEEP_TRACE["cv"],
                      SWEEP_TRACE["duration_s"], seed=SWEEP_TRACE["seed"])
    stage = pipe.toposort()[-1]
    base = PipelineConfig({
        s: StageConfig(pipe.stages[s].hardware_options[0], 4, 4)
        for s in pipe.stages})
    grid = []
    for hw in SWEEP_HW:
        for batch in SWEEP_BATCHES:
            for replicas in SWEEP_REPLICAS:
                for tmo in SWEEP_TIMEOUTS:
                    cand = base.copy()
                    cand.stage_configs[stage] = StageConfig(
                        hw, batch, replicas, timeout_s=tmo)
                    grid.append(cand)
    return bound, arr, stage, grid


class SweepParts:
    """Times a torch sweep's parts from outside the sim package, which
    reads no clock: the host clock around the uploads
    (``torch_backend._to``), the copy back (``_to_host``, after a
    synchronize, so that it waits for no kernel) and the lerp
    (``_host_lerp``); CUDA events around each kernel's launch. It counts
    the bytes copied back and the calls of np.partition, and keeps each
    kernel's last inputs (the fill's pools a copy taken before the
    launch)."""

    def __init__(self) -> None:
        self.host = dict.fromkeys(("inputs", "copy", "lerp"), 0.0)
        self.events = {"sim_fill": [], "sim_select": []}
        self.copied_bytes = 0
        self.partitions = 0
        self.inputs = {}

    def _timed(self, part, fn):
        def wrapped(*args, **kw):
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            self.host[part] += time.perf_counter() - t0
            return out
        return wrapped

    def _evented(self, name, fn, keep):
        def wrapped(*args):
            self.inputs[name] = keep(args)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args)
            end.record()
            self.events[name].append((start, end))
            return out
        return wrapped

    def __enter__(self):
        tb = torch_backend
        self._saved = (tb._to, tb._to_host, tb._host_lerp,
                       sim_fill.fill_latency, sim_select.select, np.partition)
        to_host = tb._to_host

        def copy_back(t):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = to_host(t)
            self.host["copy"] += time.perf_counter() - t0
            self.copied_bytes += out.nbytes
            return out

        partition = np.partition

        def counted(*args, **kw):
            self.partitions += 1
            return partition(*args, **kw)

        tb._to = self._timed("inputs", tb._to)
        tb._to_host = copy_back
        tb._host_lerp = self._timed("lerp", tb._host_lerp)
        sim_fill.fill_latency = self._evented(
            "sim_fill", sim_fill.fill_latency,
            lambda a: a[:5] + (a[5].clone(),) + a[6:])
        sim_select.select = self._evented("sim_select", sim_select.select,
                                          lambda a: a)
        np.partition = counted
        return self

    def __exit__(self, *exc) -> None:
        tb = torch_backend
        (tb._to, tb._to_host, tb._host_lerp, sim_fill.fill_latency,
         sim_select.select, np.partition) = self._saved

    def kernel_ms(self, name: str) -> float:
        torch.cuda.synchronize()
        return sum(s.elapsed_time(e) for s, e in self.events[name])


def device_sweep() -> dict:
    """Phase 9b: the 1200-candidate sweep with ``"numpy"`` and with
    ``"torch"`` (cold, then warm), equal with ``==``; the warm run's
    split. Returns the warm run's kernel inputs, by kernel name."""
    bound, arr, stage, grid = sweep_grid()
    log(f"  {SWEEP_MOTIF}, sink {stage!r}: {arr.size} queries (the "
        f"reference's trace: {SWEEP_QUERIES_REF}), {len(grid)} candidates")
    engine = SimEngine(bound.pipeline, bound.profiles)
    t0 = time.perf_counter()
    host = engine.session(arr).percentile_many(grid, 99.0)
    t_np = time.perf_counter() - t0
    sess = engine.session(arr, backend="torch")
    t0 = time.perf_counter()
    dev = sess.percentile_many(grid, 99.0)
    t_cold = time.perf_counter() - t0
    cold = dict(sess.grid_split)
    sess = engine.session(arr, backend="torch")
    with SweepParts() as parts:
        t0 = time.perf_counter()
        dev2 = sess.percentile_many(grid, 99.0)
        t_warm = time.perf_counter() - t0
    warm = dict(sess.grid_split)
    if not (host == dev and host == dev2):
        raise RuntimeError("the device sweep differs from numpy's")
    log(f"  p99 of {len(grid)} candidates equal (==) between numpy and "
        f"torch, cold and warm; numpy {t_np:.2f} s, torch cold "
        f"{t_cold:.3f} s, warm {t_warm:.3f} s ({t_np / t_warm:.1f}x); the "
        f"reference's 1-core CPU artifact: numpy 67.3 s, jax warm 13.2 s")
    chunks = warm["chunks"]
    fills, selects = (len(parts.events[n]) for n in ("sim_fill",
                                                      "sim_select"))
    if not (warm["launches"] == 2 * chunks and fills == chunks
            and selects == chunks and cold["launches"] == 2 * cold["chunks"]):
        raise RuntimeError(f"the sweep made {fills} fills and {selects} "
                           f"selects in {chunks} chunks ({warm})")
    if parts.copied_bytes != 16 * len(grid) or parts.partitions:
        raise RuntimeError(f"the warm sweep copied {parts.copied_bytes} "
                           f"bytes back and ran np.partition "
                           f"{parts.partitions} times")
    fill_ms, select_ms = (parts.kernel_ms(n) for n in ("sim_fill",
                                                        "sim_select"))
    host_ms = {k: v * 1e3 for k, v in parts.host.items()}
    rest = t_warm * 1e3 - fill_ms - select_ms - sum(host_ms.values())
    log(f"  cold: {cold['chunks']} chunk(s), {cold['launches']} launches "
        f"of {cold['lanes']} lanes x {cold['queries']} queries")
    log(f"  warm: {chunks} chunk(s), {warm['launches']} launches ({fills} "
        f"fill, {selects} select); inputs to the card "
        f"{host_ms['inputs']:.3f} ms, fill {fill_ms:.3f} ms, select "
        f"{select_ms:.3f} ms, copy back {host_ms['copy']:.3f} ms "
        f"({parts.copied_bytes} bytes), host lerp {host_ms['lerp']:.3f} "
        f"ms, the rest of percentile_many {rest:.3f} ms (the fixed "
        f"stages' simulation and Python); np.partition calls "
        f"{parts.partitions}")
    return parts.inputs


def plan_identity() -> None:
    """Phase 9c: the reference's ``_bench_plan_identity``: Planner and
    BeamPlanner(beam_width=4) on every motif, numpy against torch, the
    same configuration at the same cost; torch twice, with the grid's
    thresholds as they are and with every grid of two or more
    candidates sent to the card, so that the plans go through the
    kernels."""
    sample = gamma_trace(PLAN_TRACE["lam"], PLAN_TRACE["cv"],
                         PLAN_TRACE["duration_s"], seed=PLAN_TRACE["seed"])
    log(f"  sample trace: {sample.size} queries")
    thresholds = (torch_backend._GRID_MIN_CANDIDATES,
                  torch_backend._GRID_MIN_QUERIES)
    runs = (("numpy", "numpy", thresholds), ("torch", "torch", thresholds),
            ("every grid on the card", "torch", (2, 0)))
    for motif in MOTIFS:
        bound = get_motif(motif)
        slo = 0.25 if motif != "video-monitoring" else 0.3
        for label in ("greedy", "beam"):
            res = []
            for _, be, (min_c, min_q) in runs:
                kw = {"beam_width": 4} if label == "beam" else {}
                cls = BeamPlanner if label == "beam" else Planner
                torch_backend._GRID_MIN_CANDIDATES = min_c
                torch_backend._GRID_MIN_QUERIES = min_q
                before = sim_fill.counter.count + sim_select.counter.count
                try:
                    t0 = time.perf_counter()
                    plan = cls(bound.pipeline, bound.profiles, backend=be,
                               **kw).plan(sample, slo)
                    dt = time.perf_counter() - t0
                finally:
                    (torch_backend._GRID_MIN_CANDIDATES,
                     torch_backend._GRID_MIN_QUERIES) = thresholds
                res.append((plan, dt, sim_fill.counter.count
                            + sim_select.counter.count - before))
            a = res[0][0]
            for b, _, _ in res[1:]:
                if not (a.feasible == b.feasible and (
                        not a.feasible
                        or (a.config.cache_key() == b.config.cache_key()
                            and a.cost_per_hr == b.cost_per_hr))):
                    raise RuntimeError(f"plans differ: {motif} {label}")
            log(f"  {motif:16s} {label:6s} slo {slo}: identical, "
                f"${a.cost_per_hr:.2f}/hr; " + ", ".join(
                    f"{name} {dt:.3f} s ({n} launches)"
                    for (name, _, _), (_, dt, n) in zip(runs, res)))


def event_ms(fn) -> float:
    """One call's CUDA-event time."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def fill_record(inputs, launches: int) -> dict:
    """The fill's record at the sweep's shape: its device time (CUDA
    events, one launch at a time, best of 3), its plain version's (one
    call), the two held bit for bit, and the bound."""
    ready, k, luts, eff, tmo, pools, bl, arr, rpc = inputs
    lanes = luts.shape[0]
    lat = sim_fill.fill_latency(ready, k, luts, eff, tmo, pools.clone(), bl,
                                arr, rpc)
    t_ms = [event_ms(lambda: sim_fill.fill_latency(
        ready, k, luts, eff, tmo, pools.clone(), bl, arr, rpc))
        for _ in range(3)]
    plain = []
    plain_ms = event_ms(lambda: plain.append(sim_fill.fill_latency_ref(
        ready, k, luts, eff, tmo, pools.clone(), bl, arr, rpc)))
    if not torch.equal(lat, plain[0]):
        raise RuntimeError("sim_fill differs from its plain version at the "
                           "sweep's shape")
    # bytes: the queue, LUTs, batches, timeouts, pools, base_last and
    # arrivals read once, the latencies written once; operations: per
    # query a comparison and its latency's max, subtract and add, per
    # batch its start, hold test, end and rank search over the lane's
    # replicas (float64). The batches come from one completion launch.
    done = sim_fill.fill_static(ready, k, luts, eff, tmo, pools.clone())[0]
    batches = 1 + (done[:, 1:] != done[:, :-1]).sum(1)
    reps = torch.isfinite(pools).sum(1)
    # what sets the time: the batch-1 lanes (k steps each) alone, and
    # the other lanes alone
    ones = eff == 1
    part_ms = [event_ms(lambda: sim_fill.fill_latency(
        ready, k, luts[m], eff[m], tmo[m], pools[m].clone(), bl, arr, rpc))
        for m in (ones, ~ones)]
    nbytes = 8 * (ready.numel() + luts.numel() + 2 * lanes + pools.numel()
                  + bl.numel() + arr.numel() + lat.numel())
    nops = float(4 * lanes * k + (batches * (3 + reps)).sum())
    bytes_ms = nbytes / H100_HBM_BW * 1e3
    ops_ms = nops / H100_PEAK_FLOPS_F64 * 1e3
    ms = min(t_ms)
    props = torch.cuda.get_device_properties(0)
    threads = props.multi_processor_count * \
        props.max_threads_per_multi_processor
    log(f"  sim_fill at the sweep's shape ({lanes} lanes x {k} queries, "
        f"latency rows): kernel {ms:.3f} ms ({ms * 1e3:.1f} us of device "
        f"time; launches {', '.join(f'{t:.3f}' for t in t_ms)} ms), plain "
        f"version {plain_ms:.1f} ms, bit-equal; bound "
        f"{max(bytes_ms, ops_ms):.6f} ms ({'bytes' if bytes_ms >= ops_ms else 'operations'}: "
        f"{nbytes / 1e9:.3f} GB, {nops:.3e} float64 operations); "
        f"{32 * lanes} threads (a warp a lane) of the card's {threads} "
        f"({32 * lanes / threads:.2%}); the longest lane "
        f"{int(batches.max())} steps; the {int(ones.sum())} lanes of "
        f"batch 1 alone {part_ms[0]:.3f} ms, the other "
        f"{int((~ones).sum())} alone {part_ms[1]:.3f} ms")
    return {
        "name": "sim_fill", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/sim_fill.cu",
        "replaces": "src/repro/sim/jax_backend.py:103",
        "launches": launches, "max_abs_err": 0.0,
        "ms": ms, "plain_ms": plain_ms,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": None,
    }


def select_record(inputs, launches: int) -> dict:
    """The select's record at the sweep's shape: its device time (CUDA
    events, one launch at a time, best of 3), its plain version's (one
    warm call) and ``torch.kthvalue``'s along dim 1, once for each rank
    (best of 3), all three equal, and the bound: the rows read once.
    Logs the launch's path, its cluster and the bytes it reads."""
    rows, seg, r0, r1 = inputs
    lanes, k = rows.shape
    plan = sim_select.plan(k, seg.numel(), lanes)
    got = sim_select.select(rows, seg, r0, r1)
    t_ms = [event_ms(lambda: sim_select.select(rows, seg, r0, r1))
            for _ in range(3)]
    # the plain version's time is its second call's: the first takes the
    # caching allocator's new blocks
    plain = [sim_select.select_ref(rows, seg, r0, r1)]
    plain_ms = event_ms(lambda: plain.append(sim_select.select_ref(
        rows, seg, r0, r1)))
    full = rows if seg.numel() == 0 else \
        torch.cat([rows, seg.expand(lanes, -1)], 1)
    lib = []
    lib_ms = min(event_ms(lambda: lib.append(torch.stack(
        [torch.kthvalue(full, r + 1, dim=1).values for r in (r0, r1)], 1)))
        for _ in range(3))
    if not (torch.equal(got, plain[-1]) and torch.equal(got, lib[0])):
        raise RuntimeError("sim_select differs from its plain version or "
                           "torch.kthvalue at the sweep's shape")
    nbytes = 8 * (rows.numel() + seg.numel() + 2 * lanes)
    bytes_ms = nbytes / H100_HBM_BW * 1e3
    ms = min(t_ms)
    if plan["path"] == "cluster":
        how = (f"cluster path: clusters of {plan['cluster']} CTAs a "
               f"candidate, {plan['smem']} B of dynamic shared memory a "
               f"CTA, {plan['resident']} clusters resident at once "
               f"(cudaOccupancyMaxActiveClusters); the rows read from "
               f"device memory once, {8 * rows.numel() / 1e9:.3f} GB")
    else:
        how = (f"stream path: a CTA a candidate, {plan['resident']} "
               f"resident; the rows read from device memory once a pass")
    log(f"  sim_select at the sweep's shape ({lanes} rows x {k} + "
        f"{seg.numel()} shared, ranks {r0}, {r1}): {how}; kernel "
        f"{ms:.3f} ms ({ms * 1e3:.1f} us of device time; launches "
        f"{', '.join(f'{t:.3f}' for t in t_ms)} ms), "
        f"{nbytes / ms / 1e6:.0f} GB/s of the bound's bytes, "
        f"{bytes_ms / ms:.1%} of the bound; plain version (sort) "
        f"{plain_ms:.3f} ms, torch.kthvalue twice {lib_ms:.3f} ms, all "
        f"equal; bound {bytes_ms:.6f} ms (bytes: {nbytes / 1e9:.3f} GB "
        f"read once)")
    return {
        "name": "sim_select", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/sim_select.cu",
        "replaces": "src/repro/sim/jax_backend.py:566",
        "launches": launches, "max_abs_err": 0.0,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bytes_ms,
        "bound_by": "bytes", "library_ms": lib_ms,
    }


def fill_crossover() -> None:
    """Phase 9d: the reference's ``_bench_fill_crossover``: one fill,
    numpy against the kernel forced on, at growing lengths (best of 3
    host-clock calls each, the kernel's result checked against
    numpy's)."""
    lut = np.array([0.0] + [0.004 + 0.0005 * b for b in range(1, 9)])
    rng = np.random.default_rng(13)
    old = torch_backend._FILL_THRESHOLD
    crossover = None
    for k in CROSSOVER_K:
        ready = np.cumsum(rng.exponential(1 / 140.0, k))
        t_np = t_dev = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            want = simulate_stage("fifo", ready, lut, 8, 4)
            t_np = min(t_np, time.perf_counter() - t0)
        torch_backend._FILL_THRESHOLD = 0
        try:
            got = simulate_stage("fifo", ready, lut, 8, 4, backend="torch")
            for _ in range(3):
                t0 = time.perf_counter()
                simulate_stage("fifo", ready, lut, 8, 4, backend="torch")
                t_dev = min(t_dev, time.perf_counter() - t0)
        finally:
            torch_backend._FILL_THRESHOLD = old
        if not all(np.array_equal(a, b) for a, b in zip(got, want)):
            raise RuntimeError(f"the single fill differs at k={k}")
        if crossover is None and t_dev < t_np:
            crossover = k
        log(f"  k={k:7d}: numpy {t_np * 1e3:.2f} ms, kernel (launch, copies, "
            f"host) {t_dev * 1e3:.2f} ms ({t_dev / t_np:.2f}x numpy)")
    log(f"  crossover: {crossover if crossover else 'none'} (the default "
        f"single-fill threshold stays off: {old})")


def planner_sweep() -> list:
    """Phase 9: the planner's device sweep. Returns the sim_fill and
    sim_select records."""
    log("[9a] the fill and select kernels against their plain versions, "
        "the numpy fill and np.partition")
    check_fills()
    reset_counts()
    sim_fill.counter.reset()
    sim_select.counter.reset()
    for c in sim_select.path_counters.values():
        c.reset()
    log("[9b] the reference's 1200-candidate sweep, numpy and torch")
    inputs = device_sweep()
    log("[9c] plan identity, every motif, Planner and BeamPlanner")
    plan_identity()
    fills, selects = sim_fill.counter.count, sim_select.counter.count
    if fills == 0 or selects != fills or any(counts().values()):
        raise RuntimeError(f"the sweep launched sim_fill {fills} times, "
                           f"sim_select {selects} times and the model "
                           f"kernels {counts()}")
    paths = {p: c.count for p, c in sim_select.path_counters.items()}
    if sum(paths.values()) != selects:
        raise RuntimeError(f"sim_select's launches by path {paths} do not "
                           f"add up to its {selects}")
    log(f"  sim_select's {selects} launches of 9b-9c by path: "
        f"{', '.join(f'{p} {n}' for p, n in paths.items())}")
    records = [fill_record(inputs["sim_fill"], fills),
               select_record(inputs["sim_select"], selects)]
    log("[9d] one fill, numpy against the kernel")
    fill_crossover()
    return records


# --------------------------------------------------------------- phase 10

class RecordingAdamW:
    """AdamW that keeps the gradient tree of its last update (the train
    step calls only ``update``, which reads the gradients and writes
    nothing of them)."""

    def __init__(self, opt: AdamW):
        self.opt, self.grads = opt, None

    def init(self, params):
        return self.opt.init(params)

    def update(self, params, state, grads, sq_norm):
        self.grads = grads
        return self.opt.update(params, state, grads, sq_norm)


TRAIN_COUNTERS = {"rmsnorm": rms_mod.counter,
                  "flash_attention": fa_mod.counter,
                  "flash_attention_bwd": fa_mod.bwd_counter,
                  "mamba_scan": ms_mod.counter,
                  "mamba_scan_bwd": ms_mod.bwd_counter}


def train_counts(reset: bool = False) -> dict:
    if reset:
        for c in TRAIN_COUNTERS.values():
            c.reset()
    return {name: c.count for name, c in TRAIN_COUNTERS.items()}


def launches_per_train_step(cfg, seq: int) -> dict:
    """Launches of one training step over ``seq`` text tokens: the
    forward's (with its MTP module and encoder), then, with remat, each
    layer's norms, flash and scans again when the backward runs the
    layer's checkpoint, encoder and cross-attention included; what runs
    outside the checkpoints runs once (the final norm, an encoder's final
    norm, the MTP module's three norms and flash call); one flash
    backward per flash forward, one scan backward per scan (65 / 32 / 16
    / 0 / 0 for llama3.2-1b; 9 / 2 / 1 / 32 / 16 for phase 13's two Jamba
    blocks at 4096 tokens; whisper-small 122 / 72 / 36)."""
    mtp = bool(cfg.mtp_depth) and seq >= 3
    fwd = launches_per_forward(cfg, seq, mtp=mtp)
    remat = bool(cfg.remat)
    once_norms = 1 + bool(cfg.encoder_segments) + 3 * mtp
    return {"rmsnorm": fwd["rmsnorm"]
            + remat * (fwd["rmsnorm"] - once_norms),
            "flash_attention": fwd["flash_attention"]
            + remat * (fwd["flash_attention"] - mtp),
            "flash_attention_bwd": fwd["flash_attention"],
            "mamba_scan": (1 + remat) * fwd["mamba_scan"],
            "mamba_scan_bwd": fwd["mamba_scan"]}


def batch_on(batch: dict, device) -> dict:
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def leaf_errors(got: list, exp: list) -> list:
    """Per leaf: max |got - exp| over the leaf's largest |exp|."""
    return [float((g.float() - e.float()).abs().max())
            / max(float(e.float().abs().max()), 1e-30)
            for g, e in zip(got, exp)]


def check_leaves(label: str, got: list, exp: list, rel: float) -> float:
    errs = leaf_errors(got, exp)
    worst = max(errs)
    if not worst <= rel:
        raise RuntimeError(f"{label}: a leaf's gradient differs by "
                           f"{worst:.3e} of its largest entry (bar {rel})")
    return worst


# the bar for one training step's gradients held against another: per
# leaf, 5e-4 of the leaf's largest entry, the backward's own bar (the
# reference's for its flash VJP); relative to the leaf's scale because an
# entry near zero carries absolute error, and f32 differences of ~1e-6
# a kernel grow little through 16 layers
STEP_REL = 5e-4


def smoke_step_against_cpu(cfg, seq: int) -> None:
    """Phase 10 / 13 (a): one step of make_train_step with AdamW on a
    smoke config (remat on), B 2 x ``seq``, on the card against the same
    step on the CPU: loss, every leaf's gradient, every first moment."""
    params = build_model(cfg, "cpu").init(torch.Generator().manual_seed(0))
    batch = next(batches(cfg, 2, seq, seed=2))
    out, routes = {}, Routes()
    for dev in ("cpu", "cuda"):
        model = build_model(cfg, dev)
        p = _tree_to(params, dev, copy=True)   # the step writes it in place
        opt = RecordingAdamW(AdamW(lr=TRAIN_LR))
        state = opt.init(p)
        train_counts(reset=True)
        with routes.run(replay=dev == "cuda"):
            _, state, m = make_train_step(model, opt)(p, state,
                                                      batch_on(batch, dev))
            torch.cuda.synchronize()
        launched = train_counts()
        out[dev] = (float(m["loss"]),
                    [g.cpu() for g in tree_leaves(opt.grads)],
                    [t.cpu() for t in tree_leaves(state.mu)], launched)
        if dev == "cpu" and any(launched.values()):
            raise RuntimeError(f"the CPU step launched kernels {launched}")
    routes.check(f"{cfg.name} smoke step, card vs CPU")
    want = launches_per_train_step(cfg, seq)
    if out["cuda"][3] != want:
        raise RuntimeError(f"smoke step launches {out['cuda'][3]} != {want}")
    (lc, gc_, mc, _), (lg, gg, mg, _) = out["cpu"], out["cuda"]
    if not abs(lc - lg) <= 1e-5 * abs(lc):
        raise RuntimeError(f"smoke step loss: card {lg} vs CPU {lc}")
    g_err = check_leaves("smoke step, card vs CPU", gg, gc_, STEP_REL)
    m_err = check_leaves("smoke step moments, card vs CPU", mg, mc, STEP_REL)
    log(f"  (a) {cfg.name}, one step on the card vs the CPU: loss "
        f"{lg:.6f} vs {lc:.6f}; {len(gg)} leaves, worst gradient "
        f"{g_err:.3e} and first moment {m_err:.3e} of the leaf's largest "
        f"entry (bar {STEP_REL}); card launches {out['cuda'][3]}"
        + (f"; {routes.line()}" if routes.tokens else ""))


class Routes:
    """The MoE router's ``torch.topk`` (``layers._moe_tokens``), recorded
    in one run and replayed in another: a replayed call takes the
    recorded experts, their weights gathered from its own probabilities
    (topk's gradient is that gather's), so that two runs whose router
    logits differ by rounding route every token alike; a near tie
    between the k-th and the next expert, which rounding flips, would
    otherwise move a token's gradient from one expert to another.
    ``index`` maps a replaying call's number to the recorded call's (a
    sharded run's groups are a slice of the one-card run's). ``flips``
    counts the tokens whose own top-k differs from the route taken;
    :meth:`check` bounds them at FLIP_SHARE of the routes, so that the
    replay covers near ties and a router that picks other experts still
    fails."""

    FLIP_SHARE = 1e-3

    def __init__(self):
        self.calls, self.flips, self.tokens = [], 0, 0
        self.index, self.replayed = None, 0

    @contextlib.contextmanager
    def run(self, replay: bool):
        topk = torch.topk

        def routed(x, k, dim=-1, *args, **kwargs):
            if not replay:
                out = topk(x, k, dim, *args, **kwargs)
                self.calls.append(out.indices.detach())
                return out
            i = self.replayed if self.index is None else \
                self.index(self.replayed)
            self.replayed += 1
            idx = self.calls[i].to(x.device)
            own = topk(x.detach(), k, dim).indices
            self.flips += int((own.sort(dim).values != idx.sort(dim).values)
                              .any(dim).sum())
            self.tokens += idx.shape[0]
            return x.gather(dim, idx), idx
        torch.topk = routed
        try:
            yield self
        finally:
            torch.topk = topk

    def broadcast(self, rank: int, dev) -> None:
        """Rank 0's recorded routes to every rank (each call holds a
        group's (tokens, k) experts; every group is as large)."""
        import torch.distributed as dist
        shape = torch.tensor([len(self.calls)] + list(
            self.calls[0].shape if self.calls else (0, 0)), device=dev) \
            if rank == 0 else torch.zeros(3, dtype=torch.int64, device=dev)
        dist.broadcast(shape, 0)
        n, t, k = shape.tolist()
        if not n:
            return
        stacked = torch.stack(self.calls).to(dev) if rank == 0 else \
            torch.empty((n, t, k), dtype=torch.int64, device=dev)
        dist.broadcast(stacked, 0)
        self.calls = list(stacked)

    def line(self) -> str:
        return (f"{self.tokens} token routes replayed, {self.flips} of them "
                f"other than the run's own top-k" if self.tokens else "")

    def check(self, label: str) -> None:
        if self.flips > self.FLIP_SHARE * self.tokens:
            raise RuntimeError(f"{label}: {self.line()}, more than "
                               f"{self.FLIP_SHARE:g} of them: the routers "
                               f"differ beyond near ties")


def plain_on_the_card():
    """Point the model's norm, flash and scan calls at the plain versions
    on the card (autograd of plain PyTorch), for a comparison only;
    returns the function that restores them."""
    saved = (kernel_ops.rmsnorm, kernel_ops.flash_attention,
             kernel_ops.mamba_scan)
    kernel_ops.rmsnorm = ref.rmsnorm_ref
    kernel_ops.flash_attention = \
        lambda q, k, v, causal=True, window=0: ref.flash_attention_ref(
            q, k, v, causal=causal, window=window)
    kernel_ops.mamba_scan = ref.mamba_scan_ref

    def restore():
        (kernel_ops.rmsnorm, kernel_ops.flash_attention,
         kernel_ops.mamba_scan) = saved
    return restore


def kernels_and_plain(model, params, batch) -> tuple:
    """The loss and every leaf's gradient (make_train_step's own
    ``value_and_grad``) through the kernels, then through the plain
    versions on the card, each with the launches it made; the second
    run takes the first's MoE routes (:class:`Routes`). Returns the two
    (loss, gradients, launches) and the routes."""
    routes, results = Routes(), []
    for plain in (False, True):
        restore = plain_on_the_card() if plain else None
        try:
            with routes.run(replay=plain):
                train_counts(reset=True)
                loss, grads = value_and_grad(model, params, batch)
                torch.cuda.synchronize()
            results.append((float(loss), grads, train_counts()))
            del grads
        finally:
            if restore:
                restore()
    routes.check(f"{model.cfg.name}, kernels vs plain")
    return results[0], results[1], routes


def grads_against_plain(cfg, batch_size: int) -> None:
    """Phases 10, 13 and 15 (b): at full width, B ``batch_size`` x
    GRAD_SEQ (with the stub features the config takes), the gradient of
    Model.loss for every leaf (make_train_step's own ``value_and_grad``)
    through the kernels against the same through the plain versions on
    the card (no kernel launched), per leaf within STEP_REL of the leaf's
    largest entry."""
    model = build_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(1))
    batch = batch_on(next(batches(cfg, batch_size, GRAD_SEQ, seed=1)),
                     "cuda")
    (lk, gk, ck), (lp, gp, cp), routes = kernels_and_plain(model, params,
                                                           batch)
    if ck != launches_per_train_step(cfg, GRAD_SEQ) or any(cp.values()):
        raise RuntimeError(f"launches: kernels {ck}, plain {cp}")
    worst = check_leaves(f"B {batch_size} x {GRAD_SEQ}, kernels vs plain",
                         gk, gp, STEP_REL)
    errs = leaf_errors(gk, gp)
    if not abs(lk - lp) <= 1e-5 * abs(lp):
        raise RuntimeError(f"loss with kernels {lk} vs plain {lp}")
    log(f"  (b) {cfg.name}, B={batch_size} x {GRAD_SEQ}, one step's "
        f"gradients through the kernels ({ck}) vs the plain versions on "
        f"the card (no launch): loss {lk:.6f} vs {lp:.6f}; {len(gk)} "
        f"leaves, worst {worst:.3e} of the leaf's largest entry (bar "
        f"{STEP_REL}), median {float(np.median(errs)):.3e}"
        + (f"; {routes.line()}" if routes.tokens else ""))
    del gk, gp, params, model


def positions(cfg, batch_size: int, seq: int) -> int:
    """The positions a training step runs: ``seq`` text tokens a row,
    an image prefix and an encoder's stub frames (those the data
    pipeline gives)."""
    return batch_size * (seq + cfg.num_image_tokens
                         + cfg.encoder_max_frames * cfg.is_encoder_decoder)


def train_full_width(cfg, smoke_cfg, batch_size: int, seq: int,
                     smoke_seq: int = SMOKE_TRAIN_SEQ,
                     steps: int = TRAIN_STEPS, grad_cfg=None,
                     grad_batch: int = 0, dryrun_gb=None) -> dict:
    """Phases 10, 13 and 15: (a) and (b) for ``smoke_cfg`` and
    ``grad_cfg`` (by default ``cfg``; B ``grad_batch``, by default
    ``batch_size``), then (c), the main path of the phase: ``cfg`` at
    published width trained by make_train_step (AdamW, remat) on
    batches(cfg, batch_size, seq): one warm-up step, ``steps`` timed
    steps each with its launches checked exactly, then one traced step;
    the peak beside ``dryrun_gb()``, the dry-run's, where given. Returns
    the launches of the steps."""
    smoke_step_against_cpu(smoke_cfg, smoke_seq)
    grads_against_plain(grad_cfg or cfg, grad_batch or batch_size)
    gc.collect()
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    model = build_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    opt = AdamW(lr=TRAIN_LR)
    state = opt.init(params)
    torch.cuda.synchronize()
    n = model_line(cfg, params, time.perf_counter() - t0)
    step = make_train_step(model, opt)
    data = batches(cfg, batch_size, seq, seed=0)
    want = launches_per_train_step(cfg, seq)
    total = dict.fromkeys(TRAIN_COUNTERS, 0)
    losses, step_s = [], []
    torch.cuda.reset_peak_memory_stats()
    for i in range(1 + steps):
        batch = batch_on(next(data), "cuda")
        torch.cuda.synchronize()
        train_counts(reset=True)
        t = time.perf_counter()
        params, state, m = step(params, state, batch)
        torch.cuda.synchronize()
        if i:
            step_s.append(time.perf_counter() - t)
        got = train_counts()
        if got != want:
            raise RuntimeError(f"train step {i}: launches {got} != {want}")
        for k in total:
            total[k] += got[k]
        losses.append(float(m["loss"]))
    peak = torch.cuda.max_memory_allocated() / 1e9
    tokens = batch_size * seq
    ms = float(np.mean(step_s)) * 1e3
    # 6 N T: N the parameters a token touches (a MoE's top-k experts and
    # shared one), T every position the step runs
    n_active = cfg.active_param_count() if cfg.num_experts else n
    pos = positions(cfg, batch_size, seq)
    extra = f" + {pos - tokens} prefix or encoder positions" \
        if pos != tokens else ""
    log(f"  (c) {steps} timed steps after 1 warm-up, B={batch_size} x "
        f"{seq} tokens{extra}, AdamW(lr={TRAIN_LR}), remat: {ms:.1f} ms a "
        f"step (min {min(step_s) * 1e3:.1f}, max {max(step_s) * 1e3:.1f}),"
        f" {tokens / (ms / 1e3):.1f} tokens/s, "
        f"{6 * n_active * pos / (ms / 1e3) / 1e12:.1f} TFLOP/s of 6 N T "
        f"(N {n_active} parameters a token touches, T {pos} positions); "
        f"peak device memory {peak:.2f} GB "
        f"(torch.cuda.max_memory_allocated)"
        + (f", the dry-run's {dryrun_gb():.2f} GB" if dryrun_gb else "")
        + f"; launches a step {want}, exact in every step ({nvidia_smi()})")
    batch = batch_on(next(data), "cuda")
    train_counts(reset=True)
    report_trace("one traced training step",
                 cuda_events(lambda: losses.append(float(
                     step(params, state, batch)[2]["loss"])) or None),
                 ms)
    traced = train_counts()
    if traced != {k: 2 * v for k, v in want.items()}:
        raise RuntimeError(f"the traced steps launched {traced}")
    for k in total:
        total[k] += traced[k]
    log(f"  losses {[round(x, 4) for x in losses]}")
    if not all(np.isfinite(losses)) or \
            not np.mean(losses[-3:]) < losses[0]:
        raise RuntimeError(f"training did not lower the loss: {losses}")
    log(f"  every loss finite; the mean of the last 3, "
        f"{np.mean(losses[-3:]):.4f}, is below the first, {losses[0]:.4f}")
    del params, state, model
    return total


# --------------------------------------------------------------- phase 11
def _p11_greedy(model, params, batch, steps: int, smax: int = SMAX):
    """Prefill ``batch`` (this rank's rows: the prompt and the stub
    features its config takes) into ``smax`` slots and ``steps`` greedy
    steps of a (sharded or plain) model: (every step's whole-vocabulary
    logits (B, 1 + steps, V), tokens (B, 1 + steps), prefill s, the
    steps' s)."""
    whole = model.gather_logits
    pos = batch["tokens"].shape[1] + model.cfg.num_image_tokens
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, state = model.prefill(params, batch, smax)
    outs = [whole(logits)]
    torch.cuda.synchronize()
    pre_s = time.perf_counter() - t0
    toks = [outs[-1].argmax(-1)]
    t0 = time.perf_counter()
    for i in range(steps):
        logits, state = model.decode_step(params, toks[-1], pos + i, state)
        outs.append(whole(logits))
        toks.append(outs[-1].argmax(-1))
    torch.cuda.synchronize()
    return (torch.cat(outs, 1), torch.cat(toks, 1), pre_s,
            time.perf_counter() - t0)


def _p11_rel(got: torch.Tensor, exp: torch.Tensor) -> float:
    return float((got - exp).abs().max() / exp.abs().max())


def _p11_dev(rank: int) -> torch.device:
    return torch.device("cuda", rank)


def _p11_batch(cfg, tokens: torch.Tensor, seed: int) -> dict:
    """``tokens`` and, for whisper or pixtral, seeded stub frames
    (encoder_max_frames a row) or patch embeddings of as many rows, the
    same on every rank."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": tokens}
    if cfg.is_encoder_decoder:
        batch["frames"] = rng.standard_normal(
            (tokens.shape[0], cfg.encoder_max_frames, AUDIO_FEAT_DIM),
            dtype=np.float32)
    if cfg.num_image_tokens:
        batch["image_feats"] = rng.standard_normal(
            (tokens.shape[0], cfg.num_image_tokens, IMAGE_FEAT_DIM),
            dtype=np.float32)
    return {k: v if k == "tokens" else torch.from_numpy(v).to(tokens.device)
            for k, v in batch.items()}


def _p11_draw(cfg, dev):
    """The seeded full weights every part compares against one card."""
    return build_model(cfg, dev).init(
        torch.Generator(device=dev).manual_seed(0))


def _p11_scatter(model, cfg, rank: int, dev):
    """This rank's shards of rank 0's seeded full weights, for a model
    that one card holds but not one card and its shards: rank 0 draws
    the tree and broadcasts it a leaf at a time (each rank keeps its
    slice of the leaf, and the full leaf is dropped), so no card holds
    the tree beside its shards."""
    import torch.distributed as dist
    from repro_torch.models.parallel import _map2
    from repro_torch.models.sharding import execution_view, local_slices
    names = model.mesh.mesh_dim_names
    coords = dict(zip(names, model.mesh.get_coordinate()))
    metas, specs = [], []
    _map2(lambda leaf, spec: (metas.append(leaf), specs.append(spec)),
          model.full, model.specs)
    src = []
    if rank == 0:
        _map2(lambda leaf, spec: src.append(leaf),
              execution_view(_p11_draw(cfg, dev)), model.specs)
    local = []
    for i, (meta, spec) in enumerate(zip(metas, specs)):
        if rank == 0:
            t, src[i] = src[i].contiguous(), None
        else:
            t = torch.empty(meta.shape, dtype=meta.dtype, device=dev)
        dist.broadcast(t, 0)
        # a copy: a slice's view would keep the whole leaf alive
        local.append(t[local_slices(t.shape, spec, model.mesh,
                                    coords)].clone(
                                        memory_format=torch.contiguous_format))
        del t
    shards = iter(local)
    return _map2(lambda leaf, spec: next(shards), model.full, model.specs)


def _p11_forced(model, params, batch, toks: torch.Tensor,
                smax: int = SMAX) -> torch.Tensor:
    """:func:`_p11_greedy`'s logits (B, 1 + steps, V) with its tokens
    given: step i decodes ``toks[:, i]``, so every step sees the input of
    the greedy run that chose ``toks``."""
    pos = batch["tokens"].shape[1] + model.cfg.num_image_tokens
    logits, state = model.prefill(params, batch, smax)
    outs = [logits]
    for i in range(toks.shape[1] - 1):
        logits, state = model.decode_step(params, toks[:, i:i + 1], pos + i,
                                          state)
        outs.append(logits)
    return torch.cat(outs, 1)


class Float64(torch.overrides.TorchFunctionMode):
    """Every ``float()`` cast and every ``float32`` argument becomes
    ``float64``: the model's f32 arithmetic, run in f64. With ``log``,
    each call's (function, arguments, output) is appended to it."""

    def __init__(self, log: list = None):
        super().__init__()
        self.log = log

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func is torch.Tensor.float:
            out = args[0].to(torch.float64)
        else:
            def sub(v):
                return torch.float64 if v is torch.float32 else v
            out = func(*(sub(a) for a in args),
                       **{k: sub(v) for k, v in (kwargs or {}).items()})
        if self.log is not None:
            self.log.append((func, args, out))
        return out


def _p11_f64(cfg, full, fwd, prompt, toks, smax: int) -> tuple:
    """(j)'s reference: the one-card model on the same weights and
    batches in f64 (the plain versions on the card, every f32 cast
    promoted): the forward's logits and the prefill and steps fed the
    one-card run's greedy ``toks``."""
    model = build_model(cfg, full["embed"].device)
    w64 = tree_map(lambda t: t.to(torch.float64), full)
    restore = plain_on_the_card()
    try:
        with Float64():
            out = (model.forward(w64, fwd)[0],
                   _p11_forced(model, w64, prompt, toks, smax))
    finally:
        restore()
    return out


def _p11_against_one_card(rank: int, cfg, meshes, scatter: bool = False,
                          batch: int = DECODE_BATCH, prompt_len: int = PROMPT,
                          smax: int = SMAX, f64: bool = False) -> dict:
    """(a), (b), (e), (j), (k): the same seeded weights, drawn on every
    card; rank 0 runs the plain model on its card, then every mesh of
    ``meshes`` runs the sharded one: the forward of PAR_FWD, then
    ``batch`` x ``prompt_len`` prefilled into ``smax`` slots and
    PAR_STEPS greedy steps, with the stub frames or image features the
    config takes. With ``scatter`` ((f), (g), (l): a model whose full
    tree and shards do not fit one card together) only rank 0 draws
    them, and each mesh's shards come from :func:`_p11_scatter`. With
    ``f64`` ((j)) the logits are also held against :func:`_p11_f64`'s,
    and the one-card run's own distance from f64 is returned beside
    them (``forward_rel`` and ``steps_rel`` are then f64's,
    ``vs_one_card`` the one-card run's). Returns rank 0's
    errors and token agreement, each mesh's shards a card and peak, and
    this rank's launches over the sharded runs."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.parallel import (ShardedModel, shard_batch,
                                             shard_params)
    dev = _p11_dev(rank)
    t_part = time.perf_counter()
    full = _p11_draw(cfg, dev) if rank == 0 or not scatter else None
    rng = np.random.default_rng(11)
    fwd = _p11_batch(cfg, torch.from_numpy(rng.integers(
        0, cfg.vocab_size, PAR_FWD)).to(dev), 12)
    prompt = _p11_batch(cfg, torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (batch, prompt_len))).to(dev), 13)
    out = {"meshes": {}}
    with torch.no_grad():
        if rank == 0:
            plain = build_model(cfg, dev)
            ref_fwd, _ = plain.forward(full, fwd)
            ref_steps, ref_toks, _, _ = _p11_greedy(plain, full, prompt,
                                                    PAR_STEPS, smax)
            if f64:
                f64_fwd, f64_steps = _p11_f64(cfg, full, fwd, prompt,
                                              ref_toks, smax)
                out["one_card_vs_f64"] = {
                    "forward_rel": _p11_rel(ref_fwd, f64_fwd),
                    "steps_rel": _p11_rel(ref_steps, f64_steps)}
                # the one-card run's logits, kept for the log
                one_fwd, one_steps = ref_fwd, ref_steps
                ref_fwd, ref_steps = f64_fwd, f64_steps
        if scatter:
            del full
            gc.collect()
            torch.cuda.empty_cache()
        torch.distributed.barrier()
        total = dict.fromkeys(COUNTERS, 0)
        for shape in meshes:
            mesh = make_mesh(*shape)
            model = ShardedModel(cfg, mesh, dev)
            par = model.par
            local = _p11_scatter(model, cfg, rank, dev) if scatter else \
                shard_params(full, mesh)
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
            reset_counts()
            t_mesh = time.perf_counter()
            logits, _ = model.forward(local, shard_batch(fwd, mesh))
            logits = par.all_gather(model.gather_logits(logits), 0, "data")
            steps, toks, _, _ = _p11_greedy(
                model, local, shard_batch(prompt, mesh), PAR_STEPS, smax)
            steps = par.all_gather(steps, 0, "data")
            toks = par.all_gather(toks, 0, "data")
            add_counts(total, counts())
            if rank == 0:
                out["meshes"][f"{shape[0]}x{shape[1]}"] = {
                    "forward_rel": _p11_rel(logits, ref_fwd),
                    "steps_rel": _p11_rel(steps, ref_steps),
                    **({"vs_one_card": [_p11_rel(logits, one_fwd),
                                        _p11_rel(steps, one_steps)]}
                       if f64 else {}),
                    "tokens_equal": int((toks == ref_toks).sum()),
                    "tokens": toks.numel(),
                    "local_gb": sum(t.numel() * t.element_size()
                                    for t in _leaves(local)) / 1e9,
                    "s": time.perf_counter() - t_mesh,
                    "peak_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
                    "collectives": {f"{k}/{n}": c for (k, n), (c, _)
                                    in par.stats.by_kind.items()}}
            del local, model, steps, logits
            torch.distributed.barrier()
    out["launches"] = total
    out["s"] = time.perf_counter() - t_part
    return out


def _covered_ms(spans) -> float:
    """The time, in ms, that the union of ``spans`` ((start, end) in
    us) covers: kernels that overlap count once."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            total += b - max(a, end)
            end = b
    return total / 1e3


def _trace_summary(prof, wall_ms: float) -> dict:
    """One rank's traced step: its CUDA kernels, the time the union of
    the non-NCCL kernels' intervals covers (busy) and NCCL's, and the
    five kernels with the most device time."""
    cuda = torch.autograd.DeviceType.CUDA
    kern = [e for e in prof.key_averages() if e.device_type == cuda]
    spans = [(e.time_range.start, e.time_range.end,
              "nccl" in e.name.lower()) for e in prof.events()
             if e.device_type == cuda]
    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:5]
    return {"wall_ms": wall_ms,
            "busy_ms": _covered_ms([(a, b) for a, b, n in spans if not n]),
            "nccl_ms": _covered_ms([(a, b) for a, b, n in spans if n]),
            "kernels": sum(e.count for e in kern),
            "top": [(e.key[:70], e.self_device_time_total / 1e3, e.count)
                    for e in top]}


def _log_trace(part: str, t: dict) -> None:
    """Log a :func:`_trace_summary` of rank 0."""
    log(f"  ({part}) one traced step on rank 0: {t['kernels']} kernels, "
        f"device busy (the union of its non-NCCL kernels) "
        f"{t['busy_ms']:.3f} of {t['wall_ms']:.3f} ms "
        f"({t['busy_ms'] / t['wall_ms']:.1%}); NCCL kernels resident "
        f"{t['nccl_ms']:.3f} ms ({t['nccl_ms'] / t['wall_ms']:.1%}: "
        f"transfer and the wait for the slowest rank)")
    for key, ms, n in t["top"]:
        log(f"    {ms:8.3f} ms  x{n:<5d} {key}")


def _p11_whole(rank: int, cfg) -> dict:
    """(c), (h), (i): ``cfg`` at full width on the (1, 4) mesh, each
    card drawing its shards (init_local, one seed on every card): prefill
    DECODE_BATCH x PROMPT into SMAX slots (a cold call, then a timed
    one), then PAR_WHOLE_STEPS greedy steps; launches checked per rank;
    one more step traced on rank 0."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.parallel import ShardedModel
    dev = _p11_dev(rank)
    t_part = time.perf_counter()
    mesh = make_mesh(1, PAR_CARDS)
    model = ShardedModel(cfg, mesh, dev)
    t0 = time.perf_counter()
    params = model.init_local(1000)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)     # serving's peak, from here
    out = {"init_s": time.perf_counter() - t0,
           "local_gb": sum(t.numel() * t.element_size()
                           for t in _leaves(params)) / 1e9,
           "params": cfg.param_count()}
    prompt = torch.from_numpy(np.random.default_rng(12).integers(
        0, cfg.vocab_size, (DECODE_BATCH, PROMPT))).to(dev)
    with torch.no_grad():
        _, state = model.prefill(params, {"tokens": prompt}, SMAX)   # cold
        del state
        reset_counts()
        steps, toks, pre_s, dec_s = _p11_greedy(
            model, params, {"tokens": prompt}, PAR_WHOLE_STEPS)
        launches = counts()
        want = launches_per_forward(cfg, PROMPT)
        for k, n in launches_per_step(cfg).items():
            want[k] += n * PAR_WHOLE_STEPS
        if launches != want:
            raise RuntimeError(f"rank {rank}: launches {launches} != {want}")
        if not bool(torch.isfinite(steps).all()) or tuple(steps.shape) != (
                DECODE_BATCH, 1 + PAR_WHOLE_STEPS, cfg.vocab_size):
            raise RuntimeError(f"rank {rank}: bad logits "
                               f"{tuple(steps.shape)}")
        out.update(prefill_ms=pre_s * 1e3,
                   step_ms=dec_s / PAR_WHOLE_STEPS * 1e3,
                   tokens_per_s=DECODE_BATCH * PAR_WHOLE_STEPS / dec_s,
                   launches=launches,
                   first_tokens=toks[0, :8].tolist())
        # one more step, at the next position, traced on rank 0 only
        _, state = model.prefill(params, {"tokens": prompt}, SMAX)
        tok = toks[:, :1]

        def step():
            model.decode_step(params, tok, PROMPT, state)
            torch.cuda.synchronize()
        step()
        torch.distributed.barrier()
        if rank == 0:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                step()
                wall = (time.perf_counter() - t0) * 1e3
            out["trace"] = _trace_summary(prof, wall)
        else:
            step()
        torch.distributed.barrier()
    out["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    out["collectives"] = {f"{k}/{n}": [c, b] for (k, n), (c, b)
                          in model.par.stats.by_kind.items()}
    out["s"] = time.perf_counter() - t_part
    return out


def par_hybrid(lo: int = 0, hi: int = 8):
    """jamba-1.5-large-398b, its experts kept, one period cut to blocks
    [lo:hi]."""
    full = get_arch(HYBRID)
    seg = full.segments[0]
    name = full.name if (lo, hi) == (0, 8) else f"{full.name}-blocks{lo}:{hi}"
    return dataclasses.replace(
        full, name=f"{name}-1p",
        segments=(dataclasses.replace(seg, blocks=seg.blocks[lo:hi],
                                      repeat=1),))


def _p11_parts(rank: int) -> dict:
    """The parts of phase 11 a rank runs, in order; a card's memory is
    freed between them."""
    from repro_torch.launch.shapes import SHAPES, dryrun_config

    def cut(arch: str, layers: int):
        full = get_arch(arch)
        return dataclasses.replace(full, name=f"{full.name}-{layers}L",
                                   segments=dense_segments(layers))

    def serving(cfg):
        return dryrun_config(cfg, SHAPES["prefill_32k"], 1)[0]

    runs = {
        "a": lambda: _p11_against_one_card(
            rank, cut("qwen2-72b", PAR_CUT), PAR_MESHES),
        "b": lambda: _p11_against_one_card(
            rank, drop_free(get_arch("granite-moe-1b-a400m")),
            PAR_MESHES[:1]),
        "e": lambda: _p11_against_one_card(
            rank, cut("granite-34b", PAR_SPLIT_CUT), PAR_MESHES[:1]),
        "c": lambda: _p11_whole(rank, serving(get_arch("qwen2-72b"))),
        "f": lambda: _p11_against_one_card(
            rank, drop_free(deepseek_cut(*PAR_DEEPSEEK_CUT)), PAR_MESHES,
            scatter=True),
        "g": lambda: _p11_against_one_card(
            rank, drop_free(par_hybrid(*PAR_HYBRID_BLOCKS)), PAR_MESHES,
            scatter=True),
        "h": lambda: _p11_whole(rank, serving(deepseek_cut(
            *PAR_DEEPSEEK_WHOLE))),
        "i": lambda: _p11_whole(rank, par_hybrid()),
    }
    for part, arch, batch, prompt_len, smax in PAR_FAMILIES:
        runs[part] = functools.partial(
            _p11_against_one_card, rank, get_arch(arch), PAR_MESHES,
            scatter=arch == "pixtral-12b", batch=batch,
            prompt_len=prompt_len, smax=smax, f64=part == "j")
    res: dict = {}
    for part, run in runs.items():
        res[part] = run()
        gc.collect()
        torch.cuda.empty_cache()
    return res


def _p11_rank(rank: int, world: int, store: str, out_dir: str,
              phase: int = 11) -> None:
    """One rank of phase 11 or 16: NCCL over a FileStore, one card a
    rank."""
    import datetime
    import traceback
    import torch.distributed as dist
    torch.cuda.set_device(rank)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.load(rebuild=False)      # the parent's build
    dist.init_process_group(
        "nccl", store=dist.FileStore(store, world), rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=600),
        device_id=torch.device("cuda", rank))
    res: dict = {"rank": rank}
    try:
        res.update(_p11_parts(rank) if phase == 11 else _p16_parts(rank))
    except Exception:  # noqa: BLE001 — reported to the parent
        res["error"] = traceback.format_exc()
    path = Path(out_dir) / f"rank{rank}.json"
    path.with_suffix(".tmp").write_text(json.dumps(res))
    path.with_suffix(".tmp").replace(path)
    if "error" not in res:
        dist.destroy_process_group()


class DryRun:
    """The port's dry-run (``repro_torch.launch.dryrun.lower_one`` on
    ``meta``) of each ``(config or registered name, ShapeSpec, mesh,
    smax)`` of ``runs``, in a process of its own (its fake process group
    is process-global), started at once; :meth:`gb` waits for it and
    gives a run's per-device peak in GB. A name takes the reference's
    production policy, a config is traced as it is."""

    def __init__(self, runs):
        import pickle
        code = (
            "import json, pickle, sys\n"
            f"sys.path.insert(0, {str(ROOT / 'src')!r})\n"
            "from repro_torch.launch.dryrun import lower_one\n"
            "runs = pickle.load(sys.stdin.buffer)\n"
            "print(json.dumps([lower_one(a, shape, mesh, smax=smax, "
            "verbose=False)['peak_bytes_per_device'] for a, shape, mesh, "
            "smax in runs]))\n")
        self.proc = subprocess.Popen(
            [sys.executable, "-W", "ignore", "-c", code],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT)
        self.proc.stdin.write(pickle.dumps(list(runs)))
        self.proc.stdin.close()
        self.peaks = None

    def gb(self, i: int) -> float:
        if self.peaks is None:
            out = self.proc.stdout.read().decode(errors="replace")
            if self.proc.wait(timeout=600):
                raise RuntimeError(f"the dry-run failed: {out[-3000:]}")
            self.peaks = json.loads(out.strip().splitlines()[-1])
        return self.peaks[i] / 1e9

    def close(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
        self.proc.wait()
        self.proc.stdout.close()


def train_shape(cfg, b: int, seq: int):
    """The dry-run's training shape of B ``b`` x ``seq`` text tokens: its
    batch is the reference's ``batch_specs``, whose training rows take
    an image prefix before the text and, for an encoder-decoder, as many
    stub frames as tokens."""
    from repro_torch.launch.shapes import ShapeSpec
    return ShapeSpec("train", "train", seq * (1 + cfg.is_encoder_decoder)
                     + cfg.num_image_tokens, b)


def dryrun_peaks(world: int) -> dict:
    """(d): the port's dry-run of (c)'s configuration on the (1, world)
    mesh: the prefill into SMAX slots and a decode step against them;
    returns each one's per-device peak in GB."""
    from repro_torch.launch.shapes import ShapeSpec
    dry = DryRun([
        ("qwen2-72b", ShapeSpec("prefill", "prefill", PROMPT, DECODE_BATCH),
         (1, world), SMAX),
        ("qwen2-72b", ShapeSpec("decode", "decode", SMAX, DECODE_BATCH),
         (1, world), 0)])
    try:
        return {"prefill": dry.gb(0), "decode": dry.gb(1)}
    finally:
        dry.close()


def _p11_report_whole(part: str, label: str, rows: list,
                      kernels: tuple) -> None:
    """Log (c), (h) or (i): the served model's sizes, its prefill and
    steps, memory, launches (each rank must launch every kernel of
    ``kernels``), collectives and the traced step."""
    x0 = rows[0]
    log(f"  ({part}) {label}: {x0['params']} parameters, "
        f"{x0['local_gb']:.2f} GB of shards a card (drawn in "
        f"{x0['init_s']:.1f} s); prefill {DECODE_BATCH}x{PROMPT} into "
        f"{SMAX} slots {x0['prefill_ms']:.3f} ms (the second call); "
        f"{PAR_WHOLE_STEPS} greedy steps {x0['step_ms']:.3f} ms a step, "
        f"{x0['tokens_per_s']:.1f} tokens/s; first row's tokens "
        f"{x0['first_tokens']}; {x0['s']:.1f} s in all")
    log(f"  ({part}) peak device memory a card "
        f"(torch.cuda.max_memory_allocated): "
        f"{[round(x['peak_gb'], 2) for x in rows]} GB")
    for rank, x in enumerate(rows):
        log(f"  ({part}) rank {rank} launches {x['launches']}")
        if not all(x["launches"][k] > 0 for k in kernels):
            raise RuntimeError(f"phase 11 ({part}): a rank launched no "
                               f"kernel of the path: {x['launches']}")
    log(f"  ({part}) collectives a rank [calls, bytes]: "
        f"{x0['collectives']}")
    _log_trace(part, x0["trace"])


def _spawn_ranks(phase: int) -> list:
    """PAR_CARDS ranks of phase 11 or 16 spawned, one a card (NCCL over
    a FileStore under build/), each running its parts in order: returns
    their results, rank by rank, or raises with a failed rank's
    traceback."""
    import multiprocessing as mp
    out_dir = ROOT / "build" / f"phase{phase}"
    out_dir.mkdir(parents=True, exist_ok=True)
    for f in out_dir.glob("*"):
        f.unlink()
    ctx = mp.get_context("spawn")
    t0 = time.perf_counter()
    procs = [ctx.Process(target=_p11_rank, args=(
        r, PAR_CARDS, str(out_dir / "store"), str(out_dir), phase))
        for r in range(PAR_CARDS)]
    for p in procs:
        p.start()
    # every rank writes its result; a failed rank leaves the others
    # waiting in a collective, so they are killed at once
    deadline = time.monotonic() + PAR_JOIN_S
    while any(p.is_alive() for p in procs) and \
            time.monotonic() < deadline:
        time.sleep(1.0)
        if any("error" in json.loads(f.read_text())
               for f in out_dir.glob("rank*.json")):
            break
    for p in procs:
        p.join(5.0)
        if p.is_alive():
            p.kill()
            p.join()
    log(f"  {PAR_CARDS} ranks ran in {time.perf_counter() - t0:.1f} s; exit "
        f"codes {[p.exitcode for p in procs]}")
    res = []
    for r in range(PAR_CARDS):
        path = out_dir / f"rank{r}.json"
        if not path.exists():
            raise RuntimeError(f"phase {phase}: rank {r} wrote no result "
                               f"(exit code {procs[r].exitcode})")
        res.append(json.loads(path.read_text()))
    errors = [x["error"] for x in res if "error" in x]
    if errors:
        raise RuntimeError(f"phase {phase} failed:\n" + "\n".join(errors))
    if any(p.exitcode != 0 for p in procs):
        raise RuntimeError(f"phase {phase}: exit codes "
                           f"{[p.exitcode for p in procs]}")
    return res


def sharded_on_four_cards() -> dict:
    """Phase 11: PAR_CARDS ranks spawned, one a card (NCCL over a
    FileStore under build/), running its parts in order:
    (a) qwen2-72b cut to PAR_CUT layers, f32, the same seeded weights
    unsharded on cuda:0 and split over each mesh of PAR_MESHES: the
    forward's logits of PAR_FWD, then prefill DECODE_BATCH x PROMPT and
    PAR_STEPS greedy steps into SMAX slots, within PAR_REL (max |dlogit|
    / max |logit|) and every greedy token equal; (b) granite-moe-1b-a400m
    whole on (1, 4), drop-free, the same bar; (e) granite-34b cut to
    PAR_SPLIT_CUT layers on (1, 4), the same bar, its decode over the
    sequence-split cache; (c) qwen2-72b whole (80 layers, bf16) on (1,
    4); (d) the dry-run's peak beside (c)'s; (f) deepseek-v3-671b and
    (g) jamba-1.5-large-398b with its experts, cut, f32, drop-free, on
    both meshes, the bar of (a); (h) deepseek-v3-671b at
    PAR_DEEPSEEK_WHOLE layers, bf16, and (i) one whole period of Jamba,
    f32, served on (1, 4) as (c) is; (j) xlstm-125m, (k) whisper-small
    and (l) pixtral-12b whole at published width, f32, on both meshes,
    the bar of (a) ((j): its forward against an f64 run at that bar, its
    prefill and steps against one card at that bar and against the f64
    run at PAR_F64_MARGIN times the one card's own distance from it).
    Every rank of (f)-(i) must launch rmsnorm and flash
    attention, and of (g) and (i) the scan and decode attention too; of
    (j) rmsnorm, of (k) and (l) rmsnorm, flash and decode attention.
    Returns the ranks' launches, summed."""
    res = _spawn_ranks(11)
    against = (("a", f"qwen2-72b {PAR_CUT}L f32"),
               ("b", "granite-moe-1b-a400m whole, drop-free"),
               ("e", f"granite-34b {PAR_SPLIT_CUT}L f32, one KV "
                     f"head: the sequence split over model"),
               ("f", f"deepseek-v3-671b {'+'.join(map(str, PAR_DEEPSEEK_CUT))}"
                     f" dense+MoE layers with MTP, f32, drop-free"),
               ("g", f"jamba-1.5-large-398b blocks "
                     f"{list(PAR_HYBRID_BLOCKS)} with experts, f32, "
                     f"drop-free"),
               ("j", "xlstm-125m whole, f32, against f64"),
               ("k", "whisper-small whole, f32, 1500 stub frames a row"),
               ("l", "pixtral-12b whole (40 layers), f32, 1024 stub "
                     "patches a row"))
    failed = []         # every part is logged before phase 11 fails
    for part, label in against:
        one = res[0][part].get("one_card_vs_f64")
        if one:
            log(f"  ({part}) {label}: every logit held against the same "
                f"weights and batches in f64 (the plain versions, every "
                f"f32 cast promoted; the steps fed the one-card run's "
                f"tokens): max |d| / max |x_f64|; the one-card f32 run "
                f"itself sits {one['forward_rel']:.3e} (forward) and "
                f"{one['steps_rel']:.3e} (prefill + steps) from f64")
        for mesh, m in res[0][part]["meshes"].items():
            if one:
                # the steps: within PAR_REL of one card, and from f64
                # within PAR_F64_MARGIN of the one card's own distance
                steps_bar = PAR_F64_MARGIN * one["steps_rel"]
                ok = (m["vs_one_card"][1] <= PAR_REL
                      and m["steps_rel"] <= steps_bar)
                log(f"  ({part}) on ({mesh.replace('x', ', ')}) against "
                    f"the one-card f32 run: forward "
                    f"{m['vs_one_card'][0]:.3e} (not a bar), prefill + "
                    f"steps {m['vs_one_card'][1]:.3e} (bar {PAR_REL:g})")
                steps = (f"{m['steps_rel']:.3e} (bar {PAR_F64_MARGIN:g} x "
                         f"the one card's {one['steps_rel']:.3e} = "
                         f"{steps_bar:.3e})")
            else:
                ok = m["steps_rel"] <= PAR_REL
                steps = f"{m['steps_rel']:.3e} (bar {PAR_REL:g})"
            log(f"  ({part}) {label} on ({mesh.replace('x', ', ')}): "
                f"forward {PAR_FWD[0]}x{PAR_FWD[1]} max|dlogit|/max|logit| "
                f"{m['forward_rel']:.3e} (bar {PAR_REL:g}); prefill + "
                f"{PAR_STEPS} steps {steps}; "
                f"greedy tokens equal {m['tokens_equal']} of {m['tokens']}; "
                f"{m['local_gb']:.2f} GB of shards a card, peak "
                f"{m['peak_gb']:.2f} GB on rank 0, {m['s']:.1f} s; "
                f"collectives a rank {m['collectives']}")
            if not (ok and m["forward_rel"] <= PAR_REL
                    and m["tokens_equal"] == m["tokens"]):
                failed.append(f"({part}) {mesh}: {m}")
        log(f"  ({part}) launches a rank over its sharded runs: "
            f"{[x[part]['launches'] for x in res]}; {res[0][part]['s']:.1f}"
            f" s in all")
    # (e) decodes by the split-sequence flash (rank 0 holds the prompt's
    # first slots, so it attends at every step), never the decode kernel
    e0 = res[0]["e"]["launches"]
    if any(x["e"]["launches"]["decode_attention"] for x in res) or \
            e0["flash_attention"] < PAR_STEPS * PAR_SPLIT_CUT:
        raise RuntimeError(f"phase 11 (e) did not decode by the split "
                           f"sequence: {[x['e']['launches'] for x in res]}")
    need = {"f": ("rmsnorm", "flash_attention"),
            "g": ("rmsnorm", "flash_attention", "mamba_scan",
                  "decode_attention"),
            "j": ("rmsnorm",),
            "k": ("rmsnorm", "flash_attention", "decode_attention"),
            "l": ("rmsnorm", "flash_attention", "decode_attention")}
    for part, kernels in need.items():
        for x in res:
            if not all(x[part]["launches"][k] > 0 for k in kernels):
                failed.append(f"({part}): a rank launched no kernel of the "
                              f"path: {x[part]['launches']}")
    whole = (("c", "qwen2-72b whole: 80 layers, bf16",
              ("rmsnorm", "flash_attention", "decode_attention")),
             ("h", f"deepseek-v3-671b, {PAR_DEEPSEEK_WHOLE[0]} dense + "
                   f"{PAR_DEEPSEEK_WHOLE[1]} MoE layers, bf16",
              ("rmsnorm", "flash_attention")),
             ("i", "jamba-1.5-large-398b, one whole period (7 Mamba + 1 "
                   "attention layers, 4 MoE), f32",
              ("rmsnorm", "flash_attention", "mamba_scan",
               "decode_attention")))
    for part, label, kernels in whole:
        _p11_report_whole(part, label, [x[part] for x in res], kernels)
    peaks = dryrun_peaks(PAR_CARDS)
    measured = max(x["c"]["peak_gb"] for x in res)
    for kind in ("prefill", "decode"):
        log(f"  (d) the dry-run of (c) on (1, {PAR_CARDS}), {kind}: peak "
            f"{peaks[kind]:.2f} GB a device; (c) measured "
            f"{measured:.2f} GB: ratio {peaks[kind] / measured:.3f}")
    if failed:
        raise RuntimeError("phase 11 failed: " + "; ".join(failed))
    total = dict.fromkeys(COUNTERS, 0)
    for x in res:
        for part in "abecfghijkl":
            add_counts(total, x[part]["launches"])
    return total


# --------------------------------------------------------------- phase 12

def families_of_the_slice() -> dict:
    """xlstm-125m, whisper-small and pixtral-12b at published width, f32,
    seeded random weights and stub features, one at a time (each freed
    before the next): phase 6's prefill, greedy decode and checks at
    P12_RUNS's shapes. Returns the launches of the prefills and steps
    that decode_and_check counted, summed."""
    total = dict.fromkeys(COUNTERS, 0)
    for arch, b, prompt_len, smax, steps in P12_RUNS:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        cfg = get_arch(arch)
        t0 = time.perf_counter()
        model = build_model(cfg, "cuda")
        params = model.init(torch.Generator(device="cuda").manual_seed(0))
        torch.cuda.synchronize()
        model_line(cfg, params, time.perf_counter() - t0)
        gen = torch.Generator(device="cuda").manual_seed(1)
        extra = {}
        if cfg.is_encoder_decoder:
            log(f"  encoder: {sum(s.num_layers for s in cfg.encoder_segments)}"
                f"L over {cfg.encoder_max_frames} stub frames of "
                f"{AUDIO_FEAT_DIM}; a cross-attention in every decoder layer")
            extra["frames"] = torch.randn(
                (b, cfg.encoder_max_frames, AUDIO_FEAT_DIM), generator=gen,
                device="cuda")
        if cfg.num_image_tokens:
            log(f"  image prefix: {cfg.num_image_tokens} stub patch "
                f"embeddings of {IMAGE_FEAT_DIM} through img_proj")
            extra["image_feats"] = torch.randn(
                (b, cfg.num_image_tokens, IMAGE_FEAT_DIM), generator=gen,
                device="cuda")
        pre, stepped, _ = decode_and_check(model, params, steps, b=b,
                                           prompt_len=prompt_len, smax=smax,
                                           extra=extra)
        peak_line(f"{arch} ({nvidia_smi()})")
        add_counts(total, pre)
        add_counts(total, stepped)
        del model, params, extra
    gc.collect()
    torch.cuda.empty_cache()
    return total


# --------------------------------------------------------------- phase 13

def hybrid_train_cut():
    """The expert-free Jamba at published width, its period cut to blocks
    HYBRID_TRAIN_BLOCKS, remat on as the dry-run sets it for training."""
    cfg = without_experts(get_arch(HYBRID))
    seg = cfg.segments[0]
    lo, hi = HYBRID_TRAIN_BLOCKS
    return dataclasses.replace(
        cfg, name=f"{cfg.name}-blocks{lo}:{hi}", remat=True,
        segments=(dataclasses.replace(seg, blocks=seg.blocks[lo:hi]),))


def train_the_hybrid() -> dict:
    """Phase 13: phase 10's three parts for the hybrid. Returns the
    launches of the main path's steps."""
    smoke = dataclasses.replace(drop_free(get_smoke(HYBRID)), remat=True)
    return train_full_width(hybrid_train_cut(), smoke, HYBRID_TRAIN_BATCH,
                            HYBRID_TRAIN_SEQ, smoke_seq=HYBRID_SMOKE_SEQ)


# --------------------------------------------------------------- phase 14

def run_example(name: str, *args: str) -> tuple:
    """``python -m repro_torch.examples.<name> args`` from the repository
    root, its output captured; raises on a nonzero exit. Returns (its
    standard output, its wall time in s)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", f"repro_torch.examples.{name}", *args],
        cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=EXAMPLE_TIMEOUT_S)
    wall = time.perf_counter() - t0
    for line in proc.stdout.splitlines():
        log(f"    | {line}")
    if proc.returncode != 0:
        raise RuntimeError(f"{name} exited {proc.returncode}:\n"
                           f"{proc.stderr[-4000:]}")
    return proc.stdout, wall


def examples_on_the_card() -> None:
    """Phase 14: the serving example at its default (published width on
    the card) and the training example on the hybrid's smoke config.
    The serving example exits nonzero if the plan is infeasible or a live
    query goes unanswered; here its served count, the closed loop's
    releases and scale-up are checked from its output."""
    out, wall = run_example("serve_real_models")
    live = gamma_trace(PLAN_QPS, 1.0, PLAN_LIVE_S, seed=1).size
    served = re.search(r"^served (\d+) queries:$", out, re.M)
    measured = re.search(r"measured  p50=\s*([\d.]+)ms  p99=\s*([\d.]+)ms"
                         r"  miss=([\d.]+)", out)
    est = re.search(r"estimator p50=\s*([\d.]+)ms  p99=\s*([\d.]+)ms", out)
    loop = re.search(r"served (\d+) queries, miss=([\d.]+), "
                     r"released=(\d+)", out)
    ups = re.findall(r"^  t=\s*[\d.]+s  up ", out, re.M)
    if "h100-1" not in out or not served or int(served.group(1)) != live \
            or not (measured and est and loop):
        raise RuntimeError(f"serve_real_models: no plan on h100-1 or not "
                           f"every one of the {live} live queries served")
    if int(loop.group(3)) or not ups:
        raise RuntimeError(f"serve_real_models: the closed loop released "
                           f"{loop.group(3)} queries, scale-ups {len(ups)}")
    log(f"  serve_real_models ({wall:.1f} s of wall time): {live} of {live} "
        f"live queries served on the plan, measured p50 "
        f"{measured.group(1)} ms p99 {measured.group(2)} ms miss "
        f"{measured.group(3)} beside the Estimator's p50 {est.group(1)} ms "
        f"p99 {est.group(2)} ms; closed loop {loop.group(1)} served, miss "
        f"{loop.group(2)}, released 0, {len(ups)} scale-up events")
    out, wall = run_example("train_arch", *EXAMPLE_TRAIN_ARGS)
    learned = re.search(r"loss: first10=([\d.]+)  last10=([\d.]+)", out)
    if not learned or "checkpoint round-trip OK" not in out:
        raise RuntimeError("train_arch: no loss line or no round trip")
    log(f"  train_arch {' '.join(EXAMPLE_TRAIN_ARGS)} ({wall:.1f} s of wall "
        f"time): loss first10 {learned.group(1)} -> last10 "
        f"{learned.group(2)}, checkpoint round-trip OK")


# --------------------------------------------------------------- phase 15

def train_the_families() -> dict:
    """Phase 15: phase 10's three parts for each of P15_RUNS at published
    width, f32, remat: granite-moe-1b-a400m, (a) and (b) drop-free (a
    route that rounding flips makes a comparison meaningless) and (c) at
    its published capacity factor, the reference's training semantics;
    whisper-small with the data pipeline's encoder_max_frames stub frames
    a row. (b) at B 1 x GRAD_SEQ, (c) P15_STEPS timed steps, its peak
    beside the port's dry-run of the same step. Returns the launches of
    the main path's steps."""
    runs = [(dataclasses.replace(get_arch(arch), remat=True), b, seq)
            for arch, b, seq in P15_RUNS]
    dry = DryRun([(cfg, train_shape(cfg, b, seq), (1, 1), 0)
                  for cfg, b, seq in runs])
    total = dict.fromkeys(TRAIN_COUNTERS, 0)
    try:
        for i, (cfg, b, seq) in enumerate(runs):
            log(f"  {cfg.name}, B {b} x {seq} tokens"
                + (f" + {cfg.encoder_max_frames} stub frames a row"
                   if cfg.is_encoder_decoder else "")
                + (f", capacity factor {cfg.capacity_factor}"
                   if cfg.num_experts else ""))
            smoke = dataclasses.replace(drop_free(get_smoke(cfg.name)),
                                        remat=True)
            add_counts(total, train_full_width(
                cfg, smoke, b, seq, steps=P15_STEPS, grad_cfg=drop_free(cfg),
                grad_batch=1, dryrun_gb=functools.partial(dry.gb, i)))
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        dry.close()
    return total


# --------------------------------------------------------------- phase 16

def _p16_batch(cfg, b: int, seq: int, dev, seed: int = 3) -> dict:
    """One batch of the data pipeline, the same on every rank."""
    return batch_on(next(batches(cfg, b, seq, seed=seed)), dev)


def _p16_whole_leaves(tree, model, shapes):
    """Every leaf of a tree of ``model``'s shards made whole (every rank
    takes part; rank 0 keeps them), in :func:`tree_leaves`' order, each
    in the reference's shape of ``shapes``: a generator, a leaf at a
    time."""
    spec_of = {}
    from repro_torch.models.parallel import _map2
    _map2(lambda t, spec: spec_of.__setitem__(id(t), spec), tree,
          model.specs)
    for t, shape in zip(tree_leaves(tree), shapes):
        for d, entry in enumerate(spec_of[id(t)]):
            if entry is not None:
                t = model.par.all_gather(t, d, entry)
        yield t.reshape(shape)


def _p16_against_one_card(rank: int, cfg, meshes, b: int, seq: int) -> dict:
    """(a), (b): the same seeded weights drawn on every card; rank 0
    takes one make_train_step with AdamW on its card, then every mesh of
    ``meshes`` takes the same step sharded, on the same B ``b`` x
    ``seq`` batch. Rank 0 holds the sharded loss, every gradient leaf
    and every first moment, each made whole, against its one-card run's:
    max |d| over the leaf's largest |x|. Returns those, each mesh's
    shards a card, peak and seconds, and this rank's launches, checked
    exact, over the sharded steps."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.model import Model
    from repro_torch.models.parallel import (ShardedModel, shard_batch,
                                             shard_params)
    dev = _p11_dev(rank)
    t_part = time.perf_counter()
    full = _p11_draw(cfg, dev)
    batch = _p16_batch(cfg, b, seq, dev)
    want = launches_per_train_step(cfg, seq)
    shapes = [t.shape for t in tree_leaves(Model(cfg, torch.device(
        "meta")).init(None))]
    out = {"meshes": {}, "params": sum(t.numel() for t in tree_leaves(full))}
    routes = Routes()
    if rank == 0:
        rec = RecordingAdamW(AdamW(lr=TRAIN_LR))
        p = _tree_to(full, dev, copy=True)      # the step writes it
        state = rec.init(p)
        with routes.run(replay=False):
            _, state, m = make_train_step(build_model(cfg, dev), rec)(
                p, state, batch)
        ref_loss = float(m["loss"])
        ref = [(g.cpu(), mu.cpu()) for g, mu in zip(
            tree_leaves(rec.grads), tree_leaves(state.mu))]
        del p, state, rec, m
        gc.collect()
        torch.cuda.empty_cache()
    routes.broadcast(rank, dev)
    total = dict.fromkeys(TRAIN_COUNTERS, 0)
    for shape in meshes:
        mesh = make_mesh(*shape)
        model = ShardedModel(cfg, mesh, dev)
        local = shard_params(full, mesh)
        rec = RecordingAdamW(AdamW(lr=TRAIN_LR))
        state = rec.init(local)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        nd, g = model.par.data_size, cfg.moe_groups
        # a data rank that routes its own rows takes its slice of the
        # one-card run's groups (ShardedModel's moe_rows)
        own = nd > 1 and g % nd == 0 and b * seq % g == 0
        routes.index = functools.partial(
            lambda i, per, d: (i // per) * g + d * per + i % per,
            per=g // nd, d=model.par.data_rank) if own else None
        routes.replayed = routes.flips = routes.tokens = 0
        t_mesh = time.perf_counter()
        train_counts(reset=True)
        with routes.run(replay=True):
            _, state, m = make_train_step(model, rec)(
                local, state, shard_batch(batch, mesh))
            torch.cuda.synchronize()
        if routes.replayed * (nd if own else 1) != len(routes.calls):
            raise RuntimeError(f"rank {rank} on {shape}: "
                               f"{routes.replayed} routed groups, the "
                               f"one-card run {len(routes.calls)}")
        routes.check(f"rank {rank} on {shape}")
        got = train_counts()
        if got != want:
            raise RuntimeError(f"rank {rank} on {shape}: launches {got} != "
                               f"{want}")
        add_counts(total, got)
        step_s = time.perf_counter() - t_mesh
        g_err, m_err = [], []
        for (g, mu), whole_g, whole_mu in zip(
                ref if rank == 0 else [(None, None)] * len(shapes),
                _p16_whole_leaves(rec.grads, model, shapes),
                _p16_whole_leaves(state.mu, model, shapes)):
            if rank == 0:
                g_err.append(leaf_errors([whole_g], [g.to(dev)])[0])
                m_err.append(leaf_errors([whole_mu], [mu.to(dev)])[0])
        if rank == 0:
            out["meshes"][f"{shape[0]}x{shape[1]}"] = {
                "loss": [float(m["loss"]), ref_loss],
                "loss_rel": abs(float(m["loss"]) - ref_loss) / abs(ref_loss),
                "grad_rel": max(g_err), "mu_rel": max(m_err),
                "grad_median": float(np.median(g_err)),
                "leaves": len(g_err), "step_s": step_s,
                "routes": routes.line(),
                "local_gb": sum(t.numel() * t.element_size()
                                for t in tree_leaves(local)) / 1e9,
                "peak_gb": torch.cuda.max_memory_allocated(dev) / 1e9}
        del local, model, state, rec, m
        torch.distributed.barrier()
    out["launches"] = total
    out["s"] = time.perf_counter() - t_part
    return out


def _p16_against_plain(rank: int, cfg, b: int, seq: int) -> dict:
    """(c): ``cfg`` on (1, PAR_CARDS), each card drawing its own shards;
    every rank's gradients of one loss through the kernels against the
    same through the plain versions on the same cards (no launch), per
    local leaf over the leaf's largest entry, and the loss."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.parallel import ShardedModel
    dev = _p11_dev(rank)
    t_part = time.perf_counter()
    model = ShardedModel(cfg, make_mesh(1, PAR_CARDS), dev)
    params = model.init_local(2000)
    batch = _p16_batch(cfg, b, seq, dev)
    (lk, gk, ck), (lp, gp, cp), routes = kernels_and_plain(model, params,
                                                           batch)
    want = launches_per_train_step(cfg, seq)
    if ck != want or any(cp.values()):
        raise RuntimeError(f"rank {rank}: launches with kernels {ck} != "
                           f"{want}, plain {cp}")
    errs = leaf_errors(gk, gp)
    return {"loss": [lk, lp], "loss_rel": abs(lk - lp) / abs(lp),
            "grad_rel": max(errs), "grad_median": float(np.median(errs)),
            "leaves": len(errs), "launches": ck, "routes": routes.line(),
            "local_gb": sum(t.numel() * t.element_size()
                            for t in tree_leaves(params)) / 1e9,
            "peak_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
            "s": time.perf_counter() - t_part}


def _p16_train_whole(rank: int, cfg, b: int, seq: int) -> dict:
    """(d), (e): ``cfg`` on (1, PAR_CARDS), each card drawing its own
    shards, trained by make_train_step (AdamW, remat) on B ``b`` x
    ``seq``: one warm-up step, P16_STEPS timed steps, each with its
    launches checked exactly, then one traced on rank 0 (its collectives
    counted: kind, group, bytes). Returns the times, losses, peak and
    launches of this rank, and rank 0's trace."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.parallel import ShardedModel
    dev = _p11_dev(rank)
    t_part = time.perf_counter()
    model = ShardedModel(cfg, make_mesh(1, PAR_CARDS), dev)
    t0 = time.perf_counter()
    params = model.init_local(1000)
    opt = AdamW(lr=TRAIN_LR)
    state = opt.init(params)
    torch.cuda.synchronize()
    out = {"init_s": time.perf_counter() - t0,
           "local_gb": sum(t.numel() * t.element_size()
                           for t in tree_leaves(params)) / 1e9}
    step = make_train_step(model, opt)
    data = batches(cfg, b, seq, seed=0)     # the same rows on every rank
    want = launches_per_train_step(cfg, seq)
    total = dict.fromkeys(TRAIN_COUNTERS, 0)
    losses, step_s = [], []
    torch.cuda.reset_peak_memory_stats(dev)
    for i in range(2 + P16_STEPS):
        batch = batch_on(next(data), dev)
        traced = i == 1 + P16_STEPS
        torch.distributed.barrier()
        torch.cuda.synchronize()
        train_counts(reset=True)
        model.par.stats.reset()
        prof = profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) \
            if traced and rank == 0 else contextlib.nullcontext()
        with prof:
            t = time.perf_counter()
            params, state, m = step(params, state, batch)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
        losses.append(float(m["loss"]))
        if 0 < i <= P16_STEPS:
            step_s.append(wall)
        got = train_counts()
        if got != want:
            raise RuntimeError(f"rank {rank} step {i}: launches {got} != "
                               f"{want}")
        add_counts(total, got)
    out.update(step_s=step_s, losses=losses, launches=total, want=want,
               peak_gb=torch.cuda.max_memory_allocated(dev) / 1e9,
               collectives={f"{k}/{n}": [c, nb] for (k, n), (c, nb)
                            in model.par.stats.by_kind.items()})
    if rank == 0:
        out["trace"] = _trace_summary(prof, wall * 1e3)
    del params, state, model
    out["s"] = time.perf_counter() - t_part
    return out


def p16_configs() -> dict:
    """Phase 16's configs by part, remat on: (a) granite-moe whole and
    (b) pixtral-12b cut to P16_PIXTRAL_CUT layers, (c) DeepSeek 1 + 1
    with MTP, drop-free, f32; (d) pixtral-12b whole, f32; (e) DeepSeek
    1 + 1 under the dry-run's training policy, and (e32) the same in
    f32, which the dry-run only traces."""
    from repro_torch.launch.shapes import ShapeSpec, dryrun_config
    pix = get_arch("pixtral-12b")
    ds = deepseek_cut(*PAR_DEEPSEEK_CUT)
    cut = dataclasses.replace(pix, name=f"{pix.name}-{P16_PIXTRAL_CUT}L",
                              segments=dense_segments(P16_PIXTRAL_CUT))
    _, _, b_e, seq_e = P16_WHOLE[1]
    policy = dryrun_config(ds, ShapeSpec("train", "train", seq_e, b_e),
                           1)[0]
    return {k: dataclasses.replace(cfg, remat=True) for k, cfg in {
        "a": drop_free(get_arch("granite-moe-1b-a400m")), "b": cut,
        "c": drop_free(ds), "d": pix, "e": policy,
        "e32": dataclasses.replace(policy, param_dtype="float32",
                                   compute_dtype="float32")}.items()}


def _p16_parts(rank: int) -> dict:
    """The parts of phase 16 a rank runs, in order; a card's memory is
    freed between them."""
    cfgs = p16_configs()
    runs = {part: functools.partial(_p16_against_one_card, rank, cfgs[part],
                                    PAR_MESHES, b, seq)
            for part, _, b, seq in P16_AGAINST}
    runs["c"] = functools.partial(_p16_against_plain, rank, cfgs["c"],
                                  *P16_DEEPSEEK_GRAD)
    for part, _, b, seq in P16_WHOLE:
        runs[part] = functools.partial(_p16_train_whole, rank, cfgs[part], b,
                                       seq)
    res: dict = {}
    for part, run in runs.items():
        res[part] = run()
        gc.collect()
        torch.cuda.empty_cache()
    return res


def train_on_four_cards() -> dict:
    """Phase 16: PAR_CARDS ranks spawned, one a card (NCCL over a
    FileStore under build/), running P16_AGAINST's (a) and (b), (c), then
    P16_WHOLE's (d) and (e) in turn; the port's dry-run of (d), (e) and
    (e) in f32 runs beside them on the host. Logs every part, fails at the end if any
    part missed its bar; returns the ranks' launches over the sharded
    steps, summed."""
    cfgs = p16_configs()
    whole = {part: (cfgs[part], b, seq) for part, _, b, seq in P16_WHOLE}
    dry = DryRun([(cfg, train_shape(cfg, b, seq), (1, PAR_CARDS), 0)
                  for cfg, b, seq in (whole["d"], whole["e"],
                                      (cfgs["e32"],) + whole["e"][1:])])
    try:
        res = _spawn_ranks(16)
        peaks = [dry.gb(i) for i in range(3)]
    finally:
        dry.close()
    failed = []
    for part, arch, b, seq in P16_AGAINST:
        x0 = res[0][part]
        label = (f"{cfgs[part].name} ({x0['params']} parameters), f32"
                 f"{', drop-free' if cfgs[part].num_experts else ''}, B {b}"
                 f" x {seq} tokens"
                 + (f" + {cfgs[part].num_image_tokens} stub patches"
                    if cfgs[part].num_image_tokens else ""))
        for mesh, m in x0["meshes"].items():
            log(f"  ({part}) {label} on ({mesh.replace('x', ', ')}), one "
                f"make_train_step with AdamW against one card: loss "
                f"{m['loss'][0]:.6f} vs {m['loss'][1]:.6f} "
                f"({m['loss_rel']:.3e}); {m['leaves']} leaves made whole, "
                f"worst gradient {m['grad_rel']:.3e} (median "
                f"{m['grad_median']:.3e}) and first moment "
                f"{m['mu_rel']:.3e} of the leaf's largest entry (bar "
                f"{STEP_REL}); the sharded step {m['step_s']:.2f} s; "
                + (f"{m['routes']} on rank 0; " if m["routes"] else "")
                + f"{m['local_gb']:.2f} GB of shards a card, peak "
                f"{m['peak_gb']:.2f} GB on rank 0")
            if not max(m["loss_rel"], m["grad_rel"], m["mu_rel"]) <= \
                    STEP_REL:
                failed.append(f"({part}) {mesh}: {m}")
        log(f"  ({part}) launches a rank over its sharded steps, each "
            f"exact: {[x[part]['launches'] for x in res]}; "
            f"{x0['s']:.1f} s in all")
    b, seq = P16_DEEPSEEK_GRAD
    c = [x["c"] for x in res]
    worst = [f"{x['grad_rel']:.3e}" for x in c]
    log(f"  (c) {cfgs['c'].name} with MTP, f32, drop-free, on (1, "
        f"{PAR_CARDS}), B {b} x {seq}: each rank's gradients through the "
        f"kernels ({c[0]['launches']}, exact) against the plain versions "
        f"on the same cards (no launch): worst leaf a rank {worst} of its "
        f"largest entry (bar {STEP_REL}), loss {c[0]['loss'][0]:.6f} vs "
        f"{c[0]['loss'][1]:.6f}; {c[0]['routes']} on rank 0; "
        f"{c[0]['local_gb']:.2f} GB of shards a card, peak "
        f"{[round(x['peak_gb'], 2) for x in c]} GB; {c[0]['s']:.1f} s")
    for x in c:
        if not max(x["loss_rel"], x["grad_rel"]) <= STEP_REL:
            failed.append(f"(c): {x}")
    notes = {"d": "", "e": (f"; f32 is not run: under this policy's f32 "
                            f"twin the dry-run reckons {peaks[2]:.2f} GB a "
                            f"card")}
    for i, (part, arch, b, seq) in enumerate(P16_WHOLE):
        failed += _p16_report_whole(part, cfgs[part], b, seq,
                                    [x[part] for x in res], peaks[i],
                                    notes[part])
    if failed:
        raise RuntimeError("phase 16 failed: " + "; ".join(failed))
    total = dict.fromkeys(TRAIN_COUNTERS, 0)
    for x in res:
        for part in "abcde":
            add_counts(total, x[part]["launches"])
    return total


def _p16_report_whole(part: str, cfg, b: int, seq: int, rows: list,
                      dry_gb: float, note: str) -> list:
    """Log (d) or (e) and return what failed: the losses finite and
    falling on every rank, the same on every rank."""
    x0 = rows[0]
    ms = float(np.mean(x0["step_s"])) * 1e3
    tokens = b * seq
    pos = positions(cfg, b, seq)
    n = cfg.active_param_count()
    log(f"  ({part}) {cfg.name}, {cfg.num_layers} layers, "
        f"{str(cfg.pdtype)[6:]} parameters and {str(cfg.cdtype)[6:]} "
        f"compute, remat, on (1, {PAR_CARDS}), B {b} x {seq} tokens"
        + (f" + {cfg.num_image_tokens} stub patches" if cfg.num_image_tokens
           else "")
        + (f", capacity factor {cfg.capacity_factor}" if cfg.num_experts
           else "")
        + f": {cfg.param_count()} parameters, {x0['local_gb']:.2f} GB of "
        f"shards a card (drawn in {x0['init_s']:.1f} s); {P16_STEPS} timed "
        f"steps after 1 warm-up {ms:.1f} ms a step (min "
        f"{min(x0['step_s']) * 1e3:.1f}, max {max(x0['step_s']) * 1e3:.1f}),"
        f" {tokens / (ms / 1e3):.1f} tokens/s, "
        f"{6 * n * pos / (ms / 1e3) / 1e12:.1f} TFLOP/s of 6 N T over the "
        f"{PAR_CARDS} cards (N {n}, T {pos}); {x0['s']:.1f} s in all")
    log(f"  ({part}) peak device memory a card "
        f"(torch.cuda.max_memory_allocated): "
        f"{[round(x['peak_gb'], 2) for x in rows]} GB; the dry-run's "
        f"{dry_gb:.2f} GB{note}")
    for rank, x in enumerate(rows):
        log(f"  ({part}) rank {rank} launches {x['launches']}, "
            f"{x['want']} a step, exact in every step")
    log(f"  ({part}) collectives of one step on rank 0 [calls, bytes]: "
        f"{x0['collectives']}")
    _log_trace(part, x0["trace"])
    losses = x0["losses"]
    log(f"  ({part}) losses {[round(v, 4) for v in losses]}")
    failed = []
    if any(x["losses"] != losses for x in rows):
        failed.append(f"({part}): the ranks' losses differ")
    if not all(np.isfinite(losses)) or not np.mean(losses[-3:]) < losses[0]:
        failed.append(f"({part}): training did not lower the loss: {losses}")
    return failed


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA GPU; this script runs the "
              "port on the card", file=sys.stderr)
        return 2
    # the plain versions and the model's matmuls run in full f32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    smi = nvidia_smi()
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")

    log("[1] build kernels")
    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.load()
    log(f"  {lib_path.relative_to(ROOT)} in "
        f"{time.perf_counter() - t0:.1f} s")
    for line in _build.build_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log("  ptxas " + line.strip())

    log("[2] kernels against their plain versions")
    gen = torch.Generator(device="cuda").manual_seed(0)
    check_rmsnorm(gen)
    check_flash(gen)
    check_flash_against_f64()
    check_decode(gen)
    check_mamba(gen)
    check_flash_bwd(gen)
    check_mamba_bwd(gen)
    records = time_kernels(gen)
    bwd_record = time_flash_bwd(gen)     # its launches come from phase 10
    scan_bwd_record = time_mamba_bwd(gen)    # ... and from phase 13
    time_launch_path(gen)
    time_decode_launch_path(gen)
    sweep_decode_splits(gen)
    time_family_shapes(gen)

    # phases 3-9 serve, prefill and decode: none may launch a backward
    launches_before_training = bwd_counts()
    log("[3] forward and decode against the CPU path; full-width stages, "
        "profile")
    check_forward_against_cpu()
    check_decode_against_cpu()
    stages, store = build_and_profile()

    log("[4] serve the cascade")
    launches = serve(stages, store)
    log("[4b] plan the cascade from the measured profile, serve the plan")
    planned, plan_config = plan_and_serve(stages, store)
    log("[4c] serve each stage alone on its planned configuration")
    alone = serve_each_alone(stages, store, plan_config)
    log("[4d] close the loop: the ClosedLoopTuner scales the planned "
        "cascade through the 3x spike; its co-simulated twin beside it")
    warm_slots(stages)
    tuned = close_the_loop(stages, store, plan_config)
    log("[4e] what a replica adds on one card")
    replicas_on_one_card(stages)
    for arch in STAGES:
        stages[arch].pool.keep(1)
    gc.collect()
    torch.cuda.empty_cache()
    log("[4f] the process backend on this card: a worker against this "
        "process's stage; the plan served from worker processes while a "
        "FaultSchedule SIGKILLs them, beside the twin")
    log(f"  replica slots past the first freed: "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated, "
        f"{torch.cuda.memory_reserved() / 1e9:.2f} GB reserved")
    worker_matches_the_parent(stages)
    proc_launches = processes_under_faults(stages, store, plan_config)
    if torch.cuda.device_count() >= GPU_CARDS:
        log(f"[4g] {torch.cuda.device_count()} cards: worker processes one "
            f"a card")
        processes_on_their_own_cards(stages)
        four = spike_on_four_cards(stages, store, plan_config)
        proc_launches = {k: n + four[k] for k, n in proc_launches.items()}
    else:
        log(f"[4g] not run: it places one worker a card on {GPU_CARDS} "
            f"cards, and torch sees {torch.cuda.device_count()}")
    log("[5] trace one replay per stage")
    trace(stages, store)
    log("[6] full-width llama3.2-1b: prefill and greedy decode")
    llama = stages["llama3.2-1b"]
    _, decode_launches, _ = decode_and_check(llama.model, llama.params,
                                             STEPS)
    del stages, store, llama
    gc.collect()
    torch.cuda.empty_cache()
    log(f"  the cascade's graphs and weights freed: "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated, "
        f"{torch.cuda.memory_reserved() / 1e9:.2f} GB reserved")
    log("[7] full-width expert-free one-period Jamba-1.5-Large: prefill, "
        "greedy decode, stage latency")
    hybrid_pre, hybrid_steps = hybrid_full_width()
    gc.collect()
    torch.cuda.empty_cache()
    log("[8] the remaining decoder-only families at published widths "
        f"(the hybrid freed: {torch.cuda.memory_allocated() / 1e9:.2f} GB "
        f"allocated)")
    log("[8a] granite-moe-1b-a400m and phi3-mini-3.8b as served stages")
    family = family_stages()
    log("[8b] deepseek-v3-671b, its first dense layer and one MoE layer")
    add_counts(family, deepseek_two_layers())
    log("[8c] granite-34b and qwen2-72b cut in depth")
    add_counts(family, depth_cuts())
    # each kernel's launches come from the path that runs it: the serves
    # of the cascade's stages (4-4d; 4f-4g in the worker processes), the
    # llama decode, the hybrid, and phase 8's serves, prefills and steps
    for name in launches:
        launches[name] += planned[name] + alone[name] + tuned[name] + \
            proc_launches[name]
    launches["decode_attention"] = decode_launches["decode_attention"]
    launches["mamba_scan"] = hybrid_pre["mamba_scan"] + \
        hybrid_steps["mamba_scan"]
    add_counts(launches, family)    # phase 8: serves, prefills, steps
    for r in records:
        r["launches"] = launches[r["name"]]
    log(f"[9] the planner's device sweep ({nvidia_smi()})")
    records.extend(planner_sweep())
    if bwd_counts() != launches_before_training:
        raise RuntimeError("a served path launched a backward kernel")
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[10] train full-width {TRAIN_ARCH} on one card "
        f"({torch.cuda.memory_allocated() / 1e9:.2f} GB allocated before; "
        f"{nvidia_smi()})")
    trained = train_full_width(
        dataclasses.replace(get_arch(TRAIN_ARCH), remat=True),
        dataclasses.replace(get_smoke(TRAIN_ARCH), remat=True),
        TRAIN_BATCH, TRAIN_SEQ)
    records.extend([bwd_record, scan_bwd_record])
    for r in records:
        if r["name"] in trained:
            r["launches"] += trained[r["name"]]
    gc.collect()
    torch.cuda.empty_cache()
    if torch.cuda.device_count() >= PAR_CARDS:
        log(f"[11] sharded serving on {PAR_CARDS} cards over NCCL "
            f"({nvidia_smi()})")
        sharded = sharded_on_four_cards()
        for r in records:
            r["launches"] += sharded.get(r["name"], 0)
    else:
        log(f"[11] not run: it shards over {PAR_CARDS} cards, and torch "
            f"sees {torch.cuda.device_count()}")
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[12] xlstm-125m, whisper-small and pixtral-12b at published "
        f"width ({torch.cuda.memory_allocated() / 1e9:.2f} GB allocated "
        f"before; {nvidia_smi()})")
    before_decoding = bwd_counts()
    for name, n in families_of_the_slice().items():
        for r in records:
            if r["name"] == name:
                r["launches"] += n
    if bwd_counts() != before_decoding:
        raise RuntimeError("phase 12 launched a backward kernel")
    gc.collect()
    torch.cuda.empty_cache()
    cut = hybrid_train_cut()
    log(f"[13] train the expert-free Jamba-1.5-Large at published width, "
        f"blocks {list(HYBRID_TRAIN_BLOCKS)} of its period "
        f"({', '.join(b.kind for b in cut.segments[0].blocks)}), on one "
        f"card ({torch.cuda.memory_allocated() / 1e9:.2f} GB allocated "
        f"before; {nvidia_smi()})")
    for name, n in train_the_hybrid().items():
        for r in records:
            if r["name"] == name:
                r["launches"] += n
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[14] the examples on the card, each its own process "
        f"({torch.cuda.memory_allocated() / 1e9:.2f} GB allocated in this "
        f"one; {nvidia_smi()})")
    examples_on_the_card()
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[15] train granite-moe-1b-a400m and whisper-small at published "
        f"width on one card ({torch.cuda.memory_allocated() / 1e9:.2f} GB "
        f"allocated before; {nvidia_smi()})")
    families = train_the_families()
    if torch.cuda.device_count() >= PAR_CARDS:
        log(f"[16] training sharded on {PAR_CARDS} cards over NCCL "
            f"({nvidia_smi()})")
        add_counts(families, train_on_four_cards())
    else:
        log(f"[16] not run: it trains over {PAR_CARDS} cards, and torch "
            f"sees {torch.cuda.device_count()}")
    for r in records:
        r["launches"] += families.get(r["name"], 0)
    if not all(r["launches"] > 0 for r in records):
        raise RuntimeError(f"a kernel was not launched: "
                           f"{[(r['name'], r['launches']) for r in records]}")
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": records}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
