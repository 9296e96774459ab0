"""The paper's four pipeline motifs (Fig. 2) bound to assigned archs.

A copy of the reference's ``repro.configs.pipelines``: the same stages,
edges, hardware menus and analytic latency tables, so the Planner and the
device sweep run on the reference's own workloads.

Each motif is a Pipeline whose stages reference assigned architectures;
per-stage ModelSpecs are derived analytically from the ArchConfig (FLOPs /
weight bytes / activation and TP-collective traffic per query), so the
Profiler's analytic backend prices each (model, hardware, batch) point
without hardware. A "query" at a stage is one inference at that stage's
native input size (`seq_in` tokens scored, classification-style).

Hardware menus are capacity-filtered: a model only lists accelerator
slices whose aggregate HBM holds its bf16 weights (the planner's §9
total-latency-ordering assumption still holds on the filtered menu).
The filter runs over the reference's entries only
(``hardware.ANALYTIC_MENU``): the port's menu also holds ``h100-1``,
which the analytic backend does not price, so a motif never lists it.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.configs import get_arch
from repro_torch.core.hardware import ANALYTIC_MENU, HBM_BYTES, get_hardware
from repro_torch.core.pipeline import SOURCE, Edge, Pipeline, Stage
from repro_torch.core.profiler import (
    ModelSpec,
    ProfileStore,
    profile_model_analytic,
)

BYTES_PER_PARAM = 2  # bf16 serving


def arch_model_spec(arch_id: str, seq_in: int,
                    name: Optional[str] = None) -> ModelSpec:
    """Analytic per-query workload description for one assigned arch."""
    cfg = get_arch(arch_id)
    flops = cfg.flops_per_token(seq_in) * seq_in
    weight_bytes = cfg.active_param_count() * BYTES_PER_PARAM
    act_bytes = 4 * seq_in * cfg.d_model * BYTES_PER_PARAM
    # TP traffic: 2 all-reduces per layer of the (seq, d_model) activation
    coll = 2 * cfg.num_layers * seq_in * cfg.d_model * BYTES_PER_PARAM
    return ModelSpec(
        name or arch_id,
        flops_per_query=float(flops),
        weight_bytes=float(weight_bytes),
        act_bytes_per_query=float(act_bytes),
        collective_bytes_per_query=float(coll),
    )


def transform_spec(name: str, flops: float = 2e9) -> ModelSpec:
    """Non-parallelizable basic data transform (paper Fig. 3 preprocess)."""
    return ModelSpec(name, flops_per_query=flops, weight_bytes=1e6,
                     act_bytes_per_query=1e6, parallelizable=False)


def _resident_bytes(arch_id: str) -> float:
    """All weights must be HBM-resident to serve (not just active)."""
    return get_arch(arch_id).param_count() * BYTES_PER_PARAM


def hardware_menu_for(spec: ModelSpec,
                      resident_bytes: Optional[float] = None
                      ) -> Tuple[str, ...]:
    """Capacity-filtered hardware options for one model."""
    if not spec.parallelizable:
        return ("cpu-1",)
    need = resident_bytes if resident_bytes is not None else \
        spec.weight_bytes
    out = []
    for h in map(get_hardware, ANALYTIC_MENU):
        if h.chips == 0:
            out.append(h.name)            # host DRAM holds anything
        elif need <= 0.9 * h.chips * HBM_BYTES:
            out.append(h.name)
    return tuple(out)


@dataclasses.dataclass
class BoundPipeline:
    pipeline: Pipeline
    profiles: ProfileStore


def _build(name: str,
           stages: Sequence[Tuple[str, ModelSpec, Optional[float]]],
           edges: List[Edge]) -> BoundPipeline:
    """stages: (stage_name, spec, resident_bytes or None)."""
    store = ProfileStore()
    st: Dict[str, Stage] = {}
    for sname, spec, resident in stages:
        menu = hardware_menu_for(spec, resident)
        store.add(profile_model_analytic(spec, hardware_options=menu))
        st[sname] = Stage(sname, spec.name, menu)
    return BoundPipeline(Pipeline(name, st, edges), store)


# ---------------------------------------------------------------- motifs

def image_processing() -> BoundPipeline:
    """preprocess -> VLM classification (Fig. 2a)."""
    prep = transform_spec("preprocess")
    cls = arch_model_spec("pixtral-12b", seq_in=1024 + 16, name="classify")
    return _build(
        "image-processing",
        [("preprocess", prep, None),
         ("classify", cls, _resident_bytes("pixtral-12b"))],
        [Edge(SOURCE, "preprocess"), Edge("preprocess", "classify")],
    )


def video_monitoring() -> BoundPipeline:
    """detect -> {vehicle, person(+audio transcribe)} conditionals
    (Fig. 2b, inspired by VideoStorm)."""
    detect = arch_model_spec("pixtral-12b", seq_in=1024 + 16, name="detect")
    vehicle = arch_model_spec("llama3.2-1b", seq_in=256, name="vehicle_id")
    person = arch_model_spec("phi3-mini-3.8b", seq_in=256, name="person_id")
    plate = arch_model_spec("granite-moe-1b-a400m", seq_in=128,
                            name="plate_ocr")
    audio = arch_model_spec("whisper-small", seq_in=448, name="transcribe")
    return _build(
        "video-monitoring",
        [("detect", detect, _resident_bytes("pixtral-12b")),
         ("vehicle_id", vehicle, _resident_bytes("llama3.2-1b")),
         ("person_id", person, _resident_bytes("phi3-mini-3.8b")),
         ("plate_ocr", plate, _resident_bytes("granite-moe-1b-a400m")),
         ("transcribe", audio, _resident_bytes("whisper-small"))],
        [Edge(SOURCE, "detect"),
         Edge(SOURCE, "transcribe"),
         Edge("detect", "vehicle_id", probability=0.4),
         Edge("detect", "person_id", probability=0.3),
         Edge("vehicle_id", "plate_ocr", probability=0.5)],
    )


def social_media() -> BoundPipeline:
    """lang-id -> (translate?) -> categorize, + image branch (Fig. 2c)."""
    lang = arch_model_spec("xlstm-125m", seq_in=128, name="lang_id")
    translate = arch_model_spec("qwen2-72b", seq_in=256, name="translate")
    img = arch_model_spec("pixtral-12b", seq_in=1024 + 16, name="img_cls")
    cat = arch_model_spec("llama3.2-1b", seq_in=256, name="categorize")
    return _build(
        "social-media",
        [("lang_id", lang, _resident_bytes("xlstm-125m")),
         ("translate", translate, _resident_bytes("qwen2-72b")),
         ("img_cls", img, _resident_bytes("pixtral-12b")),
         ("categorize", cat, _resident_bytes("llama3.2-1b"))],
        [Edge(SOURCE, "lang_id"),
         Edge(SOURCE, "img_cls", probability=0.5),
         Edge("lang_id", "translate", probability=0.4),
         Edge("translate", "categorize"),
         Edge("lang_id", "categorize", probability=0.6),
         Edge("img_cls", "categorize")],
    )


def tf_cascade() -> BoundPipeline:
    """fast model -> slow model when uncertain (Fig. 2d)."""
    fast = arch_model_spec("llama3.2-1b", seq_in=256, name="fast")
    slow = arch_model_spec("granite-34b", seq_in=256, name="slow")
    return _build(
        "tf-cascade",
        [("fast", fast, _resident_bytes("llama3.2-1b")),
         ("slow", slow, _resident_bytes("granite-34b"))],
        [Edge(SOURCE, "fast"), Edge("fast", "slow", probability=0.2)],
    )


MOTIFS = {
    "image-processing": image_processing,
    "video-monitoring": video_monitoring,
    "social-media": social_media,
    "tf-cascade": tf_cascade,
}


def get_motif(name: str) -> BoundPipeline:
    try:
        return MOTIFS[name]()
    except KeyError:
        raise KeyError(f"unknown motif {name!r}; have {sorted(MOTIFS)}") \
            from None
