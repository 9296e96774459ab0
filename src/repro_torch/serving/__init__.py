from repro_torch.serving.cluster import LiveClusterSim, LiveRunResult  # noqa: F401
from repro_torch.serving.dataplane import (  # noqa: F401
    DataplaneStats,
    SlotOverflow,
    decode_batch,
    encode_batch,
)
from repro_torch.serving.executor import PipelineExecutor  # noqa: F401
from repro_torch.serving.frontends import FRONTENDS, Frontend  # noqa: F401
from repro_torch.serving.ingress import (  # noqa: F401
    AsyncIngress,
    IngressStats,
    PayloadRing,
)
from repro_torch.serving.loop import LiveControlLoop, LiveLoopResult  # noqa: F401
from repro_torch.serving.procpool import (  # noqa: F401
    ProcessReplicaPool,
    ProcReplica,
    ReplicaDead,
    StageWorkerError,
    register_worker_fn,
    resolve_worker_fn,
)
from repro_torch.serving.stage import (  # noqa: F401
    SEQ,
    ProcessStage,
    ServedStage,
    make_stage,
    worker_counts,
)
