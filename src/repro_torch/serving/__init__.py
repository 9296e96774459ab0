from repro_torch.serving.executor import PipelineExecutor  # noqa: F401
from repro_torch.serving.stage import SEQ, ServedStage, make_stage  # noqa: F401
