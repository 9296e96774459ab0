from repro_torch.serving.executor import PipelineExecutor  # noqa: F401
from repro_torch.serving.frontends import FRONTENDS, Frontend  # noqa: F401
from repro_torch.serving.loop import LiveControlLoop, LiveLoopResult  # noqa: F401
from repro_torch.serving.stage import SEQ, ServedStage, make_stage  # noqa: F401
