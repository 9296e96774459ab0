from repro_torch.models.config import ArchConfig, Block, Segment  # noqa: F401
from repro_torch.models.model import Model, build_model  # noqa: F401
