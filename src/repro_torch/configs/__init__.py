# The port's run configuration (TrainConfig).
from repro_torch.configs.base import TrainConfig

__all__ = ["TrainConfig"]
