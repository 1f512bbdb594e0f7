"""PyTorch/CUDA port of vision_assist_tpu for NVIDIA Hopper.

The JAX package ``vision_assist_tpu`` is the reference; this package keeps
its module layout so that each counterpart is easy to find, imports nothing
from it, and runs its entry points on ``device="cuda"`` unless the caller
asks for the CPU.
"""

__version__ = "0.1.0"

from vision_assist_tpu_torch.config import PipelineConfig, replay_config
from vision_assist_tpu_torch.types import Cell, Coordinate, FinalAnswer, Instruction, Peak

__all__ = [
    "PipelineConfig",
    "replay_config",
    "Cell",
    "Coordinate",
    "FinalAnswer",
    "Instruction",
    "Peak",
    "__version__",
]
