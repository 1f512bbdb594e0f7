from vision_assist_tpu_torch.semantics.sections import AnalysedPath, PathSection, build_path
from vision_assist_tpu_torch.semantics.analyser import InstructionEngine

__all__ = ["AnalysedPath", "PathSection", "build_path", "InstructionEngine"]
