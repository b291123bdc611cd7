"""Hand-written CUDA kernels (sources under ../../csrc) and their wrappers.

Each wrapper launches its kernel on a CUDA tensor and uses the plain PyTorch
version beside it only for a tensor that lies on the CPU. Nothing here is
compiled or loaded at import.
"""

from .build import launch_counts, reset_launch_counts

__all__ = ["launch_counts", "reset_launch_counts"]
