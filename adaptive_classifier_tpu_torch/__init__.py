"""PyTorch/CUDA port of adaptive_classifier_tpu.

Loads, builds and grows an adaptive classifier and answers ``predict_batch``
on an NVIDIA GPU, with hand-written CUDA kernels for attention, the
prototype search and the int8 encoder's products.  Imports torch and numpy
only; kernels build with nvcc on first use.  ``launch_counts`` counts each
kernel's launches (``reset_launch_counts`` zeroes them).
"""

from .classifier import AdaptiveClassifier
from .config import Example, ModelConfig
from .ops import launch_counts, reset_launch_counts

__all__ = ["AdaptiveClassifier", "Example", "ModelConfig", "launch_counts",
           "reset_launch_counts"]
