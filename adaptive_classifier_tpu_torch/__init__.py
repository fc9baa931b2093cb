"""PyTorch/CUDA port of adaptive_classifier_tpu.

Builds an adaptive classifier (ridge or MLP head), grows it with new
classes (EWC and distillation, or frozen probes after a lossy load), saves
and loads it, and answers ``predict_batch``, ``predict``, ``predict_proba``
(temperature-calibrated after ``calibrate``) and ``predict_document`` on an
NVIDIA GPU, with hand-written CUDA kernels for attention, the prototype
search and the int8 encoder's products.  Repeated texts are served from
embedding caches on the host and on the device.  ``BatchingClassifierServer``
and ``MultiTenantServer`` gather single requests from many callers into
device batches; ``MultiLabelAdaptiveClassifier`` gives each text several
labels.  Imports torch and numpy only; kernels build with nvcc on first
use.  ``launch_counts`` counts each kernel's launches
(``reset_launch_counts`` zeroes them).
"""

from .calibration import TemperatureScaler, expected_calibration_error
from .classifier import AdaptiveClassifier
from .config import Example, ModelConfig
from .memory import PrototypeMemory
from .models.head import AdaptiveHead, MultiLabelAdaptiveHead
from .multilabel import MultiLabelAdaptiveClassifier
from .ops import launch_counts, reset_launch_counts
from .serving import BatchingClassifierServer, MultiTenantServer

__all__ = ["AdaptiveClassifier", "MultiLabelAdaptiveClassifier", "MultiLabelAdaptiveHead",
           "AdaptiveHead", "Example", "ModelConfig", "PrototypeMemory",
           "BatchingClassifierServer", "MultiTenantServer", "TemperatureScaler",
           "expected_calibration_error", "launch_counts", "reset_launch_counts"]
