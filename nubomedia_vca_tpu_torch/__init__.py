"""nubomedia_vca_tpu_torch — the PyTorch/CUDA port of nubomedia_vca_tpu.

The face-detection main path of the JAX package, in PyTorch, for an NVIDIA
H100: exact resize → equalizeHist → multiscale Haar cascade → minNeighbors
grouping → track-ID association. The one TPU kernel on that path (the
all-levels pyramid dense phase) is a hand-written CUDA C++ kernel for
``sm_90a`` (``csrc/pyramid_dense.cu``), built with ``nvcc`` at first use;
on CPU tensors every op runs its plain PyTorch version.

The package never imports ``jax`` or ``nubomedia_vca_tpu``; host code it
needs from the JAX package is copied, module name for module name. Every
function takes its device from its input tensors or an explicit ``device``
argument, and importing the package changes no global torch state.

Layout:
  cascade/   cascade-XML loader, pyramid geometry, the detection engine
  ops/       resize, histogram, integral, grouping (+ cuda/ kernel wrappers)
  csrc/      CUDA C++ kernel sources
  models/    face detector, GOP/event-gate scheduling
  utils/     cv2-free synthetic frames
"""

__version__ = "0.1.0"
