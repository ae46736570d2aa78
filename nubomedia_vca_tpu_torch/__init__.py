"""nubomedia_vca_tpu_torch — the PyTorch/CUDA port of nubomedia_vca_tpu.

The face-detection main path, the part chain (nose, mouth, eyes) and the
learned face detector's serving path (bf16 and int8) of the JAX package,
in PyTorch, for an NVIDIA H100: exact resize → equalizeHist → multiscale
Haar cascade (tilted features included) → minNeighbors grouping → track-ID
association or per-face part assignment and temporal merges; or letterbox
→ conv net → decode → NMS → track ids. The TPU kernels on those paths are
hand-written CUDA C++ kernels for ``sm_90a`` (``csrc/``: the all-levels
pyramid dense phase, the tilted and row-strip dense phase of one level, the
integral tables, the dynamic int8 quantizers), built with ``nvcc`` at first
use; on CPU tensors every op runs its plain PyTorch version.

The package never imports ``jax`` or ``nubomedia_vca_tpu``; host code it
needs from the JAX package is copied, module name for module name. Entry
points run on the card unless the caller asks for another device, and
importing the package changes no global torch state.

Layout:
  cascade/   cascade-XML loader, pyramid geometry, the detection engine
  ops/       resize, histogram, integral, grouping, quant (+ cuda/ kernel
             wrappers)
  csrc/      CUDA C++ kernel sources
  models/    face, part and learned (cnn, quant) detectors, GOP/event-gate
             scheduling
  assets/    bundled cascades and the CNN checkpoint
  utils/     cv2-free synthetic frames
"""

__version__ = "0.2.0"
