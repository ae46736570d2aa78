"""nubomedia_vca_tpu_torch — the PyTorch/CUDA port of nubomedia_vca_tpu.

The face-detection main path, the part chain (nose, mouth, eyes, and the
ear with its profile pass over normal and flipped frames), the motion
tracker, the overlay drawing and the learned face detector's serving path
(bf16 and int8) of the JAX package, in PyTorch, for an NVIDIA H100: exact
resize → equalizeHist → multiscale Haar cascade (tilted features included)
→ minNeighbors grouping → track-ID association or per-face part
assignment and temporal merges; MHI update → seeded connected components →
blob merge; or letterbox → conv net → decode → NMS → track ids. The TPU
kernels on those paths are hand-written CUDA C++ kernels for ``sm_90a``
(``csrc/``: the pyramid dense phase of all levels, wide levels in bands;
the tilted dense phase of one level, as a table pass and a tiled
evaluation; the integral tables; the dynamic int8 quantizers), built with
``nvcc`` at first use; on CPU tensors every op runs its plain PyTorch
version. The tracker, drawing and color ops are plain PyTorch. The serving
plane serves them: Kurento-named remote objects in a ``MediaPipeline``, a
media loop fed raw frames over TCP by a native ingest, and a JSON-RPC
WebSocket server whose IDL and generated clients are the JAX package's.

The package never imports ``jax`` or ``nubomedia_vca_tpu``; host code it
needs from the JAX package is copied, module name for module name. Entry
points run on the card unless the caller asks for another device, and
importing the package changes no global torch state.

Layout:
  cascade/   cascade-XML loader, pyramid geometry, the detection engine
  core/      fixed-capacity box sets, frame batches
  ops/       resize, histogram, integral, grouping, quant, color, drawing
             (+ cuda/ kernel wrappers)
  csrc/      CUDA C++ kernel sources
  models/    face, part (nose, mouth, eye, ear) and learned (cnn, quant,
             cnn_parts) detectors, the motion tracker, GOP/event-gate
             scheduling
  api/       remote objects, media loop, JSON-RPC server, IDL, client
             generator, frame rendering
  pipeline/  detection events, the filter graph, the stream feeder
  cpp/       the native ingest (C++ source, built with g++ at first use)
  assets/    bundled cascades and the CNN checkpoints
  utils/     cv2-free synthetic frames (faces, profile heads, moving
             blobs), knobs, logging, tracing
  cli.py     ``python -m nubomedia_vca_tpu_torch <filter> ...``
"""

__version__ = "0.2.0"
