"""Motion segmentation's connected components on the card: the labels of
one frame's motion-history image in ``csrc/motion_ccl.cu``, block-based
union-find in three launches (a 32x32 tile a block, then the pixel pairs
across tile borders, then each pixel's root), with no host read.

Replaces no TPU kernel: the JAX package labels the components with a
``lax.while_loop`` of min-label propagation and pointer jumping. That
loop stays in the port as ``models/tracker._propagate``, the plain
version and the route of CPU tensors; this kernel gives its labels bit
for bit: a non-zero-MHI pixel is labelled with the raster index of its
component's first pixel in the 4-neighbour graph whose links join two
non-zero MHI values within ``seg_thresh`` of each other (difference and
comparison in float32), nothing links across the frame's edges, and a
zero-MHI pixel is its own label.

``motion_ccl`` takes CUDA tensors only and raises for any other, or when
the library cannot be built; it never falls back. Each call counts three
launches in ``motion_ccl.launches`` and, while tracing, one frame in
``vca.tracker.ccl_frames``.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ...utils.tracing import count
from . import _build
from .dense_cuda import device_index

# the kernel's tile side (kTile in csrc/motion_ccl.cu): a block of pass 1
# labels a TILE x TILE piece of the frame
TILE = 32
LAUNCHES = 3            # a frame: tiles, borders, flatten
INT32_LIMIT = 2 ** 31   # pixels a frame, below which int32 labels hold


def _check(mhi: torch.Tensor) -> None:
    if mhi.dtype != torch.float32 or mhi.ndim != 2 or not mhi.is_contiguous():
        raise ValueError("the MHI must be a contiguous [H, W] float32 tensor")
    if mhi.numel() == 0 or mhi.numel() >= INT32_LIMIT:
        raise ValueError(f"1 to {INT32_LIMIT - 1} pixels a frame, got "
                         f"{tuple(mhi.shape)}")


_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.cache
def _library() -> ctypes.CDLL:
    lib = _build.load_library("motion_ccl")
    lib.motion_ccl_launch.argtypes = [
        _I, _P,                      # device, stream
        _P, _I, _I, ctypes.c_float,  # mhi, h, w, thr
        _P, _P,                      # parent (scratch), labels
    ]
    lib.motion_ccl_launch.restype = ctypes.c_int
    lib.motion_ccl_error_string.argtypes = [ctypes.c_int]
    lib.motion_ccl_error_string.restype = ctypes.c_char_p
    return lib


def load() -> None:
    """Build and load the kernel's library now (a tracker on a card does
    so when it is built, so that no frame builds it)."""
    _library()


def motion_ccl(mhi: torch.Tensor, seg_thresh: float) -> torch.Tensor:
    """[H, W] float32 MHI on a card → [H*W] int64 component labels (see
    the module docstring), launched on the current stream."""
    if mhi.device.type != "cuda":
        raise ValueError(f"no motion labelling kernel for {mhi.device}")
    _check(mhi)
    H, W = mhi.shape
    dev = mhi.device
    parent = torch.empty(H * W, dtype=torch.int32, device=dev)
    labels = torch.empty(H * W, dtype=torch.int64, device=dev)
    idx = device_index(dev)
    lib = _library()
    rc = lib.motion_ccl_launch(
        idx, torch.cuda.current_stream(dev).cuda_stream, mhi.data_ptr(), H,
        W, float(np.float32(seg_thresh)), parent.data_ptr(),
        labels.data_ptr())
    if rc != 0:
        msg = lib.motion_ccl_error_string(rc).decode()
        raise RuntimeError(f"motion_ccl kernel launch failed: {msg} ({rc})")
    motion_ccl.launches += LAUNCHES
    count("vca.tracker.ccl_frames")
    return labels


motion_ccl.launches = 0
