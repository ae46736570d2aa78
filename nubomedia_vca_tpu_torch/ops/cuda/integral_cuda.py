"""Sum and squared-sum integral tables in one pass.

Port of the TPU kernel ``integral_images_pallas``
(``nubomedia_vca_tpu/ops/pallas/integral_pallas.py:52``). The tilted
dense phase (``dense_level_cuda.dense_level_tilted``) runs it first on
every level of a tilted cascade: its table pass. ``integral_tables``
launches ``csrc/integral_tables.cu`` for a CUDA tensor (or raises) and runs
the plain version, ``integral_image`` + ``sq_integral_image``, for a CPU
tensor.

The kernel cuts each frame into bands of ``band_rows(H, W)`` rows, one block
each, and carries the column sums down the bands by a decoupled look-back
(see the source). Its scratch — a ticket counter, one flag per band and
two vectors of 2 W words per band (the band's column aggregate and its
inclusive prefix) — belongs to a ``LookBackScratch`` per device and stream,
which the wrapper keeps and grows; a call tags its flags with a new epoch,
so the scratch is never cleared between calls.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..integral import integral_image, sq_integral_image
from . import _build
from .dense_cuda import MAX_SMEM_BYTES, device_index

# pixels per band: 16 rows at the part chain's 320-px width; narrower
# images take taller bands, so a small level is one band with no look-back
BAND_PIXELS = 16 * 320
_EPOCHS = 1 << 30    # flag word = epoch << 2 | state (csrc/integral_tables.cu)


def band_smem_bytes(rows: int, W: int) -> int:
    """Dynamic shared memory of a block with bands of `rows` rows: the
    in-band prefixes of both tables and the carries (rows padded to a
    multiple of 4 words), and the band's pixels."""
    pitch = -(-W // 4) * 4
    return 4 * (2 * rows * pitch + 2 * pitch) + rows * W


def band_rows(H: int, W: int) -> int:
    """Rows per band for an [H, W] image: about BAND_PIXELS pixels, at most
    H, at least 1, within one block's shared memory; raises ValueError when
    even one row does not fit."""
    rows = max(1, min(H, BAND_PIXELS // max(W, 1)))
    while rows > 1 and band_smem_bytes(rows, W) > MAX_SMEM_BYTES:
        rows -= 1
    if band_smem_bytes(rows, W) > MAX_SMEM_BYTES:
        raise ValueError(f"an image row of {W} pixels needs "
                         f"{band_smem_bytes(1, W)} B of shared memory > "
                         f"{MAX_SMEM_BYTES} B")
    return rows


@functools.cache
def band_geometry(H: int, W: int) -> tuple[int, int]:
    """(rows per band, bands per frame) of the kernel's launch."""
    rows = band_rows(H, W)
    return rows, max(1, -(-H // rows))


def integral_tables_reference(img: torch.Tensor):
    """[B,H,W] uint8 → (ii, sq) [B,H+1,W+1] int32, plain PyTorch."""
    return integral_image(img), sq_integral_image(img)


class LookBackScratch:
    """The look-back's device scratch on one device and stream: the ticket
    counter, the flags and the published vectors. ``take`` returns the
    launch arguments for a call of `n_slots` bands of width `W`, growing
    the buffers (zeroed) when they are too small; ``issued`` counts the
    tickets of the launches made, which the kernel subtracts."""

    def __init__(self, device: torch.device):
        self.device = device
        self.flags = None
        self.n_slots = self.n_words = 0
        self.issued = 0
        self.epoch = 0

    def take(self, n_slots: int, W: int) -> tuple:
        words = 2 * n_slots * max(W, 1)
        if n_slots > self.n_slots or words > self.n_words:
            ticket = torch.zeros(1, dtype=torch.int32, device=self.device)
            self.flags = torch.zeros(n_slots, dtype=torch.int32,
                                     device=self.device)
            vecs = torch.empty((2, words), dtype=torch.int32,
                               device=self.device)
            self._keep = (ticket, vecs)
            self._ptrs = (ticket.data_ptr(), self.flags.data_ptr(),
                          vecs[0].data_ptr(), vecs[1].data_ptr())
            self.n_slots, self.n_words = n_slots, words
            self.issued = self.epoch = 0
        self.epoch += 1
        if self.epoch == _EPOCHS:
            self.flags.zero_()
            self.epoch = 1
        ticket, flags, agg, incl = self._ptrs
        return ticket, self.issued, flags, agg, incl, self.epoch

    def launched(self, n_slots: int) -> None:
        self.issued = (self.issued + n_slots) % (1 << 32)


_SCRATCH: dict[tuple[int, int], LookBackScratch] = {}


def _scratch(dev: torch.device, stream: int) -> LookBackScratch:
    key = (device_index(dev), stream)
    s = _SCRATCH.get(key)
    if s is None:
        s = _SCRATCH[key] = LookBackScratch(torch.device("cuda", key[0]))
    return s


@functools.cache
def _library() -> ctypes.CDLL:
    lib = _build.load_library("integral_tables")
    P, I, U = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
    lib.integral_tables_launch.argtypes = [
        I, P,                   # device, stream
        P, I, I, I,             # img, B, H, W
        I, I, I, I,             # band_rows, n_bands, pitch, smem
        P, P,                   # ii_out, sq_out
        P, U, P, P, P, U,       # ticket, ticket_base, flags, agg, incl, epoch
    ]
    lib.integral_tables_launch.restype = ctypes.c_int
    lib.integral_tables_error_string.argtypes = [ctypes.c_int]
    lib.integral_tables_error_string.restype = ctypes.c_char_p
    return lib


def integral_tables(img: torch.Tensor):
    """[B,H,W] uint8 → (ii, sq) [B,H+1,W+1] int32 (squared sums wrap
    around). A CUDA tensor launches the kernel (counted in
    ``integral_tables.launches``) or raises."""
    if img.dtype != torch.uint8 or img.ndim != 3:
        raise TypeError(f"image must be [B,H,W] uint8, got {img.dtype} "
                        f"{tuple(img.shape)}")
    if not img.is_contiguous():
        raise ValueError("image must be contiguous")
    if img.device.type == "cpu":
        return integral_tables_reference(img)
    if img.device.type != "cuda":
        raise ValueError(f"no integral kernel for {img.device}")
    B, H, W = img.shape
    if B < 1:
        raise ValueError("no frame to launch on")
    rows, n_bands = band_geometry(H, W)
    lib = _library()
    dev = img.device
    stream = torch.cuda.current_stream(dev).cuda_stream
    scratch = _scratch(dev, stream)
    ii = torch.empty((B, H + 1, W + 1), dtype=torch.int32, device=dev)
    sq = torch.empty_like(ii)
    rc = lib.integral_tables_launch(
        device_index(dev), stream, img.data_ptr(), B, H, W, rows, n_bands,
        -(-W // 4) * 4, band_smem_bytes(rows, W), ii.data_ptr(),
        sq.data_ptr(), *scratch.take(B * n_bands, W))
    if rc != 0:
        msg = lib.integral_tables_error_string(rc).decode()
        raise RuntimeError(f"integral_tables kernel launch failed: {msg} "
                           f"({rc})")
    scratch.launched(B * n_bands)
    integral_tables.launches += 1
    return ii, sq


integral_tables.launches = 0
