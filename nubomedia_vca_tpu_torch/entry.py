"""Entry points of the port: the flagship device step with its
example input, and the multi-device dry run — the counterparts of the
repository root's ``__graft_entry__.py`` ``entry()`` and
``dryrun_multichip()``.

    from nubomedia_vca_tpu_torch.entry import entry
    fn, (example,) = entry()            # or entry("cpu")
    boxes, valid, overflow = fn(example)

The face cascade is the port's bundled ``haarcascade_frontalface_alt.xml``
(byte-identical to OpenCV's). Both run on the card unless the caller asks
for the CPU; a CUDA request on a host without a card raises.
"""

from __future__ import annotations

import numpy as np
import torch

from .cascade.engine import CascadeEngine, _resolve_device, load_cascade
from .models.face import DEFAULT_FACE_CASCADE
from .ops.histogram import equalize_hist
from .ops.resize import resize_linear_exact

FRAME = (640, 480)          # (W, H) of the example frames
WORK = (160, 120)           # the face path's working image
FACTOR = 1.25
EXAMPLE_BATCH = 4


def entry(device: str | torch.device = "cuda"):
    """The flagship device step (exact resize → equalizeHist → multiscale
    Haar cascade) → (fn, (example,)): fn(gray [B,480,640] uint8 on
    `device`) returns the engine's raw candidates (boxes [B,TC,4] int32,
    valid [B,TC] bool, overflow [B] bool); example is 4 frames of seeded
    noise on `device`."""
    dev = _resolve_device(device)
    engine = CascadeEngine(load_cascade(DEFAULT_FACE_CASCADE), WORK, FACTOR,
                           device=dev)

    def fn(gray: torch.Tensor):
        return engine._detect_impl(equalize_hist(resize_linear_exact(
            gray, WORK)))

    example = torch.from_numpy(np.random.RandomState(0).randint(
        0, 256, (EXAMPLE_BATCH, FRAME[1], FRAME[0]), np.uint8)).to(dev)
    return fn, (example,)


def dryrun_multichip(n_devices: int,
                     device: str | torch.device = "cuda") -> list[dict]:
    """The four multi-device steps (dp×tp train step, sharded detection,
    the 4-stream serving step, the sharded part chain) over `n_devices`
    processes, each held against the unsharded path
    (``parallel.dryrun.dryrun_multichip``), then the JAX dry run's
    one-line summary. Returns each process's report. Spawns processes:
    call it under an ``if __name__ == "__main__":`` guard."""
    from .parallel import dryrun

    reports = dryrun.dryrun_multichip(n_devices, torch.device(device).type)
    r0 = reports[0]
    print(f"dryrun_multichip({n_devices}): train loss "
          f"{r0['train_losses'][-1]:.4f}; detect boxes "
          f"{r0['detect'][0].shape}; serving {dryrun.DryrunInputs.n_streams}"
          f"-stream grouped boxes {r0['serve'][0].shape}; part-chain "
          f"eye_left compacted candidates {r0['chain'][1]['eye_left'][0].shape}"
          " OK", flush=True)
    return reports
