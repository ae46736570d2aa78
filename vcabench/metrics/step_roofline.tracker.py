"""step_roofline.tracker: the tracker's device work as a share (%) of its
roofline: the least time the traced frames' bytes take
(``frozen/motion.py`` ``frame_bytes``: frame, previous frame and MHI read,
MHI and previous frame written, at 3.35 TB/s) over the device time of the
kernels launched inside the program's ``vca.tracker.process`` ranges."""

import torch

from vcabench.frozen.motion import frame_bytes
from vcabench.frozen.profile import _device_us
from vcabench.frozen.roofline import HBM_BYTES_PER_S


def read(ctx: dict):
    prof = ctx.get("prof")
    if prof is None:
        return None
    device_us = sum(_device_us(e) for e in prof.events()
                    if e.device_type != torch.autograd.DeviceType.CUDA
                    and e.name == "vca.tracker.process")
    if device_us <= 0:
        return None
    frames = ctx["calls"] * ctx["pool"].shape[1]
    least_s = frames * frame_bytes(tuple(ctx["cfg"]["frame"])) \
        / HBM_BYTES_PER_S
    return 100.0 * least_s / (device_us * 1e-6)
