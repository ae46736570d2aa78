"""group_ms.archive: device ms a call of the grouping (``cascade/engine.py``
``_group_impl`` and ``_compact_raw_impl``, inside the program's
``vca.engine.group`` ranges): the device time of the kernels launched
inside them, summed over the traced calls and divided by the calls
(``vca.filter.process`` ranges)."""

import torch

from vcabench.frozen.profile import _device_us


def read(ctx: dict):
    prof = ctx.get("prof")
    if prof is None:
        return None
    calls, group, total = 0, 0, 0.0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            continue
        if e.name == "vca.filter.process":
            calls += 1
        elif e.name == "vca.engine.group":
            group += 1
            total += _device_us(e)
    if not calls or not group:
        return None
    return total / calls / 1000.0
