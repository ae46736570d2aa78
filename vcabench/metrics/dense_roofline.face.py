"""dense_roofline.face: the face dense phase's share (%) of its roofline
(``frozen/roofline.py``) against the device time of the pyramid kernel
(``ops/cuda/dense_cuda.py``, #1) in the traced calls."""

from vcabench.frozen.roofline import dense_share


def read(ctx: dict):
    cfg = ctx["cfg"]
    w = min(cfg["width_to_process"], cfg["frame"][0])
    size = (w, int(round(cfg["frame"][1] * w / cfg["frame"][0])))
    return dense_share(ctx, [cfg["cascade"]], size,
                       1.0 + cfg["multi_scale_factor"] / 100.0, (0, 0),
                       True, ("pyramid_band_kernel",))
