"""dense_roofline.eye: the tilted dense phase of both eye cascades as a
share (%) of its roofline (``frozen/roofline.py``) against the summed
device time of its three kernels in the traced calls: the integral tables
(``ops/cuda/integral_cuda.py``, #4), the tilted table and the tiled
evaluation (``ops/cuda/dense_level_cuda.py``, #2)."""

from vcabench.frozen.roofline import dense_share


def read(ctx: dict):
    cfg = ctx["cfg"]
    w = min(cfg["width_to_process"], cfg["frame"][0])
    size = (w, int(round(cfg["frame"][1] * w / cfg["frame"][0])))
    return dense_share(ctx, [cfg["right_cascade"], cfg["left_cascade"]],
                       size, cfg["part_scale_factor"],
                       tuple(cfg["part_min_size"]), False,
                       ("integral_bands_kernel", "tilted_table_kernel",
                        "tilted_eval_kernel"))
