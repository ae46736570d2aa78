#!/usr/bin/env python3
"""Drive the PyTorch port's main paths once on an NVIDIA GPU: the face
path, the part chain (nose, mouth, eyes), the ear detector, the learned
face detector (int8 and bf16), the motion tracker, the drawing ops, the
serving plane (JSON-RPC server, media loop, native ingest), the
learned detectors' training path (distillation teacher, trainers,
checkpoints), the multi-device paths over NCCL, the cascade tooling
(XML conversion, the AdaBoost trainer), the entry point, the
evaluation and cascade-training tools and the examples, and the benchmark
script ``bench_torch.py``.

    python3 chip_smoke.py        # from the repository root; needs one GPU

Phases, each printing its findings, any failure ending the run non-zero:

1. device check: CUDA present; card name and power limit; torch/CUDA;
2. build: compile the six CUDA sources with nvcc, one process each, and
   the native ingest with g++, all started together (ptxas registers,
   spills and shared memory per kernel);
3. kernels vs plain versions, exactly, on the same CUDA tensors:
   the pyramid dense kernel on B=64 synthetic 1280x720 (and 640x480) face
   work images and noise (level images, vnf, alive), and on the nose's
   24-level launch of the part chain at 320x180; its bands alone on the
   nose's four wide levels (320x180 .. 240x135, whose whole tables exceed
   a block: the row-strip kernel's levels before), and in bands of one
   grid row on the widest; at the part chain's 320x180, the tilted kernels
   (table pass, tilted table, tiled evaluation) on every level of the
   mouth and both eyes, 320x180 included (ii, iit, vnf, alive), the
   tilted-table kernel alone against the image's plain tilted table and
   the integral kernel alone on the same levels and at band-edge heights
   and 1x1; the survivor kernel on every level and both blocks of the
   mouth and both eyes, B=64 faces and noise at 320x180, on the slots
   that ``_level_post`` compacts (passed flags); the motion labelling
   kernel against ``tracker._propagate`` on ``utils/synth.motion_maps``
   and the blob clip's MHIs at 1280x720 (labels); the int8 quantizer on
   the seven layer inputs of a B=64 720p
   int8 forward and on odd sizes (1, 1023, 1025, 2^24 + 3 elements, all
   zeros), the stochastic quantizer on the conv1 input for two seeds
   (values, scale, and its mean rounding error within 5 sigma of 0); the
   pyramid kernel on both plans of each ear pairing (profile faces at
   160x90; ears at 320x180, four wide levels) over the [normal, flipped]
   batch of B=64 720p profile frames, 128 work images, and noise;
4. face path: ``FaceDetector((1280, 720), device="cuda").process`` over
   consecutive batches of one stream; the pyramid kernel must launch once
   per batch, at least one face must be tracked, and the tracked faces
   (ids and rects) and the engine's raw candidates must equal the port's
   CPU run;
5. part path: ``NoseDetector``, ``MouthDetector`` and ``EyeDetector`` at
   1280x720 on the card over two batches of one stream: every kernel
   launches as often as the engines' level routes predict (the pyramid
   kernel twice per nose batch, once of them with the wide levels); per-frame
   (the survivor kernel once a level and block of each tilted engine);
   outputs, grouped faces and compacted raw part candidates (with their
   overflow flags) equal the port's CPU run; nose boxes, mouth candidates
   and alive windows after the dense phase of every tilted engine are
   non-zero;
6. ear path: ``EarDetector((1280, 720), device="cuda").process`` over
   two B=64 batches of one stream of profile frames (``utils/synth``), with
   the default pairing (synthetic ear and profile cascades) and with the
   real ``haarcascade_profileface.xml``: the pyramid kernel launches twice
   per batch (once of them with the ear's wide levels); the first batch's
   outputs, grouped profile faces and raw ear candidates equal the port's
   CPU run; the default pairing keeps windows alive and finds profile
   faces and ears on both the normal and the flipped side;
7. learned path: ``QuantizedCnnFaceDetector((1280, 720),
   device="cuda").process`` over two B=64 batches of one stream: the
   quantizer launches 7 times per forward, every layer's int8 tensor and
   scale and the output equal the CPU run's, the tracked faces (ids and
   rects) equal the CPU run's, at least one face is tracked; the bf16
   ``CnnFaceDetector`` on the card tracks the same faces as on the CPU
   (ids equal, rects within 2 px: cuDNN sums the bf16 convs in another
   order);
8. tracker and drawing: ``Tracker((1280, 720), device="cuda")`` on a
   moving-blob clip, blobs per frame and the final MHI equal to the CPU
   run over 8 frames, then ``Tracker.process`` over 64 frames in one call
   timed, every frame labelled by the motion labelling kernel (three
   launches a frame, ``vca.tracker.ccl_frames``); ``render_detections``
   rect, circle and costume blend on a B=64 720p BGR batch on the card
   against the numpy twins (``host=True``): rect and circle exactly, the
   blend within 1 (the twin divides by 255 and fuses no multiply-add) and
   exactly the port's CPU blend on its first frames;
10. serving (run before the times): ``VcaRpcServer(port=0,
    frame_size=(1280, 720))`` on the card, driven by the generated
    ``clients/python`` client, serves two pipelines at once, each fed 96
    720p frames from ``utils/synth.face_clip`` over TCP, paced to at most
    32 in flight: A, ``NuboTracker`` → ``NuboFaceDetector`` →
    ``NuboEyeDetector(detectByEvent=1)`` with ``listen(channels=3,
    output=1)`` (BGR in, annotated BGR read back), and B,
    ``NuboCnnFaceDetector`` (``setQuantized(1)``) + ``NuboCnnPartDetector``
    with ``listen(channels=1, downscale=1)``. Each pipeline must process
    every frame it was sent and drop none, send OnFace over RPC at least
    once and use the native ingest; no element may raise inside the loop
    (each element's ``process`` and ``render`` are wrapped on the
    instance to record it); the pyramid, tilted, integral and int8
    kernels must launch; A's annotated frames must equal the same element
    chain called directly on the card (``MediaRunner._step``) in the
    loop's batches. It prints frames/s per pipeline over TCP, ms per loop
    step, each pipeline's ``stats()`` and the host ms of each element
    call; then each pipeline serves its first 48 frames alone, timed the
    same way, and A's tracker runs the served frames alone
    (``Tracker.process`` ms per frame);
11. training (run after 10, before the times): at the shipped width,
    B=32, 320x240 on the card. The distillation teacher
    (``distill.make_teacher``: frontalface_alt, 12 levels, 3 wide) labels
    32 ``face_clip`` frames with one #1 launch and its wide bands, equal
    to the CPU teacher's labels; ``distill.train`` itself (30 steps on the
    warmup-cosine schedule, a pool of 3 labelled batches on the card,
    ``make_scene`` replaced by the cv2-free ``synth_scene``: the card's
    host has no cv2) with every loss finite, step 0 moving nothing and
    step 1 the parameters, its npz served by ``CnnFaceDetector`` on the
    card; ``cnn_parts.train`` (6 steps, C=6, ctx) on teacher-labelled
    face-only scenes; the #1 launches counted in each run against the
    teacher's plan; 3 face steps from the same weights and pool on the card
    and on the host's CPU (losses within 1e-3 relative, parameters within
    2·k·lr, median under lr / 20); the train-state round trip on the card
    (parameters, AdamW moments and count, lr bit for bit, the next loss
    within 1e-3); then the step's ms and images/s (CUDA events, warm), its
    peak memory, the teacher's ms per labelled batch and #1 on the
    teacher's levels with its plain version and bound;
12. multi-device (after 11, before the times): ``parallel.dryrun.
    dryrun_multichip`` over ``torch.cuda.device_count()`` NCCL processes,
    one per card, spawned with a time limit (one card: world size 1, which
    is all NCCL allows there; the multi-rank semantics are held on the
    CPU with gloo by ``tests/test_torch_parallel.py``). At full width:
    sharded face detection and, through a 4-stream ``StreamFeeder``,
    detection and grouping of B=64 720p frames (160x90 work images, 7
    levels, one #1 launch a batch); the sharded chain with
    ``lefteye_2splits`` at 320x180 (#2 and #4 on its 24 levels); 3 dp×tp
    train steps of the shipped CNN (B=32, 320x240, ``ctx``, the teacher's
    labels), then 3 on the recipe's warmup-cosine schedule and 3 more
    resumed from their gathered optimizer and scheduler state, saved and
    read back. Each process holds every sharded output against the
    unsharded path on its card (detection exactly; the train steps' losses
    within 1e-5 relative, parameters within 2·Σ lr, median lr/1000) and
    the sharded launches against the prediction; it prints the time to
    join the group and the ms per sharded and per unsharded batch;
13. cascade tooling: the three bundled XML families (frontalface_alt,
    lefteye_2splits, smile) to the old format and back, the loaded
    cascades equal; an engine on the card built from the old-format face
    file gives the bundled file's candidates; two stages of the cascade
    trainer at the part recipe's widths through
    ``tools/torch_train_part_cascades.py`` ``train_one`` (20x20, n_pos
    3000, n_neg 8000, 3000 features; 8 stages cut to 2) from cv2-free
    samples, with its holdout check, on the card and on the CPU, writing
    the same XML bytes, with the feature GEMM's ms per stage on both; the
    trained cascade's engine on the card (one #1 launch) equal to the
    CPU's;
14. entry, tools and examples: the port's entry point
    (``nubomedia_vca_tpu_torch/entry.py`` ``entry()``: 640x480 → 160x120,
    frontalface_alt at 1.25) on its example batch and on face frames, raw
    candidates equal to the CPU's, one #1 launch a call, its ms a call;
    ``tools/torch_real_eval.py`` ``evaluate`` on 8 720p ``.npy`` scenes
    with the int8 and the bf16 CNN (teacher and int8 boxes equal to the
    CPU's, bf16 boxes within 2 px), recall, precision and ms per image;
    ``tools/torch_eval_trained_cascades.py``: the real-photo sweep's scans
    (the three shipped ``vca_*_synthetic.xml`` and the bundled profile
    cascade at their serving configurations) on a synthetic 720p frame
    and ``eval_xml_windows`` on cv2-free windows, equal to the CPU's; each
    ``examples/torch_*.py`` demo as a subprocess on the card at a small
    frame count, all five exiting 0 within 240 s;
15. benchmark: ``python3 bench_torch.py 64`` as a subprocess with a
    time limit, its lines printed here: it must exit 0, print every metric
    of its phases exactly once before its headline lines, finite and
    positive, the card line first and ``face_detect_720p_fps_per_chip``
    last, and each timed loop's kernel launches a batch as
    ``BENCH_LAUNCHES`` says (its own gate, card against CPU, runs inside
    it); its phases' launches join the kernel line's;
9. times (CUDA events, kernel and plain version in turns): each kernel at
   the main paths' shapes with its plain version, its bound from the
   shapes and this run's data, and a PyTorch call computing the same
   function where there is one (the ``torch.cumsum`` pair for the integral
   kernel, ``abs().amax()`` + ``torch.quantize_per_tensor`` for the int8
   quantizer): the pyramid kernel on the face path's launch, on the
   nose's 24-level launch and on the nose's four wide levels alone, the
   integral kernel over the mouth's 23, the
   right eye's 24 and its 6 largest levels; the tilted dense phase over
   the right eye's 18 levels that
   the single-block kernel of earlier versions took, over all 24, and over
   the six largest against the plain tilted table and dense phase that
   took them before, each with the table pass's and the evaluation's
   share; the survivor kernel over both eye engines' 24 levels and 2
   blocks (96 launches) on the slots of phase 3, with its kernels alone
   under ``torch.profiler``; the motion labelling kernel on a 1280x720
   MHI of the blob clip against ``tracker._propagate``, with its kernels
   alone and its bound, and alone on a uniform MHI; the pyramid kernel
   on the ear's plans (128 work images); the face path's, the part detectors', the ear's and the learned detectors'
   device ms per batch; each detector's ``process()`` frames/s at B=64
   720p.

The last lines are the kernel summary as JSON, the card's
``nvidia-smi --query-gpu=name,power.limit`` line, and
``{"ok": true, "device": {...}}``. The script imports no JAX.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import json
import os
import socket
import subprocess
import sys
import tempfile
import threading
import time
import traceback
from unittest import mock

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

from nubomedia_vca_tpu_torch import entry  # noqa: E402
from nubomedia_vca_tpu_torch.api import (  # noqa: E402
    media_loop, objects, rpc)
from nubomedia_vca_tpu_torch.api.render import (  # noqa: E402
    render_detections)
from nubomedia_vca_tpu_torch.cascade import convert, train  # noqa: E402
from nubomedia_vca_tpu_torch.cascade.engine import (  # noqa: E402
    CascadeEngine, get_engine)
from nubomedia_vca_tpu_torch.cascade.paths import find_cascade  # noqa: E402
from nubomedia_vca_tpu_torch.cascade.xml_loader import (  # noqa: E402
    load_cascade_xml)
from nubomedia_vca_tpu_torch.cpp import ingest_binding  # noqa: E402
from nubomedia_vca_tpu_torch.models import (  # noqa: E402
    CnnFaceDetector, EarDetector, EarDetectorConfig, EyeDetector,
    FaceDetector, MouthDetector, NoseDetector, QuantizedCnnFaceDetector,
    Tracker)
from nubomedia_vca_tpu_torch.models import (  # noqa: E402
    cnn, cnn_parts, distill, tracker)
from nubomedia_vca_tpu_torch.models.face import (  # noqa: E402
    DEFAULT_FACE_CASCADE)
from nubomedia_vca_tpu_torch.ops import quant  # noqa: E402
from nubomedia_vca_tpu_torch.ops.color import bgr_to_gray  # noqa: E402
from nubomedia_vca_tpu_torch.ops.cuda import (  # noqa: E402
    _build, dense_cuda, dense_level_cuda, integral_cuda, motion_ccl_cuda,
    quant_cuda, survivor_cuda)
from nubomedia_vca_tpu_torch.ops.histogram import equalize_hist  # noqa: E402
from nubomedia_vca_tpu_torch.ops.integral import (  # noqa: E402
    tilted_from_integral, tilted_integral_image)
from nubomedia_vca_tpu_torch.ops.resize import (  # noqa: E402
    resize_linear_exact)
from nubomedia_vca_tpu_torch.parallel import dryrun  # noqa: E402
from nubomedia_vca_tpu_torch.utils import checkpoint, tracing  # noqa: E402
from nubomedia_vca_tpu_torch.utils.synth import (  # noqa: E402
    blob_clip, draw_face, face_clip, face_scene, motion_maps, profile_scene)

sys.path.insert(0, os.path.join(ROOT, "tools"))
import torch_eval_trained_cascades  # noqa: E402
import torch_real_eval  # noqa: E402
import torch_train_part_cascades  # noqa: E402

import bench_torch  # noqa: E402

FRAME = (1280, 720)
BATCH = 64
PART_BATCHES = 2       # consecutive batches of one stream on the part path
PART_BATCH = 4         # frames per part-path batch
LEARNED_BATCHES = 2    # consecutive B=64 batches of one stream, learned path
BF16_ATOL = 0.0625     # bf16 forward, card vs CPU (tests/test_torch_cnn.py)
EAR_BATCHES = 2        # consecutive B=64 batches of one stream, ear path
TRACKER_FRAMES = 64    # frames of the tracker's timed run
TRACKER_CPU_FRAMES = 8  # consecutive frames held against the CPU run
REAL_PROFILE = "haarcascade_profileface.xml"
SERVE_FRAMES = 96      # paced 720p frames per pipeline over TCP, phase 10
SERVE_WINDOW = 32      # frames in flight at most: the ingest holds 64
SERVE_TIMEOUT = 300.0  # seconds a serving stream may take
SERVE_SOLO = 48        # frames each pipeline then serves alone
SERVE_LISTEN = {"A": {"channels": 3, "output": 1},
                "B": {"channels": 1, "downscale": 1}}
TRAIN_BATCH = 32       # frames per labelled batch and per train step
TRAIN_STEPS = 30       # distill.train's steps on the warmup-cosine schedule
TRAIN_POOL = 3         # labelled batches resident on the card
TRAIN_REGEN = 10       # steps between relabelled pool entries
TRAIN_LR = 3e-4
PARITY_STEPS = 3       # face-trainer steps held against the card host's CPU
# the same torch code on the card and on its host's CPU: a step's loss
# (relative), step 0's gradient per leaf (share of the leaf's largest
# |gradient|), and the median parameter after PARITY_STEPS steps; the max
# is held to 2·Σ lr of the steps taken (Adam's first updates are ±lr)
CARD_LOSS_RTOL = 1e-5
CARD_GRAD_TOL = 2e-2
CARD_PARAM_MEDIAN = TRAIN_LR / 1000
PARTS_STEPS = 6        # cnn_parts.train's steps, constant lr
PARTS_POOL = 2
TIMED_STEPS = 20       # warm train steps timed with CUDA events
MULTI_TIMEOUT = 300.0  # seconds the multi-device processes may take, phase 12
MULTI_TIMED = 5        # sharded and unsharded calls timed each, phase 12
# phase 13: the part-cascade recipe's widths (tools/train_part_cascades.py
# :54, 20x20 window, n_pos 3000, n_neg 8000, a pool of 3000 features, up
# to 40 weaks a stage); its depth cut from 8 stages to 2
TOOLING_TRAIN = dict(n_stages=2, n_pos=3000, n_neg=8000, max_features=3000,
                     max_weaks_per_stage=40, verbose=False)
EVAL_SCENES = 8        # 720p .npy scenes through tools/torch_real_eval, phase 14
EXAMPLE_TIMEOUT = 240.0  # seconds the five demos may take together, phase 14
EXAMPLES = {"torch_annotated_stream_demo.py": ("--frames", "8"),
            "torch_cnn_demo.py": ("--frames", "4", "--quantized"),
            "torch_full_chain_demo.py": ("--frames", "4"),
            "torch_rpc_client_demo.py": (),
            "torch_serving_demo.py": ("--streams", "4", "--frames", "4")}
TOOLING_XML = ("haarcascade_frontalface_alt.xml",
               "haarcascade_lefteye_2splits.xml", "haarcascade_smile.xml")
# NVIDIA H100 SXM data sheet (dense, at the 700 W limit): HBM rate and the
# float32 rate outside the tensor cores, which the dense kernels' integer
# adds and float32 compares run at
HBM_BYTES_PER_S = 3.35e12
OPS_PER_S = 67e12
# phase 15: bench_torch.py at B=BATCH, its metrics and each timed loop's
# kernel launches a batch (provenance line → step → launches)
BENCH_TIMEOUT = 540.0
BENCH_METRICS = (
    "face_detect_720p_fps_per_chip", "face_detect_720p_fps_per_chip_samples",
    "device_path_720p_fps", "hbm_gbps_est", "latency_batch_ms_derived",
    "haar_chain_720p_fps_per_chip", "haar_chain_720p_fps_per_chip_samples",
    "e2e_async_loop_fps", "e2e_hostloop_fps", "cnn_720p_fps",
    "cnn_int8_720p_fps", "cnn_parts_720p_fps", "latency_batch_ms_p50",
    "latency_batch_ms_p99", "e2e_hostloop_fullres_fps",
    "feeder_multistream_async_fps")
_ONE_PYRAMID = {"pyramid_dense_phase": 1.0}
BENCH_LAUNCHES = {
    "grouped_provenance": {"face_detect_720p_fps_per_chip": _ONE_PYRAMID,
                           "device_path_720p_fps": _ONE_PYRAMID},
    "chain_provenance": {"haar_chain_720p_fps_per_chip": {
        "pyramid_dense_phase": 2.0, "pyramid_dense_phase_wide": 1.0,
        "dense_level_tilted": 71.0, "tilted_table": 71.0,
        "integral_tables": 71.0}},
    "e2e_hostloop_fps_provenance": {"e2e_async_loop_fps": _ONE_PYRAMID,
                                    "e2e_hostloop_fps": _ONE_PYRAMID},
    "cnn_provenance": {"cnn_720p_fps": {},
                       "cnn_int8_720p_fps": {"quantize_int8": 7.0},
                       "cnn_parts_720p_fps": {}},
    "latency_provenance": {"latency": _ONE_PYRAMID},
    "e2e_hostloop_fullres_fps_provenance": {"e2e_hostloop_fullres_fps":
                                            _ONE_PYRAMID},
    "feeder_multistream_async_fps_provenance": {
        "feeder_multistream_async_fps": _ONE_PYRAMID},
}
PALLAS = "nubomedia_vca_tpu/ops/pallas"
CSRC = "nubomedia_vca_tpu_torch/csrc"
# name → (wrapper, its launch counter, source, TPU kernel replaced). The
# row-strip form of the TPU dense phase (dense_pallas.py:276) is carried by
# the pyramid kernel's bands: its entry counts the pyramid launches that
# hold a wide level (whole tables over a block's shared memory).
KERNELS = {
    "pyramid_dense_phase": (dense_cuda.pyramid_dense_phase, "launches",
                            f"{CSRC}/pyramid_dense.cu",
                            f"{PALLAS}/dense_pallas.py:371"),
    "dense_level_tilted": (dense_level_cuda.dense_level_tilted, "launches",
                           f"{CSRC}/dense_level.cu",
                           f"{PALLAS}/dense_pallas.py:221"),
    "tilted_table": (dense_level_cuda.tilted_table, "launches",
                     f"{CSRC}/dense_level.cu",
                     f"{PALLAS}/dense_pallas.py:181"),
    "pyramid_dense_phase_wide": (dense_cuda.pyramid_dense_phase,
                                 "wide_launches", f"{CSRC}/pyramid_dense.cu",
                                 f"{PALLAS}/dense_pallas.py:276"),
    "integral_tables": (integral_cuda.integral_tables, "launches",
                        f"{CSRC}/integral_tables.cu",
                        f"{PALLAS}/integral_pallas.py:52"),
    "quantize_int8": (quant_cuda.quantize_int8, "launches",
                      f"{CSRC}/quant_int8.cu",
                      f"{PALLAS}/quant_pallas.py:73"),
    "quantize_int8_stochastic": (quant_cuda.quantize_int8_stochastic,
                                 "launches", f"{CSRC}/quant_int8.cu",
                                 f"{PALLAS}/quant_pallas.py:100"),
    # the JAX engine's survivor stages are XLA gathers and dots
    "survivor_eval": (survivor_cuda.survivor_eval, "launches",
                      f"{CSRC}/survivor_eval.cu", "none"),
    # the JAX tracker labels motion components with a lax.while_loop
    "motion_ccl": (motion_ccl_cuda.motion_ccl, "launches",
                   f"{CSRC}/motion_ccl.cu", "none"),
}
# No path runs it: the JAX package calls quantize_int8_stochastic_pallas
# from nowhere (it exists for quantization-aware fine-tuning), so its
# launches on the paths are 0; phase 3 holds it to its plain version.
OFF_PATH = {"quantize_int8_stochastic"}
DETECTORS = (NoseDetector, MouthDetector, EyeDetector)
# tilted levels per part-path batch at 720p: the smile's 23, the two eyes'
# 24 each
TILTED_LEVELS = {"NoseDetector": 0, "MouthDetector": 23, "EyeDetector": 48}


START = time.perf_counter()


def phase(name: str) -> None:
    print(f"== {name} (at {time.perf_counter() - START:.1f} s)", flush=True)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0].strip()


def cuda_ms(fn, n: int) -> float:
    """Mean ms per call of `fn` over n calls, after one warm call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def in_turns(kernel, plain, n_kernel: int, n_plain: int):
    """(kernel ms, plain ms, runs): plain, kernel, kernel, plain."""
    runs = {"kernel": [], "plain": []}
    for which in ("plain", "kernel", "kernel", "plain"):
        fn, n = (kernel, n_kernel) if which == "kernel" else (plain, n_plain)
        runs[which].append(cuda_ms(fn, n))
    return float(np.mean(runs["kernel"])), float(np.mean(runs["plain"])), runs


def reset_counts() -> None:
    for fn, attr, _, _ in KERNELS.values():
        setattr(fn, attr, 0)


def read_counts() -> dict[str, int]:
    return {name: getattr(fn, attr)
            for name, (fn, attr, _, _) in KERNELS.items()}


def work_images(frames, size, dev) -> torch.Tensor:
    gray = torch.from_numpy(frames).to(dev)
    return equalize_hist(resize_linear_exact(gray, size))


def assert_equal(got, want, what: str) -> float:
    """Exact equality of two tensors (None both or neither) → max |err|."""
    if (got is None) != (want is None):
        raise AssertionError(f"{what}: one side is None")
    if got is None:
        return 0.0
    err = float((got.double() - want.double()).abs().max()) if got.numel() \
        else 0.0
    if not torch.equal(got, want):
        n = int((got != want).sum())
        raise AssertionError(f"{what}: differs in {n} elements (max {err})")
    return err


# ------------------------------------------------------------------ bounds
def dense_ops(tables, vnf: torch.Tensor, alive: torch.Tensor) -> float:
    """Operations the dense phase needs at least on this data: the
    normalization of every window (8 table reads, 6 integer and 6 float32
    operations), the first stage for every window with enough variance,
    and every dense stage for the windows still alive. A weak tree is two
    features (the root and the child it selects), a feature per rect 4
    reads, 3 adds, a multiply and an add."""
    d, fi = tables.dense, tables.host["feat_i"]
    weak_cost = []
    for k in range(len(d["stage"])):
        rects = [fi[tables.host["weak_i"][k][j]][0] for j in (0, 1)]
        weak_cost.append(sum(9 * r for r in rects) + 4)
    stage = np.asarray(d["stage"])
    first = float(sum(c for c, s in zip(weak_cost, stage) if s == 0))
    every = float(sum(weak_cost))
    n_win = vnf.numel()
    n_valid = int((vnf != 1.0).sum())
    n_alive = int(alive.sum())
    return 20.0 * n_win + first * n_valid + every * n_alive


def bound(n_bytes: float, n_ops: float) -> tuple[float, str]:
    """(least ms, "bytes" | "operations") on an H100 SXM at 700 W."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


# ------------------------------------------------------------------ phases
def build_all() -> None:
    names = ("pyramid_dense", "dense_level", "integral_tables", "quant_int8",
             "survivor_eval", "motion_ccl")
    with concurrent.futures.ThreadPoolExecutor(len(names) + 1) as ex:
        ingest = ex.submit(ingest_binding.build_library)
        t0 = time.perf_counter()
        results = list(ex.map(_build.build_library, names))
        print(f"build: {ingest.result().name} (g++, the native ingest) by "
              f"{time.perf_counter() - t0:.2f} s")
    for name, (path, log, seconds) in zip(names, results):
        print(f"build: {path.name} in {seconds:.2f} s")
        for line in log.splitlines():
            if ("Compiling entry" in line or "registers" in line
                    or "spill" in line):
                print(f"  ptxas: {line.strip()}")


def pyramid_equal(work, plan, what: str) -> tuple[float, int]:
    """The pyramid kernel's level images, vnf and alive on `work` equal
    to its plain version's, element by element → (max |err|, alive
    windows)."""
    got = dense_cuda.pyramid_dense_phase(work, plan)
    want = dense_cuda.pyramid_dense_phase_reference(work, plan)
    torch.cuda.synchronize()
    err = 0.0
    for li, (g, w) in enumerate(zip(got, want)):
        for gt, wt, name in zip(g, w, ("image", "vnf", "alive")):
            err = max(err, assert_equal(gt, wt,
                                        f"pyramid {what} level {li} {name}"))
    return err, sum(int(a.sum()) for _, _, a in got)


def check_pyramid(dev, frames_by_size, nose, teacher,
                  teacher_frames) -> tuple[float, float]:
    """The pyramid kernel vs its plain version on the face engine's plans
    (720p and 480p frames), on the nose's 24-level launch of the part
    chain (720p frames at 320x180) and on the distillation teacher's plan
    (its 320x240 frames as they are, B=TRAIN_BATCH); faces and noise;
    → (max |err|, max |err| over the plans with wide levels)."""
    max_err = wide_err = 0.0
    cases = []
    for size, frames in frames_by_size.items():
        eng = get_engine(DEFAULT_FACE_CASCADE,
                         (160, round(size[1] * 160 / size[0])), 1.25,
                         device=dev)
        cases.append((f"face {size[0]}x{size[1]}", eng,
                      work_images(frames, (eng.image_w, eng.image_h), dev)))
    cases.append(("nose 1280x720", nose, work_images(
        frames_by_size[FRAME], (nose.image_w, nose.image_h), dev)))
    cases.append(("teacher", teacher, torch.from_numpy(teacher_frames).to(
        dev)))
    for what, eng, work in cases:
        noise = torch.from_numpy(np.random.RandomState(5).randint(
            0, 256, work.shape, np.uint8)).to(dev)
        n_alive = []
        p = eng._plan
        for x in (work, noise):
            err, alive = pyramid_equal(x, p, what)
            max_err = max(max_err, err)
            if p.n_wide:
                wide_err = max(wide_err, err)
            n_alive.append(alive)
        print(f"pyramid kernel, {what} -> work {eng.image_w}x{eng.image_h}, "
              f"{len(p.levels)} levels in {len(p.items)} bands, "
              f"B={work.shape[0]}: == plain (level images, vnf, alive); "
              f"alive windows {n_alive[0]} (faces) {n_alive[1]} (noise); "
              f"smem per block {p.band_smem_bytes} B ({p.n_wide} wide "
              f"levels)")
    return max_err, wide_err


def part_engines(dev) -> dict:
    """The part chain's engines at 1280x720, as the detectors build them."""
    return {d.__name__: d(FRAME, device=dev) for d in DETECTORS}


def check_level_kernels(dev, dets, part_frames) -> dict[str, float]:
    """Tilted, tilted-table and integral kernels vs their plain versions
    on the part chain's levels, and the pyramid kernel's bands on the
    nose's wide levels; → max |err| per kernel."""
    work = work_images(part_frames, (320, 180), dev)
    noise = torch.from_numpy(np.random.RandomState(6).randint(
        0, 256, work.shape, np.uint8)).to(dev)
    err = {"dense_level_tilted": 0.0, "pyramid_dense_phase_wide": 0.0,
           "integral_tables": 0.0, "tilted_table": 0.0}
    tilted = [(n, e) for d in dets.values()
              for n, e in d.part_engines.items() if e._uses_tilt]
    n_levels = 0
    for name, eng in tilted:
        if sorted(eng._level_plans) != list(range(len(eng.levels))):
            raise AssertionError(f"{name}: a level is off the tilted route")
        n_alive = 0
        for x in (work, noise):
            for li, plan in eng._level_plans.items():
                l = eng.levels[li]
                img = resize_linear_exact(x, (l.sw, l.sh))
                got = dense_level_cuda.dense_level_tilted(img, plan)
                want = dense_level_cuda.dense_level_reference(img, plan)
                for g, w, what in zip(got, want, ("ii", "iit", "vnf",
                                                  "alive")):
                    err["dense_level_tilted"] = max(
                        err["dense_level_tilted"],
                        assert_equal(g, w, f"{name} level {li} {what}"))
                ii, sq = integral_cuda.integral_tables(img)
                for g, w, what in zip(
                        (ii, sq), integral_cuda.integral_tables_reference(img),
                        ("ii", "sq")):
                    err["integral_tables"] = max(
                        err["integral_tables"],
                        assert_equal(g, w, f"{name} level {li} {what}"))
                err["tilted_table"] = max(err["tilted_table"], assert_equal(
                    dense_level_cuda.tilted_table(ii),
                    tilted_integral_image(img),
                    f"{name} level {li} tilted table"))
                n_alive += int(got[3].sum())
        n_levels += len(eng.levels)
        l0, p0 = eng.levels[0], eng._level_plans[0]
        smem = max(p.smem_bytes for p in eng._level_plans.values())
        print(f"tilted kernels ({name}, {len(eng.levels)} levels "
              f"{l0.sw}x{l0.sh} .. {eng.levels[-1].sw}x{eng.levels[-1].sh}; "
              f"{p0.tile_ny}x{p0.tile_nx}-window tiles, {p0.n_tiles} at "
              f"{l0.sw}x{l0.sh}, evaluation smem up to {smem} B), B={BATCH} "
              "faces + noise: table pass + tiled evaluation == plain (ii, "
              "iit, vnf, alive), integral kernel == plain (ii, sq), "
              "tilted-table kernel "
              f"== tilted_integral_image; alive windows {n_alive}")
    # the integral kernel alone on one band, band edges at 320 columns (16
    # rows a band) and a single pixel, at the largest sums
    rng = np.random.RandomState(8)
    for hw in [(1, 1), (15, 320), (16, 320), (17, 320), (33, 320), (37, 53)]:
        img = torch.from_numpy(rng.randint(0, 256, (BATCH,) + hw,
                                           np.uint8)).to(dev)
        img[0] = 255
        for g, w, what in zip(integral_cuda.integral_tables(img),
                              integral_cuda.integral_tables_reference(img),
                              ("ii", "sq")):
            err["integral_tables"] = max(err["integral_tables"], assert_equal(
                g, w, f"integral {hw} {what}"))
    print(f"tilted kernels: {n_levels} tilted levels, max |err| "
          f"{err['dense_level_tilted']}, tilted table "
          f"{err['tilted_table']}, integral {err['integral_tables']} (also "
          "at 1x1, 320 wide at 15, 16, 17, 33 rows, 53x37)")
    nose = dets["NoseDetector"].part_engines["nose"]
    n_alive = 0
    for what, plan in wide_plans(nose).items():
        for x in (work, noise):
            got = dense_cuda.pyramid_dense_phase(x, plan)
            want = dense_cuda.pyramid_dense_phase_reference(x, plan)
            torch.cuda.synchronize()
            for li, (g, w) in enumerate(zip(got, want)):
                for gt, wt, name in zip(g, w, ("image", "vnf", "alive")):
                    err["pyramid_dense_phase_wide"] = max(
                        err["pyramid_dense_phase_wide"],
                        assert_equal(gt, wt, f"nose {what} level {li} {name}"))
            n_alive += sum(int(a.sum()) for _, _, a in got)
        print(f"pyramid kernel, nose {what}: {len(plan.levels)} levels "
              f"{[(l.sw, l.sh) for l in plan.levels]} in {len(plan.items)} "
              f"bands, smem per block {plan.band_smem_bytes} B, B={BATCH} "
              "faces + noise: == plain (level images, vnf, alive)")
    print(f"pyramid kernel on the wide levels: max |err| "
          f"{err['pyramid_dense_phase_wide']}; alive windows {n_alive}")
    return err


def wide_plans(nose) -> dict:
    """The pyramid kernel's plans of the nose's four wide levels alone (the
    row-strip kernel's levels before): in the default bands, and the widest
    in bands of one grid row."""
    wide = [l for l in nose.levels
            if dense_cuda.pyramid_smem_bytes(l) > dense_cuda.MAX_SMEM_BYTES]
    assert len(wide) == 4, wide
    return {"4 wide levels": dense_cuda.PyramidDensePlan(
                (320, 180), wide, nose._tables),
            "widest level, one grid row a band": dense_cuda.PyramidDensePlan(
                (320, 180), wide[:1], nose._tables, band_target=0)}


def survivor_slots(eng, work) -> list:
    """Per level of a tilted engine on the work images: its tables, vnf
    and, for each block, (plan, window ids, alive) as ``_level_post``
    compacts them, the kernel's flags carried from block to block."""
    out = []
    B = work.shape[0]
    for li in range(len(eng.levels)):
        (ii, iit), vnf, alive = eng._dense_level(work, li)
        caps = eng._level_caps[li]
        sel, sel_alive, _ = eng._compact(alive.bool().reshape(B, -1),
                                         caps[0])
        win_ids, blocks = sel, []
        for bi, plan in enumerate(eng._survivor_plans[li]):
            if bi > 0 and caps[bi] < sel_alive.shape[1]:
                sel2, sel_alive, _ = eng._compact(sel_alive, caps[bi])
                win_ids = win_ids.gather(1, sel2)
            blocks.append((plan, win_ids, sel_alive))
            sel_alive = survivor_cuda.survivor_eval(ii, iit, vnf, win_ids,
                                                    sel_alive, plan)
        out.append((ii, iit, vnf, blocks))
    return out


def blob_mhis(dev, n_frames: int):
    """The tracker's MHIs over the 1280x720 blob clip on `dev`, a frame
    at a time."""
    state = tracker.init_state(FRAME[1], FRAME[0], dev)
    for i, fr in enumerate(blob_clip(n_frames, *FRAME)):
        state, _ = tracker._update(state, fr, i / 30.0, 20, 0.2)
        yield state.mhi


def check_motion_ccl(dev) -> float:
    """The motion labelling kernel vs ``tracker._propagate`` on the card,
    label for label, at 1280x720: ``motion_maps`` and 6 MHIs of the blob
    clip; → max |err|."""
    maps = [torch.from_numpy(m).to(dev)
            for m in motion_maps(FRAME[1], FRAME[0], seed=7).values()]
    maps += list(blob_mhis(dev, 12))[1::2]
    err, n_comp = 0.0, 0
    for mhi in maps:
        got = motion_ccl_cuda.motion_ccl(mhi, 0.05)
        want = tracker._propagate(mhi, 0.05)
        err = max(err, assert_equal(got, want, "motion_ccl labels"))
        n_comp += int(((want == torch.arange(want.numel(), device=dev))
                       & (mhi.reshape(-1) > 0)).sum())
    print(f"motion_ccl: {len(maps)} 1280x720 maps (motion_maps, blob-clip "
          f"MHIs), {n_comp} components: labels == tracker._propagate")
    return err


def check_survivor(dev, dets, part_frames) -> float:
    """The survivor kernel vs its plain version, bit for bit, on every
    level and block of the mouth and both eyes at 320x180, B=64 faces and
    noise; → max |err|."""
    work = work_images(part_frames, (320, 180), dev)
    noise = torch.from_numpy(np.random.RandomState(9).randint(
        0, 256, work.shape, np.uint8)).to(dev)
    err, n_pass = 0.0, 0
    for d in dets.values():
        for name, eng in d.part_engines.items():
            if not eng._uses_tilt:
                continue
            n_in, passed, n_slots = [0, 0], [0, 0], [0, 0]
            for x in (work, noise):
                for li, (ii, iit, vnf, blocks) in enumerate(
                        survivor_slots(eng, x)):
                    for bi, (plan, win_ids, alive) in enumerate(blocks):
                        got = survivor_cuda.survivor_eval(
                            ii, iit, vnf, win_ids, alive, plan)
                        want = survivor_cuda.survivor_eval_reference(
                            ii, iit, vnf, win_ids, alive, plan)
                        err = max(err, assert_equal(
                            got, want, f"survivor {name} level {li} block "
                            f"{bi}"))
                        n_in[bi] += int(alive.sum())
                        passed[bi] += int(got.sum())
                        n_slots[bi] += win_ids.numel()
            smem = max(p.smem_bytes for ps in eng._survivor_plans.values()
                       for p in ps)
            print(f"survivor kernel ({name}, {len(eng.levels)} levels x "
                  f"{len(eng._blocks)} blocks), B={BATCH} faces + noise: == "
                  f"plain (passed flags); slots {n_slots}, alive in "
                  f"{n_in}, passed {passed}; records up to {smem} B")
            if n_in[0] == 0:
                raise AssertionError(f"survivor {name}: no slot alive")
            n_pass += passed[0]
    if n_pass == 0:
        raise AssertionError("survivor kernel: no slot passed a block")
    print(f"survivor kernel: max |err| {err}")
    return err


def layer_inputs(dev, frames_720) -> list[torch.Tensor]:
    """The seven float32 layer inputs of an int8 forward of the B=64 720p
    batch on the card (what the int8 quantizer takes on the main path)."""
    qdet = QuantizedCnnFaceDetector(FRAME, device=dev)
    taps = []
    qdet.model(qdet.letterbox(torch.from_numpy(frames_720).to(dev)), taps)
    return [x for x, _, _ in taps]


def check_quant(dev, xs) -> dict[str, float]:
    """Both quantizers vs their plain versions, exactly; → max |err|."""
    err = {"quantize_int8": 0.0, "quantize_int8_stochastic": 0.0}
    rng = np.random.RandomState(7)
    odd = [torch.from_numpy(rng.randn(n).astype(np.float32) * 3).to(dev)
           for n in (1, 1023, 1025, 2**24 + 3)]
    cases = [(f"layer {i} {tuple(x.shape)}", x) for i, x in enumerate(xs)]
    cases += [(f"{x.numel()} elements", x) for x in odd]
    cases.append(("all zeros", torch.zeros(4096, device=dev)))
    for what, x in cases:
        for g, w in zip(quant_cuda.quantize_int8(x),
                        quant.quantize_int8_reference(x)):
            err["quantize_int8"] = max(err["quantize_int8"], assert_equal(
                g, w, f"quantize_int8 {what}"))
    print(f"int8 quantizer: == plain (values, scale) on the 7 layer inputs "
          f"of a B={BATCH} 720p int8 forward ({[x.numel() for x in xs]} "
          "elements), on 1, 1023, 1025, 2^24+3 elements and all zeros")
    x = xs[1]
    for seed in (1, 2):
        q, scale = quant_cuda.quantize_int8_stochastic(x, seed)
        for g, w in zip((q, scale),
                        quant.quantize_int8_stochastic_reference(x, seed)):
            err["quantize_int8_stochastic"] = max(
                err["quantize_int8_stochastic"],
                assert_equal(g, w, f"stochastic quantizer seed {seed}"))
        r = (x / scale).clamp(-127, 127).double()
        frac = r - r.floor()
        mean = float((q.double() - r).mean())
        sigma = float((frac * (1 - frac)).sum().sqrt()) / r.numel()
        print(f"stochastic quantizer, conv1 input {tuple(x.shape)}, seed "
              f"{seed}: == plain; mean rounding error {mean:.3e} "
              f"(sigma {sigma:.3e})")
        if abs(mean) > 5 * sigma:
            raise AssertionError("stochastic rounding is biased")
    return err


def face_path(dev, frames_720) -> tuple[dict[str, int], object]:
    clip = face_clip(4 * 16, *FRAME, seed=0)
    batches = np.split(clip, 4)
    fd = FaceDetector(FRAME, device=dev)
    reset_counts()
    gpu_faces = []
    for b in batches:
        gpu_faces += fd.process(b)
    torch.cuda.synchronize()
    counts = read_counts()
    print(f"face path: {len(batches)} batches of {len(batches[0])} frames, "
          f"launches {counts}")
    if counts["pyramid_dense_phase"] != len(batches):
        raise AssertionError("expected one pyramid launch per batch")
    n_tracked = sum(len(f) for f in gpu_faces)
    ids = sorted({f.id for fs in gpu_faces for f in fs})
    print(f"tracked faces: {n_tracked} over {len(gpu_faces)} frames, "
          f"ids {ids}")
    if n_tracked < 1:
        raise AssertionError("no face tracked on the synthetic clip")
    fd_cpu = FaceDetector(FRAME, device="cpu")
    cpu_faces = []
    for b in batches:
        cpu_faces += fd_cpu.process(b)

    def as_tuples(faces):
        return [[(f.id, f.rect()) for f in fs] for fs in faces]

    if as_tuples(gpu_faces) != as_tuples(cpu_faces):
        raise AssertionError("CUDA tracked faces differ from the CPU run")
    print("tracked faces: CUDA == CPU, frame by frame (ids and rects)")
    work_cpu = work_images(frames_720, (160, 90), "cpu")
    cand_gpu = fd.engine.candidates(work_cpu.to(dev))
    cand_cpu = fd_cpu.engine.candidates(work_cpu)
    n_cand = 0
    for a, b in zip(cand_gpu, cand_cpu):
        if not np.array_equal(np.sort(a, axis=0), np.sort(b, axis=0)):
            raise AssertionError("CUDA raw candidates differ from the CPU")
        n_cand += len(a)
    if n_cand == 0:
        raise AssertionError("no raw candidates on the synthetic frames")
    print(f"raw candidates: CUDA == CPU on B={BATCH} ({n_cand} windows)")
    return counts, fd.engine


def predicted_launches(det) -> dict[str, int]:
    """Launches per batch that the engines' level routes predict."""
    engines = [det.face_engine, *det.part_engines.values()]
    return {
        "pyramid_dense_phase": sum(e._plan is not None for e in engines),
        "dense_level_tilted": sum(e.routes.count("tilted") for e in engines),
        "tilted_table": sum(e.routes.count("tilted") for e in engines),
        "pyramid_dense_phase_wide": sum(
            e._plan is not None and e._plan.n_wide > 0 for e in engines),
        "integral_tables": sum(e.routes.count("tilted") for e in engines),
        "quantize_int8": 0,
        "quantize_int8_stochastic": 0,
        # one a level and block of each tilted engine
        "survivor_eval": sum(len(plans) for e in engines
                             for plans in e._survivor_plans.values()),
        "motion_ccl": 0,
    }


def part_path(dets, dev) -> dict[str, int]:
    clip = face_clip(PART_BATCHES * PART_BATCH, *FRAME, seed=11)
    batches = np.split(clip, PART_BATCHES)
    total = dict.fromkeys(KERNELS, 0)
    for name, det in dets.items():
        reset_counts()
        out = []
        for b in batches:
            out += det.process(b)
        torch.cuda.synchronize()
        counts = read_counts()
        want = {k: v * PART_BATCHES
                for k, v in predicted_launches(det).items()}
        print(f"{name}: {PART_BATCHES} batches of {PART_BATCH} frames, "
              f"launches {counts} (routes predict {want})")
        if counts != want:
            raise AssertionError(f"{name}: launches differ from the routes")
        if want["dense_level_tilted"] != TILTED_LEVELS[name] * PART_BATCHES:
            raise AssertionError(f"{name}: expected every level of its "
                                 "tilted engines on the tilted kernels")
        for k, v in counts.items():
            total[k] += v
        cpu = type(det)(FRAME, device="cpu")
        cpu_out = []
        for b in batches:
            cpu_out += cpu.process(b)
        if out != cpu_out:
            raise AssertionError(f"{name}: CUDA outputs differ from CPU")
        (fg, pg), (fc, pc) = (det._device_pass(batches[0]),
                              cpu._device_pass(batches[0]))
        for g, c in zip(fg, fc):
            if not np.array_equal(g, c):
                raise AssertionError(f"{name}: grouped faces differ")
        summary = []
        for part in pc:
            for g, c in zip(pg[part], pc[part]):
                if not np.array_equal(g, c):
                    raise AssertionError(f"{name}: raw {part} differ")
            boxes, valid, overflow = pg[part]
            summary.append(f"{part}: {valid.sum(1).tolist()} candidates, "
                           f"overflow {overflow.tolist()}")
        print(f"{name}: outputs, grouped faces ({fg[1].sum(1).tolist()}) "
              f"and raw candidates == CPU; {'; '.join(summary)}; first "
              f"frame {out[0]}")
        if name == "NoseDetector" and not sum(len(r["nose"]) for r in out):
            raise AssertionError("no nose box on the synthetic clip")
        if name == "MouthDetector" and not pg["mouth"][1].sum():
            raise AssertionError("no mouth candidate on the synthetic clip")
        for part, eng in det.part_engines.items():
            if not eng._uses_tilt:
                continue
            work = work_images(batches[0], (320, 180), dev)
            alive = sum(int(eng._dense_level(work, li)[2].sum())
                        for li in range(len(eng.levels)))
            print(f"{name} {part}: {alive} windows alive after the dense "
                  "phase")
            if alive == 0:
                raise AssertionError(f"{name} {part}: dense phase vacuous")
    return total


def as_tuples(faces):
    return [[(f.id, f.rect()) for f in fs] for fs in faces]

# ------------------------------------------------------------ ear, tracker
def ear_clip(n: int, seed: int = 0) -> np.ndarray:
    """[n, 720, 1280] uint8: a left- and a right-facing cartoon profile
    head, drifting; the normal pass finds the first, the flipped pass the
    second."""
    return np.stack([profile_scene(
        *FRAME, heads=((340 + 2 * (t % 16), 360, 160, "left"),
                       (940 - 2 * (t % 16), 360, 160, "right")),
        seed=seed + t) for t in range(n)])


def ear_config(pairing: str) -> EarDetectorConfig:
    """The default pairing (synthetic ear + synthetic profile cascade), or
    the real production profile cascade (bundled) with the same ear."""
    if pairing == "default":
        return EarDetectorConfig()
    return EarDetectorConfig(face_cascade_path=find_cascade(REAL_PROFILE))


def ear_detectors(dev) -> dict:
    return {p: EarDetector(FRAME, ear_config(p), device=dev)
            for p in ("default", "real profile")}


def ear_work(det, eng, gray: torch.Tensor) -> torch.Tensor:
    """The engine's work images of the [normal, flipped] batch."""
    both = torch.cat([gray, torch.flip(gray, dims=(2,))])
    return equalize_hist(resize_linear_exact(both, (eng.image_w,
                                                    eng.image_h)))


def check_ear_pyramid(dev, ears, frames) -> tuple[float, float]:
    """The pyramid kernel vs its plain version on each ear pairing's two
    plans (profile faces at 160x90; ears at 320x180, its four wide levels
    in bands) over the [normal, flipped] batch of B=64 720p profile frames,
    128 work images, and noise; → (max |err|, max |err| on the plans that
    hold a wide level)."""
    gray = torch.from_numpy(frames).to(dev)
    err = wide_err = 0.0
    for pairing, det in ears.items():
        for what, eng in (("profile faces", det.face_engine),
                          ("ears", det.part_engines["ear"])):
            work = ear_work(det, eng, gray)
            noise = torch.from_numpy(np.random.RandomState(10).randint(
                0, 256, work.shape, np.uint8)).to(dev)
            n_alive = []
            for x in (work, noise):
                got = dense_cuda.pyramid_dense_phase(x, eng._plan)
                want = dense_cuda.pyramid_dense_phase_reference(x, eng._plan)
                torch.cuda.synchronize()
                for li, (g, w) in enumerate(zip(got, want)):
                    for gt, wt, name in zip(g, w, ("image", "vnf", "alive")):
                        e = assert_equal(gt, wt, f"pyramid ear {pairing} "
                                         f"{what} level {li} {name}")
                        err = max(err, e)
                        if eng._plan.n_wide:
                            wide_err = max(wide_err, e)
                n_alive.append(sum(int(a.sum()) for _, _, a in got))
            p = eng._plan
            print(f"pyramid kernel, ear {pairing} {what} -> work "
                  f"{eng.image_w}x{eng.image_h}, {len(p.levels)} levels in "
                  f"{len(p.items)} bands ({p.n_wide} wide), "
                  f"{work.shape[0]} images: == plain (level images, vnf, "
                  f"alive); alive windows {n_alive[0]} (profiles) "
                  f"{n_alive[1]} (noise); smem per block "
                  f"{p.band_smem_bytes} B, records "
                  f"{'staged' if p.staged else 'through L1'}")
            if pairing == "default" and n_alive[0] == 0:
                raise AssertionError(f"ear {what}: dense phase vacuous")
    return err, wide_err


def record_raw(det) -> list:
    """Keep what ``det._device_pass`` returns on each ``process`` call
    (the grouped faces and compacted part candidates it works from)."""
    seen = []
    run = det._device_pass

    def recorded(gray):
        out = run(gray)
        seen.append(out)
        return out

    det._device_pass = recorded
    return seen


def ear_path(ears, batches) -> dict[str, int]:
    """``EarDetector.process`` over consecutive B=64 batches of one stream
    for each pairing: the pyramid kernel launches as the routes predict
    (twice per batch, once of them with the ear's wide levels); the first
    batch's outputs, grouped profile faces and raw ear candidates equal
    the port's CPU run; the default pairing finds profile faces and ears
    on both the normal and the flipped side."""
    total = dict.fromkeys(KERNELS, 0)
    n = len(batches[0])
    for pairing, det in ears.items():
        raw = record_raw(det)
        reset_counts()
        out = []
        for b in batches:
            out += det.process(b)
        torch.cuda.synchronize()
        counts = read_counts()
        want = {k: v * len(batches)
                for k, v in predicted_launches(det).items()}
        print(f"ear path ({pairing}): {len(batches)} batches of {n} frames "
              f"({2 * n} in the engines), launches {counts} (routes predict "
              f"{want})")
        if counts != want or want["pyramid_dense_phase"] != 2 * len(batches):
            raise AssertionError(f"ear {pairing}: launches differ from the "
                                 "routes")
        for k, v in counts.items():
            total[k] += v
        cpu = EarDetector(FRAME, ear_config(pairing), device="cpu")
        cpu_raw = record_raw(cpu)
        if cpu.process(batches[0]) != out[:n]:
            raise AssertionError(f"ear {pairing}: CUDA outputs differ from "
                                 "the CPU run")
        (fg, pg), (fc, pc) = raw[0], cpu_raw[0]
        for g, c in zip(fg, fc):
            if not np.array_equal(g, c):
                raise AssertionError(f"ear {pairing}: grouped faces differ")
        for g, c in zip(pg["ear"], pc["ear"]):
            if not np.array_equal(g, c):
                raise AssertionError(f"ear {pairing}: raw ears differ")
        det._face_raw, det._n_real = fg, n
        sides = {}
        for name, flipped in (("normal", False), ("flipped", True)):
            found = [det._side_detections(pg, b + n * flipped, flipped)
                     for b in range(n)]
            sides[name] = (sum(len(f) for f, _ in found),
                           sum(len(e) for _, e in found))
        print(f"ear path ({pairing}): outputs, grouped profile faces and raw "
              f"ear candidates == CPU on batch 0; profile faces, ears per "
              f"side {sides}; ear candidates {int(pg['ear'][1].sum())}, "
              f"overflowing frames {int(pg['ear'][2].sum())}; first frame "
              f"{out[0]}")
        if pairing == "default" and min(min(v) for v in sides.values()) < 1:
            raise AssertionError("ear: a side found no profile face or ear")
        del det._device_pass          # the class's own again
    return total


def ear_device_pass(det, gray):
    """The ear detector's device pass on device-resident frames: the flip,
    both images, the profile pass with grouping and the ear engine with
    candidate compaction (``_device_pass`` without the host copies)."""
    def run():
        fe = det.face_engine
        fe.group_device(fe.detect_raw(ear_work(det, fe, gray)),
                        det.FACE_MIN_NEIGHBORS)
        return [eng.compact_raw(eng.detect_raw(ear_work(det, eng, gray)))
                for eng in det.part_engines.values()]
    return run


def time_tracker(dev, frames) -> tuple[float, int]:
    """``Tracker.process`` over `frames` [N,H,W] (host) in one call of
    stream 0, after a first call of stream 1 → (ms per frame, blobs).
    Every frame must be labelled by the motion labelling kernel
    (``vca.tracker.ccl_frames``), with no label-propagation iteration."""
    tr = Tracker(FRAME, device=dev)
    tr.process(frames[:4], stream=1)
    t = tracing.TRACER
    t.enabled = True
    try:
        t.counters.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = tr.process(frames)
        secs = time.perf_counter() - t0
        counters = dict(t.counters)
    finally:
        t.enabled = False
        t.sections.clear()
        t.counters.clear()
    n = len(frames)
    if (counters.get("vca.tracker.ccl_frames") != n
            or "vca.tracker.seg_iterations" in counters):
        raise AssertionError(f"tracker: {n} frames but counters {counters}")
    return secs * 1000.0 / n, sum(len(b) for b in out)


def tracker_path(dev, gpu) -> dict[str, int]:
    """``Tracker.process`` at 1280x720 on the moving-blob clip: blobs per
    frame and the final MHI equal the CPU run over the first frames; then
    the timed run → the kernel launches of the phase (three a frame)."""
    clip = blob_clip(TRACKER_FRAMES, *FRAME)
    n = TRACKER_CPU_FRAMES
    reset_counts()
    got = Tracker(FRAME, device=dev)
    want = Tracker(FRAME, device="cpu")
    g_out, c_out = got.process(clip[:n]), want.process(clip[:n])
    blobs = [len(b) for b in g_out]
    if g_out != c_out:
        raise AssertionError("tracker: CUDA blobs differ from the CPU run")
    assert_equal(got.state.mhi.cpu(), want.state.mhi, "tracker MHI")
    if sum(blobs) == 0:
        raise AssertionError("tracker: no blob on the moving-blob clip")
    print(f"tracker: {n} frames 1280x720, blobs per frame {blobs}: CUDA == "
          f"CPU (blob lists, final MHI)")
    ms, n_blobs = time_tracker(dev, clip)
    print(f"time: Tracker.process {ms:.4f} ms per 1280x720 frame over "
          f"{TRACKER_FRAMES} frames in one call ({n_blobs} blobs), every "
          f"frame labelled by the motion labelling kernel [{gpu}]")
    torch.cuda.synchronize()
    counts = read_counts()
    frames = n + 4 + TRACKER_FRAMES
    want_counts = dict.fromkeys(KERNELS, 0)
    want_counts["motion_ccl"] = motion_ccl_cuda.LAUNCHES * frames
    if counts != want_counts:
        raise AssertionError(f"tracker launches {counts}, expected "
                             f"{want_counts}")
    return counts


def drawing_path(dev, gpu, gray_frames) -> None:
    """``render_detections`` (rect, circle, costume blend) on a B=64 720p
    BGR batch on the card against ``host=True`` (the numpy twins): rect and
    circle exactly; the blend within 1 of the twin (a true division by 255
    and no FMA there) and exactly the port's CPU run on its first frames."""
    rng = np.random.RandomState(9)
    bgr = np.stack([gray_frames, 255 - gray_frames,
                    gray_frames // 2 + 64], -1)
    rects = [[(int(rng.randint(-40, FRAME[0])), int(rng.randint(-40, FRAME[1])),
               int(rng.randint(0, 400)), int(rng.randint(0, 300)))
              for _ in range(rng.randint(0, 9))] for _ in range(len(bgr))]
    overlay = rng.randint(0, 256, (48, 64, 4)).astype(np.uint8)
    overlay[..., 3] = rng.randint(1, 255, (48, 64))
    bgr_dev = torch.from_numpy(bgr).to(dev)
    for mode in ("rect", "circle", "overlay"):
        kw = dict(mode=mode, color=(0, 0, 255))
        if mode == "overlay":
            kw["overlay"] = (overlay, (0.1, -0.2, 1.3, 0.9))
        got = render_detections(bgr, rects, device=dev, **kw)
        if got.device != bgr_dev.device:
            raise AssertionError("render: result is not on the card")
        got = got.cpu().numpy()
        host = render_detections(bgr, rects, host=True, **kw)
        diff = np.abs(got.astype(np.int16) - host)
        note = ""
        if mode == "overlay":
            cpu = render_detections(bgr[:4], rects[:4], device="cpu", **kw)
            if not np.array_equal(cpu.numpy(), got[:4]):
                raise AssertionError("blend: card differs from the CPU run")
            note = (f"; == the port's CPU blend on the first 4 frames; "
                    f"{int((diff > 0).sum())} of {diff.size} values differ "
                    f"from the twin, max {int(diff.max())} (bound 1)")
            if diff.max() > 1:
                raise AssertionError("blend: more than 1 from the twin")
        elif diff.any():
            raise AssertionError(f"render {mode}: card differs from the twin")
        ms = cuda_ms(lambda: render_detections(bgr_dev, rects, **kw), 3)
        print(f"drawing {mode}: B={len(bgr)} 720p BGR, "
              f"{sum(map(len, rects))} boxes: card "
              f"{'== twin' if mode != 'overlay' else 'vs twin'}{note}; "
              f"{ms:.4f} ms per batch on device-resident frames [{gpu}]")



def learned_path(dev) -> dict[str, int]:
    clip = face_clip(LEARNED_BATCHES * BATCH, *FRAME, seed=11)
    batches = np.split(clip, LEARNED_BATCHES)
    qdet = QuantizedCnnFaceDetector(FRAME, device=dev)
    reset_counts()
    out = []
    for b in batches:
        out += qdet.process(b)
    torch.cuda.synchronize()
    counts = read_counts()
    want = {k: 0 for k in KERNELS}
    want["quantize_int8"] = 7 * LEARNED_BATCHES
    print(f"learned path (int8): {LEARNED_BATCHES} batches of {BATCH} "
          f"frames, launches {counts}")
    if counts != want:
        raise AssertionError(f"expected {want}")
    cpu = QuantizedCnnFaceDetector(FRAME, device="cpu")
    cpu_out = []
    for b in batches:
        cpu_out += cpu.process(b)
    if as_tuples(out) != as_tuples(cpu_out):
        raise AssertionError("int8 tracked faces: CUDA differs from CPU")
    n_tracked = sum(len(f) for f in out)
    if n_tracked < 1:
        raise AssertionError("no face tracked by the int8 detector")
    canvas = cpu.letterbox(torch.from_numpy(batches[0]))
    taps_g, taps_c = [], []
    pred_g = qdet.model(canvas.to(dev), taps_g)
    pred_c = cpu.model(canvas, taps_c)
    for i, ((_, qg, sg), (_, qc, sc)) in enumerate(zip(taps_g, taps_c)):
        assert_equal(qg.cpu(), qc, f"int8 layer {i} values")
        assert_equal(sg.cpu(), sc, f"int8 layer {i} scale")
    assert_equal(pred_g.cpu(), pred_c, "int8 forward output")
    print(f"int8: tracked faces ({n_tracked} over {len(out)} frames, ids "
          f"{sorted({f.id for fs in out for f in fs})}), the 7 layers' int8 "
          "tensors and scales and the output: CUDA == CPU")
    bdet, bcpu = (CnnFaceDetector(FRAME, device=d) for d in (dev, "cpu"))
    perr = float((bdet.model(canvas.to(dev)).cpu()
                  - bcpu.model(canvas)).abs().max())
    g_out, c_out = [], []
    for b in batches:
        g_out += bdet.process(b)
        c_out += bcpu.process(b)
    gt, ct = as_tuples(g_out), as_tuples(c_out)
    same = [len(a) == len(b) and all(
        fa[0] == fb[0] and max(abs(u - v) for u, v in zip(fa[1], fb[1])) <= 2
        for fa, fb in zip(a, b)) for a, b in zip(gt, ct)]
    exact = sum(a == b for a, b in zip(gt, ct))
    print(f"bf16: output max |CUDA - CPU| {perr:.4g} (tolerance "
          f"{BF16_ATOL}); tracked faces equal in {exact} of {len(gt)} "
          f"frames, within 2 px in {sum(same)}; "
          f"{sum(len(f) for f in g_out)} faces")
    if perr > BF16_ATOL or not all(same):
        raise AssertionError("bf16 detector: CUDA differs from CPU")
    return counts


def time_quant(dev, gpu, xs, out) -> None:
    """The int8 quantizer over the 7 layer inputs of a B=64 batch, and the
    stochastic one on the conv1 input, with their plain versions, bounds
    and (for the first) the library pair."""
    n_el = sum(x.numel() for x in xs)
    k, p, runs = in_turns(lambda: [quant_cuda.quantize_int8(x) for x in xs],
                          lambda: [quant.quantize_int8_reference(x)
                                   for x in xs], 50, 10)
    # each element read once (4 B) and written once (1 B), plus the scale;
    # abs, max, divide, round and two compares per element
    b_ms, b_by = bound(5.0 * n_el + 4 * len(xs), 6.0 * n_el)
    lib_ms, mism = None, None
    zero = torch.zeros((), dtype=torch.long, device=dev)

    def library_pair():
        return [torch.quantize_per_tensor(
            x, x.abs().amax().clamp(min=1e-8) / 127.0, zero, torch.qint8)
            for x in xs]

    try:
        lib = library_pair()
        mism = sum(int((l.int_repr() != quant_cuda.quantize_int8(x)[0]).sum())
                   for l, x in zip(lib, xs))
        lib_ms = cuda_ms(library_pair, 50)
        lib_note = (f"abs().amax() + torch.quantize_per_tensor {lib_ms:.4f} "
                    f"ms, {mism} of {n_el} values differ from the kernel's")
    except (RuntimeError, NotImplementedError) as e:
        lib_note = ("abs().amax() + torch.quantize_per_tensor does not run "
                    f"on the card: {str(e).splitlines()[0]}")
    out["quantize_int8"] = dict(ms=k, plain_ms=p, bound_ms=b_ms,
                                bound_by=b_by, library_ms=lib_ms)
    print(f"time: int8 quantizer {k:.4f} ms per B={BATCH} 720p batch over "
          f"its 7 calls ({n_el} elements; runs {runs}); bound {b_ms:.4f} ms "
          f"({b_by}); {lib_note} [{gpu}]")
    x = xs[1]
    k, p, runs = in_turns(
        lambda: quant_cuda.quantize_int8_stochastic(x, 1),
        lambda: quant.quantize_int8_stochastic_reference(x, 1), 50, 10)
    # + Philox4x32-10 per 4 elements: 10 rounds of 2 multiplies, 2 high
    # multiplies, 4 xors and the 2 key adds; the add, floor, clamps and the
    # conversion of u per element
    b_ms, b_by = bound(5.0 * x.numel() + 4, (6.0 + 6.0 + 100 / 4)
                       * x.numel())
    out["quantize_int8_stochastic"] = dict(ms=k, plain_ms=p, bound_ms=b_ms,
                                           bound_by=b_by, library_ms=None)
    print(f"time: stochastic int8 quantizer {k:.4f} ms on the conv1 input "
          f"({x.numel()} elements; runs {runs}); bound {b_ms:.4f} ms "
          f"({b_by}); no PyTorch call rounds stochastically [{gpu}]")


def time_tilted(gpu, eye, levels) -> dict[str, dict]:
    """The tilted dense phase on the right eye's levels of the B=64 batch
    at 320x180: (a) the 18 levels (181x102 .. 22x20) that the single-block
    kernel of earlier versions took; (b) all 24; (c) the six largest
    (320x180 .. 199x112) against their route before, the integral kernel
    and the plain tilted table and dense phase on the card. Each with its
    plain version, its bound, and the shares of the table pass (integral
    kernel + tilted table) and of the evaluation kernel; the tilted-table
    kernel alone over the 24 levels."""
    plans, tabs = eye._level_plans, eye._tables
    lis_all = list(levels)
    tables = {li: (ii, sq, dense_level_cuda.tilted_table(ii))
              for li in lis_all
              for ii, sq in [integral_cuda.integral_tables(levels[li])]}

    def dense_phase(lis):
        return lambda: [dense_level_cuda.dense_level_tilted(levels[li],
                                                            plans[li])
                        for li in lis]

    def table_pass(lis):
        return lambda: [dense_level_cuda.tilted_table(
            integral_cuda.integral_tables(levels[li])[0]) for li in lis]

    def evaluation(lis):
        return lambda: [dense_level_cuda._tilted_eval(*tables[li], plans[li])
                        for li in lis]

    def old_route(lis):
        def run():
            for li in lis:
                l = eye.levels[li]
                ii, sq = integral_cuda.integral_tables(levels[li])
                tabs.evaluate(ii, sq, tilted_integral_image(levels[li]),
                              l.ny, l.nx, l.ystep)
        return run

    out: dict[str, dict] = {}
    for tag, lis, what in (
            ("a", lis_all[6:], "18 levels 181x102 .. 22x20 (the "
             "single-block kernel's before)"),
            ("b", lis_all, "all 24 levels 320x180 .. 22x20"),
            ("c", lis_all[:6], "6 largest levels 320x180 .. 199x112")):
        k, p, runs = in_turns(dense_phase(lis), lambda: [
            dense_level_cuda.dense_level_reference(levels[li], plans[li])
            for li in lis], 20, 2)
        res = dense_phase(lis)()
        n_bytes = sum(levels[li].numel() + 8 * ii.numel() + 5 * vnf.numel()
                      for li, (ii, _, vnf, _) in zip(lis, res))
        # + per table element: the sum, squared-sum and tilted tables (12)
        n_ops = sum(dense_ops(tabs, vnf, alive) + 12.0 * ii.numel()
                    for ii, _, vnf, alive in res)
        b_ms, b_by = bound(n_bytes, n_ops)
        t_ms = cuda_ms(table_pass(lis), 20)
        i_ms = cuda_ms(lambda: [integral_cuda.integral_tables(levels[li])
                                for li in lis], 20)
        e_ms = cuda_ms(evaluation(lis), 20)
        note = ""
        if tag == "c":
            o_k, o_ms, oruns = in_turns(dense_phase(lis), old_route(lis), 20,
                                        3)
            note = (f"; before: integral kernel + plain tilted table and "
                    f"dense phase {o_ms:.4f} ms (in turns with the kernels' "
                    f"{o_k:.4f} ms; runs {oruns})")
        if tag == "b":
            out["dense_level_tilted"] = dict(ms=k, plain_ms=p, bound_ms=b_ms,
                                             bound_by=b_by, library_ms=None)
        print(f"time: tilted dense phase ({tag}) {k:.4f} ms per B={BATCH} "
              f"batch over the right eye's {what}; runs {runs}; plain "
              f"{p:.4f} ms; bound {b_ms:.4f} ms ({b_by}); table pass "
              f"{t_ms:.4f} ms (integral kernel {i_ms:.4f}, tilted table "
              f"{t_ms - i_ms:.4f}), evaluation {e_ms:.4f} ms{note} "
              f"[{gpu}]")

    k, p, runs = in_turns(
        lambda: [dense_level_cuda.tilted_table(tables[li][0])
                 for li in lis_all],
        lambda: [tilted_from_integral(tables[li][0]) for li in lis_all],
        50, 10)
    n_el = sum(tables[li][0].numel() for li in lis_all)
    # ii read once and the tilted table written once; per element the
    # difference of two rows and three adds
    b_ms, b_by = bound(8.0 * n_el, 4.0 * n_el)
    out["tilted_table"] = dict(ms=k, plain_ms=p, bound_ms=b_ms, bound_by=b_by,
                               library_ms=None)
    print(f"time: tilted-table kernel {k:.4f} ms per B={BATCH} batch over "
          f"the right eye's 24 levels; runs {runs}; plain {p:.4f} ms; bound "
          f"{b_ms:.4f} ms ({b_by}); no PyTorch call builds a tilted table "
          f"[{gpu}]")
    return out


def kernels_us(fn) -> tuple[float, str]:
    """(device µs of all kernels of one call of fn, mean over 3 calls
    under torch.profiler; the kernel with the most time)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
    rows = sorted(((float(getattr(e, "device_time_total", 0.0)) / 3, e.key)
                   for e in prof.key_averages()), reverse=True)
    return sum(us for us, _ in rows), rows[0][1][:60] if rows else ""


def time_survivor(gpu, dets, part) -> dict:
    """The survivor kernel over both eye engines' 24 levels and 2 blocks
    of the B=64 batch at 320x180 (96 launches, a call's worth on the
    eye path), on the slots ``_level_post`` compacts, with its plain
    version, its kernels alone and its bound: both tables of every level
    read once and, per slot, its window id, alive flag and vnf read and
    its flag written (14 B), against each live slot's every feature and
    tree (at most: 4 corner adds, a multiply and an add a rect, the
    conversion and the vnf multiply a feature, a compare and the stage
    add a tree)."""
    calls, n_bytes, n_ops = [], 0.0, 0.0
    for eng in dets["EyeDetector"].part_engines.values():
        for li, (ii, iit, vnf, blocks) in enumerate(survivor_slots(eng,
                                                                   part)):
            n_bytes += 2.0 * ii.numel() * 4
            for plan, win_ids, alive in blocks:
                calls.append((ii, iit, vnf, win_ids, alive, plan))
                b = plan.block
                n_bytes += 14.0 * win_ids.numel()
                n_ops += float(alive.sum()) * float(
                    6 * b.n_rects.sum() + 2 * len(b.n_rects)
                    + 2 * len(b.feat))
    kernel = lambda: [survivor_cuda.survivor_eval(*c) for c in calls]
    plain = lambda: [survivor_cuda.survivor_eval_reference(*c)
                     for c in calls]
    k, p, runs = in_turns(kernel, plain, 20, 2)
    k_us, top = kernels_us(kernel)
    b_ms, b_by = bound(n_bytes, n_ops)
    print(f"time: survivor kernel {k:.4f} ms per B={BATCH} batch over both "
          f"eye engines' {len(calls)} levels x blocks; runs {runs}; kernels "
          f"alone {k_us:.1f} us ({top}); plain {p:.4f} ms; bound "
          f"{b_ms:.4f} ms ({b_by}; {n_bytes / 1e6:.2f} MB, "
          f"{n_ops / 1e9:.3f} G ops) [{gpu}]")
    return dict(ms=k, plain_ms=p, bound_ms=b_ms, bound_by=b_by,
                library_ms=None, kernels_us=k_us)


def time_motion_ccl(dev, gpu) -> dict:
    """The motion labelling kernel on one 1280x720 MHI of the blob clip
    (its 8th frame), in turns with ``tracker._propagate``, with its
    kernels alone and its bound: the float32 MHI read once and the int64
    labels written once (12 B a pixel)."""
    mhi = list(blob_mhis(dev, 8))[-1]
    kernel = lambda: motion_ccl_cuda.motion_ccl(mhi, 0.05)
    plain = lambda: tracker._propagate(mhi, 0.05)
    k, p, runs = in_turns(kernel, plain, 200, 5)
    k_us, top = kernels_us(kernel)
    b_ms, b_by = bound(12.0 * mhi.numel(), 0.0)
    print(f"time: motion labelling kernel {k:.4f} ms per 1280x720 frame "
          f"({motion_ccl_cuda.LAUNCHES} launches); runs {runs}; kernels "
          f"alone {k_us:.1f} us ({top}); plain {p:.4f} ms; bound "
          f"{b_ms:.4f} ms ({b_by}; {12.0 * mhi.numel() / 1e6:.2f} MB) "
          f"[{gpu}]")
    # the whole frame in motion: one component over every tile, the
    # longest root chains of the border and flatten passes
    full = torch.ones_like(mhi)
    u_us, u_top = kernels_us(lambda: motion_ccl_cuda.motion_ccl(full, 0.05))
    print(f"time: motion labelling kernel on a uniform 1280x720 MHI, "
          f"kernels alone {u_us:.1f} us ({u_top}) [{gpu}]")
    return dict(ms=k, plain_ms=p, bound_ms=b_ms, bound_by=b_by,
                library_ms=None, kernels_us=k_us)


def part_device_pass(det, gray):
    """The part detector's device pass on device-resident frames: both
    images, the face pass with grouping, each part engine with candidate
    compaction (``_device_pass`` without the host copies)."""
    def run():
        face = equalize_hist(resize_linear_exact(gray,
                                                 (det.face_w, det.face_h)))
        part = equalize_hist(resize_linear_exact(gray,
                                                 (det.part_w, det.part_h)))
        fe = det.face_engine
        fe.group_device(fe.detect_raw(face), det.FACE_MIN_NEIGHBORS)
        return [eng.compact_raw(eng.detect_raw(part))
                for eng in det.part_engines.values()]
    return run


def time_pyramid(gpu, work, plan, what) -> dict:
    """The pyramid kernel on one launch's levels, with its plain version
    and bound; the kernel's outputs are held to the plain version's."""
    k, p, runs = in_turns(lambda: dense_cuda.pyramid_dense_phase(work, plan),
                          lambda: dense_cuda.pyramid_dense_phase_reference(
                              work, plan), 50, 5)
    pyramid_equal(work, plan, what)
    res = dense_cuda.pyramid_dense_phase(work, plan)
    n_bytes = work.numel() + sum(
        (img.numel() if img is not None else 0) + 5 * vnf.numel()
        for img, vnf, _ in res)
    # + per level pixel: the 2-tap resize (8) and the two tables (4)
    n_ops = sum(dense_ops(plan.tables, vnf, alive) + 12.0 * work.shape[0]
                * l.sh * l.sw for l, (_, vnf, alive) in zip(plan.levels, res))
    b_ms, b_by = bound(n_bytes, n_ops)
    print(f"time: pyramid dense kernel {k:.4f} ms per {work.shape[0]}-image "
          f"batch of {work.shape[2]}x{work.shape[1]} work images "
          f"over {what} ({len(plan.levels)} levels in {len(plan.items)} "
          f"bands; runs {runs}); plain {p:.4f} ms; bound {b_ms:.4f} ms "
          f"({b_by}) [{gpu}]")
    return dict(ms=k, plain_ms=p, bound_ms=b_ms, bound_by=b_by,
                library_ms=None)


def time_integral(gpu, imgs, what) -> dict:
    """The integral kernel over a list of level images [B, h, w], with its
    plain version, the torch.cumsum pair and its bound."""
    k, p, runs = in_turns(
        lambda: [integral_cuda.integral_tables(x) for x in imgs],
        lambda: [integral_cuda.integral_tables_reference(x) for x in imgs],
        50, 10)

    def cumsum_pair():
        for x in imgs:
            x = x.to(torch.int32)
            torch.cumsum(torch.cumsum(x, -1, dtype=torch.int32), -2,
                         dtype=torch.int32)
            torch.cumsum(torch.cumsum(x * x, -1, dtype=torch.int32), -2,
                         dtype=torch.int32)

    lib_ms = cuda_ms(cumsum_pair, 50)
    # each pixel read once, both tables written once; a multiply and
    # two adds per pixel and table
    n_bytes = sum(x.numel() + 8 * x.shape[0] * (x.shape[1] + 1)
                  * (x.shape[2] + 1) for x in imgs)
    b_ms, b_by = bound(n_bytes, sum(6.0 * x.numel() for x in imgs))
    print(f"time: integral kernel {k:.4f} ms per B={BATCH} batch over {what}; "
          f"runs {runs}; plain {p:.4f} ms; torch.cumsum pair {lib_ms:.4f} ms; "
          f"bound {b_ms:.4f} ms ({b_by}) [{gpu}]")
    return dict(ms=k, plain_ms=p, bound_ms=b_ms, bound_by=b_by,
                library_ms=lib_ms)


def level_images(part, eng) -> dict[int, torch.Tensor]:
    return {li: resize_linear_exact(part, (l.sw, l.sh))
            for li, l in enumerate(eng.levels)}


# ------------------------------------------------------------------ serving
def _trap(fn, errors: list, seconds: list, calls: list | None = None):
    """`fn` recording every exception it raises (the media loop catches and
    prints an element's exception and goes on), the host seconds of each
    call and, with `calls`, the batch size of each call."""
    def wrapped(frames, *args, **kwargs):
        if calls is not None:
            calls.append(len(frames))
        t0 = time.perf_counter()
        try:
            return fn(frames, *args, **kwargs)
        except Exception:
            errors.append(traceback.format_exc())
            raise
        finally:
            seconds.append(time.perf_counter() - t0)
    return wrapped


def _timed(fn, steps: list):
    def wrapped(frames, *args, **kwargs):
        t0 = time.perf_counter()
        try:
            return fn(frames, *args, **kwargs)
        finally:
            steps.append((len(frames), time.perf_counter() - t0))
    return wrapped


def _color(gray: np.ndarray) -> np.ndarray:
    """BGR frames whose luma keeps the gray frames' faces."""
    return np.stack([gray, np.clip(gray.astype(np.int32) + 12, 0, 255),
                     np.clip(gray.astype(np.int32) - 15, 0, 255)],
                    -1).astype(np.uint8)


class _Stream:
    """One TCP stream of raw frames into a pipeline's media port, paced so
    that at most SERVE_WINDOW frames are in flight (sent and not yet
    processed, asked over RPC), with an optional reader of the annotated
    frames written back on the same connection."""

    def __init__(self, cli, pipe_id: str, port: int, frames: np.ndarray,
                 read_back: bool):
        self.cli, self.pipe_id, self.frames = cli, pipe_id, frames
        self.sock = socket.create_connection(("127.0.0.1", port), timeout=120)
        self.back = bytearray()
        self.want_back = frames.nbytes if read_back else 0
        self.error: list[str] = []
        self.t_first = self.t_done = self.t_read = 0.0
        # daemon threads: a stream that hangs must not keep a failed run
        # from exiting
        self.threads = [threading.Thread(target=self._send, daemon=True)]
        if read_back:
            self.threads.append(threading.Thread(target=self._read,
                                                 daemon=True))
        for t in self.threads:
            t.start()

    def processed(self) -> int:
        return self.cli.call("invoke", {
            "object": self.pipe_id, "operation": "framesProcessed",
            "operationParams": {}})["value"]

    def _send(self) -> None:
        try:
            self.t_first = time.perf_counter()
            for i, fr in enumerate(self.frames):
                while i - self.processed() >= SERVE_WINDOW:
                    time.sleep(0.005)
                self.sock.sendall(fr.tobytes())
            while self.processed() < len(self.frames):
                time.sleep(0.005)
            self.t_done = time.perf_counter()
        except Exception:      # reported by join()
            self.error.append(traceback.format_exc())

    def _read(self) -> None:
        try:
            while len(self.back) < self.want_back:
                chunk = self.sock.recv(1 << 22)
                if not chunk:
                    break
                self.back.extend(chunk)
            self.t_read = time.perf_counter()
        except Exception:
            self.error.append(traceback.format_exc())

    def join(self) -> float:
        """Wait for both ends → seconds from the first frame sent to the
        last frame processed (and read back)."""
        for t in self.threads:
            t.join(SERVE_TIMEOUT)
        self.sock.close()
        if any(t.is_alive() for t in self.threads):
            raise AssertionError("serving: a stream did not finish")
        if self.error:
            raise AssertionError("serving stream failed:\n"
                                 + "\n".join(self.error))
        if len(self.back) != self.want_back:
            raise AssertionError(f"serving: read back {len(self.back)} of "
                                 f"{self.want_back} bytes")
        return max(self.t_done, self.t_read) - self.t_first


def serving_path(dev, gpu) -> dict[str, int]:
    """Phase 10: a ``VcaRpcServer`` on the card, driven by the generated
    Python client, serving two pipelines of 1280x720 streams at once."""
    sys.path.insert(0, os.path.join(ROOT, "clients", "python"))
    import nubomedia_vca_client as gen

    if ingest_binding._load() is None:
        raise AssertionError("serving: the native ingest did not build")
    gray = face_clip(SERVE_FRAMES, *FRAME, seed=5)
    bgr = _color(gray)
    srv = rpc.VcaRpcServer(port=0, frame_size=FRAME).start()
    if srv.device != dev:
        raise AssertionError(f"serving: the server runs on {srv.device}")
    cli = gen.KurentoClient("127.0.0.1", srv.port)
    errors: list[str] = []
    events: dict[str, list] = {"A": [], "B": [], "B parts": []}
    steps: dict[str, list] = {"A": [], "B": []}
    a_calls: list[int] = []
    el_secs: dict[str, list] = {}

    def invoke(oid, op, **params):
        return cli.call("invoke", {"object": oid, "operation": op,
                                   "operationParams": params},
                        timeout=600)["value"]

    def listen(name, pipe_id, step_times) -> int:
        """Open pipeline `name`'s media port; its loop steps are timed."""
        port = invoke(pipe_id, "listen", port=0, **SERVE_LISTEN[name])
        runner = srv.objects[pipe_id]._runner
        if type(runner.ingest).__name__ != "NativeIngest":
            raise AssertionError(f"serving {name}: ingest is "
                                 f"{type(runner.ingest).__name__}")
        runner._step = _timed(runner._step, step_times)
        return port

    try:
        # A: tracker → face → event-gated eye, annotated BGR frames back
        pa = cli.create_pipeline()
        tracker_el = pa.createNuboTracker()
        face = pa.createNuboFaceDetector()
        eye = pa.createNuboEyeDetector()
        eye.detectByEvent(1)
        face.activateServerEvents(1, 1)
        face.onFace(events["A"].append)
        # B: int8 learned faces + learned parts on work-res luma
        pb = cli.create_pipeline()
        cnn = pb.createNuboCnnFaceDetector()
        cnn.setQuantized(1)
        parts = pb.createNuboCnnPartDetector()
        cnn.activateServerEvents(1, 1)
        cnn.onFace(events["B"].append)
        parts.activateServerEvents(1, 1)
        parts.onPart(events["B parts"].append)
        for oid in (tracker_el.id, face.id, eye.id, cnn.id, parts.id):
            el = srv.objects[oid]
            calls = a_calls if oid == tracker_el.id else None
            name = type(el).__name__
            el.process = _trap(el.process, errors,
                               el_secs.setdefault(f"{name}.process", []),
                               calls)
            el.render = _trap(el.render, errors,
                              el_secs.setdefault(f"{name}.render", []))
        reset_counts()
        port_a = listen("A", pa.id, steps["A"])
        port_b = listen("B", pb.id, steps["B"])
        sa = _Stream(cli, pa.id, port_a, bgr, read_back=True)
        sb = _Stream(cli, pb.id, port_b, gray, read_back=False)
        secs = {"A": sa.join(), "B": sb.join()}
        torch.cuda.synchronize()
        stats = {"A": invoke(pa.id, "getStats"), "B": invoke(pb.id,
                                                             "getStats")}
        counts = read_counts()
        for p in (pa, pb):
            invoke(p.id, "stopMedia")
        a_batches = list(a_calls)
        el_report = {k: list(v) for k, v in el_secs.items()}
        # then each pipeline alone, on its first SERVE_SOLO frames
        solo = {}
        for name, p, frames in (("A", pa, bgr[:SERVE_SOLO]),
                                ("B", pb, gray[:SERVE_SOLO])):
            solo_steps: list = []
            port = listen(name, p.id, solo_steps)
            solo[name] = (_Stream(cli, p.id, port, frames,
                                  read_back=name == "A").join(), solo_steps)
            invoke(p.id, "stopMedia")
    finally:
        cli.close()
        srv.stop()
    for name, what in (("A", "tracker -> face -> eye(detectByEvent), "
                        "listen(channels=3, output=1)"),
                       ("B", "int8 CNN face + CNN parts, "
                        "listen(channels=1, downscale=1)")):
        st, ms = stats[name], [s * 1000.0 for _, s in steps[name]]
        sizes = [n for n, _ in steps[name]]
        print(f"serving {name} ({what}): {SERVE_FRAMES} paced "
              f"{FRAME[0]}x{FRAME[1]} frames over TCP in {secs[name]:.3f} s, "
              f"{SERVE_FRAMES / secs[name]:.1f} frames/s; {len(ms)} loop "
              f"steps of {min(sizes)}-{max(sizes)} frames, mean "
              f"{np.mean(ms):.3f} ms, median {np.median(ms):.3f} ms, max "
              f"{max(ms):.3f} ms per step; stats {json.dumps(st)} [{gpu}]")
        alone, alone_steps = solo[name]
        ams = [s * 1000.0 for _, s in alone_steps]
        print(f"serving {name} alone: {SERVE_SOLO} paced frames in "
              f"{alone:.3f} s, {SERVE_SOLO / alone:.1f} frames/s; "
              f"{len(ams)} loop steps, mean {np.mean(ams):.3f} ms, median "
              f"{np.median(ams):.3f} ms per step [{gpu}]")
        if st["framesProcessed"] + st["dropped"] != SERVE_FRAMES \
                or st["dropped"]:
            raise AssertionError(f"serving {name}: frames lost: {st}")
    print("serving: host ms per loop step by element call (mean, median; "
          "both loops and the pacing RPCs share one interpreter): "
          + "; ".join(f"{k} {1000 * np.mean(v):.3f}, "
                      f"{1000 * np.median(v):.3f}"
                      for k, v in el_report.items() if v) + f" [{gpu}]")
    if stats["A"]["framesSent"] != SERVE_FRAMES or stats["A"]["outDropped"]:
        raise AssertionError(f"serving A: annotated frames lost: "
                             f"{stats['A']}")
    if stats["B"]["downscale"] != [320, 320 * FRAME[1] // FRAME[0]]:
        raise AssertionError(f"serving B: downscale {stats['B']}")
    if errors:
        raise AssertionError("serving: an element raised inside the "
                             "loop:\n" + "\n".join(errors))
    print(f"serving events over RPC: A OnFace {len(events['A'])}, B OnFace "
          f"{len(events['B'])}, B OnPart {len(events['B parts'])}; launches "
          f"{counts}")
    if not events["A"] or not events["B"]:
        raise AssertionError("serving: no OnFace event on a pipeline")
    missing = [k for k, v in counts.items() if v == 0 and k not in OFF_PATH
               and k != "pyramid_dense_phase_wide"]
    if missing:
        raise AssertionError(f"serving: kernels never launched: {missing}")
    # A's annotated frames against the same chain called directly on the
    # card, in the loop's batches
    pipe = objects.MediaPipeline(FRAME, device=dev)
    objects.NuboTracker(pipe)
    objects.NuboFaceDetector(pipe)
    objects.NuboEyeDetector(pipe).detectByEvent(1)
    runner = media_loop.MediaRunner(pipe)
    direct: list[np.ndarray] = []
    runner.on_annotated = lambda out, stream: direct.append(out)
    bgr_dev = torch.from_numpy(bgr).to(dev)
    luma = bgr_to_gray(bgr_dev).cpu().numpy()
    i = 0
    for n in a_batches:
        runner._step(luma[i:i + n], stream=0, color=bgr[i:i + n])
        i += n
    pipe.release()
    got = np.frombuffer(bytes(sa.back), np.uint8).reshape(bgr.shape)
    want = np.concatenate(direct)
    if not np.array_equal(got, want):
        raise AssertionError(
            f"serving A: annotated frames differ from the direct chain in "
            f"{int((got != want).any(-1).sum())} pixels")
    drawn = int((got != bgr).any(-1).sum())
    if drawn == 0:
        raise AssertionError("serving A: nothing drawn on the frames")
    print(f"serving A: {SERVE_FRAMES} annotated frames read back == the "
          f"chain called directly on the card in the loop's {len(a_batches)} "
          f"batches ({drawn} pixels drawn); native ingest on both "
          f"pipelines, no element exception")
    # A's tracker alone on the served frames (phase 8 times it on the blob
    # clip)
    ms, _ = time_tracker(dev, gray)
    print(f"serving: A's tracker alone on the {SERVE_FRAMES} served frames, "
          f"Tracker.process {ms:.4f} ms per frame [{gpu}]")
    return counts


# ---------------------------------------------------------------- training
def synth_scene(rng, return_geom: bool = False):
    """cv2-free stand-in for ``distill.make_scene``: a 320x240
    ``utils/synth.face_scene`` frame with one cartoon face at a random
    place and size over noise, and no ignore geometry."""
    s = int(rng.randint(28, 72))
    face = (int(rng.randint(s, distill.W - s)),
            int(rng.randint(s, distill.H - s)), s)
    img = face_scene(distill.W, distill.H, faces=(face,),
                     seed=int(rng.randint(1 << 30)),
                     bg=int(rng.randint(90, 200)))
    return (img, []) if return_geom else img


def teacher_parts_scene(teacher):
    """cv2-free stand-in for ``cnn_parts.scene_with_parts``: a
    ``synth_scene`` frame whose face class carries the teacher's boxes;
    the other classes carry none."""
    def scene(rng):
        img = synth_scene(rng)
        boxes, valid = distill.label_batch(teacher, img[None])
        out = np.zeros((cnn_parts.C, cnn_parts.MAX_PER_CLASS, 4), np.float32)
        val = np.zeros((cnn_parts.C, cnn_parts.MAX_PER_CLASS), bool)
        out[0, :distill.MAX_FACES] = boxes[0]
        val[0, :distill.MAX_FACES] = valid[0]
        return img, out, val
    return scene


def teacher_launches(teacher, n_batches: int) -> dict[str, int]:
    """Launches of ``n_batches`` labelled batches that the teacher's
    plan predicts: one #1 launch each, with its wide-level bands."""
    want = dict.fromkeys(KERNELS, 0)
    want["pyramid_dense_phase"] = n_batches
    want["pyramid_dense_phase_wide"] = n_batches * (teacher._plan.n_wide > 0)
    return want


def params_close(got: dict, want: dict, lr_sum: float) -> tuple[float,
                                                                  float]:
    """(max, median) |difference| of two nested parameter dicts; raises
    past 2·lr_sum or a median of CARD_PARAM_MEDIAN."""
    d = np.concatenate([np.abs(got[n][k] - want[n][k]).ravel()
                        for n in want for k in want[n]])
    if d.max() > 2 * lr_sum or np.median(d) > CARD_PARAM_MEDIAN:
        raise AssertionError(f"parameters differ: max {d.max()}, median "
                             f"{np.median(d)}")
    return float(d.max()), float(np.median(d))


def grads_close(got: dict, want: dict) -> tuple[str, float]:
    """(leaf, gap) of the worst leaf: max |difference| of two gradients
    as a share of the leaf's largest |gradient|; raises past
    CARD_GRAD_TOL."""
    gaps = {k: float((got[k] - w).abs().max() / w.abs().max())
            for k, w in want.items()}
    leaf = max(gaps, key=gaps.get)
    if gaps[leaf] > CARD_GRAD_TOL:
        raise AssertionError(f"step 0's gradients differ: {gaps}")
    return leaf, gaps[leaf]


def training_path(dev, gpu) -> dict[str, int]:
    """Phase 11: the teacher, the face trainer and the parts trainer on
    the card at the shipped width (B=32, 320x240), each launch counted;
    then the card against the card host's CPU, a train-state round trip,
    and the step's time and memory."""
    total = dict.fromkeys(KERNELS, 0)

    def count(counts):
        for k, v in counts.items():
            total[k] += v

    teacher = distill.make_teacher(dev)
    cpu_teacher = distill.make_teacher("cpu")
    frames = face_clip(TRAIN_BATCH, distill.W, distill.H, seed=5)
    reset_counts()
    labels = distill.label_batch(teacher, frames)
    torch.cuda.synchronize()
    counts = read_counts()
    want = teacher_launches(teacher, 1)
    print(f"teacher: {len(teacher.levels)} levels at {distill.W}x"
          f"{distill.H} ({teacher._plan.n_wide} wide) in "
          f"{len(teacher._plan.items)} bands; one labelled batch of "
          f"{TRAIN_BATCH}: launches {counts}")
    if counts != want:
        raise AssertionError(f"teacher launches: expected {want}")
    count(counts)
    for g, c in zip(labels, distill.label_batch(cpu_teacher, frames)):
        if not np.array_equal(g, c):
            raise AssertionError("teacher labels: CUDA differs from CPU")
    if not labels[1].any():
        raise AssertionError("the teacher found no face on face_clip")
    print(f"teacher labels == CPU ({int(labels[1].sum())} faces in "
          f"{TRAIN_BATCH} frames)")

    # distill.train itself, make_scene replaced by the cv2-free source;
    # cnn.train_step is wrapped to read every step's loss and whether the
    # parameters moved (count 0 of the schedule moves nothing)
    losses, snaps = [], []
    real_step = cnn.train_step

    def recorded_step(model, *args, **kw):
        if len(losses) < 3:
            snaps.append([p.detach().clone() for p in model.parameters()])
        out = real_step(model, *args, **kw)
        losses.append(out[0])
        return out

    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "student.npz")
        n_labels = TRAIN_POOL + (TRAIN_STEPS - 1) // TRAIN_REGEN
        with mock.patch.object(distill, "make_scene", synth_scene), \
                mock.patch.object(cnn, "train_step", recorded_step):
            reset_counts()
            t0 = time.perf_counter()
            params, final = distill.train(
                steps=TRAIN_STEPS, batch=TRAIN_BATCH, lr=TRAIN_LR,
                n_pool=TRAIN_POOL, regen_every=TRAIN_REGEN, log_every=10,
                save_every=0, out=out, device=dev)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            counts = read_counts()
        print(f"distill.train: {TRAIN_STEPS} steps, {n_labels} labelled "
              f"batches in {secs:.2f} s, launches {counts}")
        if counts != teacher_launches(teacher, n_labels):
            raise AssertionError("distill.train: teacher launches differ")
        count(counts)
        steps_loss = torch.stack(losses).cpu().numpy()
        if len(steps_loss) != TRAIN_STEPS or not np.isfinite(
                steps_loss).all():
            raise AssertionError(f"distill.train losses {steps_loss}")
        still = all(torch.equal(a, b) for a, b in zip(snaps[0], snaps[1]))
        moved = not all(torch.equal(a, b) for a, b in zip(snaps[1], snaps[2]))
        if not (still and moved):
            raise AssertionError("expected step 0 to move nothing and step "
                                 "1 to move the parameters")
        det = CnnFaceDetector((distill.W, distill.H), checkpoint=out,
                              device=dev)
        res = det.process(frames)
        print(f"distill.train: losses {np.round(steps_loss, 4).tolist()} "
              f"(final {final:.4f}), step 0 moved nothing, step 1 moved "
              f"the parameters; the saved npz serves on the card "
              f"({sum(len(r) for r in res)} faces on {len(res)} frames)")

    scene = teacher_parts_scene(teacher)
    with mock.patch.object(cnn_parts, "scene_with_parts", scene):
        reset_counts()
        pparams, pfinal = cnn_parts.train(
            steps=PARTS_STEPS, batch=TRAIN_BATCH, lr=TRAIN_LR,
            n_pool=PARTS_POOL, regen_every=0, log_every=PARTS_STEPS - 1,
            device=dev)
        torch.cuda.synchronize()
        counts = read_counts()
    print(f"cnn_parts.train: {PARTS_STEPS} steps, C={cnn_parts.C} with ctx, "
          f"final loss {pfinal:.4f}, launches {counts} (the teacher on "
          f"each of {PARTS_POOL * TRAIN_BATCH} scenes)")
    if counts != teacher_launches(teacher, PARTS_POOL * TRAIN_BATCH) \
            or not np.isfinite(pfinal):
        raise AssertionError("cnn_parts.train on the card")
    count(counts)
    res = cnn_parts.CnnPartDetector((distill.W, distill.H), params=pparams,
                                    device=dev).process(frames[:4])
    print(f"cnn_parts: the trained weights serve on the card "
          f"({len(res)} frames)")

    # the face trainer's first steps, card against the card host's CPU,
    # from the same carried weights and the same pool
    params0 = cnn.init_params(torch.Generator().manual_seed(1), ctx=True)
    rng = np.random.RandomState(3)
    with mock.patch.object(distill, "make_scene", synth_scene):
        pool = [distill.pool_entry(teacher, rng, TRAIN_BATCH)
                for _ in range(PARITY_STEPS)]

    def run(d, entries):
        """(model, opt, sched, losses, lrs, step 0's gradients on the
        host): the gradients stay on the parameters after the step."""
        model = cnn.CnnNet(params0).to(d)
        opt, sched = cnn.make_optimizer(model.parameters(), TRAIN_LR,
                                        steps=TRAIN_STEPS)
        losses, lrs = [], []
        for e in entries:
            lrs.append(opt.param_groups[0]["lr"])
            losses.append(float(cnn.train_step(model, opt, sched,
                                               *(t.to(d) for t in e))[0]))
            if len(losses) == 1:
                grads = {k: p.grad.detach().cpu()
                         for k, p in model.named_parameters()}
        return model, opt, sched, losses, lrs, grads

    gmodel, gopt, gsched, g_losses, lrs, g_grads = run(dev, pool)
    cmodel, _, _, c_losses, _, c_grads = run("cpu", pool)
    rel = max(abs(a - b) / abs(b) for a, b in zip(g_losses, c_losses))
    leaf, gap = grads_close(g_grads, c_grads)
    pmax, pmed = params_close(cnn.params_to_numpy(gmodel.state_dict()),
                              cnn.params_to_numpy(cmodel.state_dict()),
                              sum(lrs))
    print(f"train steps card vs CPU: losses {g_losses} / {c_losses} (max "
          f"relative {rel:.3g}, tolerance {CARD_LOSS_RTOL}); step 0's "
          f"gradients: worst leaf {leaf} within {gap:.3g} of its largest "
          f"|gradient| (tolerance {CARD_GRAD_TOL}); parameters max |diff| "
          f"{pmax:.3g}, median {pmed:.3g} (bounds {2 * sum(lrs):.3g} = "
          f"2·Σ lr {lrs}, {CARD_PARAM_MEDIAN:.3g})")
    if rel > CARD_LOSS_RTOL:
        raise AssertionError("train step losses: card differs from CPU")

    # train-state round trip on the card after PARITY_STEPS steps
    with tempfile.TemporaryDirectory() as tmp:
        checkpoint.save_train_state(tmp, gmodel, gopt, gsched, PARITY_STEPS)
        model2 = cnn.CnnNet(cnn.init_params(
            torch.Generator().manual_seed(2), ctx=True)).to(dev)
        opt2, sched2 = cnn.make_optimizer(model2.parameters(), TRAIN_LR,
                                          steps=TRAIN_STEPS)
        step = checkpoint.load_train_state(tmp, model2, opt2, sched2)
    same = step == PARITY_STEPS and all(
        torch.equal(a, b) for a, b in zip(gmodel.state_dict().values(),
                                          model2.state_dict().values()))
    for p, p2 in zip(gmodel.parameters(), model2.parameters()):
        same &= all(torch.equal(gopt.state[p][k], opt2.state[p2][k])
                    for k in ("exp_avg", "exp_avg_sq", "step"))
    same &= (gopt.param_groups[0]["lr"] == opt2.param_groups[0]["lr"]
             and gsched.last_epoch == sched2.last_epoch)
    nxt = [float(cnn.train_step(m, o, sc, *pool[0])[0])
           for m, o, sc in ((gmodel, gopt, gsched), (model2, opt2, sched2))]
    rel = abs(nxt[0] - nxt[1]) / abs(nxt[0])
    print(f"train state round trip on the card: parameters, exp_avg, "
          f"exp_avg_sq, step and lr bit for bit: {same}; next step's loss "
          f"{nxt[0]} / {nxt[1]} (relative {rel:.3g})")
    if not same or rel > CARD_LOSS_RTOL:
        raise AssertionError("train state round trip on the card")

    # times: a warm step at B=32 320x240, its peak memory; the teacher
    gray, obj_t, reg_t = pool[0]
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    cnn.train_step(gmodel, gopt, gsched, gray, obj_t, reg_t)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev)
    step_ms = cuda_ms(lambda: cnn.train_step(gmodel, gopt, gsched, gray,
                                             obj_t, reg_t), TIMED_STEPS)
    with torch.no_grad():
        fwd_ms = cuda_ms(lambda: cnn.loss_fn(gmodel, gray, obj_t, reg_t),
                         TIMED_STEPS)
    print(f"time: train step (forward, loss, backward, AdamW, schedule) "
          f"{step_ms:.4f} ms at B={TRAIN_BATCH} {distill.W}x{distill.H}, "
          f"{TRAIN_BATCH * 1000.0 / step_ms:.1f} images/s (forward and loss "
          f"alone {fwd_ms:.4f} ms); peak memory of a step "
          f"{peak / 2**20:.1f} MiB ({base / 2**20:.1f} MiB resident before "
          f"it: weights, AdamW state, the pool) [{gpu}]")
    gdev = torch.from_numpy(frames).to(dev)
    dev_ms = cuda_ms(lambda: teacher.detect_grouped(gdev, 3), 10)
    t0 = time.perf_counter()
    for _ in range(3):
        distill.label_batch(teacher, frames)
    host_ms = (time.perf_counter() - t0) * 1000.0 / 3
    print(f"time: teacher {dev_ms:.4f} ms per labelled batch of "
          f"{TRAIN_BATCH} on the device (detect_grouped on device-resident "
          f"frames), {host_ms:.3f} ms through label_batch from host frames "
          f"[{gpu}]")
    time_pyramid(gpu, gdev, teacher._plan,
                 f"the teacher's {len(teacher.levels)} levels at "
                 f"{distill.W}x{distill.H} ({teacher._plan.n_wide} wide)")
    return total


def multichip_launches(eye) -> dict[str, int]:
    """Sharded launches per process that phase 12 predicts: one #1
    launch for each of the detection, serving and chain face passes (no
    wide level at 160x90), and the eye's tilted levels once (#2, its
    tilted table and #4 per level)."""
    n_tilted = eye.routes.count("tilted")
    return {"pyramid_dense_phase": 3, "pyramid_dense_phase_wide": 0,
            "dense_level_tilted": n_tilted, "tilted_table": n_tilted,
            "integral_tables": n_tilted}


def multichip_path(dev, gpu, frames_720) -> dict[str, int]:
    """Phase 12: ``parallel.dryrun.dryrun_multichip`` at full width over
    one NCCL process per card (``torch.cuda.device_count()``), spawned,
    with a time limit: sharded face detection and grouping of B=64 720p
    frames (160x90 work images, pushed through a 4-stream
    ``StreamFeeder`` for the serving step), the sharded chain at 320x180
    with ``lefteye_2splits``, and 3 dp×tp train steps of the shipped CNN
    (B=32, 320x240, the teacher's labels). Every process holds each
    sharded output against the unsharded path on its card (detection
    exactly, the train step within ``dryrun.LOSS_RTOL`` and 2·Σ lr / a
    median of lr/1000) and times both."""
    n = torch.cuda.device_count()
    n_model = dryrun.default_n_model(n)
    face = work_images(frames_720, (160, 90), dev).cpu().numpy()
    tframes = face_clip(TRAIN_BATCH, distill.W, distill.H, seed=7)
    boxes, valid = distill.label_batch(distill.make_teacher(dev), tframes)
    inputs = dryrun.DryrunInputs(
        face=face, part=work_images(frames_720, (320, 180), dev).cpu().numpy(),
        serve=face, train_gray=tframes, train_boxes=boxes,
        train_valid=valid, train_steps=PARITY_STEPS,
        params=cnn.load_params_npz(cnn.find_checkpoint()))
    t0 = time.perf_counter()
    reports = dryrun.dryrun_multichip(n, "cuda", inputs=inputs,
                                      timed=MULTI_TIMED,
                                      timeout=MULTI_TIMEOUT)
    print(f"multi-device: {n} NCCL process(es), mesh {n // n_model}x"
          f"{n_model}, {time.perf_counter() - t0:.1f} s from spawn to the "
          "last result")
    total = dict.fromkeys(KERNELS, 0)
    want = multichip_launches(get_engine(
        find_cascade(inputs.part_cascade), (320, 180), inputs.part_factor,
        device=dev))
    for r, rep in enumerate(reports):
        ms = rep["ms"]
        print(f"multi-device rank {r}: process group, mesh and a first "
              f"all-reduce {rep['setup_s']:.3f} s; sharded launches "
              f"{rep['launches']} (per process: {want})")
        if rep["launches"] != want:
            raise AssertionError(f"rank {r}: sharded launches "
                                 f"{rep['launches']}, predicted {want}")
        for k, v in rep["launches"].items():
            total[k] += v
        print(f"multi-device rank {r}: sharded == unsharded: detect, "
              f"serving (4 streams), chain exactly; train "
              f"{rep['train_check']} over {PARITY_STEPS} steps, losses "
              f"{rep['train_losses']}")
        print(f"multi-device rank {r}: warmup-cosine over "
              f"{dryrun.SCHEDULE_STEPS} steps, {PARITY_STEPS} sharded, the "
              f"gathered state saved, {PARITY_STEPS} resumed, against one "
              f"unsharded run: {rep['schedule_check']}, losses "
              f"{rep['schedule_losses']}")
        for what, n_img in (("detect_grouped", BATCH), ("chain", BATCH),
                            ("train_step", TRAIN_BATCH)):
            print(f"time: multi-device rank {r} {what} {ms[what]:.4f} ms "
                  f"per sharded batch of {n_img}, unsharded "
                  f"{ms[what + '_unsharded']:.4f} ms [{gpu}]")
    return total


def tooling_samplers(window=(20, 20)):
    """cv2-free (positives(n, rng), negatives(n, rng)) for the cascade
    trainer: positives are ``utils/synth`` cartoon faces cropped square
    with 8% scale and 10% position jitter; negatives are blocky noise at a
    random grain, stripes and gradients, and off-centre or wrong-scale
    crops of the same faces. Crops are resampled to the window by nearest
    neighbour."""
    w, h = window
    yy, xx = np.mgrid[0:h, 0:w]

    def crop(img, x, y, side):
        idx = (np.arange(w) * side) // w
        return img[y + idx][:, x + idx]

    def canvas(rng, s):
        img = np.full((4 * s, 4 * s), rng.randint(60, 230), np.int16)
        img = (img + rng.randint(-8, 9, img.shape)).clip(0, 255)
        img = img.astype(np.uint8)
        draw_face(img, 2 * s, 2 * s, s)
        return img

    def positives(n, rng):
        out = np.empty((n, h, w), np.uint8)
        for i in range(n):
            s = int(rng.randint(12, 30))
            img = canvas(rng, s)
            side = int(2 * s * rng.uniform(0.92, 1.08))
            jx, jy = (int(rng.randint(-(s // 10), s // 10 + 1))
                      for _ in range(2))
            out[i] = crop(img, 2 * s - side // 2 + jx,
                          2 * s - side // 2 + jy, side)
        return out

    def negatives(n, rng):
        out = np.empty((n, h, w), np.uint8)
        for i, kind in enumerate(rng.randint(0, 3, n)):
            if kind == 0:
                k = int(rng.choice([2, 4, 5, 10, 20]))
                img = np.kron(rng.randint(0, 256, (k, k)),
                              np.ones((h // k, w // k), int))
                img = img + rng.randint(-6, 7, (h, w))
            elif kind == 1:
                f, a = rng.uniform(0.05, 0.6), rng.uniform(0, np.pi)
                img = (128 + rng.uniform(20, 120) * np.sin(
                    f * (xx * np.cos(a) + yy * np.sin(a))
                    + rng.uniform(0, 6)) + rng.randint(-10, 11, (h, w)))
            else:
                s = int(rng.randint(12, 30))
                side = min(int(2 * s * rng.choice([0.5, 2.0])), 4 * s)
                img = crop(canvas(rng, s),
                           int(rng.randint(0, 4 * s - side + 1)),
                           int(rng.randint(0, 4 * s - side + 1)), side)
            out[i] = np.clip(img, 0, 255)
        return out

    return positives, negatives


def cascades_equal(got, want, what: str) -> None:
    """The loaded cascades hold the same arrays, and every weak's features
    the same rects, weights and tilt (``tests/test_cascade_loader.py``)."""
    same = ((got.window_w, got.window_h) == (want.window_w, want.window_h)
            and all(np.array_equal(getattr(got, k), getattr(want, k))
                    for k in ("thr0", "thrL", "thrR", "leavesL", "leavesR",
                              "weak_stage", "stage_thresholds"))
            and all(np.array_equal(getattr(got, a)[getattr(got, k)],
                                   getattr(want, a)[getattr(want, k)])
                    for k in ("feat0", "featL", "featR")
                    for a in ("rects", "rect_weights", "tilted")))
    if not same:
        raise AssertionError(f"{what}: the loaded cascades differ")


def tooling_path(dev, gpu, frames_720) -> dict[str, int]:
    """Phase 13: the three bundled XML families to the old format and
    back (loaded cascades equal, an engine on the card built from the
    old-format face file gives the same candidates); two stages of the
    cascade trainer at the part recipe's widths, on the card and on the
    CPU, from the same cv2-free samples (the same XML bytes); the
    trained cascade's engine on the card (#1) against the CPU engine."""
    total = dict.fromkeys(KERNELS, 0)
    work = work_images(frames_720, (160, 90), dev)
    with tempfile.TemporaryDirectory() as tmp:
        for name in TOOLING_XML:
            src = find_cascade(name)
            old = os.path.join(tmp, "old_" + name)
            new = os.path.join(tmp, "new_" + name)
            convert.new_to_old_xml(src, old)
            convert.old_to_new_xml(old, new)
            ref = load_cascade_xml(src)
            cascades_equal(load_cascade_xml(old), ref, f"{name} old")
            cascades_equal(load_cascade_xml(new), ref, f"{name} back")
            print(f"convert: {name} → old ({os.path.getsize(old)} B) → "
                  f"new ({os.path.getsize(new)} B): loaded cascades equal "
                  f"({ref.n_stages} stages, {int(ref.tilted.sum())} tilted "
                  "features)")
        old_face = os.path.join(tmp, "old_" + TOOLING_XML[0])
        old_eng = CascadeEngine(load_cascade_xml(old_face), (160, 90), 1.25,
                                device=dev)
        reset_counts()
        got = old_eng.candidates(work)
        torch.cuda.synchronize()
        for k, v in read_counts().items():
            total[k] += v
        want = get_engine(DEFAULT_FACE_CASCADE, (160, 90), 1.25,
                          device=dev).candidates(work)
        if not all(np.array_equal(a, b) for a, b in zip(got, want)):
            raise AssertionError("the old-format face file's engine differs")
        print(f"convert: the old-format face file's engine on the card == "
              f"the bundled file's: {sum(map(len, got))} raw candidates on "
              f"B={BATCH} 160x90")

        pos_s, neg_s = tooling_samplers()
        cfg = train.TrainConfig(**TOOLING_TRAIN)
        xml, calls = {}, {}
        real_fv = train.feature_values
        for where, d in (("card", dev), ("cpu", torch.device("cpu"))):
            calls[where] = []

            def timed_fv(samples, mat, chunk=2048, device=d, _c=calls[where]):
                t = time.perf_counter()
                out = real_fv(samples, mat, chunk, device)
                _c.append((len(samples), mat.shape[1],
                           (time.perf_counter() - t) * 1e3))
                return out

            t0 = time.perf_counter()
            path = os.path.join(tmp, f"trained_{where}.xml")
            with mock.patch.object(train, "feature_values", timed_fv):
                res = torch_train_part_cascades.train_one(
                    "nose", path, device=d, cfg=cfg,
                    samplers=(pos_s, neg_s, {"clean": neg_s}))
            model = res["model"]
            with open(path, "rb") as fh:
                xml[where] = fh.read()
            print(f"cascade trainer (tools/torch_train_part_cascades.py "
                  f"train_one) on the {where}: "
                  f"{len(model.stages)} stages, weaks "
                  f"{[len(s.weaks) for s in model.stages]}, holdout det "
                  f"{res['det']:.4f} fp {res['fp']['clean']:.5f}, "
                  f"{time.perf_counter() - t0:.2f} s "
                  f"({len(calls[where])} feature-value calls)")
        if xml["card"] != xml["cpu"]:
            raise AssertionError("the card-trained XML differs from the "
                                 "CPU-trained bytes")
        print(f"cascade trainer: card XML == CPU XML ({len(xml['card'])} B)")
        stage_calls = [(c, p) for c, p in zip(calls["card"], calls["cpu"])
                       if c[0] > TOOLING_TRAIN["n_neg"]]
        for s_idx, ((n_s, n_f, card_ms), (_, _, cpu_ms)) in enumerate(
                stage_calls):
            mat = torch.from_numpy(train.corner_matrix(
                train.feature_pool(20, 20, max_features=n_f), 20, 20))
            p = torch.randint(0, 102001, (n_s, mat.shape[0])).float()
            pd, md = p.to(dev), mat.to(dev)
            gemm_ms = cuda_ms(lambda: pd @ md, 10)
            t0 = time.perf_counter()
            for _ in range(3):
                p @ mat
            cpu_gemm = (time.perf_counter() - t0) * 1e3 / 3
            print(f"time: trainer stage {s_idx} feature GEMM [{n_s}x"
                  f"{mat.shape[0]}]x[{mat.shape[0]}x{n_f}] float32: card "
                  f"{gemm_ms:.4f} ms, CPU {cpu_gemm:.4f} ms; feature_values "
                  f"(patches, GEMM, copy back, normalization) card "
                  f"{card_ms:.4f} ms, CPU {cpu_ms:.4f} ms [{gpu}]")

        c = load_cascade_xml(os.path.join(tmp, "trained_card.xml"))
    eng = CascadeEngine(c, (160, 90), 1.25, device=dev)
    if set(eng.routes) != {"pyramid"}:
        raise AssertionError(f"trained cascade routes {eng.routes}")
    reset_counts()
    got = eng.candidates(work)
    torch.cuda.synchronize()
    counts = read_counts()
    for k, v in counts.items():
        total[k] += v
    if counts["pyramid_dense_phase"] != 1:
        raise AssertionError(f"trained engine launches {counts}")
    want = CascadeEngine(c, (160, 90), 1.25, device="cpu").candidates(
        work.cpu())
    if not all(np.array_equal(a, b) for a, b in zip(got, want)):
        raise AssertionError("the trained engine's card candidates differ "
                             "from the CPU's")
    print(f"trained cascade: engine on the card ({len(eng.levels)} levels, "
          f"one #1 launch) == CPU, {sum(map(len, got))} raw candidates on "
          f"B={BATCH} 160x90")
    return total


def eval_scenes(n: int, seed: int = 21) -> np.ndarray:
    """[n, 720, 1280] ``utils/synth`` scenes: one cartoon face on even
    indices, two (one in each half) on odd ones, at random places and
    sizes large enough for the teacher's 160-px working width."""
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        xs = [(200, 420), (860, 1080)] if i % 2 else [(300, 980)]
        faces = [(int(rng.randint(*x)), int(rng.randint(200, 520)),
                  int(rng.randint(130, 180))) for x in xs]
        out.append(face_scene(*FRAME, faces=faces, seed=seed + i))
    return np.stack(out)


def counted(fn):
    """(fn(), the kernel launches it made, synchronized)."""
    reset_counts()
    out = fn()
    torch.cuda.synchronize()
    return out, read_counts()


def entry_tools_path(dev, gpu) -> dict[str, int]:
    """Phase 14: the port's entry point (``entry.entry``), the evaluation
    tools (``tools/torch_real_eval.py``, ``tools/torch_eval_trained_
    cascades.py``) on the card against the CPU, and each
    ``examples/torch_*.py`` demo as a subprocess on the card."""
    total = dict.fromkeys(KERNELS, 0)

    def add(counts):
        for k, v in counts.items():
            total[k] += v

    # 1. the entry point: the example batch and 4 face frames
    fn, (example,) = entry.entry(dev)
    cpu_fn, _ = entry.entry("cpu")
    faces = torch.from_numpy(face_clip(entry.EXAMPLE_BATCH, *entry.FRAME,
                                       seed=3)).to(dev)
    for what, x in (("example", example), ("face frames", faces)):
        got, counts = counted(lambda: fn(x))
        add(counts)
        want = {k: 0 for k in KERNELS}
        want["pyramid_dense_phase"] = 1
        if counts != want:
            raise AssertionError(f"entry on the {what}: launches {counts}, "
                                 f"expected {want}")
        for g, c, name in zip(got, cpu_fn(x.cpu()),
                              ("boxes", "valid", "overflow")):
            assert_equal(g.cpu(), c, f"entry {what} {name}")
        print(f"entry: fn({what} {tuple(x.shape)}) == CPU (raw candidates "
              f"{tuple(got[0].shape)}, {int(got[1].sum())} valid), one #1 "
              "launch")
        if what == "face frames" and not int(got[1].sum()):
            raise AssertionError("entry: no raw candidate on face frames")
    print(f"time: entry fn(example) {cuda_ms(lambda: fn(example), 20):.4f} "
          f"ms per call of B={entry.EXAMPLE_BATCH} "
          f"{entry.FRAME[0]}x{entry.FRAME[1]} (CUDA events, 20 warm calls) "
          f"[{gpu}]")

    # 2. real_eval on .npy scenes: int8 and bf16, card against the CPU
    scenes = eval_scenes(EVAL_SCENES)
    with tempfile.TemporaryDirectory() as tmp:
        images = []
        for i, img in enumerate(scenes):
            path = os.path.join(tmp, f"scene_{i}.npy")
            np.save(path, img)
            images.append((path, path))
        for quantized in (True, False):
            what = "int8" if quantized else "bf16"
            rec = {"card": [], "cpu": []}
            t0 = time.perf_counter()
            res, counts = counted(lambda: torch_real_eval.evaluate(
                images, quantized=quantized, device=dev, record=rec["card"]))
            secs = time.perf_counter() - t0
            add(counts)
            want = {k: 0 for k in KERNELS}
            want["pyramid_dense_phase"] = EVAL_SCENES
            want["quantize_int8"] = 7 * EVAL_SCENES * quantized
            if counts != want:
                raise AssertionError(f"real_eval {what}: launches {counts}, "
                                     f"expected {want}")
            cpu_res = torch_real_eval.evaluate(
                images, quantized=quantized, device="cpu", record=rec["cpu"])
            n_exact = 0
            for (name, tg, sg), (_, tc, sc) in zip(rec["card"], rec["cpu"]):
                if not np.array_equal(tg, tc):
                    raise AssertionError(f"real_eval {name}: teacher boxes "
                                         "differ from the CPU's")
                exact = np.array_equal(sg, sc)
                n_exact += exact
                if quantized and not exact:
                    raise AssertionError(f"real_eval {name}: int8 boxes "
                                         "differ from the CPU's")
                if not exact and (sg.shape != sc.shape or np.abs(
                        sg.astype(int) - sc).max() > 2):
                    raise AssertionError(f"real_eval {name}: bf16 boxes "
                                         "differ from the CPU's by more "
                                         "than 2 px")
            if res[2] < 1:
                raise AssertionError(f"real_eval {what}: no true positive")
            print(f"real_eval ({what}): recall {res[0]:.3f} precision "
                  f"{res[1]:.3f} (tp {res[2]} fn {res[3]} fp {res[4]}) on "
                  f"{EVAL_SCENES} 720p .npy scenes; CPU {cpu_res}; teacher "
                  f"boxes == CPU, CNN boxes == CPU on {n_exact} of "
                  f"{EVAL_SCENES}; {secs * 1e3 / EVAL_SCENES:.2f} ms per "
                  f"image on the card (host clock, cold engines included); "
                  f"launches {counts} [{gpu}]")

    # 3. the real-pixel FP sweep's scans on a synthetic 720p frame on
    # which the teacher found a face
    gray = scenes[next(i for i, (_, t, _) in enumerate(rec["cpu"])
                       if len(t))]
    photo = dataclasses.make_dataclass(
        "Photo", ["name", "bgr", "n_faces"])("synth_720p", np.repeat(
            gray[..., None], 3, axis=2), 1)
    rows, counts = counted(lambda: torch_eval_trained_cascades.run_real_sweep(
        dev, photos=[photo]))
    add(counts)
    cpu_rows = torch_eval_trained_cascades.run_real_sweep("cpu",
                                                          photos=[photo])
    if rows != cpu_rows:
        raise AssertionError("real_fp_scan: card rows differ from the CPU's")
    if counts["pyramid_dense_phase"] != 1 + len(rows):
        raise AssertionError(f"real_fp_scan launches {counts}")
    for row in rows:
        print(f"real_fp_scan: {row['cascade']} ({row['family']}) on a "
              f"synthetic 720p frame: {row['n_det']} detections, "
              f"{row['n_in_face']} in the face box {row['face_box']}")
    print(f"real_fp_scan: card == CPU (counts and boxes) for "
          f"{len(rows)} cascades; launches {counts}")

    # 4. eval_xml_windows on cv2-free windows
    pos_s, neg_s = tooling_samplers()
    rng = np.random.RandomState(5)
    wins = {"pos": pos_s(800, rng), "neg": neg_s(3000, rng)}
    for part, fname in torch_eval_trained_cascades.PARTS.items():
        casc = load_cascade_xml(os.path.join(
            torch_eval_trained_cascades.ASSETS, fname))
        rates = []
        for kind, w in wins.items():
            w = w[train.vnf_and_valid(w)[1]]
            got = torch_eval_trained_cascades.eval_xml_windows(casc, w, dev)
            want = torch_eval_trained_cascades.eval_xml_windows(casc, w,
                                                                "cpu")
            if not np.array_equal(got, want):
                raise AssertionError(f"eval_xml_windows {part} {kind}: card "
                                     "mask differs from the CPU's")
            rates.append(f"{kind} {got.mean():.4f} of {len(w)}")
        print(f"eval_xml_windows: {fname} card == CPU, pass rate "
              + ", ".join(rates))

    # 5. the demos, as subprocesses on the card, all started together
    # (two host threads each: they share the host's cores)
    procs = {}
    env = dict(os.environ, OMP_NUM_THREADS="2")
    for name, args in EXAMPLES.items():
        procs[name] = subprocess.Popen(
            [sys.executable, os.path.join(ROOT, "examples", name),
             "--device", "cuda", *args], cwd=ROOT, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    t0 = time.perf_counter()
    failed = []
    for name, p in procs.items():
        try:
            out, _ = p.communicate(timeout=max(
                EXAMPLE_TIMEOUT - (time.perf_counter() - t0), 1.0))
        except subprocess.TimeoutExpired:
            p.kill()
            out, _ = p.communicate()
            failed.append(f"{name}: no exit within {EXAMPLE_TIMEOUT} s")
            continue
        last = (out.strip().splitlines() or [""])[-1]
        print(f"example {name} {' '.join(EXAMPLES[name])}: rc "
              f"{p.returncode} after {time.perf_counter() - t0:.1f} s; "
              f"last line: {last[:160]}")
        if p.returncode != 0:
            failed.append(f"{name}: rc {p.returncode}\n{out[-3000:]}")
    if failed:
        raise AssertionError("examples failed: " + "\n".join(failed))
    return total


def bench_path() -> dict[str, int]:
    """Phase 15: ``bench_torch.py`` at B=BATCH in a subprocess; its lines
    are printed here and checked → the launches its phases made."""
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "bench_torch.py"), str(BATCH)],
        cwd=ROOT, capture_output=True, text=True, timeout=BENCH_TIMEOUT)
    secs = time.perf_counter() - t0
    for line in proc.stdout.splitlines():
        print(f"bench_torch: {line}")
    for line in proc.stderr.splitlines():
        if line.startswith("bench:"):
            print(f"bench_torch stderr: {line}")
    print(f"bench_torch: rc {proc.returncode} after {secs:.1f} s")
    if proc.returncode != 0:
        raise AssertionError(f"bench_torch.py exited {proc.returncode}:\n"
                             f"{proc.stderr[-4000:]}")
    lines = [json.loads(line) for line in proc.stdout.splitlines()]
    n_head = len(bench_torch.HEADLINE_KEYS)
    body, head = lines[:-n_head], lines[-n_head:]
    if lines[0]["metric"] != "card":
        raise AssertionError("bench_torch: the first line is not the card")
    if [ln["metric"] for ln in head] != bench_torch.HEADLINE_KEYS[::-1]:
        raise AssertionError("bench_torch: the headline lines are not last "
                             f"in order: {[ln['metric'] for ln in head]}")
    names = [ln["metric"] for ln in body]
    for name in BENCH_METRICS:
        if names.count(name) != 1:
            raise AssertionError(f"bench_torch: {name} printed "
                                 f"{names.count(name)} times")
        values = body[names.index(name)]["value"]
        for v in values if isinstance(values, list) else [values]:
            if not (isinstance(v, (int, float)) and np.isfinite(v)
                    and v > 0):
                raise AssertionError(f"bench_torch: {name} = {values}")
    got = {ln["metric"]: {k: v["launches_per_batch"]
                          for k, v in ln["steps"].items()}
           for ln in body if ln["metric"] in BENCH_LAUNCHES}
    if got != BENCH_LAUNCHES:
        raise AssertionError(f"bench_torch launches a batch {got}, expected "
                             f"{BENCH_LAUNCHES}")
    total = dict.fromkeys(KERNELS, 0)
    for ln in body:
        if ln["metric"].endswith("_launches"):
            for k, v in ln["value"].items():
                total[k] += v
    print(f"bench_torch: every metric once, card line first, headline last, "
          f"launches a batch as predicted; launches in its phases {total}")
    return total


def times(dev, gpu, face_eng, dets, frames_720, xs, ears,
          ear_frames) -> dict[str, dict]:
    out: dict[str, dict] = {}
    # pyramid kernel: the face path's 7 levels at 160x90, and the nose's
    # 24-level launch at 320x180
    out["pyramid_dense_phase"] = time_pyramid(
        gpu, work_images(frames_720, (160, 90), dev), face_eng._plan,
        "the face path's levels at 160x90")
    part = work_images(frames_720, (320, 180), dev)
    nose = dets["NoseDetector"].part_engines["nose"]
    time_pyramid(gpu, part, nose._plan,
                 "the nose's pyramid launch at 320x180 (320x180 .. 36x20)")

    # level kernels at the part chain's 320x180, per B=64 batch
    eye = dets["EyeDetector"].part_engines["right"]
    levels = level_images(part, eye)
    out.update(time_tilted(gpu, eye, levels))
    mouth = level_images(part, dets["MouthDetector"].part_engines["mouth"])
    time_integral(gpu, list(mouth.values()),
                  "the mouth's 23 tilted levels (its launches on the path)")
    time_integral(gpu, [levels[li] for li in range(6)],
                  "the right eye's 6 largest tilted levels (320x180 .. "
                  "199x112)")
    out["integral_tables"] = time_integral(
        gpu, list(levels.values()),
        "the right eye's 24 tilted levels (its launches on the path)")

    out["survivor_eval"] = time_survivor(gpu, dets, part)
    out["motion_ccl"] = time_motion_ccl(dev, gpu)

    out["pyramid_dense_phase_wide"] = time_pyramid(
        gpu, part, wide_plans(nose)["4 wide levels"],
        "the nose's 4 wide levels alone (320x180 .. 240x135, the row-strip "
        "kernel's before)")

    time_quant(dev, gpu, xs, out)

    # the pyramid kernel on the ear's plans: 128 work images per batch
    ear_gray = torch.from_numpy(ear_frames).to(dev)
    for pairing, det in ears.items():
        for what, eng in (("profile faces at 160x90", det.face_engine),
                          ("ears at 320x180 (24 levels, 4 wide)",
                           det.part_engines["ear"])):
            if pairing != "default" and eng is det.part_engines["ear"]:
                continue          # the same ear engine as the default's
            time_pyramid(gpu, ear_work(det, eng, ear_gray), eng._plan,
                         f"the ear's {pairing} {what}")

    gray = torch.from_numpy(frames_720).to(dev)
    dev_ms = cuda_ms(lambda: face_eng.detect_grouped(equalize_hist(
        resize_linear_exact(gray, (160, 90)))), 20)
    print(f"time: face device path (resize, equalize, cascade, grouping on "
          f"device-resident frames) {dev_ms:.4f} ms/batch, "
          f"{BATCH * 1000.0 / dev_ms:.1f} frames/s; B={BATCH} 720p [{gpu}]")
    for name, det in dets.items():
        dev_ms = cuda_ms(part_device_pass(det, gray), 5)
        print(f"time: {name} device pass (both images, face pass, part "
              f"engines, compaction on device-resident frames) {dev_ms:.4f} "
              f"ms/batch, {BATCH * 1000.0 / dev_ms:.1f} frames/s; B={BATCH} "
              f"720p [{gpu}]")
    cnn_dets = [cls(FRAME, device=dev)
                for cls in (QuantizedCnnFaceDetector, CnnFaceDetector)]
    for det in cnn_dets:
        canvas = det.letterbox(gray)
        fwd_ms = cuda_ms(lambda: det.model(canvas), 20)
        dev_ms = cuda_ms(lambda: det.detect_device(gray), 20)
        print(f"time: {type(det).__name__} device path (letterbox, forward, "
              f"decode, NMS on device-resident frames) {dev_ms:.4f} ms/batch "
              f"({fwd_ms:.4f} ms of it the forward), "
              f"{BATCH * 1000.0 / dev_ms:.1f} frames/s; B={BATCH} 720p [{gpu}]")
    for pairing, det in ears.items():
        dev_ms = cuda_ms(ear_device_pass(det, ear_gray), 5)
        print(f"time: EarDetector ({pairing}) device pass (flip, both images, "
              f"profile pass, ear engine, compaction on device-resident "
              f"frames; {2 * BATCH} images in the engines) {dev_ms:.4f} "
              f"ms/batch, {BATCH * 1000.0 / dev_ms:.1f} frames/s; B={BATCH} "
              f"720p [{gpu}]")
        det.process(ear_frames)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            det.process(ear_frames)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        print(f"time: EarDetector ({pairing}).process "
              f"{3 * BATCH / secs:.1f} frames/s ({secs * 1000.0 / 3:.3f} ms "
              f"per {BATCH}-frame 720p host batch of profile frames) [{gpu}]")
    for det in (FaceDetector(FRAME, device=dev), *dets.values(), *cnn_dets):
        det.process(frames_720)
        torch.cuda.synchronize()
        n_rep = 3
        t0 = time.perf_counter()
        for _ in range(n_rep):
            det.process(frames_720)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        print(f"time: {type(det).__name__}.process "
              f"{n_rep * BATCH / secs:.1f} frames/s ({secs * 1000.0 / n_rep:.3f}"
              f" ms per {BATCH}-frame 720p host batch) [{gpu}]")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this check needs an NVIDIA GPU")
    dev = torch.device("cuda", 0)

    phase("1 device")
    gpu = gpu_line()
    print(f"gpu: {gpu}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} devices "
          f"{torch.cuda.device_count()} name {torch.cuda.get_device_name(0)}")

    phase("2 build")
    build_all()

    phase("3 kernels vs plain versions")
    frames = {size: face_clip(BATCH, *size, seed=11)
              for size in (FRAME, (640, 480))}
    dets = part_engines(dev)
    ears = ear_detectors(dev)
    ear_frames = ear_clip(EAR_BATCHES * BATCH)
    pyr_err, pyr_wide_err = check_pyramid(
        dev, frames, dets["NoseDetector"].part_engines["nose"],
        distill.make_teacher(dev),
        face_clip(TRAIN_BATCH, distill.W, distill.H, seed=5))
    err = {"pyramid_dense_phase": pyr_err}
    err.update(check_level_kernels(dev, dets, frames[FRAME]))
    err["survivor_eval"] = check_survivor(dev, dets, frames[FRAME])
    err["motion_ccl"] = check_motion_ccl(dev)
    ear_err, ear_wide_err = check_ear_pyramid(dev, ears, ear_frames[:BATCH])
    err["pyramid_dense_phase"] = max(err["pyramid_dense_phase"], ear_err)
    err["pyramid_dense_phase_wide"] = max(err["pyramid_dense_phase_wide"],
                                          ear_wide_err)
    xs = layer_inputs(dev, frames[FRAME])
    err.update(check_quant(dev, xs))
    err["pyramid_dense_phase"] = max(err["pyramid_dense_phase"],
                                     pyr_err)
    err["pyramid_dense_phase_wide"] = max(err["pyramid_dense_phase_wide"],
                                          pyr_wide_err)

    phase("4 face path")
    launches, face_eng = face_path(dev, frames[FRAME])

    phase("5 part path")
    for k, v in part_path(dets, dev).items():
        launches[k] += v

    phase("6 ear path")
    for k, v in ear_path(ears, np.split(ear_frames, EAR_BATCHES)).items():
        launches[k] += v

    phase("7 learned path")
    for k, v in learned_path(dev).items():
        launches[k] += v

    phase("8 tracker and drawing")
    for k, v in tracker_path(dev, gpu).items():
        launches[k] += v
    drawing_path(dev, gpu, frames[FRAME])
    missing = [k for k, v in launches.items() if v == 0 and k not in OFF_PATH]
    if missing:
        raise AssertionError(f"kernels never launched on a path: {missing}")

    phase("10 serving")
    for k, v in serving_path(dev, gpu).items():
        launches[k] += v

    phase("11 training")
    for k, v in training_path(dev, gpu).items():
        launches[k] += v

    phase("12 multi-device")
    for k, v in multichip_path(dev, gpu, frames[FRAME]).items():
        launches[k] += v

    phase("13 cascade tooling")
    for k, v in tooling_path(dev, gpu, frames[FRAME]).items():
        launches[k] += v

    phase("14 entry, tools and examples")
    for k, v in entry_tools_path(dev, gpu).items():
        launches[k] += v

    phase("15 benchmark")
    for k, v in bench_path().items():
        launches[k] += v

    phase("9 times")
    t = times(dev, gpu, face_eng, dets, frames[FRAME], xs, ears,
              ear_frames[:BATCH])

    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name], "max_abs_err": err[name], **t[name]}
        for name, (_, _, src, rep) in KERNELS.items()]}))
    print(gpu)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
