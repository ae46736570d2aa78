"""CUDA tests of the PyTorch port: each hand-written kernel (the pyramid
dense kernel, its bands on the levels the row-strip kernel took before
included, the tilted kernels of the level dense phase, the tilted-table
kernel, the integral-tables kernel, the survivor kernel of tilted
cascades, the motion labelling kernel, the int8 quantizers) against its
plain PyTorch version on the card, and the face, part, ear and learned
detectors, the motion tracker, the drawing ops and the learned
detectors' training path (the distillation teacher, train steps, the
train-state round trip), the multi-device dry run at world size 1, the
cascade trainer's GEMM, the entry point and the benchmark's gate
(``bench_torch.py``) on CUDA against the port's CPU run (the drawing
also against its numpy twins).

Every test here is marked ``cuda`` and skips on a host without a GPU. On a
GPU host without JAX, run them with

    python -m pytest --noconftest -o addopts="" -p no:cacheprovider \\
        -m cuda tests/test_torch_cuda.py -q

(``--noconftest``: the suite's conftest configures JAX).
"""

from __future__ import annotations

import os

import numpy as np
import pytest
import torch

from nubomedia_vca_tpu_torch.api.render import render_detections
from nubomedia_vca_tpu_torch.cascade.engine import CascadeEngine, load_cascade
from nubomedia_vca_tpu_torch.cascade.paths import PKG_ASSETS_DIR
from nubomedia_vca_tpu_torch.models import (CnnFaceDetector, EarDetector,
                                            EarDetectorConfig, EyeDetector,
                                            MouthDetector, NoseDetector,
                                            QuantizedCnnFaceDetector)
from nubomedia_vca_tpu_torch.models import cnn, distill, tracker
from nubomedia_vca_tpu_torch.models.base import (StagingRing, bucket_pad,
                                                 select_frames)
from nubomedia_vca_tpu_torch.models.face import (DEFAULT_FACE_CASCADE,
                                                 FaceDetector)
from nubomedia_vca_tpu_torch.ops import quant
from nubomedia_vca_tpu_torch.ops.cuda import (dense_cuda, dense_level_cuda,
                                              integral_cuda, motion_ccl_cuda,
                                              quant_cuda, survivor_cuda)
from nubomedia_vca_tpu_torch.ops.histogram import equalize_hist
from nubomedia_vca_tpu_torch.ops.integral import tilted_integral_image
from nubomedia_vca_tpu_torch.ops.resize import resize_linear_exact
from nubomedia_vca_tpu_torch.utils import checkpoint, tracing
from nubomedia_vca_tpu_torch.utils.synth import (blob_clip, face_clip,
                                                 face_scene, motion_maps,
                                                 profile_scene)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda", 0)


def _levels_equal(got, want):
    for li, ((gi, gv, ga), (wi, wv, wa)) in enumerate(zip(got, want)):
        assert (gi is None) == (wi is None), li
        if gi is not None:
            assert torch.equal(gi, wi), f"level {li} image"
        assert torch.equal(gv, wv), f"level {li} vnf"
        assert torch.equal(ga, wa), f"level {li} alive"


@pytest.mark.parametrize("size,factor", [((160, 90), 1.25),
                                         ((160, 120), 1.25),
                                         ((320, 240), 1.25),
                                         ((97, 61), 1.1)])
def test_kernel_equals_plain_version(cuda_device, size, factor):
    """Exact equality (level images, vnf, alive) on faces and on noise, at
    the main path's work sizes (320x240: the distillation teacher's plan,
    3 wide levels), and an odd geometry."""
    w, h = size
    eng = CascadeEngine(load_cascade(DEFAULT_FACE_CASCADE), size, factor,
                        device=cuda_device)
    frames = np.stack(
        [face_scene(w, h, faces=((w // 2, h // 2, h // 3),), seed=s)
         for s in range(4)]
        + [np.random.RandomState(s).randint(0, 256, (h, w), np.uint8)
           for s in range(4)])
    work = torch.from_numpy(frames).to(cuda_device)
    before = dense_cuda.pyramid_dense_phase.launches
    got = dense_cuda.pyramid_dense_phase(work, eng._plan)
    assert dense_cuda.pyramid_dense_phase.launches == before + 1
    want = dense_cuda.pyramid_dense_phase_reference(work, eng._plan)
    torch.cuda.synchronize()
    _levels_equal(got, want)
    assert sum(int(a.sum()) for _, _, a in got) > 0


def test_kernel_equals_plain_version_on_nose_plan(cuda_device):
    """The nose's 24-level launch of the part chain at 720p (320x180 part
    image, levels 320x180 .. 36x20 in 88 bands): level images, vnf and
    alive exactly, on faces and noise."""
    nose = NoseDetector((1280, 720), device=cuda_device).part_engines["nose"]
    plan = nose._plan
    assert len(plan.levels) == 24 and len(plan.items) == 88
    work = _part_work((320, 180)).to(cuda_device)
    before = dense_cuda.pyramid_dense_phase.launches
    got = dense_cuda.pyramid_dense_phase(work, plan)
    assert dense_cuda.pyramid_dense_phase.launches == before + 1
    want = dense_cuda.pyramid_dense_phase_reference(work, plan)
    torch.cuda.synchronize()
    _levels_equal(got, want)
    assert sum(int(a.sum()) for _, _, a in got) > 0


def test_kernel_wrapper_checks_inputs(cuda_device):
    eng = CascadeEngine(load_cascade(DEFAULT_FACE_CASCADE), (160, 90),
                        device=cuda_device)
    good = torch.zeros((2, 90, 160), dtype=torch.uint8, device=cuda_device)
    with pytest.raises(TypeError):
        dense_cuda.pyramid_dense_phase(good.to(torch.int32), eng._plan)
    with pytest.raises(ValueError):
        dense_cuda.pyramid_dense_phase(good[:, :80], eng._plan)
    with pytest.raises(ValueError):
        dense_cuda.pyramid_dense_phase(
            torch.zeros((2, 160, 90), dtype=torch.uint8,
                        device=cuda_device).transpose(1, 2), eng._plan)


def test_large_level_takes_band_kernel_on_cuda(cuda_device):
    """A 320-px work image has levels beyond one block's shared memory:
    they go to the pyramid kernel in bands, in the one launch of all
    levels (counted as a wide launch too), and the raw candidates equal
    the CPU engine's."""
    casc = load_cascade(DEFAULT_FACE_CASCADE)
    eng = CascadeEngine(casc, (320, 180), device=cuda_device)
    assert eng.routes == ["pyramid"] * len(eng.levels)
    assert eng._plan.n_wide > 0
    frames = np.stack([face_scene(320, 180, faces=((160, 90, 60),), seed=s)
                       for s in range(4)])
    before = (dense_cuda.pyramid_dense_phase.wide_launches,
              dense_cuda.pyramid_dense_phase.launches)
    got = eng.detect_raw(frames)
    torch.cuda.synchronize()
    assert (dense_cuda.pyramid_dense_phase.wide_launches - before[0],
            dense_cuda.pyramid_dense_phase.launches - before[1]) == (1, 1)
    want = CascadeEngine(casc, (320, 180), device="cpu").detect_raw(frames)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    assert want[1].any()


def _part_work(size, n=8):
    """n uint8 work images [n, h, w]: equalized synthetic 720p faces and
    noise, on the card."""
    w, h = size
    faces = equalize_hist(resize_linear_exact(
        torch.from_numpy(face_clip(n // 2, 1280, 720, seed=3)), (w, h)))
    noise = torch.from_numpy(np.random.RandomState(2).randint(
        0, 256, (n - n // 2, h, w), np.uint8))
    return torch.cat([faces, noise])


@pytest.mark.parametrize("name,min_size", [
    ("haarcascade_smile.xml", (1, 1)),
    ("haarcascade_righteye_2splits.xml", (20, 20)),
    ("haarcascade_lefteye_2splits.xml", (20, 20))])
def test_tilted_kernel_equals_plain_version(cuda_device, name, min_size):
    """The tilted kernels (table pass, tilted table, tiled evaluation) on
    every level of a tilted engine at 720p (320x180 part image, whose
    first level is 320x180 with ragged last tiles both ways), and on the
    first level in 5x7 tiles: ii, iit, vnf and alive exactly; one launch
    of each kernel per call."""
    eng = CascadeEngine(load_cascade(os.path.join(PKG_ASSETS_DIR, name)),
                        (320, 180), 1.1, min_size=min_size,
                        device=cuda_device)
    assert sorted(eng._level_plans) == list(range(len(eng.levels)))
    assert (eng.levels[0].sw, eng.levels[0].sh) == (320, 180)
    plans = [(li, plan) for li, plan in eng._level_plans.items()]
    plans.append((0, dense_level_cuda.DenseLevelPlan.make(
        eng.levels[0], eng._tables, tile=(5, 7))))
    work = _part_work((320, 180)).to(cuda_device)
    counters = (dense_level_cuda.dense_level_tilted,
                dense_level_cuda.tilted_table, integral_cuda.integral_tables)
    n_alive = 0
    for li, plan in plans:
        l = eng.levels[li]
        if li == 0:     # ragged last tiles in both directions
            assert l.ny % plan.tile_ny and l.nx % plan.tile_nx
        img = resize_linear_exact(work, (l.sw, l.sh))
        before = [c.launches for c in counters]
        got = dense_level_cuda.dense_level_tilted(img, plan)
        assert [c.launches for c in counters] == [n + 1 for n in before]
        want = dense_level_cuda.dense_level_reference(img, plan)
        torch.cuda.synchronize()
        for g, w, what in zip(got, want, ("ii", "iit", "vnf", "alive")):
            assert torch.equal(g, w), f"level {li} {what}"
        n_alive += int(got[3].sum())
    assert n_alive > 0


EYES = ("haarcascade_righteye_2splits.xml", "haarcascade_lefteye_2splits.xml")


@pytest.mark.parametrize("name", EYES)
def test_survivor_kernel_equals_plain_version(cuda_device, name):
    """The survivor kernel against its plain version on the card, at the
    eye cell's shapes: B = 64 part images at 320x180, all 24 levels, both
    blocks, on the slots that ``_level_post`` compacts; passed flags bit
    for bit, one launch a level and block."""
    eng = CascadeEngine(load_cascade(os.path.join(PKG_ASSETS_DIR, name)),
                        (320, 180), 1.1, min_size=(20, 20),
                        device=cuda_device)
    assert len(eng.levels) == 24 and len(eng._blocks) == 2
    work = _part_work((320, 180), n=64).to(cuda_device)
    n_in, n_pass = [0, 0], [0, 0]
    for li in range(len(eng.levels)):
        (ii, iit), vnf, alive = eng._dense_level(work, li)
        caps = eng._level_caps[li]
        sel, sel_alive, _ = eng._compact(alive.bool().reshape(64, -1),
                                         caps[0])
        win_ids = sel
        for bi, plan in enumerate(eng._survivor_plans[li]):
            if bi > 0 and caps[bi] < sel_alive.shape[1]:
                sel2, sel_alive, _ = eng._compact(sel_alive, caps[bi])
                win_ids = win_ids.gather(1, sel2)
            before = survivor_cuda.survivor_eval.launches
            got = survivor_cuda.survivor_eval(ii, iit, vnf, win_ids,
                                              sel_alive, plan)
            assert survivor_cuda.survivor_eval.launches == before + 1
            want = survivor_cuda.survivor_eval_reference(
                ii, iit, vnf, win_ids, sel_alive, plan)
            torch.cuda.synchronize()
            assert torch.equal(got, want), (li, bi)
            n_in[bi] += int(sel_alive.sum())
            n_pass[bi] += int(got.sum())
            sel_alive = got
    assert n_in[0] > n_pass[0] > 0 and n_in[1] > 0


def test_survivor_kernel_engines_cuda_equal_cpu(cuda_device):
    """The eye engines' raw output (boxes, valid, overflow) on the card
    equals the CPU's for the same part images; the survivor kernel's
    launches (``survivor_eval.launches`` and, while tracing,
    ``vca.engine.survivor_kernel_launches``) rise by one a level and block
    for an eye engine and stay where they were for the face engine."""
    work = _part_work((320, 180), n=8)
    t = tracing.TRACER
    t.enabled = True
    try:
        face = CascadeEngine(load_cascade(DEFAULT_FACE_CASCADE), (160, 90),
                             1.25, device=cuda_device)
        before = (survivor_cuda.survivor_eval.launches,
                  t.counters["vca.engine.survivor_kernel_launches"])
        face.detect_raw(resize_linear_exact(work, (160, 90)).to(cuda_device))
        assert (survivor_cuda.survivor_eval.launches,
                t.counters["vca.engine.survivor_kernel_launches"]) == before
        for name in EYES:
            engs = [CascadeEngine(
                load_cascade(os.path.join(PKG_ASSETS_DIR, name)), (320, 180),
                1.1, min_size=(20, 20), device=dev)
                for dev in (cuda_device, "cpu")]
            before = (survivor_cuda.survivor_eval.launches,
                      t.counters["vca.engine.survivor_kernel_launches"])
            got = engs[0].detect_raw(work.to(cuda_device))
            n = len(engs[0].levels) * len(engs[0]._blocks)
            assert (survivor_cuda.survivor_eval.launches,
                    t.counters["vca.engine.survivor_kernel_launches"]) == (
                        before[0] + n, before[1] + n)
            want = engs[1].detect_raw(work)
            for g, w, what in zip(got, want, ("boxes", "valid", "overflow")):
                assert torch.equal(g.cpu(), w), (name, what)
    finally:
        t.enabled = False
        t.sections.clear()
        t.counters.clear()


@pytest.mark.parametrize("hw", [(180, 320), (37, 53), (1, 1)])
def test_tilted_table_kernel_equals_tilted_integral(cuda_device, hw):
    """The tilted-table kernel on the integral kernel's sum table equals the
    image's plain tilted table, also at the largest sums."""
    img = torch.from_numpy(np.random.RandomState(sum(hw)).randint(
        0, 256, (5,) + hw, np.uint8)).to(cuda_device)
    img[0] = 255
    ii, _ = integral_cuda.integral_tables(img)
    before = dense_level_cuda.tilted_table.launches
    got = dense_level_cuda.tilted_table(ii)
    assert dense_level_cuda.tilted_table.launches == before + 1
    want = tilted_integral_image(img)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_no_engine_has_a_tables_route(cuda_device):
    """Every level of the part chain's engines at 720p takes a kernel route:
    all of a tilted engine's levels the tilted kernels."""
    for det in (NoseDetector, MouthDetector, EyeDetector):
        d = det((1280, 720), device=cuda_device)
        for eng in (d.face_engine, *d.part_engines.values()):
            assert set(eng.routes) <= {"pyramid", "tilted"}
            if eng._uses_tilt:
                assert eng.routes == ["tilted"] * len(eng.levels)
                assert sorted(eng._level_plans) == list(
                    range(len(eng.levels)))


@pytest.mark.parametrize("target", [dense_cuda.BAND_SMEM_TARGET,
                                    dense_cuda.MAX_SMEM_BYTES, 0])
def test_band_kernel_equals_plain_version_on_wide_levels(cuda_device,
                                                         target):
    """The pyramid kernel on the nose's four wide levels at 320x180 (the
    row-strip kernel's before), in the default bands (three blocks an SM),
    in bands of a window's height and in bands of one grid row: level
    images, vnf and alive exactly."""
    eng = CascadeEngine(
        load_cascade(os.path.join(PKG_ASSETS_DIR, "vca_nose_synthetic.xml")),
        (320, 180), 1.1, min_size=(1, 1), device=cuda_device)
    plan = dense_cuda.PyramidDensePlan((320, 180), eng.levels[:4],
                                       eng._tables, band_target=target)
    assert plan.n_wide == 4
    work = _part_work((320, 180)).to(cuda_device)
    got = dense_cuda.pyramid_dense_phase(work, plan)
    want = dense_cuda.pyramid_dense_phase_reference(work, plan)
    torch.cuda.synchronize()
    _levels_equal(got, want)
    assert sum(int(a.sum()) for _, _, a in got) > 0


def test_band_kernel_reads_records_through_l1_on_widest_level(cuda_device):
    """At the widest level the pyramid kernel takes (1382 px for a 20-px
    window) a band of one grid row leaves no room for the tree records:
    the launch's blocks read them through L1, and all levels equal the
    plain version."""
    eng = CascadeEngine(load_cascade(DEFAULT_FACE_CASCADE), (1382, 60),
                        1.25, device=cuda_device)
    plan = eng._plan
    assert not plan.staged
    frames = np.stack(
        [face_scene(1382, 60, faces=((300 * s, 30, 40),), seed=s)
         for s in range(1, 4)]
        + [np.random.RandomState(1).randint(0, 256, (60, 1382), np.uint8)])
    work = torch.from_numpy(frames).to(cuda_device)
    got = dense_cuda.pyramid_dense_phase(work, plan)
    want = dense_cuda.pyramid_dense_phase_reference(work, plan)
    torch.cuda.synchronize()
    _levels_equal(got, want)
    assert sum(int(a.sum()) for _, _, a in got) > 0


@pytest.mark.parametrize("hw", [(180, 320), (112, 199), (37, 53), (1, 1),
                                (15, 320), (16, 320), (17, 320), (33, 320),
                                (720, 1280)])
def test_integral_kernel_equals_plain_version(cuda_device, hw):
    img = torch.from_numpy(np.random.RandomState(sum(hw)).randint(
        0, 256, (5,) + hw, np.uint8)).to(cuda_device)
    img[0] = 255                      # the largest sums
    before = integral_cuda.integral_tables.launches
    got = integral_cuda.integral_tables(img)
    assert integral_cuda.integral_tables.launches == before + 1
    want = integral_cuda.integral_tables_reference(img)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_integral_kernel_reuses_its_scratch(cuda_device):
    """Calls in a row on one stream share the look-back scratch (new
    epoch, no clearing), and a larger call grows it: every result exact."""
    rng = np.random.RandomState(4)
    for shape in [(64, 180, 320), (2, 40, 600), (64, 180, 320),
                  (64, 199, 112), (3, 17, 320), (64, 180, 320)]:
        img = torch.from_numpy(rng.randint(0, 256, shape, np.uint8)).to(
            cuda_device)
        got = integral_cuda.integral_tables(img)
        want = integral_cuda.integral_tables_reference(img)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert torch.equal(g, w), shape


@pytest.mark.parametrize("detector", [NoseDetector, MouthDetector,
                                      EyeDetector])
def test_part_detector_cuda_equals_cpu(cuda_device, detector):
    """Per-frame outputs and the device pass's raw results (grouped faces,
    compacted part candidates, overflow) equal the CPU run's, at 720p over
    two consecutive batches of one stream."""
    clip = face_clip(8, 1280, 720, seed=11)
    gpu = detector((1280, 720), device=cuda_device)
    cpu = detector((1280, 720), device="cpu")
    for b in (clip[:4], clip[4:]):
        assert gpu.process(b) == cpu.process(b)
    (f_g, p_g), (f_c, p_c) = gpu._device_pass(clip[:4]), cpu._device_pass(
        clip[:4])
    for g, w in zip(f_g, f_c):
        assert np.array_equal(g, w)
    for name in p_c:
        for g, w in zip(p_g[name], p_c[name]):
            assert np.array_equal(g, w), name


def test_face_process_cuda_equals_cpu(cuda_device):
    clip = face_clip(8, 1280, 720)
    fd_gpu = FaceDetector((1280, 720), device=cuda_device)
    fd_cpu = FaceDetector((1280, 720), device="cpu")
    got = fd_gpu.process(clip)
    want = fd_cpu.process(clip)
    as_t = lambda faces: [[(f.id, f.rect()) for f in fs] for fs in faces]
    assert as_t(got) == as_t(want)
    assert sum(len(f) for f in got) > 0


@pytest.mark.parametrize("n", [1, 3, 1023, 1025, 2**20 + 3])
@pytest.mark.parametrize("offset", [0, 1])
def test_quant_kernels_equal_plain_versions(cuda_device, n, offset):
    """Both quantizers, exactly (values and scale), on odd sizes and on a
    view whose start is not 16-byte aligned (the kernel's scalar path)."""
    x = torch.from_numpy(np.random.RandomState(n).randn(n + 1).astype(
        np.float32) * 3).to(cuda_device)[offset:offset + n]
    before = quant_cuda.quantize_int8.launches
    got = quant_cuda.quantize_int8(x)
    assert quant_cuda.quantize_int8.launches == before + 1
    want = quant.quantize_int8_reference(x)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    for seed in (0, 12345):
        before = quant_cuda.quantize_int8_stochastic.launches
        got = quant_cuda.quantize_int8_stochastic(x, seed)
        assert quant_cuda.quantize_int8_stochastic.launches == before + 1
        want = quant.quantize_int8_stochastic_reference(x, seed)
        for g, w in zip(got, want):
            assert torch.equal(g, w)


def test_quant_kernel_slot_holds_each_calls_maximum(cuda_device):
    """The maximum slot is never cleared between calls: a call after one
    with a larger maximum, on the same stream and on another, still takes
    its own scale; the grid is asked once per device."""
    big = torch.full((5000,), 1e6, device=cuda_device)
    rng = np.random.RandomState(3)
    xs = [torch.from_numpy(rng.randn(n).astype(np.float32)).to(cuda_device)
          for n in (7, 70_000, 5_000_000)]
    side = torch.cuda.Stream(cuda_device)
    for x in xs:
        quant_cuda.quantize_int8(big)
        side.wait_stream(torch.cuda.current_stream(cuda_device))
        for stream in (torch.cuda.current_stream(cuda_device), side):
            with torch.cuda.stream(stream):
                got = quant_cuda.quantize_int8(x)
                want = quant.quantize_int8_reference(x)
            stream.synchronize()
            for g, w in zip(got, want):
                assert torch.equal(g, w)
    assert quant_cuda.max_blocks.cache_info().misses == 1


def test_quant_kernel_on_all_zero_tensor(cuda_device):
    x = torch.zeros((3, 77), device=cuda_device)
    q, s = quant_cuda.quantize_int8(x)
    assert not q.any()
    assert s.item() == quant.quantize_int8_reference(x.cpu())[1].item()


def test_int8_detector_cuda_equals_cpu(cuda_device):
    """Every layer's int8 tensor and scale, the forward's output and the
    tracked faces equal the CPU run's, at 720p."""
    clip = face_clip(8, 1280, 720, seed=11)
    gpu = QuantizedCnnFaceDetector((1280, 720), device=cuda_device)
    cpu = QuantizedCnnFaceDetector((1280, 720), device="cpu")
    canvas = cpu.letterbox(torch.from_numpy(clip))
    taps_g, taps_c = [], []
    before = quant_cuda.quantize_int8.launches
    pred_g = gpu.model(canvas.to(cuda_device), taps_g)
    assert quant_cuda.quantize_int8.launches == before + 7
    pred_c = cpu.model(canvas, taps_c)
    for i, ((_, qg, sg), (_, qc, sc)) in enumerate(zip(taps_g, taps_c)):
        assert torch.equal(qg.cpu(), qc), f"layer {i}"
        assert sg.item() == sc.item(), f"layer {i} scale"
    assert torch.equal(pred_g.cpu(), pred_c)
    as_t = lambda faces: [[(f.id, f.rect()) for f in fs] for fs in faces]
    for b in (clip[:4], clip[4:]):
        got = as_t(gpu.process(b))
        assert got == as_t(cpu.process(b))
    assert sum(len(f) for f in got) > 0


def _pageable_work(frames, size, device):
    """The upload the staging ring replaced: the padded batch in one
    pageable copy, then resized and equalized whole."""
    padded, _ = bucket_pad(np.ascontiguousarray(frames))
    return equalize_hist(resize_linear_exact(
        torch.from_numpy(padded).to(device), size))


@pytest.mark.parametrize("reverse", [False, True],
                         ids=["forward", "reversed"])
def test_staging_ring_equals_pageable_upload(cuda_device, reverse):
    """A 64-frame 720p batch through the ring's pinned slots, in chunks,
    equals the pageable upload bit for bit at both part-detector sizes."""
    clip = face_clip(64, 1280, 720, seed=11)
    frames = clip[::-1] if reverse else clip
    sizes = [(160, 90), (320, 180)]
    ring = StagingRing(cuda_device)
    works, n_real = ring.stage(select_frames(frames), sizes)
    assert n_real == 64 and len(ring.slots[0]) < 64
    assert all(slot.is_pinned() for slot in ring.slots)
    for work, size in zip(works, sizes):
        assert torch.equal(work, _pageable_work(frames, size, cuda_device))


def test_staging_ring_calls_back_to_back(cuda_device):
    """Three calls with different clips and no synchronisation between
    them: each work batch is its own clip's (a slot reused before its
    copy ended would carry another clip's frames)."""
    clips = [face_clip(24, 1280, 720, seed=s) for s in (3, 4, 5)]
    ring = StagingRing(cuda_device)
    got = [ring.stage(select_frames(c), [(160, 90)])[0][0] for c in clips]
    for clip, work in zip(clips, got):
        assert torch.equal(work, _pageable_work(clip, (160, 90), cuda_device))


def test_bf16_detector_cuda_matches_cpu(cuda_device):
    """cuDNN and the CPU sum the bf16 convs in another order: the output
    agrees within the tolerance the JAX comparison uses, the faces
    exactly on this clip."""
    clip = face_clip(4, 1280, 720, seed=11)
    gpu = CnnFaceDetector((1280, 720), device=cuda_device)
    cpu = CnnFaceDetector((1280, 720), device="cpu")
    canvas = cpu.letterbox(torch.from_numpy(clip))
    err = (gpu.model(canvas.to(cuda_device)).cpu() - cpu.model(canvas)).abs()
    assert float(err.max()) <= 0.0625
    for g, w in zip(gpu.detect_boxes(clip), cpu.detect_boxes(clip)):
        assert np.array_equal(g, w)


EAR_PAIRINGS = {
    "default": None,
    "real_profile": os.path.join(PKG_ASSETS_DIR,
                                 "haarcascade_profileface.xml"),
}


def _ear_clip(n):
    return np.stack([profile_scene(
        1280, 720, heads=((340 + 2 * t, 360, 160, "left"),
                          (940 - 2 * t, 360, 160, "right")), seed=t)
        for t in range(n)])


@pytest.mark.parametrize("pairing", sorted(EAR_PAIRINGS))
def test_ear_pyramid_plans_equal_plain_version(cuda_device, pairing):
    """The pyramid kernel on both of the ear's plans (profile faces at
    160x90; ears at 320x180 with four wide levels) over the [normal,
    flipped] batch, exactly."""
    det = EarDetector((1280, 720), EarDetectorConfig(
        face_cascade_path=EAR_PAIRINGS[pairing]), device=cuda_device)
    gray = torch.from_numpy(_ear_clip(4)).to(cuda_device)
    both = torch.cat([gray, torch.flip(gray, dims=(2,))])
    for eng in (det.face_engine, det.part_engines["ear"]):
        work = equalize_hist(resize_linear_exact(both, (eng.image_w,
                                                        eng.image_h)))
        got = dense_cuda.pyramid_dense_phase(work, eng._plan)
        want = dense_cuda.pyramid_dense_phase_reference(work, eng._plan)
        torch.cuda.synchronize()
        _levels_equal(got, want)
    assert det.part_engines["ear"]._plan.n_wide == 4


@pytest.mark.parametrize("pairing", sorted(EAR_PAIRINGS))
def test_ear_detector_cuda_equals_cpu(cuda_device, pairing):
    """Per-frame outputs over two batches of one stream and the device
    pass's raw results on both halves of the flipped batch equal the CPU
    run's; the pyramid kernel launches twice per batch."""
    clip = _ear_clip(8)
    cfg = lambda: EarDetectorConfig(face_cascade_path=EAR_PAIRINGS[pairing])
    gpu = EarDetector((1280, 720), cfg(), device=cuda_device)
    cpu = EarDetector((1280, 720), cfg(), device="cpu")
    dense_cuda.pyramid_dense_phase.launches = 0
    for b in (clip[:4], clip[4:]):
        out = gpu.process(b)
        assert out == cpu.process(b)
    assert dense_cuda.pyramid_dense_phase.launches == 4
    (f_g, p_g), (f_c, p_c) = gpu._device_pass(clip[:4]), cpu._device_pass(
        clip[:4])
    for g, w in zip(f_g, f_c):
        assert np.array_equal(g, w)
    for g, w in zip(p_g["ear"], p_c["ear"]):
        assert np.array_equal(g, w)
    if pairing == "default":
        assert all(r["face_profile"] and r["ear"] for r in out)


def test_tracker_step_cuda_equals_cpu(cuda_device):
    """The MHI and ``segment_motion``'s rects (every seeded component, in
    first-seed order) equal the CPU run's frame by frame, and
    ``Tracker.process``'s blobs over the clip the CPU's."""
    clip = blob_clip(8)
    st_g = tracker.init_state(240, 320, cuda_device)
    st_c = tracker.init_state(240, 320, "cpu")
    n = 0
    for i, fr in enumerate(clip):
        st_g, ts_g = tracker._update(st_g, fr, i / 30.0, 20, 0.2)
        st_c, ts_c = tracker._update(st_c, fr, i / 30.0, 20, 0.2)
        assert torch.equal(st_g.mhi.cpu(), st_c.mhi), i
        got = tracker.segment_motion(st_g.mhi, ts_g, 0.05)
        want = tracker.segment_motion(st_c.mhi, ts_c, 0.05)
        assert torch.equal(got.cpu(), want), i
        n += len(want)
    assert n > 0
    gpu = tracker.Tracker((320, 240), device=cuda_device)
    cpu = tracker.Tracker((320, 240), device="cpu")
    assert gpu.process(clip) == cpu.process(clip)


def _blob_mhis(dev, n_frames, w, h):
    """The tracker's MHIs over the blob clip on `dev`, frame by frame."""
    state = tracker.init_state(h, w, dev)
    for i, fr in enumerate(blob_clip(n_frames, w, h)):
        state, _ = tracker._update(state, fr, i / 30.0, 20, 0.2)
        yield state.mhi


@pytest.mark.parametrize("case", ["blob_clip", "serpentine", "speckle",
                                  "thresh_edge", "frame_edges", "uniform",
                                  "zeros"])
def test_motion_ccl_equals_propagate(cuda_device, case):
    """The union-find kernel's labels equal the plain loop's
    (``_propagate``, on the card and on the CPU) bit for bit at a size
    that no tile divides, 321x239: the ``utils/synth.motion_maps`` cases
    and the blob clip's MHIs; three launches a frame."""
    w, h = 321, 239
    if case == "blob_clip":
        mhis = list(_blob_mhis(cuda_device, 10, w, h))[2::2]
    else:
        mhis = [torch.from_numpy(motion_maps(h, w, seed=7)[case]).to(
            cuda_device)]
    for mhi in mhis:
        before = motion_ccl_cuda.motion_ccl.launches
        got = motion_ccl_cuda.motion_ccl(mhi, 0.05)
        assert motion_ccl_cuda.motion_ccl.launches == before + 3
        assert got.dtype == torch.int64 and got.shape == (h * w,)
        assert torch.equal(got, tracker._propagate(mhi, 0.05))
        assert torch.equal(got.cpu(), tracker._propagate(mhi.cpu(), 0.05))


def test_motion_ccl_on_benchmark_footage(cuda_device):
    """The kernel's labels equal ``_propagate``'s on the MHIs of the
    tracker cell's 1280x720 footage (``vcabench/frozen/motion.py``, three
    streams of the ``motion_archive`` mix, every eighth frame of a
    clip)."""
    import json

    from vcabench.frozen import motion

    with open(os.path.join(os.path.dirname(__file__), "..", "vcabench",
                           "traffic", "motion_archive.json")) as f:
        mix = json.load(f)
    frame = (1280, 720)
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(4000000001)
    n_comp = 0
    for stream in motion.layout(mix, frame, 4000000001)[:3]:
        clip = motion.draw_clip(stream, frame, mix["clip_frames"], mix, gen,
                                cuda_device)
        state = tracker.init_state(frame[1], frame[0], cuda_device)
        for i, fr in enumerate(clip):
            state, _ = tracker._update(state, fr, i / 30.0, 20, 0.2)
            if i % 8 == 7:
                got = motion_ccl_cuda.motion_ccl(state.mhi, 0.05)
                assert torch.equal(got, tracker._propagate(state.mhi, 0.05))
                n_comp += int(((got == torch.arange(
                    got.numel(), device=cuda_device))
                    & (state.mhi.reshape(-1) > 0)).sum())
    assert n_comp > 0


def test_tracker_process_cuda_counts_kernel_frames(cuda_device):
    """``Tracker.process`` on the card equals the CPU run on the blob clip;
    while tracing, ``vca.tracker.ccl_frames`` equals ``vca.tracker.frames``
    and no ``vca.tracker.seg_iterations`` is counted (no iteration runs)."""
    clip = blob_clip(12)
    gpu = tracker.Tracker((320, 240), device=cuda_device)
    cpu = tracker.Tracker((320, 240), device="cpu")
    t = tracing.TRACER
    t.enabled = True
    try:
        t.counters.clear()
        before = motion_ccl_cuda.motion_ccl.launches
        got = gpu.process(clip)
        counters = dict(t.counters)
    finally:
        t.enabled = False
        t.sections.clear()
        t.counters.clear()
    assert got == cpu.process(clip)
    assert sum(map(len, got)) > 0
    assert counters["vca.tracker.ccl_frames"] == counters[
        "vca.tracker.frames"] == len(clip)
    assert "vca.tracker.seg_iterations" not in counters
    assert motion_ccl_cuda.motion_ccl.launches == before + 3 * len(clip)


@pytest.mark.parametrize("mode", ["rect", "circle", "overlay"])
def test_drawing_cuda_equals_twin(cuda_device, mode):
    """Rect and circle on the card equal the numpy twins; the blend equals
    the port's CPU run exactly and the twin within 1."""
    rng = np.random.RandomState(9)
    gray = face_clip(4, 640, 480, seed=3)
    bgr = np.stack([gray, 255 - gray, gray // 2 + 64], -1)
    rects = [[(int(rng.randint(-40, 640)), int(rng.randint(-40, 480)),
               int(rng.randint(0, 300)), int(rng.randint(0, 200)))
              for _ in range(6)] for _ in range(4)]
    kw = dict(mode=mode, color=(0, 0, 255))
    if mode == "overlay":
        overlay = rng.randint(0, 256, (32, 24, 4)).astype(np.uint8)
        overlay[..., 3] = rng.randint(1, 255, (32, 24))
        kw["overlay"] = (overlay, (0.1, -0.2, 1.3, 0.9))
    got = render_detections(bgr, rects, device=cuda_device, **kw)
    assert got.device.type == "cuda"
    got = got.cpu().numpy()
    host = render_detections(bgr, rects, host=True, **kw)
    if mode == "overlay":
        cpu = render_detections(bgr, rects, device="cpu", **kw).numpy()
        assert np.array_equal(got, cpu)
        assert np.abs(got.astype(np.int16) - host).max() <= 1
    else:
        assert np.array_equal(got, host)


# --------------------------------------------------------------- serving
def _color(gray):
    """BGR frames whose luma keeps the gray frames' faces."""
    return np.stack([gray, np.clip(gray.astype(np.int32) + 12, 0, 255),
                     np.clip(gray.astype(np.int32) - 15, 0, 255)],
                    -1).astype(np.uint8)


def test_cnn_part_detector_cuda_matches_cpu(cuda_device):
    """The learned part detector on the card: the output within the bf16
    tolerance of the CPU run's, every class's boxes within 2 px."""
    from nubomedia_vca_tpu_torch.models.cnn_parts import (CLASSES,
                                                          CnnPartDetector)

    frames = np.concatenate([
        face_clip(2, 1280, 720, seed=11),
        np.stack([profile_scene(1280, 720, heads=(
            (360, 360, 240, "left"), (920, 360, 240, "right")), seed=s)
            for s in range(2)])])
    gpu = CnnPartDetector((1280, 720), device=cuda_device)
    cpu = CnnPartDetector((1280, 720), device="cpu")
    canvas = cpu.letterbox(torch.from_numpy(frames))
    err = (gpu.model(canvas.to(cuda_device)).cpu() - cpu.model(canvas)).abs()
    assert float(err.max()) <= 0.0625
    got, want = gpu.process(frames), cpu.process(frames)
    for g, w in zip(got, want):
        for k in CLASSES:
            assert len(g[k]) == len(w[k]), k
            for a, b in zip(g[k], w[k]):
                assert max(abs(u - v) for u, v in zip(a, b)) <= 2, k
    assert sum(len(r[k]) for r in got for k in CLASSES) > 0


def test_annotated_frames_cuda_equal_cpu(cuda_device):
    """One media-loop step (face → event-gated eye, drawn on the color
    frames on the device) on the card equals the CPU run: the results and
    the annotated frames."""
    from nubomedia_vca_tpu_torch.api import media_loop, objects

    gray = face_clip(4, 640, 480, seed=3)
    bgr = _color(gray)
    out = {}
    for dev in (cuda_device, "cpu"):
        pipe = objects.MediaPipeline((640, 480), device=dev)
        objects.NuboFaceDetector(pipe)
        eye = objects.NuboEyeDetector(pipe)
        eye.detectByEvent(1)
        runner = media_loop.MediaRunner(pipe)
        frames = []
        runner.on_annotated = lambda o, s: frames.append(o)
        runner._step(gray, stream=0, color=bgr)
        out[str(dev)] = frames
        pipe.release()
    got, want = out[str(cuda_device)], out["cpu"]
    assert len(got) == len(want) == 1
    assert np.array_equal(got[0], want[0])
    assert (got[0] != bgr).any()


def test_rpc_serving_on_card(cuda_device):
    """The RPC server on the card (its default device), driven by the
    generated client: annotated BGR frames read back over TCP equal the
    element called directly on the CPU, through the pyramid kernel."""
    import socket
    import sys
    import threading

    from nubomedia_vca_tpu_torch.api import objects, rpc
    from nubomedia_vca_tpu_torch.ops.color import bgr_to_gray

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "clients", "python"))
    import nubomedia_vca_client as gen

    w, h, n = 640, 480, 8
    bgr = _color(face_clip(n, w, h, seed=2))
    srv = rpc.VcaRpcServer(port=0, frame_size=(w, h)).start()
    assert srv.device.type == "cuda"
    before = dense_cuda.pyramid_dense_phase.launches
    cli = gen.KurentoClient("127.0.0.1", srv.port)
    try:
        pipe = cli.create_pipeline()
        pipe.createNuboFaceDetector()
        port = cli.call("invoke", {
            "object": pipe.id, "operation": "listen",
            "operationParams": {"port": 0, "channels": 3, "output": 1}},
            timeout=600)["value"]
        back = bytearray()
        with socket.create_connection(("127.0.0.1", port), timeout=60) as s:
            def read():
                while len(back) < n * w * h * 3:
                    chunk = s.recv(1 << 20)
                    if not chunk:
                        return
                    back.extend(chunk)

            reader = threading.Thread(target=read)
            reader.start()
            for fr in bgr:
                s.sendall(fr.tobytes())
            reader.join(600)
        stats = cli.call("invoke", {"object": pipe.id,
                                    "operation": "getStats"})["value"]
        cli.call("invoke", {"object": pipe.id, "operation": "stopMedia"},
                 timeout=600)
    finally:
        cli.close()
        srv.stop()
    assert stats["framesProcessed"] == n and stats["dropped"] == 0
    assert dense_cuda.pyramid_dense_phase.launches > before
    got = np.frombuffer(bytes(back), np.uint8).reshape(n, h, w, 3)
    direct = objects.NuboFaceDetector(objects.MediaPipeline((w, h),
                                                            device="cpu"))
    gray = bgr_to_gray(torch.from_numpy(bgr)).numpy()
    want = direct.render(bgr, direct.process(gray)).numpy()
    assert np.array_equal(got, want)
    assert (got != bgr).any()


# ------------------------------------------------------------- training
LR = 3e-4
# the same torch code on the card and on the CPU (chip_smoke.py's bounds)
CARD_LOSS_RTOL = 1e-5
CARD_GRAD_TOL = 2e-2
CARD_PARAM_MEDIAN = LR / 1000


def test_teacher_labels_cuda_equal_cpu(cuda_device):
    """The distillation teacher at 320x240: one pyramid launch per
    labelled batch, labels equal to the CPU teacher's."""
    frames = face_clip(8, 320, 240, seed=5)
    gpu = distill.make_teacher(cuda_device)
    before = dense_cuda.pyramid_dense_phase.launches
    got = distill.label_batch(gpu, frames)
    assert dense_cuda.pyramid_dense_phase.launches == before + 1
    want = distill.label_batch(distill.make_teacher("cpu"), frames)
    for g, w in zip(got, want):
        assert np.array_equal(g, w)
    assert got[1].any()


def _train_entries(n, device):
    rs = np.random.RandomState(0)
    clip = face_clip(4 * n, 320, 240, seed=2)
    out = []
    for k in range(n):
        boxes = torch.from_numpy(np.concatenate(
            [rs.randint(0, 200, (4, 3, 2)), rs.randint(20, 100, (4, 3, 2))],
            axis=-1).astype(np.float32))
        valid = torch.from_numpy(rs.rand(4, 3) < 0.7)
        obj, reg = cnn.boxes_to_targets(boxes.to(device), valid.to(device),
                                        240, 320)
        cobj, creg = cnn.boxes_to_targets(boxes, valid, 240, 320)
        assert torch.equal(obj.cpu(), cobj) and torch.equal(reg.cpu(), creg)
        out.append((torch.from_numpy(clip[4 * k:4 * k + 4]), cobj, creg))
    return out


def _trainer(device, seed=1):
    model = cnn.CnnNet(cnn.init_params(torch.Generator().manual_seed(seed),
                                       ctx=True)).to(device)
    opt, sched = cnn.make_optimizer(model.parameters(), LR, steps=20)
    return model, opt, sched


def test_train_steps_cuda_match_cpu(cuda_device):
    """3 steps at the shipped width from the same weights and batches:
    losses within CARD_LOSS_RTOL relative, parameters within 2·Σ lr of the
    steps taken and a median within CARD_PARAM_MEDIAN; targets built on
    the card equal the CPU's."""
    entries = _train_entries(3, cuda_device)
    runs = []
    for dev in (cuda_device, torch.device("cpu")):
        model, opt, sched = _trainer(dev)
        losses, lrs = [], []
        for e in entries:
            lrs.append(opt.param_groups[0]["lr"])
            losses.append(float(cnn.train_step(
                model, opt, sched, *(t.to(dev) for t in e))[0]))
        runs.append((losses, [p.detach().cpu() for p in model.parameters()]))
    (gl, gp), (cl, cp) = runs
    for g, c in zip(gl, cl):
        assert abs(g - c) <= CARD_LOSS_RTOL * abs(c)
    d = torch.cat([(a - b).abs().flatten() for a, b in zip(gp, cp)])
    assert float(d.max()) <= 2 * sum(lrs)
    assert float(d.median()) <= CARD_PARAM_MEDIAN


def test_train_grads_cuda_match_cpu(cuda_device):
    """The loss's gradient at the same weights on one batch, leaf by
    leaf: within CARD_GRAD_TOL of the leaf's largest |gradient|."""
    entry = _train_entries(1, cuda_device)[0]
    grads = []
    for dev in (cuda_device, torch.device("cpu")):
        model, _, _ = _trainer(dev)
        cnn.loss_fn(model, *(t.to(dev) for t in entry))[0].backward()
        grads.append({k: p.grad.cpu() for k, p in model.named_parameters()})
    for k, c in grads[1].items():
        gap = float((grads[0][k] - c).abs().max() / c.abs().max())
        assert gap <= CARD_GRAD_TOL, (k, gap)


def test_train_state_round_trip_cuda(cuda_device, tmp_path):
    entries = [tuple(t.to(cuda_device) for t in e)
               for e in _train_entries(3, cuda_device)]
    model, opt, sched = _trainer(cuda_device)
    for e in entries[:2]:
        cnn.train_step(model, opt, sched, *e)
    checkpoint.save_train_state(str(tmp_path), model, opt, sched, 2)
    model2, opt2, sched2 = _trainer(cuda_device, seed=2)
    assert checkpoint.load_train_state(str(tmp_path), model2, opt2,
                                       sched2) == 2
    for a, b in zip(model.state_dict().values(),
                    model2.state_dict().values()):
        assert a.device.type == "cuda" and torch.equal(a, b)
    for p, p2 in zip(model.parameters(), model2.parameters()):
        for key in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(opt.state[p][key], opt2.state[p2][key])
    assert opt.param_groups[0]["lr"] == opt2.param_groups[0]["lr"]
    want = float(cnn.train_step(model, opt, sched, *entries[2])[0])
    got = float(cnn.train_step(model2, opt2, sched2, *entries[2])[0])
    assert abs(got - want) <= CARD_LOSS_RTOL * abs(want)


def test_world_one_nccl_sharding_equals_unsharded(cuda_device):
    """The multi-device dry run at world size 1 on NCCL (one card): the
    sharded detection, serving step and part chain equal the unsharded
    engines on the card, the dp×tp train step the unsharded step within
    ``dryrun.LOSS_RTOL`` and its parameter bounds, and the chain's
    kernels launch on the sharded path."""
    from nubomedia_vca_tpu_torch.parallel import dryrun

    rep, = dryrun.dryrun_multichip(1, "cuda", timeout=300.0)
    n = rep["launches"]
    assert n["pyramid_dense_phase"] >= 2           # detect, serve, chain
    assert n["dense_level_tilted"] == n["integral_tables"] > 0
    assert rep["train_check"]["loss_rel"] <= dryrun.LOSS_RTOL
    assert rep["schedule_check"]["loss_rel"] <= dryrun.LOSS_RTOL


def test_trainer_gemm_cuda_equals_cpu(cuda_device):
    """The cascade trainer's feature GEMM on the card equals the CPU's
    bit for bit at the recipe's window and pool (20x20, 3000 features),
    saturated windows included."""
    from nubomedia_vca_tpu_torch.cascade import train

    mat = train.corner_matrix(train.feature_pool(20, 20, max_features=3000),
                              20, 20)
    samples = np.random.RandomState(0).randint(0, 256, (2500, 20, 20)
                                               ).astype(np.uint8)
    samples[:8] = 255
    got = train.feature_values(samples, mat, device=cuda_device)
    want = train.feature_values(samples, mat, device="cpu")
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_entry_on_the_card_equals_cpu(cuda_device):
    """The entry point's fn on its example batch and on face frames: one
    pyramid launch a call, raw candidates equal to the CPU entry's."""
    from nubomedia_vca_tpu_torch import entry

    fn, (example,) = entry.entry()
    cpu_fn, (cpu_example,) = entry.entry("cpu")
    assert example.device.type == "cuda"
    assert torch.equal(example.cpu(), cpu_example)
    faces = torch.from_numpy(face_clip(4, 640, 480, seed=3))
    for x in (cpu_example, faces):
        before = dense_cuda.pyramid_dense_phase.launches
        got = fn(x.to(cuda_device))
        torch.cuda.synchronize()
        assert dense_cuda.pyramid_dense_phase.launches == before + 1
        for g, w in zip(got, cpu_fn(x)):
            assert torch.equal(g.cpu(), w)


def test_bench_gate_on_the_card(cuda_device):
    """bench_torch.py's gate on its first 4 frames: the grouped step, the
    chain and the learned detectors on the card against the CPU run, with
    raw face candidates, part candidates and learned boxes found."""
    import bench_torch

    frames = bench_torch.variant(bench_torch.make_frames(
        bench_torch.GATE_FRAMES), 0)
    x = torch.from_numpy(frames).to(cuda_device)
    found = bench_torch.gate_grouped(bench_torch.grouped_steps(cuda_device),
                                     x, "grouped")
    assert found["raw"] > 0
    assert bench_torch.gate_chain(bench_torch.chain_step(cuda_device)[1],
                                  x)["parts"] > 0
    found = bench_torch.gate_cnn(bench_torch.cnn_detectors(cuda_device),
                                 frames)
    assert all(v > 0 for v in found.values())
