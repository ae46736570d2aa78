"""The check on the CPU at a tiny size: the plain reference agrees with
the program on both configurations, on frames where it finds something;
the lower-precision control and each fault that the archive cells can
have come out as not correct."""

from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch

from vcabench.drivers import archive
from vcabench.reference import filters
from vcabench.tests import helpers

torch.set_num_threads(4)

CASCADES = os.path.join(helpers.REPO, helpers.PACKAGE, "assets",
                        "haarcascades")
SEED = 2_718_281_828


def tiny(config: str) -> tuple[dict, dict]:
    with open(os.path.join(helpers.REPO, "vcabench", "configs",
                           config + ".json")) as f:
        cfg = json.load(f)
    cfg["frame"] = [320, 180]
    return cfg, dict(helpers.TINY_MIX)


@pytest.mark.parametrize("config", ["face720p", "eye720p"])
def test_reference_agrees_with_the_program(config):
    cfg, mix = tiny(config)
    a = archive.Archive(cfg, mix, SEED, torch.device("cpu"), CASCADES)
    for i in range(2 * a.n_streams):         # both streams, both ways
        assert a.call(i) == a.batch
    a.release()
    want = a.expected(a.reference())
    n, bad = a.compare(want, dict(enumerate(a.results)))
    assert (n, bad) == (4 * a.batch, 0)
    found = [r for res in want.values() for r in res
             if (any(r.values()) if isinstance(r, dict) else r)]
    assert len(found) >= n // 4, "the frames must give the check something"


class ReferenceProgram:
    """The reference in bfloat16 in the program's place: the control."""

    def __init__(self, cfg):
        self.face = cfg["filter"] == "face"
        cls = filters.FaceFilter if self.face else filters.EyeFilter
        self.flt = cls(cfg, CASCADES, "cpu", torch.bfloat16)

    def process(self, frames, stream=0):
        dets = self.flt.detect(frames)
        if self.face:
            return self.flt.track(stream, dets)
        return [self.flt.frame_result(stream, d) for d in dets]


def _state_unchanged(mp, config):
    if config == "face720p":
        from nubomedia_vca_tpu_torch.models import face
        mp.setattr(face.FaceTracks, "update",
                   lambda self, det, thr: self.faces)
    else:
        from nubomedia_vca_tpu_torch.models import parts
        mp.setattr(parts.PartDetectorBase, "_merge_consecutive",
                   lambda self, key, new, eu: list(self._prev.get(key, [])))


def _half_batch(mp, config):
    from nubomedia_vca_tpu_torch.models import face, parts
    if config == "face720p":
        real = face.FaceDetector.detect_boxes

        def detect_boxes(self, gray):
            out = real(self, gray)
            h = (len(out) + 1) // 2
            return out[:h] + [np.zeros((0, 4), np.int32)] * (len(out) - h)

        mp.setattr(face.FaceDetector, "detect_boxes", detect_boxes)
    else:
        real = parts.PartDetectorBase._device_pass

        def device_pass(self, gray):
            face_raw, part_raw = real(self, gray)
            valid = face_raw[1].copy()
            valid[(len(valid) + 1) // 2:] = False
            return (face_raw[0], valid, *face_raw[2:]), part_raw

        mp.setattr(parts.PartDetectorBase, "_device_pass", device_pass)


def _answer_altered(mp, config):
    from nubomedia_vca_tpu_torch.models import face, parts
    if config == "face720p":
        real = face.FaceDetector.detect_boxes
        mp.setattr(face.FaceDetector, "detect_boxes",
                   lambda self, g: [b + np.array([1, 0, 0, 0], np.int32)
                                    for b in real(self, g)])
    else:
        real = parts.PartDetectorBase._to_original
        mp.setattr(parts.PartDetectorBase, "_to_original",
                   lambda self, r, *a: [(x + 1, y, w, h) for x, y, w, h
                                        in real(self, r, *a)])


class _Face(tuple):
    def rect(self):
        return tuple(self[:4])


class ReferenceModel(ReferenceProgram):
    """The bfloat16 reference as the live face element's model."""

    def __init__(self, cfg):
        super().__init__(cfg)
        self.work_w, self.work_h = self.flt.work

    def process(self, frames, stream=0, events=None):
        return [[_Face(f) for f in faces]
                for faces in super().process(frames, stream)]


def _control(mp, config):
    mp.setattr(archive, "_program",
               lambda cfg, device: ReferenceProgram(cfg))
    from nubomedia_vca_tpu_torch.api import objects
    mp.setattr(objects.NuboFaceDetector, "_build_model",
               lambda self: ReferenceModel(dict(
                   json.load(open(os.path.join(
                       helpers.REPO, "vcabench", "configs",
                       "face720p.json"))), frame=[320, 180])))


FAULTS = {"state_unchanged": _state_unchanged, "half_batch": _half_batch,
          "answer_altered": _answer_altered, "control_bfloat16": _control}
CELLS = [("face720p", "tiny", 0.5), ("eye720p", "tiny", 0.01),
         ("face720p", "tiny_live", 2.0)]


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    return {c: helpers.tiny_tree(tmp_path_factory.mktemp(c), c)
            for c in ("face720p", "eye720p")}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("config,mix,seconds", CELLS)
def test_faults_are_not_correct(trees, monkeypatch, config, mix, seconds,
                                fault):
    FAULTS[fault](monkeypatch, config)
    line, _ = helpers.run_cell(trees[config], f"{config}_tiny.{mix}", SEED,
                               seconds, 0)
    assert line["correct"] is False
    c = line["checks"]["frames_differing_pct"]
    assert c["value"] > c["limit"]
