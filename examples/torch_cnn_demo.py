"""Learned-detector demo on the PyTorch port — the counterpart of
``examples/cnn_demo.py``: the shipped CNN face detector (distilled from
the Haar cascade teacher, ``models/distill.py``) as a pipeline element
whose faces feed the event-gated eye detector, as the reference's face
element feeds part detectors over GstEvents.

    python examples/torch_cnn_demo.py [--device cpu] [--quantized]
                                      [--teacher-eval]

The frames are ``utils/synth`` cartoon faces at the detector's 320x240
working size (no cv2 needed). --teacher-eval also runs the held-out
recall/precision evaluation against the cascade teacher
(``distill.evaluate``; its scenes are drawn with cv2).
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--quantized", action="store_true",
                    help="the int8 detector instead of the bf16 one")
    ap.add_argument("--teacher-eval", action="store_true",
                    help="also evaluate recall/precision vs the cascade "
                         "teacher on held-out scenes")
    args = ap.parse_args(argv)

    from nubomedia_vca_tpu_torch.models import cnn, distill
    from nubomedia_vca_tpu_torch.models.eye import (EyeDetector,
                                                    EyeDetectorConfig)
    from nubomedia_vca_tpu_torch.models.quant import (
        QuantizedCnnFaceDetector)
    from nubomedia_vca_tpu_torch.pipeline.graph import (FilterNode,
                                                        VcaPipeline)
    from nubomedia_vca_tpu_torch.utils.synth import face_clip

    ckpt = cnn.find_checkpoint()
    if ckpt is None:
        print("no checkpoint found — train one first:\n"
              "  python -m nubomedia_vca_tpu_torch.models.distill --out "
              "nubomedia_vca_tpu_torch/assets/checkpoints/cnn_face_v1.npz")
        return 1
    print(f"checkpoint: {ckpt}")

    W, H = cnn.CnnFaceDetector.WORK_W, cnn.CnnFaceDetector.WORK_H
    clip = face_clip(args.frames, W, H, seed=7)
    cls = QuantizedCnnFaceDetector if args.quantized else cnn.CnnFaceDetector
    pipe = (
        VcaPipeline()
        .add(FilterNode("face", cls((W, H), device=args.device), "face",
                        emits=("face",)))
        .add(FilterNode("eye", EyeDetector((W, H), EyeDetectorConfig(
            detect_event=1), device=args.device), "eye", consumes={"face"}))
    )
    events = pipe.process(clip)
    for i in range(args.frames):
        faces = events["face"][i].detections
        eyes = events["eye"][i].detections
        print(f"frame {i}: faces={len(faces)} eyes={len(eyes)}")
        for d in faces:
            print(f"    face id={d.id} at ({d.x},{d.y},{d.width},{d.height})")

    if args.teacher_eval:
        print("\n--- held-out eval vs cascade teacher ---")
        distill.evaluate(cnn.load_params_npz(ckpt), n_scenes=64,
                         device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
