"""Full chained pipeline demo on the PyTorch port — the counterpart of
``examples/full_chain_demo.py``: the reference's flagship deployment shape
(a face detector feeding event-gated part detectors, plus the motion
tracker) over a synthetic clip, with rendered output frames.

    python examples/torch_full_chain_demo.py [--device cpu] [--frames 8]

The frames are ``utils/synth`` cartoon faces and moving blobs (no cv2
needed).
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--frames", type=int, default=8)
    args = ap.parse_args(argv)
    dev = args.device

    from nubomedia_vca_tpu_torch.api.render import render_detections
    from nubomedia_vca_tpu_torch.models.eye import (EyeDetector,
                                                    EyeDetectorConfig)
    from nubomedia_vca_tpu_torch.models.face import FaceDetector
    from nubomedia_vca_tpu_torch.models.mouth import MouthDetector
    from nubomedia_vca_tpu_torch.models.tracker import Tracker
    from nubomedia_vca_tpu_torch.pipeline.graph import (FilterNode,
                                                        VcaPipeline)
    from nubomedia_vca_tpu_torch.utils.synth import blob_clip, face_clip

    clip = face_clip(args.frames)
    pipe = (
        VcaPipeline()
        .add(FilterNode("face", FaceDetector((640, 480), device=dev), "face",
                        emits=("face",)))
        .add(FilterNode("eye", EyeDetector((640, 480), EyeDetectorConfig(
            detect_event=1), device=dev), "eye", consumes={"face"}))
        .add(FilterNode("mouth", MouthDetector((640, 480), device=dev),
                        "mouth", consumes={"face"}))
    )
    events = pipe.process(clip)
    for i in range(args.frames):
        row = []
        for name in ("face", "eye", "mouth"):
            dets = events[name][i].detections
            row.append(f"{name}:{len(dets)}")
        print(f"frame {i}: " + "  ".join(row))
        for d in events["face"][i].detections:
            print(f"    face id={d.id} at ({d.x},{d.y},{d.width},{d.height})")

    rendered = render_detections(
        clip, [[(d.x, d.y, d.width, d.height)
                for d in events["face"][i].detections]
               for i in range(args.frames)], device=dev)
    out = rendered.cpu().numpy()
    print("rendered frames:", out.shape, "nonzero overlay px:",
          int((out != clip).sum()))

    print("\n--- motion tracker on a moving-blob clip ---")
    blobs = Tracker((320, 240), device=dev).process(blob_clip(8))
    for i, bl in enumerate(blobs):
        print(f"frame {i}: {bl}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
