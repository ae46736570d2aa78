"""Kurento-style RPC round trip on the PyTorch port, with the GENERATED
client library — the counterpart of ``examples/rpc_client_demo.py``:
start the port's server, create a pipeline and a face detector, configure
it, subscribe to OnFace, feed frames, receive the event.

The IDL and the Python client are generated from the port's API surface
(``api/idl.py``, ``api/client_gen.py``, the kurento-module-creator
analog) into a temporary directory; their bytes equal the committed
``clients/python``.

    python examples/torch_rpc_client_demo.py [--device cpu]
"""

import argparse
import os
import sys
import tempfile
import time

ROOT = os.path.join(os.path.dirname(__file__), "..")
sys.path.insert(0, ROOT)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    from nubomedia_vca_tpu_torch.api import client_gen, idl
    from nubomedia_vca_tpu_torch.api.rpc import VcaRpcServer
    from nubomedia_vca_tpu_torch.utils.synth import face_clip

    with tempfile.TemporaryDirectory() as tmp:
        idl.emit_all(os.path.join(tmp, "idl"))
        client_gen.generate(os.path.join(tmp, "idl"),
                            os.path.join(tmp, "clients"))
        sys.path.insert(0, os.path.join(tmp, "clients", "python"))
        import nubomedia_vca_client as kc

    srv = VcaRpcServer(port=0, frame_size=(640, 480),
                       device=args.device).start()
    try:
        client = kc.KurentoClient("127.0.0.1", srv.port)
        pipe = client.create_pipeline()
        fd = pipe.createNuboFaceDetector()
        print("created:", pipe.id, fd.id)
        fd.multiScaleFactor(scaleFactor=25)
        fd.widthToProcess(width=160)
        fd.showFaces(viewFaces=1)
        fd.activateServerEvents(activate=1, time=0)

        got = []
        fd.onFace(lambda data: got.append(data))

        # feed frames host-side (media ingest plane)
        srv.objects[fd.id].process(face_clip(1))
        deadline = time.time() + 60
        while not got and time.time() < deadline:
            time.sleep(0.05)
        print("event:", str(got[0])[:200] if got else "none", "...")
        fd.release()
        client.close()
    finally:
        srv.stop()
    return 0 if got else 1


if __name__ == "__main__":
    sys.exit(main())
