"""The port's JSON-RPC server (``api/rpc.py``) against the JAX package's,
and the serving plane end to end on the CPU.

* The WebSocket layer: the handshake's accept key and the server's frames
  byte for byte as the JAX server's, client-masked frames of every length
  form decoded alike; the Kurento verbs (create, invoke, subscribe,
  unsubscribe, release, ping) and their errors give the JAX server's
  responses; the creatable types are the JAX package's.
* ``VcaRpcServer(port=0, device="cpu")`` driven by the generated
  ``clients/python`` client: create, invoke ``listen``, subscribe, raw
  frames over TCP, ``onEvent``, ``getStats``, ``stopMedia``. With
  ``listen(channels=3, output=1)`` the annotated BGR frames read back equal
  the element called directly, on the port and in the JAX package; with
  ``listen(channels=1, downscale=1)`` the learned detector sees
  working-resolution frames and reports the faces of full-resolution
  processing.
"""

from __future__ import annotations

import os
import re
import socket
import struct
import sys
import threading
import time

import numpy as np
import pytest
import torch

from nubomedia_vca_tpu.api import objects as jobjects
from nubomedia_vca_tpu.api import rpc as jrpc
from nubomedia_vca_tpu_torch.api import objects, rpc
from nubomedia_vca_tpu_torch.ops.color import bgr_to_gray
from nubomedia_vca_tpu_torch.utils.synth import face_clip

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "clients", "python"))
import nubomedia_vca_client as gen  # noqa: E402

W, H = 320, 240


def _wait(pred, timeout=300.0):
    t0 = time.time()
    while time.time() - t0 < timeout:
        if pred():
            return True
        time.sleep(0.02)
    return False


# ---------------------------------------------------------------- websocket
def test_creatable_types_match_jax():
    assert list(rpc.CREATABLE) == list(jrpc.CREATABLE)
    for name, cls in rpc.CREATABLE.items():
        assert cls.__name__ == name
        assert cls.__module__ == "nubomedia_vca_tpu_torch.api.objects"


def _pair():
    a, b = socket.socketpair()
    a.settimeout(5)
    b.settimeout(5)
    return a, b


def test_handshake_matches_jax():
    # the RFC 6455 section 1.3 example key and its accept value
    req = (b"GET / HTTP/1.1\r\nHost: x\r\nUpgrade: websocket\r\n"
           b"Connection: Upgrade\r\n"
           b"Sec-WebSocket-Key: dGhlIHNhbXBsZSBub25jZQ==\r\n\r\n")
    replies = []
    for mod in (rpc, jrpc):
        a, b = _pair()
        with a, b:
            b.sendall(req)
            assert mod._ws_handshake(a)
            replies.append(b.recv(4096))
    assert replies[0] == replies[1]
    assert b"s3pPLMBiTxaQ9kYGzzhZRbK+xOo=" in replies[0]
    a, b = _pair()
    with a, b:
        b.sendall(b"GET / HTTP/1.1\r\nHost: x\r\n\r\n")
        assert not rpc._ws_handshake(a)


@pytest.mark.parametrize("n", [5, 125, 126, 300, 65535, 70000])
def test_frames_match_jax(n):
    text = "".join(chr(0x41 + i % 26) for i in range(n - 1)) + "é"
    sent = []
    for mod in (rpc, jrpc):
        a, b = _pair()
        with a, b:
            mod._ws_send(a, text)
            a.shutdown(socket.SHUT_WR)
            buf = b""
            while chunk := b.recv(1 << 16):
                buf += chunk
            sent.append(buf)
    assert sent[0] == sent[1]
    # a client-masked frame of the same text decodes alike
    payload = text.encode()
    mask = bytes([0x11, 0x22, 0x33, 0x44])
    body = bytes(c ^ mask[i % 4] for i, c in enumerate(payload))
    m = len(payload)
    hdr = (struct.pack(">BB", 0x81, 0x80 | m) if m < 126 else
           struct.pack(">BBH", 0x81, 0x80 | 126, m) if m < 65536 else
           struct.pack(">BBQ", 0x81, 0x80 | 127, m))
    for mod in (rpc, jrpc):
        a, b = _pair()
        with a, b:
            threading.Thread(target=b.sendall,
                             args=(hdr + mask + body,)).start()
            assert mod._ws_recv(a) == text
    a, b = _pair()
    with a, b:
        b.sendall(struct.pack(">BB", 0x88, 0))        # close frame
        assert rpc._ws_recv(a) is None


def _script(server):
    """A fixed request sequence → the responses, object and subscription
    ids replaced by their order of appearance."""
    pushed = []
    reqs = [
        {"id": 1, "method": "ping"},
        {"id": 2, "method": "create", "params": {"type": "NoSuchType"}},
        {"id": 3, "method": "create",
         "params": {"type": "NuboFaceDetector", "constructorParams": {}}},
        {"id": 4, "method": "create",
         "params": {"type": "MediaPipeline", "sessionId": "s1"}},
    ]
    out = [server.handle_request(r, pushed.append) for r in reqs]
    pipe = out[-1]["result"]["value"]
    more = [
        {"id": 5, "method": "create",
         "params": {"type": "NuboFaceDetector",
                    "constructorParams": {"mediaPipeline": pipe}}},
    ]
    out += [server.handle_request(r, pushed.append) for r in more]
    face = out[-1]["result"]["value"]
    reqs = [
        {"id": 6, "method": "invoke",
         "params": {"object": face, "operation": "showFaces",
                    "operationParams": {"viewFaces": 0}}},
        {"id": 7, "method": "invoke",
         "params": {"object": face, "operation": "_ensure_model"}},
        {"id": 8, "method": "invoke",
         "params": {"object": face, "operation": "noSuchOperation"}},
        {"id": 9, "method": "invoke",
         "params": {"object": "missing", "operation": "showFaces"}},
        {"id": 10, "method": "invoke",
         "params": {"object": pipe, "operation": "getStats"}},
        {"id": 11, "method": "invoke",
         "params": {"object": pipe, "operation": "framesProcessed"}},
        {"id": 12, "method": "invoke",
         "params": {"object": face, "operation": "widthToProcess",
                    "operationParams": {"bad": 1}}},
        {"id": 13, "method": "subscribe",
         "params": {"object": face, "type": "OnFace"}},
        {"id": 14, "method": "subscribe",
         "params": {"object": "missing", "type": "OnFace"}},
        {"id": 15, "method": "release", "params": {"object": face}},
        {"id": 16, "method": "invoke",
         "params": {"object": face, "operation": "showFaces",
                    "operationParams": {"viewFaces": 1}}},
        {"id": 17, "method": "noSuchMethod"},
    ]
    out += [server.handle_request(r, pushed.append) for r in reqs]
    sub = out[-5]["result"]["value"]
    out.append(server.handle_request(
        {"id": 18, "method": "unsubscribe",
         "params": {"subscription": sub}}, pushed.append))
    text = repr(out)
    for i, oid in enumerate((pipe, face, sub)):
        text = text.replace(oid, f"<id{i}>")
    return re.sub(r"'(\w+)_[0-9a-f]{12}'", r"'\1_<id>'", text), pushed


def test_handle_request_matches_jax():
    got, pushed = _script(rpc.VcaRpcServer(port=0, device="cpu"))
    want, _ = _script(jrpc.VcaRpcServer(port=0))
    assert got == want
    assert "pong" in got and "-32601" in got and "-32001" in got
    assert not pushed


# ------------------------------------------------------- serving end to end
def _bgr(gray):
    return np.stack([gray,
                     np.clip(gray.astype(np.int32) + 12, 0, 255),
                     np.clip(gray.astype(np.int32) - 15, 0, 255)],
                    axis=-1).astype(np.uint8)


@pytest.fixture
def server():
    srv = rpc.VcaRpcServer(port=0, frame_size=(W, H), device="cpu").start()
    try:
        yield srv
    finally:
        srv.stop()


def _invoke(cli, oid, op, **params):
    return cli.call("invoke", {"object": oid, "operation": op,
                               "operationParams": params},
                    timeout=600)["value"]


def test_serving_over_rpc_annotated_bgr_frames(server):
    """Generated client → listen(channels=3, output=1) → BGR frames over
    TCP → OnFace over RPC and the annotated frames read back."""
    bgr = _bgr(face_clip(6, W, H, seed=2))
    n = len(bgr)
    cli = gen.KurentoClient("127.0.0.1", server.port)
    try:
        pipe = cli.create_pipeline()
        face = pipe.createNuboFaceDetector()
        face.activateServerEvents(1, 1)
        events = []
        face.onFace(events.append)
        port = _invoke(cli, pipe.id, "listen", port=0, channels=3,
                       output=1)
        back = bytearray()
        with socket.create_connection(("127.0.0.1", port), timeout=60) as s:
            def read():
                while len(back) < n * W * H * 3:
                    chunk = s.recv(1 << 20)
                    if not chunk:
                        return
                    back.extend(chunk)

            reader = threading.Thread(target=read)
            reader.start()
            for fr in bgr:
                s.sendall(fr.tobytes())
            reader.join(600)
            assert not reader.is_alive()
        assert _wait(lambda: events)
        stats = _invoke(cli, pipe.id, "getStats")
        _invoke(cli, pipe.id, "stopMedia")
    finally:
        cli.close()
    assert stats["framesProcessed"] == stats["framesSent"] == n
    assert stats["dropped"] == stats["outDropped"] == 0
    assert stats["colorOutput"] is True and stats["pending"] == 0
    got = np.frombuffer(bytes(back), np.uint8).reshape(n, H, W, 3)
    # the element called directly on the same frames, port and JAX
    gray = bgr_to_gray(torch.from_numpy(bgr)).numpy()
    direct = objects.NuboFaceDetector(objects.MediaPipeline((W, H),
                                                            device="cpu"))
    res = direct.process(gray)
    want = direct.render(bgr, res).numpy()
    np.testing.assert_array_equal(got, want)
    jface = jobjects.NuboFaceDetector(jobjects.MediaPipeline((W, H)))
    jres = jface.process(gray)
    np.testing.assert_array_equal(got, np.asarray(jface.render(bgr, jres)))
    assert (got != bgr).any()
    first = next(fs for fs in res if fs)
    assert events[0]["type"] == "OnFace"
    assert events[0]["wire"] == "".join(
        f"x:{f.x},y:{f.y},width:{f.w},height:{f.h};" for f in first)
    assert events[0]["faceInfo"][0] == {
        "name": "face", "x": first[0].x, "y": first[0].y,
        "width": first[0].w, "height": first[0].h}


def test_serving_over_rpc_gray_downscale_learned():
    """listen(channels=1, downscale=1): the learned detector's frames are
    downscaled to its letterbox size at ingest; the OnFace events report
    the faces of full-resolution processing."""
    size = (640, 480)
    gray = face_clip(4, *size, seed=3)
    srv = rpc.VcaRpcServer(port=0, frame_size=size, device="cpu").start()
    cli = gen.KurentoClient("127.0.0.1", srv.port)
    try:
        pipe = cli.create_pipeline()
        det = pipe.createNuboCnnFaceDetector()
        det.activateServerEvents(1, 0)
        events = []
        det.onFace(events.append)
        port = _invoke(cli, pipe.id, "listen", port=0, channels=1,
                       downscale=1)
        with socket.create_connection(("127.0.0.1", port), timeout=60) as s:
            s.sendall(gray[0].tobytes())
            assert _wait(lambda: _invoke(cli, pipe.id,
                                         "framesProcessed") == 1)
        stats = _invoke(cli, pipe.id, "getStats")
        _invoke(cli, pipe.id, "stopMedia")
    finally:
        cli.close()
        srv.stop()
    assert stats["downscale"] == [320, 240] and stats["dropped"] == 0
    direct = objects.NuboCnnFaceDetector(objects.MediaPipeline(
        size, device="cpu"))
    faces = direct.process(gray[:1])[0]
    assert faces
    assert [(i["x"], i["y"], i["width"], i["height"])
            for i in events[0]["faceInfo"]] == [f.rect() for f in faces]
