"""JSON-RPC server — the Kurento-protocol-shaped control plane.

The reference exposes its filters as Kurento remote objects over JSON-RPC /
WebSocket (SURVEY.md §3.5: app → JSON-RPC → generated invoke() dispatch →
g_object_set). This module implements the same protocol shape with no
external dependencies: a minimal RFC 6455 WebSocket server (stdlib sockets)
carrying JSON-RPC 2.0 with the Kurento verbs:

    create      {type: "NuboFaceDetector", constructorParams: {...}}
    invoke      {object: id, operation: "multiScaleFactor",
                 operationParams: {...}}
    subscribe   {object: id, type: "OnFace"}
    unsubscribe / release / ping

Events are pushed as JSON-RPC notifications {method: "onEvent", params:...}
to the subscribed connection — the same flow as the reference's
g_signal_emit → Impl::onFace → Kurento event (NuboFaceDetectorImpl.cpp:
55-129).

The PyTorch port of ``nubomedia_vca_tpu/api/rpc.py``: the same protocol,
verbs and creatable types. The server holds the device its pipelines run
on, the card unless the caller asks for another (a CUDA request on a host
without CUDA raises when the server is built).
"""

from __future__ import annotations

import base64
import dataclasses
import hashlib
import json
import socket
import struct
import threading
import uuid

import torch

from ..cascade.engine import _resolve_device
from . import objects as obj_mod
from .objects import MediaPipeline

_WS_MAGIC = "258EAFA5-E914-47DA-95CA-C5AB0DC85B11"

CREATABLE = {
    "MediaPipeline": MediaPipeline,
    "NuboFaceDetector": obj_mod.NuboFaceDetector,
    "NuboEyeDetector": obj_mod.NuboEyeDetector,
    "NuboMouthDetector": obj_mod.NuboMouthDetector,
    "NuboNoseDetector": obj_mod.NuboNoseDetector,
    "NuboEarDetector": obj_mod.NuboEarDetector,
    "NuboTracker": obj_mod.NuboTracker,
    "NuboCnnFaceDetector": obj_mod.NuboCnnFaceDetector,
    "NuboCnnPartDetector": obj_mod.NuboCnnPartDetector,
}


# ---------------------------------------------------------------- websocket
def _ws_handshake(conn: socket.socket) -> bool:
    data = b""
    while b"\r\n\r\n" not in data:
        chunk = conn.recv(4096)
        if not chunk:
            return False
        data += chunk
    headers = {}
    for line in data.decode("latin1").split("\r\n")[1:]:
        k, _, v = line.partition(":")
        if v:
            headers[k.strip().lower()] = v.strip()
    key = headers.get("sec-websocket-key")
    if not key:
        return False
    accept = base64.b64encode(
        hashlib.sha1((key + _WS_MAGIC).encode()).digest()).decode()
    conn.sendall(
        ("HTTP/1.1 101 Switching Protocols\r\n"
         "Upgrade: websocket\r\nConnection: Upgrade\r\n"
         f"Sec-WebSocket-Accept: {accept}\r\n\r\n").encode())
    return True


def _ws_recv(conn: socket.socket) -> str | None:
    def read_exact(n):
        buf = b""
        while len(buf) < n:
            chunk = conn.recv(n - len(buf))
            if not chunk:
                return None
            buf += chunk
        return buf

    hdr = read_exact(2)
    if hdr is None:
        return None
    fin_op, mask_len = hdr
    opcode = fin_op & 0x0F
    masked = mask_len & 0x80
    length = mask_len & 0x7F
    if length == 126:
        length = struct.unpack(">H", read_exact(2))[0]
    elif length == 127:
        length = struct.unpack(">Q", read_exact(8))[0]
    mask = read_exact(4) if masked else b"\0\0\0\0"
    payload = read_exact(length) if length else b""
    if payload is None:
        return None
    data = bytes(b ^ mask[i % 4] for i, b in enumerate(payload))
    if opcode == 0x8:    # close
        return None
    if opcode in (0x1, 0x2):
        return data.decode("utf-8", "replace")
    return ""            # ping/pong/continuation: ignore payload


def _ws_send(conn: socket.socket, text: str) -> None:
    payload = text.encode()
    n = len(payload)
    if n < 126:
        hdr = struct.pack(">BB", 0x81, n)
    elif n < 65536:
        hdr = struct.pack(">BBH", 0x81, 126, n)
    else:
        hdr = struct.pack(">BBQ", 0x81, 127, n)
    conn.sendall(hdr + payload)


# ----------------------------------------------------------------- the server
class VcaRpcServer:
    """Kurento-shaped JSON-RPC WebSocket server over the port's filters."""

    def __init__(self, host="127.0.0.1", port=8888,
                 frame_size=(640, 480),
                 device: str | torch.device = "cuda"):
        self.host, self.port = host, port
        self.frame_size = frame_size
        self.device = _resolve_device(device)
        self.objects: dict[str, object] = {}
        self.subscriptions: dict[str, list] = {}
        self._sock = None
        self._threads = []
        self._running = False

    # -- object registry ---------------------------------------------------
    def _create(self, type_name: str, ctor: dict):
        cls = CREATABLE.get(type_name)
        if cls is None:
            raise ValueError(f"unknown type {type_name}")
        if type_name == "MediaPipeline":
            inst = cls(self.frame_size, device=self.device)
        else:
            pipe_id = ctor.get("mediaPipeline")
            pipe = self.objects.get(pipe_id)
            if not isinstance(pipe, MediaPipeline):
                raise ValueError("constructorParams.mediaPipeline required")
            inst = cls(pipe)
        oid = f"{type_name}_{uuid.uuid4().hex[:12]}"
        self.objects[oid] = inst
        return oid

    def handle_request(self, req: dict, push) -> dict:
        """One JSON-RPC request → response dict. `push(msg)` sends a
        server-initiated notification on the same connection."""
        rid = req.get("id")
        method = req.get("method")
        params = req.get("params", {}) or {}

        def ok(value):
            return {"jsonrpc": "2.0", "id": rid, "result": value}

        def err(msg, code=-32000):
            return {"jsonrpc": "2.0", "id": rid,
                    "error": {"code": code, "message": msg}}

        try:
            if method == "ping":
                return ok({"value": "pong"})
            if method == "create":
                oid = self._create(params.get("type"),
                                   params.get("constructorParams", {}) or {})
                return ok({"value": oid, "sessionId": params.get("sessionId")})
            if method == "invoke":
                target = self.objects.get(params.get("object"))
                if target is None:
                    return err("object not found", -32001)
                op = params.get("operation")
                fn = getattr(target, op, None)
                if fn is None or op.startswith("_"):
                    return err(f"unknown operation {op}", -32601)
                kwargs = params.get("operationParams", {}) or {}
                value = fn(**kwargs)
                return ok({"value": _jsonable(value)})
            if method == "subscribe":
                oid = params.get("object")
                target = self.objects.get(oid)
                ev = params.get("type")
                if target is None:
                    return err("object not found", -32001)
                sub_id = uuid.uuid4().hex[:12]

                def cb(payload, _oid=oid, _ev=ev):
                    push({"jsonrpc": "2.0", "method": "onEvent", "params": {
                        "value": {"object": _oid, "type": _ev,
                                  "data": _jsonable(payload)}}})

                target.addEventListener(ev, cb)
                self.subscriptions[sub_id] = [oid, ev]
                return ok({"value": sub_id})
            if method == "unsubscribe":
                self.subscriptions.pop(params.get("subscription"), None)
                return ok({"value": None})
            if method == "release":
                self.objects.pop(params.get("object"), None)
                return ok({"value": None})
            return err(f"unknown method {method}", -32601)
        except Exception as e:  # noqa: BLE001 — protocol boundary
            return err(str(e))

    # -- socket plumbing ---------------------------------------------------
    def serve_forever(self):
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((self.host, self.port))
        self.port = self._sock.getsockname()[1]
        self._sock.listen(8)
        self._running = True
        while self._running:
            try:
                conn, _ = self._sock.accept()
            except OSError:
                break
            t = threading.Thread(target=self._client, args=(conn,),
                                 daemon=True)
            t.start()
            self._threads.append(t)

    def start(self):
        t = threading.Thread(target=self.serve_forever, daemon=True)
        t.start()
        import time
        while not self._running:
            time.sleep(0.01)
        return self

    def stop(self):
        self._running = False
        if self._sock:
            try:
                self._sock.close()
            except OSError:
                pass

    def _client(self, conn: socket.socket):
        with conn:
            if not _ws_handshake(conn):
                return
            lock = threading.Lock()

            def push(msg):
                with lock:
                    try:
                        _ws_send(conn, json.dumps(msg))
                    except OSError:
                        pass

            while True:
                text = _ws_recv(conn)
                if text is None:
                    return
                if not text:
                    continue
                try:
                    req = json.loads(text)
                except json.JSONDecodeError:
                    continue
                resp = self.handle_request(req, push)
                push(resp)


def _jsonable(v):
    if dataclasses.is_dataclass(v) and not isinstance(v, type):
        return dataclasses.asdict(v)
    if isinstance(v, dict):
        return {k: _jsonable(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    if hasattr(v, "tolist"):
        return v.tolist()
    if hasattr(v, "rect"):
        return {"x": v.x, "y": v.y, "width": v.w, "height": v.h, "id": v.id}
    if v is None or isinstance(v, (str, int, float, bool)):
        return v
    return str(v)
