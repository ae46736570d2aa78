"""Client-library generation from the kmd.json IDL — the
kurento-module-creator analog (reference: each module's
``src/server/CMakeLists.txt:3-8`` runs the module-creator over the
*.kmd.json to generate Java/JS client libraries).

Here the emitted kmd.json descriptors (api/idl.py) are the codegen input,
and two self-contained client libraries are generated:

  * Python  — stdlib-only WebSocket JSON-RPC client: a ``KurentoClient``
    transport plus one class per remote class with the IDL's exact method
    names, and ``On*`` event subscription callbacks.
  * JavaScript — the same surface for node/browser ``WebSocket``.
  * Java — a Maven client project (the module-creator's
    GENERATE_JAVA_CLIENT_PROJECT=TRUE analog, compile_filter.sh): one
    typed class per remote class over JDK11 java.net.http.WebSocket.

    python -m nubomedia_vca_tpu_torch.api.client_gen [idl_dir] [out_dir]

A copy of ``nubomedia_vca_tpu/api/client_gen.py``. The "Generated by
nubomedia_vca_tpu.api.client_gen" headers inside the templates are output,
kept as they are, so the generated clients are byte-identical to the
checked-in ``clients/`` whichever package generates them.
"""

from __future__ import annotations

import json
import os
import sys


def load_idl(idl_dir: str) -> list[dict]:
    descs = []
    for name in sorted(os.listdir(idl_dir)):
        if name.endswith(".kmd.json"):
            with open(os.path.join(idl_dir, name)) as f:
                descs.append(json.load(f))
    if not descs:
        raise FileNotFoundError(f"no *.kmd.json in {idl_dir}")
    return descs


_PY_RUNTIME = '''"""Auto-generated Kurento-style client library.
Generated by nubomedia_vca_tpu.api.client_gen from the kmd.json IDL —
do not edit. Stdlib-only (socket-level RFC6455 WebSocket + JSON-RPC 2.0).
"""

import base64
import json
import os
import socket
import struct
import threading


class _Ws:
    """Minimal client-side WebSocket (text frames, client-masked)."""

    def __init__(self, host, port, timeout=10.0):
        self.sock = socket.create_connection((host, port), timeout=timeout)
        key = base64.b64encode(os.urandom(16)).decode()
        self.sock.sendall((
            f"GET / HTTP/1.1\\r\\nHost: {host}\\r\\nUpgrade: websocket\\r\\n"
            f"Connection: Upgrade\\r\\nSec-WebSocket-Key: {key}\\r\\n"
            "Sec-WebSocket-Version: 13\\r\\n\\r\\n").encode())
        buf = b""
        while b"\\r\\n\\r\\n" not in buf:
            buf += self.sock.recv(4096)
        # timeout applies to connect/handshake only; the reader thread
        # must block indefinitely between server messages
        self.sock.settimeout(None)
        self._buf = bytearray()
        self._wlock = threading.Lock()

    def send(self, obj):
        p = json.dumps(obj).encode()
        mask = os.urandom(4)
        body = bytes(b ^ mask[i % 4] for i, b in enumerate(p))
        n = len(p)
        if n < 126:
            hdr = struct.pack(">BB", 0x81, 0x80 | n)
        elif n < 65536:
            hdr = struct.pack(">BBH", 0x81, 0x80 | 126, n)
        else:
            hdr = struct.pack(">BBQ", 0x81, 0x80 | 127, n)
        with self._wlock:
            self.sock.sendall(hdr + mask + body)

    def _need(self, n):
        while len(self._buf) < n:
            chunk = self.sock.recv(4096)
            if not chunk:
                raise ConnectionError("websocket closed")
            self._buf.extend(chunk)
        out = bytes(self._buf[:n])
        del self._buf[:n]
        return out

    def recv(self):
        while True:
            b1, b2 = self._need(2)
            ln = b2 & 0x7F
            if ln == 126:
                ln = struct.unpack(">H", self._need(2))[0]
            elif ln == 127:
                ln = struct.unpack(">Q", self._need(8))[0]
            data = self._need(ln) if ln else b""
            op = b1 & 0x0F
            if op == 0x8:
                raise ConnectionError("websocket closed")
            if op in (0x1, 0x2):
                return json.loads(data.decode())

    def close(self):
        try:
            self.sock.close()
        except OSError:
            pass


class KurentoClient:
    """JSON-RPC transport with Kurento verbs (create/invoke/subscribe)."""

    def __init__(self, host="127.0.0.1", port=8888, timeout=10.0):
        self._ws = _Ws(host, port, timeout)
        self._next_id = 0
        self._lock = threading.Lock()
        self._listeners = {}            # (object_id, event) -> [callbacks]
        self._pending = {}
        self._cv = threading.Condition()
        self._rx = threading.Thread(target=self._reader, daemon=True)
        self._rx.start()

    def _reader(self):
        while True:
            try:
                msg = self._ws.recv()
            except (ConnectionError, OSError):
                return
            if msg.get("method") == "onEvent":
                v = msg.get("params", {}).get("value", {})
                for cb in self._listeners.get(
                        (v.get("object"), v.get("type")), []):
                    cb(v.get("data"))
                continue
            with self._cv:
                self._pending[msg.get("id")] = msg
                self._cv.notify_all()

    def call(self, method, params, timeout=10.0):
        with self._lock:
            self._next_id += 1
            rid = self._next_id
        self._ws.send({"jsonrpc": "2.0", "id": rid, "method": method,
                       "params": params})
        with self._cv:
            ok = self._cv.wait_for(lambda: rid in self._pending, timeout)
            if not ok:
                raise TimeoutError(f"no response for {method}")
            msg = self._pending.pop(rid)
        if "error" in msg:
            raise RuntimeError(msg["error"].get("message"))
        return msg.get("result")

    # Kurento verbs ---------------------------------------------------------
    def create_pipeline(self):
        oid = self.call("create", {"type": "MediaPipeline"})["value"]
        return MediaPipeline(self, oid)

    def _create(self, type_name, pipeline_id):
        oid = self.call("create", {
            "type": type_name,
            "constructorParams": {"mediaPipeline": pipeline_id}})["value"]
        return oid

    def _subscribe(self, object_id, event, callback):
        self._listeners.setdefault((object_id, event), []).append(callback)
        return self.call("subscribe",
                         {"object": object_id, "type": event})["value"]

    def release(self, object_id):
        self.call("release", {"object": object_id})

    def close(self):
        self._ws.close()


class _RemoteObject:
    TYPE = None
    EVENTS = ()

    def __init__(self, client, object_id):
        self.client = client
        self.id = object_id

    def _invoke(self, operation, params):
        return self.client.call("invoke", {
            "object": self.id, "operation": operation,
            "operationParams": params}).get("value")

    def release(self):
        self.client.release(self.id)


class MediaPipeline(_RemoteObject):
    TYPE = "MediaPipeline"
'''

_PY_FACTORY = """
    def create{cls}(self):
        return {cls}(self.client, self.client._create("{cls}", self.id))
"""

_PY_CLASS = '''

class {cls}(_RemoteObject):
    TYPE = "{cls}"
    EVENTS = ({events},)
{methods}
'''

_PY_METHOD = """    def {name}(self{args}):
        return self._invoke("{name}", {{{params}}})
"""

_PY_SUB = """    def on{short}(self, callback):
        \"\"\"Subscribe to {event} notifications.\"\"\"
        return self.client._subscribe(self.id, "{event}", callback)
"""


def generate_python(descs: list[dict]) -> str:
    out = [_PY_RUNTIME]
    factories = []
    classes = []
    for d in descs:
        for rc in d.get("remoteClasses", []):
            cls = rc["name"]
            factories.append(_PY_FACTORY.format(cls=cls))
            methods = []
            for m in rc.get("methods", []):
                names = [p["name"] for p in m.get("params", [])]
                args = "".join(f", {n}" for n in names)
                params = ", ".join(f'"{n}": {n}' for n in names)
                methods.append(_PY_METHOD.format(
                    name=m["name"], args=args, params=params))
            for ev in rc.get("events", []):
                short = ev[2:] if ev.startswith("On") else ev
                methods.append(_PY_SUB.format(short=short, event=ev))
            classes.append(_PY_CLASS.format(
                cls=cls,
                events=", ".join(f'"{e}"' for e in rc.get("events", [])),
                methods="".join(methods) or "    pass\n"))
    return "".join(out + factories + classes)


_JS_RUNTIME = """// Auto-generated Kurento-style client library (JSON-RPC over WebSocket).
// Generated by nubomedia_vca_tpu.api.client_gen from the kmd.json IDL.
'use strict';

class KurentoClient {
  constructor(url, WebSocketImpl) {
    const WS = WebSocketImpl || (typeof WebSocket !== 'undefined' ? WebSocket
        : require('ws'));
    this.ws = new WS(url);
    this.nextId = 0;
    this.pending = new Map();
    this.listeners = new Map();
    this.ready = new Promise((res, rej) => {
      this.ws.onopen = res;
      this.ws.onerror = rej;
    });
    this.ws.onmessage = (ev) => {
      const msg = JSON.parse(ev.data);
      if (msg.method === 'onEvent') {
        const v = msg.params.value;
        const cbs = this.listeners.get(v.object + '/' + v.type) || [];
        for (const cb of cbs) cb(v.data);
        return;
      }
      const p = this.pending.get(msg.id);
      if (p) {
        this.pending.delete(msg.id);
        if (msg.error) p.reject(new Error(msg.error.message));
        else p.resolve(msg.result);
      }
    };
  }

  call(method, params) {
    const id = ++this.nextId;
    return new Promise((resolve, reject) => {
      this.pending.set(id, {resolve, reject});
      this.ws.send(JSON.stringify({jsonrpc: '2.0', id, method, params}));
    });
  }

  async createPipeline() {
    const r = await this.call('create', {type: 'MediaPipeline'});
    return new MediaPipeline(this, r.value);
  }

  async _create(type, pipelineId) {
    const r = await this.call('create', {
      type, constructorParams: {mediaPipeline: pipelineId}});
    return r.value;
  }

  async _subscribe(objectId, event, callback) {
    const key = objectId + '/' + event;
    if (!this.listeners.has(key)) this.listeners.set(key, []);
    this.listeners.get(key).push(callback);
    const r = await this.call('subscribe', {object: objectId, type: event});
    return r.value;
  }

  release(objectId) { return this.call('release', {object: objectId}); }
  close() { this.ws.close(); }
}

class RemoteObject {
  constructor(client, id) { this.client = client; this.id = id; }
  async _invoke(operation, operationParams) {
    const r = await this.client.call('invoke',
        {object: this.id, operation, operationParams});
    return r.value;
  }
  release() { return this.client.release(this.id); }
}

class MediaPipeline extends RemoteObject {
"""

_JS_FACTORY = """  async create{cls}() {{
    return new {cls}(this.client,
        await this.client._create('{cls}', this.id));
  }}
"""

_JS_CLASS = """
class {cls} extends RemoteObject {{
{methods}}}
"""

_JS_METHOD = """  {name}({args}) {{
    return this._invoke('{name}', {{{params}}});
  }}
"""

_JS_SUB = """  on{short}(callback) {{
    return this.client._subscribe(this.id, '{event}', callback);
  }}
"""


def generate_js(descs: list[dict]) -> str:
    out = [_JS_RUNTIME]
    classes = []
    names = []
    for d in descs:
        for rc in d.get("remoteClasses", []):
            cls = rc["name"]
            names.append(cls)
            out.append(_JS_FACTORY.format(cls=cls))
            methods = []
            for m in rc.get("methods", []):
                pnames = [p["name"] for p in m.get("params", [])]
                methods.append(_JS_METHOD.format(
                    name=m["name"], args=", ".join(pnames),
                    params=", ".join(pnames)))
            for ev in rc.get("events", []):
                short = ev[2:] if ev.startswith("On") else ev
                methods.append(_JS_SUB.format(short=short, event=ev))
            classes.append(_JS_CLASS.format(cls=cls,
                                            methods="".join(methods)))
    out.append("}\n")
    out.extend(classes)
    exports = ", ".join(["KurentoClient", "MediaPipeline"] + names)
    out.append("\nif (typeof module !== 'undefined') "
               f"module.exports = {{{exports}}};\n")
    return "".join(out)


_JAVA_POM = """<?xml version="1.0" encoding="UTF-8"?>
<project xmlns="http://maven.apache.org/POM/4.0.0">
  <modelVersion>4.0.0</modelVersion>
  <groupId>org.nubomedia.vca</groupId>
  <artifactId>nubomedia-vca-client</artifactId>
  <version>1.0.0</version>
  <packaging>jar</packaging>
  <properties>
    <maven.compiler.source>11</maven.compiler.source>
    <maven.compiler.target>11</maven.compiler.target>
    <project.build.sourceEncoding>UTF-8</project.build.sourceEncoding>
  </properties>
  <dependencies>
    <dependency>
      <groupId>com.google.code.gson</groupId>
      <artifactId>gson</artifactId>
      <version>2.10.1</version>
    </dependency>
  </dependencies>
</project>
"""

_JAVA_RUNTIME = """// Auto-generated Kurento-style Java client library.
// Generated by nubomedia_vca_tpu.api.client_gen from the kmd.json IDL —
// do not edit. JSON-RPC 2.0 over JDK11 java.net.http.WebSocket.
package org.nubomedia.vca.client;

import com.google.gson.Gson;
import com.google.gson.JsonElement;
import com.google.gson.JsonObject;
import com.google.gson.JsonParser;

import java.net.URI;
import java.net.http.HttpClient;
import java.net.http.WebSocket;
import java.util.List;
import java.util.Map;
import java.util.concurrent.CompletableFuture;
import java.util.concurrent.ConcurrentHashMap;
import java.util.concurrent.CopyOnWriteArrayList;
import java.util.concurrent.CompletionStage;
import java.util.concurrent.atomic.AtomicLong;
import java.util.function.Consumer;

public class NuboVcaClient {
  private final WebSocket ws;
  private final Gson gson = new Gson();
  private final AtomicLong nextId = new AtomicLong();
  private final Map<Long, CompletableFuture<JsonObject>> pending =
      new ConcurrentHashMap<>();
  private final Map<String, List<Consumer<JsonElement>>> listeners =
      new ConcurrentHashMap<>();

  public NuboVcaClient(String url) {
    this.ws = HttpClient.newHttpClient().newWebSocketBuilder()
        .buildAsync(URI.create(url), new WebSocket.Listener() {
          private final StringBuilder buf = new StringBuilder();

          @Override
          public CompletionStage<?> onText(WebSocket w, CharSequence data,
                                           boolean last) {
            buf.append(data);
            if (last) {
              handle(buf.toString());
              buf.setLength(0);
            }
            w.request(1);
            return null;
          }
        }).join();
  }

  private void handle(String text) {
    JsonObject msg = JsonParser.parseString(text).getAsJsonObject();
    if (msg.has("method")
        && msg.get("method").getAsString().equals("onEvent")) {
      JsonObject v = msg.getAsJsonObject("params").getAsJsonObject("value");
      String key = v.get("object").getAsString() + "/"
          + v.get("type").getAsString();
      List<Consumer<JsonElement>> cbs = listeners.get(key);
      if (cbs != null) {
        for (Consumer<JsonElement> cb : cbs) cb.accept(v.get("data"));
      }
      return;
    }
    CompletableFuture<JsonObject> f = pending.remove(msg.get("id").getAsLong());
    if (f != null) {
      if (msg.has("error")) {
        f.completeExceptionally(new RuntimeException(
            msg.getAsJsonObject("error").get("message").getAsString()));
      } else {
        f.complete(msg.getAsJsonObject("result"));
      }
    }
  }

  JsonObject call(String method, JsonObject params) {
    long id = nextId.incrementAndGet();
    CompletableFuture<JsonObject> f = new CompletableFuture<>();
    pending.put(id, f);
    JsonObject req = new JsonObject();
    req.addProperty("jsonrpc", "2.0");
    req.addProperty("id", id);
    req.addProperty("method", method);
    req.add("params", params);
    ws.sendText(gson.toJson(req), true);
    return f.join();
  }

  public MediaPipeline createPipeline() {
    JsonObject p = new JsonObject();
    p.addProperty("type", "MediaPipeline");
    return new MediaPipeline(this, call("create", p).get("value")
        .getAsString());
  }

  String create(String type, String pipelineId) {
    JsonObject ctor = new JsonObject();
    ctor.addProperty("mediaPipeline", pipelineId);
    JsonObject p = new JsonObject();
    p.addProperty("type", type);
    p.add("constructorParams", ctor);
    return call("create", p).get("value").getAsString();
  }

  String subscribe(String objectId, String event,
                   Consumer<JsonElement> callback) {
    listeners.computeIfAbsent(objectId + "/" + event,
        k -> new CopyOnWriteArrayList<>()).add(callback);
    JsonObject p = new JsonObject();
    p.addProperty("object", objectId);
    p.addProperty("type", event);
    return call("subscribe", p).get("value").getAsString();
  }

  public void release(String objectId) {
    JsonObject p = new JsonObject();
    p.addProperty("object", objectId);
    call("release", p);
  }

  public void close() {
    ws.sendClose(WebSocket.NORMAL_CLOSURE, "bye").join();
  }
}
"""

_JAVA_REMOTE = """package org.nubomedia.vca.client;

import com.google.gson.JsonElement;
import com.google.gson.JsonObject;

public abstract class RemoteObject {
  protected final NuboVcaClient client;
  public final String id;

  protected RemoteObject(NuboVcaClient client, String id) {
    this.client = client;
    this.id = id;
  }

  protected JsonElement invoke(String operation, JsonObject params) {
    JsonObject p = new JsonObject();
    p.addProperty("object", id);
    p.addProperty("operation", operation);
    p.add("operationParams", params);
    return client.call("invoke", p).get("value");
  }

  public void release() {
    client.release(id);
  }
}
"""

_JAVA_PIPELINE = """package org.nubomedia.vca.client;

public class MediaPipeline extends RemoteObject {{
  public MediaPipeline(NuboVcaClient client, String id) {{
    super(client, id);
  }}
{factories}}}
"""

_JAVA_FACTORY = """
  public {cls} create{cls}() {{
    return new {cls}(client, client.create("{cls}", id));
  }}
"""

_JAVA_CLASS = """package org.nubomedia.vca.client;

import com.google.gson.JsonElement;
import com.google.gson.JsonObject;
import java.util.function.Consumer;

public class {cls} extends RemoteObject {{
  public {cls}(NuboVcaClient client, String id) {{
    super(client, id);
  }}
{methods}}}
"""

_JAVA_METHOD = """
  public JsonElement {name}({sig}) {{
    JsonObject p = new JsonObject();
{adds}    return invoke("{name}", p);
  }}
"""

_JAVA_SUB = """
  public String on{short}(Consumer<JsonElement> callback) {{
    return client.subscribe(id, "{event}", callback);
  }}
"""

_JAVA_TYPES = {"int": "int", "float": "float", "boolean": "boolean",
               "String": "String"}


def generate_java(descs: list[dict], out_dir: str) -> list[str]:
    """Emit a Maven client project: pom.xml + one typed source file per
    remote class (the shape kurento-module-creator produces for
    GENERATE_JAVA_CLIENT_PROJECT=TRUE)."""
    src = os.path.join(out_dir, "src", "main", "java", "org", "nubomedia",
                       "vca", "client")
    os.makedirs(src, exist_ok=True)
    written = []

    def emit(name, text):
        path = os.path.join(src, name)
        with open(path, "w") as f:
            f.write(text)
        written.append(path)

    pom = os.path.join(out_dir, "pom.xml")
    with open(pom, "w") as f:
        f.write(_JAVA_POM)
    written.append(pom)

    emit("NuboVcaClient.java", _JAVA_RUNTIME)
    emit("RemoteObject.java", _JAVA_REMOTE)
    factories = []
    for d in descs:
        for rc in d.get("remoteClasses", []):
            cls = rc["name"]
            factories.append(_JAVA_FACTORY.format(cls=cls))
            methods = []
            for m in rc.get("methods", []):
                sig = ", ".join(
                    f"{_JAVA_TYPES.get(p.get('type', 'int'), 'String')} "
                    f"{p['name']}" for p in m.get("params", []))
                adds = "".join(
                    f'    p.addProperty("{p["name"]}", {p["name"]});\n'
                    for p in m.get("params", []))
                methods.append(_JAVA_METHOD.format(
                    name=m["name"], sig=sig, adds=adds))
            for ev in rc.get("events", []):
                short = ev[2:] if ev.startswith("On") else ev
                methods.append(_JAVA_SUB.format(short=short, event=ev))
            emit(f"{cls}.java", _JAVA_CLASS.format(
                cls=cls, methods="".join(methods)))
    emit("MediaPipeline.java",
         _JAVA_PIPELINE.format(factories="".join(factories)))
    return written


def generate(idl_dir: str, out_dir: str) -> list[str]:
    descs = load_idl(idl_dir)
    py_dir = os.path.join(out_dir, "python")
    js_dir = os.path.join(out_dir, "js")
    os.makedirs(py_dir, exist_ok=True)
    os.makedirs(js_dir, exist_ok=True)
    py_path = os.path.join(py_dir, "nubomedia_vca_client.py")
    js_path = os.path.join(js_dir, "nubomedia_vca_client.js")
    with open(py_path, "w") as f:
        f.write(generate_python(descs))
    with open(js_path, "w") as f:
        f.write(generate_js(descs))
    java_paths = generate_java(descs, os.path.join(out_dir, "java"))
    return [py_path, js_path] + java_paths


if __name__ == "__main__":
    idl_dir = sys.argv[1] if len(sys.argv) > 1 else "idl"
    out_dir = sys.argv[2] if len(sys.argv) > 2 else "clients"
    for p in generate(idl_dir, out_dir):
        print(p)
