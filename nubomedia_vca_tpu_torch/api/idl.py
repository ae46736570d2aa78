"""IDL descriptors — the kmd.json layer (L3) equivalent.

The reference declares each remote class in a *.kmd.json interface file from
which kurento-module-creator generates server stubs and Java/JS clients
(SURVEY.md §2.2; src/server/CMakeLists.txt:3-8). Here the api/ classes are
the source of truth and this module *emits* the descriptors — same shape:
remoteClasses (name/constructor/methods), events (On*), complexTypes
(*Info{name,x,y,width,height}) — so external tooling/clients can still
introspect the surface.

    python -m nubomedia_vca_tpu_torch.api.idl [outdir]

A copy of ``nubomedia_vca_tpu/api/idl.py`` over the port's
``api/objects.py``, whose public surface is the JAX package's, so the
descriptors it writes are byte-identical to that package's.
"""

from __future__ import annotations

import inspect
import json
import os
import sys

from . import objects as obj_mod

MODULES = {
    "nubofacedetector": ("NuboFaceDetector", "OnFace", "FaceInfo"),
    "nuboeyedetector": ("NuboEyeDetector", "OnEye", "EyeInfo"),
    "nubomouthdetector": ("NuboMouthDetector", "OnMouth", "MouthInfo"),
    "nubonosedetector": ("NuboNoseDetector", "OnNose", "NoseInfo"),
    "nuboeardetector": ("NuboEarDetector", "OnEar", "EarInfo"),
    "nubotracker": ("NuboTracker", "OnTracker", "TrackerInfo"),
    # extension beyond the reference: the learned detector module
    "nubocnnfacedetector": ("NuboCnnFaceDetector", "OnFace", "FaceInfo"),
    "nubocnnpartdetector": ("NuboCnnPartDetector", "OnPart", "PartInfo"),
}

_EXCLUDE = {"process", "render", "addEventListener"}


def _kmd_type(annotation) -> str:
    """Python annotation → kmd.json type name. Annotations arrive as
    strings (objects.py uses `from __future__ import annotations`)."""
    if annotation in (float, "float"):
        return "float"
    if annotation in (str, "str"):
        return "String"
    if annotation in (bool, "bool"):
        return "boolean"
    return "int"


def describe(cls_name: str, event: str, info: str) -> dict:
    cls = getattr(obj_mod, cls_name)
    methods = []
    for name, fn in inspect.getmembers(cls, inspect.isfunction):
        if name.startswith("_") or name in _EXCLUDE:
            continue
        params = [
            {"name": p, "type": _kmd_type(a)}
            for p, a in (
                (pn, pp.annotation)
                for pn, pp in inspect.signature(fn).parameters.items()
                if pn not in ("self",))
        ]
        methods.append({"name": name, "params": params})
    return {
        "remoteClasses": [{
            "name": cls_name,
            "extends": "Filter",
            "constructor": {"params": [{
                "name": "mediaPipeline", "type": "MediaPipeline"}]},
            "methods": methods,
            "events": [event],
        }],
        "events": [{
            "name": event,
            "extends": "Media",
            "properties": [{"name": f"{info[0].lower()}{info[1:]}",
                            "type": f"{info}[]"}],
        }],
        "complexTypes": [{
            "name": info,
            "typeFormat": "REGISTER",
            "properties": [
                {"name": "name", "type": "String"},
                {"name": "x", "type": "int"},
                {"name": "y", "type": "int"},
                {"name": "width", "type": "int"},
                {"name": "height", "type": "int"},
            ],
        }],
    }


def emit_all(outdir: str) -> list[str]:
    os.makedirs(outdir, exist_ok=True)
    written = []
    for module, (cls_name, event, info) in MODULES.items():
        path = os.path.join(outdir, f"{module}.{cls_name}.kmd.json")
        with open(path, "w") as f:
            json.dump(describe(cls_name, event, info), f, indent=2)
        written.append(path)
    return written


if __name__ == "__main__":
    out = sys.argv[1] if len(sys.argv) > 1 else "idl"
    for p in emit_all(out):
        print(p)
