"""Checkpoint / resume — the PyTorch port of
``nubomedia_vca_tpu/utils/checkpoint.py``. The reference has none ("a
restart loses track identity only"); the framework adds two durable
things:

  * learned-detector training state: a ``step_{n}/state.pt`` directory per
    save and ``latest.json`` naming the newest, as the JAX package lays
    out its orbax checkpoints. The payload is a torch state dict (the
    model's parameters, ``optimizer.state_dict()`` and the scheduler's
    state) written with ``torch.save`` and read with ``weights_only=True``:
    tensors and plain values only, no pickled code;
  * per-stream runtime snapshots (face track ids, part-detector temporal
    merges, tracker MHI and previous frame) so a restarted server resumes
    streams without losing track identity. A snapshot is a pickle of plain
    Python values and numpy arrays in the JAX package's layout, so either
    package resumes from the other's snapshot. Load only snapshots this
    system wrote: unpickling runs whatever the file asks for.
"""

from __future__ import annotations

import json
import os
import pickle

import numpy as np
import torch


# ------------------------------------------------------------- training state
def _step_file(path: str, step: int) -> str:
    return os.path.join(os.path.abspath(path), f"step_{step}", "state.pt")


def save_train_state(path: str, model: torch.nn.Module, optimizer, scheduler,
                     step: int) -> None:
    """Write the parameters, the optimizer's moments and count, and the
    lr schedule's position under ``path/step_{step}/``, then point
    ``latest.json`` at it."""
    f = _step_file(path, step)
    os.makedirs(os.path.dirname(f), exist_ok=True)
    torch.save({"params": model.state_dict(),
                "optimizer": optimizer.state_dict(),
                "scheduler": scheduler.state_dict()}, f)
    with open(os.path.join(path, "latest.json"), "w") as fh:
        json.dump({"step": step}, fh)


def load_train_state(path: str, model: torch.nn.Module, optimizer,
                     scheduler) -> int:
    """Restore the newest saved state into `model`, `optimizer` and
    `scheduler` (built as they were when it was saved, on any device) →
    its step."""
    with open(os.path.join(path, "latest.json")) as fh:
        step = json.load(fh)["step"]
    # on the host: load_state_dict moves the moments to each parameter's
    # device and leaves AdamW's step counts where a fresh optimizer keeps
    # them
    state = torch.load(_step_file(path, step), map_location="cpu",
                       weights_only=True)
    model.load_state_dict(state["params"])
    optimizer.load_state_dict(state["optimizer"])
    scheduler.load_state_dict(state["scheduler"])
    return step


# ------------------------------------------------------------- runtime state
def snapshot_detector(model) -> dict:
    """Extract the resumable state of any filter model."""
    state: dict = {"type": type(model).__name__}
    if hasattr(model, "tracks"):          # FaceDetector, CnnFaceDetector
        state["tracks"] = [
            {"faces": [(f.x, f.y, f.w, f.h, f.id) for f in t.faces],
             "next_id": t.next_id, "empty_frames": t.empty_frames}
            for t in model.tracks
        ]
        state["gop_counter"] = model.gop.counter
        state["gate_budget"] = model.gate.budget
    if hasattr(model, "_streams"):        # part detectors (per-stream)
        state["streams"] = {
            int(sid): {
                "prev": {k: list(v) for k, v in st.prev.items()},
                "empty_count": dict(st.empty_count),
                "gop_counter": st.gop.counter,
                "gate_budget": st.gate.budget,
            }
            for sid, st in model._streams.items()
        }
        # stream-0 aliases keep old snapshots readable by old code; read
        # stream 0 explicitly (model._prev/gop/gate proxy the ACTIVE
        # stream, which need not be stream 0)
        st0 = model._streams.get(0)
        if st0 is not None:
            state["prev"] = {k: list(v) for k, v in st0.prev.items()}
            state["gop_counter"] = st0.gop.counter
            state["gate_budget"] = st0.gate.budget
    if hasattr(model, "_states") and hasattr(model, "_frame_idx"):  # Tracker
        state["tracker_streams"] = {
            int(sid): {
                "mhi": ts.mhi.cpu().numpy(),
                "prev_gray": ts.prev_gray.cpu().numpy(),
                "initialized": bool(ts.initialized),
                "frame_idx": model._frame_idx.get(sid, 0),
            }
            for sid, ts in model._states.items()
        }
        st0 = state["tracker_streams"].get(0)
        if st0 is not None:   # stream-0 aliases (back-compat)
            state["mhi"] = st0["mhi"]
            state["prev_gray"] = st0["prev_gray"]
            state["initialized"] = st0["initialized"]
            state["frame_idx"] = st0["frame_idx"]
    return state


def _tracker_state(snap: dict, device):
    from ..models.tracker import TrackerState
    return TrackerState.from_numpy(np.asarray(snap["prev_gray"]),
                                   np.asarray(snap["mhi"]),
                                   snap["initialized"], device=device)


def restore_detector(model, state: dict) -> None:
    """Put a snapshot's state back into `model`; tracker tensors go onto
    the model's device."""
    if "tracks" in state:
        from ..models.face import TrackedFace
        for t, ts in zip(model.tracks, state["tracks"]):
            t.faces = [TrackedFace(*f) for f in ts["faces"]]
            t.next_id = ts["next_id"]
            t.empty_frames = ts["empty_frames"]
        model.gop.counter = state.get("gop_counter", 0)
        model.gate.budget = state.get("gate_budget", 0)
    if "streams" in state:                # per-stream part state
        for sid, snap in state["streams"].items():
            st = model._stream_state(int(sid))
            st.prev = {k: [tuple(r) for r in v]
                       for k, v in snap["prev"].items()}
            st.empty_count = dict(snap.get("empty_count", {}))
            st.gop.counter = snap.get("gop_counter", 0)
            st.gate.budget = snap.get("gate_budget", 0)
    elif "prev" in state:                 # old single-stream snapshot
        model._active.prev = {k: [tuple(r) for r in v]
                              for k, v in state["prev"].items()}
        model.gop.counter = state.get("gop_counter", 0)
        model.gate.budget = state.get("gate_budget", 0)
    if "tracker_streams" in state:
        for sid, snap in state["tracker_streams"].items():
            model._states[int(sid)] = _tracker_state(snap, model.device)
            model._frame_idx[int(sid)] = snap["frame_idx"]
    elif "mhi" in state:                  # old single-stream snapshot
        model.state = _tracker_state(state, model.device)
        model.frame_idx = state["frame_idx"]


def save_runtime(path: str, models: dict) -> None:
    with open(path, "wb") as f:
        pickle.dump({name: snapshot_detector(m) for name, m in models.items()},
                    f)


def load_runtime(path: str, models: dict) -> None:
    with open(path, "rb") as f:
        snaps = pickle.load(f)
    for name, model in models.items():
        if name in snaps:
            restore_detector(model, snaps[name])
