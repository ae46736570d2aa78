"""Config/flag system (SURVEY.md §5): the reference's three config tiers —
kmd.json method params → Impl setters → GObject properties with declared
ranges/defaults (g_param_spec_int, kmsfacedetect.cpp:1043-1102) — map here
to one declarative knob registry with the same names, ranges and defaults,
shared by the api/ layer and the config-file loader.

A copy of ``nubomedia_vca_tpu/utils/config.py``."""

from __future__ import annotations

import dataclasses
import json


@dataclasses.dataclass(frozen=True)
class Knob:
    name: str            # GObject property name (kebab-case)
    attr: str            # config dataclass attribute
    lo: int
    hi: int
    default: int


# ranges/defaults from the reference's g_param_spec declarations
COMMON_KNOBS = [
    Knob("view", "view", 0, 1, 1),
    Knob("detect-event", "detect_event", 0, 1, 0),
    Knob("send-meta-data", "send_meta_data", 0, 1, 0),
    Knob("width-to-process", "width_to_process", 160, 640, 160),
    Knob("process-x-every-4-frames", "process_x_every_4_frames", 0, 4, 4),
    Knob("multi-scale-factor", "multi_scale_factor", 5, 51, 25),
    Knob("activate-events", "activate_events", 0, 1, 0),
    Knob("events-ms", "events_ms", 0, (1 << 31) - 1, 30001),
]

FACE_KNOBS = COMMON_KNOBS + [
    Knob("euclidean-distance", "euclidean_distance", 0, 100, 8),
    Knob("track-threshold", "track_threshold", 0, 1000, 40),
    Knob("area-threshold", "area_threshold", 0, 10000, 500),
]

TRACKER_KNOBS = [
    Knob("threshold", "threshold", 0, 255, 20),
    Knob("min-area", "min_area", 0, 10000, 50),
    Knob("max-area", "max_area", 0, 300000, 30000),
    Knob("distance", "distance", 0, 2000, 35),
    Knob("visual-mode", "visual_mode", 0, 1, 0),
    Knob("activate-events", "activate_events", 0, 1, 0),
    Knob("events-ms", "events_ms", 0, (1 << 31) - 1, 30001),
]


def clamp(knob: Knob, value: int) -> int:
    return max(knob.lo, min(knob.hi, int(value)))


def apply_knobs(config, knobs: list[Knob], values: dict) -> None:
    """Apply {property-name: value} to a config dataclass with clamping."""
    by_name = {k.name: k for k in knobs}
    for name, v in values.items():
        k = by_name.get(name)
        if k is None:
            raise KeyError(f"unknown property {name!r}")
        setattr(config, k.attr, clamp(k, v))


def load_config_file(config, knobs: list[Knob], path: str) -> None:
    with open(path) as f:
        apply_knobs(config, knobs, json.load(f))
