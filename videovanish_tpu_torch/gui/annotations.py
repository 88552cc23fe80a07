"""Annotation model + JSON schema (port of
videovanish_tpu/gui/annotations.py).

Schema parity with the reference (videovanish.py:1097-1109):
  {"video": str, "fps": float, "keyframes": [
      {"frame_idx": int,
       "pos_clicks": [{"x","y","obj"}], "neg_clicks": [...],
       "rects": [{"x","y","w","h","obj"}]}]}
Coordinates are normalized [0..1]; object ids are 1-based. This module
is pure python (no Qt) so the CLI and tests share it.
"""
from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class Keyframe:
    frame_idx: int
    pos_clicks: list = field(default_factory=list)  # (x, y, obj)
    neg_clicks: list = field(default_factory=list)  # (x, y, obj)
    rects: list = field(default_factory=list)       # (x, y, w, h, obj)

    def is_empty(self) -> bool:
        return not (self.pos_clicks or self.neg_clicks or self.rects)

    def to_json_obj(self) -> dict:
        return {
            "frame_idx": int(self.frame_idx),
            "pos_clicks": [{"x": x, "y": y, "obj": o}
                           for (x, y, o) in self.pos_clicks],
            "neg_clicks": [{"x": x, "y": y, "obj": o}
                           for (x, y, o) in self.neg_clicks],
            "rects": [{"x": x, "y": y, "w": w, "h": h, "obj": o}
                      for (x, y, w, h, o) in self.rects],
        }

    @classmethod
    def from_json_obj(cls, obj: dict) -> "Keyframe":
        kf = cls(int(obj["frame_idx"]))
        for c in obj.get("pos_clicks", []):
            kf.pos_clicks.append((float(c["x"]), float(c["y"]),
                                  int(c.get("obj", 1))))
        for c in obj.get("neg_clicks", []):
            kf.neg_clicks.append((float(c["x"]), float(c["y"]),
                                  int(c.get("obj", 1))))
        for r in obj.get("rects", []):
            kf.rects.append((float(r["x"]), float(r["y"]), float(r["w"]),
                             float(r["h"]), int(r.get("obj", 1))))
        return kf


class AnnotationStore:
    """Frame-indexed keyframes with the reference's editing semantics."""

    def __init__(self):
        self.keyframes: dict[int, Keyframe] = {}

    def get_or_create(self, frame_idx: int) -> Keyframe:
        return self.keyframes.setdefault(int(frame_idx),
                                         Keyframe(int(frame_idx)))

    def prune_if_empty(self, frame_idx: int) -> bool:
        kf = self.keyframes.get(int(frame_idx))
        if kf is not None and kf.is_empty():
            del self.keyframes[int(frame_idx)]
            return True
        return False

    def max_obj_id(self) -> int:
        mx = 1
        for kf in self.keyframes.values():
            for (*_, o) in kf.pos_clicks + kf.neg_clicks:
                mx = max(mx, o)
            for (*_, o) in kf.rects:
                mx = max(mx, o)
        return mx

    def to_json_obj(self, video: str = "", fps: float = 0.0) -> dict:
        return {
            "video": video,
            "fps": fps,
            "keyframes": [kf.to_json_obj() for _, kf in
                          sorted(self.keyframes.items())],
        }

    def load_from_json_obj(self, obj: dict) -> None:
        self.keyframes.clear()
        for kobj in obj.get("keyframes", []):
            kf = Keyframe.from_json_obj(kobj)
            if not kf.is_empty():
                self.keyframes[kf.frame_idx] = kf

    def annotations_dict(self, only_frame: int | None = None,
                         remap_to_zero: bool = False) -> dict:
        """Pipeline-facing dict (run_sam2_on_frames input). only_frame
        with remap_to_zero implements the 1-frame mask preview contract
        (reference videovanish.py:1540-1557: frame_idx remapped to 0)."""
        kfs = sorted(self.keyframes.values(), key=lambda k: k.frame_idx)
        if only_frame is not None:
            kfs = [k for k in kfs if k.frame_idx == only_frame]
        out = []
        for kf in kfs:
            o = kf.to_json_obj()
            if remap_to_zero:
                o["frame_idx"] = 0
            out.append(o)
        return {"keyframes": out}
