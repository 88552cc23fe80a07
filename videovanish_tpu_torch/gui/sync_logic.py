"""Pure decision logic of the 3-player sync engine (port of
videovanish_tpu/gui/sync_logic.py).

Behavior parity with the reference VideoPlayer (videovanish.py:493-980),
factored out of the Qt shell (gui/player.py) so the sync policy is
testable on hosts without PySide6:
  - followers resync during playback only when |drift| > 35 ms and only
    when they have a source loaded (reference :530-533, 872-884);
  - frame-accurate master time prefers the QVideoSink frame timestamp,
    falling back to the player clock (:853-869);
  - ms<->frame conversion (:57-61); frame count from container duration;
  - RAM preview layers index by absolute frame with a start offset,
    out-of-range -> no preview (:640-750);
  - keyframe chips keep sorted order by frame index (:982-1088).
"""
from __future__ import annotations

RESYNC_INTERVAL_MS = 120
RESYNC_DRIFT_MS = 35


def ms_to_frame(ms: float, fps: float) -> int:
    return int(round(ms * fps / 1000.0))


def frame_to_ms(frame: int, fps: float) -> int:
    return int(round(frame * 1000.0 / fps))


def frame_count(duration_ms: float, fps: float) -> int:
    """Number of frames implied by the container duration."""
    return ms_to_frame(duration_ms, fps)


def master_frame_ms(frame_ts_us, player_position_ms: float) -> float:
    """Frame-accurate master time in ms: the sink frame's start timestamp
    (microseconds) when valid and positive, else the player clock
    (reference videovanish.py:853-869)."""
    if frame_ts_us and frame_ts_us > 0:
        return frame_ts_us / 1000.0
    return float(player_position_ms)


def followers_to_resync(master_ms: float, follower_ms, has_source,
                        drift_ms: float = RESYNC_DRIFT_MS):
    """Indices of followers that must snap to the master position:
    loaded followers whose |drift| exceeds drift_ms (reference
    videovanish.py:872-884 — strictly greater, 35 ms default)."""
    return [i for i, (pos, loaded) in enumerate(zip(follower_ms, has_source))
            if loaded and abs(pos - master_ms) > drift_ms]


def preview_frame_index(start_frame: int, n_frames: int, current_frame: int):
    """RAM preview lookup: absolute frame -> index into the preview list,
    or None outside [start_frame, start_frame + n_frames) (reference
    videovanish.py:640-750)."""
    i = current_frame - start_frame
    return i if 0 <= i < n_frames else None


def chip_insert_pos(existing_frames, frame_idx: int) -> int:
    """Insertion position that keeps keyframe chips sorted by frame index
    (reference videovanish.py:982-1088)."""
    return sum(1 for f in existing_frames if f < frame_idx)


VOLUME_SLIDER_DEFAULT = 90  # reference toolbar default (videovanish.py:1622)


def volume_from_slider(value: int) -> float:
    """Toolbar volume slider (0-100 int) -> QAudioOutput.setVolume
    (0.0-1.0 linear), clipped like the reference (videovanish.py:850)."""
    return max(0.0, min(1.0, value / 100.0))
