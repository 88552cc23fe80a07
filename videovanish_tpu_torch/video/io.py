"""Video files in and out (port of videovanish_tpu/video/io.py).

Frames are host (H, W, 3) RGB uint8 numpy arrays; the pipelines move them
to the card. Reading decodes from the first frame and discards up to
`start_frame` (no codec-level seek, so frame indices do not depend on the
codec) and stops after `max_frames`; writing is lossless FFV1 in .mkv,
RGB to BGR, with a nearest resize to (W0, H0) of a frame of another size.

The codec is OpenCV's bundled FFmpeg, as in the JAX package, so a file
written by either package reads back bitwise in the other. This is the
only module of the port that imports cv2, and only inside its functions:
the compute path needs torch alone.
"""
from __future__ import annotations

import numpy as np


def _cv2():
    try:
        import cv2
    except ImportError as e:  # pragma: no cover - cv2 is on both machines
        raise RuntimeError("video files need OpenCV (cv2) with FFmpeg") from e
    return cv2


def codec_info() -> dict:
    """The codec library: OpenCV's version and its build's Video I/O
    lines."""
    cv2 = _cv2()
    lines = cv2.getBuildInformation().splitlines()
    start = next(i for i, line in enumerate(lines) if "Video I/O" in line)
    video_io = []
    for line in lines[start + 1:]:
        if not line.strip():
            break
        video_io.append(" ".join(line.split()))
    return {"cv2": cv2.__version__, "video_io": video_io}


def _open(video_path):
    cv2 = _cv2()
    cap = cv2.VideoCapture(str(video_path))
    if not cap.isOpened():
        raise AssertionError(f"Failed to open video: {video_path}")
    return cap


def load_video_frames_from_path(video_path, start_frame: int = 0,
                                max_frames: int = -1):
    """Frames [start_frame, start_frame + max_frames) as a list of (H, W, 3)
    RGB uint8 arrays (max_frames <= 0: to the end), and the fps. Raises
    AssertionError when no frame is read."""
    with VideoFrameReader(video_path, start_frame, max_frames) as reader:
        frames = reader.read_chunk(2 ** 62)
        fps = reader.fps
    if len(frames) == 0:
        raise AssertionError("No frames read")
    return frames, fps


def write_video_frames_to_path(out_video, frames, fps, H0: int, W0: int,
                               fourcc: str = "FFV1"):
    """Write an iterable of (H, W, 3) RGB uint8 frames losslessly (FFV1 in
    .mkv by default) at (H0, W0), nearest-resizing a frame of another
    size."""
    cv2 = _cv2()
    writer = cv2.VideoWriter(str(out_video), cv2.VideoWriter_fourcc(*fourcc),
                             fps, (int(W0), int(H0)))
    if not writer.isOpened():
        raise AssertionError("Failed to open VideoWriter (FFV1/MKV). "
                             "Try MJPG or mp4v if needed.")
    n = 0
    try:
        for f in frames:
            f = cv2.cvtColor(np.asarray(f), cv2.COLOR_RGB2BGR)
            if f.shape[0] != H0 or f.shape[1] != W0:
                f = cv2.resize(f, (int(W0), int(H0)),
                               interpolation=cv2.INTER_NEAREST)
            writer.write(f)
            n += 1
    finally:
        writer.release()
    print(f"[ok] wrote {n} frames to {out_video}")


def probe_video(video_path):
    """(n_frames, fps, H, W) from the container, without decoding."""
    cv2 = _cv2()
    cap = _open(video_path)
    try:
        return (int(cap.get(cv2.CAP_PROP_FRAME_COUNT)),
                cap.get(cv2.CAP_PROP_FPS),
                int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT)),
                int(cap.get(cv2.CAP_PROP_FRAME_WIDTH)))
    finally:
        cap.release()


class VideoFrameReader:
    """Reads a window of a video a chunk at a time, so a long video never
    sits whole in host memory. Same window as load_video_frames_from_path."""

    def __init__(self, video_path, start_frame: int = 0, max_frames: int = -1):
        cv2 = _cv2()
        self.cap = _open(video_path)
        self.fps = self.cap.get(cv2.CAP_PROP_FPS)
        self.start_frame = start_frame
        self.max_frames = max_frames
        self._emitted = 0
        self._idx = 0

    def read_chunk(self, n: int) -> list:
        """Up to n more frames of the window; fewer at its end."""
        cv2 = _cv2()
        out = []
        while len(out) < n:
            if self.max_frames > 0 and self._emitted >= self.max_frames:
                break
            ok, frame = self.cap.read()
            if not ok:
                break
            if self._idx >= self.start_frame:
                out.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
                self._emitted += 1
            self._idx += 1
        return out

    def close(self):
        self.cap.release()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
