"""Decode-ahead staging (port of videovanish_tpu/video/staging.py).

A decode thread reads a video ahead of the compute loop into a bounded
queue of `prefetch_frames` frames, so codec work overlaps the card's and
host memory stays bounded on long videos. The JAX package's ring lives in
its native C++ library; a `queue.Queue` gives the same bound and order and
needs no build step, so there is no synchronous fallback either.
"""
from __future__ import annotations

import queue
import threading

import numpy as np

from videovanish_tpu_torch.video.io import VideoFrameReader

_END = object()  # the decode thread's last item


class PrefetchingFrameSource:
    """Chunks of frames of a video window while a thread decodes ahead.

    `close()` (or leaving the `with` block) stops the thread even when the
    consumer stopped early, and releases the file."""

    def __init__(self, video_path, start_frame: int = 0, max_frames: int = -1,
                 prefetch_frames: int = 64):
        self.reader = VideoFrameReader(video_path, start_frame, max_frames)
        self.fps = self.reader.fps
        self._queue: queue.Queue = queue.Queue(maxsize=max(1, prefetch_frames))
        self._stop = threading.Event()
        self._done = False
        self._thread = threading.Thread(target=self._decode_loop, daemon=True,
                                        name="vv-decode")
        self._thread.start()

    def _put(self, item) -> bool:
        """Queue an item, waiting for room; False once close() was called."""
        while not self._stop.is_set():
            try:
                self._queue.put(item, timeout=0.05)
                return True
            except queue.Full:
                pass
        return False

    def _decode_loop(self) -> None:
        try:
            while True:
                frames = self.reader.read_chunk(1)
                if not frames or not self._put(frames[0]):
                    break
        except Exception as e:  # handed to the consumer, raised there
            self._put(e)
        self._put(_END)

    def read_chunk(self, n: int) -> list[np.ndarray]:
        """Up to n more frames of the window; fewer at its end."""
        out = []
        while len(out) < n and not self._done:
            item = self._queue.get()
            if item is _END:
                self._done = True
            elif isinstance(item, Exception):
                self._done = True
                raise item
            else:
                out.append(item)
        return out

    def close(self) -> None:
        self._stop.set()
        self._thread.join()
        self.reader.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
