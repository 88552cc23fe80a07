"""The port's video files (videovanish_tpu_torch/video) against the JAX
package's: FFV1/MKV written by either package reads back bitwise in the
other with the same fps, the start/max windows give the JAX package's
frames (a start past the end included), probe_video agrees, the nearest
resize on write gives the JAX writer's file, and PrefetchingFrameSource
yields the JAX package's chunks and stops its thread when closed early."""
import threading
import time

import numpy as np
import pytest

from torch_threads import one_torch_thread  # noqa: F401
from videovanish_tpu.video import io as jio
from videovanish_tpu.video.staging import (
    PrefetchingFrameSource as JPrefetchingFrameSource,
)
from videovanish_tpu_torch.video import io as pio
from videovanish_tpu_torch.video.staging import PrefetchingFrameSource

T, H, W = 12, 48, 64
FPS = 24.0


def _frames(seed=0, n=T):
    return list(np.random.default_rng(seed).integers(0, 256, (n, H, W, 3),
                                                     np.uint8))


@pytest.fixture(scope="module")
def clips(tmp_path_factory):
    """The same seeded frames written by the port and by the JAX package."""
    d = tmp_path_factory.mktemp("io")
    frames = _frames()
    paths = {"port": str(d / "port.mkv"), "jax": str(d / "jax.mkv")}
    pio.write_video_frames_to_path(paths["port"], frames, FPS, H, W)
    jio.write_video_frames_to_path(paths["jax"], frames, FPS, H, W)
    return frames, paths


def test_files_cross_packages_bitwise(clips, tmp_path):
    """Each package reads the other's file as written, with its fps; the
    windows and probe_video agree with the JAX package's; a frame of
    another size is nearest-resized into the same file bytes."""
    frames, paths = clips
    for writer in ("port", "jax"):
        for read in (pio.load_video_frames_from_path,
                     jio.load_video_frames_from_path):
            got, fps = read(paths[writer])
            assert fps == FPS
            np.testing.assert_array_equal(np.stack(got), np.stack(frames))
        assert pio.probe_video(paths[writer]) == \
            jio.probe_video(paths[writer]) == (T, FPS, H, W)
    for start in (0, 1, 5, T - 1, T, T + 3):
        for count in (-1, 0, 1, 4, T):
            if start >= T:
                for read in (pio.load_video_frames_from_path,
                             jio.load_video_frames_from_path):
                    with pytest.raises(AssertionError, match="No frames read"):
                        read(paths["port"], start, count)
                continue
            got, _ = pio.load_video_frames_from_path(paths["port"], start,
                                                     count)
            want, _ = jio.load_video_frames_from_path(paths["port"], start,
                                                      count)
            assert len(got) == len(want) == (
                T - start if count <= 0 else min(count, T - start))
            np.testing.assert_array_equal(np.stack(got), np.stack(want))

    # frames of other sizes, nearest-resized on write
    odd = [_frames(1, 1)[0][:31, :40], _frames(2, 1)[0],
           np.random.default_rng(3).integers(0, 256, (97, 130, 3), np.uint8)]
    pio.write_video_frames_to_path(tmp_path / "p.mkv", odd, 30.0, H, W)
    jio.write_video_frames_to_path(str(tmp_path / "j.mkv"), odd, 30.0, H, W)
    got, fps = pio.load_video_frames_from_path(tmp_path / "p.mkv")
    want, jfps = jio.load_video_frames_from_path(str(tmp_path / "j.mkv"))
    assert fps == jfps == 30.0 and len(got) == 3
    np.testing.assert_array_equal(np.stack(got), np.stack(want))
    np.testing.assert_array_equal(got[1], odd[1])


def test_prefetching_source_matches_jax_and_closes_early(clips):
    """Chunks of 5 (and what is left) from a window of the clip, as the
    JAX package's source gives them; close() after one chunk of a source
    whose queue is full returns within a few seconds and stops its
    thread."""
    frames, paths = clips
    port = PrefetchingFrameSource(paths["jax"], 2, 9, prefetch_frames=3)
    ref = JPrefetchingFrameSource(paths["jax"], 2, 9, prefetch_frames=3)
    with port, ref:
        assert port.fps == ref.fps == FPS
        sizes = []
        while True:
            got, want = port.read_chunk(5), ref.read_chunk(5)
            assert len(got) == len(want)
            if not got:
                break
            sizes.append(len(got))
            np.testing.assert_array_equal(np.stack(got), np.stack(want))
    assert sizes == [5, 4]

    before = threading.active_count()
    src = PrefetchingFrameSource(paths["port"], prefetch_frames=2)
    first = src.read_chunk(1)
    np.testing.assert_array_equal(first[0], frames[0])
    time.sleep(0.2)  # the decode thread fills the queue and waits on it
    assert src._thread.is_alive()
    t0 = time.perf_counter()
    src.close()
    assert time.perf_counter() - t0 < 5.0
    assert not src._thread.is_alive()
    assert threading.active_count() <= before
