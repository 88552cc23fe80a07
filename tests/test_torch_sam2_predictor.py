"""The port's SAM2 video predictor and run_sam2_on_frames against the JAX
package's, f32 on the CPU at the tiny config, with the weights of
tests/test_torch_sam2.py (made by the port, carried to JAX by its own
converter) and the default I420 wire on both sides.

Tolerance: on every frame the logits within 1e-4 * max|JAX logit|; binary
and coloured masks identical wherever |JAX logit| > 1e-3 * max|JAX logit|.
One JAX predictor serves the process, and one test runs the scenarios in
turn: the JAX predictor compiles a program per encode-chunk size, and
under the suite's parallel workers every test process that drew a
scenario of its own would compile them again (about a minute each on a
loaded host).
"""
import functools

import numpy as np

import videovanish_tpu.pipeline.masker as jmasker
from test_torch_sam2 import CFG, JCFG, weights
from torch_threads import one_torch_thread  # noqa: F401
from videovanish_tpu.models.sam2.predictor import (
    Sam2VideoPredictor as JPredictor,
)
from videovanish_tpu_torch.models.sam2.predictor import (
    ENCODE_CHUNK, Sam2VideoPredictor,
)
from videovanish_tpu_torch.pipeline import colors
from videovanish_tpu_torch.pipeline import masker as pmasker

REL, EDGE = 1e-4, 1e-3
T, H, W = ENCODE_CHUNK + 2, 96, 128


@functools.lru_cache(maxsize=None)
def predictors():
    """(port predictor, JAX predictor) with the same weights."""
    sd, tree = weights()
    return (Sam2VideoPredictor(CFG, params=sd, device="cpu"),
            JPredictor(config=JCFG, params=tree))


@functools.lru_cache(maxsize=None)
def video():
    """T frames with two bright shapes moving over a noisy background."""
    rng = np.random.default_rng(3)
    frames = []
    for t in range(T):
        f = (rng.random((H, W, 3)) * 80).astype(np.uint8)
        f[30:60, 40 + 4 * t:70 + 4 * t] = (220, 200, 60)
        f[8:28, 90 - 3 * t:110 - 3 * t] = (40, 90, 230)
        frames.append(f)
    return frames


def _sure(want):
    """Where each object's JAX logit is clear of 0: |logit| > EDGE times
    that object's max |logit| (absent objects hold NO_OBJ_SCORE)."""
    want = np.asarray(want)
    top = np.abs(want).reshape(len(want), -1).max(1)[:, None, None]
    return np.abs(want) > EDGE * top


def _close_logits(got, want):
    """(O, H, W) logits, each object within REL of its own max |JAX|."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == np.float32
    for g, w in zip(got, want):
        assert np.abs(g - w).max() <= REL * np.abs(w).max()
    sure = _sure(want)
    assert np.array_equal((got > 0)[sure], (want > 0)[sure])


def _prompt(pred, state, clicks=((55.0, 45.0),)):
    """A click object (1) and a box object (2) on frame 0; returns the two
    immediate predictions."""
    a = pred.add_new_points_or_box(
        inference_state=state, frame_idx=0, obj_id=1,
        points=np.array(clicks, np.float32),
        labels=np.ones(len(clicks), np.int32))
    b = pred.add_new_points_or_box(
        inference_state=state, frame_idx=0, obj_id=2,
        box=np.array([85.0, 5.0, 115.0, 30.0], np.float32))
    return a, b


def _both(fn):
    """fn(predictor, state) on the port and on JAX."""
    out = []
    for pred in predictors():
        state = pred.init_state(video_path=video())
        out.append(fn(pred, state))
    return out


def _check_streams(got, want):
    assert [f for f, _, _ in got] == [f for f, _, _ in want]
    for (_, ids, masks), (_, jids, jmasks) in zip(got, want):
        assert ids == jids
        _close_logits(np.stack(masks), np.stack(jmasks))


def _four_call_api():
    """init_state, two add_new_points_or_box calls (click, box) and
    propagate_in_video over ENCODE_CHUNK + 2 frames."""
    def run(pred, state):
        prompts = _prompt(pred, state)
        return prompts, list(pred.propagate_in_video(state))
    (p_prompts, p_stream), (j_prompts, j_stream) = _both(run)
    for (f, ids, lg), (jf, jids, jlg) in zip(p_prompts, j_prompts):
        assert (f, ids) == (jf, jids) and lg.shape == (len(ids), H, W)
        _close_logits(lg, jlg)
    assert len(p_stream) == T
    _check_streams(p_stream, j_stream)
    absent = [(m == -1024.0).all() for _, _, ms in j_stream for m in ms]
    assert 0 < sum(absent) < len(absent)  # both branches ran


def _reverse_from_frame_3():
    def run(pred, state):
        _prompt(pred, state)
        pred.add_new_points_or_box(
            inference_state=state, frame_idx=3, obj_id=1,
            points=np.array([[66.0, 44.0]], np.float32),
            labels=np.array([1], np.int32))
        return list(pred.propagate_in_video(state, start_frame_idx=3,
                                            reverse=True))
    got, want = _both(run)
    assert [f for f, _, _ in got] == [3, 2, 1, 0]
    _check_streams(got, want)


def _clear_old_points():
    """A second click with clear_old_points=False keeps the first (two
    clicks: single-mask output); with True it replaces it (multimask)."""
    def run(pred, state):
        _prompt(pred, state)
        out = []
        for clear in (False, True):
            out.append(pred.add_new_points_or_box(
                inference_state=state, frame_idx=0, obj_id=1,
                points=np.array([[30.0, 70.0]], np.float32),
                labels=np.array([0], np.int32),
                clear_old_points=clear)[2])
            out.append(list(state["prompts"][0][1]["labels"]))
        return out
    got, want = _both(run)
    assert got[1] == want[1] == [1, 0] and got[3] == want[3] == [0]
    _close_logits(got[0], want[0])
    _close_logits(got[2], want[2])


def _max_frame_num_to_track():
    def run(pred, state):
        _prompt(pred, state)
        return list(pred.propagate_in_video(
            state, start_frame_idx=1, max_frame_num_to_track=ENCODE_CHUNK))
    got, want = _both(run)
    assert [f for f, _, _ in got] == list(range(1, 1 + ENCODE_CHUNK))
    _check_streams(got, want)


def _recording(pred, logits):
    """pred.propagate_in_video that appends every frame's f32 logits to
    `logits` and yields the 0/1 masks the masker asks for."""
    orig = pred.propagate_in_video

    def propagate(state, *a, yield_binary=False, **k):
        for f, ids, masks in orig(state, *a, **k):
            logits.append(np.stack(masks))
            yield f, ids, [(m > 0).astype(np.uint8) for m in masks] \
                if yield_binary else masks
    return propagate


def _run_sam2_on_frames(monkeypatch):
    """Normalized and pixel coordinates, clicks of both labels on two
    keyframes and a rect: every frame's logits within the tolerance, and
    the coloured masks equal wherever each object's JAX logit is clear of
    0."""
    port, jax_pred = predictors()
    got_lg, want_lg = [], []
    monkeypatch.setattr(pmasker, "_get_predictor", lambda device=None: port)
    monkeypatch.setattr(jmasker, "predictor", jax_pred)
    monkeypatch.setattr(port, "propagate_in_video", _recording(port, got_lg))
    monkeypatch.setattr(jax_pred, "propagate_in_video",
                        _recording(jax_pred, want_lg))
    ann = {"keyframes": [
        {"frame_idx": 0,
         "pos_clicks": [{"x": 0.43, "y": 0.47, "obj": 1}],
         "rects": [{"x": 85, "y": 5, "w": 30, "h": 25, "obj": 2}]},
        {"frame_idx": 4, "neg_clicks": [{"x": 10, "y": 80, "obj": 1}]},
    ]}
    frames = video()
    got = pmasker.run_sam2_on_frames(frames, ann, device="cpu")
    want = jmasker.run_sam2_on_frames(frames, ann)
    assert len(got) == len(want) == len(got_lg) == len(want_lg) == T
    palette = {(0, 0, 0), colors.color_for_obj(1), colors.color_for_obj(2)}
    for g, w, lg, jlg in zip(got, want, got_lg, want_lg):
        assert g.shape == (H, W, 3) and g.dtype == np.uint8
        assert {tuple(c) for c in g.reshape(-1, 3)} <= palette
        _close_logits(lg, jlg)
        sure = _sure(jlg).all(0)
        assert np.array_equal(g[sure], w[sure])


def test_predictor_and_masker_match_jax(monkeypatch):
    """The 4-call API over ENCODE_CHUNK + 2 frames, reverse propagation
    from frame 3, clear_old_points, max_frame_num_to_track, and
    run_sam2_on_frames, each against the JAX package."""
    _four_call_api()
    _reverse_from_frame_3()
    _clear_old_points()
    _max_frame_num_to_track()
    _run_sam2_on_frames(monkeypatch)
