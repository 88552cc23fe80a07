"""3-player sync engine + keyframe chip bar (port of
videovanish_tpu/gui/player.py).

Behavior parity with the reference VideoPlayer (videovanish.py:493-980):
  - master player (original, with audio) + two followers (infill, mask);
  - followers resync every 120 ms during playback when drift > 35 ms
    (:530-533, 872-884); exact position snap on pause/seek (:886-903);
  - frame-accurate position from the master QVideoSink's frame
    timestamps (:518-519, 853-869);
  - fps must come from container metadata — hard error if absent
    (:917-926); ms<->frame conversion (:57-61);
  - EndOfMedia -> pause + seek to 0 (:908-910); poster frame on load;
  - RAM preview layers indexed by the current frame (:640-750);
  - keyframe chip bar: thumbnails sorted by frame, click -> seek
    (:982-1088).
"""
from __future__ import annotations

import numpy as np

from PySide6.QtCore import Qt, QTimer, QUrl, Signal
from PySide6.QtMultimedia import QAudioOutput, QMediaMetaData, QMediaPlayer
from PySide6.QtWidgets import (
    QHBoxLayout, QLabel, QPushButton, QSlider, QStyle,
    QToolButton, QVBoxLayout, QWidget,
)

from videovanish_tpu_torch.gui.view import VideoView
# sync policy lives in sync_logic.py (pure, PySide6-free) so it is
# testable on hosts without Qt; this module is the thin Qt shell
from videovanish_tpu_torch.gui.sync_logic import (  # noqa: F401 (re-exports)
    RESYNC_DRIFT_MS, RESYNC_INTERVAL_MS, chip_insert_pos,
    followers_to_resync, frame_count, frame_to_ms, master_frame_ms,
    ms_to_frame, preview_frame_index, volume_from_slider,
)


class KeyframeChipBar(QWidget):
    chipClicked = Signal(int)

    def __init__(self, parent=None):
        super().__init__(parent)
        self._lay = QHBoxLayout(self)
        self._lay.setContentsMargins(2, 2, 2, 2)
        self._lay.addStretch(1)
        self._chips: dict[int, QToolButton] = {}

    def add_chip(self, frame_idx: int, thumb=None):
        if frame_idx in self._chips:
            return
        btn = QToolButton(self)
        btn.setText(str(frame_idx))
        if thumb is not None:
            from PySide6.QtGui import QIcon
            btn.setIcon(QIcon(thumb))
        btn.clicked.connect(lambda: self.chipClicked.emit(frame_idx))
        self._lay.insertWidget(chip_insert_pos(self._chips, frame_idx), btn)
        self._chips[frame_idx] = btn

    def remove_chip(self, frame_idx: int):
        btn = self._chips.pop(frame_idx, None)
        if btn is not None:
            btn.setParent(None)
            btn.deleteLater()


class VideoPlayer(QWidget):
    frameChanged = Signal(int)

    def __init__(self, parent=None):
        super().__init__(parent)
        self.view = VideoView(self)
        self.fps: float | None = None
        self.n_frames = 0
        self.current_frame = 0

        self.player_orig = QMediaPlayer(self)
        self.audio = QAudioOutput(self)
        self.player_orig.setAudioOutput(self.audio)
        self.player_infill = QMediaPlayer(self)
        self.player_mask = QMediaPlayer(self)

        self.player_orig.setVideoOutput(self.view.video_item)
        self.player_infill.setVideoOutput(self.view.infill_item)
        self.player_mask.setVideoOutput(self.view.mask_item)

        sink = self.view.video_item.videoSink()
        if sink is not None:
            sink.videoFrameChanged.connect(self._on_master_frame_changed)
        self.player_orig.mediaStatusChanged.connect(self._on_master_status)

        # follower drift correction during playback
        self._resync = QTimer(self)
        self._resync.setInterval(RESYNC_INTERVAL_MS)
        self._resync.timeout.connect(self._playing_resync)

        # RAM previews: (start_frame, [np frames]) indexed by current frame
        self._mask_preview = None
        self._infill_preview = None

        # transport UI
        self.play_btn = QPushButton(self)
        self.play_btn.setIcon(self.style().standardIcon(
            QStyle.SP_MediaPlay))
        self.play_btn.clicked.connect(self.toggle_play)
        self.slider = QSlider(Qt.Horizontal, self)
        self.slider.sliderMoved.connect(self._on_slider)
        self.time_label = QLabel("0", self)
        self.chips = KeyframeChipBar(self)
        self.chips.chipClicked.connect(self.seek_to_frame)

        bar = QHBoxLayout()
        bar.addWidget(self.play_btn)
        bar.addWidget(self.slider, 1)
        bar.addWidget(self.time_label)
        lay = QVBoxLayout(self)
        lay.addWidget(self.view, 1)
        lay.addLayout(bar)
        lay.addWidget(self.chips)

    # ---- sources ------------------------------------------------------
    def load_color_video(self, path: str):
        self.player_orig.setSource(QUrl.fromLocalFile(path))

    def load_mask_video(self, path: str):
        self.player_mask.setSource(QUrl.fromLocalFile(path))

    def load_infill_video(self, path: str):
        self.player_infill.setSource(QUrl.fromLocalFile(path))

    # ---- master frame tracking ---------------------------------------
    def _on_master_status(self, status):
        if status == QMediaPlayer.LoadedMedia:
            meta = self.player_orig.metaData()
            fps = meta.value(QMediaMetaData.VideoFrameRate)
            if not fps:
                raise ValueError(
                    "Video container reports no frame rate; VideoVanish "
                    "requires fps metadata for frame-accurate seeking.")
            self.fps = float(fps)
            dur = self.player_orig.duration()
            self.n_frames = frame_count(dur, self.fps)
            self.slider.setRange(0, max(0, self.n_frames - 1))
            # poster frame
            self.player_orig.pause()
            self.player_orig.setPosition(0)
            self.view.relayout()
        elif status == QMediaPlayer.EndOfMedia:
            self.pause()
            self.seek_to_frame(0)

    def _on_master_frame_changed(self, frame):
        if self.fps is None:
            return
        ts_us = frame.startTime() if frame.isValid() else -1
        ms = master_frame_ms(ts_us, self.player_orig.position())
        idx = ms_to_frame(ms, self.fps)
        if idx != self.current_frame:
            self.current_frame = idx
            self.slider.blockSignals(True)
            self.slider.setValue(idx)
            self.slider.blockSignals(False)
            self.time_label.setText(str(idx))
            self._update_previews()
            self.frameChanged.emit(idx)

    # ---- follower sync ------------------------------------------------
    def _playing_resync(self):
        pos = self.player_orig.position()
        followers = (self.player_infill, self.player_mask)
        for i in followers_to_resync(
                pos, [pl.position() for pl in followers],
                [not pl.source().isEmpty() for pl in followers]):
            followers[i].setPosition(pos)

    def _snap_followers(self):
        pos = self.player_orig.position()
        for pl in (self.player_infill, self.player_mask):
            if not pl.source().isEmpty():
                pl.setPosition(pos)

    # ---- transport ----------------------------------------------------
    def play(self):
        self.player_orig.play()
        for pl in (self.player_infill, self.player_mask):
            if not pl.source().isEmpty():
                pl.play()
        self._resync.start()
        self.play_btn.setIcon(self.style().standardIcon(QStyle.SP_MediaPause))

    def pause(self):
        self._resync.stop()
        self.player_orig.pause()
        for pl in (self.player_infill, self.player_mask):
            if not pl.source().isEmpty():
                pl.pause()
        self._snap_followers()
        self.play_btn.setIcon(self.style().standardIcon(QStyle.SP_MediaPlay))

    def toggle_play(self):
        if self.player_orig.playbackState() == QMediaPlayer.PlayingState:
            self.pause()
        else:
            self.play()

    def stop(self):
        """Toolbar Stop: pause and rewind (reference videovanish.py:823)."""
        self.pause()
        self.seek_to_frame(0)

    def set_volume(self, value: int):
        """Toolbar volume slider 0-100 -> master audio output
        (reference videovanish.py:850)."""
        self.audio.setVolume(volume_from_slider(value))

    def seek_to_frame(self, frame_idx: int):
        if self.fps is None:
            return
        self.player_orig.setPosition(frame_to_ms(frame_idx, self.fps))
        self._snap_followers()

    def _on_slider(self, value: int):
        self.seek_to_frame(int(value))

    # ---- RAM previews -------------------------------------------------
    def set_mask_preview_frames(self, frames: list[np.ndarray] | None,
                                start_frame: int = 0):
        self._mask_preview = (start_frame, frames) if frames else None
        self._update_previews()

    def set_infill_preview_frames(self, frames: list[np.ndarray] | None,
                                  start_frame: int = 0):
        self._infill_preview = (start_frame, frames) if frames else None
        self._update_previews()

    def _update_previews(self):
        for store, show in ((self._mask_preview, self.view.show_mask_preview),
                            (self._infill_preview,
                             self.view.show_infill_preview)):
            if store is None:
                show(None)
                continue
            start, frames = store
            i = preview_frame_index(start, len(frames), self.current_frame)
            show(frames[i] if i is not None else None)
