"""Application shell (port of videovanish_tpu/gui/main_window.py) —
behavior parity with the reference MainWindow (videovanish.py:1288-1741):
menus, dark theme, dock wiring, one-job-at-a-time runner with progress
dialog + cancel + error dialog, annotation editing with keyframe chips,
Generate Mask / Make Vanish and the two bounded-latency previews (mask:
1 frame; infill: 22 frames from the cursor, videovanish.py:1544,1572),
annotations JSON save/load. The jobs themselves are gui/jobs.py's, run on
`device` ("cuda" unless the caller asks for "cpu")."""
from __future__ import annotations

import json

from PySide6.QtCore import Qt
from PySide6.QtWidgets import QFileDialog, QMainWindow, QMessageBox

from videovanish_tpu_torch.gui import jobs
from videovanish_tpu_torch.gui.annotations import AnnotationStore
from videovanish_tpu_torch.gui.dock import SideDock
from videovanish_tpu_torch.gui.player import VideoPlayer
from videovanish_tpu_torch.gui.worker import ProgressDialog, Worker


class MainWindow(QMainWindow):
    def __init__(self, color_video=None, mask_video=None, infilled_video=None,
                 device: str = "cuda"):
        super().__init__()
        self.setWindowTitle("VideoVanish")
        self.device = device
        self.resize(1280, 800)

        self.player = VideoPlayer(self)
        self.setCentralWidget(self.player)
        self.dock = SideDock(self)
        self.addDockWidget(Qt.RightDockWidgetArea, self.dock)

        self.annotations = AnnotationStore()
        self.color_path = None
        self.mask_path = None
        self.infilled_path = None
        self._job_running = False
        self._worker = None
        self._dlg = None

        self._wire()
        self._build_menus()
        self._build_toolbar()

        if color_video:
            self.load_color_video(color_video)
        if mask_video:
            self.load_mask_video(mask_video)
        if infilled_video:
            self.load_infilled_video(infilled_video)

    # ------------------------------------------------------------------
    def _wire(self):
        d, v = self.dock, self.player.view
        d.toolChanged.connect(lambda t: setattr(v.overlay, "tool", t))
        d.objChanged.connect(lambda o: setattr(v.overlay, "obj_id", o))
        d.viewModeChanged.connect(v.set_base_visible)
        d.maskVisibleChanged.connect(v.set_mask_visible)
        d.maskOpacityChanged.connect(v.set_mask_opacity)
        d.openColor.connect(self.open_color_dialog)
        d.openMask.connect(self.open_mask_dialog)
        d.openInfilled.connect(self.open_infilled_dialog)
        d.generateMask.connect(self.generate_mask)
        d.previewMask.connect(self.on_preview_mask_clicked)
        d.makeVanish.connect(self.make_vanish)
        d.previewInfill.connect(self.on_preview_infill_clicked)

        v.addPositive.connect(self._add_pos)
        v.addNegative.connect(self._add_neg)
        v.addRectangle.connect(self._add_rect)
        v.requestDelete.connect(self._delete_nearest)
        self.player.frameChanged.connect(self._refresh_overlay)

    def _build_menus(self):
        m = self.menuBar().addMenu("&File")
        m.addAction("Open Color Video…", self.open_color_dialog)
        m.addAction("Open Mask Video…", self.open_mask_dialog)
        m.addAction("Open Infilled Video…", self.open_infilled_dialog)
        m.addSeparator()
        m.addAction("Save Annotations…", self.save_annotations)
        m.addAction("Load Annotations…", self.load_annotations)
        m.addSeparator()
        m.addAction("Quit", self.close)

    def _build_toolbar(self):
        """Main toolbar: open / play-pause / stop actions + volume
        slider into the master QAudioOutput (reference
        videovanish.py:1617-1624)."""
        from PySide6.QtCore import QSize
        from PySide6.QtWidgets import QLabel, QSlider, QStyle, QToolBar

        from videovanish_tpu_torch.gui.sync_logic import VOLUME_SLIDER_DEFAULT

        tb = QToolBar("Main", self)
        tb.setIconSize(QSize(18, 18))
        self.addToolBar(Qt.TopToolBarArea, tb)
        style = self.style()
        tb.addAction(style.standardIcon(QStyle.SP_DirOpenIcon),
                     "Open Color Video…", self.open_color_dialog)
        tb.addAction(style.standardIcon(QStyle.SP_MediaPlay),
                     "Play/Pause (Space)", self.player.toggle_play)
        tb.addAction(style.standardIcon(QStyle.SP_MediaStop),
                     "Stop", self.player.stop)
        tb.addSeparator()
        tb.addWidget(QLabel("Vol", self))
        vol = QSlider(Qt.Horizontal, self)
        vol.setRange(0, 100)
        vol.setValue(VOLUME_SLIDER_DEFAULT)
        vol.setFixedWidth(120)
        vol.valueChanged.connect(self.player.set_volume)
        tb.addWidget(vol)
        self.volume_slider = vol

    # ------------------------------------------------------------------
    # file loading
    # ------------------------------------------------------------------
    def _pick(self, title):
        path, _ = QFileDialog.getOpenFileName(
            self, title, "", "Videos (*.mkv *.mp4 *.avi *.mov);;All (*)")
        return path or None

    def open_color_dialog(self):
        p = self._pick("Open color video")
        if p:
            self.load_color_video(p)

    def open_mask_dialog(self):
        p = self._pick("Open mask video")
        if p:
            self.load_mask_video(p)

    def open_infilled_dialog(self):
        p = self._pick("Open infilled video")
        if p:
            self.load_infilled_video(p)

    def load_color_video(self, path):
        self.color_path = path
        self.player.load_color_video(path)

    def load_mask_video(self, path):
        self.mask_path = path
        self.player.load_mask_video(path)

    def load_infilled_video(self, path):
        self.infilled_path = path
        self.player.load_infill_video(path)

    # ------------------------------------------------------------------
    # annotation editing
    # ------------------------------------------------------------------
    def _kf(self):
        return self.annotations.get_or_create(self.player.current_frame)

    def _after_edit(self):
        f = self.player.current_frame
        if not self.annotations.prune_if_empty(f):
            self.player.chips.add_chip(f)
        else:
            self.player.chips.remove_chip(f)
        self._refresh_overlay(f)

    def _add_pos(self, x, y, obj):
        self._kf().pos_clicks.append((x, y, obj))
        self._after_edit()

    def _add_neg(self, x, y, obj):
        self._kf().neg_clicks.append((x, y, obj))
        self._after_edit()

    def _add_rect(self, x, y, w, h, obj):
        self._kf().rects.append((x, y, w, h, obj))
        self._after_edit()

    def _delete_nearest(self, x, y):
        """Right-click: delete the nearest point, else the rect whose edge
        is nearest (reference :229-235, 1056-1080)."""
        kf = self.annotations.keyframes.get(self.player.current_frame)
        if kf is None:
            return
        best = None  # (dist, kind, index)
        for lst, kind in ((kf.pos_clicks, "pos"), (kf.neg_clicks, "neg")):
            for i, (px, py, _) in enumerate(lst):
                d = (px - x) ** 2 + (py - y) ** 2
                if best is None or d < best[0]:
                    best = (d, kind, i)
        if best is None or best[0] > 0.002:
            for i, (rx, ry, rw, rh, _) in enumerate(kf.rects):
                dx = max(rx - x, 0, x - (rx + rw))
                dy = max(ry - y, 0, y - (ry + rh))
                d = dx * dx + dy * dy
                if best is None or d < best[0]:
                    best = (d, "rect", i)
        if best is None:
            return
        _, kind, i = best
        {"pos": kf.pos_clicks, "neg": kf.neg_clicks,
         "rect": kf.rects}[kind].pop(i)
        self._after_edit()

    def _refresh_overlay(self, frame_idx):
        kf = self.annotations.keyframes.get(frame_idx)
        ov = self.player.view.overlay
        if kf is None:
            ov.set_annotations([], [])
        else:
            clicks = [(x, y, o, True) for (x, y, o) in kf.pos_clicks] + \
                     [(x, y, o, False) for (x, y, o) in kf.neg_clicks]
            ov.set_annotations(clicks, list(kf.rects))

    # ------------------------------------------------------------------
    # annotations save/load (schema parity :1706-1732)
    # ------------------------------------------------------------------
    def save_annotations(self):
        path, _ = QFileDialog.getSaveFileName(
            self, "Save annotations", "", "JSON (*.json)")
        if not path:
            return
        with open(path, "w") as f:
            json.dump(self.annotations.to_json_obj(
                video=self.color_path or "", fps=self.player.fps or 0.0),
                f, indent=2)

    def load_annotations(self):
        path, _ = QFileDialog.getOpenFileName(
            self, "Load annotations", "", "JSON (*.json)")
        if not path:
            return
        with open(path) as f:
            self.annotations.load_from_json_obj(json.load(f))
        for fidx in self.annotations.keyframes:
            self.player.chips.add_chip(fidx)
        self._refresh_overlay(self.player.current_frame)

    # ------------------------------------------------------------------
    # job runner (one at a time; reference :1355-1397)
    # ------------------------------------------------------------------
    def run_with_progress(self, title, job, on_done):
        if self._job_running:
            QMessageBox.information(self, "Busy",
                                    "Another job is already running.")
            return
        self._job_running = True
        self._dlg = ProgressDialog(title, self)
        self._worker = Worker(job, self)
        self._worker.progressed.connect(self._dlg.on_progress)
        self._dlg.cancel_btn.clicked.connect(self._worker.request_cancel)

        def done(result):
            self._job_running = False
            self._dlg.accept()
            on_done(result)

        def failed(tb):
            self._job_running = False
            self._dlg.accept()
            QMessageBox.critical(self, "Job failed", tb)

        self._worker.finished_ok.connect(done)
        self._worker.failed.connect(failed)
        self._worker.start()
        self._dlg.exec()

    # ------------------------------------------------------------------
    # pipeline actions (reference :1443-1602)
    # ------------------------------------------------------------------
    def generate_mask(self):
        if not self.color_path:
            QMessageBox.warning(self, "No video", "Open a color video first.")
            return
        job = jobs.generate_mask_job(self.color_path,
                                     self.annotations.annotations_dict(),
                                     device=self.device)
        self.run_with_progress("Generating Mask…", job,
                               lambda p: p and self.load_mask_video(p))

    def _infill_settings(self) -> dict:
        return {"max_img_size": self.dock.resolution.value(),
                "mask_dilation_iter": self.dock.dilation.value(),
                "keep_unmasked_original": self.dock.preserve.isChecked()}

    def make_vanish(self):
        if not (self.color_path and self.mask_path):
            QMessageBox.warning(self, "Missing inputs",
                                "Open color and mask videos first.")
            return
        job = jobs.make_vanish_job(self.color_path, self.mask_path,
                                   **self._infill_settings(),
                                   device=self.device)

        def done(p):
            if p:
                self.load_infilled_video(p)
                self.dock.view_combo.setCurrentText("Infilled")

        self.run_with_progress("Making Vanish…", job, done)

    def on_preview_mask_clicked(self):
        """1-frame mask preview shown as RAM overlay (:1540-1557)."""
        if not self.color_path:
            return
        f = self.player.current_frame
        ann = self.annotations.annotations_dict(only_frame=f,
                                               remap_to_zero=True)
        if not ann["keyframes"]:
            QMessageBox.information(self, "No annotations",
                                    "Annotate this frame first.")
            return
        job = jobs.preview_mask_job(self.color_path, f, ann,
                                    device=self.device)
        self.run_with_progress(
            "Previewing Mask…", job,
            lambda masks: masks and self.player.set_mask_preview_frames(
                masks, start_frame=f))

    def on_preview_infill_clicked(self):
        """22-frame infill preview from the cursor (:1566-1602)."""
        if not (self.color_path and self.mask_path):
            return
        f = self.player.current_frame
        job = jobs.preview_infill_job(self.color_path, self.mask_path, f,
                                      **self._infill_settings(),
                                      device=self.device)
        self.run_with_progress(
            "Previewing Infill…", job,
            lambda out: out and self.player.set_infill_preview_frames(
                out, start_frame=f))
