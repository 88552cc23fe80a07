"""Layered video view + annotation overlay (port of
videovanish_tpu/gui/view.py).

Behavior parity with the reference's VideoView/OverlayItem
(videovanish.py:136-476): a QGraphicsScene stacking
  z=0   original / infilled video item (and RAM infill preview pixmap)
  z=10  mask video item (default opacity 0.4)
  z=15  RAM mask preview pixmap
  z=20  annotation overlay (clicks, rects)
aspect-fit letterboxing, normalized annotation coordinates, tools:
positive click / negative click / rect drag, right-click deletes the
nearest point or rect.
"""
from __future__ import annotations

import numpy as np

from PySide6.QtCore import QPointF, QRectF, QSizeF, Qt, Signal
from PySide6.QtGui import QBrush, QColor, QImage, QPainter, QPen, QPixmap
from PySide6.QtMultimediaWidgets import QGraphicsVideoItem
from PySide6.QtWidgets import (
    QGraphicsItem, QGraphicsPixmapItem, QGraphicsScene, QGraphicsView,
)


def np_to_qpixmap(arr: np.ndarray) -> QPixmap:
    """uint8 gray / RGB / RGBA numpy -> QPixmap (reference :641-672)."""
    arr = np.ascontiguousarray(arr)
    h, w = arr.shape[:2]
    if arr.ndim == 2:
        img = QImage(arr.data, w, h, w, QImage.Format_Grayscale8)
    elif arr.shape[2] == 3:
        img = QImage(arr.data, w, h, 3 * w, QImage.Format_RGB888)
    elif arr.shape[2] == 4:
        img = QImage(arr.data, w, h, 4 * w, QImage.Format_RGBA8888)
    else:
        raise ValueError(f"unsupported array shape {arr.shape}")
    return QPixmap.fromImage(img.copy())


class OverlayItem(QGraphicsItem):
    """Annotation canvas: draws labeled green/red dots and cyan rects in
    normalized coords; emits add/delete requests through the view."""

    def __init__(self, view: "VideoView"):
        super().__init__()
        self.view = view
        self.setZValue(20)
        self.rect = QRectF(0, 0, 1, 1)
        self.tool = "pos"  # pos | neg | rect
        self.obj_id = 1
        self.clicks: list = []   # (x, y, obj, positive)
        self.rects: list = []    # (x, y, w, h, obj)
        self._drag_start = None
        self._drag_cur = None

    def boundingRect(self) -> QRectF:
        return self.rect

    def set_geometry(self, rect: QRectF):
        self.prepareGeometryChange()
        self.rect = rect
        self.update()

    # ---- painting -----------------------------------------------------
    def paint(self, p: QPainter, opt, widget=None):
        r = self.rect
        for (x, y, obj, positive) in self.clicks:
            cx, cy = r.x() + x * r.width(), r.y() + y * r.height()
            color = QColor(60, 220, 60) if positive else QColor(230, 60, 60)
            p.setPen(QPen(Qt.black, 1))
            p.setBrush(QBrush(color))
            p.drawEllipse(QPointF(cx, cy), 5, 5)
            p.setPen(QPen(Qt.white))
            p.drawText(QPointF(cx + 6, cy - 6), str(obj))
        pen = QPen(QColor(0, 220, 220), 2)
        p.setPen(pen)
        p.setBrush(Qt.NoBrush)
        for (x, y, w, h, obj) in self.rects:
            p.drawRect(QRectF(r.x() + x * r.width(), r.y() + y * r.height(),
                              w * r.width(), h * r.height()))
            p.drawText(QPointF(r.x() + x * r.width() + 4,
                               r.y() + y * r.height() + 14), str(obj))
        if self._drag_start and self._drag_cur:
            a, b = self._drag_start, self._drag_cur
            p.setPen(QPen(QColor(0, 220, 220), 1, Qt.DashLine))
            p.drawRect(QRectF(a, b).normalized())

    # ---- mouse tools --------------------------------------------------
    def _norm(self, pos: QPointF):
        r = self.rect
        if r.width() <= 0 or r.height() <= 0:
            return None
        x = (pos.x() - r.x()) / r.width()
        y = (pos.y() - r.y()) / r.height()
        if not (0.0 <= x <= 1.0 and 0.0 <= y <= 1.0):
            return None
        return x, y

    def mousePressEvent(self, ev):
        if ev.button() == Qt.RightButton:
            n = self._norm(ev.pos())
            if n:
                self.view.requestDelete.emit(n[0], n[1])
            return
        n = self._norm(ev.pos())
        if n is None:
            return
        if self.tool == "rect":
            self._drag_start = ev.pos()
            self._drag_cur = ev.pos()
        elif self.tool == "pos":
            self.view.addPositive.emit(n[0], n[1], self.obj_id)
        else:
            self.view.addNegative.emit(n[0], n[1], self.obj_id)

    def mouseMoveEvent(self, ev):
        if self._drag_start is not None:
            self._drag_cur = ev.pos()
            self.update()

    def mouseReleaseEvent(self, ev):
        if self._drag_start is not None:
            a = self._norm(self._drag_start)
            b = self._norm(ev.pos())
            self._drag_start = self._drag_cur = None
            self.update()
            if a and b:
                x1, y1 = min(a[0], b[0]), min(a[1], b[1])
                w, h = abs(a[0] - b[0]), abs(a[1] - b[1])
                if w > 0.002 and h > 0.002:
                    self.view.addRectangle.emit(x1, y1, w, h, self.obj_id)

    def set_annotations(self, clicks, rects):
        self.clicks = clicks
        self.rects = rects
        self.update()


class VideoView(QGraphicsView):
    addPositive = Signal(float, float, int)
    addNegative = Signal(float, float, int)
    addRectangle = Signal(float, float, float, float, int)
    requestDelete = Signal(float, float)

    def __init__(self, parent=None):
        super().__init__(parent)
        self.setScene(QGraphicsScene(self))
        self.setRenderHints(QPainter.Antialiasing |
                            QPainter.SmoothPixmapTransform)
        self.setBackgroundBrush(QColor(16, 16, 16))

        self.video_item = QGraphicsVideoItem()        # original (z=0)
        self.infill_item = QGraphicsVideoItem()       # infilled file (z=0)
        self.infill_preview = QGraphicsPixmapItem()   # RAM preview (z=0)
        self.mask_item = QGraphicsVideoItem()         # mask file (z=10)
        self.mask_preview = QGraphicsPixmapItem()     # RAM preview (z=15)
        self.overlay = OverlayItem(self)

        for item, z in [(self.video_item, 0), (self.infill_item, 0),
                        (self.infill_preview, 0), (self.mask_item, 10),
                        (self.mask_preview, 15), (self.overlay, 20)]:
            item.setZValue(z)
            self.scene().addItem(item)
        self.infill_item.setVisible(False)
        self.infill_preview.setVisible(False)
        self.mask_item.setOpacity(0.4)
        self.mask_preview.setVisible(False)

    # ---- layer controls (reference :300-326) -------------------------
    def set_base_visible(self, mode: str):
        """mode: 'original' | 'infilled'."""
        self.video_item.setVisible(mode == "original")
        self.infill_item.setVisible(mode == "infilled")

    def set_mask_visible(self, on: bool):
        self.mask_item.setVisible(on)

    def set_mask_opacity(self, opacity: float):
        self.mask_item.setOpacity(opacity)
        self.mask_preview.setOpacity(opacity)

    def show_mask_preview(self, arr: np.ndarray | None):
        if arr is None:
            self.mask_preview.setVisible(False)
            self.mask_item.setVisible(True)
            return
        self.mask_preview.setPixmap(np_to_qpixmap(arr))
        self._fit_item(self.mask_preview)
        self.mask_preview.setVisible(True)
        self.mask_item.setVisible(False)

    def show_infill_preview(self, arr: np.ndarray | None):
        if arr is None:
            self.infill_preview.setVisible(False)
            return
        self.infill_preview.setPixmap(np_to_qpixmap(arr))
        self._fit_item(self.infill_preview)
        self.infill_preview.setVisible(True)

    # ---- geometry -----------------------------------------------------
    def _video_rect(self) -> QRectF:
        return QRectF(self.video_item.pos(),
                      self.video_item.size()) if self.video_item.size() \
            .width() > 0 else QRectF(0, 0, 1, 1)

    def _fit_item(self, pix_item: QGraphicsPixmapItem):
        r = self._video_rect()
        pm = pix_item.pixmap()
        if pm.width() > 0:
            pix_item.setPos(r.topLeft())
            pix_item.setScale(r.width() / pm.width())

    def relayout(self):
        """Aspect-fit letterboxing (reference :363-388)."""
        vp = self.viewport().rect()
        self.scene().setSceneRect(QRectF(vp))
        size = self.video_item.nativeSize()
        if size.width() <= 0:
            return
        scale = min(vp.width() / size.width(), vp.height() / size.height())
        w, h = size.width() * scale, size.height() * scale
        x, y = (vp.width() - w) / 2, (vp.height() - h) / 2
        for item in (self.video_item, self.infill_item, self.mask_item):
            item.setPos(x, y)
            item.setSize(QSizeF(w, h))
        self.overlay.set_geometry(QRectF(x, y, w, h))
        self._fit_item(self.mask_preview)
        self._fit_item(self.infill_preview)

    def resizeEvent(self, ev):
        super().resizeEvent(ev)
        self.relayout()

    def grab_thumb_with_overlay(self, size=(96, 54)) -> QPixmap:
        """Offscreen thumbnail with annotations burned in (:391-476)."""
        pm = QPixmap(*size)
        pm.fill(QColor(0, 0, 0))
        p = QPainter(pm)
        self.render(p)
        p.end()
        return pm.scaled(*size, Qt.KeepAspectRatio, Qt.SmoothTransformation)
