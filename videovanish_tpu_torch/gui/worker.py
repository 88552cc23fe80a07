"""Background job system (port of videovanish_tpu/gui/worker.py): one
QThread worker at a time with progress / cancel / error-dialog semantics
matching the reference's Worker + ProgressDialog (videovanish.py:75-133,
1355-1397): jobs are callables `job(report, is_canceled)` (gui/jobs.py);
report(pct, status) marshals to the GUI thread via signals; cancel is
cooperative."""
from __future__ import annotations

import traceback

from PySide6.QtCore import QThread, Signal
from PySide6.QtWidgets import (
    QDialog, QLabel, QProgressBar, QPushButton, QVBoxLayout,
)


class Worker(QThread):
    progressed = Signal(float, str)
    finished_ok = Signal(object)
    failed = Signal(str)

    def __init__(self, job, parent=None):
        super().__init__(parent)
        self._job = job
        self._cancel = False

    def request_cancel(self):
        self._cancel = True

    def is_canceled(self) -> bool:
        return self._cancel

    def run(self):
        try:
            def report(pct, status="", **kw):
                self.progressed.emit(float(pct), str(status))

            result = self._job(report, self.is_canceled)
            self.finished_ok.emit(result)
        except Exception:
            self.failed.emit(traceback.format_exc())


class ProgressDialog(QDialog):
    def __init__(self, title: str, parent=None):
        super().__init__(parent)
        self.setWindowTitle(title)
        self.setModal(True)
        lay = QVBoxLayout(self)
        self.label = QLabel("Starting…")
        self.bar = QProgressBar()
        self.bar.setRange(0, 100)
        self.cancel_btn = QPushButton("Cancel")
        lay.addWidget(self.label)
        lay.addWidget(self.bar)
        lay.addWidget(self.cancel_btn)

    def on_progress(self, pct: float, status: str):
        self.bar.setValue(int(pct))
        if status:
            self.label.setText(status)
