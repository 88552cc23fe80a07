"""Qt application bootstrap (port of videovanish_tpu/gui/app.py): Fusion
style + dark palette (reference main(), videovanish.py:1752-1766)."""
from __future__ import annotations

import sys

from PySide6.QtGui import QColor, QPalette
from PySide6.QtWidgets import QApplication

from videovanish_tpu_torch.gui.main_window import MainWindow


def _dark_palette() -> QPalette:
    p = QPalette()
    bg = QColor(37, 37, 38)
    base = QColor(30, 30, 30)
    text = QColor(220, 220, 220)
    hl = QColor(42, 130, 218)
    p.setColor(QPalette.Window, bg)
    p.setColor(QPalette.WindowText, text)
    p.setColor(QPalette.Base, base)
    p.setColor(QPalette.AlternateBase, bg)
    p.setColor(QPalette.Text, text)
    p.setColor(QPalette.Button, bg)
    p.setColor(QPalette.ButtonText, text)
    p.setColor(QPalette.Highlight, hl)
    p.setColor(QPalette.HighlightedText, QColor(255, 255, 255))
    p.setColor(QPalette.ToolTipBase, base)
    p.setColor(QPalette.ToolTipText, text)
    return p


def run_app(color_video=None, mask_video=None, infilled_video=None,
            device: str = "cuda") -> int:
    app = QApplication(sys.argv[:1])
    app.setStyle("Fusion")
    app.setPalette(_dark_palette())
    win = MainWindow(color_video=color_video, mask_video=mask_video,
                     infilled_video=infilled_video, device=device)
    win.show()
    return app.exec()
