"""Tools dock (port of videovanish_tpu/gui/dock.py) — behavior parity
with the reference SideDock (videovanish.py:1151-1284): object selector
with dynamic "Add Object" (1-based ids), tool radio buttons, file-open
buttons, view mode (Original/Infilled), mask overlay checkbox + opacity
slider 0-100, infill settings (Resolution 64-4096 step 64 default 960;
Dilation 0-25 default 8; "Preserve unmasked resolution" default on), and
the four action buttons."""
from __future__ import annotations

from PySide6.QtCore import Qt, Signal
from PySide6.QtWidgets import (
    QCheckBox, QComboBox, QDockWidget, QFormLayout, QGroupBox, QLabel,
    QPushButton, QRadioButton, QSlider, QSpinBox, QVBoxLayout, QWidget,
)


class SideDock(QDockWidget):
    toolChanged = Signal(str)            # pos | neg | rect
    objChanged = Signal(int)
    viewModeChanged = Signal(str)        # original | infilled
    maskVisibleChanged = Signal(bool)
    maskOpacityChanged = Signal(float)
    openColor = Signal()
    openMask = Signal()
    openInfilled = Signal()
    generateMask = Signal()
    previewMask = Signal()
    makeVanish = Signal()
    previewInfill = Signal()

    def __init__(self, parent=None):
        super().__init__("Tools", parent)
        w = QWidget(self)
        lay = QVBoxLayout(w)

        # --- object selector (dynamic "Add Object", 1-based) ---
        self.obj_combo = QComboBox()
        self.obj_combo.addItem("Object 1", 1)
        self.obj_combo.addItem("Add Object…", -1)
        self.obj_combo.currentIndexChanged.connect(self._on_obj)
        lay.addWidget(QLabel("Object"))
        lay.addWidget(self.obj_combo)

        # --- tools ---
        tools_box = QGroupBox("Tool")
        tl = QVBoxLayout(tools_box)
        self.rb_pos = QRadioButton("Positive point")
        self.rb_neg = QRadioButton("Negative point")
        self.rb_rect = QRadioButton("Rectangle")
        self.rb_pos.setChecked(True)
        for rb, name in ((self.rb_pos, "pos"), (self.rb_neg, "neg"),
                         (self.rb_rect, "rect")):
            rb.toggled.connect(
                lambda on, n=name: on and self.toolChanged.emit(n))
            tl.addWidget(rb)
        lay.addWidget(tools_box)

        # --- file buttons ---
        self.btn_open_color = QPushButton("Open Color Video…")
        self.btn_open_mask = QPushButton("Open Mask Video…")
        self.btn_open_infilled = QPushButton("Open Infilled Video…")
        self.btn_open_color.clicked.connect(self.openColor)
        self.btn_open_mask.clicked.connect(self.openMask)
        self.btn_open_infilled.clicked.connect(self.openInfilled)
        for b in (self.btn_open_color, self.btn_open_mask,
                  self.btn_open_infilled):
            lay.addWidget(b)

        # --- view mode + mask overlay ---
        view_box = QGroupBox("View")
        vl = QFormLayout(view_box)
        self.view_combo = QComboBox()
        self.view_combo.addItems(["Original", "Infilled"])
        self.view_combo.currentTextChanged.connect(
            lambda t: self.viewModeChanged.emit(t.lower()))
        vl.addRow("Base", self.view_combo)
        self.mask_check = QCheckBox("Show mask overlay")
        self.mask_check.setChecked(True)
        self.mask_check.toggled.connect(self.maskVisibleChanged)
        vl.addRow(self.mask_check)
        self.opacity = QSlider(Qt.Horizontal)
        self.opacity.setRange(0, 100)
        self.opacity.setValue(40)
        self.opacity.valueChanged.connect(
            lambda v: self.maskOpacityChanged.emit(v / 100.0))
        vl.addRow("Mask opacity", self.opacity)
        lay.addWidget(view_box)

        # --- infill settings (reference defaults :1212-1231) ---
        set_box = QGroupBox("Infill settings")
        fl = QFormLayout(set_box)
        self.resolution = QSpinBox()
        self.resolution.setRange(64, 4096)
        self.resolution.setSingleStep(64)
        self.resolution.setValue(960)
        fl.addRow("Resolution", self.resolution)
        self.dilation = QSpinBox()
        self.dilation.setRange(0, 25)
        self.dilation.setValue(8)
        fl.addRow("Dilation", self.dilation)
        self.preserve = QCheckBox("Preserve unmasked resolution")
        self.preserve.setChecked(True)
        fl.addRow(self.preserve)
        lay.addWidget(set_box)

        # --- actions ---
        self.btn_gen_mask = QPushButton("Generate Mask")
        self.btn_prev_mask = QPushButton("Preview Mask")
        self.btn_vanish = QPushButton("Make Vanish")
        self.btn_prev_infill = QPushButton("Preview Infill")
        self.btn_gen_mask.clicked.connect(self.generateMask)
        self.btn_prev_mask.clicked.connect(self.previewMask)
        self.btn_vanish.clicked.connect(self.makeVanish)
        self.btn_prev_infill.clicked.connect(self.previewInfill)
        for b in (self.btn_gen_mask, self.btn_prev_mask, self.btn_vanish,
                  self.btn_prev_infill):
            lay.addWidget(b)

        lay.addStretch(1)
        self.setWidget(w)

    def _on_obj(self, idx: int):
        val = self.obj_combo.itemData(idx)
        if val == -1:  # "Add Object…": create the next 1-based id
            new_id = self.obj_combo.count()  # ids occupy [0, count-2]
            self.obj_combo.insertItem(self.obj_combo.count() - 1,
                                      f"Object {new_id}", new_id)
            self.obj_combo.setCurrentIndex(self.obj_combo.count() - 2)
            return
        self.objChanged.emit(int(val))
