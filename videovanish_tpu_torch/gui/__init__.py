"""The interactive app (port of videovanish_tpu/gui).

`annotations.py`, `sync_logic.py` and `jobs.py` are plain Python and import
no Qt: the annotation model, the players' sync policy and the four jobs
the window runs (Generate Mask, Make Vanish and the two previews), so
scripts and tests drive the same code without PySide6. The window itself
(`app.py`, `main_window.py`, `dock.py`, `player.py`, `view.py`,
`worker.py`) needs PySide6; without it `cli/videovanish.py` stops with a
message that names the command-line pipelines.
"""
