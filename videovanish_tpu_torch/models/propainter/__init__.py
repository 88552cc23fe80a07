"""ProPainter: RAFT, recurrent flow completion, image propagation and the InpaintGenerator."""
