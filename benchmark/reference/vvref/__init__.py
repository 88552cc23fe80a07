"""A frozen copy of the port's model and op code (videovanish_tpu_torch,
at the commit that added this benchmark), with plain f32 attention and no
kernels, mesh, tracing or checkpoint files: the plain reference that
decides each cell's `correct`. It imports nothing of the port and must not
change when the port changes."""
