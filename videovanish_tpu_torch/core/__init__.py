from videovanish_tpu_torch.core.prog import (
    CancelledError, ProgressFn, check_cancel, null_prog, scale_prog,
)

__all__ = ["CancelledError", "ProgressFn", "check_cancel", "null_prog",
           "scale_prog"]
