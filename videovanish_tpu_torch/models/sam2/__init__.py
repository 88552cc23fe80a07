from videovanish_tpu_torch.models.sam2.predictor import (
    build_sam2_video_predictor,
)

__all__ = ["build_sam2_video_predictor"]
