from videovanish_tpu_torch.video.io import (
    load_video_frames_from_path,
    probe_video,
    write_video_frames_to_path,
)

__all__ = ["load_video_frames_from_path", "probe_video",
           "write_video_frames_to_path"]
