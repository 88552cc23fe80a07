from videovanish_tpu_torch.utils.observability import (
    collect_stages, get_logger, record_stage, stage_timer, start_profile,
    stop_profile, trace_annotation,
)

__all__ = ["collect_stages", "get_logger", "record_stage", "stage_timer",
           "start_profile", "stop_profile", "trace_annotation"]
