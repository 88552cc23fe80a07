"""Parallelism of the port over torch.distributed: ring attention over the
frames of a clip (`ring_attention.py`). The mesh itself is `core/mesh.py`."""
from videovanish_tpu_torch.parallel.ring_attention import (
    SequenceShard, make_ring_attention, ring_attention,
    ring_attention_for_mesh, sequence_shard,
)

__all__ = ["SequenceShard", "make_ring_attention", "ring_attention",
           "ring_attention_for_mesh", "sequence_shard"]
