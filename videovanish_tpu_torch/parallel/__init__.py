"""Parallelism of the port over torch.distributed: ring attention over the
frames of a clip (`ring_attention.py`) and the trainer's tensor parallelism
over "model" with its sharding rules (`sharding.py`). The mesh itself is
`core/mesh.py`."""
from videovanish_tpu_torch.parallel.ring_attention import (
    SequenceShard, make_ring_attention, ring_attention,
    ring_attention_for_mesh, sequence_shard,
)
from videovanish_tpu_torch.parallel.sharding import (
    ModelShard, batch_block, copy_to_model, gather_state_dict, join_shards,
    model_shard, row_linear, shard_module_, shard_state_dict, shard_tensor,
    split_dim,
)

__all__ = ["ModelShard", "SequenceShard", "batch_block", "copy_to_model",
           "gather_state_dict", "join_shards", "make_ring_attention",
           "model_shard", "ring_attention", "ring_attention_for_mesh",
           "row_linear", "sequence_shard", "shard_module_",
           "shard_state_dict", "shard_tensor", "split_dim"]
