"""The port's run_infill_on_frames against the JAX package's with both
reuse approximations off (brushnet_feature_reuse, spatial_attn_reuse): the
exact per-step path. Same geometry, weights, noise and gates as
tests/test_torch_infill.py, in a file of its own to keep each file's run
short."""
from tests.test_torch_infill import check_pipeline_matches_jax, shared  # noqa: F401
from torch_threads import one_torch_thread  # noqa: F401


def test_pipeline_matches_jax_reuse_off(shared):  # noqa: F811
    check_pipeline_matches_jax(shared, brushnet_feature_reuse=False,
                               spatial_attn_reuse=False)
