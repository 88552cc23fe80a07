"""The port's multi-rank path on the CPU: torch.distributed over gloo, one
spawned process a rank (`torch_ranks.py`), held against the JAX package on
its 8 virtual devices and against the port's own single-device runs.

- the pure mesh functions against the JAX ones, errors included, and
  initialize_distributed as a no-op in one process;
- ring attention on 2 and 4 data ranks and a 2x2 mesh against the JAX
  package's make_ring_attention and dense attention (atol 2e-5);
- a MotionModule with JAX weights, its clips' frames split over 2 and 4
  ranks, against the unsharded JAX module (1e-4 of its max): the GroupNorm
  statistics summed over the ranks, the positional embedding's global
  frame indices and the ring;
- the tiny config on 2 ranks against one device: DiffuEraser.forward
  within 1 u8, the UNet with the ring within 2e-3, Propainter.forward's
  float prior (its windows split by reference count) and the flow
  completion network on 20 frames (the encoder's halo inside the clip)
  within 1e-5 of their max;
- run_infill_on_frames on 2 ranks at the JAX dry run's input, config and
  seeded weights, against the golden the JAX package froze from its
  single-device run, under the dry run's bounds; VV_MESH=0, the clip
  length rounded up to the data axis, the chunked driver writing one
  file from rank 0, and the sharding trace (each of the five programs
  received a "data" block; no record without a sink).
"""
import dataclasses
import os
import pickle
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
import torch_ranks as R
from test_torch_modules import _init, _load, _nchw, _nhwc
from torch_threads import one_torch_thread  # noqa: F401
from videovanish_tpu.config import dryrun_config
from videovanish_tpu.core import mesh as jmesh
from videovanish_tpu.models.diffueraser import temporal as jt
from videovanish_tpu.parallel.ring_attention import make_ring_attention
from videovanish_tpu_torch.config import (
    DiffuEraserConfig, ProPainterConfig, VVConfig,
)
from videovanish_tpu_torch.core import mesh as pmesh
from videovanish_tpu_torch.models.diffueraser import temporal as pt

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "golden", "dryrun_pipeline.npz")


def _dense(q, k, v):
    s = np.einsum("bhqd,bhkd->bhqk", q, k) * (q.shape[-1] ** -0.5)
    p = np.exp(s - s.max(-1, keepdims=True))
    return np.einsum("bhqk,bhkd->bhqd", p / p.sum(-1, keepdims=True), v)


def _same(fj, fp, *args):
    """fj(*args) and fp(*args) return the same value, or both raise
    ValueError with the same message up to its first colon (the reason
    after it names the TPU's links in the JAX package)."""
    try:
        want = fj(*args)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            fp(*args)
        assert str(got.value).split(":")[0] == str(e).split(":")[0]
        return
    assert fp(*args) == want


def test_mesh_functions_match_jax(monkeypatch):
    for n in range(1, 9):
        for mp in (-1, 0, 1, 2, 3, 4, 8):
            _same(jmesh.mesh_shape_for, pmesh.mesh_shape_for, n, mp)
    for slices in (1, 2, 4):
        for per in (1, 2, 4, 6, 8):
            for mp in (1, 2, 4, 8):
                _same(jmesh.plan_hybrid_mesh, pmesh.plan_hybrid_mesh,
                              slices, per, mp)
    for var in ("VV_COORDINATOR", "VV_NUM_PROCESSES", "WORLD_SIZE", "RANK",
                "MASTER_ADDR"):
        monkeypatch.delenv(var, raising=False)
    assert pmesh.initialize_distributed() is False
    assert pmesh.initialize_distributed(num_processes=1) is False
    assert pmesh.data_coords(None) == (0, 1)
    assert pmesh.frame_block(7, None) == (0, 7)


def test_ring_attention_matches_jax_and_dense(tmp_path):
    rng = np.random.default_rng(0)
    cases = [tuple(rng.standard_normal((2, H, S, 16)).astype(np.float32)
                   for _ in range(3)) for H, S in ((3, 16), (3, 64), (4, 16))]
    # (data, model) = (2, 1) on two ranks, (4, 1) and (2, 2) on four
    for world, models in ((2, (1,)), (4, (1, 2))):
        ranks = R.run_ranks(R.ring_cases, world, tmp_path, models, cases)
        for m, model in enumerate(models):
            data = world // model
            jring = make_ring_attention(jmesh.make_mesh(
                jax.devices()[:world], model_parallel=model))
            for refused, hybrid, _ in (r[m] for r in ranks):
                assert refused
                assert hybrid == {"data": data, "model": model}
            for (q, k, v), *per_rank in zip(cases, *(r[m][2] for r in ranks)):
                dense = _dense(q, k, v)
                want = np.asarray(jring(*(jnp.asarray(a) for a in (q, k, v))))
                np.testing.assert_allclose(want, dense, atol=2e-5)
                for full, local in per_rank:  # every rank returns the whole
                    np.testing.assert_allclose(full, want, atol=2e-5)
                    np.testing.assert_allclose(full, dense, atol=2e-5)
                    # ring_attention_for_mesh: heads split over "model" on
                    # the 2x2 mesh when H divides by it (H = 4)
                    np.testing.assert_allclose(local, dense, atol=2e-5)


def test_motion_module_sharded_matches_jax(tmp_path):
    T, B = 8, 2
    rng = np.random.default_rng(1)
    x = rng.standard_normal((B * T, 4, 3, 64)).astype(np.float32)
    jm = jt.MotionModule(8)
    params = _init(jm, jnp.asarray(x), T, seed=5)
    ref = np.asarray(jm.apply({"params": params}, jnp.asarray(x), T))
    state = _load(pt.MotionModule(64, 8), params).state_dict()
    for world in (2, 4):
        for got in R.run_ranks(R.motion_module, world, tmp_path, state,
                               _nchw(x).numpy(), T, 8):
            np.testing.assert_allclose(
                _nhwc(torch.from_numpy(got)), ref,
                atol=1e-4 * np.abs(ref).max())


def test_sharded_models_match_single_device(tmp_path):
    rng = np.random.default_rng(2)
    T, H, W = 8, 64, 64
    frames = rng.integers(0, 255, (T, H, W, 3), np.uint8)
    masks = np.zeros((T, H, W), np.uint8)
    masks[:, 24:40, 20:44] = 255
    prior = rng.integers(0, 255, (T, H, W, 3), np.uint8)
    t0 = time.perf_counter()
    ranks = R.run_ranks(R.sharded_models, 2, tmp_path, frames, masks, prior)
    print(f"2 ranks: {time.perf_counter() - t0:.1f} s")
    r0 = ranks[0]
    assert r0["windows_mesh"] == {"sharded": 1, "whole": 0}
    assert r0["windows_single"] == {"sharded": 0, "whole": 1}
    d = np.abs(r0["forward_mesh"].astype(int)
               - r0["forward_single"].astype(int))
    assert d.max() <= 1
    np.testing.assert_allclose(r0["unet_mesh"], r0["unet_single"], atol=2e-3)
    (u8_m, f_m), (u8_s, f_s) = r0["prior_mesh"], r0["prior_single"]
    np.testing.assert_allclose(f_m, f_s, atol=1e-5 * np.abs(f_s).max())
    assert np.abs(u8_m.astype(int) - u8_s.astype(int)).max() <= 1
    np.testing.assert_allclose(
        r0["flows_mesh"], r0["flows_single"],
        atol=1e-5 * np.abs(r0["flows_single"]).max())
    for key in ("forward_mesh", "unet_mesh"):  # every rank has the whole
        np.testing.assert_array_equal(ranks[1][key], r0[key])
    np.testing.assert_array_equal(ranks[1]["prior_mesh"][1], f_m)


# the JAX package's seeded init at dryrun_config, each model in a process of
# its own while the ranks start: DiffuEraser's constructor as the dry run
# calls it (with the noise its forward draws for 8 frames of 8x8 latents),
# Propainter's `_init_params` under jax.jit, which compiles it once in
# place of one compile per eager op. XLA compiles at optimization level 0
# there, which cuts the compiles several times over on the CPU; the
# weights then differ from the default build's by float rounding (up to
# about 1e-7 measured), far below the golden's bounds.
_JAX_INIT = """
import os, pickle, sys, time
import jax, jax.numpy as jnp, numpy as np
jax.config.update("jax_platforms", "cpu")
from videovanish_tpu.config import dryrun_config
from videovanish_tpu.models.diffueraser import DiffuEraser
from videovanish_tpu.models.propainter import Propainter
t0 = time.perf_counter()
cfg = dryrun_config()
if sys.argv[1] == "diffueraser":
    params = DiffuEraser(config=cfg.diffueraser, seed=0).params
    key = jax.random.PRNGKey(0)
    extra = jax.vmap(lambda i: jax.random.normal(
        jax.random.fold_in(key, i), (8, 8, 4), jnp.float32))(jnp.arange(8))
else:
    pp = Propainter(config=cfg.propainter, params={})
    params = jax.jit(pp._init_params, static_argnums=0)(0)
    extra = None
tree = jax.tree_util.tree_map(np.asarray, (params, extra))
with open(sys.argv[2] + ".tmp", "wb") as f:
    pickle.dump(tree, f)
os.replace(sys.argv[2] + ".tmp", sys.argv[2])
print(f"{time.perf_counter() - t0:.1f}")
"""


def _port_dryrun_config() -> VVConfig:
    """The JAX dryrun_config's DiffuEraser and Propainter fields in the
    port's config (checkpoint paths aside)."""
    j = dryrun_config()

    def carry(cls, src):
        return cls(**{f.name: getattr(src, f.name)
                      for f in dataclasses.fields(cls)
                      if "checkpoint" not in f.name})
    return VVConfig(diffueraser=carry(DiffuEraserConfig, j.diffueraser),
                    propainter=carry(ProPainterConfig, j.propainter))


@pytest.fixture
def jax_dryrun_weights(tmp_path_factory):
    """Starts the JAX package's seeded init at dryrun_config (_JAX_INIT)
    in two processes and yields {model: the pickle each writes}, while
    the ranks start and run their first checks; the teardown prints each
    init's seconds and requires both to have succeeded."""
    root = tmp_path_factory.mktemp("jax_init")
    env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS=(
        "--xla_backend_optimization_level=0 "
        "--xla_llvm_disable_expensive_passes=true"))
    weights = {m: str(root / f"{m}.pkl") for m in ("diffueraser",
                                                   "propainter")}
    procs = {m: subprocess.Popen(
        [sys.executable, "-c", _JAX_INIT, m, path], env=env, cwd=ROOT,
        stdout=subprocess.PIPE, text=True) for m, path in weights.items()}
    try:
        yield weights
    finally:
        for m, proc in procs.items():
            stdout, _ = proc.communicate(timeout=300)
            assert proc.returncode == 0, f"JAX init of {m} failed"
            print(f"JAX seeded init of {m} at dryrun_config: "
                  f"{stdout.strip()} s")


def test_pipeline_on_two_ranks_matches_dryrun_golden(tmp_path,
                                                     jax_dryrun_weights):
    from videovanish_tpu_torch.video.io import write_video_frames_to_path
    frames, masks = graft._dryrun_pipeline_input(8)
    video = tmp_path / "videos"
    video.mkdir()
    color, mask = str(video / "color.mkv"), str(video / "mask.mkv")
    write_video_frames_to_path(color, frames, 24.0, 64, 64)
    write_video_frames_to_path(mask, masks, 24.0, 64, 64)
    out = str(tmp_path / "out" / "vanished.mkv")
    os.makedirs(os.path.dirname(out))
    t0 = time.perf_counter()
    ranks = R.run_ranks(R.dryrun_pipeline, 2, tmp_path, _port_dryrun_config(),
                        jax_dryrun_weights, frames, masks, (color, mask, out),
                        timeout=240.0)
    print(f"2 ranks: {time.perf_counter() - t0:.1f} s")

    for r in ranks:
        assert r["no_mesh_under_vv_mesh_0"]
        assert r["clip_rounded"] == 8
        assert r["windows"] == {"sharded": 1, "whole": 0}
        # the sharding trace: every program received a block split over
        # "data" (tests/test_infill_spmd.py's assertion of the JAX run);
        # nothing is recorded without a sink
        assert r["recorded_without_sink"] == 0
        assert r["sharded_programs"] == sorted([
            "vae_encode", "vae_decode", "denoise_window",
            "propainter_stage1", "propainter_window"]), r["sharded_programs"]
    assert [r["writer"] for r in ranks] == [True, False]
    got = ranks[0]["frames"]
    np.testing.assert_array_equal(ranks[1]["frames"], got)

    # the JAX dry run's gate (__graft_entry__.dryrun_multichip)
    g = np.load(GOLDEN)
    assert str(g["fingerprint"]) == graft._dryrun_fingerprint(
        dryrun_config())
    d = np.abs(got.astype(int) - g["frames"].astype(int))
    inside = np.stack(masks)[..., 0] > 0
    ys, xs = np.nonzero(inside[0])
    pad = 8
    box = np.zeros_like(inside)
    box[:, max(ys.min() - pad, 0):ys.max() + pad + 1,
        max(xs.min() - pad, 0):xs.max() + pad + 1] = True
    assert d[~box].max() <= 1
    assert d[box].mean() <= 2.0 and d[box].max() <= 64

    # the chunked driver on the same ranks: one file, by rank 0
    assert os.listdir(os.path.dirname(out)) == ["vanished.mkv"]
    assert ranks[0]["chunked_frames"] == 8
