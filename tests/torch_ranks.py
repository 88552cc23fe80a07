"""Several CPU ranks for the port's multi-rank tests.

`run_ranks(fn, world, tmp_path, *args)` spawns `world` processes; each
joins a gloo process group through a FileStore under tmp_path, runs at one
torch thread, calls fn(*args) and hands its return value back, so the test
gets every rank's result in rank order. A rank that raises fails the call,
and so does a run that outlives `timeout` (its processes are killed).

The functions the ranks run are here, at module level, so that a spawned
process imports them with torch and the port alone, never JAX.
"""
from __future__ import annotations

import os
import pickle
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _entry(rank, world, root, fn, args):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(
        os.path.join(root, "store"), world), world_size=world, rank=rank)
    try:
        result = fn(*args)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(root, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(result, f)


def run_ranks(fn, world: int, tmp_path, *args, timeout: float = 120.0):
    """[fn(*args) on rank r for r in range(world)], each rank a process of
    a gloo world."""
    root = tempfile.mkdtemp(dir=tmp_path)
    ctx = mp.start_processes(_entry, args=(world, root, fn, args),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    while not ctx.join(timeout=1.0):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"{world} ranks of {fn.__name__} still "
                               f"running after {timeout} s")
    out = []
    for r in range(world):
        with open(os.path.join(root, f"rank{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))  # written by the ranks above
    return out


def _mesh(model: int = 1):
    from videovanish_tpu_torch.core.mesh import make_mesh
    return make_mesh("cpu", model_parallel=model)


def _clip_block(x, T, index, size):
    """Frames [index * T/size, (index + 1) * T/size) of each clip of a
    (B*T, ...) tensor, as (B*T/size, ...)."""
    t = T // size
    return x.reshape(-1, T, *x.shape[1:])[:, index * t:(index + 1) * t] \
        .reshape(-1, *x.shape[1:])


def _gather_clips(local, T, group):
    """The inverse of _clip_block over every rank of `group`."""
    from videovanish_tpu_torch.core.mesh import all_gather_cat
    parts = all_gather_cat(local[None], group)    # (size, B*t, ...)
    size = parts.shape[0]
    B = local.shape[0] * size // T
    parts = parts.reshape(size, B, T // size, *local.shape[1:])
    return parts.transpose(0, 1).reshape(B * T, *local.shape[1:])


# ---------------------------------------------------------------------------
# what the ranks run
# ---------------------------------------------------------------------------
def ring_cases(models, cases):
    """For each model-axis size of `models`, a mesh over every rank:
    (whether a mesh on CUDA tensors over gloo was refused, the shape of
    the hybrid mesh over two "nodes", [per case: make_ring_attention on
    (q, k, v), and ring_attention_for_mesh on this rank's sequence blocks,
    gathered]) for every (q, k, v) of `cases`."""
    from videovanish_tpu_torch.core.mesh import (
        DATA_AXIS, all_gather_cat, make_hybrid_mesh, make_mesh,
    )
    from videovanish_tpu_torch.parallel import (
        make_ring_attention, ring_attention_for_mesh,
    )
    results = []
    for model in models:
        try:  # CUDA tensors travel over NCCL only, never through gloo
            make_mesh("cuda", model_parallel=model)
            cuda_refused = False
        except ValueError:
            cuda_refused = True
        mesh = _mesh(model)
        hybrid = make_hybrid_mesh(2, model, "cpu")  # two "nodes"
        hybrid = dict(zip(hybrid.mesh_dim_names, hybrid.shape))
        full = make_ring_attention(mesh)
        per_rank = ring_attention_for_mesh(mesh)
        i, n = mesh.get_local_rank(DATA_AXIS), mesh[DATA_AXIS].size()
        out = []
        for q, k, v in cases:
            q, k, v = (torch.from_numpy(a) for a in (q, k, v))
            blk = slice(i * q.shape[2] // n, (i + 1) * q.shape[2] // n)
            local = per_rank(q[:, :, blk], k[:, :, blk], v[:, :, blk])
            out.append((full(q, k, v).numpy(),
                        all_gather_cat(local, mesh.get_group(DATA_AXIS),
                                       dim=2).numpy()))
        results.append((cuda_refused, hybrid, out))
    return results


def motion_module(state, x, T, heads):
    """A port MotionModule with `state` on this rank's block of each
    clip's frames of x (B*T, C, H, W); the gathered output."""
    from videovanish_tpu_torch.models.diffueraser.temporal import MotionModule
    from videovanish_tpu_torch.parallel import sequence_shard
    mesh = _mesh()
    shard = sequence_shard(mesh)
    mm = MotionModule(x.shape[1], heads)
    mm.load_state_dict(state)
    with torch.inference_mode():
        y = mm(_clip_block(torch.from_numpy(x), T, shard.index, shard.size),
               T, shard)
    return _gather_clips(y, T, shard.group).numpy()


def sharded_models(frames, masks, prior):
    """Tiny config, every rank: DiffuEraser.forward, Propainter.forward's
    float prior, the flow completion network and the UNet with the ring on
    a mesh over every rank; rank 0 also runs each on one device with the
    same weights."""
    from videovanish_tpu_torch.config import tiny_config
    from videovanish_tpu_torch.models.diffueraser.model import DiffuEraser
    from videovanish_tpu_torch.models.propainter.model import Propainter
    from videovanish_tpu_torch.parallel import sequence_shard
    cfg = tiny_config()
    mesh = _mesh()
    shard = sequence_shard(mesh)
    out = {}
    runs = [("mesh", mesh)] + ([("single", None)] if shard.index == 0 else [])
    with torch.inference_mode():
        for name, m in runs:
            de = DiffuEraser(config=cfg.diffueraser, device="cpu", seed=1,
                             mesh=m)
            out[f"forward_{name}"] = de.forward(
                frames, masks, prior, max_img_size=64).numpy()
            out[f"windows_{name}"] = dict(de.window_split)

            pp = Propainter(config=cfg.propainter, device="cpu", seed=2,
                            mesh=m)
            floats = []
            pp.stage_hook = lambda stage, *o: floats.append(o[0]) \
                if stage == "generator" else None
            p = cfg.propainter
            out[f"prior_{name}"] = (pp.forward(
                frames, masks, ref_stride=p.ref_stride,
                neighbor_length=p.neighbor_length,
                subvideo_length=p.subvideo_length,
                return_device=True).numpy(), torch.cat(floats).numpy())

        # the flow completion network alone on 20 frames: each rank's
        # block of 10 is widened by the encoder's 8-frame halo inside the
        # clip
        x = torch.randn(20, 2, 32, 32, generator=torch.Generator()
                        .manual_seed(4))
        m = (x[:, :1] > 0.5).float()
        out["flows_mesh"] = pp.flow_comp(x, m, mesh).numpy()
        if shard.index == 0:
            out["flows_single"] = pp.flow_comp(x, m).numpy()

        # the UNet alone: 8 frames of 8x8 latents
        T = 8
        g = torch.Generator().manual_seed(3)
        x = torch.randn(T, 4, 8, 8, generator=g)
        txt = torch.randn(T, 77, cfg.diffueraser.cross_attention_dim,
                          generator=g)
        t = torch.full((T,), 500)
        unet = de.unet
        blk = slice(shard.index * T // shard.size,
                    (shard.index + 1) * T // shard.size)
        ring = unet(x[blk], t[blk], txt[blk], T, shard=shard)
        out["unet_mesh"] = _gather_clips(ring, T, shard.group).numpy()
        if shard.index == 0:
            out["unet_single"] = unet(x, t, txt, T).numpy()
    return out


def _wait_for(path: str, timeout: float = 200.0):
    """The pickle at `path` once its writer has renamed it into place."""
    deadline = time.monotonic() + timeout
    while not os.path.exists(path):
        if time.monotonic() > deadline:
            raise TimeoutError(f"{path} not written in {timeout} s")
        time.sleep(0.2)
    with open(path, "rb") as f:
        return pickle.load(f)  # written by the test's own JAX process


def dryrun_pipeline(cfg, weights, frames, masks, files):
    """On every rank: the mesh policy (VV_MESH=0, the clip length rounded
    up to the data axis); the chunked driver over `files` (color, mask,
    out) on the mesh with seeded weights; then, once the JAX package's
    weights are in the pickles `weights` names, run_infill_on_frames at
    the JAX dry run's config with those weights and its noise, under a
    sharding trace (the programs that received a block split over "data")."""
    import dataclasses

    from videovanish_tpu_torch.core.mesh import is_writer
    from videovanish_tpu_torch.models.diffueraser.model import DiffuEraser
    from videovanish_tpu_torch.models.propainter.model import Propainter
    from videovanish_tpu_torch.pipeline import chunking, infill
    from videovanish_tpu_torch.video.io import probe_video

    out = {"writer": is_writer()}
    os.environ["VV_MESH"] = "0"
    infill.set_config(cfg)
    out["no_mesh_under_vv_mesh_0"] = infill._get_mesh("cpu") is None
    del os.environ["VV_MESH"]
    infill.set_config(dataclasses.replace(cfg, diffueraser=dataclasses.replace(
        cfg.diffueraser, clip_length=7)))
    out["clip_rounded"] = infill.get_model("2-Step", "cpu").cfg.clip_length

    infill.set_config(cfg)
    color, mask, path = files
    chunking.vanish_video_chunked(color, mask, path, chunk_frames=6,
                                  overlap_frames=2, mask_dilation_iter=2,
                                  max_img_size=64, device="cpu")
    out["chunked_frames"] = probe_video(path)[0]

    # without a sink, record_sharding records nothing
    from videovanish_tpu_torch.utils import observability as obs
    probe = []
    obs.trace_shardings(probe)
    obs.trace_shardings(None)
    obs.record_sharding("vae_encode", frames=torch.zeros(1))
    out["recorded_without_sink"] = len(probe)

    de_params, noise = _wait_for(weights["diffueraser"])
    pp_params, _ = _wait_for(weights["propainter"])
    mesh = infill._get_mesh("cpu")

    def jax_noise(idx, shape):
        return torch.from_numpy(noise[idx.start:idx.stop])

    infill.video_inpainting_sd = DiffuEraser(
        config=cfg.diffueraser, params=de_params, device="cpu",
        noise=jax_noise, mesh=mesh)
    infill.last_ckpt = "2-Step"
    infill.propainter = Propainter(config=cfg.propainter, params=pp_params,
                                   device="cpu", mesh=mesh)
    trace = []
    obs.trace_shardings(trace)
    try:
        out["frames"] = np.stack(infill.run_infill_on_frames(
            frames, masks, mask_dilation_iter=2, max_img_size=64,
            device="cpu"))
    finally:
        obs.trace_shardings(None)
    # the programs that received an operand split over "data"
    out["sharded_programs"] = sorted({
        prog for prog, specs in trace
        if any(s and s[0] == "data" for s in specs.values())})
    out["windows"] = dict(infill.video_inpainting_sd.window_split)
    return out


# ---------------------------------------------------------------------------
# the trainer on a mesh
# ---------------------------------------------------------------------------
def _tiny_trainer(dims, mesh, params, remat=False):
    """A trainer of the tiny UNet and BrushNet (dims = (channels, layers,
    heads, context width)) on `mesh` (or one device), at `params`."""
    from videovanish_tpu_torch.models.diffueraser.brushnet import (
        BrushNetModel,
    )
    from videovanish_tpu_torch.models.diffueraser.unet import UNetCondition
    from videovanish_tpu_torch.train import make_train_step
    ch, layers, heads, ctx = dims
    init_fn, step_fn = make_train_step(
        UNetCondition(4, 4, ch, layers, heads, ctx),
        BrushNetModel(9, ch, layers, heads, ctx), mesh, remat=remat,
        device="cpu")
    return init_fn(params), step_fn


def _whole_state(state, mesh) -> dict:
    """The state's params, mu and nu gathered to whole numpy arrays (a
    collective: every rank of the mesh calls it)."""
    from videovanish_tpu_torch.parallel import gather_state_dict
    trees = {"params": state.params, "mu": state.opt_state["mu"],
             "nu": state.opt_state["nu"]}
    return {slot: {m: {k: v.detach().numpy().copy() for k, v in
                       gather_state_dict(tree[m], mesh).items()}
                   for m in tree}
            for slot, tree in trees.items()}


def _replicated_differ(state, mesh) -> list:
    """The replicated tensors (params, mu, nu) that differ anywhere between
    the ranks of this rank's "model" group: their keys."""
    from videovanish_tpu_torch.core.mesh import MODEL_AXIS, all_gather_cat
    from videovanish_tpu_torch.parallel import split_dim
    group = mesh.get_group(MODEL_AXIS)
    bad = []
    for slot, tree in (("params", state.params),
                       ("mu", state.opt_state["mu"]),
                       ("nu", state.opt_state["nu"])):
        for m in tree:
            for k, v in tree[m].items():
                if split_dim(k, v.ndim) is not None:
                    continue
                every = all_gather_cat(v.detach()[None], group)
                if not all(torch.equal(every[0], e) for e in every[1:]):
                    bad.append((slot, m, k))
    return bad


def train_on_meshes(dims, params, batch, t, noise, models, save_path=None):
    """For each model-axis size of `models`, a mesh over every rank and a
    trainer on it: whether init_fn kept shard_state_dict's shards of
    `params`; one step on the given t and noise (the loss, and mu and nu
    gathered whole); where the axis is above 1, whether the same step
    with remat is bitwise the same, then a second step from a seeded
    generator and the replicated tensors that differ across the model
    group. With `save_path`: that state saved there, then (at model 1) a
    step from a generator against the same step on one device (rank 0),
    and the saved file restored on this mesh. Rank 0 returns the results,
    the others None."""
    from videovanish_tpu_torch.core.mesh import make_mesh
    from videovanish_tpu_torch.parallel import shard_state_dict
    from videovanish_tpu_torch.train import (
        restore_train_state, save_train_state,
    )
    rank0 = dist.get_rank() == 0
    out = {}
    for model in models:
        mesh = make_mesh("cpu", model_parallel=model)
        shape = tuple(mesh.shape)
        state, step_fn = _tiny_trainer(dims, mesh, params)
        # init_fn kept this rank's shards of the whole parameters
        kept = all(torch.equal(state.params[m][k], v) for m in params
                   for k, v in shard_state_dict(params[m], mesh).items())
        state, loss = step_fn(state, batch, t=t, noise=noise)
        whole = _whole_state(state, mesh)
        res = {"loss": float(loss), "mu": whole["mu"], "nu": whole["nu"],
               "init_kept_shards": kept}
        if model > 1:
            # remat recomputes the forward's all-reduces in the backward
            r_state, r_step = _tiny_trainer(dims, mesh, params, remat=True)
            r_state, r_loss = r_step(r_state, batch, t=t, noise=noise)
            r_whole = _whole_state(r_state, mesh)
            res["remat_bitwise"] = float(r_loss) == res["loss"] and all(
                np.array_equal(r_whole[slot][m][k], v)
                for slot in whole for m in whole[slot]
                for k, v in whole[slot][m].items())
            del r_state, r_step
            state, _ = step_fn(state, batch, torch.Generator().manual_seed(5))
            res["replicated_differ"] = _replicated_differ(state, mesh)
            if save_path:
                save_train_state(save_path, state)
                res["saved"] = _whole_state(state, mesh)
        out[shape] = res
    if save_path:
        mesh = make_mesh("cpu", model_parallel=1)
        shape = tuple(mesh.shape)
        gen = {}
        for where, m in [("mesh", mesh)] + ([("single", None)] if rank0
                                            else []):
            state, step_fn = _tiny_trainer(dims, m, params)
            state, loss = step_fn(state, batch,
                                  torch.Generator().manual_seed(11))
            whole = _whole_state(state, m)
            gen[where] = {"loss": float(loss), "mu": whole["mu"],
                          "nu": whole["nu"]}
        out["generator"] = gen
        state, _ = _tiny_trainer(dims, mesh, params)
        state = restore_train_state(save_path, state)
        out["restored"] = (shape, state.step, state.opt_state["count"],
                           _whole_state(state, mesh))
    return out if rank0 else None
