"""DiffuEraser training step: epsilon-prediction MSE under the SD1.5 schedule
with AdamW, on one card or on a ("data", "model") mesh.

Port of videovanish_tpu/train/train_step.py. One step draws a timestep per
clip (repeated over its frames) and unit-normal noise of the latents'
shape, noises the clean latents, runs BrushNet on [x_t, masked latent,
mask] with the text embedding and the motion-module UNet on x_t with
BrushNet's residuals, and takes the mean f32 squared error between the
predicted and the drawn noise; both models' parameters are trained.

PyTorch's idiom inside, the JAX semantics outside:
  * the parameters live in the modules (f32 masters) and AdamW's moments
    in a torch.optim.AdamW (fused on the card) with optax.adamw's
    defaults: decoupled weight decay on every parameter. `TrainState`
    holds references to those tensors, and `step_fn` updates them in place
    (a second copy of 2.2 B parameters and their moments does not fit on
    one card); a state whose tensors are not the trainer's own (converted
    from JAX, or restored) is copied into them first;
  * on the card the forward runs under torch.autocast in bf16 (the port's
    attention kernels take bf16 only); normalisation statistics and the
    loss stay f32. On the CPU everything is f32, as the JAX tests run;
  * remat=True recomputes the whole BrushNet forward and the whole UNet
    forward in the backward pass (torch.utils.checkpoint, non-reentrant),
    the two cuts of the JAX package's jax.checkpoint;
  * t and noise come from an explicit torch.Generator on the card (JAX's
    PRNG key), or are given, so that tests can feed JAX's draws;
  * checkpoints are torch.save files (the JAX package writes orbax).
The attention gradients run through the hand-written backward kernels
(ops/attention.py).

On a mesh (a DeviceMesh from core/mesh.make_mesh; one process a card, as
torchrun starts them) the JAX package's shardings become explicit
collectives on plain local tensors:
  * "data": every rank is given the whole batch and keeps its block of
    clips; t and noise are drawn (or given) for the whole batch and cut
    the same way, so the result does not depend on the mesh's shape. The
    gradients are averaged over "data" after the backward (one all-reduce
    a bucket), and the loss is the whole batch's mean on every rank;
  * "model": the attention, feed-forward and time-embedding parameters are
    split by parallel/sharding.py's rules (the modules are cut to this
    rank's shards in place) and those layers run Megatron's pattern. A
    split parameter's gradient and AdamW moments stay on its shard; the
    replicated ones are equal on every rank of the model group, bitwise,
    since their gradients come from identical inputs.
Remat recomputes the forward's collectives in the backward, in the same
order on every rank. States come in whole (init_fn, a converted or
restored state) and each rank keeps its shards; save_train_state writes
the whole state from rank 0, so a file restores on any mesh or on one
card. At a 1x1 mesh no collective runs and the step is the one-card step.
"""
from __future__ import annotations

import contextlib
import os
from typing import NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from videovanish_tpu_torch.core.mesh import (
    DATA_AXIS, all_reduce_sum, barrier, data_coords, is_writer,
)
from videovanish_tpu_torch.models.diffueraser.scheduler import NoiseSchedule
from videovanish_tpu_torch.parallel.sharding import (
    batch_block, gather_tensor, local_of, model_shard, shard_module_,
    shard_of, tag_shard_,
)

MODELS = ("unet", "brushnet")
# gradients averaged over "data" in buckets of this many f32 elements
BUCKET_NUMEL = 1 << 25


class TrainState(NamedTuple):
    """step: steps taken. params: {"unet": {name: tensor}, "brushnet":
    {...}}, f32, keyed as the modules' named_parameters (the checkpoint
    keys). opt_state: {"count": steps AdamW has taken, "mu": first moments,
    "nu": second moments}, the moments in the params' layout (optax's
    ScaleByAdamState). A trainer under a "model" split holds this rank's
    shards, each tagged with its sharding.ModelShard."""
    step: int
    params: dict
    opt_state: dict


def make_train_step(unet, brushnet, mesh=None, learning_rate: float = 1e-5,
                    weight_decay: float = 1e-2, remat: bool = False,
                    device=None):
    """Returns (init_fn, step_fn) training `unet` (UNetCondition) and
    `brushnet` (BrushNetModel) on `device` (the card unless the caller
    asks for the CPU), on one device (mesh=None) or on `mesh`, a
    ("data", "model") DeviceMesh of this device type (every rank builds
    the same modules and calls the same functions). The modules move there
    in f32; on a "model" axis above 1 they are cut to this rank's shards.

    init_fn(params=None) -> TrainState: params {"unet": state dict,
      "brushnet": state dict}, whole tensors, are loaded into the modules
      (this rank's shards; None keeps theirs); step 0, zero moments.
    step_fn(state, batch, generator=None, *, t=None, noise=None)
      -> (TrainState, loss): one AdamW step, in place. Batch (leading axis
      = clips, the JAX package's channel-last layout):
        latents:    (B, T, h, w, 4)  clean target latents
        masked_lat: (B, T, h, w, 4)
        mask_lat:   (B, T, h, w, 1)
        text_emb:   (B, 77, D)
      t (B,) integers in [0, 1000) and noise (the latents' shape) are drawn
      from `generator` (t first) unless given. On a mesh the batch, t and
      noise are the whole batch's on every rank, B a multiple of the data
      axis, and every rank draws from an identically seeded generator.
    """
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("make_train_step: no CUDA device (pass "
                           "device='cpu' to train on the CPU)")
    if mesh is not None and mesh.device_type != device.type:
        raise ValueError(f"a {mesh.device_type} mesh for a trainer on "
                         f"{device.type}")
    on_card = device.type == "cuda"
    schedule = NoiseSchedule()
    modules = {"unet": unet, "brushnet": brushnet}
    shard = model_shard(mesh)
    d_size = data_coords(mesh)[1]
    for m in modules.values():
        m.to(device=device, dtype=torch.float32).requires_grad_(True)
        shard_module_(m, shard)
    named = {name: dict(m.named_parameters()) for name, m in modules.items()}
    flat = [p for name in MODELS for p in named[name].values()]
    opt = torch.optim.AdamW(flat, lr=learning_rate, betas=(0.9, 0.999),
                            eps=1e-8, weight_decay=weight_decay,
                            fused=True if on_card else None)
    # AdamW's state made up front (as its lazy init would), so that the
    # state's moments exist from step 0
    for p in flat:
        opt.state[p] = {
            "step": torch.zeros((), dtype=torch.float32,
                                device=p.device if on_card else "cpu"),
            "exp_avg": torch.zeros_like(p),
            "exp_avg_sq": torch.zeros_like(p)}
    moments = {slot: {name: {k: opt.state[p][key]
                             for k, p in named[name].items()}
                      for name in MODELS}
               for slot, key in (("mu", "exp_avg"), ("nu", "exp_avg_sq"))}
    if shard is not None:
        for name in MODELS:
            for k, p in named[name].items():
                for t in (p, moments["mu"][name][k], moments["nu"][name][k]):
                    tag_shard_(t, shard)

    count = [0]  # AdamW's step count, as its step tensors hold it

    def state_of(step: int) -> TrainState:
        return TrainState(step, named, {"count": count[0], **moments})

    @torch.no_grad()
    def bind(state: TrainState) -> None:
        """Copy every tensor of `state` that is not the trainer's own into
        the trainer's (this rank's shard of a whole one); set AdamW's step
        count where it differs."""
        for name in MODELS:
            if set(state.params[name]) != set(named[name]):
                raise KeyError(f"{name}: the state's parameters are not the "
                               f"module's")
            for k, p in named[name].items():
                for src, dst in ((state.params[name][k], p),
                                 (state.opt_state["mu"][name][k],
                                  opt.state[p]["exp_avg"]),
                                 (state.opt_state["nu"][name][k],
                                  opt.state[p]["exp_avg_sq"])):
                    if src is not dst:
                        dst.copy_(local_of(k, src, dst))
        if state.opt_state["count"] != count[0]:
            count[0] = int(state.opt_state["count"])
            for p in flat:
                opt.state[p]["step"].fill_(count[0])

    def init_fn(params=None) -> TrainState:
        with torch.no_grad():
            if params is not None:
                for name in MODELS:
                    if set(params[name]) != set(named[name]):
                        raise KeyError(f"{name}: the parameters are not "
                                       f"the module's")
                    for k, p in named[name].items():
                        p.copy_(local_of(k, params[name][k], p))
            for p in flat:
                for v in opt.state[p].values():
                    v.zero_()
        count[0] = 0
        return state_of(0)

    def forward(fn, *args):
        if remat:
            return checkpoint(fn, *args, use_reentrant=False)
        return fn(*args)

    def step_fn(state: TrainState, batch: dict, generator=None, *, t=None,
                noise=None):
        bind(state)
        B, T = batch["latents"].shape[:2]
        if B % d_size:
            raise ValueError(f"a batch of {B} clips does not split over a "
                             f"data axis of {d_size}")
        if (t is None or noise is None) and generator is None:
            raise ValueError("step_fn draws t and noise from a "
                             "torch.Generator: pass one, or both tensors")
        # the whole batch's draws on every rank, then this rank's clips
        if t is None:
            t = torch.randint(0, schedule.num_train_timesteps, (B,),
                              generator=generator, device=device)
        if noise is None:
            noise = torch.randn(batch["latents"].shape, generator=generator,
                                device=device, dtype=torch.float32)
        batch = {k: batch_block(mesh, v) for k, v in batch.items()}
        t, noise = batch_block(mesh, t), batch_block(mesh, noise)
        latents = batch["latents"].to(device, torch.float32)
        B = latents.shape[0]
        t_full = t.to(device).long().repeat_interleave(T)  # (B*T,)

        def nchw(x):  # (B, T, h, w, C) -> (B*T, C, h, w)
            x = x.to(device, torch.float32)
            return x.reshape((B * T,) + x.shape[2:]).permute(0, 3, 1, 2) \
                .contiguous()

        x0, eps_true = nchw(latents), nchw(noise)
        x_t = schedule.add_noise(x0, eps_true, t_full)
        bsample = torch.cat([x_t, nchw(batch["masked_lat"]),
                             nchw(batch["mask_lat"])], dim=1)
        txt = batch["text_emb"].to(device, torch.float32) \
            .repeat_interleave(T, dim=0)

        def brush_fwd(bsample, t_full, txt):
            return brushnet(bsample, t_full, txt)

        def unet_fwd(x_t, t_full, txt, bd, bm, bu):
            return unet(x_t, t_full, txt, T, brushnet_down=bd,
                        brushnet_mid=bm, brushnet_up=bu)

        opt.zero_grad(set_to_none=True)
        amp = torch.autocast("cuda", dtype=torch.bfloat16) if on_card \
            else contextlib.nullcontext()
        with amp:
            bd, bm, bu = forward(brush_fwd, bsample, t_full, txt)
            eps = forward(unet_fwd, x_t, t_full, txt, bd, bm, bu)
        loss = torch.mean(torch.square(eps.float() - eps_true))
        loss.backward()
        if d_size > 1:
            # every rank's clips are as many: the whole batch's mean is
            # the mean of the ranks'
            group = mesh.get_group(DATA_AXIS)
            average_gradients(flat, group, d_size)
            loss = all_reduce_sum(loss.detach().clone(), group) / d_size
        opt.step()
        count[0] += 1
        return state_of(state.step + 1), loss.detach()

    return init_fn, step_fn


@torch.no_grad()
def average_gradients(params, group, size: int) -> None:
    """Each parameter's .grad averaged over `group` (`size` ranks), in
    place: the gradients flattened into buckets of up to BUCKET_NUMEL
    elements, one all-reduce a bucket, in the same order on every rank."""
    grads = [p.grad for p in params if p.grad is not None]
    while grads:
        bucket, n = [], 0
        while grads and (not bucket or n + grads[0].numel() <= BUCKET_NUMEL):
            n += grads[0].numel()
            bucket.append(grads.pop(0))
        buf = all_reduce_sum(torch.cat([g.reshape(-1) for g in bucket]),
                             group)
        buf.div_(size)
        for g, part in zip(bucket, buf.split([g.numel() for g in bucket])):
            g.copy_(part.view_as(g))


@torch.no_grad()
def save_train_state(path: str, state: TrainState) -> None:
    """Persist a training run (step, params, AdamW's count and moments) with
    torch.save; `restore_train_state` reads it back. The file holds whole
    tensors: where there are several ranks every rank calls this, the
    shards are gathered over "model" one tensor at a time (no second copy
    of the state on the card) and rank 0 alone writes; every rank returns
    once the file is there."""
    writer = is_writer()

    def host(tree):
        out = {}
        for name in MODELS:
            out[name] = {}
            for k, v in tree[name].items():
                # a collective under a model split: every rank takes part
                whole = gather_tensor(k, v, shard_of(v))
                out[name][k] = whole.detach().cpu() if writer else None
                del whole
        return out
    tree = {"step": int(state.step), "params": host(state.params),
            "opt_state": {"count": int(state.opt_state["count"]),
                          "mu": host(state.opt_state["mu"]),
                          "nu": host(state.opt_state["nu"])}}
    if writer:
        torch.save(tree, path + ".tmp")
        os.replace(path + ".tmp", path)
    barrier()


@torch.no_grad()
def restore_train_state(path: str, like: TrainState) -> TrainState:
    """The state saved at `path`, read into `like`'s tensors in place (the
    trainer's own, so the next step_fn continues from it without a second
    copy of the state on the card). Keys and whole shapes must match. On a
    mesh every rank reads the whole file (mapped, not loaded) and keeps its
    shards, so a file saved on any mesh restores on any other."""
    tree = torch.load(path, map_location="cpu", weights_only=True,
                      mmap=True)
    pairs = [(tree["params"], like.params)] + [
        (tree["opt_state"][slot], like.opt_state[slot])
        for slot in ("mu", "nu")]
    for src, dst in pairs:
        for name in MODELS:
            if set(src[name]) != set(dst[name]):
                raise KeyError(f"{path}: {name}'s keys differ from the "
                               f"state's")
            for k, v in dst[name].items():
                v.copy_(local_of(k, src[name][k], v))
    return TrainState(tree["step"], like.params,
                      {"count": tree["opt_state"]["count"],
                       "mu": like.opt_state["mu"],
                       "nu": like.opt_state["nu"]})
