"""SAM2 streaming video predictor, PyTorch.

Port of videovanish_tpu/models/sam2/predictor.py with the reference's call
surface:

  build_sam2_video_predictor(config_file, ckpt_path, device) -> predictor
  predictor.init_state(video_path=<list of (H, W, 3) uint8 RGB frames>)
  predictor.add_new_points_or_box(state, frame_idx, obj_id, points=...,
                                  labels=..., box=xyxy) -> (frame_idx,
                                  obj_ids, logits (O, H, W))
  predictor.propagate_in_video(state, start_frame_idx, max_frame_num_to_track,
                               reverse, yield_binary)
      -> yields (frame_idx, obj_ids, [mask logits or 0/1 masks per object])

Objects ride a leading batch axis; each frame is encoded once and shared.
The memory bank is fixed-size per object: num_maskmem spatial slots
(conditioning frames pinned, tracked frames ring-evicted) and
max_obj_ptrs_in_encoder pointer slots, invalid slots masked in attention.
The bank lives on the model's device and is updated in place; its
occupancy is host metadata (`_BankMeta`), shared by all objects. Frames are
encoded ENCODE_CHUNK at a time (the last chunk is not padded: frames are
independent in Hiera), then stepped one by one in a Python loop; the JAX
package fuses a chunk's steps into one `lax.scan` and bit-packs binary
masks to cut dispatches and host-link bytes, which the port does not need.

On the card the networks run in bf16 with f32 LayerNorms, softmax, mask
logits and memory bank; on the CPU everything is f32.

Propagation records the JAX package's stages per encode chunk
(`utils/observability.py`): sam2.wire_prep (stacking and the I420
conversion on the host), sam2.encode_dispatch, sam2.step_dispatch (the
chunk's steps) and sam2.fetch (the masks to the host). They read the host
clock, so device time bills to sam2.fetch, where the host waits.
"""
from __future__ import annotations

import time
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn as nn

from benchmark.reference.vvref.standins import load_torch_state
from benchmark.reference.vvref.config import Sam2Config
from benchmark.reference.vvref.standins import published_state_dict
from benchmark.reference.vvref.models.sam2.decoder import MaskDecoder
from benchmark.reference.vvref.models.sam2.hiera import Hiera, Mlp
from benchmark.reference.vvref.models.sam2.memory import (
    CXBlock, MemoryAttention, MemoryEncoder,
)
from benchmark.reference.vvref.models.sam2.neck import FpnNeck, sine_pos_embed_2d
from benchmark.reference.vvref.models.sam2.prompt import MAX_POINTS, PromptEncoder
from benchmark.reference.vvref.ops.colorspace import (
    rgb_to_yuv420_host, yuv420_to_rgb01,
)
from benchmark.reference.vvref.ops.resize import resize_bilinear
from benchmark.reference.vvref.standins import record_stage

_IMAGENET_MEAN = (0.485, 0.456, 0.406)
_IMAGENET_STD = (0.229, 0.224, 0.225)
NO_OBJ_SCORE = -1024.0

# frames encoded per batch during propagation
ENCODE_CHUNK = 8

_LOW_PRECISION = (nn.Linear, nn.Conv2d, nn.ConvTranspose2d)


class Sam2Model(nn.Module):
    """Every SAM2 parameter under the published checkpoint's names."""

    def __init__(self, cfg: Sam2Config):
        super().__init__()
        d, m = cfg.neck_d_model, cfg.mem_dim
        self.image_encoder = nn.Module()
        self.image_encoder.trunk = Hiera(
            cfg.hiera_embed_dim, cfg.hiera_num_heads, cfg.hiera_stages,
            cfg.hiera_window_spec, cfg.hiera_global_att_blocks,
            cfg.hiera_window_pos_embed_bkg_spatial_size)
        self.image_encoder.neck = FpnNeck(cfg.backbone_channel_list, d)
        self.sam_prompt_encoder = PromptEncoder(d, cfg.image_size)
        self.sam_mask_decoder = MaskDecoder(d, cfg.num_multimask_outputs,
                                            cfg.iou_head_depth)
        self.obj_ptr_proj = Mlp((d, d, d, d))
        self.memory_attention = MemoryAttention(
            cfg.memory_attention_layers, cfg.memory_attention_d_model, m)
        self.memory_encoder = MemoryEncoder(d, m)
        self.obj_ptr_tpos_proj = nn.Linear(d, m)
        self.maskmem_tpos_enc = nn.Parameter(torch.zeros(cfg.num_maskmem, 1,
                                                         1, m))
        self.no_mem_embed = nn.Parameter(torch.zeros(1, 1, d))
        self.no_obj_ptr = nn.Parameter(torch.zeros(1, d))
        self.no_obj_embed_spatial = nn.Parameter(torch.zeros(1, m))


@torch.no_grad()
def _init_random_(model: Sam2Model, gen: torch.Generator) -> None:
    """Seeded weights: linear and conv weights and biases uniform in
    +-1/sqrt(fan_in), LayerNorms at 1 and 0, token and label embeddings
    and the Fourier matrix standard normal, the position embeddings normal
    at 0.02, the layer scales 1e-6, and the no-memory, no-pointer and
    occlusion embeddings 0 (the JAX package's initial values)."""
    for mod in model.modules():
        if isinstance(mod, _LOW_PRECISION):
            fan_in = mod.weight.shape[1] * mod.weight[0, 0].numel()
            bound = 1.0 / np.sqrt(fan_in)
            mod.weight.uniform_(-bound, bound, generator=gen)
            mod.bias.uniform_(-bound, bound, generator=gen)
        elif isinstance(mod, nn.LayerNorm):
            mod.reset_parameters()
        elif isinstance(mod, nn.Embedding):
            mod.weight.normal_(generator=gen)
        elif isinstance(mod, CXBlock):
            mod.gamma.fill_(1e-6)
    trunk = model.image_encoder.trunk
    for p in (trunk.pos_embed, trunk.pos_embed_window, model.maskmem_tpos_enc):
        p.normal_(0.0, 0.02, generator=gen)
    model.sam_prompt_encoder.pe_layer.positional_encoding_gaussian_matrix \
        .normal_(generator=gen)
    for p in (model.no_mem_embed, model.no_obj_ptr,
              model.no_obj_embed_spatial):
        p.zero_()


class _BankMeta:
    """Host-side occupancy of the memory bank. All objects see the same
    frames, so occupancy is shared; only the contents differ.
    Conditioning-frame slots are pinned; recent slots ring-evict
    oldest-first."""

    def __init__(self, num_maskmem: int, max_ptrs: int):
        self.num_maskmem = num_maskmem
        self.max_ptrs = max_ptrs
        self.slots: list = [None] * num_maskmem  # (frame_idx, is_cond)
        self.ptr_slot_frame: list = [None] * max_ptrs
        self.ptr_next = 0

    def choose_slot(self, frame_idx: int, is_cond: bool) -> int:
        for i, s in enumerate(self.slots):
            if s is None:
                self.slots[i] = (frame_idx, is_cond)
                return i
        cand = [(s[0], i) for i, s in enumerate(self.slots) if not s[1]]
        if not cand:
            cand = [(s[0], i) for i, s in enumerate(self.slots)]
        _, i = min(cand)
        self.slots[i] = (frame_idx, is_cond)
        return i

    def choose_ptr_slot(self, frame_idx: int, is_cond: bool = False) -> int:
        """Conditioning-frame pointers are pinned; tracked-frame pointers
        ring-evict among the remaining slots."""
        slots = self.ptr_slot_frame
        if is_cond:
            for i, s in enumerate(slots):
                if s is None or not s[1]:
                    slots[i] = (frame_idx, True)
                    return i
            slots[0] = (frame_idx, True)
            return 0
        order = [i for i in range(self.max_ptrs)
                 if slots[i] is None or not slots[i][1]]
        if not order:  # all pinned: overwrite the oldest cond
            order = list(range(self.max_ptrs))
        i = order[self.ptr_next % len(order)]
        self.ptr_next += 1
        slots[i] = (frame_idx, False)
        return i

    def valid_age(self, cur_frame: int):
        """Conditioning slots use temporal index num_maskmem-1; tracked
        slots at distance d in 1..num_maskmem-1 use d-1; farther tracked
        frames are not attended."""
        n = self.num_maskmem
        valid = np.zeros((n,), bool)
        tpos = np.zeros((n,), np.int32)
        for i, s in enumerate(self.slots):
            if s is None:
                continue
            frame, is_cond = s
            d = abs(cur_frame - frame)
            if is_cond:
                valid[i] = True
                tpos[i] = n - 1
            elif 1 <= d <= n - 1:
                valid[i] = True
                tpos[i] = d - 1
        return valid, tpos

    def ptr_valid_tdiff(self, cur_frame: int, reverse: bool,
                        num_total_frames: int):
        """Per pointer slot: validity and the signed temporal offset
        normalised by (max pointers to use - 1). Conditioning-frame
        pointers from the past (in the tracking direction) at any offset,
        tracked-frame pointers within max pointers to use - 1."""
        max_use = min(num_total_frames, self.max_ptrs) \
            if num_total_frames else self.max_ptrs
        v = np.zeros((self.max_ptrs,), bool)
        td = np.zeros((self.max_ptrs,), np.float32)
        sign = -1.0 if reverse else 1.0
        for i, s in enumerate(self.ptr_slot_frame):
            if s is None:
                continue
            frame, is_cond = s
            diff = sign * float(cur_frame - frame)
            ok = diff >= 0 if is_cond else 1 <= diff <= max_use - 1
            if ok:
                v[i] = True
                td[i] = diff / max(max_use - 1, 1)
        return v, td


class Sam2VideoPredictor:
    """params: None (seeded random weights) or the published state dict
    (checkpoint keys, its unused mask-prompt keys allowed; a JAX parameter
    tree goes through `jax_params_to_state_dict(tree, "sam2")` first). The
    networks run in bf16 on CUDA and in f32 on the CPU.
    `stage_hook`, if set, is called with a stage name and its outputs as
    each stage is enqueued: ("encode", f4, f8, f16) per encoded batch,
    ("decode", logits) after memory attention and the mask decoder,
    ("memory_encode", new memory features) after the memory encoder."""

    def __init__(self, config: Optional[Sam2Config] = None, params=None,
                 seed: int = 0, device="cuda"):
        self.cfg = cfg = config or Sam2Config()
        self.device = torch.device(device or "cuda")
        self.dtype = torch.float32  # the reference runs in f32 everywhere
        self.stage_hook: Optional[Callable[..., None]] = None
        with torch.device(self.device):
            self.model = Sam2Model(cfg)
        if params is None:
            _init_random_(self.model,
                          torch.Generator(device=self.device).manual_seed(seed))
        else:
            self.model.load_state_dict(
                {k: v if isinstance(v, torch.Tensor)
                 else torch.as_tensor(np.asarray(v)) for k, v in
                 published_state_dict(params, "sam2").items()})
        # the JAX package keeps the prompt encoder and the pointer's
        # temporal projection in f32
        for name, mod in self.model.named_modules():
            if isinstance(mod, _LOW_PRECISION) and \
                    not name.startswith("obj_ptr_tpos_proj"):
                mod.to(self.dtype)
        self.model.eval().requires_grad_(False)

        self.s16 = cfg.image_size // 16
        self.tokens16 = self.s16 * self.s16
        d, dev = cfg.neck_d_model, self.device
        self._pos16 = torch.from_numpy(sine_pos_embed_2d(
            self.s16, self.s16, d)).to(dev).reshape(1, self.tokens16, d)
        self._mem_spatial_pos = torch.from_numpy(sine_pos_embed_2d(
            self.s16, self.s16, cfg.mem_dim)).to(dev).reshape(
                self.tokens16, cfg.mem_dim)
        self._mean = torch.tensor(_IMAGENET_MEAN, device=dev)
        self._std = torch.tensor(_IMAGENET_STD, device=dev)

    def _stage(self, name: str, *outputs) -> None:
        if self.stage_hook is not None:
            self.stage_hook(name, *outputs)

    # ------------------------------------------------------------------
    # the three stages
    # ------------------------------------------------------------------
    def encode(self, img01: torch.Tensor):
        """(N, H0, W0, 3) f32 RGB in [0, 1] on the device -> (f4, f8, f16)
        channel-last neck features at the model's square size."""
        S = self.cfg.image_size
        if tuple(img01.shape[1:3]) != (S, S):
            img01 = resize_bilinear(img01, S, S)
        x = ((img01 - self._mean) / self._std).to(self.dtype)
        enc = self.model.image_encoder
        f4, f8, f16, _ = enc.neck(enc.trunk(x))
        self._stage("encode", f4, f8, f16)
        return f4, f8, f16

    def encode_rgb(self, frames_u8) -> tuple:
        """(N, H0, W0, 3) uint8 RGB (numpy) -> neck features."""
        x = torch.from_numpy(np.ascontiguousarray(frames_u8)).to(self.device)
        return self.encode(x.float() / 255.0)

    def encode_yuv(self, yuv_u8) -> tuple:
        """(N, H0*3//2, W0) I420 uint8 (numpy) -> neck features."""
        x = torch.from_numpy(np.ascontiguousarray(yuv_u8)).to(self.device)
        return self.encode(yuv420_to_rgb01(x))

    def decode(self, f16, f4, f8, mem_feats, mem_valid, mem_age, ptr_feats,
               ptr_valid, ptr_tdiff, points, labels, H0: int, W0: int):
        """Memory attention and the mask decoder, batched over objects O.
        f16/f4/f8: (1, ...) shared features; mem_feats (O, n, T16, mem) and
        ptr_feats (O, P*splits, mem): the bank; mem_valid, mem_age (O, n),
        ptr_valid (O, P*splits), ptr_tdiff (O, P), points (O, MAX_POINTS, 2),
        labels (O, MAX_POINTS): host numpy arrays. Returns (low-res masks
        (O, 4*s16, 4*s16, 1), logits at (H0, W0), object pointers, the
        conditioned stride-16 features, object scores)."""
        cfg, m = self.cfg, self.model
        dev, dt = self.device, self.dtype
        d, n, T16 = cfg.neck_d_model, cfg.num_maskmem, self.tokens16
        O = mem_feats.shape[0]
        splits = d // cfg.mem_dim

        def up(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

        x = f16.reshape(1, T16, d).expand(O, T16, d).to(dt)
        no_mem = x + m.no_mem_embed.to(dt)
        any_mem = np.asarray(mem_valid).any(1) | np.asarray(ptr_valid).any(1)
        if any_mem.any():
            # memory kv: spatial slots with their temporal encodings, then
            # the pointer tokens with the projected sine encoding of their
            # normalised temporal offsets
            tpos = m.maskmem_tpos_enc.reshape(n, cfg.mem_dim)[
                up(mem_age).long()]
            pos_sp = (self._mem_spatial_pos[None, None] + tpos[:, :, None, :]
                      ).reshape(O, n * T16, cfg.mem_dim)
            pe_dim = d // 2
            dim_t = 10000.0 ** (2.0 * (torch.arange(pe_dim, device=dev) // 2)
                                .float() / pe_dim)
            ang = up(ptr_tdiff)[..., None] / dim_t
            sine_pe = torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)
            ptr_pos = m.obj_ptr_tpos_proj(sine_pe).repeat_interleave(
                splits, dim=1)
            kv = torch.cat([mem_feats.reshape(O, n * T16, cfg.mem_dim),
                            ptr_feats], dim=1).to(dt)
            pos = torch.cat([pos_sp, ptr_pos], dim=1)
            valid = torch.cat([up(mem_valid).repeat_interleave(T16, dim=1),
                               up(ptr_valid)], dim=1)
            cond = m.memory_attention(x, self._pos16, kv, pos, valid)
            # a frame with no memory takes the learned no-memory embedding
            x = torch.where(up(any_mem)[:, None, None], cond, no_mem)
        else:
            x = no_mem
        x = x.reshape(O, self.s16, self.s16, d)

        pe_enc = m.sam_prompt_encoder
        lab = up(labels).long()
        sparse, no_mask = pe_enc(up(points), lab)
        # the real prompt tokens and exactly one "not a point" pad token
        real = lab >= 0
        pad_rank = torch.cumsum((~real).long(), dim=1)
        sparse_valid = real | ((pad_rank == 1) & ~real)
        x = x + no_mask.to(dt)
        dense_pe = pe_enc.dense_pe(self.s16, self.s16)
        out = m.sam_mask_decoder(
            x, dense_pe[None].expand(O, -1, -1, -1), sparse.to(dt),
            f4.expand(O, -1, -1, -1), f8.expand(O, -1, -1, -1), sparse_valid,
            m.obj_ptr_proj)

        # multimask (best of masks 1..3 by IoU) with at most one click,
        # mask 0 otherwise; NO_OBJ_SCORE where the object is absent
        multi = real.sum(1) <= 1
        best = torch.where(multi, out["iou"][:, 1:].argmax(-1) + 1,
                           torch.zeros_like(multi, dtype=torch.long))
        appearing = out["obj_score"][:, 0] > 0
        masks_all = torch.where(appearing[:, None, None, None], out["masks"],
                                torch.full_like(out["masks"], NO_OBJ_SCORE))
        masks = masks_all[torch.arange(O, device=dev), best]
        ptr_sel = out["obj_ptrs"][torch.arange(O, device=dev), best]
        # occlusion-aware pointer: the no-object pointer where absent
        lam = appearing.to(ptr_sel.dtype)[:, None]
        obj_ptr = lam * ptr_sel + (1.0 - lam) * m.no_obj_ptr.to(ptr_sel.dtype)
        logits = resize_bilinear(masks[..., None], H0, W0)[..., 0]
        self._stage("decode", logits)
        return masks[..., None], logits, obj_ptr, x, out["obj_score"]

    def step(self, f16, f4, f8, bank_feats, bank_ptrs, mem_valid, mem_age,
             ptr_valid, ptr_tdiff, points, labels, write_slot: int,
             ptr_slot: int, binarize: bool, H0: int, W0: int):
        """One propagation step: decode, encode the new memory, and write it
        and the object pointer into the bank (in place). Returns the
        logits at (H0, W0)."""
        cfg = self.cfg
        masks_s4, logits, obj_ptr, cond_f16, obj_score = self.decode(
            f16, f4, f8, bank_feats, mem_valid, mem_age, bank_ptrs, ptr_valid,
            ptr_tdiff, points, labels, H0, W0)
        # the image-resolution mask, binarised on prompted frames, else a
        # sigmoid, scaled by 20 and biased by -10
        S = cfg.image_size
        m_hi = resize_bilinear(masks_s4, S, S)
        mask = (m_hi > 0).float() if binarize else torch.sigmoid(m_hi)
        new_feat = self.model.memory_encoder(
            cond_f16, (mask * 20.0 - 10.0).to(self.dtype)).float()
        # occluded frames: add the learned no-object spatial embedding
        absent = (obj_score[:, 0] <= 0).float()
        new_feat = new_feat + absent[:, None, None, None] * \
            self.model.no_obj_embed_spatial.float().reshape(-1)
        self._stage("memory_encode", new_feat)
        splits = cfg.neck_d_model // cfg.mem_dim
        bank_feats[:, write_slot] = new_feat.reshape(-1, self.tokens16,
                                                     cfg.mem_dim)
        bank_ptrs[:, ptr_slot * splits:(ptr_slot + 1) * splits] = \
            obj_ptr.float().reshape(-1, splits, cfg.mem_dim)
        return logits

    def _empty_bank(self, O: int):
        cfg = self.cfg
        splits = cfg.neck_d_model // cfg.mem_dim
        feats = torch.zeros(O, cfg.num_maskmem, self.tokens16, cfg.mem_dim,
                            device=self.device)
        ptrs = torch.zeros(O, cfg.max_obj_ptrs_in_encoder * splits,
                           cfg.mem_dim, device=self.device)
        return feats, ptrs

    # ------------------------------------------------------------------
    # reference API
    # ------------------------------------------------------------------
    def init_state(self, video_path):
        """video_path: list of (H, W, 3) uint8 RGB frames."""
        frames = video_path
        assert len(frames) > 0
        H0, W0 = frames[0].shape[:2]
        return {"frames": frames, "H0": H0, "W0": W0,
                "prompts": {},      # frame_idx -> {obj_id: {pts, labels}}
                "obj_ids": [],
                "feat_cache": {}}   # frame_idx -> (f4, f8, f16), prompted

    def reset_state(self, inference_state):
        inference_state["prompts"] = {}
        inference_state["obj_ids"] = []
        inference_state["feat_cache"] = {}

    @torch.inference_mode()
    def add_new_points_or_box(self, inference_state, frame_idx, obj_id,
                              points=None, labels=None, box=None,
                              clear_old_points: bool = True,
                              normalize_coords: bool = True):
        state = inference_state
        H0, W0 = state["H0"], state["W0"]
        S = self.cfg.image_size
        scale_x, scale_y = S / W0, S / H0

        pts, labs = [], []
        if points is not None:
            for p, lab in zip(np.asarray(points, np.float32),
                              np.asarray(labels, np.int32)):
                pts.append([p[0] * scale_x, p[1] * scale_y])
                labs.append(int(lab))
        if box is not None:
            b = np.asarray(box, np.float32)
            pts.append([b[0] * scale_x, b[1] * scale_y])
            labs.append(2)
            pts.append([b[2] * scale_x, b[3] * scale_y])
            labs.append(3)

        fp = state["prompts"].setdefault(int(frame_idx), {})
        entry = fp.setdefault(int(obj_id), {"pts": [], "labels": []})

        def keep(labels_kept):
            kept = [(p, lab) for p, lab in zip(entry["pts"], entry["labels"])
                    if lab in labels_kept]
            entry["pts"] = [p for p, _ in kept]
            entry["labels"] = [lab for _, lab in kept]
        if clear_old_points and points is not None:
            keep((2, 3))  # new clicks replace old ones; box corners stay
        if box is not None:
            keep((0, 1))  # a new box replaces the previous corners
        entry["pts"].extend(pts)
        entry["labels"].extend(labs)
        if int(obj_id) not in state["obj_ids"]:
            state["obj_ids"].append(int(obj_id))

        # immediate single-frame prediction without memory
        frame_idx = int(frame_idx)
        logits = self._predict_prompt_frame(state, frame_idx)
        return frame_idx, list(state["obj_ids"]), logits

    def _encode_frame(self, state, frame_idx):
        cache = state["feat_cache"]
        if frame_idx in cache:
            return cache[frame_idx]
        feats = self.encode_rgb(np.asarray(state["frames"][frame_idx])[None])
        if frame_idx in state["prompts"]:
            cache[frame_idx] = feats
        return feats

    def _prompt_arrays(self, state, frame_idx):
        O = len(state["obj_ids"])
        points = np.zeros((O, MAX_POINTS, 2), np.float32)
        labels = np.full((O, MAX_POINTS), -1, np.int32)
        fp = state["prompts"].get(frame_idx, {})
        for oi, obj_id in enumerate(state["obj_ids"]):
            e = fp.get(obj_id)
            if e is None:
                continue
            n = min(len(e["pts"]), MAX_POINTS)
            if n:
                points[oi, :n] = np.asarray(e["pts"][:n], np.float32)
                labels[oi, :n] = np.asarray(e["labels"][:n], np.int32)
        return points, labels

    def _meta_arrays(self, meta: _BankMeta, cur_frame: int, O: int,
                     reverse: bool = False, num_total_frames: int = 0):
        """Shared occupancy broadcast to per-object numpy arrays."""
        splits = self.cfg.neck_d_model // self.cfg.mem_dim
        valid, age = meta.valid_age(cur_frame)
        pvalid, tdiff = meta.ptr_valid_tdiff(cur_frame, reverse,
                                             num_total_frames)
        pvalid_tok = np.repeat(pvalid, splits)

        def bc(a):
            return np.broadcast_to(a, (O,) + a.shape)

        return bc(valid), bc(age), bc(pvalid_tok), bc(tdiff)

    def _predict_prompt_frame(self, state, frame_idx):
        """Memoryless single-frame decode: (O, H0, W0) f32 logits."""
        O = len(state["obj_ids"])
        f4, f8, f16 = self._encode_frame(state, frame_idx)
        feats, ptrs = self._empty_bank(O)
        meta = _BankMeta(self.cfg.num_maskmem,
                         self.cfg.max_obj_ptrs_in_encoder)
        valid, age, pvalid, tdiff = self._meta_arrays(meta, frame_idx, O)
        points, labels = self._prompt_arrays(state, frame_idx)
        logits = self.decode(f16, f4, f8, feats, valid, age, ptrs, pvalid,
                             tdiff, points, labels, state["H0"],
                             state["W0"])[1]
        return logits.cpu().numpy()

    def propagate_in_video(self, inference_state, start_frame_idx=None,
                           max_frame_num_to_track=None, reverse=False,
                           yield_binary: bool = False):
        """Yield (frame_idx, obj_ids, [per-object (H0, W0) array]) through
        the video from the first prompted frame: f32 logits, or with
        yield_binary uint8 0/1 masks (logits > 0, taken on the device)."""
        with torch.inference_mode():
            yield from self._propagate(inference_state, start_frame_idx,
                                       max_frame_num_to_track, reverse,
                                       yield_binary)

    def _propagate(self, state, start_frame_idx, max_frame_num_to_track,
                   reverse, yield_binary):
        obj_ids = list(state["obj_ids"])
        O = len(obj_ids)
        if O == 0:
            return
        T = len(state["frames"])
        prompt_frames = sorted(state["prompts"].keys())
        first = start_frame_idx if start_frame_idx is not None \
            else (prompt_frames[0] if prompt_frames else 0)
        if reverse:
            stop = -1 if max_frame_num_to_track is None \
                else max(-1, first - max_frame_num_to_track)
            idxs = list(range(first, stop, -1))
        else:
            last = T if max_frame_num_to_track is None \
                else min(T, first + max_frame_num_to_track)
            idxs = list(range(first, last))

        feats, ptrs = self._empty_bank(O)
        meta = _BankMeta(self.cfg.num_maskmem,
                         self.cfg.max_obj_ptrs_in_encoder)
        H0, W0 = state["H0"], state["W0"]
        frames = state["frames"]
        # I420 needs even dimensions; odd videos go as RGB
        use_yuv = self.cfg.wire == "yuv420" and H0 % 2 == 0 and W0 % 2 == 0
        no_points = np.zeros((O, MAX_POINTS, 2), np.float32)
        no_labels = np.full((O, MAX_POINTS), -1, np.int32)
        for pos in range(0, len(idxs), ENCODE_CHUNK):
            sel = idxs[pos:pos + ENCODE_CHUNK]
            t0 = time.perf_counter()
            batch = np.stack([np.asarray(frames[i]) for i in sel])
            wire = rgb_to_yuv420_host(batch) if use_yuv else batch
            t1 = time.perf_counter()
            record_stage("sam2.wire_prep", t1 - t0, frames=len(sel),
                         bytes=int(wire.nbytes))
            f4c, f8c, f16c = (self.encode_yuv(wire) if use_yuv
                              else self.encode_rgb(wire))
            record_stage("sam2.encode_dispatch", time.perf_counter() - t1,
                         frames=len(sel))
            step_s = fetch_s = 0.0
            for j, t in enumerate(sel):
                # occupancy before this frame writes, as one step at a time
                is_cond = t in state["prompts"]
                valid, age, pvalid, tdiff = self._meta_arrays(
                    meta, t, O, reverse=reverse, num_total_frames=T)
                points, labels = self._prompt_arrays(state, t) if is_cond \
                    else (no_points, no_labels)
                ws = meta.choose_slot(t, is_cond)
                ps = meta.choose_ptr_slot(t, is_cond)
                t2 = time.perf_counter()
                logits = self.step(
                    f16c[j:j + 1], f4c[j:j + 1], f8c[j:j + 1], feats, ptrs,
                    valid, age, pvalid, tdiff, points, labels, ws, ps,
                    is_cond, H0, W0)
                out = (logits > 0).to(torch.uint8) if yield_binary \
                    else logits
                t3 = time.perf_counter()
                out = out.cpu().numpy()
                step_s += t3 - t2
                fetch_s += time.perf_counter() - t3
                yield t, obj_ids, [out[i] for i in range(O)]
            record_stage("sam2.step_dispatch", step_s, frames=len(sel))
            record_stage("sam2.fetch", fetch_s, frames=len(sel))


def build_sam2_video_predictor(config_file=None, ckpt_path=None, device=None,
                               config: Optional[Sam2Config] = None,
                               **kwargs) -> Sam2VideoPredictor:
    """The reference's factory `build_sam2_video_predictor(model_cfg,
    checkpoint, device=...)`. config_file is accepted for its signature
    (the architecture comes from `config`); ckpt_path, if given, is a
    published SAM2.1 checkpoint (the fb .pt, or the same state dict as
    .safetensors) loaded with load_state_dict, else
    the weights are seeded random; device None means "cuda". The mask
    decoder's 2x2 transposed convolutions reproduce the JAX package's, whose
    converter carries the published kernels over unflipped: with published
    weights the upsampling is mirrored against the original PyTorch model
    until both packages are fixed (ROADMAP, Queue 3)."""
    params = None if ckpt_path is None else load_torch_state(ckpt_path)
    return Sam2VideoPredictor(config=config, params=params,
                              device=device or "cuda", **kwargs)
