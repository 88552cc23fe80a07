"""Config tree of the port: the SAM2, ProPainter, DiffuEraser, infill,
chunking and mesh settings.

A copy of the matching dataclasses of videovanish_tpu/config.py with the
same defaults (the port keeps its own copy and imports nothing of the JAX
package), except that the checkpoint paths name torch files in place of
orbax directories. Widths are the published SAM2.1 Hiera-L, ProPainter and
SD1.5 ones; `tiny_config` is the CPU-runnable smoke size.
"""
from __future__ import annotations

from dataclasses import dataclass, field


@dataclass(frozen=True)
class MeshConfig:
    """Logical mesh axes over the ranks of torch.distributed, resolved
    when the mesh is built (`core/mesh.py`).

    data  : frames and temporal windows (data and sequence parallelism)
    model : attention heads (tensor parallelism)
    """
    data: int = -1  # -1: every rank the model axis leaves
    model: int = 1


@dataclass(frozen=True)
class Sam2Config:
    """Hiera-L SAM2.1 video predictor (the published
    sam2.1_hiera_large.pt architecture)."""
    checkpoint: str = "checkpoints/sam2.1_hiera_large.pt"  # as published
    image_size: int = 1024
    # Hiera-L stages
    hiera_embed_dim: int = 144
    hiera_num_heads: int = 2
    hiera_stages: tuple[int, ...] = (2, 6, 36, 4)
    hiera_window_spec: tuple[int, ...] = (8, 4, 16, 8)
    hiera_global_att_blocks: tuple[int, ...] = (23, 33, 43)
    hiera_window_pos_embed_bkg_spatial_size: tuple[int, int] = (7, 7)
    # FPN neck
    neck_d_model: int = 256
    backbone_channel_list: tuple[int, ...] = (1152, 576, 288, 144)
    # memory attention / memory encoder
    mem_dim: int = 64
    num_maskmem: int = 7  # ring buffer of 6 recent + 1 conditioning slot
    max_obj_ptrs_in_encoder: int = 16
    memory_attention_layers: int = 4
    memory_attention_d_model: int = 256
    # mask decoder
    num_multimask_outputs: int = 3
    iou_head_depth: int = 3
    # frame format handed to the encoder during propagation: "yuv420" (I420,
    # 2x2 chroma subsampling, half the bytes of RGB) or "rgb" (exact)
    wire: str = "yuv420"


@dataclass(frozen=True)
class ProPainterConfig:
    """Flow-guided inpainting prior: RAFT, recurrent flow completion and the
    InpaintGenerator at the published checkpoints' widths."""
    # the three published files as they ship
    checkpoint: str = "checkpoints/ProPainter.pth"  # InpaintGenerator
    raft_checkpoint: str = "checkpoints/raft-things.pth"
    flowcomp_checkpoint: str = "checkpoints/recurrent_flow_completion.pth"
    ref_stride: int = 10
    neighbor_length: int = 10
    subvideo_length: int = 50
    raft_iters: int = 20  # published inference default
    # internal processing resolution cap (long side), multiple of 8; the
    # all-pairs RAFT correlation grows with the square of the tokens
    max_img_size: int = 432
    # InpaintGenerator widths (128/512/8 are the published sizes)
    channels: int = 128
    hidden: int = 512
    depths: int = 8
    num_heads: int = 4
    window: tuple[int, int] = (5, 9)
    pool: tuple[int, int] = (4, 4)
    t_dilation: int = 2
    ffn_channels: int = 40   # FusionFeedForward hidden = 49 * this
    flowcomp_base: int = 32  # RecurrentFlowCompleteNet stem width


@dataclass(frozen=True)
class DiffuEraserConfig:
    """BrushNet-conditioned SD1.5 UNet + temporal attention + PCM 2-step."""
    # {vae, unet, brushnet, null_text_emb}, written by
    # `python -m benchmark.reference.vvref.cli.convert --assemble diffueraser`
    checkpoint: str = "checkpoints/diffueraser.pt"
    # read only without `checkpoint`: sd-vae-ft-mse as published or converted
    vae_checkpoint: str = "checkpoints/sd_vae_ft_mse.safetensors"
    ckpt: str = "2-Step"  # PCM phased-consistency 2-step LoRA schedule
    num_inference_steps: int = 2
    guidance_scale: float = 0.0
    max_img_size: int = 960  # long side, multiple of 8
    # the GUI's interactive preview renders at this lower long side
    preview_img_size: int = 640
    # temporal clip handling (overlapping windows)
    clip_length: int = 22
    clip_overlap: int = 6
    # compute BrushNet features at the first PCM step only and reuse them
    # at later steps; False gives the exact per-step reference
    brushnet_feature_reuse: bool = True
    # record the UNet's Transformer2D attention outputs (spatial self and
    # text cross) at PCM step 1 and replay them at later steps; the motion
    # modules' temporal attention always recomputes. False gives the exact
    # per-step reference
    spatial_attn_reuse: bool = True
    # SD1.5 UNet shape
    sample_channels: int = 4
    block_out_channels: tuple[int, ...] = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    cross_attention_dim: int = 768
    attention_head_dim: int = 8
    # VAE
    vae_latent_channels: int = 4
    vae_block_out_channels: tuple[int, ...] = (128, 256, 512, 512)
    vae_scaling_factor: float = 0.18215


@dataclass(frozen=True)
class InfillConfig:
    """run_infill_on_frames defaults."""
    mask_dilation_iter: int = 8
    keep_unmasked_original: bool = True
    feather_px: int = 3
    max_img_size: int = 960


@dataclass(frozen=True)
class ChunkingConfig:
    """Chunked long-video runs (`pipeline/chunking.py`): chunks of
    `chunk_frames` sharing `overlap_frames` with their neighbours, blended
    in latent space (f32 accumulators)."""
    chunk_frames: int = 48
    overlap_frames: int = 8


@dataclass(frozen=True)
class VVConfig:
    sam2: Sam2Config = field(default_factory=Sam2Config)
    propainter: ProPainterConfig = field(default_factory=ProPainterConfig)
    diffueraser: DiffuEraserConfig = field(default_factory=DiffuEraserConfig)
    infill: InfillConfig = field(default_factory=InfillConfig)
    chunking: ChunkingConfig = field(default_factory=ChunkingConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)


def default_config() -> VVConfig:
    return VVConfig()


def tiny_config() -> VVConfig:
    """CPU-runnable smoke config: tiny channel counts, short clips."""
    return VVConfig(
        diffueraser=DiffuEraserConfig(
            max_img_size=256,
            clip_length=8,
            clip_overlap=2,
            block_out_channels=(32, 64, 64, 64),
            layers_per_block=1,
            cross_attention_dim=64,
            attention_head_dim=8,
            vae_block_out_channels=(16, 32, 32, 32),
        ),
        propainter=ProPainterConfig(
            max_img_size=256, raft_iters=2, channels=32, hidden=128,
            depths=2, ffn_channels=5, flowcomp_base=8,
            neighbor_length=4, ref_stride=4, subvideo_length=16,
        ),
        sam2=Sam2Config(
            image_size=128,
            hiera_embed_dim=32,
            hiera_stages=(1, 2, 2, 1),
            hiera_window_spec=(4, 4, 4, 4),
            hiera_global_att_blocks=(3,),
            backbone_channel_list=(256, 128, 64, 32),
            neck_d_model=64,
            mem_dim=16,
            memory_attention_layers=2,
            memory_attention_d_model=64,
            max_obj_ptrs_in_encoder=4,
        ),
        chunking=ChunkingConfig(chunk_frames=8, overlap_frames=2),
    )
