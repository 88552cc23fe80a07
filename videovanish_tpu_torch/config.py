"""Config tree of the port: the DiffuEraser and infill settings.

A copy of the matching dataclasses of videovanish_tpu/config.py with the
same defaults (the port keeps its own copy and imports nothing of the JAX
package). Widths are SD1.5's; `tiny_config` is the CPU-runnable smoke size.
"""
from __future__ import annotations

from dataclasses import dataclass, field


@dataclass(frozen=True)
class DiffuEraserConfig:
    """BrushNet-conditioned SD1.5 UNet + temporal attention + PCM 2-step."""
    checkpoint: str = "checkpoints/diffueraser.orbax"
    vae_checkpoint: str = "checkpoints/sd_vae_ft_mse.orbax"
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
class VVConfig:
    diffueraser: DiffuEraserConfig = field(default_factory=DiffuEraserConfig)
    infill: InfillConfig = field(default_factory=InfillConfig)


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
    )
