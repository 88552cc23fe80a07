"""PCM/LCM few-step consistency sampling (port of
videovanish_tpu/models/diffueraser/scheduler.py).

SD1.5's scaled-linear beta schedule as f32 tables, the PCM phase-boundary
timesteps, the consistency boundary scalings and the deterministic
(eta = 0) transition. All arithmetic is f32, whatever the model's type.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch


@dataclass(frozen=True)
class NoiseSchedule:
    """SD1.5 scaled-linear beta schedule tables (f32 numpy)."""
    num_train_timesteps: int = 1000
    beta_start: float = 0.00085
    beta_end: float = 0.012
    alphas_cumprod: np.ndarray = field(default=None, compare=False)

    def __post_init__(self):
        betas = np.linspace(self.beta_start ** 0.5, self.beta_end ** 0.5,
                            self.num_train_timesteps, dtype=np.float64) ** 2
        acp = np.cumprod(1.0 - betas).astype(np.float32)
        object.__setattr__(self, "alphas_cumprod", acp)

    def sqrt_acp(self, t: int) -> np.float32:
        return np.sqrt(self.alphas_cumprod[t])

    def sqrt_one_minus_acp(self, t: int) -> np.float32:
        return np.sqrt(np.float32(1.0) - self.alphas_cumprod[t])

    def add_noise(self, x0: torch.Tensor, noise: torch.Tensor,
                  t) -> torch.Tensor:
        """q(x_t | x_0) = sqrt(acp_t) x0 + sqrt(1 - acp_t) eps, in f32. t is
        an int, or an integer tensor of one timestep per leading entry of x0
        (training's (B*T,) draws), broadcast over the other axes."""
        if not isinstance(t, torch.Tensor):
            return float(self.sqrt_acp(t)) * x0.float() \
                + float(self.sqrt_one_minus_acp(t)) * noise.float()
        acp = torch.from_numpy(self.alphas_cumprod).to(x0.device)[t.long()]
        shape = acp.shape + (1,) * (x0.dim() - acp.dim())
        return acp.sqrt().view(shape) * x0.float() \
            + (1.0 - acp).sqrt().view(shape) * noise.float()

    def pred_x0_from_eps(self, x_t: torch.Tensor, eps: torch.Tensor,
                         t: int) -> torch.Tensor:
        return (x_t.float() - float(self.sqrt_one_minus_acp(t)) * eps.float()) \
            / float(self.sqrt_acp(t))


def pcm_timesteps(num_inference_steps: int, num_train_timesteps: int = 1000,
                  original_inference_steps: int = 50) -> np.ndarray:
    """Phase-boundary timesteps for N-step consistency sampling (diffusers
    LCMScheduler.set_timesteps): [999, 499] for the "2-Step" PCM."""
    if num_inference_steps > original_inference_steps:
        raise ValueError(
            f"num_inference_steps={num_inference_steps} exceeds the "
            f"distillation grid ({original_inference_steps})")
    k = num_train_timesteps // original_inference_steps
    origin_ts = np.arange(1, original_inference_steps + 1) * k - 1
    skip = original_inference_steps // num_inference_steps
    return origin_ts[::-1][::skip][:num_inference_steps].astype(np.int32)


def boundary_scalings(t: int, timestep_scaling: float = 10.0,
                      sigma_data: float = 0.5):
    """Consistency boundary conditions (c_skip(t), c_out(t)) in f32."""
    s = np.float32(timestep_scaling) * np.float32(t)
    sd2 = np.float32(sigma_data ** 2)
    c_skip = sd2 / (s * s + sd2)
    c_out = s / np.sqrt(s * s + sd2)
    return np.float32(c_skip), np.float32(c_out)


def consistency_step(schedule: NoiseSchedule, x_t: torch.Tensor,
                     eps: torch.Tensor, t: int, t_next: int) -> torch.Tensor:
    """One deterministic PCM transition: predict x0 from eps at t, apply
    the boundary scalings, and re-noise to t_next with the predicted eps
    (t_next < 0: return the denoised prediction). f32 in and out."""
    x0 = schedule.pred_x0_from_eps(x_t, eps, t)
    c_skip, c_out = boundary_scalings(t)
    denoised = float(c_out) * x0 + float(c_skip) * x_t.float()
    if t_next < 0:
        return denoised
    return float(schedule.sqrt_acp(t_next)) * denoised \
        + float(schedule.sqrt_one_minus_acp(t_next)) * eps.float()
