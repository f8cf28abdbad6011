"""VibeVoice diffusion head + DPM-Solver++ (2M) sampler — port of
``qwen3_asr_swift_tpu/models/vibevoice/diffusion.py``.

The per-frame latent sampler: a 4-layer AdaLN-modulated SwiGLU head
(hidden 896, latent 64, ffn ratio 3) conditioned on the LM hidden state and
a sinusoidal timestep embedding, driven by a v-prediction DPM-Solver++
multistep scheduler (cosine ᾱ schedule, 1000 train steps) with
classifier-free guidance. The per-step coefficients are Python floats
worked out on the host (``solver_coefficients``, a copy), as the
reference's are; the start of each solve comes from the caller.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F

from ...ops.nn import acc_dtype, linear, rms_norm


@dataclasses.dataclass(frozen=True)
class DiffusionConfig:
    hidden_size: int = 896
    latent_size: int = 64
    head_layers: int = 4
    head_ffn_ratio: float = 3.0
    rms_norm_eps: float = 1e-5
    ddpm_num_steps: int = 1000
    ddpm_num_inference_steps: int = 20
    freq_embed_size: int = 256
    cfg_scale: float = 1.5

    @property
    def ffn_dim(self) -> int:
        return int(self.hidden_size * self.head_ffn_ratio)


def diffusion_config_tiny() -> DiffusionConfig:
    return DiffusionConfig(hidden_size=16, latent_size=8, head_layers=2,
                           ddpm_num_steps=50, ddpm_num_inference_steps=4,
                           freq_embed_size=8)


def draw_diffusion_params(cfg: DiffusionConfig, normal, ones) -> dict:
    """The reference's tree and scales (every linear unbiased)."""
    h = cfg.hidden_size

    def lin(d_in, d_out):
        return {"kernel": normal((d_in, d_out), 1.0 / np.sqrt(d_in))}

    return {
        "noisy_proj": lin(cfg.latent_size, h),
        "cond_proj": lin(h, h),
        "t_mlp1": lin(cfg.freq_embed_size, h),
        "t_mlp2": lin(h, h),
        "final_ada": lin(h, 2 * h),
        "final_norm": {"weight": ones(h)},
        "final_linear": lin(h, cfg.latent_size),
        "layers": [{
            "ada": lin(h, 3 * h),
            "norm": {"weight": ones(h)},
            "gate_proj": lin(h, cfg.ffn_dim),
            "up_proj": lin(h, cfg.ffn_dim),
            "down_proj": lin(cfg.ffn_dim, h),
        } for _ in range(cfg.head_layers)],
    }


def timestep_embedding(t: torch.Tensor, dim: int, max_period: float = 10000.0,
                       dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """[B] → [B, dim] in ``dtype``; cos ‖ sin order."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=dtype, device=t.device) / half)
    args = t.to(dtype)[:, None] * freqs[None, :]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def diffusion_head(p, cfg: DiffusionConfig, noisy, t, condition) -> torch.Tensor:
    """noisy [B, latent], t [B] (train-step indices), condition [B, hidden]
    → v-prediction [B, latent]."""
    x = linear(noisy, p["noisy_proj"])
    t_emb = linear(F.silu(linear(timestep_embedding(t, cfg.freq_embed_size,
                                                    dtype=acc_dtype(condition.dtype)),
                                 p["t_mlp1"])), p["t_mlp2"])
    c = linear(condition, p["cond_proj"]) + t_emb
    c_act = F.silu(c)
    for lp in p["layers"]:
        shift, scale, gate = linear(c_act, lp["ada"]).chunk(3, dim=-1)
        h = rms_norm(x, lp["norm"]["weight"], cfg.rms_norm_eps)
        h = h * (1 + scale) + shift
        h = linear(F.silu(linear(h, lp["gate_proj"])) * linear(h, lp["up_proj"]),
                   lp["down_proj"])
        x = x + gate * h
    shift, scale = linear(c_act, p["final_ada"]).chunk(2, dim=-1)
    h = rms_norm(x, p["final_norm"]["weight"], cfg.rms_norm_eps)
    return linear(h * (1 + scale) + shift, p["final_linear"])


def _alphas_cumprod(num_steps: int) -> np.ndarray:
    """Cosine ᾱ schedule via betas_for_alpha_bar
    (reference: DPMSolver.swift:31-57)."""
    t = np.arange(num_steps + 1) / num_steps
    alpha_bar = np.cos((t + 0.008) / 1.008 * np.pi / 2) ** 2
    betas = np.minimum(1 - alpha_bar[1:] / alpha_bar[:-1], 0.999)
    return np.cumprod(1.0 - betas)


def solver_coefficients(cfg: DiffusionConfig, num_inference_steps: int = None):
    """Precompute per-step (timestep, α_t, σ_t, λ) tables for the K+1 grid
    (reference: DPMSolver.swift:140-181). Returns numpy arrays."""
    k = num_inference_steps or cfg.ddpm_num_inference_steps
    n = cfg.ddpm_num_steps
    acp = _alphas_cumprod(n)
    timesteps = np.array([int(round((n - 1) * (1.0 - i / k))) for i in range(k)])
    alpha_t_train = np.sqrt(acp)
    sigmas = np.sqrt((1 - alpha_t_train[timesteps] ** 2) / (alpha_t_train[timesteps] ** 2))
    alpha_t = 1.0 / np.sqrt(sigmas ** 2 + 1.0)
    sigma_t = sigmas * alpha_t
    lam = np.log(alpha_t) - np.log(sigma_t)
    # append the final (σ=0) grid point
    alpha_t = np.append(alpha_t, 1.0)
    sigma_t = np.append(sigma_t, 0.0)
    lam = np.append(lam, np.inf)
    return timesteps.astype(np.int32), alpha_t.astype(np.float64), \
        sigma_t.astype(np.float64), lam.astype(np.float64)


def dpm_solve(p, cfg: DiffusionConfig, condition, start, neg_condition=None,
              num_inference_steps: int = None, cfg_scale: float = None) -> torch.Tensor:
    """Sample a latent [B, latent_size] by DPM-Solver++ 2M with
    v-prediction and CFG, from ``start`` [B, latent_size] (standard
    normal). The K steps run as device ops with Python-float coefficients."""
    k_steps = num_inference_steps or cfg.ddpm_num_inference_steps
    scale = cfg.cfg_scale if cfg_scale is None else cfg_scale
    timesteps, alpha_t, sigma_t, lam = solver_coefficients(cfg, k_steps)
    b = condition.shape[0]
    x = start.to(acc_dtype(condition.dtype))

    use_cfg = neg_condition is not None and scale != 1.0
    if use_cfg:
        cond_in = torch.cat([condition, neg_condition], dim=0)

    prev_x0 = torch.zeros_like(x)
    for i in range(k_steps):
        t_vec = torch.full((b,), float(timesteps[i]), dtype=torch.float32, device=x.device)
        if use_cfg:
            out = diffusion_head(p, cfg, torch.cat([x, x], dim=0),
                                 torch.cat([t_vec, t_vec], dim=0), cond_in)
            eps_c, eps_u = out[:b], out[b:]
            model_out = eps_u + scale * (eps_c - eps_u)
        else:
            model_out = diffusion_head(p, cfg, x, t_vec, condition)
        model_out = model_out.to(x.dtype)
        # v-prediction → x0
        a_s, s_s = float(alpha_t[i]), float(sigma_t[i])
        x0 = a_s * x - s_s * model_out
        a_next, s_next = float(alpha_t[i + 1]), float(sigma_t[i + 1])
        h = float(lam[i + 1] - lam[i])
        lower_order_final = (i == k_steps - 1)
        if (not lower_order_final) and i > 0:
            h0 = float(lam[i] - lam[i - 1])
            r0 = h0 / h
            d1 = (x0 - prev_x0) / r0
            sigma_ratio = s_next / s_s
            em1 = float(np.exp(-h) - 1.0)
            x = sigma_ratio * x - a_next * em1 * x0 - 0.5 * a_next * em1 * d1
        else:
            if s_s == 0.0 or not np.isfinite(h):
                x = x0
            else:
                sigma_ratio = s_next / s_s
                x = sigma_ratio * x - a_next * float(np.exp(-h) - 1.0) * x0
        prev_x0 = x0
    return x
