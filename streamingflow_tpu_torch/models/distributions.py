"""Latent distribution heads (Gaussian / MixGaussian / Bernoulli).

Port of streamingflow_tpu/models/distributions.py.  The reference builds
neither module on its shipped path (its ``present_distribution`` is never
called by the forward), so the model exposes the head as
``StreamingFlow.distribution_forward`` behind PROBABILISTIC.ENABLED, as the
JAX package does.  The present state comes channels-last,
(B, 1, H, W, C); the convolutions run NCHW inside.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..layers.conv import Bottleneck, conv2d


class DistributionEncoder(nn.Module):
    """Four stride-2 Bottlenecks."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        for i in range(4):
            self.add_module(f'Bottleneck_{i}',
                            Bottleneck(cin if i == 0 else cout, cout,
                                       downsample=True))

    def forward(self, x):
        for i in range(4):
            x = getattr(self, f'Bottleneck_{i}')(x)
        return x


class DistributionModule(nn.Module):
    """Present state -> latent distribution parameters.

    GAUSSIAN -> (B, 1, 2 L); MIXGAUSSIAN -> (B, 1, 6 L + 3); BERNOULLI ->
    per-pixel log-probabilities (B, 1, H, W, L)."""

    def __init__(self, in_channels: int, latent_dim: int,
                 method: str = 'GAUSSIAN'):
        super().__init__()
        self.method = method
        if method in ('GAUSSIAN', 'MIXGAUSSIAN'):
            self.out_dim = (2 * latent_dim if method == 'GAUSSIAN'
                            else 6 * latent_dim + 3)
            compress = in_channels // 2
            self.encoder = DistributionEncoder(in_channels, compress)
            self.decoder = conv2d(compress, self.out_dim, 1, bias=True)
        elif method == 'BERNOULLI':
            self.encoder = Bottleneck(in_channels, latent_dim)
        else:
            raise NotImplementedError(method)

    def forward(self, s_t):
        """s_t: (B, 1, H, W, C)."""
        b, s = s_t.shape[:2]
        x = s_t[:, 0].permute(0, 3, 1, 2)
        if self.method == 'BERNOULLI':
            h = self.encoder(x)
            return F.logsigmoid(h).permute(0, 2, 3, 1)[:, None]
        h = self.encoder(x).mean(dim=(2, 3), keepdim=True)
        return self.decoder(h).reshape(b, s, self.out_dim)


def distribution_forward(params: torch.Tensor, latent_dim: int, method: str,
                         hw: Tuple[int, int],
                         generator: Optional[torch.Generator],
                         min_log_sigma: float = -5.0,
                         max_log_sigma: float = 5.0) -> torch.Tensor:
    """A latent sampled from the distribution parameters and broadcast over
    space: (B, 1, H, W, latent_dim).  Noise is standard normal from
    ``generator``; None means zero noise (the mean; the Bernoulli
    probabilities)."""
    h, w = hw

    def noise_like(x):
        if generator is None:
            return torch.zeros_like(x)
        return torch.randn(x.shape, generator=generator, dtype=x.dtype,
                           device=x.device)

    def mu_sigma_sample(p):
        mu = p[..., :latent_dim]
        log_sigma = p[..., latent_dim:2 * latent_dim].clamp(min_log_sigma,
                                                            max_log_sigma)
        return mu + torch.exp(log_sigma) * noise_like(mu)

    if method == 'GAUSSIAN':
        sample = mu_sigma_sample(params)
    elif method == 'MIXGAUSSIAN':
        samples = [mu_sigma_sample(params[..., 2 * i * latent_dim:
                                          2 * (i + 1) * latent_dim])
                   for i in range(3)]
        coeff = torch.softmax(params[..., 6 * latent_dim:], dim=-1)
        sample = sum(samples[i] * coeff[..., i:i + 1] for i in range(3))
    elif method == 'BERNOULLI':
        return torch.exp(params) + noise_like(params)
    else:
        raise NotImplementedError(method)
    b, s = params.shape[:2]
    return sample[:, :, None, None, :].expand(b, s, h, w, latent_dim)
