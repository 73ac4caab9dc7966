"""PatchGAN discriminator, NCHW.

Counterpart of ``attention_models_tpu/models/discriminator.py``: 4x4 convs
on a stride-2 ladder, BatchNorm, LeakyReLU(0.2), a one-channel logit map.
Parameter names follow the flax module (``conv0``, ``conv1``/``bn1``, ...,
``conv_out``), so ``utils/convert.py`` maps the JAX tree key by key.

``BatchNorm`` follows flax, not ``nn.BatchNorm2d``: in training mode it
normalises with the biased batch variance, computed as
E[x^2] - E[x]^2 (flax's fast variance), and moves the running statistics
by ``ra = 0.9 * ra + 0.1 * batch`` with that same biased variance
(``BatchNorm2d`` would store the unbiased one).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from attention_models_torch.models.layers import lecun_normal_


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)`` over dim 1."""

    def __init__(self, num_features: int, momentum: float = 0.9,
                 eps: float = 1e-5):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.scale = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("mean", torch.zeros(num_features))
        self.register_buffer("var", torch.ones(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            mean = x.mean(dim=(0, 2, 3))
            var = torch.clamp_min((x * x).mean(dim=(0, 2, 3)) - mean * mean, 0.0)
            with torch.no_grad():
                m = self.momentum
                self.mean.mul_(m).add_(mean.detach(), alpha=1.0 - m)
                self.var.mul_(m).add_(var.detach(), alpha=1.0 - m)
        else:
            mean, var = self.mean, self.var
        inv = torch.rsqrt(var + self.eps) * self.scale
        return (x - mean[:, None, None]) * inv[:, None, None] \
            + self.bias[:, None, None]


class NLayerDiscriminator(nn.Module):
    def __init__(self, input_nc: int = 3, ndf: int = 64, n_layers: int = 3):
        super().__init__()
        self.n_layers = n_layers
        self.conv0 = nn.Conv2d(input_nc, ndf, 4, stride=2, padding=1)
        ch = ndf
        for n in range(1, n_layers):
            out = ndf * min(2 ** n, 8)
            setattr(self, f"conv{n}",
                    nn.Conv2d(ch, out, 4, stride=2, padding=1, bias=False))
            setattr(self, f"bn{n}", BatchNorm(out))
            ch = out
        out = ndf * min(2 ** n_layers, 8)
        setattr(self, f"conv{n_layers}",
                nn.Conv2d(ch, out, 4, stride=1, padding=1, bias=False))
        setattr(self, f"bn{n_layers}", BatchNorm(out))
        self.conv_out = nn.Conv2d(out, 1, 4, stride=1, padding=1)

    def forward(self, imgs: torch.Tensor) -> torch.Tensor:
        x = F.leaky_relu(self.conv0(imgs), 0.2)
        for n in range(1, self.n_layers + 1):
            x = getattr(self, f"bn{n}")(getattr(self, f"conv{n}")(x))
            x = F.leaky_relu(x, 0.2)
        return self.conv_out(x)

    def reset_parameters(self, generator: torch.Generator
                         ) -> "NLayerDiscriminator":
        """flax's inits: lecun-normal conv kernels, zero biases, BatchNorm
        scale 1, bias 0, running mean 0 and variance 1."""
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, nn.Conv2d):
                    lecun_normal_(m.weight, generator)
                    if m.bias is not None:
                        m.bias.zero_()
                elif isinstance(m, BatchNorm):
                    m.scale.fill_(1.0)
                    m.bias.zero_()
                    m.mean.zero_()
                    m.var.fill_(1.0)
        return self

