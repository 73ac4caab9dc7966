"""GAN and reconstruction losses of the VQGAN trainer, and the LPIPS tower.

Counterpart of ``attention_models_tpu/training/losses.py``. Images are NCHW
in [0, 1]. LPIPS is the VGG16 tower with unit-normalised taps, squared
differences and a 1x1 linear head per tap; with converted pretrained
weights it is the published metric, with the seeded random init it is a
fixed multi-scale structural loss (as in the JAX package).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from attention_models_torch.models.layers import lecun_normal_


def hinge_d_loss(fake_logits: torch.Tensor,
                 real_logits: torch.Tensor) -> torch.Tensor:
    """0.5 * (mean(relu(1 + fake)) + mean(relu(1 - real)))."""
    return 0.5 * (torch.mean(F.relu(1.0 - real_logits))
                  + torch.mean(F.relu(1.0 + fake_logits)))


def g_nonsaturating_loss(fake_logits: torch.Tensor) -> torch.Tensor:
    """mean(softplus(-fake))."""
    return torch.mean(F.softplus(-fake_logits))


def gradient_penalty(discr, real: torch.Tensor, fake: torch.Tensor, *,
                     eta: torch.Tensor | None = None,
                     generator: torch.Generator | None = None,
                     lambda_term: float = 10.0) -> torch.Tensor:
    """WGAN-GP with the reference's norm over the CHANNEL dim only:
    mean((sqrt(sum_c g^2 + 1e-12) - 1)^2) * lambda, g the gradient of
    sum(discr(x)) at x = eta * real + (1 - eta) * fake. ``eta`` (b, 1, 1, 1)
    is drawn uniform from ``generator`` unless given. The gradient is taken
    with ``create_graph=True``, so the penalty is differentiable in the
    discriminator's parameters (real and fake carry no graph)."""
    b = real.shape[0]
    if eta is None:
        eta = torch.rand(b, 1, 1, 1, generator=generator, device=real.device,
                         dtype=real.dtype)
    interp = (eta * real + (1.0 - eta) * fake).detach().requires_grad_(True)
    (grads,) = torch.autograd.grad(discr(interp).sum(), interp,
                                   create_graph=True)
    norm = torch.sqrt(torch.sum(grads * grads, dim=1) + 1e-12)
    return torch.mean((norm - 1.0) ** 2) * lambda_term


# VGG16 conv plan: (out_channels, pool_before); LPIPS taps the ReLU outputs
# relu1_2, relu2_2, relu3_3, relu4_3, relu5_3
_VGG16_PLAN = [
    (64, False), (64, False),
    (128, True), (128, False),
    (256, True), (256, False), (256, False),
    (512, True), (512, False), (512, False),
    (512, True), (512, False), (512, False),
]
_TAP_AFTER = {1, 3, 6, 9, 12}
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)


def lpips_prep(img: torch.Tensor) -> torch.Tensor:
    """[0, 1] images -> the LPIPS input scaling ([-1, 1], shift, scale)."""
    shift = img.new_tensor(_SHIFT)[None, :, None, None]
    scale = img.new_tensor(_SCALE)[None, :, None, None]
    return (img * 2.0 - 1.0 - shift) / scale


class VGG16Features(nn.Module):
    """The 13 3x3 convs of VGG16 (``conv0`` .. ``conv12``); returns the five
    tapped ReLU outputs, NCHW."""

    def __init__(self):
        super().__init__()
        ch = 3
        for i, (out, _) in enumerate(_VGG16_PLAN):
            setattr(self, f"conv{i}", nn.Conv2d(ch, out, 3, padding=1))
            ch = out

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        taps = []
        for i, (_, pool) in enumerate(_VGG16_PLAN):
            if pool:
                x = F.max_pool2d(x, 2, 2)
            x = F.relu(getattr(self, f"conv{i}")(x))
            if i in _TAP_AFTER:
                taps.append(x)
        return taps


class LPIPS(nn.Module):
    """lpips.LPIPS(net='vgg') equivalent; ``forward(x, y)`` takes NCHW
    images in [0, 1] and returns the per-image distance (b,)."""

    def __init__(self):
        super().__init__()
        self.vgg = VGG16Features()
        self.lins = nn.ModuleList(nn.Conv2d(ch, 1, 1, bias=False)
                                  for ch in (64, 128, 256, 512, 512))

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        fx, fy = self.vgg(lpips_prep(x)), self.vgg(lpips_prep(y))
        total = 0.0
        for a, b, lin in zip(fx, fy, self.lins):
            an = a / torch.sqrt(torch.sum(a * a, dim=1, keepdim=True) + 1e-10)
            bn = b / torch.sqrt(torch.sum(b * b, dim=1, keepdim=True) + 1e-10)
            total = total + torch.mean(lin((an - bn) ** 2), dim=(1, 2, 3))
        return total

    def reset_parameters(self, generator: torch.Generator) -> "LPIPS":
        """flax's inits (lecun-normal kernels, zero biases): the offline
        stand-in for the pretrained tower."""
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, nn.Conv2d):
                    lecun_normal_(m.weight, generator)
                    if m.bias is not None:
                        m.bias.zero_()
        return self
