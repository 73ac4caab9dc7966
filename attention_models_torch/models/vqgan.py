"""CNN VQGAN image tokenizer (taming-transformers lineage).

Counterpart of ``attention_models_tpu/models/vqgan.py``. Images are NCHW in
and out, and the convolutions run in NCHW; the codebook sees z as (b, h, w,
c), the JAX package's NHWC, so its indices and loss come in JAX's (h, w)
order. Parameter names are the reference PyTorch ``state_dict`` keys
(``encoder.model.{i}`` / ``decoder.model.{i}`` at the plan's index i:
``block.{0,2,3,5}`` and ``channel_up`` of a residual block, ``gn.gn``,
``q``, ``k``, ``v`` of a NonLocal block, ``conv`` of a resampling block,
``gn`` of the closing GroupNorm; ``pre_quant``, ``codebook.embedding``,
``post_quant``), so a reference checkpoint loads once its NonLocal blocks'
``proj_out`` keys are dropped (``load_reference_state_dict``).

The compute dtype is separate from the parameters' dtype, as flax's
``dtype=``: every convolution casts its weight and bias to the activations'
dtype at use. JAX's rounding points are kept:
  - GroupNorm (32 groups, eps 1e-6) takes its statistics in fp32 from the
    input as flax 0.12 does, var = E[x^2] - E[x]^2 clipped at 0, and casts
    the normalised output once to the input's dtype;
  - the NonLocal block's scores are an fp32 product of the q and k
    activations, times c^-0.5, softmax in fp32, the weights cast to the
    compute dtype before the product with v; it has no ``proj_out`` (the
    reference builds one and never applies it);
  - the codebook (the CNN variant): uniform +-1/K init, z and the table
    L2-normalised in fp32, the nearest-code dots on bf16 operands only when
    z is bf16 (kernel 4 on the card), beta on the SECOND (commitment) term,
    the straight-through estimator; ``indices_to_embeddings`` does NOT
    renormalise.
Convolutions, GroupNorm, swish and the NonLocal attention are PyTorch, as
JAX leaves them to XLA; the nearest-code search is the one kernel.
"""

from __future__ import annotations

import torch
from torch import nn

from attention_models_torch.models.layers import Conv2d, lecun_normal_
from attention_models_torch.models.vitvqgan import Codebook, ViTVQGAN
from attention_models_torch.ops.codebook import l2_normalize
from attention_models_torch.ops.dispatch import resolve_device


class GroupNorm(nn.Module):
    """32-group GroupNorm with eps 1e-6 under the reference's wrapper
    (``gn.weight``, ``gn.bias``), flax's numerics."""

    groups, eps = 32, 1e-6

    def __init__(self, channels: int):
        super().__init__()
        self.gn = nn.GroupNorm(self.groups, channels, eps=self.eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c = x.shape[:2]
        xf = x.float()
        grouped = xf.reshape(b, self.groups, -1)
        mean = grouped.mean(dim=-1)
        var = torch.clamp_min((grouped * grouped).mean(dim=-1) - mean * mean,
                              0.0)
        # per channel, in flax's order: (x - mean) * (rsqrt(var + eps) * scale)
        # + bias
        per_group = c // self.groups
        shape = (b, c) + (1,) * (x.dim() - 2)
        mean = mean.repeat_interleave(per_group, dim=1).reshape(shape)
        mul = (torch.rsqrt(var + self.eps).repeat_interleave(per_group, dim=1)
               * self.gn.weight.float()).reshape(shape)
        y = (xf - mean) * mul + self.gn.bias.float().reshape((1,) + shape[1:])
        return y.to(x.dtype)


class Swish(nn.Module):
    """x * sigmoid(x)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * torch.sigmoid(x)


class ResidualBlock(nn.Module):
    """GN, swish, conv3x3, GN, swish, conv3x3 (``block.{0..5}``) plus the
    input, through a 1x1 ``channel_up`` when the width changes."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.block = nn.Sequential(
            GroupNorm(in_channels), Swish(),
            Conv2d(in_channels, out_channels, 3, padding=1),
            GroupNorm(out_channels), Swish(),
            Conv2d(out_channels, out_channels, 3, padding=1))
        if in_channels != out_channels:
            self.channel_up = Conv2d(in_channels, out_channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.block(x)
        if hasattr(self, "channel_up"):
            x = self.channel_up(x)
        return x + h


class UpSampleBlock(nn.Module):
    """Nearest x2, then a 3x3 conv."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = Conv2d(channels, channels, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
        return self.conv(x)


class DownSampleBlock(nn.Module):
    """Pad one row and one column at the far edges (0, 1, 0, 1), then a
    stride-2 3x3 conv without padding."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = Conv2d(channels, channels, 3, stride=2, padding=0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(torch.nn.functional.pad(x, (0, 1, 0, 1)))


class NonLocalBlock(nn.Module):
    """x + softmax(q k^T c^-0.5) v over the h * w positions, q, k and v 1x1
    convs of GN(x); no ``proj_out``."""

    def __init__(self, channels: int):
        super().__init__()
        self.gn = GroupNorm(channels)
        self.q = Conv2d(channels, channels, 1)
        self.k = Conv2d(channels, channels, 1)
        self.v = Conv2d(channels, channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, hh, ww = x.shape
        h_ = self.gn(x)
        q, k, v = (m(h_).reshape(b, c, hh * ww).transpose(1, 2)
                   for m in (self.q, self.k, self.v))
        attn = torch.softmax((q.float() @ k.float().transpose(1, 2))
                             * (int(c) ** -0.5), dim=2)
        out = attn.to(x.dtype) @ v
        return x + out.transpose(1, 2).reshape(b, c, hh, ww)


def encoder_plan(dim: int) -> list[tuple[str, dict]]:
    """The reference encoder's Sequential layout, as (kind, arguments) a
    plan index (the JAX package's ``encoder_plan``)."""
    channels = [128, 128, 128, 256, 256, 512]
    attn_resolutions, num_res_blocks, resolution = [16], 2, 256
    plan = [("conv_in", dict(in_channels=3, out_channels=channels[0]))]
    for i in range(len(channels) - 1):
        in_c, out_c = channels[i], channels[i + 1]
        for _ in range(num_res_blocks):
            plan.append(("res", dict(in_channels=in_c, out_channels=out_c)))
            in_c = out_c
            if resolution in attn_resolutions:
                plan.append(("attn", dict(channels=in_c)))
        if i != len(channels) - 2:
            plan.append(("down", dict(channels=channels[i + 1])))
            resolution //= 2
    c = channels[-1]
    plan += [("res", dict(in_channels=c, out_channels=c)),
             ("attn", dict(channels=c)),
             ("res", dict(in_channels=c, out_channels=c)),
             ("norm", dict(channels=c)),
             ("swish", {}),
             ("conv_out", dict(in_channels=c, out_channels=dim))]
    return plan


def decoder_plan(dim: int) -> list[tuple[str, dict]]:
    """The reference decoder's Sequential layout (the JAX package's
    ``decoder_plan``)."""
    channels = [512, 256, 256, 128, 128]
    attn_resolutions, num_res_blocks, resolution = [16], 3, 16
    in_c = channels[0]
    plan = [("conv_in", dict(in_channels=dim, out_channels=in_c)),
            ("res", dict(in_channels=in_c, out_channels=in_c)),
            ("attn", dict(channels=in_c)),
            ("res", dict(in_channels=in_c, out_channels=in_c))]
    for i, out_c in enumerate(channels):
        for _ in range(num_res_blocks):
            plan.append(("res", dict(in_channels=in_c, out_channels=out_c)))
            in_c = out_c
            if resolution in attn_resolutions:
                plan.append(("attn", dict(channels=in_c)))
        if i != 0:
            plan.append(("up", dict(channels=in_c)))
            resolution *= 2
    plan += [("norm", dict(channels=in_c)),
             ("swish", {}),
             ("conv_out", dict(in_channels=in_c, out_channels=3))]
    return plan


def _layer(kind: str, kw: dict) -> nn.Module:
    if kind in ("conv_in", "conv_out"):
        return Conv2d(kw["in_channels"], kw["out_channels"], 3, padding=1)
    return {"res": ResidualBlock, "attn": NonLocalBlock,
            "down": DownSampleBlock, "up": UpSampleBlock, "norm": GroupNorm,
            "swish": Swish}[kind](**kw)


class PlannedStack(nn.Module):
    """A plan's layers as ``model``, a Sequential indexed as the plan."""

    def __init__(self, plan: list[tuple[str, dict]]):
        super().__init__()
        self.model = nn.Sequential(*(_layer(k, kw) for k, kw in plan))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.model(x)


class CodebookCNN(Codebook):
    """The CNN variant of the codebook, on z (..., d) channels-last."""

    def __init__(self, codebook_size: int = 1024, codebook_dim: int = 256,
                 beta: float = 0.25):
        super().__init__(codebook_size, codebook_dim, beta)

    def indices_to_embeddings(self, indices: torch.Tensor) -> torch.Tensor:
        """(b, hw) -> (b, sqrt(hw), sqrt(hw), d) fp32 rows, NOT
        renormalised; indices past the table read its last row, as JAX's
        gather clamps them."""
        idx = indices.long().clamp(max=self.embedding.num_embeddings - 1)
        side = int(indices.shape[1] ** 0.5)
        return self.embedding(idx).float().reshape(
            indices.shape[0], side, side, -1)

    def forward(self, z: torch.Tensor):
        zn = l2_normalize(z.float())
        indices = self.nearest(z)
        z_q = l2_normalize(self.embedding(indices.long()).float())
        loss = (torch.mean((z_q.detach() - zn) ** 2)
                + self.beta * torch.mean((z_q - zn.detach()) ** 2))
        z_q = zn + (z_q - zn).detach()  # straight-through
        return z_q.to(z.dtype), indices, loss


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


class VQGAN(nn.Module):
    """``VQGAN(dim, codebook_size)`` as the reference constructor: ``dim``
    is also the code width. ``dtype`` is the compute dtype (None: the
    parameters' dtype). The encoder downsamples 16 times: 256 px images
    give the 16 x 16 grid that ``num_patches`` (256) states."""

    def __init__(self, dim: int, codebook_size: int,
                 dtype: torch.dtype | None = None):
        super().__init__()
        self.compute_dtype = dtype
        self.encoder = PlannedStack(encoder_plan(dim))
        self.pre_quant = Conv2d(dim, dim, 1)
        self.codebook = CodebookCNN(codebook_size, dim)
        self.post_quant = Conv2d(dim, dim, 1)
        self.decoder = PlannedStack(decoder_plan(dim))

    @property
    def dtype(self) -> torch.dtype:
        """The compute dtype."""
        return self.compute_dtype or self.pre_quant.weight.dtype

    @property
    def num_patches(self) -> int:
        return 16 * 16

    use_kernels = ViTVQGAN.use_kernels

    def _encode_features(self, imgs: torch.Tensor) -> torch.Tensor:
        """z (b, h, w, dim), channels-last as JAX's NHWC."""
        return _nhwc(self.pre_quant(self.encoder(imgs.to(self.dtype))))

    def _decode(self, z_q: torch.Tensor) -> torch.Tensor:
        return self.decoder(self.post_quant(_nchw(z_q).to(self.dtype)))

    def forward(self, imgs: torch.Tensor):
        """Images (b, 3, H, W) -> (reconstruction (b, 3, H, W) in the
        compute dtype, the codebook loss)."""
        z_q, _, loss = self.codebook(self._encode_features(imgs))
        return self._decode(z_q), loss

    def encode_imgs(self, imgs: torch.Tensor) -> torch.Tensor:
        """int32 indices (b, h * w) in (h, w) order."""
        idx = self.codebook.nearest(self._encode_features(imgs))
        return idx.reshape(imgs.shape[0], -1)

    def decode_indices(self, indices: torch.Tensor) -> torch.Tensor:
        return self._decode(self.codebook.indices_to_embeddings(indices))

    def reset_parameters(self, generator: torch.Generator) -> "VQGAN":
        """The JAX package's inits: lecun-normal conv weights, zero biases,
        GroupNorm ones / zeros, the codebook uniform in +-1/K."""
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, nn.Conv2d):
                    lecun_normal_(m.weight, generator)
                    m.bias.zero_()
                elif isinstance(m, nn.GroupNorm):
                    m.weight.fill_(1.0)
                    m.bias.zero_()
            table = self.codebook.embedding.weight
            k = table.shape[0]
            table.uniform_(-1.0 / k, 1.0 / k, generator=generator)
        return self


def load_reference_state_dict(model: VQGAN,
                              state: dict[str, torch.Tensor]) -> VQGAN:
    """A reference ``state_dict`` into ``model``, strictly, its NonLocal
    blocks' ``proj_out`` keys dropped (never applied by the reference's
    forward)."""
    model.load_state_dict({k: v for k, v in state.items()
                           if ".proj_out." not in k})
    return model


def vqgan_base(dim: int = 256, codebook_size: int = 1024,
               dtype: torch.dtype = torch.float32,
               device: str | torch.device | None = None,
               seed: int = 0) -> VQGAN:
    """The CNN tokenizer of ``inference/vqgan.py`` and ``muse_vqgan``
    (dim 256, 1024 codes) with seeded random weights (initialised on the
    CPU from ``seed``, then moved); ``device=None`` means the card."""
    dev = resolve_device(device)
    model = VQGAN(dim, codebook_size)
    model.reset_parameters(torch.Generator().manual_seed(seed))
    return model.to(device=dev, dtype=dtype).eval()
