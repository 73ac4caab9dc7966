"""Muse text-to-image generation on the port:

    python -m attention_models_torch.inference.muse --prompt "stop sign"
        [--vq-ckpt VitVQGAN.pt] [--ckpt muse.pt] [--timesteps 18]
        [--guidance-scale 3.0] [--approx-topk] [--quant int8|int8_wide]
        [--resolution 256] [--dim 768] [--depth 16] [--heads 12] [--mult 8]
        [--device cuda|cpu] [--output test.jpg]

Counterpart of ``inference/muse.py`` with its defaults (the decoder of the
reference inference config: dim 768, depth 16, 12 heads, mult 8; the CLIP-L
text tower; the 256 px ViTVQGAN tokenizer). The prompt goes through
``tokenize`` (the hash tokenizer unless Hugging Face's CLIP vocabulary is on
disk). Weights are seeded (seed 0) until ``--vq-ckpt`` (a ``VitVQGAN.pt``
or the port's VQGANTrainer checkpoint) and ``--ckpt`` (a ``state_dict`` of
the port's ``MUSE``) replace them; sampling uses seed 2. ``--quant`` picks
the W8A8 decode. Pillow is imported only to write the output.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from attention_models_torch.models.factory import load_vq_checkpoint
from attention_models_torch.models.muse import MUSE
from attention_models_torch.models.text_encoder import tokenize
from attention_models_torch.ops.dispatch import resolve_device


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--prompt", default="stop sign")
    ap.add_argument("--vq-ckpt", default=None)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--output", default="test.jpg")
    ap.add_argument("--timesteps", type=int, default=18)
    ap.add_argument("--guidance-scale", type=float, default=None,
                    help="CFG scale (default: the model's, 3.0)")
    ap.add_argument("--approx-topk", dest="approx_topk", action="store_true",
                    help="bisection top-k threshold and the fused sampling "
                         "epilogue instead of the exact top-count filter")
    ap.add_argument("--resolution", type=int, default=256)
    ap.add_argument("--dim", type=int, default=768)
    ap.add_argument("--depth", type=int, default=16)
    ap.add_argument("--heads", type=int, default=12)
    ap.add_argument("--mult", type=int, default=8)
    ap.add_argument("--quant", default=None, choices=["int8", "int8_wide"],
                    help="W8A8 int8 decode (per-token dynamic activation "
                         "scales)")
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    vq_config = dict(
        vit_params=dict(dim=512, img_size=args.resolution, patch_size=8,
                        n_heads=8, d_head=64, depth=6, mlp_dim=2048,
                        dropout=0.0),
        codebook_params=dict(codebook_size=8192, codebook_dim=32))
    model = MUSE(dim=args.dim, vq_config=vq_config, n_heads=args.heads,
                 d_head=64, depth=args.depth, mult=args.mult,
                 quant=args.quant)
    model.reset_parameters(torch.Generator().manual_seed(0))
    if args.ckpt and os.path.exists(args.ckpt):
        if os.path.isdir(args.ckpt):
            raise NotImplementedError(
                f"{args.ckpt}: orbax checkpoint directories are not ported")
        model.load_state_dict(torch.load(args.ckpt, map_location="cpu"))
    if args.vq_ckpt:
        vq = load_vq_checkpoint(args.vq_ckpt)
        if vq is not None:
            model.vq.load_state_dict(vq)
    model = model.to(dev).eval()

    ids = torch.as_tensor(tokenize([args.prompt]), device=dev)
    out = model.generate(ids, timesteps=args.timesteps,
                         guidance_scale=args.guidance_scale,
                         approx_topk=args.approx_topk, seeds=[2])
    out = out.float().cpu().numpy()
    from PIL import Image

    arr = (np.clip(out[0], 0, 1) * 255).astype(np.uint8).transpose(1, 2, 0)
    Image.fromarray(arr).save(args.output)
    print(f"wrote {args.output}")
    return out


if __name__ == "__main__":
    main()
