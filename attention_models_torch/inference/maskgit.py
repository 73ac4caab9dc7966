"""MaskGIT generation / inpainting on the port:

    python -m attention_models_torch.inference.maskgit [--image x.jpg]
        [--vq-ckpt VitVQGAN.pt] [--ckpt maskgit.pt] [--num-masked 100]
        [--timesteps 8] [--approx-topk] [--resolution 256] [--dim 512]
        [--depth 6] [--device cuda|cpu] [--output final.jpg]

Counterpart of ``inference/maskgit.py``: without ``--image`` it generates
from scratch, with it it inpaints the first ``--num-masked`` tokens and
writes the original beside the result. Weights are seeded (seed 0) until
``--vq-ckpt`` (a ``VitVQGAN.pt`` or the port's VQGANTrainer checkpoint) and
``--ckpt`` (a ``state_dict`` of the port's ``MaskGitTransformer``) replace
them; sampling uses seed 2. ``--quant`` picks the W8A8 decode. Pillow is
imported only for ``--image`` and for writing the output.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from attention_models_torch.inference.vitvqgan import (
    load_image,
    save_side_by_side,
)
from attention_models_torch.models.factory import load_vq_checkpoint
from attention_models_torch.models.maskgit import MaskGitTransformer
from attention_models_torch.ops.dispatch import resolve_device


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--image", default=None)
    ap.add_argument("--vq-ckpt", default=None)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--output", default="final.jpg")
    ap.add_argument("--num-masked", type=int, default=100)
    ap.add_argument("--timesteps", type=int, default=8)
    ap.add_argument("--approx-topk", dest="approx_topk", action="store_true",
                    help="bisection top-k threshold and the fused sampling "
                         "epilogue instead of the exact top-count filter")
    ap.add_argument("--resolution", type=int, default=256)
    ap.add_argument("--dim", type=int, default=512)
    ap.add_argument("--depth", type=int, default=6)
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
    model = MaskGitTransformer(dim=args.dim, vq_config=vq_config,
                               vocab_size=8192, n_heads=8, d_head=64,
                               dec_depth=args.depth, quant=args.quant)
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

    imgs = load_image(args.image, args.resolution) if args.image else None
    out = model.generate(
        torch.as_tensor(imgs, device=dev) if imgs is not None else None,
        batch=1, num_masked=args.num_masked, timesteps=args.timesteps,
        approx_topk=args.approx_topk, seeds=[2])
    out = out.float().cpu().numpy()
    if imgs is not None:
        save_side_by_side(imgs, out, args.output)
    else:
        from PIL import Image

        arr = (np.clip(out[0], 0, 1) * 255).astype(np.uint8).transpose(1, 2, 0)
        Image.fromarray(arr).save(args.output)
    print(f"wrote {args.output}")
    return out


if __name__ == "__main__":
    main()
