"""CNN VQGAN tokenize + reconstruct round trip on the port:

    python -m attention_models_torch.inference.vqgan [--image PATH]
        [--ckpt PATH] [--device cuda|cpu] [--dtype float32|bfloat16]
        [--batch N] [--seed S] [--resolution 256] [--dim 256]
        [--codebook-size 1024] [--output out.jpg]

Counterpart of ``inference/vqgan.py``. ``--ckpt`` is a reference ``.pt``
(its ``state_dict``; the NonLocal blocks' unused ``proj_out`` keys are
dropped) or a checkpoint of the port's ``VQGANTrainer`` (a ``step_<n>.pt``
file or its directory: the newest step, the EMA weights over the live ones
when it kept an EMA); a path that does not exist is refused. Without
``--ckpt`` the weights are seeded random. Without ``--image`` the batch is
seeded random images. fp32 runs with TF32 off, the exact path the golden
index check needs. PIL is imported only for --image.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from attention_models_torch.inference.vitvqgan import (
    DTYPES,
    load_image,
    save_side_by_side,
)
from attention_models_torch.models.factory import load_vq_checkpoint
from attention_models_torch.models.vqgan import (
    load_reference_state_dict,
    vqgan_base,
)
from attention_models_torch.serving import vq_encode_service


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--image", default=None)
    ap.add_argument("--ckpt", default=None,
                    help="a reference .pt or a VQGANTrainer checkpoint")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--dtype", choices=sorted(DTYPES), default="float32")
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--resolution", type=int, default=256)
    ap.add_argument("--dim", type=int, default=256)
    ap.add_argument("--codebook-size", type=int, default=1024)
    ap.add_argument("--output", default=None,
                    help="side-by-side original/reconstruction (with --image)")
    args = ap.parse_args(argv)
    if args.output and not args.image:
        ap.error("--output needs --image")
    if args.ckpt and not os.path.exists(args.ckpt):
        raise SystemExit(f"--ckpt {args.ckpt!r} does not exist: refusing to "
                         f"reconstruct with random weights")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = vqgan_base(args.dim, args.codebook_size, dtype=DTYPES[args.dtype],
                       device=args.device, seed=args.seed)
    if args.ckpt:
        load_reference_state_dict(model, load_vq_checkpoint(args.ckpt))
    if args.image:
        imgs = np.repeat(load_image(args.image, args.resolution), args.batch, 0)
    else:
        imgs = np.random.RandomState(args.seed).rand(
            args.batch, 3, args.resolution, args.resolution).astype(np.float32)

    indices = vq_encode_service(model)(imgs, None)
    with torch.inference_mode():
        rec = model.decode_indices(indices).float().cpu().numpy()
    mse = float(np.mean((rec - imgs) ** 2))
    print(f"indices shape: {tuple(indices.shape)}, unique codes: "
          f"{int(torch.unique(indices).numel())}, recon mse: {mse:.6f}")
    if args.output:
        save_side_by_side(imgs, rec, args.output)
        print(f"wrote {args.output}")
    return indices, rec


if __name__ == "__main__":
    main()
