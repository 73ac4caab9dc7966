"""ViTVQGAN tokenize + reconstruct round trip on the port:

    python -m attention_models_torch.inference.vitvqgan [--image PATH]
        [--device cuda|cpu] [--dtype float32|bfloat16] [--batch N]
        [--seed S] [--resolution 256] [--output out.jpg]

Counterpart of ``inference/vitvqgan.py``. Weights are seeded random until a
released checkpoint is loaded (its keys are the model's own). Without
``--image`` the batch is seeded random images. fp32 runs with TF32 off, the
exact path the golden index check needs. PIL is imported only for --image.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from attention_models_torch.models.vitvqgan import vitvqgan_base
from attention_models_torch.serving import vq_encode_service

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def load_image(path: str, resolution: int) -> np.ndarray:
    from PIL import Image

    img = Image.open(path).convert("RGB").resize((resolution, resolution),
                                                 Image.BILINEAR)
    arr = np.asarray(img, np.float32) / 255.0
    return np.transpose(arr, (2, 0, 1))[None]  # (1, 3, H, W)


def save_side_by_side(orig: np.ndarray, rec: np.ndarray, path: str) -> None:
    from PIL import Image

    both = np.concatenate([orig[0], np.clip(rec[0], 0, 1)], axis=2)
    Image.fromarray((both * 255).astype(np.uint8).transpose(1, 2, 0)).save(path)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--image", default=None)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--dtype", choices=sorted(DTYPES), default="float32")
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--resolution", type=int, default=256)
    ap.add_argument("--output", default=None,
                    help="side-by-side original/reconstruction (with --image)")
    args = ap.parse_args(argv)
    if args.output and not args.image:
        ap.error("--output needs --image")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = vitvqgan_base(img_size=args.resolution, dtype=DTYPES[args.dtype],
                          device=args.device, seed=args.seed)
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
