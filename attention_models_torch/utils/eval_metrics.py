"""Reconstruction quality metrics: PSNR and a VGG-feature FID.

The port's copy of ``attention_models_tpu/utils/eval_metrics.py``'s
``psnr``, ``vgg_fid_features``, ``feature_stats``, ``frechet_distance`` and
``fid_score``. The feature tower is the LPIPS VGG16 (relu5_3, global-average
pooled); the trainer's tower is seeded from a ``torch.Generator`` (seed 0),
so its numbers compare within the port, not with the JAX package's. The
Inception features of the published FID are not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

from attention_models_torch.training.losses import VGG16Features, lpips_prep


def psnr(a: torch.Tensor, b: torch.Tensor, max_val: float = 1.0
         ) -> torch.Tensor:
    """Peak signal-to-noise ratio per batch element over (c, h, w)."""
    mse = torch.mean((a.float() - b.float()) ** 2, dim=(-3, -2, -1))
    return 10.0 * torch.log10(max_val ** 2 / torch.clamp_min(mse, 1e-12))


def vgg_fid_features(tower: VGG16Features, imgs: torch.Tensor
                     ) -> torch.Tensor:
    """(b, 512) pooled relu5_3 features of NCHW images in [0, 1]."""
    return torch.mean(tower(lpips_prep(imgs.float()))[-1], dim=(2, 3))


def feature_stats(feats):
    """(mu, cov) of an (n, d) feature matrix in float64."""
    f = np.asarray(feats, np.float64)
    mu = f.mean(axis=0)
    if f.shape[0] < 2:  # np.cov would give NaN (ddof=1); define cov as 0
        return mu, np.zeros((f.shape[1], f.shape[1]))
    return mu, np.atleast_2d(np.cov(f, rowvar=False))


def frechet_distance(mu1, cov1, mu2, cov2, eps: float = 1e-6) -> float:
    """|mu1 - mu2|^2 + tr(c1 + c2 - 2 sqrtm(c1 c2)); a jittered retry covers
    near-singular covariances of small eval sets."""
    import warnings

    import scipy.linalg

    mu1, mu2 = np.asarray(mu1, np.float64), np.asarray(mu2, np.float64)
    cov1 = np.atleast_2d(np.asarray(cov1, np.float64))
    cov2 = np.atleast_2d(np.asarray(cov2, np.float64))
    diff = mu1 - mu2
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # singular products are the norm
        covmean, _ = scipy.linalg.sqrtm(cov1 @ cov2, disp=False)
        if not np.isfinite(covmean).all():
            offset = np.eye(cov1.shape[0]) * eps
            covmean, _ = scipy.linalg.sqrtm((cov1 + offset) @ (cov2 + offset),
                                            disp=False)
    if np.iscomplexobj(covmean):
        covmean = covmean.real
    return max(0.0, float(diff @ diff + np.trace(cov1) + np.trace(cov2)
                          - 2.0 * np.trace(covmean)))


def fid_score(feats_a, feats_b) -> float:
    """FID between two (n, d) feature sets."""
    return frechet_distance(*feature_stats(feats_a), *feature_stats(feats_b))
