"""Image-parity metrics: SSIM and PSNR (copies of raytpu.io.metrics).

BASELINE.json's parity criterion is SSIM >= 0.99 (PSNR also tracked) against
the reference render at matched seed. Standard SSIM (Wang et al. 2004):
11x11 Gaussian window, sigma 1.5, K1=0.01, K2=0.03, dynamic range 255 on
quantised RGB (averaged over channels)."""

from __future__ import annotations

import numpy as np


def _gaussian_kernel(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    ax = np.arange(size) - (size - 1) / 2.0
    k = np.exp(-(ax**2) / (2.0 * sigma**2))
    k2 = np.outer(k, k)
    return k2 / k2.sum()


def _filter2(img: np.ndarray, kernel: np.ndarray) -> np.ndarray:
    """'valid' 2-D correlation via stride tricks (no scipy dependency)."""
    kh, kw = kernel.shape
    h, w = img.shape
    windows = np.lib.stride_tricks.sliding_window_view(img, (kh, kw))
    return np.einsum("ijkl,kl->ij", windows, kernel, optimize=True)


def ssim(a: np.ndarray, b: np.ndarray, data_range: float = 255.0) -> float:
    """Mean SSIM between two images ([H,W] or [H,W,C]), float64."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if a.ndim == 3:
        return float(
            np.mean([ssim(a[..., c], b[..., c], data_range) for c in
                     range(a.shape[-1])])
        )
    k = _gaussian_kernel()
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    mu_a = _filter2(a, k)
    mu_b = _filter2(b, k)
    mu_aa = mu_a * mu_a
    mu_bb = mu_b * mu_b
    mu_ab = mu_a * mu_b
    sig_aa = _filter2(a * a, k) - mu_aa
    sig_bb = _filter2(b * b, k) - mu_bb
    sig_ab = _filter2(a * b, k) - mu_ab
    s = ((2 * mu_ab + c1) * (2 * sig_ab + c2)) / (
        (mu_aa + mu_bb + c1) * (sig_aa + sig_bb + c2)
    )
    return float(s.mean())


def psnr(a: np.ndarray, b: np.ndarray, data_range: float = 255.0) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    mse = np.mean((a - b) ** 2)
    if mse == 0:
        return float("inf")
    return float(10.0 * np.log10(data_range**2 / mse))
