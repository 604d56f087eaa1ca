"""PSNR / SSIM (numpy)."""

from pesr_torch.metrics.psnr_ssim import calc_psnr, calc_ssim  # noqa: F401
