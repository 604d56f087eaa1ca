"""Evaluation metrics (numpy, on the host): PSNR / SSIM and the PIRM
perceptual index (NIQE, Ma)."""

from pesr_torch.metrics.psnr_ssim import calc_psnr, calc_ssim
from pesr_torch.metrics.niqe import NiqeModel, fit_niqe_model, niqe
from pesr_torch.metrics.ma import ma_score
from pesr_torch.metrics.pirm import evaluate_dir, perceptual_index

__all__ = [
    "calc_psnr", "calc_ssim",
    "niqe", "fit_niqe_model", "NiqeModel",
    "ma_score", "perceptual_index", "evaluate_dir",
]
