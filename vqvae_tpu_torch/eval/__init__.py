"""Evaluation: L2 / PSNR / SSIM, the FID InceptionV3 and rFID."""
