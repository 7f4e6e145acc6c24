"""Evaluation for the PyTorch port: the InceptionV3 FID extractor
(`inception.py`), FID statistics and the `ref` / `calc` CLI (`fid.py`),
SSIM (`ssim.py`) and RMSE between image directories (`mse.py`).
Counterpart of `prompt_diffusion_tpu/evaluation/`."""
