"""PyTorch + CUDA port of ishapediting_tpu for NVIDIA Hopper (H100).

Generation path: noise -> ADM UNet sampling (DDPM, DDIM, DPM-Solver++(2M))
-> triplane latent -> occupancy grid -> marched and smoothed mesh. The two
fused UNet ops run as hand-written CUDA kernels on the card
(``ops/hopper_kernels.py``) and as their plain PyTorch versions on the CPU.
This package imports neither JAX nor the JAX package.
"""

__version__ = "0.1.0"
