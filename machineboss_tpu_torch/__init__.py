"""PyTorch/CUDA port of machineboss_tpu for NVIDIA Hopper (H100).

Imports torch and numpy only, never jax or machineboss_tpu. Entry points
run on the CUDA card unless the caller passes device="cpu".
"""
