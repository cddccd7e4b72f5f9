"""Hand-written CUDA kernels (sources in mpm_flip98a_tpu_torch/csrc) and their plain PyTorch versions."""
