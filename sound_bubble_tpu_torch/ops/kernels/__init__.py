"""Hand-written CUDA kernels (sources in `sound_bubble_tpu_torch/csrc/`),
each beside its plain PyTorch version."""
