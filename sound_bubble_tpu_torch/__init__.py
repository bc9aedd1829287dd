"""sound_bubble_tpu_torch — the PyTorch/CUDA port of `sound_bubble_tpu`.

A second package beside the JAX reference, written for one NVIDIA H100.
Module names mirror the JAX package (`ops/stft.py`, `models/tfgridnet/model.py`,
`runtime/fast_path.py`, ...) so each counterpart is easy to find. The port
imports torch, numpy and scipy only; it never imports the JAX package.

Entry points take `device="cuda"` by default and raise when no card is
present; pass `device="cpu"` to run the plain-PyTorch paths on the CPU.
"""

__version__ = "0.1.0"
