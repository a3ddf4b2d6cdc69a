"""mono_slam_framework_torch — the monocular SLAM framework in PyTorch/CUDA.

The PyTorch port of `mono_slam_framework_tpu`, written for one NVIDIA H100.
Subpackages and module names mirror the JAX package so that each module's
counterpart is easy to find. Plain tensor code is PyTorch; every kernel the
JAX package wrote in Pallas is a hand-written CUDA kernel under `csrc/`
(built on first use by `_kernels.py`), with its plain PyTorch version in the
same module. A wrapper runs the plain version for CPU tensors and launches
the kernel for CUDA tensors; it never falls back from one to the other.

This package never imports JAX: the machine with the card has none.
"""

import torch as _torch

# f32 stays f32 on the card. Matmuls already default to full f32, but cuDNN
# runs f32 convolutions in TF32 unless told otherwise, which keeps only ~3
# decimal digits and would break the detection filters' parity with the
# reference (the counterpart of the f32 matmul pin in the JAX package).
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"
