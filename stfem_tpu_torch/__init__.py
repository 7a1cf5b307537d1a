"""stfem_tpu_torch: the stfem_tpu space-time multigrid solver in PyTorch.

A port of the JAX package `stfem_tpu` (which stays the reference) to
PyTorch on an NVIDIA Hopper GPU.  The layout mirrors `stfem_tpu`: every
module here has its counterpart of the same name there.  The Pallas TPU
kernels of the main path are hand-written CUDA C++ kernels under `csrc/`
(see ops/time_solve.py and ops/kron_pair.py); everything else is plain
torch ops.  This package never imports jax or stfem_tpu.

Precision rule: the outer operator, the rhs coupling and the residual must
run at full precision.  Hopper's trap is TF32 (the TPU's was bf16 default
matmuls), so importing the package switches TF32 off for matmuls and cuDNN
and pins float32 matmuls to "highest"; operators built with
precision="highest" additionally re-assert it around every apply
(utils/precision.py).
"""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")

__version__ = "0.1.0"
