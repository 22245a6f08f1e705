"""PyTorch port of Quake (adaptive partitioned vector search) for NVIDIA
Hopper GPUs, beside the JAX package ``repro``; ``models`` also holds the
repository's LM serving path (prefill and decode).

The port imports torch, numpy and scipy only.  Its kernels are written by
hand in CUDA C++ (``kernels/csrc``) and built with nvcc at first use;
each has a plain PyTorch version beside it for CPU tensors.  Entry points
run on ``device="cuda"`` unless the caller passes ``device="cpu"``.
"""
import torch

# f32 parity with the reference: matrix products and convolutions in full
# f32, never TF32 (these are PyTorch's defaults for matmul; set here so
# the port does not depend on them).
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
# bf16 matrix products accumulate in f32, as the JAX package's do
torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
