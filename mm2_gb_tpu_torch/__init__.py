"""mm2-gb-tpu-torch: the mapper's device path on PyTorch and CUDA.

The PyTorch port of `mm2_gb_tpu` for one NVIDIA Hopper GPU.  It reuses
the JAX package's host layer (index, sketch, seed, host chaining,
hit post-processing, PAF/SAM; none of it imports JAX) and replaces the
modules that import JAX:

- ops.chain_gpu: range selection, segment cutting and the chain DP, a
  hand-written CUDA kernel (csrc/chain_kernel.cu) with a plain PyTorch
  twin for CPU tensors;
- models.pipeline: seed -> device chain -> backtrack/post-process;
- utils.gpucfg: the --gpu-cfg batch configuration;
- utils.kernels: builds csrc/*.cu on first use;
- cli: `python -m mm2_gb_tpu_torch --gpu-chain ref.fa reads.fa`.

Importing this package never imports JAX.
"""

__version__ = "0.1.0"
