"""mm2-gb-tpu-torch: the mapper's device path on PyTorch and CUDA.

The PyTorch port of `mm2_gb_tpu` for one NVIDIA Hopper GPU.  It carries
its own copy of the JAX package's host layer, under the same module
names (utils: options, FASTA/Q, hashes, sorts, PAF/SAM, the C++ host kit
in csrc/host built into build/hostkit; ops: sketch, seed, host chaining,
the ksw2 oracles, the align driver; models: index, hit, mapper, pe,
stream, splitmerge), and replaces the modules that import JAX:

- ops.chain_gpu: range selection, segment cutting and the chain DP, a
  hand-written CUDA kernel (csrc/chain_kernel.cu) with a plain PyTorch
  twin for CPU tensors;
- ops.ksw2_gpu, ops.ksw2s_gpu: the gap fills and extensions of
  --gpu-align (csrc/extd2_kernel.cu, csrc/exts2_kernel.cu);
- models.pipeline: seed -> device chain -> device fills -> backtrack and
  post-process;
- utils.gpucfg: the --gpu-cfg batch configuration;
- utils.kernels: builds csrc/*.cu on first use;
- cli: `python -m mm2_gb_tpu_torch --gpu-chain ref.fa reads.fa`.

Like the JAX package it also carries the mappy-compatible Python API
(api, which maps on the card unless device="cpu" asks for the host; its
maps take turns under one lock), paftools and mmphase (tools) and the
MM2TPU_TIMELINE=1 phase marks (utils.timeline).  utils.e2ebench times
the CLI against a baseline command, byte for byte.

Importing this package never imports JAX, nor any module of mm2_gb_tpu.
"""

__version__ = "0.1.0"

from mm2_gb_tpu_torch.utils.opts import IndexOptions, MapOptions, set_preset

__all__ = [
    "IndexOptions",
    "MapOptions",
    "set_preset",
    "__version__",
]
