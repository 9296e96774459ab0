"""Hand-written Hopper kernels of the port and their plain versions.

``rmsnorm`` (fused norm; differentiable, its backward a closed form),
``flash_attention`` (prefill/score/training attention, with its
backward kernel ``csrc/flash_attention_bwd.cu``), ``decode_attention``
(one token against a KV cache), ``mamba_scan`` (the Mamba block's
selective scan, with its backward kernel ``csrc/mamba_scan_bwd.cu``)
and ``sim_fill`` (the
planner's FIFO fill over a candidate grid) are CUDA C++ for
``sm_90a`` under ``csrc/``, built by ``_build`` at first use; ``ref``
holds the plain PyTorch versions of the model kernels (``sim_fill``
keeps its own beside its wrapper) and ``ops`` is the dispatch layer the
models call.
"""
