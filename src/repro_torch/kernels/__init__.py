"""Hand-written Hopper kernels of the port and their plain versions.

``rmsnorm`` (fused norm) and ``flash_attention`` (prefill/score
attention) are CUDA C++ for ``sm_90a`` under ``csrc/``, built by
``_build`` at first use; ``ref`` holds the plain PyTorch versions and
``ops`` is the dispatch layer the models call.
"""
