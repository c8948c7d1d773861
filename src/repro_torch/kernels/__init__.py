"""Hand-written CUDA kernels of the port (``csrc/*.cu``, built by
``_build.py`` at first use), their wrappers and their plain PyTorch
versions."""
