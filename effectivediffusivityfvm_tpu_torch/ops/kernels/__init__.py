"""Hand-written CUDA kernels, each beside its plain PyTorch version.

Importing these modules builds nothing: the CUDA library is compiled
(``_build.py``) the first time a wrapper is called on a CUDA tensor.
"""
