"""FVM assembly, boundary flux and the CUDA kernels (torch)."""
