"""CUDA kernels: build (`_build`) and the C sources under `csrc/`."""
