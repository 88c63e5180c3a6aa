"""Hand-written Hopper kernels, built from ../../csrc with nvcc on first use."""
