"""Row binning and the CUDA transfer kernels."""
