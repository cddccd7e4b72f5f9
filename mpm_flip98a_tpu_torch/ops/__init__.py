"""Row and pencil binning and the CUDA transfer kernels."""
