// Shared helpers of the ma_tpu_torch CUDA kernels (built for sm_90a into one
// shared library with a plain C interface; see ma_tpu_torch/kernels.py).
#pragma once

#include <cuda_runtime.h>
#include <climits>

// Every C entry point launches on the stream it is given and returns the
// launch status; the Python wrapper raises on a non-zero code.
static inline int ma_launch_status() { return static_cast<int>(cudaGetLastError()); }
