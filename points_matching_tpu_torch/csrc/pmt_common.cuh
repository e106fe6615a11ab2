// Shared helpers for the port's CUDA kernels (plain C interface, no
// PyTorch headers: the library is loaded with ctypes).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define PMT_EXPORT extern "C" __attribute__((visibility("default")))

// Every entry point returns the launch status: cudaGetLastError() right
// after the launch, so a launch the CUDA runtime refused is reported by the
// wrapper instead of being silently skipped.
#define PMT_RETURN_LAUNCH_STATUS() return static_cast<int>(cudaGetLastError())

constexpr float kPmtBig = 1e30f;  // "+inf" sentinel of the reference kernels
