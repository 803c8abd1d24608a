// Makes `device` current for the span of one C entry point and gives the
// caller's current device back on return, so a launch never moves the
// calling thread's device behind torch's back.
#pragma once
#include <cuda_runtime.h>

struct CmdlmcDeviceGuard {
  int prev = -1;
  int device;
  cudaError_t err;

  explicit CmdlmcDeviceGuard(int dev) : device(dev) {
    err = cudaGetDevice(&prev);
    if (err == cudaSuccess && prev != device) err = cudaSetDevice(device);
  }
  ~CmdlmcDeviceGuard() {
    if (prev >= 0 && prev != device) cudaSetDevice(prev);
  }
};
