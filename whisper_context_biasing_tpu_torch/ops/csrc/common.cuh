// Shared helpers for the port's hand-written Hopper kernels.
//
// Each kernel source builds into its own shared library with a plain C
// interface (see ops/_build.py): the launchers take raw device pointers,
// sizes and the caller's CUDA stream, launch on that stream without
// synchronising, and return cudaGetLastError() so the Python wrapper can
// raise on a refused launch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cfloat>
#include <cstdint>

#define WCB_EXPORT extern "C" __attribute__((visibility("default")))

// dtype codes shared with the Python wrappers
enum WcbDtype { WCB_F32 = 0, WCB_BF16 = 1 };

template <typename T>
__device__ __forceinline__ float to_f32(T x);
template <>
__device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as a dtype cast
}

// Round an f32 value to T's precision and back: the kernels' counterpart of
// casting an f32 intermediate to the compute dtype before a matmul.
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f32<T>(from_f32<T>(x));
}

// Registers, shared memory (static + dynamic), local memory (stack and
// spills), resident blocks per SM and threads per block of a kernel, for
// reports: out[0..4].
template <typename Kernel>
int kernel_info(Kernel* kernel, int threads, size_t dyn_smem, int* out) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(dyn_smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads, dyn_smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.sharedSizeBytes + dyn_smem);
  out[2] = static_cast<int>(attr.localSizeBytes);
  out[3] = blocks;
  out[4] = threads;
  return 0;
}

WCB_EXPORT const char* wcb_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
