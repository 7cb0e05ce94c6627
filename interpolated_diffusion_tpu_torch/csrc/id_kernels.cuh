// Shared declarations of the hand-written sm_90a kernels of the port.
//
// Every entry point the Python side calls is `extern "C"`, takes raw device
// pointers and a cudaStream_t, launches on that stream without synchronising,
// allocates nothing, and returns cudaGetLastError() (0 = launched).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

// Packed small-L multi-head attention (small_mha.cu). q/k/v/o address element
// (row 0, column 0) of [B*L, ld] row-major buffers; head h of row r lives at
// columns [h*Dh, (h+1)*Dh). Strides are in elements. Requires L <= 256 and
// Dh in {32, 64}.
cudaError_t launch_small_mha(const __nv_bfloat16* q, const __nv_bfloat16* k,
                             const __nv_bfloat16* v, __nv_bfloat16* o,
                             int B, int L, int H, int Dh,
                             long long ldq, long long ldk, long long ldv,
                             long long ldo, float scale, cudaStream_t stream);

__device__ __forceinline__ float id_warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}
