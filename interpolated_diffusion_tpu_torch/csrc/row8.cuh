// A thread's 8 elements of a token row, for the row-walking kernels
// (qk_norm_rope.cu, ln_modulate.cu): each thread of a CTA takes 8 neighbouring
// elements of a row of D, one 16-byte access in bf16 and two in f32, loaded,
// unpacked to f32, rounded back to the row's type and stored.
#pragma once

#include <stdint.h>

#include <type_traits>

#include <cuda_bf16.h>

constexpr int kVec = 8;   // elements a thread

// A thread's 8 elements of T as they arrive from memory: one 16-byte word in
// bf16, two in f32.
template <typename T>
struct Raw8 {
  static constexpr int kWords = (int)sizeof(T) * kVec / 16;
  uint4 u[kWords];
};

template <typename T>
__device__ __forceinline__ Raw8<T> load8(const T* p) {
  Raw8<T> r;
#pragma unroll
  for (int j = 0; j < Raw8<T>::kWords; ++j) r.u[j] = reinterpret_cast<const uint4*>(p)[j];
  return r;
}

template <typename T>
__device__ __forceinline__ void store8(T* p, const Raw8<T>& r) {
#pragma unroll
  for (int j = 0; j < Raw8<T>::kWords; ++j) reinterpret_cast<uint4*>(p)[j] = r.u[j];
}

template <typename T>
__device__ __forceinline__ void unpack8(const Raw8<T>& r, float (&v)[kVec]) {
  if constexpr (std::is_same_v<T, float>) {
    const float* f = reinterpret_cast<const float*>(r.u);
#pragma unroll
    for (int i = 0; i < kVec; ++i) v[i] = f[i];
  } else {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(r.u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
}

// v rounded to T (to nearest even), packed.
template <typename T>
__device__ __forceinline__ Raw8<T> pack8(const float (&v)[kVec]) {
  Raw8<T> r;
  if constexpr (std::is_same_v<T, float>) {
    float* f = reinterpret_cast<float*>(r.u);
#pragma unroll
    for (int i = 0; i < kVec; ++i) f[i] = v[i];
  } else {
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(r.u);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  }
  return r;
}

template <typename T>
__device__ __forceinline__ float round_to(float v) {
  if constexpr (std::is_same_v<T, float>)
    return v;
  else
    return __bfloat162float(__float2bfloat16_rn(v));
}

// 8 elements of a vector given in f32 (f32 = 1) or bf16, as f32 (exact).
__device__ __forceinline__ void load8_any(const void* p, int f32, long long off,
                                          float (&v)[kVec]) {
  if (f32)
    unpack8(load8(static_cast<const float*>(p) + off), v);
  else
    unpack8(load8(static_cast<const __nv_bfloat16*>(p) + off), v);
}
