// WanDiT's q/k RMSNorm + RoPE, forward and backward, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package's WanDiT (models/wan_dit.py) writes
// its q/k RMSNorm and its RoPE in plain jnp, which XLA fuses into the
// neighbouring operations. The port ran them as PyTorch's ops, one pass over
// [B, L, D] each: 17 forward and 32 in the backward, most of them on f32
// copies (x.float() twice, the square, the mean, the product by rsqrt, two
// casts, the weight's product, four strided products, a difference, a sum,
// the stack and the cast back). At Wan2.1-1.3B's training shapes that chain
// moved ~576 GB a Phase-1 step, the largest single share of the step's
// elementwise traffic. Here one kernel reads the row once and writes q once,
// and one kernel does the whole backward.
//
// What bounds it on the H100: bytes (well under one FLOP a byte). Forward, per
// token row: read x (2D bytes in bf16) and the row's cos / sin (2 x Dh/2 f32,
// shared by the row's heads through L1), write q (2D bytes) and one f32 rstd.
// Backward: read dq, x, rstd and cos / sin, write dx (2D bytes). At
// [2, 7800, 1536] in bf16 that is ~100 MB and ~150 MB: ~30 us and ~45 us at
// 3.35 TB/s. An f32 model (x, q, dq and dx in f32) moves twice the row bytes.
//
// Design: a CTA takes a token row at a time, D / 8 threads, each 8 elements
// (one 16-byte access in bf16, two in f32) = four whole RoPE pairs of one head
// (Dh % 8 == 0), so no value crosses a lane. The mean square is a warp shuffle
// sum, then one over the warps through shared memory: two barriers a row. As
// many CTAs as the card holds at once walk the rows (a grid-stride loop; the
// caller sizes the grid from id_qk_norm_rope_resident), each loading its next
// row before it reduces this one, so that loads stay in flight across the
// barriers and the stores. On an H100 80GB HBM3 at 700 W this reads 65%
// (forward) and 70% (backward) of the bound above at [2, 7800, 1536]; one CTA
// a row, 49% and 65%. With RoPE, q is written head-major [B, H, L, Dh], the
// layout the attention takes, so no transpose copy follows; without RoPE
// (cross-attention) it keeps x's [B, L, D].
//
// Rounding points are those of the plain twin (kernels/qk_norm_rope.py:
// rms_norm, which models/wan_dit.RMSNorm.forward calls, then apply_rope), T
// being x's dtype (bf16 or f32; rounding to f32 is exact):
//   ms   = f32 sum of the f32 squares, times fl(1 / D)    (the sum's order differs)
//   rstd = rsqrtf(ms + eps)
//   n    = T(x * rstd),  y = T(n * T(w))
//   q    = T(y1 c - y2 s), T(y1 s + y2 c)                 (f32 products, no FMA)
// so that for the same rstd the output is the twin's bit for bit; the order of
// the sum moves rstd by a few f32 ulps and, rarely, n by one ulp of T.
// The backward is f32 throughout and rounds dx to T once:
//   g  = the un-rotated dq (g1 c + g2 s, g2 c - g1 s),  dn = g * T(w),  n^ = x * rstd
//   dx = rstd * (dn - n^ * mean(dn * n^)),               dw = sum over rows of g * n^
// where the twin's autograd rounds its gradients to T at every cast. dw goes
// out as one f32 partial sum a CTA, [gridDim.x, D], which the wrapper sums
// (only when the weight wants a gradient: full fine-tuning).
//
// Two more forms, for HunyuanVideo's joint attention (models/hunyuan_video.py):
//  - per head (kPerHead): the weight is [Dh] and the mean square is taken over
//    each head's Dh lanes instead of the row's D, as diffusers' RMSNorm over
//    [B, H, L, Dh] does. A head's lanes are Dh / 8 neighbouring threads of one
//    warp (Dh a power of two, 8 .. 256), so its sums are shuffles: no barrier.
//    rstd is then [rows, H], and dw's partial sums [gridDim.x, D] fold over
//    the heads in the wrapper;
//  - rope_rows: RoPE rotates tokens l < rope_rows of each batch row only (the
//    video rows ahead of the text rows of a joint sequence); the tables are
//    [B or 1, rope_rows, Dh / 2] and the other rows pass unrotated (cos 1,
//    sin 0: the same values), still written head-major.
#include "id_kernels.cuh"
#include "row8.cuh"

namespace {

using bf16 = __nv_bfloat16;
constexpr int kMaxThreads = 1024;

// T(w[d0 .. d0 + 8)) as f32; w is f32 (a master copy) or bf16.
template <typename T>
__device__ __forceinline__ void load_weight(const void* w, int w_f32, int d0, float (&wt)[kVec]) {
  load8_any(w, w_f32, d0, wt);
#pragma unroll
  for (int i = 0; i < kVec; ++i) wt[i] = round_to<T>(wt[i]);
}

// The sum of v over the `lanes` neighbouring threads of a head (a power of
// two <= 32, aligned in the warp), in each of them; every lane calls it.
__device__ __forceinline__ float head_sum(float v, int lanes) {
  for (int off = lanes / 2; off > 0; off /= 2) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// The CTA's sum of v, in every thread, summed in the same order in each; every
// thread of the CTA calls it.
__device__ __forceinline__ float block_sum(float v, float* red) {
  v = id_warp_sum(v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.f;
  for (int i = 0; i < (int)(blockDim.x >> 5); ++i) s += red[i];
  __syncthreads();   // red is written again by the next call
  return s;
}

// One row's inputs as they arrive: x's 8 elements, with RoPE the four pairs'
// cos / sin, in the backward also dq's 8 elements (the un-rotated layout's order).
template <typename T>
struct RowIn {
  Raw8<T> x, dq;
  float4 c, s;
};

// Where a thread's 8 elements lie in the head-major [B, H, L, Dh] layout:
// element d0 of a token row is column d0 % Dh of head d0 / Dh, and the other 7
// follow it in the same head. The same for every row of a thread.
struct HeadCol {
  int head, col;
};

__device__ __forceinline__ HeadCol head_col(int d0, int Dh) { return {d0 / Dh, d0 % Dh}; }

__device__ __forceinline__ long long head_major(long long b, int l, int L, int H, int Dh,
                                                HeadCol hc) {
  return ((b * H + hc.head) * L + l) * Dh + hc.col;
}

// Issue the loads of `row` (nothing past the last row or for an idle thread).
// With dq, the backward's: dq is [rows, D] without RoPE, head-major with it.
// Tokens at or past rope_rows get cos 1, sin 0.
template <typename T>
__device__ __forceinline__ RowIn<T> load_row(const T* x, const T* dq, const float* cos_t,
                                             const float* sin_t, long long cs_batch,
                                             int rope_rows, long long row, long long rows,
                                             bool active, int L, int D, int H, int Dh, int d0,
                                             HeadCol hc) {
  RowIn<T> in = {};
  if (!active || row >= rows) return in;
  in.x = load8(x + row * D + d0);
  const long long b = row / L;
  const int l = (int)(row - b * L);
  if (cos_t != nullptr) {
    if (l < rope_rows) {
      const long long cs = b * cs_batch + (long long)l * (Dh / 2) + hc.col / 2;
      in.c = *reinterpret_cast<const float4*>(cos_t + cs);
      in.s = *reinterpret_cast<const float4*>(sin_t + cs);
    } else {
      in.c = make_float4(1.f, 1.f, 1.f, 1.f);
      in.s = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    if (dq != nullptr) in.dq = load8(dq + head_major(b, l, L, H, Dh, hc));
  } else if (dq != nullptr) {
    in.dq = load8(dq + row * D + d0);
  }
  return in;
}

// Both kernels walk rows with a grid-stride loop and load row n + gridDim.x
// before they reduce row n, so that a row's loads are in flight while the CTA
// waits at the reduction's barriers and stores.
template <typename T, bool kPerHead>
__global__ void __launch_bounds__(kMaxThreads)
qk_norm_rope_fwd_kernel(const T* __restrict__ x, const void* __restrict__ w, int w_f32,
                        const float* __restrict__ cos_t, const float* __restrict__ sin_t,
                        long long cs_batch, int rope_rows, T* __restrict__ out,
                        float* __restrict__ rstd, long long rows, int L, int D, int H, int Dh,
                        float eps) {
  __shared__ float red[kMaxThreads / 32];
  const int d0 = threadIdx.x * kVec;
  const bool active = d0 < D;
  const HeadCol hc = head_col(d0, Dh);
  const float inv_d = __frcp_rn((float)(kPerHead ? Dh : D));
  float wt[kVec] = {};
  if (active) load_weight<T>(w, w_f32, kPerHead ? hc.col : d0, wt);
  RowIn<T> next = load_row<T>(x, nullptr, cos_t, sin_t, cs_batch, rope_rows, blockIdx.x, rows,
                              active, L, D, H, Dh, d0, hc);
  for (long long row = blockIdx.x; row < rows; row += gridDim.x) {
    const RowIn<T> in = next;
    next = load_row<T>(x, nullptr, cos_t, sin_t, cs_batch, rope_rows, row + gridDim.x, rows,
                       active, L, D, H, Dh, d0, hc);
    float v[kVec];
    unpack8(in.x, v);
    float ss = 0.f;
#pragma unroll
    for (int i = 0; i < kVec; ++i) ss = __fadd_rn(ss, __fmul_rn(v[i], v[i]));
    float r;
    if constexpr (kPerHead) {
      r = rsqrtf(__fadd_rn(__fmul_rn(head_sum(ss, Dh / kVec), inv_d), eps));
      if (active && hc.col == 0) rstd[row * H + hc.head] = r;
    } else {
      r = rsqrtf(__fadd_rn(__fmul_rn(block_sum(ss, red), inv_d), eps));
      if (threadIdx.x == 0) rstd[row] = r;
    }
    if (!active) continue;
    float y[kVec];
#pragma unroll
    for (int i = 0; i < kVec; ++i)
      y[i] = round_to<T>(__fmul_rn(round_to<T>(__fmul_rn(v[i], r)), wt[i]));
    if (cos_t == nullptr) {
      store8(out + row * D + d0, pack8<T>(y));
      continue;
    }
    const float c[4] = {in.c.x, in.c.y, in.c.z, in.c.w}, s[4] = {in.s.x, in.s.y, in.s.z, in.s.w};
    float o[kVec];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float y1 = y[2 * i], y2 = y[2 * i + 1];
      o[2 * i] = __fsub_rn(__fmul_rn(y1, c[i]), __fmul_rn(y2, s[i]));
      o[2 * i + 1] = __fadd_rn(__fmul_rn(y1, s[i]), __fmul_rn(y2, c[i]));
    }
    const long long b = row / L;
    store8(out + head_major(b, (int)(row - b * L), L, H, Dh, hc), pack8<T>(o));
  }
}

template <typename T, bool kPerHead>
__global__ void __launch_bounds__(kMaxThreads)
qk_norm_rope_bwd_kernel(const T* __restrict__ dq, const T* __restrict__ x,
                        const void* __restrict__ w, int w_f32, const float* __restrict__ cos_t,
                        const float* __restrict__ sin_t, long long cs_batch, int rope_rows,
                        const float* __restrict__ rstd, T* __restrict__ dx,
                        float* __restrict__ dw_part, long long rows, int L, int D, int H,
                        int Dh) {
  __shared__ float red[kMaxThreads / 32];
  const int d0 = threadIdx.x * kVec;
  const bool active = d0 < D;
  const HeadCol hc = head_col(d0, Dh);
  const float inv_d = __frcp_rn((float)(kPerHead ? Dh : D));
  float wt[kVec] = {}, dw[kVec] = {};
  if (active) load_weight<T>(w, w_f32, kPerHead ? hc.col : d0, wt);
  RowIn<T> next = load_row<T>(x, dq, cos_t, sin_t, cs_batch, rope_rows, blockIdx.x, rows,
                              active, L, D, H, Dh, d0, hc);
  for (long long row = blockIdx.x; row < rows; row += gridDim.x) {
    const RowIn<T> in = next;
    next = load_row<T>(x, dq, cos_t, sin_t, cs_batch, rope_rows, row + gridDim.x, rows, active,
                       L, D, H, Dh, d0, hc);
    float r;
    if constexpr (kPerHead)
      r = active ? rstd[row * H + hc.head] : 0.f;
    else
      r = rstd[row];
    float xv[kVec], g[kVec];
    unpack8(in.x, xv);
    unpack8(in.dq, g);
    if (cos_t != nullptr) {   // un-rotate: the transpose of the forward's rotation
      const float c[4] = {in.c.x, in.c.y, in.c.z, in.c.w};
      const float s[4] = {in.s.x, in.s.y, in.s.z, in.s.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float q1 = g[2 * i], q2 = g[2 * i + 1];
        g[2 * i] = q1 * c[i] + q2 * s[i];
        g[2 * i + 1] = q2 * c[i] - q1 * s[i];
      }
    }
    float dot = 0.f;
#pragma unroll
    for (int i = 0; i < kVec; ++i) dot += g[i] * wt[i] * (xv[i] * r);
    float mean;
    if constexpr (kPerHead)
      mean = head_sum(dot, Dh / kVec) * inv_d;
    else
      mean = block_sum(dot, red) * inv_d;
    if (!active) continue;
    float o[kVec];
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      const float nh = xv[i] * r;
      o[i] = r * (g[i] * wt[i] - nh * mean);
      dw[i] += g[i] * nh;
    }
    store8(dx + row * D + d0, pack8<T>(o));
  }
  if (dw_part != nullptr && active) {
    float4* p = reinterpret_cast<float4*>(dw_part + (long long)blockIdx.x * D + d0);
    p[0] = make_float4(dw[0], dw[1], dw[2], dw[3]);
    p[1] = make_float4(dw[4], dw[5], dw[6], dw[7]);
  }
}

int threads_for(int D) { return (D / kVec + 31) / 32 * 32; }

bool shape_ok(long long rows, int L, int D, int H, int Dh, int grid, int per_head,
              int rope_rows) {
  const int lanes = Dh / kVec;   // per head: a power of two, at most a warp
  return rows >= 0 && L > 0 && D % kVec == 0 && D / kVec <= kMaxThreads && H > 0 &&
         Dh > 0 && Dh % kVec == 0 && H * Dh == D && rows % L == 0 && grid > 0 &&
         (!per_head || (lanes <= 32 && (lanes & (lanes - 1)) == 0)) && rope_rows >= 0 &&
         rope_rows <= L;
}

template <typename T>
const void* fwd_kernel(int per_head) {
  return per_head ? (const void*)qk_norm_rope_fwd_kernel<T, true>
                  : (const void*)qk_norm_rope_fwd_kernel<T, false>;
}

template <typename T>
const void* bwd_kernel(int per_head) {
  return per_head ? (const void*)qk_norm_rope_bwd_kernel<T, true>
                  : (const void*)qk_norm_rope_bwd_kernel<T, false>;
}

}  // namespace

// CTAs of one kernel (bwd 0: the forward, 1: the backward; f32 1: x in f32,
// 0: in bf16; per_head 1: the [Dh]-weight form) that the whole card holds at
// once for rows of D elements, in *ctas: the grid of both entries below is
// this, at most the number of rows.
extern "C" int id_qk_norm_rope_resident(int bwd, int f32, int per_head, int D, int* ctas) {
  if (D % kVec || D / kVec > kMaxThreads || D <= 0) return (int)cudaErrorInvalidValue;
  const void* kernel = bwd ? (f32 ? bwd_kernel<float>(per_head) : bwd_kernel<bf16>(per_head))
                           : (f32 ? fwd_kernel<float>(per_head) : fwd_kernel<bf16>(per_head));
  int per_sm = 0, dev = 0, sms = 0;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                                  threads_for(D), 0);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  *ctas = (per_sm > 0 ? per_sm : 1) * sms;
  return 0;
}

template <typename T, bool kPerHead>
void launch_fwd(const void* x, const void* w, int w_f32, const float* cs, const float* sn,
                long long cs_batch, int rope_rows, void* q, void* rstd, int grid, long long rows,
                int L, int D, int H, int Dh, float eps, cudaStream_t stream) {
  qk_norm_rope_fwd_kernel<T, kPerHead><<<grid, threads_for(D), 0, stream>>>(
      static_cast<const T*>(x), w, w_f32, cs, sn, cs_batch, rope_rows, static_cast<T*>(q),
      static_cast<float*>(rstd), rows, L, D, H, Dh, eps);
}

// q = RoPE(RMSNorm(x) * w) on `stream`, `grid` CTAs walking the rows. x
// [rows = B * L, D] bf16 (f32 = 0) or f32 (f32 = 1), q likewise; w [D] f32
// (w_f32 = 1) or bf16, rstd [rows] f32 (out, for the backward); per_head 1:
// w is [Dh], the norm is over each head and rstd is [rows, H]. cos / sin
// [B or 1, rope_rows, Dh / 2] f32 with `cs_batch` elements between batch rows
// (0 for one row shared by the batch), rotating tokens l < rope_rows, or both
// null: then q is [rows, D]; else q is head-major [B, H, L, Dh]. Requires
// D <= 8192, D = H * Dh, Dh % 8 == 0 (per head: Dh a power of two <= 256),
// rope_rows <= L, and 16-byte aligned x, w, cos, sin and q.
extern "C" int id_qk_norm_rope_fwd(const void* x, int f32, const void* w, int w_f32,
                                   int per_head, const void* cos_t, const void* sin_t,
                                   long long cs_batch, int rope_rows, void* q, void* rstd,
                                   int grid, long long rows, int L, int D, int H, int Dh,
                                   float eps, void* stream_ptr) {
  if (!shape_ok(rows, L, D, H, Dh, grid, per_head, rope_rows)) return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  const auto stream = static_cast<cudaStream_t>(stream_ptr);
  const auto* cs = static_cast<const float*>(cos_t);
  const auto* sn = static_cast<const float*>(sin_t);
  auto* launch = f32 ? (per_head ? &launch_fwd<float, true> : &launch_fwd<float, false>)
                     : (per_head ? &launch_fwd<bf16, true> : &launch_fwd<bf16, false>);
  launch(x, w, w_f32, cs, sn, cs_batch, rope_rows, q, rstd, grid, rows, L, D, H, Dh, eps,
         stream);
  return (int)cudaGetLastError();
}

template <typename T, bool kPerHead>
void launch_bwd(const void* dq, const void* x, const void* w, int w_f32, const float* cs,
                const float* sn, long long cs_batch, int rope_rows, const float* rstd, void* dx,
                float* dw_part, int grid, long long rows, int L, int D, int H, int Dh,
                cudaStream_t stream) {
  qk_norm_rope_bwd_kernel<T, kPerHead><<<grid, threads_for(D), 0, stream>>>(
      static_cast<const T*>(dq), static_cast<const T*>(x), w, w_f32, cs, sn, cs_batch,
      rope_rows, rstd, static_cast<T*>(dx), dw_part, rows, L, D, H, Dh);
}

// dx (and, with dw_part, dw's partial sums) from dq, x and the forward's rstd:
// layouts, dtypes and forms as id_qk_norm_rope_fwd's (dq like its q, dx like
// x). `grid` CTAs walk the rows; dw_part, if given, is [grid, D] f32 and gets
// one partial sum a CTA (per head: the wrapper folds its heads together).
extern "C" int id_qk_norm_rope_bwd(const void* dq, const void* x, int f32, const void* w,
                                   int w_f32, int per_head, const void* cos_t, const void* sin_t,
                                   long long cs_batch, int rope_rows, const void* rstd, void* dx,
                                   void* dw_part, int grid, long long rows, int L, int D, int H,
                                   int Dh, void* stream_ptr) {
  if (!shape_ok(rows, L, D, H, Dh, grid, per_head, rope_rows)) return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  const auto stream = static_cast<cudaStream_t>(stream_ptr);
  const auto* cs = static_cast<const float*>(cos_t);
  const auto* sn = static_cast<const float*>(sin_t);
  auto* launch = f32 ? (per_head ? &launch_bwd<float, true> : &launch_bwd<float, false>)
                     : (per_head ? &launch_bwd<bf16, true> : &launch_bwd<bf16, false>);
  launch(dq, x, w, w_f32, cs, sn, cs_batch, rope_rows, static_cast<const float*>(rstd), dx,
         static_cast<float*>(dw_part), grid, rows, L, D, H, Dh, stream);
  return (int)cudaGetLastError();
}
