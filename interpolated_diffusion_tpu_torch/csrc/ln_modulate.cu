// LayerNorm + modulation of the video DiTs, forward and backward, for Hopper
// (sm_90a).
//
// Replaces no TPU kernel: the JAX package writes WanDiT's LayerNorms and their
// adaLN modulation in plain jnp (models/wan_dit.py), which XLA fuses into the
// neighbouring operations. The port ran them as PyTorch's ops: the f32 copy of
// x, two means, the clamp, rsqrt, the centring, the cast, then `* (1 + scale)
// + shift` on [B, L, D] bf16 tensors and the casts of the modulation rows: 16
// passes forward and 30 in the backward, ~240 bytes moved for each element
// normalised at Wan2.1-1.3B's training shapes, the largest elementwise site of
// the step once the q/k norms were one kernel (qk_norm_rope.cu). Two forms:
//  - adaLN (WanBlock's norm1 / norm3 and its head, every HunyuanVideo LN):
//      y = T(T(n * T(1 + T(scale))) + T(shift)),  n = T((x - mu) * rstd),
//    scale and shift one row [D] a batch row, f32 or bf16, at any batch stride
//    (the f32 rows of WanBlock's `mod` [B, 6, D], the chunks of HunyuanVideo's
//    modulation Linear), rounded to T here as the chain's `.to(dtype)` rounds;
//  - affine (WanBlock's norm2): y = T((x - mu) * (rstd * w) + b), w and b [D]
//    f32 or bf16, taken as f32 unrounded, as LayerNorm.forward takes them.
// T is x's dtype (bf16, or f32 for a model run with --bf16 0; rounding to f32
// is exact). The statistics are LayerNorm.forward's: mu = mean(x), var =
// max(mean(x^2) - mu^2, 0), rstd = rsqrtf(var + eps), in f32 (the sums' order
// differs from the chain's, so mu and rstd may differ by a few f32 ulps and,
// rarely, an output by one ulp of T); the products and sums are __fmul_rn /
// __fadd_rn, never contracted to an FMA, so that for the same mu and rstd the
// output is the chain's bit for bit.
//
// The backward is f32 throughout and rounds dx to T once, where the chain's
// autograd rounds at every bf16 op:
//   n^ = (x - mu) * rstd,  dn = dy * a  (a = T(1 + T(scale)), or w),
//   dx = rstd * (dn - mean(dn) - n^ * mean(dn * n^)),
// and, only when they want a gradient (full fine-tuning), the sums over a batch
// row's tokens d_scale = sum dy * n (n as the forward rounded it) and d_shift =
// sum dy, or over every row dw = sum dy * n^ and db = sum dy: one f32 partial
// sum a CTA and batch row, [gridDim.x, batch rows, 2, D], which the wrapper
// sums.
//
// What bounds it on the H100: bytes (a few FLOPs a byte). Forward, per token
// row: read x (2D bytes in bf16), write y (2D) and two f32 (mu, rstd); backward:
// read dy and x, mu and rstd, write dx (6D bytes). The modulation rows are read
// once a CTA and batch row, from L2. At [2, 32760, 1536] in bf16: 403 MB and
// 604 MB, 120 us and 180 us at 3.35 TB/s; on an H100 80GB HBM3 at 700 W the
// forward takes 147 us (82% of that) and the backward 204 us (88%) by graph
// replay. Both are held by the instruction rate as much as by the bytes: a 64-bit
// division a row (the row's batch index) held the forward at 181 us.
//
// Design: qk_norm_rope.cu's. A CTA takes a token row at a time, D / 8
// threads, each 8 elements (one 16-byte access in bf16); both sums of a row
// (x and x^2 forward, dn and dn * n^ backward) go up together, by warp
// shuffles and then one float2 a warp through shared memory: two barriers a
// row. As many CTAs as the card holds at once walk the rows with a
// grid-stride loop (the caller sizes the grid from id_ln_mod_resident), each
// loading its next row before it reduces this one, so that loads stay in
// flight across the barriers and the stores (a second row in flight in the
// forward measured no faster on an H100: 0.1826 against 0.1805 ms at
// [2, 32760, 1536]). A CTA keeps the modulation of the batch row it is in and
// reloads it only when its walk crosses into the next.
// x may be a view with a batch stride of its own (HunyuanVideo's video and
// text slices of the joint sequence); its rows are contiguous. y and dx are
// contiguous [B, L, D].
#include "id_kernels.cuh"
#include "row8.cuh"

namespace {

using bf16 = __nv_bfloat16;
constexpr int kMaxThreads = 1024;

// The CTA's sums of v.x and v.y, in every thread, summed in the same order in
// each; every thread of the CTA calls it.
__device__ __forceinline__ float2 block_sum2(float2 v, float2* red) {
  v.x = id_warp_sum(v.x);
  v.y = id_warp_sum(v.y);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float2 s = make_float2(0.f, 0.f);
  for (int i = 0; i < (int)(blockDim.x >> 5); ++i) {
    s.x += red[i].x;
    s.y += red[i].y;
  }
  __syncthreads();   // red is written again by the next call
  return s;
}

// Where a CTA's walk is: token row `row` (blockIdx.x, then gridDim.x further
// each step), its batch row b and token l, kept by addition: a 64-bit
// division a row is dozens of instructions in each thread.
struct RowPos {
  long long row, b;
  int l;

  __device__ __forceinline__ void advance(int step, int L) {
    row += step;
    l += step;
    if (l >= L) {   // the step may cross several batch rows of a short sequence
      const int q = l / L;
      b += q;
      l -= q * L;
    }
  }
};

__device__ __forceinline__ RowPos first_row(int L) {
  const long long b = blockIdx.x / L;
  return {(long long)blockIdx.x, b, (int)(blockIdx.x - b * L)};
}

// The offset of a thread's 8 elements of that row in x, whose batch rows lie
// x_bstride elements apart and whose tokens D apart.
__device__ __forceinline__ long long x_offset(const RowPos& p, int D, long long x_bstride,
                                              int d0) {
  return p.b * x_bstride + (long long)p.l * D + d0;
}

// The modulation a thread applies to its 8 elements in batch row b: adaLN
// a = T(1 + T(scale)), h = T(shift); affine a = w, h = b as f32.
template <typename T, bool kAffine>
__device__ __forceinline__ void load_mod(const void* scale, long long s_bstride,
                                         const void* shift, long long h_bstride, int mod_f32,
                                         long long b, int d0, float (&a)[kVec],
                                         float (&h)[kVec]) {
  if constexpr (kAffine) {
    load8_any(scale, mod_f32, d0, a);
    if (shift != nullptr) load8_any(shift, mod_f32, d0, h);
  } else {
    load8_any(scale, mod_f32, b * s_bstride + d0, a);
    if (shift != nullptr) load8_any(shift, mod_f32, b * h_bstride + d0, h);
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      a[i] = round_to<T>(__fadd_rn(1.f, round_to<T>(a[i])));
      h[i] = round_to<T>(h[i]);
    }
  }
}

template <typename T, bool kAffine>
__global__ void __launch_bounds__(kMaxThreads)
ln_mod_fwd_kernel(const T* __restrict__ x, long long x_bstride, const void* __restrict__ scale,
                  long long s_bstride, const void* __restrict__ shift, long long h_bstride,
                  int mod_f32, T* __restrict__ y, float* __restrict__ mean,
                  float* __restrict__ rstd, long long rows, int L, int D, float eps) {
  __shared__ float2 red[kMaxThreads / 32];
  const int d0 = threadIdx.x * kVec;
  const bool active = d0 < D;
  const float inv_d = __frcp_rn((float)D);
  float a[kVec] = {}, h[kVec] = {};
  long long cur_b = -1;
  RowPos at = first_row(L), ahead = at;
  ahead.advance(gridDim.x, L);
  Raw8<T> next = {};
  if (active && at.row < rows) next = load8(x + x_offset(at, D, x_bstride, d0));
  for (; at.row < rows; at = ahead, ahead.advance(gridDim.x, L)) {
    const long long row = at.row, b = at.b;
    const Raw8<T> in = next;
    if (active && ahead.row < rows) next = load8(x + x_offset(ahead, D, x_bstride, d0));
    if (b != cur_b) {   // the same for every thread of the CTA
      if (active) load_mod<T, kAffine>(scale, s_bstride, shift, h_bstride, mod_f32, b, d0, a, h);
      cur_b = b;
    }
    float v[kVec];
    unpack8(in, v);
    float2 t = make_float2(0.f, 0.f);
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      t.x = __fadd_rn(t.x, v[i]);
      t.y = __fadd_rn(t.y, __fmul_rn(v[i], v[i]));
    }
    t = block_sum2(t, red);
    const float mu = __fmul_rn(t.x, inv_d);
    const float var = fmaxf(__fsub_rn(__fmul_rn(t.y, inv_d), __fmul_rn(mu, mu)), 0.f);
    const float r = rsqrtf(__fadd_rn(var, eps));
    if (threadIdx.x == 0) {
      mean[row] = mu;
      rstd[row] = r;
    }
    if (!active) continue;
    float o[kVec];
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      const float c = __fsub_rn(v[i], mu);
      if constexpr (kAffine)
        o[i] = __fadd_rn(__fmul_rn(c, __fmul_rn(r, a[i])), h[i]);
      else
        o[i] = __fadd_rn(round_to<T>(__fmul_rn(round_to<T>(__fmul_rn(c, r)), a[i])), h[i]);
    }
    store8(y + row * D + d0, pack8<T>(o));
  }
}

// One row's backward inputs as they arrive.
template <typename T>
struct BwdIn {
  Raw8<T> x, dy;
  float mu, r;
};

template <typename T>
__device__ __forceinline__ BwdIn<T> load_bwd(const T* dy, const T* x, long long x_bstride,
                                             const float* mean, const float* rstd,
                                             const RowPos& p, long long rows, bool active,
                                             int D, int d0) {
  BwdIn<T> in = {};
  if (p.row >= rows) return in;
  in.mu = mean[p.row];
  in.r = rstd[p.row];
  if (active) {
    in.x = load8(x + x_offset(p, D, x_bstride, d0));
    in.dy = load8(dy + p.row * D + d0);
  }
  return in;
}

// Add a thread's partial sums of batch row b (0 for affine) to the CTA's
// slots [blockIdx.x, b, {scale or w, shift or b}, D].
__device__ __forceinline__ void flush_partial(float* part, int part_b, long long b, int D,
                                              int d0, const float (&ds)[kVec],
                                              const float (&dh)[kVec]) {
  float* p = part + ((long long)blockIdx.x * part_b + b) * 2 * D + d0;
  reinterpret_cast<float4*>(p)[0] = make_float4(ds[0], ds[1], ds[2], ds[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(ds[4], ds[5], ds[6], ds[7]);
  reinterpret_cast<float4*>(p + D)[0] = make_float4(dh[0], dh[1], dh[2], dh[3]);
  reinterpret_cast<float4*>(p + D)[1] = make_float4(dh[4], dh[5], dh[6], dh[7]);
}

template <typename T, bool kAffine, bool kPartial>
__global__ void __launch_bounds__(kMaxThreads)
ln_mod_bwd_kernel(const T* __restrict__ dy, const T* __restrict__ x, long long x_bstride,
                  const void* __restrict__ scale, long long s_bstride, int mod_f32,
                  const float* __restrict__ mean, const float* __restrict__ rstd,
                  T* __restrict__ dx, float* __restrict__ part, int part_b, long long rows,
                  int L, int D) {
  __shared__ float2 red[kMaxThreads / 32];
  const int d0 = threadIdx.x * kVec;
  const bool active = d0 < D;
  const float inv_d = __frcp_rn((float)D);
  float a[kVec] = {}, unused[kVec] = {}, ds[kVec] = {}, dh[kVec] = {};
  long long cur_b = -1;
  RowPos at = first_row(L), ahead = at;
  ahead.advance(gridDim.x, L);
  BwdIn<T> next = load_bwd(dy, x, x_bstride, mean, rstd, at, rows, active, D, d0);
  for (; at.row < rows; at = ahead, ahead.advance(gridDim.x, L)) {
    const long long row = at.row, b = kAffine ? 0 : at.b;
    const BwdIn<T> in = next;
    next = load_bwd(dy, x, x_bstride, mean, rstd, ahead, rows, active, D, d0);
    if (b != cur_b) {   // the same for every thread of the CTA
      if (active) {
        if (kPartial && cur_b >= 0) {
          flush_partial(part, part_b, cur_b, D, d0, ds, dh);
#pragma unroll
          for (int i = 0; i < kVec; ++i) ds[i] = dh[i] = 0.f;
        }
        load_mod<T, kAffine>(scale, s_bstride, nullptr, 0, mod_f32, b, d0, a, unused);
      }
      cur_b = b;
    }
    float xv[kVec], g[kVec], nh[kVec], dn[kVec];
    unpack8(in.x, xv);
    unpack8(in.dy, g);
    float2 t = make_float2(0.f, 0.f);
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      nh[i] = (xv[i] - in.mu) * in.r;
      dn[i] = g[i] * a[i];
      t.x += dn[i];
      t.y += dn[i] * nh[i];
    }
    t = block_sum2(t, red);
    if (!active) continue;
    const float m1 = t.x * inv_d, m2 = t.y * inv_d;
    float o[kVec];
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      o[i] = in.r * (dn[i] - m1 - nh[i] * m2);
      if constexpr (kPartial) {
        ds[i] += g[i] * (kAffine ? nh[i] : round_to<T>(nh[i]));
        dh[i] += g[i];
      }
    }
    store8(dx + row * D + d0, pack8<T>(o));
  }
  if (kPartial && active && cur_b >= 0) flush_partial(part, part_b, cur_b, D, d0, ds, dh);
}

int threads_for(int D) { return (D / kVec + 31) / 32 * 32; }

bool shape_ok(long long rows, int L, int D, int grid) {
  return rows >= 0 && L > 0 && D > 0 && D % kVec == 0 && D / kVec <= kMaxThreads &&
         rows % L == 0 && grid > 0;
}

template <typename T>
const void* fwd_kernel(int affine) {
  return affine ? (const void*)ln_mod_fwd_kernel<T, true>
                : (const void*)ln_mod_fwd_kernel<T, false>;
}

template <typename T>
const void* bwd_kernel(int affine, int partial) {
  if (affine)
    return partial ? (const void*)ln_mod_bwd_kernel<T, true, true>
                   : (const void*)ln_mod_bwd_kernel<T, true, false>;
  return partial ? (const void*)ln_mod_bwd_kernel<T, false, true>
                 : (const void*)ln_mod_bwd_kernel<T, false, false>;
}

template <typename T, bool kAffine>
void launch_fwd(const void* x, long long x_bstride, const void* scale, long long s_bstride,
                const void* shift, long long h_bstride, int mod_f32, void* y, void* mean,
                void* rstd, int grid, long long rows, int L, int D, float eps,
                cudaStream_t stream) {
  ln_mod_fwd_kernel<T, kAffine><<<grid, threads_for(D), 0, stream>>>(
      static_cast<const T*>(x), x_bstride, scale, s_bstride, shift, h_bstride, mod_f32,
      static_cast<T*>(y), static_cast<float*>(mean), static_cast<float*>(rstd), rows, L, D, eps);
}

template <typename T, bool kAffine, bool kPartial>
void launch_bwd(const void* dy, const void* x, long long x_bstride, const void* scale,
                long long s_bstride, int mod_f32, const void* mean, const void* rstd, void* dx,
                void* part, int part_b, int grid, long long rows, int L, int D,
                cudaStream_t stream) {
  ln_mod_bwd_kernel<T, kAffine, kPartial><<<grid, threads_for(D), 0, stream>>>(
      static_cast<const T*>(dy), static_cast<const T*>(x), x_bstride, scale, s_bstride,
      mod_f32, static_cast<const float*>(mean), static_cast<const float*>(rstd),
      static_cast<T*>(dx), static_cast<float*>(part), part_b, rows, L, D);
}

template <typename T>
auto* bwd_launcher(int affine, int partial) {
  if (affine) return partial ? &launch_bwd<T, true, true> : &launch_bwd<T, true, false>;
  return partial ? &launch_bwd<T, false, true> : &launch_bwd<T, false, false>;
}

}  // namespace

// CTAs of one kernel (bwd 0: the forward, 1: the backward, partial 1: with the
// modulation's partial sums; f32 1: x in f32, 0: in bf16; affine 1: the
// [D]-weight form) that the whole card holds at once for rows of D elements,
// in *ctas: the grid of the entries below is this, at most the number of rows.
extern "C" int id_ln_mod_resident(int bwd, int partial, int f32, int affine, int D, int* ctas) {
  if (D % kVec || D / kVec > kMaxThreads || D <= 0) return (int)cudaErrorInvalidValue;
  const void* kernel = bwd ? (f32 ? bwd_kernel<float>(affine, partial)
                                  : bwd_kernel<bf16>(affine, partial))
                           : (f32 ? fwd_kernel<float>(affine) : fwd_kernel<bf16>(affine));
  int per_sm = 0, dev = 0, sms = 0;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                                  threads_for(D), 0);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  *ctas = (per_sm > 0 ? per_sm : 1) * sms;
  return 0;
}

// y = LN(x) modulated, on `stream`, `grid` CTAs walking the rows. x: rows =
// B * L token rows of D elements, bf16 (f32 = 0) or f32 (f32 = 1), batch row b
// at x + b * x_bstride, its tokens D apart; y contiguous [rows, D] in x's
// dtype; mean, rstd [rows] f32 (out, for the backward). affine 0: scale and
// shift are [B, D] rows at s_bstride / h_bstride elements apart; affine 1: w
// and b [D]; f32 (mod_f32 = 1) or bf16. Requires D % 8 == 0, D <= 8192 and
// 16-byte aligned rows of x, y, scale and shift.
extern "C" int id_ln_mod_fwd(const void* x, int f32, long long x_bstride, const void* scale,
                             long long s_bstride, const void* shift, long long h_bstride,
                             int mod_f32, int affine, void* y, void* mean, void* rstd, int grid,
                             long long rows, int L, int D, float eps, void* stream_ptr) {
  if (!shape_ok(rows, L, D, grid)) return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  auto* launch = f32 ? (affine ? &launch_fwd<float, true> : &launch_fwd<float, false>)
                     : (affine ? &launch_fwd<bf16, true> : &launch_fwd<bf16, false>);
  launch(x, x_bstride, scale, s_bstride, shift, h_bstride, mod_f32, y, mean, rstd, grid, rows, L,
         D, eps, static_cast<cudaStream_t>(stream_ptr));
  return (int)cudaGetLastError();
}

// dx and, with part, the modulation's partial sums from
// dy, x and the forward's mean and rstd: layouts, dtypes and forms as
// id_ln_mod_fwd's (dy and dx contiguous like y). part, if given, is
// [grid, part_b, 2, D] f32, zeroed: part_b = B for adaLN (d_scale, d_shift of
// each batch row), 1 for affine (dw, db).
extern "C" int id_ln_mod_bwd(const void* dy, const void* x, int f32, long long x_bstride,
                             const void* scale, long long s_bstride, int mod_f32, int affine,
                             const void* mean, const void* rstd, void* dx, void* part,
                             int part_b, int grid, long long rows, int L, int D,
                             void* stream_ptr) {
  if (!shape_ok(rows, L, D, grid)) return (int)cudaErrorInvalidValue;
  if (part != nullptr && part_b != (affine ? 1 : (int)(rows / L)))
    return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  auto* launch = f32 ? bwd_launcher<float>(affine, part != nullptr)
                     : bwd_launcher<bf16>(affine, part != nullptr);
  launch(dy, x, x_bstride, scale, s_bstride, mod_f32, mean, rstd, dx, part, part_b, grid, rows, L,
         D, static_cast<cudaStream_t>(stream_ptr));
  return (int)cudaGetLastError();
}
