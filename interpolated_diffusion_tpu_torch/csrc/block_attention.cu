// Block-sparse attention forward kernels for Hopper (sm_90a): SLA and int8
// SLA (SageSLA), one online-softmax loop. (The dense flash forward, which
// began as a third mode of this loop, is flash_fwd_sm90.cu.)
//
// Replaces two TPU kernels of interpolated_diffusion_tpu/kernels/:
//   kSparse     block_sparse_attention.py::_fwd_kernel (_fwd_pallas; public
//               block_sparse_attention, block_sparse_attention_lse)
//   kSparseInt8 int8_attention.py::_fwd_kernel_int8 (_fwd_pallas_int8; public
//               int8_block_sparse_attention)
// The TPU kernels walk a sequential grid axis over key blocks and carry the
// running max / sum / accumulator in VMEM scratch. Here one block of 4 warps
// owns 64 query rows (16 per warp) and walks its key tiles in a loop, with
// every running statistic and the output accumulator in registers.
//
// What bounds it on the H100: at the Wan2.1-1.3B anchor-sampling shapes
// (BH = 48, L = 7800, Dh = 128) the SLA kernel does ~147 GFLOP of products
// against ~0.3 GB of q/k/v/o traffic (counted from the shapes; the LUT re-reads
// each key block for ~6 query blocks, mostly from L2), far above the card's
// bf16 ridge, so the tensor-core rate bounds it. The products run on the
// tensor cores through warp-level mma.sync (bf16 m16n8k16, f32 accumulate; the
// int8 QK^T on s8 m16n8k32, s32 accumulate), whose register layouts are fixed
// by the PTX ISA, so that S, P and O never leave registers: P is repacked from
// the S accumulators straight into the A operand of P.V. K/V tiles of 64 rows
// come through a two-stage cp.async ring, so the next tile loads while this
// one is multiplied. Each warp reads the whole K / V tile from shared memory
// for its own 16 rows, so shared-memory traffic, not the tensor cores, is the
// limit (PERF.md); the dense kernel's redesign (wgmma, TMA, warp
// specialisation) has not been carried over to the LUT walk yet.
//
// Semantics, as the TPU kernels and the plain twins:
//  - logits are scaled by scale * log2(e) and exponentiated with exp2; the int8
//    logits are int32 dot products times (sq[row] * sk[key]) first;
//  - keys at positions >= kv_len get probability 0. K/V rows past the tensor
//    are read as zeros (never uninitialised memory), and a tile lying wholly
//    at or past kv_len is skipped: it would add nothing;
//  - the block-sparse LUT [BH, M, topk] names key blocks
//    of block_n rows for each query block of block_m rows (both multiples of
//    64); an id addressing positions >= kv_len (the sentinel of
//    block_sparse_attention_lse) contributes nothing;
//  - a row with no visible key gives o = 0 and lse = log2(1e-30), as the
//    gather reference does (block_sparse_reference.py), never NaN;
//  - P is rounded to bf16 for P.V (the TPU kernels' p.astype(v.dtype)), the
//    row sum uses f32 P; o = acc / l rounded to bf16, lse = m + log2(l) (f32,
//    base 2).
#include "attention_common.cuh"
#include "id_kernels.cuh"

namespace {

using namespace id_attn;

enum Mode { kSparse = 0, kSparseInt8 = 1 };

struct Params {
  const void* q;         // [BH, Lq, D] bf16, or int8 for kSparseInt8
  const void* k;         // [BH, Lk, D] bf16, or int8
  const bf16* v;         // [BH, Lk, D]
  bf16* o;               // [BH, Lq, D]
  float* lse;            // [BH, Lq], base 2
  const float* q_scale;  // [BH, Lq] (int8 only)
  const float* k_scale;  // [BH, Lk] (int8 only)
  const int* lut;        // [BH, m_blocks, topk]
  int Lq, Lk, kv_len, m_blocks, topk, block_m, block_n;
  float scale_log2;      // softmax scale * log2(e)
};

template <int D, int MODE>
struct Cfg {
  static constexpr bool kInt8 = MODE == kSparseInt8;
  static constexpr int kQKRow = kInt8 ? D : 2 * D;    // bytes of one q/k row in memory
  // shared-memory row strides in bytes, padded so that the 8 rows one
  // fragment load touches fall in distinct banks
  static constexpr int kLdQK = kInt8 ? D + 16 : 2 * D + 16;
  static constexpr int kLdV = 2 * D + 16;
  static constexpr int kQBytes = kBM * kLdQK;
  static constexpr int kKBytes = kBN * kLdQK;
  static constexpr int kVBytes = kBN * kLdV;
  static constexpr int kSBytes = kInt8 ? kBN * 4 : 0;
  static constexpr int kOffK = kQBytes;
  static constexpr int kOffV = kOffK + 2 * kKBytes;
  static constexpr int kOffS = kOffV + 2 * kVBytes;
  static constexpr int kOffList = kOffS + 2 * kSBytes;
};

// Fragment layouts (PTX ISA, mma.m16n8k16 / m16n8k32): lane = 4 * g + t.
// A rows g and g + 8; B column (key) g; C rows g and g + 8, columns 2t, 2t + 1.
template <int D, int MODE>
__global__ void __launch_bounds__(kThreads)
attn_fwd_kernel(const Params p) {
  using C = Cfg<D, MODE>;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* sQ = smem;
  int* tiles = reinterpret_cast<int*>(smem + C::kOffList);
  __shared__ int n_tiles_s;

  const int bh = blockIdx.y, row0 = blockIdx.x * kBM;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t4 = lane % 4;
  const unsigned char* qg = static_cast<const unsigned char*>(p.q) + (long long)bh * p.Lq * C::kQKRow;
  const unsigned char* kg = static_cast<const unsigned char*>(p.k) + (long long)bh * p.Lk * C::kQKRow;
  const unsigned char* vg = reinterpret_cast<const unsigned char*>(p.v + (long long)bh * p.Lk * D);
  const float* ksg = C::kInt8 ? p.k_scale + (long long)bh * p.Lk : nullptr;

  // key tiles this query block visits, as key offsets
  if (threadIdx.x == 0) {
    const int* lut = p.lut + ((long long)bh * p.m_blocks + row0 / p.block_m) * p.topk;
    const int per = p.block_n / kBN;
    int n = 0;
    for (int j = 0; j < p.topk; ++j) {
      const int id = lut[j];
      for (int s = 0; s < per && id >= 0; ++s) {
        const long long start = (long long)id * p.block_n + s * kBN;
        if (start < p.kv_len && n < kMaxTiles) tiles[n++] = (int)start;
      }
    }
    n_tiles_s = n;
  }
  __syncthreads();
  const int n_tiles = n_tiles_s;
  auto load_tile = [&](int i, int stage) {
    const int key0 = tiles[i];
    load_rows(smem + C::kOffK + stage * C::kKBytes, C::kLdQK, kg, C::kQKRow, key0, p.Lk);
    load_rows(smem + C::kOffV + stage * C::kVBytes, C::kLdV, vg, 2 * D, key0, p.Lk);
    if (C::kInt8 && threadIdx.x < kBN) {
      const int r = key0 + threadIdx.x;
      cp_async4(smem + C::kOffS + stage * C::kSBytes + 4 * threadIdx.x,
                r < p.Lk ? ksg + r : ksg, r < p.Lk);
    }
  };

  load_rows(sQ, C::kLdQK, qg, C::kQKRow, row0, p.Lq);
  if (n_tiles > 0) load_tile(0, 0);
  cp_async_commit();

  // per-thread state for rows r0 = row0 + 16 * warp + g and r0 + 8
  constexpr int kNd = D / 8;                    // 8-wide output column blocks
  constexpr int kKs = C::kInt8 ? D / 32 : D / 16;  // k-steps of QK^T
  float acc[kNd][4];
#pragma unroll
  for (int i = 0; i < kNd; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};
  float sq[2] = {1.f, 1.f};
  if constexpr (C::kInt8) {
    const int r = row0 + warp * 16 + g;
    const float* qs = p.q_scale + (long long)bh * p.Lq;
    sq[0] = r < p.Lq ? qs[r] : 0.f;
    sq[1] = r + 8 < p.Lq ? qs[r + 8] : 0.f;
  }
  uint32_t qf[kKs][4];

  for (int it = 0; it < n_tiles; ++it) {
    const int stage = it & 1;
    if (it + 1 < n_tiles) load_tile(it + 1, stage ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();

    if (it == 0) {  // Q fragments, once
      const unsigned char* qa = sQ + (warp * 16 + g) * C::kLdQK;
#pragma unroll
      for (int ks = 0; ks < kKs; ++ks) {
        const int c0 = C::kInt8 ? ks * 32 + t4 * 4 : (ks * 16 + t4 * 2) * 2;
        const int c1 = c0 + 16;  // columns + 16 (int8) or + 8 (bf16)
        qf[ks][0] = ld32(qa + c0);
        qf[ks][1] = ld32(qa + 8 * C::kLdQK + c0);
        qf[ks][2] = ld32(qa + c1);
        qf[ks][3] = ld32(qa + 8 * C::kLdQK + c1);
      }
    }

    const unsigned char* sK = smem + C::kOffK + stage * C::kKBytes;
    const unsigned char* sV = smem + C::kOffV + stage * C::kVBytes;
    const float* sKs = reinterpret_cast<const float*>(smem + C::kOffS + stage * C::kSBytes);
    const int key0 = tiles[it];

    // S = Q K^T for the warp's 16 rows x 64 keys, in base-2 logits
    float s[8][4];
#pragma unroll
    for (int nb = 0; nb < 8; ++nb) {
      const unsigned char* kb = sK + (nb * 8 + g) * C::kLdQK;
      if constexpr (C::kInt8) {
        int si[4] = {0, 0, 0, 0};
#pragma unroll
        for (int ks = 0; ks < kKs; ++ks)
          mma_s8(si, qf[ks], ld32(kb + ks * 32 + t4 * 4), ld32(kb + ks * 32 + 16 + t4 * 4));
        const float sk0 = sKs[nb * 8 + 2 * t4], sk1 = sKs[nb * 8 + 2 * t4 + 1];
        s[nb][0] = (float)si[0] * (sq[0] * sk0) * p.scale_log2;
        s[nb][1] = (float)si[1] * (sq[0] * sk1) * p.scale_log2;
        s[nb][2] = (float)si[2] * (sq[1] * sk0) * p.scale_log2;
        s[nb][3] = (float)si[3] * (sq[1] * sk1) * p.scale_log2;
      } else {
        float sf[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int ks = 0; ks < kKs; ++ks)
          mma_bf16(sf, qf[ks], ld32(kb + (ks * 16 + t4 * 2) * 2),
                   ld32(kb + (ks * 16 + 8 + t4 * 2) * 2));
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nb][e] = sf[e] * p.scale_log2;
      }
      const int key = key0 + nb * 8 + 2 * t4;
      if (key >= p.kv_len) s[nb][0] = s[nb][2] = -INFINITY;
      if (key + 1 >= p.kv_len) s[nb][1] = s[nb][3] = -INFINITY;
    }

    // online softmax: new running max, rescale of the old sum and accumulator
    float alpha[2], base[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int nb = 0; nb < 8; ++nb) mx = fmaxf(mx, fmaxf(s[nb][2 * r], s[nb][2 * r + 1]));
      const float m_new = fmaxf(m_run[r], quad_max(mx));
      base[r] = m_new == -INFINITY ? 0.f : m_new;  // no visible key yet: p = 0, no NaN
      alpha[r] = exp2f(m_run[r] - base[r]);
      m_run[r] = m_new;
    }
    float rowsum[2] = {0.f, 0.f};
#pragma unroll
    for (int nb = 0; nb < 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nb][e] = exp2f(s[nb][e] - base[e / 2]);
        rowsum[e / 2] += s[nb][e];
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) l_run[r] = l_run[r] * alpha[r] + rowsum[r];
#pragma unroll
    for (int nd = 0; nd < kNd; ++nd) {
      acc[nd][0] *= alpha[0];
      acc[nd][1] *= alpha[0];
      acc[nd][2] *= alpha[1];
      acc[nd][3] *= alpha[1];
    }

    // O += P V: P (bf16) from the S registers as the A operand, 16 keys a step
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      const unsigned char* vb = sV + (kk * 16 + 2 * t4) * C::kLdV + 2 * g;
#pragma unroll
      for (int nd = 0; nd < kNd; ++nd)
        mma_bf16(acc[nd], pa, ld_pair(vb + nd * 16, C::kLdV),
                 ld_pair(vb + 8 * C::kLdV + nd * 16, C::kLdV));
    }
    __syncthreads();  // this stage is refilled by the next iteration's load
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float l = fmaxf(quad_sum(l_run[r]), 1e-30f);
    const int row = row0 + warp * 16 + g + 8 * r;
    if (row >= p.Lq) continue;
    bf16* orow = p.o + ((long long)bh * p.Lq + row) * D;
#pragma unroll
    for (int nd = 0; nd < kNd; ++nd)
      *reinterpret_cast<uint32_t*>(orow + nd * 8 + 2 * t4) =
          pack_bf16(acc[nd][2 * r] / l, acc[nd][2 * r + 1] / l);
    if (t4 == 0)
      p.lse[(long long)bh * p.Lq + row] = (m_run[r] == -INFINITY ? 0.f : m_run[r]) + log2f(l);
  }
}

template <int D, int MODE>
cudaError_t launch(const Params& p, int BH, cudaStream_t stream) {
  using C = Cfg<D, MODE>;
  const size_t smem = C::kOffList + kMaxTiles * sizeof(int);
  const cudaError_t e = cudaFuncSetAttribute(
      attn_fwd_kernel<D, MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((p.Lq + kBM - 1) / kBM, BH);
  attn_fwd_kernel<D, MODE><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int MODE>
int dispatch(const Params& p, int BH, int D, void* stream) {
  if (BH <= 0 || BH > 65535 || p.Lq <= 0 || p.Lk <= 0 || p.kv_len < 0)
    return (int)cudaErrorInvalidValue;
  if (p.block_m <= 0 || p.block_m % kBM || p.block_n <= 0 || p.block_n % kBN || p.topk <= 0 ||
      p.m_blocks != (p.Lq + p.block_m - 1) / p.block_m ||
      (long long)p.topk * (p.block_n / kBN) > kMaxTiles)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64) return (int)launch<64, MODE>(p, BH, s);
  if (D == 128) return (int)launch<128, MODE>(p, BH, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Block-sparse attention forward (SLA): q/k/v bf16 [BH, L, D], lut int32
// [BH, ceil(Lq / block_m), topk] -> o bf16 [BH, Lq, D], lse f32 [BH, Lq].
extern "C" int id_sla_fwd(const void* q, const void* k, const void* v, const void* lut,
                          void* o, void* lse, int BH, int Lq, int Lk, int D, int kv_len,
                          int topk, int block_m, int block_n, float scale_log2,
                          void* stream) {
  Params p{q, k, static_cast<const bf16*>(v), static_cast<bf16*>(o), static_cast<float*>(lse),
           nullptr, nullptr, static_cast<const int*>(lut), Lq, Lk, kv_len,
           block_m > 0 ? (Lq + block_m - 1) / block_m : 0, topk, block_m, block_n,
           scale_log2};
  return dispatch<kSparse>(p, BH, D, stream);
}

// int8 block-sparse attention forward (SageSLA): q/k int8 [BH, L, D] with f32
// row scales [BH, L], v bf16; otherwise as id_sla_fwd.
extern "C" int id_sla_int8_fwd(const void* q, const void* k, const void* v,
                               const void* q_scale, const void* k_scale, const void* lut,
                               void* o, void* lse, int BH, int Lq, int Lk, int D, int kv_len,
                               int topk, int block_m, int block_n, float scale_log2,
                               void* stream) {
  Params p{q, k, static_cast<const bf16*>(v), static_cast<bf16*>(o), static_cast<float*>(lse),
           static_cast<const float*>(q_scale), static_cast<const float*>(k_scale),
           static_cast<const int*>(lut), Lq, Lk, kv_len,
           block_m > 0 ? (Lq + block_m - 1) / block_m : 0, topk, block_m, block_n,
           scale_log2};
  return dispatch<kSparseInt8>(p, BH, D, stream);
}
