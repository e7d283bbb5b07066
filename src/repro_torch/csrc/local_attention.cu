// Blocked causal / sliding-window flash attention for Hopper (sm_90a),
// with grouped-query attention and an online softmax.
//
//   out[bh, i, :] = sum_j softmax_j(mask(i, j) ? scale * q[bh, i] . k[g, j]
//                                              : -1e30) * v[g, j, :]
//   q (BH, Lq, D), k and v (BH / kv_groups, Lk, D), g = bh / kv_groups,
//   mask(i, j) = (!causal || i >= j) && (window == 0 || i - j < window).
//
// Replaces the Pallas TPU kernel of the JAX reference,
// src/repro/kernels/local_attention.py: _attn_kernel (pallas_call in
// local_flash_attention), which ops.gqa_flash_attention calls for 4-D
// (batch, heads, L, D) operands.
//
// What bounds it on an H100: causal prefill at L = 1024, D = 64 and 32
// heads is 2 * 32 * L^2 * D = 4.3 GFLOP (QK^T and PV over the lower
// triangle) against 16.8 MB of bf16 q, k, v and out, so at the card's bf16
// rate (989 TFLOP/s) and memory rate (3.35 TB/s) both bounds are about
// 5 us and the bytes bound is the larger.  This first kernel does not get
// near either: its products are fp32 FMA on the CUDA cores (67 TFLOP/s
// peak), so that it meets the reference's f32 bound (rtol/atol 2e-5) as
// well as the bf16 one (3e-2).  Tensor-core products (mma.sync or wgmma on
// bf16 P.V) and TMA-fed K/V tiles are a later kernel's work.
//
// Design: one block of 256 threads per (batch*head, 64-query tile).  Four
// neighbouring lanes share one query row: each keeps the whole
// query row in registers, 16 of the tile's 64 scores, and D/4 columns of
// the fp32 accumulator.  The block loops over 64-key tiles of K and V,
// staged through shared memory as fp32; that loop takes the place of the
// TPU's sequential kv grid axis and its VMEM scratch (acc, m, l).  Row max
// and row sum are reduced across the four lanes with shuffles; P goes
// through shared memory to the P.V product, read only by its own warp.
// Tiles that are fully masked for every row of the block (above the causal
// diagonal, or older than the window) are skipped: their keys would add
// p = 0 and leave m unchanged, so skipping is exact.  Masked scores are
// -1e30 and masked p are 0, as in the reference, so m stays finite and no
// exp() sees -inf.  The flush divides by max(l, 1e-20) and stores in q's
// dtype (bf16 rounds to nearest even, as torch's cast does).  Ragged Lq
// and Lk are masked: rows past Lq are not stored, keys past Lk are masked.
// GQA reads the shared K/V head in place, with no copies.
//
// C ABI: the entry point launches on the given stream, allocates nothing,
// does not synchronise, and returns cudaGetLastError().  It launches on the
// calling thread's current device, which the Python wrapper selects; it
// never changes it.

#include <atomic>

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int BQ = 64;                  // queries per block
constexpr int BK = 64;                  // keys per tile
constexpr int LANES = 4;                // lanes per query row
constexpr int THREADS = BQ * LANES;     // 256
constexpr int KEYS_PER_LANE = BK / LANES;
constexpr float NEG = -1.0e30f;
constexpr int kMaxDevices = 64;         // devices one process may launch on

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// Shared memory: K tile [BK][D + 1] (padded against bank conflicts), V
// tile [BK][D], P [BQ][BK + 1].  The K buffer stages the Q tile first.
template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (BK * (D + 1) + BK * D + BQ * (BK + 1));
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out, int lq,
                 int lk, int kv_groups, float scale, int causal,
                 int window) {
  extern __shared__ float smem[];
  float (*ks)[D + 1] = reinterpret_cast<float (*)[D + 1]>(smem);
  float (*vs)[D] = reinterpret_cast<float (*)[D]>(smem + BK * (D + 1));
  float (*ps)[BK + 1] =
      reinterpret_cast<float (*)[BK + 1]>(smem + BK * (D + 1) + BK * D);

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int row = threadIdx.x / LANES;   // query row within the tile
  const int sub = threadIdx.x % LANES;   // lane within the row's four
  const int qi = q0 + row;               // absolute query index
  const size_t q_base = static_cast<size_t>(bh) * lq * D;
  const size_t kv_base = static_cast<size_t>(bh / kv_groups) * lk * D;

  // Stage the Q tile through the K buffer, then keep the own row in
  // registers.  Rows past lq read 0 and are never stored.
  for (int e = threadIdx.x; e < BQ * D; e += THREADS) {
    const int r = e / D, c = e % D;
    ks[r][c] = (q0 + r < lq)
        ? load_f(q + q_base + static_cast<size_t>(q0 + r) * D + c) : 0.0f;
  }
  __syncthreads();
  float qr[D];
#pragma unroll
  for (int c = 0; c < D; ++c) qr[c] = ks[row][c];
  __syncthreads();

  float acc[D / LANES];
#pragma unroll
  for (int c = 0; c < D / LANES; ++c) acc[c] = 0.0f;
  float m = NEG, l = 0.0f;

  // The key range any row of this block can see; tiles outside it are
  // fully masked for every row and skipped.
  const int q_last = min(q0 + BQ, lq) - 1;
  int k_end = lk;
  if (causal) k_end = min(k_end, q_last + 1);
  int k_begin = 0;
  if (window > 0) k_begin = max(0, q0 - window + 1);
  k_begin = (k_begin / BK) * BK;

  const unsigned full = 0xffffffffu;
  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    for (int e = threadIdx.x; e < BK * D; e += THREADS) {
      const int r = e / D, c = e % D;
      const bool in = k0 + r < lk;
      const size_t off = kv_base + static_cast<size_t>(k0 + r) * D + c;
      ks[r][c] = in ? load_f(k + off) : 0.0f;
      vs[r][c] = in ? load_f(v + off) : 0.0f;
    }
    __syncthreads();

    // S = scale * q . k for keys j = sub + LANES * jj, masked to -1e30.
    float s[KEYS_PER_LANE];
    unsigned valid = 0u;   // bit jj: key sub + LANES * jj is visible
    float tile_max = NEG;
#pragma unroll
    for (int jj = 0; jj < KEYS_PER_LANE; ++jj) {
      const int j = sub + LANES * jj;
      float dot = 0.0f;
#pragma unroll
      for (int c = 0; c < D; ++c) dot = fmaf(qr[c], ks[j][c], dot);
      const int kj = k0 + j;
      bool ok = kj < lk;
      if (causal) ok = ok && qi >= kj;
      if (window > 0) ok = ok && (qi - kj) < window;
      s[jj] = ok ? dot * scale : NEG;
      valid |= static_cast<unsigned>(ok) << jj;
      tile_max = fmaxf(tile_max, s[jj]);
    }
    tile_max = fmaxf(tile_max, __shfl_xor_sync(full, tile_max, 1, LANES));
    tile_max = fmaxf(tile_max, __shfl_xor_sync(full, tile_max, 2, LANES));
    const float m_new = fmaxf(m, tile_max);
    const float alpha = expf(m - m_new);
    float row_sum = 0.0f;
#pragma unroll
    for (int jj = 0; jj < KEYS_PER_LANE; ++jj) {
      const float p = ((valid >> jj) & 1u) ? expf(s[jj] - m_new) : 0.0f;
      row_sum += p;
      ps[row][sub + LANES * jj] = p;
    }
    row_sum += __shfl_xor_sync(full, row_sum, 1, LANES);
    row_sum += __shfl_xor_sync(full, row_sum, 2, LANES);
    l = l * alpha + row_sum;
    m = m_new;
    __syncwarp();   // a row's P is written and read by its own warp only

    // acc = alpha * acc + P . V for columns c = sub + LANES * cc.
#pragma unroll
    for (int cc = 0; cc < D / LANES; ++cc) acc[cc] *= alpha;
    for (int j = 0; j < BK; ++j) {
      const float p = ps[row][j];
#pragma unroll
      for (int cc = 0; cc < D / LANES; ++cc)
        acc[cc] = fmaf(p, vs[j][sub + LANES * cc], acc[cc]);
    }
    __syncthreads();   // the next tile overwrites K, V and P
  }

  if (qi < lq) {
    const float inv = 1.0f / fmaxf(l, 1e-20f);
    T* o = out + q_base + static_cast<size_t>(qi) * D;
#pragma unroll
    for (int cc = 0; cc < D / LANES; ++cc)
      store_f(o + sub + LANES * cc, acc[cc] * inv);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out, int bh,
           int lq, int lk, int kv_groups, float scale, int causal,
           int window, cudaStream_t stream) {
  const size_t smem = smem_bytes<D>();
  // The shared-memory opt-in is a per-device attribute of each
  // instantiation: set it on a device's first launch only.
  static std::atomic<bool> opted_in[kMaxDevices];
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (!opted_in[device].load(std::memory_order_relaxed)) {
    err = cudaFuncSetAttribute(attention_kernel<T, D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in[device].store(true, std::memory_order_relaxed);
  }
  const dim3 grid((lq + BQ - 1) / BQ, bh);
  attention_kernel<T, D><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), lq, lk, kv_groups,
      scale, causal, window);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_d(int d, const void* q, const void* k, const void* v,
               void* out, int bh, int lq, int lk, int kv_groups,
               float scale, int causal, int window, cudaStream_t stream) {
  switch (d) {
    case 8: return launch<T, 8>(q, k, v, out, bh, lq, lk, kv_groups, scale,
                                causal, window, stream);
    case 16: return launch<T, 16>(q, k, v, out, bh, lq, lk, kv_groups,
                                  scale, causal, window, stream);
    case 32: return launch<T, 32>(q, k, v, out, bh, lq, lk, kv_groups,
                                  scale, causal, window, stream);
    case 64: return launch<T, 64>(q, k, v, out, bh, lq, lk, kv_groups,
                                  scale, causal, window, stream);
    case 128: return launch<T, 128>(q, k, v, out, bh, lq, lk, kv_groups,
                                    scale, causal, window, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out alike); d in
// {8, 16, 32, 64, 128}.  Returns cudaErrorInvalidValue for anything else.
int local_attention_forward(const void* q, const void* k, const void* v,
                            void* out, int dtype, int bh, int lq, int lk,
                            int d, int kv_groups, float scale, int causal,
                            int window, void* stream) {
  if (bh == 0 || lq == 0) return 0;
  if (kv_groups < 1 || bh % kv_groups != 0 || bh > 65535 || lk < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_d<float>(d, q, k, v, out, bh, lq, lk, kv_groups, scale,
                             causal, window, s);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(d, q, k, v, out, bh, lq, lk, kv_groups,
                                     scale, causal, window, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* local_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
