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
// When a gradient is wanted the forward also writes each row's log-sum-exp,
// lse = m + log(max(l, 1e-20)) in fp32, at its flush; otherwise it writes
// nothing more and its output is what it was without that option.
//
// The backward (the JAX reference has none: it trains through its chunked
// jnp path) is the standard recompute design, in three kernels:
//   1. delta[bh, i] = sum_d dO . O per row (one warp per row);
//   2. dK and dV: one block per (KV head, 64-key tile).  It loops over the
//      query tiles of every query head of its group that can see the tile,
//      recomputes P = exp(s - lse), dP = dO . V and dS = P (dP - delta),
//      and sums dV += P^T dO and dK += dS^T Q in registers, so GQA's sum
//      over the group needs no atomics;
//   3. dQ: one block per (batch*head, 64-query tile), looping over the key
//      tiles the forward visits, dQ += dS K.
// The masks, the tile skips and the ragged edges are the forward's.  All
// products are fp32 FMA, as in the forward, so the f32 path meets the
// reference's f32 bounds; gradients are stored in the operands' dtype.
// There are no float atomics and every sum has a fixed order, so the
// backward is bit-for-bit deterministic.  It does 2.5x the forward's
// products in the algorithm, and 3.5x here (S is recomputed in kernels 2
// and 3); its bound is set out in chip_smoke.py.
//
// C ABI: each entry point launches on the given stream, allocates nothing,
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
                 const T* __restrict__ v, T* __restrict__ out,
                 float* __restrict__ lse, int lq, int lk, int kv_groups,
                 float scale, int causal, int window) {
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
    if (lse != nullptr && sub == 0)
      lse[static_cast<size_t>(bh) * lq + qi] = m + logf(fmaxf(l, 1e-20f));
  }
}

// --- backward ------------------------------------------------------------

// delta[r] = sum_c dout[r][c] * out[r][c] over rows r of (rows, d), one
// warp per row, lanes striding the columns.
template <typename T>
__global__ void __launch_bounds__(THREADS)
delta_kernel(const T* __restrict__ out, const T* __restrict__ dout,
             float* __restrict__ delta, int rows, int d) {
  const int r = (blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (r >= rows) return;                  // uniform across the warp
  const size_t base = static_cast<size_t>(r) * d;
  float acc = 0.0f;
  for (int c = lane; c < d; c += 32)
    acc = fmaf(load_f(dout + base + c), load_f(out + base + c), acc);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, o);
  if (lane == 0) delta[r] = acc;
}

// Shared memory of the dK/dV kernel: K and V tiles [BK][D + 1], Q and dO
// tiles [BQ][D + 1], P and dS [BK][BQ + 1], lse and delta [BQ].
template <int D>
constexpr size_t bwd_kv_smem_bytes() {
  return sizeof(float) * (2 * BK * (D + 1) + 2 * BQ * (D + 1) +
                          2 * BK * (BQ + 1) + 2 * BQ);
}

// One block per (KV head g, 64-key tile).  Four lanes share one key row:
// each computes s and dP for 16 of the tile's 64 queries and keeps D/4
// columns of the row's dK and dV accumulators.
template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
attention_bwd_kv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        T* __restrict__ dk, T* __restrict__ dv, int lq,
                        int lk, int kv_groups, float scale, int causal,
                        int window) {
  extern __shared__ float smem[];
  float (*ks)[D + 1] = reinterpret_cast<float (*)[D + 1]>(smem);
  float (*vs)[D + 1] = ks + BK;
  float (*qs)[D + 1] = vs + BK;
  float (*dos)[D + 1] = qs + BQ;
  float (*ps)[BQ + 1] = reinterpret_cast<float (*)[BQ + 1]>(dos + BQ);
  float (*dss)[BQ + 1] = ps + BK;
  float* lse_s = reinterpret_cast<float*>(dss + BK);
  float* delta_s = lse_s + BQ;

  const int g = blockIdx.y;
  const int k0 = blockIdx.x * BK;
  const int row = threadIdx.x / LANES;   // key row within the tile
  const int sub = threadIdx.x % LANES;
  const int kj = k0 + row;               // absolute key index
  const size_t kv_base = static_cast<size_t>(g) * lk * D;

  for (int e = threadIdx.x; e < BK * D; e += THREADS) {
    const int r = e / D, c = e % D;
    const bool in = k0 + r < lk;
    const size_t off = kv_base + static_cast<size_t>(k0 + r) * D + c;
    ks[r][c] = in ? load_f(k + off) : 0.0f;
    vs[r][c] = in ? load_f(v + off) : 0.0f;
  }

  float dk_acc[D / LANES], dv_acc[D / LANES];
#pragma unroll
  for (int cc = 0; cc < D / LANES; ++cc) dk_acc[cc] = dv_acc[cc] = 0.0f;

  // The query range that can see some key of this tile (the forward's
  // skips, seen from the key side); tiles outside it contribute nothing.
  const int k_last = min(k0 + BK, lk) - 1;
  const int q_begin = causal ? (k0 / BQ) * BQ : 0;
  const int q_end = window > 0 ? min(lq, k_last + window) : lq;

  for (int hg = 0; hg < kv_groups; ++hg) {
    const int bh = g * kv_groups + hg;
    const size_t q_base = static_cast<size_t>(bh) * lq * D;
    const size_t r_base = static_cast<size_t>(bh) * lq;
    for (int q0 = q_begin; q0 < q_end; q0 += BQ) {
      __syncthreads();   // the last tile's readers are done (and K, V in)
      for (int e = threadIdx.x; e < BQ * D; e += THREADS) {
        const int r = e / D, c = e % D;
        const bool in = q0 + r < lq;
        const size_t off = q_base + static_cast<size_t>(q0 + r) * D + c;
        qs[r][c] = in ? load_f(q + off) : 0.0f;
        dos[r][c] = in ? load_f(dout + off) : 0.0f;
      }
      if (threadIdx.x < BQ) {
        const int qi = q0 + threadIdx.x;
        lse_s[threadIdx.x] = qi < lq ? lse[r_base + qi] : 0.0f;
        delta_s[threadIdx.x] = qi < lq ? delta[r_base + qi] : 0.0f;
      }
      __syncthreads();

      // s = q . k and dP = dO . v for queries i = sub + LANES * ii.
      float s[BQ / LANES], dp[BQ / LANES];
#pragma unroll
      for (int ii = 0; ii < BQ / LANES; ++ii) s[ii] = dp[ii] = 0.0f;
      for (int c = 0; c < D; ++c) {
        const float kc = ks[row][c], vc = vs[row][c];
#pragma unroll
        for (int ii = 0; ii < BQ / LANES; ++ii) {
          s[ii] = fmaf(kc, qs[sub + LANES * ii][c], s[ii]);
          dp[ii] = fmaf(vc, dos[sub + LANES * ii][c], dp[ii]);
        }
      }
#pragma unroll
      for (int ii = 0; ii < BQ / LANES; ++ii) {
        const int i = sub + LANES * ii;
        const int qi = q0 + i;
        bool ok = kj < lk && qi < lq;
        if (causal) ok = ok && qi >= kj;
        if (window > 0) ok = ok && (qi - kj) < window;
        const float p = ok ? expf(s[ii] * scale - lse_s[i]) : 0.0f;
        ps[row][i] = p;
        dss[row][i] = p * (dp[ii] - delta_s[i]);
      }
      __syncwarp();   // a key row's P and dS are read by its own warp only

      // dV += P^T dO and dK += dS^T Q for columns c = sub + LANES * cc.
      for (int i = 0; i < BQ; ++i) {
        const float p = ps[row][i], ds = dss[row][i];
#pragma unroll
        for (int cc = 0; cc < D / LANES; ++cc) {
          dv_acc[cc] = fmaf(p, dos[i][sub + LANES * cc], dv_acc[cc]);
          dk_acc[cc] = fmaf(ds, qs[i][sub + LANES * cc], dk_acc[cc]);
        }
      }
    }
  }

  if (kj < lk) {
    const size_t off = kv_base + static_cast<size_t>(kj) * D;
#pragma unroll
    for (int cc = 0; cc < D / LANES; ++cc) {
      store_f(dk + off + sub + LANES * cc, dk_acc[cc] * scale);
      store_f(dv + off + sub + LANES * cc, dv_acc[cc]);
    }
  }
}

// Shared memory of the dQ kernel: Q and dO tiles [BQ][D + 1], K and V
// tiles [BK][D + 1], dS [BQ][BK + 1].
template <int D>
constexpr size_t bwd_q_smem_bytes() {
  return sizeof(float) * (2 * BQ * (D + 1) + 2 * BK * (D + 1) +
                          BQ * (BK + 1));
}

// One block per (batch*head, 64-query tile), as the forward.  Four lanes
// share one query row: each computes s and dP for 16 of a tile's 64 keys
// and keeps D/4 columns of the row's dQ accumulator.
template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
attention_bwd_q_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const T* __restrict__ dout,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta, T* __restrict__ dq,
                       int lq, int lk, int kv_groups, float scale,
                       int causal, int window) {
  extern __shared__ float smem[];
  float (*qs)[D + 1] = reinterpret_cast<float (*)[D + 1]>(smem);
  float (*dos)[D + 1] = qs + BQ;
  float (*ks)[D + 1] = dos + BQ;
  float (*vs)[D + 1] = ks + BK;
  float (*dss)[BK + 1] = reinterpret_cast<float (*)[BK + 1]>(vs + BK);

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int row = threadIdx.x / LANES;
  const int sub = threadIdx.x % LANES;
  const int qi = q0 + row;
  const size_t q_base = static_cast<size_t>(bh) * lq * D;
  const size_t kv_base = static_cast<size_t>(bh / kv_groups) * lk * D;

  for (int e = threadIdx.x; e < BQ * D; e += THREADS) {
    const int r = e / D, c = e % D;
    const bool in = q0 + r < lq;
    const size_t off = q_base + static_cast<size_t>(q0 + r) * D + c;
    qs[r][c] = in ? load_f(q + off) : 0.0f;
    dos[r][c] = in ? load_f(dout + off) : 0.0f;
  }
  const size_t r_off = static_cast<size_t>(bh) * lq + qi;
  const float row_lse = qi < lq ? lse[r_off] : 0.0f;
  const float row_delta = qi < lq ? delta[r_off] : 0.0f;

  float dq_acc[D / LANES];
#pragma unroll
  for (int cc = 0; cc < D / LANES; ++cc) dq_acc[cc] = 0.0f;

  // The forward's key range for this block.
  const int q_last = min(q0 + BQ, lq) - 1;
  int k_end = lk;
  if (causal) k_end = min(k_end, q_last + 1);
  int k_begin = 0;
  if (window > 0) k_begin = max(0, q0 - window + 1);
  k_begin = (k_begin / BK) * BK;

  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    __syncthreads();   // the last tile's readers are done (and Q, dO in)
    for (int e = threadIdx.x; e < BK * D; e += THREADS) {
      const int r = e / D, c = e % D;
      const bool in = k0 + r < lk;
      const size_t off = kv_base + static_cast<size_t>(k0 + r) * D + c;
      ks[r][c] = in ? load_f(k + off) : 0.0f;
      vs[r][c] = in ? load_f(v + off) : 0.0f;
    }
    __syncthreads();

    // s = q . k and dP = dO . v for keys j = sub + LANES * jj.
    float s[BK / LANES], dp[BK / LANES];
#pragma unroll
    for (int jj = 0; jj < BK / LANES; ++jj) s[jj] = dp[jj] = 0.0f;
    for (int c = 0; c < D; ++c) {
      const float qc = qs[row][c], dc = dos[row][c];
#pragma unroll
      for (int jj = 0; jj < BK / LANES; ++jj) {
        s[jj] = fmaf(qc, ks[sub + LANES * jj][c], s[jj]);
        dp[jj] = fmaf(dc, vs[sub + LANES * jj][c], dp[jj]);
      }
    }
#pragma unroll
    for (int jj = 0; jj < BK / LANES; ++jj) {
      const int j = sub + LANES * jj;
      const int kj = k0 + j;
      bool ok = kj < lk && qi < lq;
      if (causal) ok = ok && qi >= kj;
      if (window > 0) ok = ok && (qi - kj) < window;
      const float p = ok ? expf(s[jj] * scale - row_lse) : 0.0f;
      dss[row][j] = p * (dp[jj] - row_delta);
    }
    __syncwarp();   // a query row's dS is read by its own warp only

    // dQ += dS K for columns c = sub + LANES * cc.
    for (int j = 0; j < BK; ++j) {
      const float ds = dss[row][j];
#pragma unroll
      for (int cc = 0; cc < D / LANES; ++cc)
        dq_acc[cc] = fmaf(ds, ks[j][sub + LANES * cc], dq_acc[cc]);
    }
  }

  if (qi < lq) {
    T* o = dq + q_base + static_cast<size_t>(qi) * D;
#pragma unroll
    for (int cc = 0; cc < D / LANES; ++cc)
      store_f(o + sub + LANES * cc, dq_acc[cc] * scale);
  }
}

// --- launches ----------------------------------------------------------------

// A kernel's shared-memory opt-in is a per-device attribute: set it on a
// device's first launch of each kernel only.
template <auto Kernel>
cudaError_t opt_in_smem(size_t smem) {
  static std::atomic<bool> opted_in[kMaxDevices];
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!opted_in[device].load(std::memory_order_relaxed)) {
    err = cudaFuncSetAttribute(Kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    opted_in[device].store(true, std::memory_order_relaxed);
  }
  return cudaSuccess;
}

struct Problem {
  int bh, lq, lk, kv_groups;
  float scale;
  int causal, window;
};

template <typename T, int D>
int launch_forward(const void* q, const void* k, const void* v, void* out,
                   void* lse, const Problem& p, cudaStream_t stream) {
  const size_t smem = smem_bytes<D>();
  cudaError_t err = opt_in_smem<attention_kernel<T, D>>(smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((p.lq + BQ - 1) / BQ, p.bh);
  attention_kernel<T, D><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out),
      static_cast<float*>(lse), p.lq, p.lk, p.kv_groups, p.scale, p.causal,
      p.window);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch_backward(const void* q, const void* k, const void* v,
                    const void* out, const void* dout, const void* lse,
                    void* delta, void* dq, void* dk, void* dv,
                    const Problem& p, cudaStream_t stream) {
  const int rows = p.bh * p.lq;
  const int warps_per_block = THREADS / 32;
  delta_kernel<T><<<(rows + warps_per_block - 1) / warps_per_block, THREADS,
                    0, stream>>>(
      static_cast<const T*>(out), static_cast<const T*>(dout),
      static_cast<float*>(delta), rows, D);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const size_t kv_smem = bwd_kv_smem_bytes<D>();
  err = opt_in_smem<attention_bwd_kv_kernel<T, D>>(kv_smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 kv_grid((p.lk + BK - 1) / BK, p.bh / p.kv_groups);
  attention_bwd_kv_kernel<T, D><<<kv_grid, THREADS, kv_smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dk), static_cast<T*>(dv), p.lq, p.lk, p.kv_groups,
      p.scale, p.causal, p.window);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const size_t q_smem = bwd_q_smem_bytes<D>();
  err = opt_in_smem<attention_bwd_q_kernel<T, D>>(q_smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 q_grid((p.lq + BQ - 1) / BQ, p.bh);
  attention_bwd_q_kernel<T, D><<<q_grid, THREADS, q_smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dq), p.lq, p.lk, p.kv_groups, p.scale, p.causal,
      p.window);
  return static_cast<int>(cudaGetLastError());
}

struct Forward {
  const void *q, *k, *v;
  void *out, *lse;
  Problem p;
  cudaStream_t stream;
  template <typename T, int D>
  int operator()() const {
    return launch_forward<T, D>(q, k, v, out, lse, p, stream);
  }
};

struct Backward {
  const void *q, *k, *v, *out, *dout, *lse;
  void *delta, *dq, *dk, *dv;
  Problem p;
  cudaStream_t stream;
  template <typename T, int D>
  int operator()() const {
    return launch_backward<T, D>(q, k, v, out, dout, lse, delta, dq, dk, dv,
                                 p, stream);
  }
};

// Calls fn.template operator()<T, D>() for the runtime dtype code and head
// dim; cudaErrorInvalidValue for anything the kernels are not built for.
template <typename Fn>
int dispatch(int dtype, int d, const Fn& fn) {
  auto by_d = [&](auto tag) -> int {
    using T = decltype(tag);
    switch (d) {
      case 8: return fn.template operator()<T, 8>();
      case 16: return fn.template operator()<T, 16>();
      case 32: return fn.template operator()<T, 32>();
      case 64: return fn.template operator()<T, 64>();
      case 128: return fn.template operator()<T, 128>();
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  };
  if (dtype == 0) return by_d(float{});
  if (dtype == 1) return by_d(__nv_bfloat16{});
  return static_cast<int>(cudaErrorInvalidValue);
}

bool valid_problem(const Problem& p) {
  return p.kv_groups >= 1 && p.bh % p.kv_groups == 0 && p.bh <= 65535 &&
         p.lk >= 1 && p.lq >= 0 && p.window >= 0;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out alike); d in
// {8, 16, 32, 64, 128}.  lse, (bh, lq) float32, may be null: it is then
// not written.  Returns cudaErrorInvalidValue for anything else.
int local_attention_forward(const void* q, const void* k, const void* v,
                            void* out, void* lse, int dtype, int bh, int lq,
                            int lk, int d, int kv_groups, float scale,
                            int causal, int window, void* stream) {
  if (bh == 0 || lq == 0) return 0;
  const Problem p{bh, lq, lk, kv_groups, scale, causal, window};
  if (!valid_problem(p)) return static_cast<int>(cudaErrorInvalidValue);
  return dispatch(dtype, d, Forward{q, k, v, out, lse, p,
                                    static_cast<cudaStream_t>(stream)});
}

// The gradients dq (bh, lq, d), dk and dv (bh / kv_groups, lk, d) of the
// forward above, from its inputs, its output, its lse and dout (the
// output's gradient), all in the forward's dtype but lse.  delta is
// (bh, lq) float32 scratch.
int local_attention_backward(const void* q, const void* k, const void* v,
                             const void* out, const void* dout,
                             const void* lse, void* delta, void* dq,
                             void* dk, void* dv, int dtype, int bh, int lq,
                             int lk, int d, int kv_groups, float scale,
                             int causal, int window, void* stream) {
  if (bh == 0) return 0;
  const Problem p{bh, lq, lk, kv_groups, scale, causal, window};
  if (!valid_problem(p)) return static_cast<int>(cudaErrorInvalidValue);
  return dispatch(dtype, d, Backward{q, k, v, out, dout, lse, delta, dq,
                                     dk, dv, p,
                                     static_cast<cudaStream_t>(stream)});
}

const char* local_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
