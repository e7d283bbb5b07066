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
// 5 us and the bytes bound is the larger.  The FLOPs grow with the query
// heads and the bytes with the KV heads, so under GQA the operations bound
// wins: nemotron-4-340b's prefill (96 query heads on 8 KV heads, D 192)
// is 3.87e10 FLOP against 81.8 MB, 39 us against 24 us.  Two routes,
// chosen by the caller from the dtype and the head dim, never by a
// failure:
//
// * The tensor-core route (bf16, D in {64, 128, 192, 256}: every
//   attention of the serving and training paths).  The forward is
//   warp-specialised: one CTA of three warpgroups per (batch*head,
//   128-query tile; at D 256 two warpgroups and 64 queries), the
//   heaviest causal tiles launched first.  A
//   producer warpgroup gives up registers (setmaxnreg) and one of its
//   threads starts TMA loads: the Q tile once, then 64-key K and V tiles
//   into a two-stage ring, each stage with a full and an empty mbarrier.
//   Each tile is D / 64 sub-tiles of 64 columns, so D only changes how
//   many boxes a load takes and how many n64 products a step issues:
//   shared memory is 145 KB at D 192 (of 227 KB).  A consumer thread
//   holds D / 2 fp32 of O beside 32 of S and 32 of P; ptxas compiles the
//   kernel at the 384-thread launch bound's 168 registers, which that
//   fits up to D 192.  At D 256 (O alone is 128 registers) one consumer
//   owns a 64-query CTA of two warpgroups, compiled at up to 255
//   registers, in 161 KB of shared memory (tc_consumers).  Each
//   consumer warpgroup owns 64 query rows: S = Q K^T is wgmma (both
//   operands in shared memory, 128-byte swizzled as TMA wrote them), the
//   online softmax runs on the accumulator fragment in registers, and
//   O += P V is wgmma with P from registers and V as the transposed
//   (MN-major) shared operand.  S is exact in its products (bf16 x bf16
//   into fp32); P is not bf16, so it is split into hi = bf16(p) and
//   lo = bf16(p - hi), two products into the same fp32 accumulator: about
//   16 bits of P, 1.5x the tensor-core products.  With the products
//   there, what bounds the forward is the softmax on the CUDA cores (a
//   scale, a max, an exp, a sum and the split per score), so it runs in
//   the log2 domain (each exponential one exp2) and interior tiles
//   compile without masks.  The TMA descriptors are 3-D, (D, L, heads),
//   so the ragged last key tile of a head reads zeros, never the next
//   head's keys; keys past Lk are still masked, since a zero key scores
//   0, not -1e30.  V, O and their products run at V's own width DV (64
//   up to D in steps of 64: MLA's 128 at D 192), D / 64 and DV / 64
//   sub-tiles alike.  The backward is built the same way (below).
// * The FMA route (float32 and float16 at every head dim, bf16 at the
//   rest): every product is an fp32 FMA on the CUDA cores
//   (67 TFLOP/s peak), so that it meets the reference's f32 bound
//   (rtol/atol 2e-5).  The kernels are built for head-dim buckets DP of
//   8, 16, 32, 64, 128, 192 and 256 and take the head dim d at run time:
//   tiles are zero past column d (a zero adds nothing to a dot product)
//   and only columns below d are stored, so the result does not depend on
//   the bucket.  One block of 4 R threads per (batch*head, R-query tile),
//   R = 64 up to DP 128 and 32 above (fma_rows), so that the fp32 tiles
//   fit in shared memory (at most 162 KB, the dK/dV kernel at DP 128)
//   and the accumulators in registers.  Four neighbouring lanes share one
//   query row: each keeps R / 4 of the tile's R scores and DP / 4 columns
//   of the fp32 accumulator, and up to DP 128 the whole query row in
//   registers (above, it is read from shared memory).  The block loops
//   over R-key tiles of K and V, staged through shared memory as fp32;
//   that loop takes the place of the TPU's sequential kv grid axis and
//   its VMEM scratch (acc, m, l).  Row max and row sum are reduced across
//   the four lanes with shuffles; P goes through shared memory to the
//   P.V product, read only by its own warp.  Past D 256 (the WIDE
//   kernels, at bucket 256) a grid z index picks one output chunk of 256
//   columns: each key tile sums S (and, backward, dP) over the head dim's
//   256-column chunks in order, staging each chunk's operands through
//   the same shared tiles, then stages the chunk's V (forward), Q and dO
//   (dK/dV) or K (dQ) columns for its own accumulator.  So every output
//   chunk recomputes S: ceil(D / 256) times the score products, for tiles
//   and registers no larger than at D 256 (a whole fp32 row of O or dQ in
//   registers would not fit past 256 columns), and the same order of sums
//   in every chunk, so each chunk sees the same P.
//
// Both routes skip tiles that are fully masked for every row of the
// block (above the causal diagonal, or older than the window): their
// keys would add p = 0 and leave m unchanged, so skipping is exact.
// Masked scores are -1e30 and masked p are 0, as in the reference, so m
// stays finite and no exp() sees -inf.  The flush divides by
// max(l, 1e-20) and stores in q's dtype (bf16 rounds to nearest even, as
// torch's cast does).  Ragged Lq and Lk are masked: rows past Lq are not
// stored, keys past Lk are masked.  GQA reads the shared K/V head in
// place, with no copies.
//
// When a gradient is wanted the forward also writes each row's log-sum-exp,
// lse = m + log(max(l, 1e-20)) in fp32, at its flush; otherwise it writes
// nothing more and its output is what it was without that option.
//
// The backward (the JAX reference has none: it trains through its chunked
// jnp path) is the standard recompute design, in three kernels:
//   1. delta[bh, i] = sum_c dO . O per row (one warp per row);
//   2. dK and dV: one block per (KV head, key tile).  It loops over the
//      query tiles of every query head of its group that can see the tile,
//      recomputes P = exp(s - lse), dP = dO . V and dS = P (dP - delta),
//      and sums dV += P^T dO and dK += dS^T Q in registers, so GQA's sum
//      over the group needs no atomics;
//   3. dQ: one block per (batch*head, query tile), looping over the key
//      tiles the forward visits, dQ += dS K.
// The masks, the tile skips and the ragged edges are the forward's.  There
// are no float atomics and every sum has a fixed order, so the backward is
// bit-for-bit deterministic.  On the FMA route all products are fp32 FMA,
// so the f32 path meets the reference's f32 bounds; gradients are stored
// in the operands' dtype.
//
// On the tensor-core route kernels 2 and 3 take the forward's machinery:
// TMA loads (3-D maps, so a head's ragged last tile reads zeros) of the
// CTA's resident tiles once (K and V; Q and dO) and of the rest into a
// ring of 2 to 4 stages (as many as fit, tcb_stages) with full and empty
// mbarriers (Q and dO; K and V), and every product on wgmma from the
// 128-byte swizzled tiles: S^T = K Q^T and dP^T = V dO^T (S and dP in
// kernel 3) with both operands in shared memory, dV += P^T dO,
// dK += dS^T Q and dQ += dS K with P or dS from registers (the
// accumulator's layout read as A fragments, as the forward's P V) and
// dO, Q or K as the MN-major operand.  The lse and delta rows are read
// from global memory by the threads that need them, while a product
// runs: a head's rows start at any 4-byte offset, and a TMA box must
// start 16-byte aligned.  What bounds it: a visible pair costs
// 2 (3D + 2DV) FLOP in the algorithm, and an MLA step at
// (256 / 256, 1024, 192, Dv 128) is 2.2e11 FLOP against 0.67 GB (the
// inputs, out, dout and lse read, the gradients written), 226 us against
// 201 us at the card's rates, so the tensor rate bounds every training
// shape, if narrowly (D 64: 43 us against 40 us at (128, 1024, 64)).
// What the design does about it:
// * No product is computed twice in a CTA.  The dK/dV kernel's 64 x D
//   and 64 x DV fp32 accumulators would not both fit one warpgroup's
//   registers above D 128, so its two warpgroups own the same 64 keys and
//   split by role: warpgroup 0 computes S^T and P^T, passes P^T through
//   shared memory in fp32 (two 16 KB buffers, so that it may run a step
//   ahead; named barriers say written and read) and keeps dV; warpgroup 1
//   computes dP^T and dS^T and keeps dK.  The two roles' products
//   balance: D + 2DV against DV + 2D.  The dQ kernel gives each
//   warpgroup 64 query rows, so S and dP are computed once in it;
//   kernels 2 and 3 each recompute S and dP, as the recompute design
//   does.
// * Registers set the CTAs' shapes (tcb_q_consumers): at D 256 a thread
//   of the dK role holds 128 fp32 of dK beside 64 x 64 scores and their
//   hi/lo halves, about 200 registers, and a dQ thread at D 192 as many.
//   ptxas compiles three warpgroups (or two and a producer warp, which it
//   counts as three) at 168 registers a thread, and setmaxnreg moves
//   registers at run time without letting ptxas allocate more, so the
//   dK/dV kernel is two warpgroups (up to 255 registers) whose loads one
//   thread of warpgroup 1 issues, refilling a stage once both have
//   released it; the dQ kernel keeps a producer warp beside one consumer
//   warpgroup (two at D 128).  At D 64 two CTAs of each kernel share an
//   SM.  No kernel spills.
// * P and dS are not bf16, so each is split into bf16 hi and lo, two
//   products into one fp32 accumulator, as in the forward: the kernels do
//   6D + 4DV products a visible pair against the bound's 3D + 2DV, so
//   twice the bound is the least they could take (MLA's 0.45 ms at the
//   shape above; 0.087 ms at (64 / 64, 1024, 128) and at (128, 1024, 64);
//   1.04 ms at (32 / 2, 4096, 256) window 2048).  P^T crosses shared
//   memory in fp32, so P and dS are rounded only by that split.
// * The scores take the exp2 domain and interior tiles compile without
//   masks, as in the forward; the ring's loads are in flight while the
//   products run, so a warpgroup waits on a barrier only when it runs
//   dry.
// * What it leaves: each step's products wait on the one before within a
//   warpgroup (a wgmma group, then the softmax or dS on its result, then
//   the next group), so at small D a step is short and its latencies, not
//   the tensor rate, set its time; and a CTA's key tile walks its query
//   tiles alone, so a shape with few KV heads and long keys (GQA at batch
//   1) fills few SMs.

// C ABI: each entry point launches on the given stream, allocates nothing,
// does not synchronise, and returns cudaGetLastError().  It launches on the
// calling thread's current device, which the Python wrapper selects; it
// never changes it (the tensor-core route binds that device's primary
// context to the thread, which encoding a TMA map needs).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stddef.h>

#include "hopper.cuh"

namespace {

constexpr int LANES = 4;                // lanes per row
constexpr int DELTA_THREADS = 256;      // the delta kernel: 8 rows a block
constexpr float NEG = -1.0e30f;

// Rows a block of the FMA kernels owns (queries, keys and the query or key
// step alike): 64 up to a padded head dim of 128, 32 above, so that the
// fp32 tiles fit in shared memory and the per-lane accumulators (DP / 4
// columns, two of them in the dK/dV kernel) in registers.
template <int DP>
__host__ __device__ constexpr int fma_rows() { return DP > 128 ? 32 : 64; }

// The FMA forward keeps each lane's query row in registers up to DP 128;
// above, that row alone would spill, so it stays in shared memory.
template <int DP>
__host__ __device__ constexpr bool fma_q_in_regs() { return DP <= 128; }

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ float load_f(const __half* p) {
  return __half2float(*p);
}
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
__device__ __forceinline__ void store_f(__half* p, float v) {
  *p = __float2half_rn(v);
}

// Element (r, c) of rows [r0, ..) of a (rows, d) plane as fp32: 0 past
// ``limit`` rows and past column d (the padding of the DP bucket).
template <typename T>
__device__ __forceinline__ float load_padded(const T* plane, int r0, int r,
                                             int c, int limit, int d) {
  return (r0 + r < limit && c < d)
             ? load_f(plane + static_cast<size_t>(r0 + r) * d + c)
             : 0.0f;
}

// Shared memory of the forward: K tile [R][DP + 1] (padded against bank
// conflicts), V tile [R][DP], P [R][R + 1], and, where the query rows stay
// in shared memory, the Q tile [R][DP + 1]; otherwise the K buffer stages
// the Q tile first.
template <int DP>
constexpr size_t smem_bytes() {
  constexpr int R = fma_rows<DP>();
  return sizeof(float) * (R * (DP + 1) + R * DP + R * (R + 1) +
                          (fma_q_in_regs<DP>() ? 0 : R * (DP + 1)));
}

// One block of 4 R threads per (batch*head, R-query tile); four lanes
// share one query row.  DP is the head dim's bucket, d the head dim: the
// tiles are zero past column d, which adds nothing to any dot product,
// and only columns below d are stored.
template <typename T, int DP, bool WIDE>
__global__ void __launch_bounds__(fma_rows<DP>() * LANES)
attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out,
                 float* __restrict__ lse, int lq, int lk, int d,
                 int kv_groups, float scale, int causal, int window) {
  constexpr int R = fma_rows<DP>();
  constexpr int NT = R * LANES;
  constexpr int KPL = R / LANES;          // keys a lane scores per tile
  constexpr bool QREG = fma_q_in_regs<DP>();
  extern __shared__ float smem[];
  float (*ks)[DP + 1] = reinterpret_cast<float (*)[DP + 1]>(smem);
  float (*vs)[DP] = reinterpret_cast<float (*)[DP]>(smem + R * (DP + 1));
  float (*ps)[R + 1] =
      reinterpret_cast<float (*)[R + 1]>(smem + R * (DP + 1) + R * DP);
  float (*qs)[DP + 1] =
      QREG ? ks
           : reinterpret_cast<float (*)[DP + 1]>(smem + R * (DP + 1) +
                                                 R * DP + R * (R + 1));

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * R;
  const int row = threadIdx.x / LANES;   // query row within the tile
  const int sub = threadIdx.x % LANES;   // lane within the row's four
  const int qi = q0 + row;               // absolute query index
  const int c_out = WIDE ? blockIdx.z * DP : 0;   // first output column
  const T* q_plane = q + static_cast<size_t>(bh) * lq * d;
  const size_t kv_base = static_cast<size_t>(bh / kv_groups) * lk * d;

  // The Q tile; rows past lq read 0 and are never stored.  Up to DP 128
  // each lane then keeps its row in registers.  A wide head dim stages
  // its Q columns chunk by chunk inside the key loop instead.
  if constexpr (!WIDE) {
    for (int e = threadIdx.x; e < R * DP; e += NT) {
      const int r = e / DP, c = e % DP;
      qs[r][c] = load_padded(q_plane, q0, r, c, lq, d);
    }
    __syncthreads();
  }
  float qr[QREG ? DP : 1];
  if constexpr (QREG) {
#pragma unroll
    for (int c = 0; c < DP; ++c) qr[c] = qs[row][c];
    __syncthreads();   // the K tile overwrites the staged Q tile
  }

  float acc[DP / LANES];
#pragma unroll
  for (int c = 0; c < DP / LANES; ++c) acc[c] = 0.0f;
  float m = NEG, l = 0.0f;

  // The key range any row of this block can see; tiles outside it are
  // fully masked for every row and skipped.
  const int q_last = min(q0 + R, lq) - 1;
  int k_end = lk;
  if (causal) k_end = min(k_end, q_last + 1);
  int k_begin = 0;
  if (window > 0) k_begin = max(0, q0 - window + 1);
  k_begin = (k_begin / R) * R;

  const unsigned full = 0xffffffffu;
  for (int k0 = k_begin; k0 < k_end; k0 += R) {
    // S = scale * q . k for keys j = sub + LANES * jj, masked to -1e30;
    // each dot sums over c in order, from registers or from shared memory.
    float s[KPL];
    if constexpr (WIDE) {
      // d > DP: S sums over the head dim's chunks of DP columns in order,
      // each chunk's Q and K columns staged through shared memory; then
      // V's columns of this block's output chunk.
#pragma unroll
      for (int jj = 0; jj < KPL; ++jj) s[jj] = 0.0f;
      for (int c0 = 0; c0 < d; c0 += DP) {
        for (int e = threadIdx.x; e < R * DP; e += NT) {
          const int r = e / DP, c = e % DP;
          qs[r][c] = load_padded(q_plane, q0, r, c0 + c, lq, d);
          ks[r][c] = load_padded(k + kv_base, k0, r, c0 + c, lk, d);
        }
        __syncthreads();
#pragma unroll 4
        for (int c = 0; c < DP; ++c) {
          const float qc = qs[row][c];
#pragma unroll
          for (int jj = 0; jj < KPL; ++jj)
            s[jj] = fmaf(qc, ks[sub + LANES * jj][c], s[jj]);
        }
        __syncthreads();   // the next chunk overwrites Q and K
      }
      for (int e = threadIdx.x; e < R * DP; e += NT) {
        const int r = e / DP, c = e % DP;
        vs[r][c] = load_padded(v + kv_base, k0, r, c_out + c, lk, d);
      }
      __syncthreads();
    } else {
      for (int e = threadIdx.x; e < R * DP; e += NT) {
        const int r = e / DP, c = e % DP;
        ks[r][c] = load_padded(k + kv_base, k0, r, c, lk, d);
        vs[r][c] = load_padded(v + kv_base, k0, r, c, lk, d);
      }
      __syncthreads();
      if constexpr (QREG) {
#pragma unroll
        for (int jj = 0; jj < KPL; ++jj) {
          const int j = sub + LANES * jj;
          float dot = 0.0f;
#pragma unroll
          for (int c = 0; c < DP; ++c) dot = fmaf(qr[c], ks[j][c], dot);
          s[jj] = dot;
        }
      } else {
#pragma unroll
        for (int jj = 0; jj < KPL; ++jj) s[jj] = 0.0f;
#pragma unroll 4
        for (int c = 0; c < DP; ++c) {
          const float qc = qs[row][c];
#pragma unroll
          for (int jj = 0; jj < KPL; ++jj)
            s[jj] = fmaf(qc, ks[sub + LANES * jj][c], s[jj]);
        }
      }
    }
    unsigned valid = 0u;   // bit jj: key sub + LANES * jj is visible
    float tile_max = NEG;
#pragma unroll
    for (int jj = 0; jj < KPL; ++jj) {
      const int kj = k0 + sub + LANES * jj;
      bool ok = kj < lk;
      if (causal) ok = ok && qi >= kj;
      if (window > 0) ok = ok && (qi - kj) < window;
      s[jj] = ok ? s[jj] * scale : NEG;
      valid |= static_cast<unsigned>(ok) << jj;
      tile_max = fmaxf(tile_max, s[jj]);
    }
    tile_max = fmaxf(tile_max, __shfl_xor_sync(full, tile_max, 1, LANES));
    tile_max = fmaxf(tile_max, __shfl_xor_sync(full, tile_max, 2, LANES));
    const float m_new = fmaxf(m, tile_max);
    const float alpha = expf(m - m_new);
    float row_sum = 0.0f;
#pragma unroll
    for (int jj = 0; jj < KPL; ++jj) {
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
    for (int cc = 0; cc < DP / LANES; ++cc) acc[cc] *= alpha;
    for (int j = 0; j < R; ++j) {
      const float p = ps[row][j];
#pragma unroll
      for (int cc = 0; cc < DP / LANES; ++cc)
        acc[cc] = fmaf(p, vs[j][sub + LANES * cc], acc[cc]);
    }
    __syncthreads();   // the next tile overwrites K, V and P
  }

  if (qi < lq) {
    const float inv = 1.0f / fmaxf(l, 1e-20f);
    T* o = out + static_cast<size_t>(bh) * lq * d +
           static_cast<size_t>(qi) * d + c_out;
#pragma unroll
    for (int cc = 0; cc < DP / LANES; ++cc) {
      const int c = sub + LANES * cc;
      if (c_out + c < d) store_f(o + c, acc[cc] * inv);
    }
    if (lse != nullptr && sub == 0 && c_out == 0)
      lse[static_cast<size_t>(bh) * lq + qi] = m + logf(fmaxf(l, 1e-20f));
  }
}

// --- backward ------------------------------------------------------------

// delta[r] = sum_c dout[r][c] * out[r][c] over rows r of (rows, d), one
// warp per row, lanes striding the columns.
template <typename T>
__global__ void __launch_bounds__(DELTA_THREADS)
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

// Shared memory of the dK/dV kernel: K and V tiles [R][DP + 1], Q and dO
// tiles [R][DP + 1], P and dS [R][R + 1], lse and delta [R].
template <int DP>
constexpr size_t bwd_kv_smem_bytes() {
  constexpr int R = fma_rows<DP>();
  return sizeof(float) * (4 * R * (DP + 1) + 2 * R * (R + 1) + 2 * R);
}

// One block per (KV head g, R-key tile).  Four lanes share one key row:
// each computes s and dP for R / 4 of a step's R queries and keeps DP / 4
// columns of the row's dK and dV accumulators.
template <typename T, int DP, bool WIDE>
__global__ void __launch_bounds__(fma_rows<DP>() * LANES)
attention_bwd_kv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        T* __restrict__ dk, T* __restrict__ dv, int lq,
                        int lk, int d, int kv_groups, float scale,
                        int causal, int window) {
  constexpr int R = fma_rows<DP>();
  constexpr int NT = R * LANES;
  constexpr int PER_LANE = R / LANES;
  extern __shared__ float smem[];
  float (*ks)[DP + 1] = reinterpret_cast<float (*)[DP + 1]>(smem);
  float (*vs)[DP + 1] = ks + R;
  float (*qs)[DP + 1] = vs + R;
  float (*dos)[DP + 1] = qs + R;
  float (*ps)[R + 1] = reinterpret_cast<float (*)[R + 1]>(dos + R);
  float (*dss)[R + 1] = ps + R;
  float* lse_s = reinterpret_cast<float*>(dss + R);
  float* delta_s = lse_s + R;

  const int g = blockIdx.y;
  const int k0 = blockIdx.x * R;
  const int row = threadIdx.x / LANES;   // key row within the tile
  const int sub = threadIdx.x % LANES;
  const int kj = k0 + row;               // absolute key index
  const int c_out = WIDE ? blockIdx.z * DP : 0;   // first dK/dV column
  const size_t kv_base = static_cast<size_t>(g) * lk * d;

  if constexpr (!WIDE) {
    for (int e = threadIdx.x; e < R * DP; e += NT) {
      const int r = e / DP, c = e % DP;
      ks[r][c] = load_padded(k + kv_base, k0, r, c, lk, d);
      vs[r][c] = load_padded(v + kv_base, k0, r, c, lk, d);
    }
  }

  float dk_acc[DP / LANES], dv_acc[DP / LANES];
#pragma unroll
  for (int cc = 0; cc < DP / LANES; ++cc) dk_acc[cc] = dv_acc[cc] = 0.0f;

  // The query range that can see some key of this tile (the forward's
  // skips, seen from the key side); tiles outside it contribute nothing.
  const int k_last = min(k0 + R, lk) - 1;
  const int q_begin = causal ? (k0 / R) * R : 0;
  const int q_end = window > 0 ? min(lq, k_last + window) : lq;

  for (int hg = 0; hg < kv_groups; ++hg) {
    const int bh = g * kv_groups + hg;
    const size_t q_base = static_cast<size_t>(bh) * lq * d;
    const size_t r_base = static_cast<size_t>(bh) * lq;
    for (int q0 = q_begin; q0 < q_end; q0 += R) {
      // s = q . k and dP = dO . v for queries i = sub + LANES * ii: over
      // the tiles' DP columns, or, for a wide head dim, over its chunks of
      // DP columns in order, each staged with its K, V, Q and dO columns;
      // then the Q and dO columns of this block's dK/dV chunk.
      float s[PER_LANE], dp[PER_LANE];
#pragma unroll
      for (int ii = 0; ii < PER_LANE; ++ii) s[ii] = dp[ii] = 0.0f;
      for (int c0 = 0; c0 < (WIDE ? d : 1); c0 += DP) {
        __syncthreads();   // the last tile's readers are done (and K, V in)
        for (int e = threadIdx.x; e < R * DP; e += NT) {
          const int r = e / DP, c = e % DP;
          if constexpr (WIDE) {
            ks[r][c] = load_padded(k + kv_base, k0, r, c0 + c, lk, d);
            vs[r][c] = load_padded(v + kv_base, k0, r, c0 + c, lk, d);
          }
          qs[r][c] = load_padded(q + q_base, q0, r, c0 + c, lq, d);
          dos[r][c] = load_padded(dout + q_base, q0, r, c0 + c, lq, d);
        }
        if (c0 == 0 && threadIdx.x < R) {
          const int qi = q0 + threadIdx.x;
          lse_s[threadIdx.x] = qi < lq ? lse[r_base + qi] : 0.0f;
          delta_s[threadIdx.x] = qi < lq ? delta[r_base + qi] : 0.0f;
        }
        __syncthreads();
        for (int c = 0; c < DP; ++c) {
          const float kc = ks[row][c], vc = vs[row][c];
#pragma unroll
          for (int ii = 0; ii < PER_LANE; ++ii) {
            s[ii] = fmaf(kc, qs[sub + LANES * ii][c], s[ii]);
            dp[ii] = fmaf(vc, dos[sub + LANES * ii][c], dp[ii]);
          }
        }
      }
      if constexpr (WIDE) {
        __syncthreads();
        for (int e = threadIdx.x; e < R * DP; e += NT) {
          const int r = e / DP, c = e % DP;
          qs[r][c] = load_padded(q + q_base, q0, r, c_out + c, lq, d);
          dos[r][c] = load_padded(dout + q_base, q0, r, c_out + c, lq, d);
        }
        __syncthreads();
      }
#pragma unroll
      for (int ii = 0; ii < PER_LANE; ++ii) {
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
      for (int i = 0; i < R; ++i) {
        const float p = ps[row][i], ds = dss[row][i];
#pragma unroll
        for (int cc = 0; cc < DP / LANES; ++cc) {
          dv_acc[cc] = fmaf(p, dos[i][sub + LANES * cc], dv_acc[cc]);
          dk_acc[cc] = fmaf(ds, qs[i][sub + LANES * cc], dk_acc[cc]);
        }
      }
    }
  }

  if (kj < lk) {
    const size_t off = kv_base + static_cast<size_t>(kj) * d + c_out;
#pragma unroll
    for (int cc = 0; cc < DP / LANES; ++cc) {
      const int c = sub + LANES * cc;
      if (c_out + c >= d) continue;
      store_f(dk + off + c, dk_acc[cc] * scale);
      store_f(dv + off + c, dv_acc[cc]);
    }
  }
}

// Shared memory of the dQ kernel: Q and dO tiles [R][DP + 1], K and V
// tiles [R][DP + 1], dS [R][R + 1].
template <int DP>
constexpr size_t bwd_q_smem_bytes() {
  constexpr int R = fma_rows<DP>();
  return sizeof(float) * (4 * R * (DP + 1) + R * (R + 1));
}

// One block per (batch*head, R-query tile), as the forward.  Four lanes
// share one query row: each computes s and dP for R / 4 of a tile's R keys
// and keeps DP / 4 columns of the row's dQ accumulator.
template <typename T, int DP, bool WIDE>
__global__ void __launch_bounds__(fma_rows<DP>() * LANES)
attention_bwd_q_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const T* __restrict__ dout,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta, T* __restrict__ dq,
                       int lq, int lk, int d, int kv_groups, float scale,
                       int causal, int window) {
  constexpr int R = fma_rows<DP>();
  constexpr int NT = R * LANES;
  constexpr int PER_LANE = R / LANES;
  extern __shared__ float smem[];
  float (*qs)[DP + 1] = reinterpret_cast<float (*)[DP + 1]>(smem);
  float (*dos)[DP + 1] = qs + R;
  float (*ks)[DP + 1] = dos + R;
  float (*vs)[DP + 1] = ks + R;
  float (*dss)[R + 1] = reinterpret_cast<float (*)[R + 1]>(vs + R);

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * R;
  const int row = threadIdx.x / LANES;
  const int sub = threadIdx.x % LANES;
  const int qi = q0 + row;
  const int c_out = WIDE ? blockIdx.z * DP : 0;   // first dQ column
  const size_t q_base = static_cast<size_t>(bh) * lq * d;
  const size_t kv_base = static_cast<size_t>(bh / kv_groups) * lk * d;

  if constexpr (!WIDE) {
    for (int e = threadIdx.x; e < R * DP; e += NT) {
      const int r = e / DP, c = e % DP;
      qs[r][c] = load_padded(q + q_base, q0, r, c, lq, d);
      dos[r][c] = load_padded(dout + q_base, q0, r, c, lq, d);
    }
  }
  const size_t r_off = static_cast<size_t>(bh) * lq + qi;
  const float row_lse = qi < lq ? lse[r_off] : 0.0f;
  const float row_delta = qi < lq ? delta[r_off] : 0.0f;

  float dq_acc[DP / LANES];
#pragma unroll
  for (int cc = 0; cc < DP / LANES; ++cc) dq_acc[cc] = 0.0f;

  // The forward's key range for this block.
  const int q_last = min(q0 + R, lq) - 1;
  int k_end = lk;
  if (causal) k_end = min(k_end, q_last + 1);
  int k_begin = 0;
  if (window > 0) k_begin = max(0, q0 - window + 1);
  k_begin = (k_begin / R) * R;

  for (int k0 = k_begin; k0 < k_end; k0 += R) {
    // s = q . k and dP = dO . v for keys j = sub + LANES * jj: over the
    // tiles' DP columns, or, for a wide head dim, over its chunks of DP
    // columns in order, each staged with its Q, dO, K and V columns; then
    // the K columns of this block's dQ chunk.
    float s[PER_LANE], dp[PER_LANE];
#pragma unroll
    for (int jj = 0; jj < PER_LANE; ++jj) s[jj] = dp[jj] = 0.0f;
    for (int c0 = 0; c0 < (WIDE ? d : 1); c0 += DP) {
      __syncthreads();   // the last tile's readers are done (and Q, dO in)
      for (int e = threadIdx.x; e < R * DP; e += NT) {
        const int r = e / DP, c = e % DP;
        if constexpr (WIDE) {
          qs[r][c] = load_padded(q + q_base, q0, r, c0 + c, lq, d);
          dos[r][c] = load_padded(dout + q_base, q0, r, c0 + c, lq, d);
        }
        ks[r][c] = load_padded(k + kv_base, k0, r, c0 + c, lk, d);
        vs[r][c] = load_padded(v + kv_base, k0, r, c0 + c, lk, d);
      }
      __syncthreads();
      for (int c = 0; c < DP; ++c) {
        const float qc = qs[row][c], dc = dos[row][c];
#pragma unroll
        for (int jj = 0; jj < PER_LANE; ++jj) {
          s[jj] = fmaf(qc, ks[sub + LANES * jj][c], s[jj]);
          dp[jj] = fmaf(dc, vs[sub + LANES * jj][c], dp[jj]);
        }
      }
    }
    if constexpr (WIDE) {
      __syncthreads();
      for (int e = threadIdx.x; e < R * DP; e += NT) {
        const int r = e / DP, c = e % DP;
        ks[r][c] = load_padded(k + kv_base, k0, r, c_out + c, lk, d);
      }
      __syncthreads();
    }
#pragma unroll
    for (int jj = 0; jj < PER_LANE; ++jj) {
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
    for (int j = 0; j < R; ++j) {
      const float ds = dss[row][j];
#pragma unroll
      for (int cc = 0; cc < DP / LANES; ++cc)
        dq_acc[cc] = fmaf(ds, ks[j][sub + LANES * cc], dq_acc[cc]);
    }
  }

  if (qi < lq) {
    T* o = dq + q_base + static_cast<size_t>(qi) * d + c_out;
#pragma unroll
    for (int cc = 0; cc < DP / LANES; ++cc) {
      const int c = sub + LANES * cc;
      if (c_out + c < d) store_f(o + c, dq_acc[cc] * scale);
    }
  }
}

// --- the tensor-core route: shared helpers ----------------------------------

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// (x0, x1) as two bf16 pairs, hi = bf16(x) and lo = bf16(x - hi), so that
// hi + lo carries about 16 bits of x; the low half holds x0.
__device__ __forceinline__ void split_bf16x2(float x0, float x1, uint32_t& hi,
                                             uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = bf16x2_bits(h);
  lo = bf16x2_bits(__floats2bfloat162_rn(x0 - hf.x, x1 - hf.y));
}

// 2^x, flushing results below 2^-126 to 0 (one MUFU.EX2): p that small
// adds nothing to a row sum of at least 1.
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void store_bf16x2(__nv_bfloat16* p, float x0,
                                             float x1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x0, x1);
}

// The visibility rule of the module note, for one (query, key) pair.
__device__ __forceinline__ bool visible(int qi, int kj, int lq, int lk,
                                        int causal, int window) {
  bool ok = kj < lk && qi < lq;
  if (causal) ok = ok && qi >= kj;
  if (window > 0) ok = ok && (qi - kj) < window;
  return ok;
}

// D (64 x 64, fp32) += A (64 x 16, smem) * B (16 x 64, smem, K-major).
__device__ __forceinline__ void wgmma_ss_n64(float* d, uint64_t desc_a,
                                              uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// D (64 x 64, fp32) += A (64 x 16, registers) * B (16 x 64, smem,
// MN-major: the transposed operand).
__device__ __forceinline__ void wgmma_rs_n64_tb(float* d, const uint32_t* a,
                                                 uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// --- the tensor-core route: forward -------------------------------------------

constexpr int TC_BN = 64;           // keys per K/V tile
constexpr int TC_STAGES = 2;        // K/V ring depth

// Consumer warpgroups of the forward, 64 query rows each, and the producer
// after them.  Up to D 192 two consumers share a 128-query CTA of 384
// threads, compiled at the launch bound's 168 registers a thread (ptxas
// allocates for the bound; setmaxnreg only moves registers between the
// warpgroups at run time), which holds O's D / 2 fp32, S and P up to
// D 192.  At D 256 O alone is 128 registers, so one consumer owns a
// 64-query CTA of 256 threads, compiled at up to 255 registers, and no
// warpgroup changes its count.
__host__ __device__ constexpr int tc_consumers(int d) {
  return d > 192 ? 1 : 2;
}
__host__ __device__ constexpr int tc_bm(int d) {   // queries a CTA
  return 64 * tc_consumers(d);
}
__host__ __device__ constexpr int tc_threads(int d) {
  return 128 * (tc_consumers(d) + 1);
}
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// Shared memory of the forward, in bytes from a 1024-aligned base.  Each
// tile is stored as D/64 (V: DV/64) sub-tiles of [rows][64] bf16,
// 128-byte swizzled.
template <int D, int DV>
struct TcFwdSmem {
  static constexpr int Q_BYTES = tc_bm(D) * D * 2;
  static constexpr int K_BYTES = TC_BN * D * 2;           // one K tile
  static constexpr int V_BYTES = TC_BN * DV * 2;          // one V tile
  static constexpr int Q = 0;
  static constexpr int K = Q + Q_BYTES;                    // K[stage]
  static constexpr int V = K + TC_STAGES * K_BYTES;        // V[stage]
  static constexpr int BAR = V + TC_STAGES * V_BYTES;      // q, full, empty
  static constexpr int BYTES = BAR + 8 * (1 + 2 * TC_STAGES) + 1024;
};

// One tile's online softmax on the S accumulator fragment of NS scores a
// thread (element i: row (i / 2) % 2 of the thread's two, key
// 8 (i / 4) + col0 + i % 2 of the tile).  Scores and maxima are kept in
// the log2 domain, scaled by scale * log2(e), so that each exponential is
// one exp2.  EDGE tiles (across the causal diagonal, the window edge or
// the end of the keys) mask to -1e30 and p = 0; the others compile without
// masks.  On return sc holds p and alpha each row's rescale of l and O.
template <bool EDGE, int NS>
__device__ __forceinline__ void online_softmax(
    float* sc, float* m, float* l, float* alpha, float scale_log2, int row0,
    int k0, int col0, int lq, int lk, int causal, int window) {
  static_assert(NS <= 32, "one visibility bit per score");
  uint32_t valid = ~0u;     // bit i: element i is visible
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int i = 0; i < NS; ++i) {
    const int r = (i >> 1) & 1;
    sc[i] *= scale_log2;
    if (EDGE && !visible(row0 + 8 * r, k0 + 8 * (i / 4) + col0 + (i & 1),
                         lq, lk, causal, window)) {
      valid &= ~(1u << i);
      sc[i] = NEG;
    }
    mx[r] = fmaxf(mx[r], sc[i]);
  }
  float rs[2] = {0.0f, 0.0f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    alpha[r] = exp2_ftz(m[r] - mx[r]);
    m[r] = mx[r];
  }
#pragma unroll
  for (int i = 0; i < NS; ++i) {
    const int r = (i >> 1) & 1;
    const float p = ((valid >> i) & 1u) ? exp2_ftz(sc[i] - m[r]) : 0.0f;
    sc[i] = p;
    rs[r] += p;
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 1);
    rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 2);
    l[r] = l[r] * alpha[r] + rs[r];
  }
}

template <int D, int DV>
__global__ void __launch_bounds__(tc_threads(D), 1)
attention_tc_kernel(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v,
                    __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                    int lq, int lk, int kv_groups, float scale, int causal,
                    int window) {
  using L = TcFwdSmem<D, DV>;
  constexpr int BN = TC_BN;
  constexpr int NS = BN / 2;                // S registers a thread
  constexpr int SUBS = D / 64;              // 64-column sub-tiles of Q, K
  constexpr int VSUBS = DV / 64;            // of V and O
  constexpr int CONS = tc_consumers(D);
  constexpr int BM = tc_bm(D);
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bar_q = base + L::BAR;
  const uint32_t bar_full = bar_q + 8;                    // + 8 * stage
  const uint32_t bar_empty = bar_full + 8 * TC_STAGES;    // + 8 * stage

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BM;   // heaviest first
  const int q_last = min(q0 + BM, lq) - 1;
  int k_end = lk;
  if (causal) k_end = min(k_end, q_last + 1);
  int k_begin = 0;
  if (window > 0) k_begin = max(0, q0 - window + 1);
  k_begin = (k_begin / BN) * BN;
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + BN - 1) / BN : 0;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < TC_STAGES; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, 4 * CONS);   // one arrive a warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == CONS) {
    // The producer: one thread starts every load of the CTA.
    if constexpr (CONS == 2)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 128 * CONS) {
      const int g = bh / kv_groups;
      mbar_expect_tx(bar_q, L::Q_BYTES);
      for (int h = 0; h < SUBS; ++h)
        tma_load_3d(base + L::Q + h * BM * 128, &tm_q, bar_q, h * 64, q0,
                    bh);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % TC_STAGES, n = t / TC_STAGES;
        if (n > 0) mbar_wait(bar_empty + 8 * s, (n - 1) & 1);
        mbar_expect_tx(bar_full + 8 * s, L::K_BYTES + L::V_BYTES);
        const int k0 = k_begin + t * BN;
        for (int h = 0; h < SUBS; ++h)
          tma_load_3d(base + L::K + s * L::K_BYTES + h * BN * 128, &tm_k,
                      bar_full + 8 * s, h * 64, k0, g);
        for (int h = 0; h < VSUBS; ++h)
          tma_load_3d(base + L::V + s * L::V_BYTES + h * BN * 128, &tm_v,
                      bar_full + 8 * s, h * 64, k0, g);
      }
    }
  } else {
    // A consumer warpgroup: query rows q0 + 64 wg .. + 63.  Thread
    // (warp w, lane) holds rows r and r + 8, r = 16 w + lane / 4, and in
    // every 8-column chunk c the columns 8 c + 2 (lane % 4) + {0, 1}
    // (the wgmma accumulator layout): element 4 c + e is row r + 8 (e / 2),
    // column 8 c + 2 (lane % 4) + e % 2.
    if constexpr (CONS == 2)
      asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
    const int row0 = q0 + 64 * wg + 16 * warp + lane / 4;
    const int col0 = 2 * (lane % 4);
    const uint32_t q_tile = base + L::Q + 64 * wg * 128;
    const float scale_log2 = scale * LOG2E;

    float o[VSUBS][32];
#pragma unroll
    for (int h = 0; h < VSUBS; ++h)
#pragma unroll
      for (int i = 0; i < 32; ++i) o[h][i] = 0.0f;
    float m[2] = {NEG, NEG}, l[2] = {0.0f, 0.0f};   // m in the log2 domain
    const int wg_first = q0 + 64 * wg, wg_last = wg_first + 63;

    mbar_wait(bar_q, 0);
    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % TC_STAGES, n = t / TC_STAGES;
      const int k0 = k_begin + t * BN;
      const uint32_t k_tile = base + L::K + s * L::K_BYTES;
      const uint32_t v_tile = base + L::V + s * L::V_BYTES;
      mbar_wait(bar_full + 8 * s, n & 1);

      // S = Q K^T over D in steps of 16.
      float sc[NS];
#pragma unroll
      for (int i = 0; i < NS; ++i) sc[i] = 0.0f;
      fence_regs<NS>(sc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk % 4) * 32;
        const uint64_t da = sw128_desc(q_tile + (kk / 4) * BM * 128 + off,
                                       0);
        const uint64_t db = sw128_desc(k_tile + (kk / 4) * BN * 128 + off, 0);
        wgmma_ss_n64(sc, da, db, 1);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs<NS>(sc);

      float alpha[2];
      const bool edge = k0 + BN > lk || (causal && k0 + BN - 1 > wg_first) ||
                        (window > 0 && wg_last - k0 >= window);
      if (edge)
        online_softmax<true, NS>(sc, m, l, alpha, scale_log2, row0, k0, col0,
                                 lq, lk, causal, window);
      else
        online_softmax<false, NS>(sc, m, l, alpha, scale_log2, row0, k0,
                                  col0, lq, lk, causal, window);
#pragma unroll
      for (int h = 0; h < VSUBS; ++h)
#pragma unroll
        for (int i = 0; i < 32; ++i) o[h][i] *= alpha[(i >> 1) & 1];

      // P as wgmma A fragments, split hi/lo: for keys 16 kk .. 16 kk + 15
      // the registers are (chunk 2 kk, rows r / r + 8), (chunk 2 kk + 1,
      // rows r / r + 8).
      uint32_t phi[BN / 16][4], plo[BN / 16][4];
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int i = 4 * (2 * kk + (j >> 1)) + 2 * (j & 1);
          split_bf16x2(sc[i], sc[i + 1], phi[kk][j], plo[kk][j]);
        }

      // O += P_hi V + P_lo V over the tile's keys in steps of 16.
#pragma unroll
      for (int h = 0; h < VSUBS; ++h) fence_regs<32>(o[h]);
      fence_regs<BN / 4>(&phi[0][0]);
      fence_regs<BN / 4>(&plo[0][0]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
        for (int h = 0; h < VSUBS; ++h) {
          const uint64_t dv = sw128_desc(
              v_tile + h * BN * 128 + kk * 16 * 128, 1024);
          wgmma_rs_n64_tb(o[h], phi[kk], dv);
          wgmma_rs_n64_tb(o[h], plo[kk], dv);
        }
      wgmma_commit();
      wgmma_wait_all();
#pragma unroll
      for (int h = 0; h < VSUBS; ++h) fence_regs<32>(o[h]);
      fence_regs<BN / 4>(&phi[0][0]);
      fence_regs<BN / 4>(&plo[0][0]);

      // This warp is done with the stage.
      __syncwarp();
      if (lane == 0) mbar_arrive(bar_empty + 8 * s);
    }

    const size_t bh_rows = static_cast<size_t>(bh) * lq;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qi = row0 + 8 * r;
      if (qi >= lq) continue;
      const float inv = 1.0f / fmaxf(l[r], 1e-20f);
      __nv_bfloat16* dst = out + (bh_rows + qi) * DV;
#pragma unroll
      for (int h = 0; h < VSUBS; ++h)
#pragma unroll
        for (int c = 0; c < 8; ++c)
          store_bf16x2(dst + 64 * h + 8 * c + col0,
                       o[h][4 * c + 2 * r] * inv,
                       o[h][4 * c + 2 * r + 1] * inv);
      if (lse != nullptr && lane % 4 == 0)
        lse[bh_rows + qi] = m[r] * LN2 + logf(fmaxf(l[r], 1e-20f));
    }
  }
}

// --- the tensor-core route: backward ------------------------------------------

constexpr int TCB_BQ = 64;          // queries a dK/dV step
constexpr int TCB_BN = 64;          // keys a dK/dV CTA owns, and a dQ step
constexpr int SMEM_OPTIN = 232448;  // shared memory a block may opt in to

// The depth of a backward kernel's ring: as many stages of ``stage``
// bytes as fit beside ``fixed`` bytes of resident tiles in an SM's share
// of ``ctas`` CTAs, 2 to 4.  The small head dims' steps are short, so
// more loads in flight cover their latency; at D 256 two stages are all
// that fit.
__host__ __device__ constexpr int tcb_stages(int fixed, int stage, int ctas) {
  const int n = (SMEM_OPTIN / ctas - 2048 - fixed) / stage;
  return n < 2 ? 2 : (n > 4 ? 4 : n);
}
// The backward's CTA shapes follow the registers a thread needs (the
// note's "Registers set the CTAs' shapes"): dK/dV is two warpgroups of up
// to 255 registers, one thread of the dK warpgroup loading; dQ is a
// producer warp beside one consumer warpgroup of 64 query rows (160
// threads, up to 255 registers), or two at D 128 (288 threads, which
// ptxas compiles at 168, enough for 64 fp32 of dQ beside S and dP).  At
// D 64 a thread of either needs under 128 registers, so two CTAs fit an
// SM and hide each other's short steps.
constexpr int TCB_KV_THREADS = 2 * 128;
__host__ __device__ constexpr int tcb_kv_ctas(int d) {
  return d == 64 ? 2 : 1;
}
__host__ __device__ constexpr int tcb_q_consumers(int d) {
  return d == 128 ? 2 : 1;
}
__host__ __device__ constexpr int tcb_q_ctas(int d) {
  return d == 64 ? 2 : 1;
}
__host__ __device__ constexpr int tcb_q_bm(int d) {  // queries a dQ CTA
  return 64 * tcb_q_consumers(d);
}
__host__ __device__ constexpr int tcb_q_threads(int d) {
  return 128 * tcb_q_consumers(d) + 32;
}

// Shared memory of the dK/dV kernel, in bytes from a 1024-aligned base:
// the CTA's K and V tiles, two buffers of P^T on its way from the dV
// warpgroup to the dK warpgroup (fp32, [32 elements][128 threads], so
// that each thread's element i is one conflict-free row; two, so that
// the dV warpgroup may run a step ahead), and the ring of Q and dO.
template <int D, int DV>
struct TcbKvSmem {
  static constexpr int Q_BYTES = TCB_BQ * D * 2;           // one Q tile
  static constexpr int DO_BYTES = TCB_BQ * DV * 2;         // one dO tile
  static constexpr int PT_BYTES = TCB_BN * TCB_BQ * 4;      // one P^T
  static constexpr int ST =
      tcb_stages(TCB_BN * (D + DV) * 2 + 2 * PT_BYTES, Q_BYTES + DO_BYTES,
                 tcb_kv_ctas(D));
  static constexpr int K = 0;
  static constexpr int V = K + TCB_BN * D * 2;
  static constexpr int PT = V + TCB_BN * DV * 2;            // P^T[2]
  static constexpr int Q = PT + 2 * PT_BYTES;               // Q[stage]
  static constexpr int DO = Q + ST * Q_BYTES;               // dO[stage]
  static constexpr int BAR = DO + ST * DO_BYTES;
  static constexpr int BYTES = BAR + 8 * (1 + 2 * ST) + 1024;
  static_assert(BYTES <= SMEM_OPTIN, "shared memory");
};

// Shared memory of the dQ kernel: the CTA's Q and dO tiles, and the ring
// of K and V tiles.
template <int D, int DV>
struct TcbQSmem {
  static constexpr int BM = tcb_q_bm(D);
  static constexpr int K_BYTES = TCB_BN * D * 2;
  static constexpr int V_BYTES = TCB_BN * DV * 2;
  static constexpr int ST = tcb_stages(BM * (D + DV) * 2, K_BYTES + V_BYTES,
                                       tcb_q_ctas(D));
  static constexpr int Q = 0;
  static constexpr int DO = Q + BM * D * 2;
  static constexpr int K = DO + BM * DV * 2;                // K[stage]
  static constexpr int V = K + ST * K_BYTES;                // V[stage]
  static constexpr int BAR = V + ST * V_BYTES;
  static constexpr int BYTES = BAR + 8 * (1 + 2 * ST) + 1024;
  static_assert(BYTES <= SMEM_OPTIN, "shared memory");
};

// acc (64 x 64 fp32, the wgmma accumulator of a warpgroup) as the A
// fragments of four k16 steps, split hi/lo: step kk's registers are
// (chunk 2 kk, rows r / r + 8), (chunk 2 kk + 1, rows r / r + 8).
__device__ __forceinline__ void acc_to_a(const float* acc, uint32_t (*hi)[4],
                                         uint32_t (*lo)[4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int i = 4 * (2 * kk + (j >> 1)) + 2 * (j & 1);
      split_bf16x2(acc[i], acc[i + 1], hi[kk][j], lo[kk][j]);
    }
}

// acc (64 x 64) += A (64 rows x KD, K-major) B^T (64 rows x KD, K-major),
// both 64-column swizzled sub-tiles in shared memory, ``a_rows`` and
// ``b_rows`` rows a sub-tile; issued, not waited on.
template <int KD>
__device__ __forceinline__ void wgmma_nt(float* acc, uint32_t a, int a_rows,
                                         uint32_t b, int b_rows) {
#pragma unroll
  for (int kk = 0; kk < KD / 16; ++kk) {
    const uint32_t off = (kk % 4) * 32;
    wgmma_ss_n64(acc, sw128_desc(a + (kk / 4) * a_rows * 128 + off, 0),
                 sw128_desc(b + (kk / 4) * b_rows * 128 + off, 0), 1);
  }
}

// acc[h] (64 x 64, h < N / 64) += (hi + lo) (64 x 64 from registers)
// B (64 rows x N, MN-major: the 64 rows are the contraction), B's
// sub-tiles ``b_rows`` rows each; issued, not waited on.
template <int N>
__device__ __forceinline__ void wgmma_split_nn(float (*acc)[32],
                                               uint32_t (*hi)[4],
                                               uint32_t (*lo)[4], uint32_t b,
                                               int b_rows) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int h = 0; h < N / 64; ++h) {
      const uint64_t db = sw128_desc(b + h * b_rows * 128 + kk * 16 * 128,
                                     1024);
      wgmma_rs_n64_tb(acc[h], hi[kk], db);
      wgmma_rs_n64_tb(acc[h], lo[kk], db);
    }
}

// Rows r, r + 8 of a warpgroup's accumulator acc[h] (h < N / 64) as bf16
// times ``mul`` into rows ``dst0`` and ``dst0 + 8 * ld`` of a row-major
// (.., ld) plane; ``rows_ok`` bit r says whether row r is stored.
template <int N>
__device__ __forceinline__ void store_acc(__nv_bfloat16* dst0, int ld,
                                          float (*acc)[32], float mul,
                                          int col0, unsigned rows_ok) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (!((rows_ok >> r) & 1u)) continue;
    __nv_bfloat16* dst = dst0 + static_cast<size_t>(8 * r) * ld;
#pragma unroll
    for (int h = 0; h < N / 64; ++h)
#pragma unroll
      for (int c = 0; c < 8; ++c)
        store_bf16x2(dst + 64 * h + 8 * c + col0,
                     acc[h][4 * c + 2 * r] * mul,
                     acc[h][4 * c + 2 * r + 1] * mul);
  }
}

template <int N>
__device__ __forceinline__ void zero_acc(float (*acc)[32]) {
#pragma unroll
  for (int h = 0; h < N / 64; ++h)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[h][i] = 0.0f;
}

template <int N>
__device__ __forceinline__ void fence_acc(float (*acc)[32]) {
#pragma unroll
  for (int h = 0; h < N / 64; ++h) fence_regs<32>(acc[h]);
}

// dK and dV: one CTA per (KV head g, 64-key tile), over the 64-query tiles
// of every query head of the group that can see the tile, in a fixed order.
// One thread of warpgroup 1 loads the CTA's K and V tiles once and the
// first steps' Q and dO into a ring (TMA, tcb_stages deep, full and empty
// mbarriers), and refills a stage as soon as both warpgroups have
// released it.  The two warpgroups own the same 64 keys and split the
// work by role, so that no product is computed twice:
//   warpgroup 0: S^T = K Q^T, P^T = exp(S^T scale - lse) masked, P^T to
//     shared memory for warpgroup 1, dV += P^T dO;
//   warpgroup 1: dP^T = V dO^T, dS^T = P^T (dP^T - delta), dK += dS^T Q.
// Each thread keeps one role's accumulator (64 x D or 64 x DV over the
// warpgroup) and reads its 16 queries' lse or delta from global memory
// while the step's first product runs.  Step t's P^T goes through buffer
// t % 2: named barrier 1 + t % 2 says that it is written, 3 + t % 2 that
// it is read.
template <int D, int DV>
__global__ void __launch_bounds__(TCB_KV_THREADS, tcb_kv_ctas(D))
attention_bwd_kv_tc_kernel(const __grid_constant__ CUtensorMap tm_q,
                           const __grid_constant__ CUtensorMap tm_k,
                           const __grid_constant__ CUtensorMap tm_v,
                           const __grid_constant__ CUtensorMap tm_do,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           __nv_bfloat16* __restrict__ dk,
                           __nv_bfloat16* __restrict__ dv, int lq, int lk,
                           int kv_groups, float scale, int causal,
                           int window) {
  using L = TcbKvSmem<D, DV>;
  constexpr int BQ = TCB_BQ, BN = TCB_BN, ST = L::ST;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  unsigned char* const smem = smem_raw + (base - smem_u32(smem_raw));
  const uint32_t bar_kv = base + L::BAR;
  const uint32_t bar_full = bar_kv + 8;                   // + 8 * stage
  const uint32_t bar_empty = bar_full + 8 * ST;           // + 8 * stage

  const int g = blockIdx.x;
  const int k0 = blockIdx.y * BN;       // causal: the heaviest tiles first
  // The query range that can see some key of this tile.
  const int k_last = min(k0 + BN, lk) - 1;
  const int q_begin = causal ? (k0 / BQ) * BQ : 0;
  const int q_end = window > 0 ? min(lq, k_last + window) : lq;
  const int n_qt = q_end > q_begin ? (q_end - q_begin + BQ - 1) / BQ : 0;
  const int items = kv_groups * n_qt;
  // step t: query head g * kv_groups + t / n_qt, queries q0(t) ..
  auto head_of = [&](int t) { return g * kv_groups + t / n_qt; };
  auto q0_of = [&](int t) { return q_begin + (t % n_qt) * BQ; };

  const int wg = threadIdx.x / 128;
  const bool loader = threadIdx.x == 128;
  auto load_step = [&](int t) {         // the loader's TMA for step t
    const int s = t % ST;
    const uint32_t full = bar_full + 8 * s;
    mbar_expect_tx(full, L::Q_BYTES + L::DO_BYTES);
    for (int h = 0; h < D / 64; ++h)
      tma_load_3d(base + L::Q + s * L::Q_BYTES + h * BQ * 128, &tm_q, full,
                  h * 64, q0_of(t), head_of(t));
    for (int h = 0; h < DV / 64; ++h)
      tma_load_3d(base + L::DO + s * L::DO_BYTES + h * BQ * 128, &tm_do,
                  full, h * 64, q0_of(t), head_of(t));
  };
  if (threadIdx.x == 0) {
    mbar_init(bar_kv, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, 8);     // one arrive a warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (loader) {
    mbar_expect_tx(bar_kv, BN * (D + DV) * 2);
    for (int h = 0; h < D / 64; ++h)
      tma_load_3d(base + L::K + h * BN * 128, &tm_k, bar_kv, h * 64, k0, g);
    for (int h = 0; h < DV / 64; ++h)
      tma_load_3d(base + L::V + h * BN * 128, &tm_v, bar_kv, h * 64, k0, g);
    for (int t = 0; t < min(ST, items); ++t) load_step(t);
  }
  __syncwarp();   // the loader's warp converges before its warpgroup's wgmma

  // A thread (warp w, lane) holds keys key0 and key0 + 8 and, in every
  // 8-column chunk c, the columns 8 c + col0 + {0, 1} (element 4 c + e:
  // key key0 + 8 (e / 2), column 8 c + col0 + e % 2).
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = threadIdx.x % 32;
  const int key0 = k0 + 16 * warp + lane / 4;
  const int col0 = 2 * (lane % 4);
  const float scale_log2 = scale * LOG2E;
  float* const pts = reinterpret_cast<float*>(smem + L::PT);
  const unsigned keys_ok = (key0 < lk ? 1u : 0u) | (key0 + 8 < lk ? 2u : 0u);
  const size_t kv_row = static_cast<size_t>(g) * lk + key0;
  // This thread's 16 query columns' row values (lse or delta) at step t:
  // element i of the accumulator reads rows[2 (i / 4) + i % 2].
  auto load_rows = [&](const float* src, int t, float* rows) {
    const size_t off = static_cast<size_t>(head_of(t)) * lq;
#pragma unroll
    for (int c = 0; c < 8; ++c)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int qi = q0_of(t) + 8 * c + col0 + e;
        rows[2 * c + e] = qi < lq ? src[off + qi] : 0.0f;
      }
  };
  mbar_wait(bar_kv, 0);

  if (wg == 0) {
    float acc[DV / 64][32];                 // dV
    zero_acc<DV>(acc);
    for (int t = 0; t < items; ++t) {
      const int s = t % ST, n = t / ST;
      const int q0 = q0_of(t);
      const uint32_t q_tile = base + L::Q + s * L::Q_BYTES;
      const uint32_t do_tile = base + L::DO + s * L::DO_BYTES;
      mbar_wait(bar_full + 8 * s, n & 1);

      float st[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) st[i] = 0.0f;
      fence_regs<32>(st);
      wgmma_fence();
      wgmma_nt<D>(st, base + L::K, BN, q_tile, BQ);
      wgmma_commit();
      float lse_r[16];
      load_rows(lse, t, lse_r);
      wgmma_wait_all();
      fence_regs<32>(st);

      // P^T, masked only on tiles that need it.
      const bool edge = k0 + BN > lk || q0 + BQ > lq ||
                        (causal && q0 < k0 + BN - 1) ||
                        (window > 0 && q0 + BQ - 1 - k0 >= window);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int il = 8 * (i / 4) + col0 + (i & 1);
        float p = exp2_ftz(st[i] * scale_log2 -
                           lse_r[2 * (i / 4) + (i & 1)] * LOG2E);
        if (edge && !visible(q0 + il, key0 + 8 * ((i >> 1) & 1), lq, lk,
                             causal, window))
          p = 0.0f;
        st[i] = p;
      }
      const int b = t & 1;
      float* const pt = pts + b * 32 * 128;
      if (t > 1) named_sync(3 + b, 256);  // warpgroup 1 read step t - 2's
#pragma unroll
      for (int i = 0; i < 32; ++i) pt[i * 128 + tid] = st[i];
      named_arrive(1 + b, 256);

      // dV += P^T dO over the step's queries.
      uint32_t hi[4][4], lo[4][4];
      acc_to_a(st, hi, lo);
      fence_acc<DV>(acc);
      fence_regs<16>(&hi[0][0]);
      fence_regs<16>(&lo[0][0]);
      wgmma_fence();
      wgmma_split_nn<DV>(acc, hi, lo, do_tile, BQ);
      wgmma_commit();
      wgmma_wait_all();
      fence_acc<DV>(acc);
      fence_regs<16>(&hi[0][0]);
      fence_regs<16>(&lo[0][0]);
      __syncwarp();
      if (lane == 0) mbar_arrive(bar_empty + 8 * s);
    }
    store_acc<DV>(dv + kv_row * DV, DV, acc, 1.0f, col0, keys_ok);
  } else {
    float acc[D / 64][32];                  // dK
    zero_acc<D>(acc);
    for (int t = 0; t < items; ++t) {
      const int s = t % ST, n = t / ST;
      const uint32_t q_tile = base + L::Q + s * L::Q_BYTES;
      const uint32_t do_tile = base + L::DO + s * L::DO_BYTES;
      mbar_wait(bar_full + 8 * s, n & 1);

      float dpt[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) dpt[i] = 0.0f;
      fence_regs<32>(dpt);
      wgmma_fence();
      wgmma_nt<DV>(dpt, base + L::V, BN, do_tile, BQ);
      wgmma_commit();
      float delta_r[16];
      load_rows(delta, t, delta_r);
      wgmma_wait_all();
      fence_regs<32>(dpt);

      // dS^T = P^T (dP^T - delta); P^T is 0 wherever a pair is masked.
      const int b = t & 1;
      const float* const pt = pts + b * 32 * 128;
      named_sync(1 + b, 256);
#pragma unroll
      for (int i = 0; i < 32; ++i)
        dpt[i] = pt[i * 128 + tid] *
                 (dpt[i] - delta_r[2 * (i / 4) + (i & 1)]);
      if (t + 2 < items) named_arrive(3 + b, 256);

      // dK += dS^T Q over the step's queries.
      uint32_t hi[4][4], lo[4][4];
      acc_to_a(dpt, hi, lo);
      fence_acc<D>(acc);
      fence_regs<16>(&hi[0][0]);
      fence_regs<16>(&lo[0][0]);
      wgmma_fence();
      wgmma_split_nn<D>(acc, hi, lo, q_tile, BQ);
      wgmma_commit();
      wgmma_wait_all();
      fence_acc<D>(acc);
      fence_regs<16>(&hi[0][0]);
      fence_regs<16>(&lo[0][0]);
      __syncwarp();
      if (lane == 0) mbar_arrive(bar_empty + 8 * s);
      // The stage is free once warpgroup 0 is done with it too (it
      // usually is: it runs ahead); then it takes step t + ST.
      if (loader && t + ST < items) {
        mbar_wait(bar_empty + 8 * s, n & 1);
        load_step(t + ST);
      }
      __syncwarp();
    }
    store_acc<D>(dk + kv_row * D, D, acc, scale, col0, keys_ok);
  }
}

// dQ: one CTA per (batch*head, tcb_q_bm(D)-query tile), the
// heaviest causal tiles first, over the 64-key tiles the forward visits.
// A producer warp loads the CTA's Q and dO once and streams K and V
// through a ring (tcb_stages); each consumer warpgroup owns 64 query rows:
// S = Q K^T and dP = dO V^T, dS = P (dP - delta), dQ += dS K.
template <int D, int DV>
__global__ void __launch_bounds__(tcb_q_threads(D), tcb_q_ctas(D))
attention_bwd_q_tc_kernel(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v,
                          const __grid_constant__ CUtensorMap tm_do,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          __nv_bfloat16* __restrict__ dq, int lq, int lk,
                          int kv_groups, float scale, int causal,
                          int window) {
  using L = TcbQSmem<D, DV>;
  constexpr int BN = TCB_BN, ST = L::ST;
  constexpr int CONS = tcb_q_consumers(D);
  constexpr int BM = L::BM;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bar_q = base + L::BAR;
  const uint32_t bar_full = bar_q + 8;                    // + 8 * stage
  const uint32_t bar_empty = bar_full + 8 * ST;           // + 8 * stage

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BM;   // heaviest first
  const int q_last = min(q0 + BM, lq) - 1;
  int k_end = lk;
  if (causal) k_end = min(k_end, q_last + 1);
  int k_begin = 0;
  if (window > 0) k_begin = max(0, q0 - window + 1);
  k_begin = (k_begin / BN) * BN;
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + BN - 1) / BN : 0;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, 4 * CONS);   // one arrive a warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == CONS) {
    // The producer warp: one thread starts every load of the CTA.
    if (threadIdx.x == 128 * CONS) {
      const int g = bh / kv_groups;
      mbar_expect_tx(bar_q, BM * (D + DV) * 2);
      for (int h = 0; h < D / 64; ++h)
        tma_load_3d(base + L::Q + h * BM * 128, &tm_q, bar_q, h * 64, q0,
                    bh);
      for (int h = 0; h < DV / 64; ++h)
        tma_load_3d(base + L::DO + h * BM * 128, &tm_do, bar_q, h * 64, q0,
                    bh);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % ST, n = t / ST;
        if (n > 0) mbar_wait(bar_empty + 8 * s, (n - 1) & 1);
        const int kt0 = k_begin + t * BN;
        const uint32_t full = bar_full + 8 * s;
        mbar_expect_tx(full, L::K_BYTES + L::V_BYTES);
        for (int h = 0; h < D / 64; ++h)
          tma_load_3d(base + L::K + s * L::K_BYTES + h * BN * 128, &tm_k,
                      full, h * 64, kt0, g);
        for (int h = 0; h < DV / 64; ++h)
          tma_load_3d(base + L::V + s * L::V_BYTES + h * BN * 128, &tm_v,
                      full, h * 64, kt0, g);
      }
    }
    return;
  }

  // A consumer warpgroup: query rows q0 + 64 wg .. + 63, in the
  // accumulator layout of the forward.
  const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  const int row0 = q0 + 64 * wg + 16 * warp + lane / 4;
  const int col0 = 2 * (lane % 4);
  const int wg_first = q0 + 64 * wg, wg_last = wg_first + 63;
  const uint32_t q_tile = base + L::Q + 64 * wg * 128;
  const uint32_t do_tile = base + L::DO + 64 * wg * 128;
  const float scale_log2 = scale * LOG2E;
  float row_lse2[2], row_delta[2];   // lse in the log2 domain
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = row0 + 8 * r;
    const size_t off = static_cast<size_t>(bh) * lq + qi;
    row_lse2[r] = qi < lq ? lse[off] * LOG2E : 0.0f;
    row_delta[r] = qi < lq ? delta[off] : 0.0f;
  }

  float acc[D / 64][32];                    // dQ
  zero_acc<D>(acc);
  mbar_wait(bar_q, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % ST, n = t / ST;
    const int kt0 = k_begin + t * BN;
    const uint32_t k_tile = base + L::K + s * L::K_BYTES;
    const uint32_t v_tile = base + L::V + s * L::V_BYTES;
    mbar_wait(bar_full + 8 * s, n & 1);

    float sc[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = dp[i] = 0.0f;
    fence_regs<32>(sc);
    fence_regs<32>(dp);
    wgmma_fence();
    wgmma_nt<D>(sc, q_tile, BM, k_tile, BN);
    wgmma_nt<DV>(dp, do_tile, BM, v_tile, BN);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs<32>(sc);
    fence_regs<32>(dp);

    const bool edge = kt0 + BN > lk || wg_first + 64 > lq ||
                      (causal && kt0 + BN - 1 > wg_first) ||
                      (window > 0 && wg_last - kt0 >= window);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = (i >> 1) & 1;
      float p = exp2_ftz(sc[i] * scale_log2 - row_lse2[r]);
      if (edge && !visible(row0 + 8 * r, kt0 + 8 * (i / 4) + col0 + (i & 1),
                           lq, lk, causal, window))
        p = 0.0f;
      dp[i] = p * (dp[i] - row_delta[r]);
    }

    // dQ += dS K over the tile's keys.
    uint32_t hi[4][4], lo[4][4];
    acc_to_a(dp, hi, lo);
    fence_acc<D>(acc);
    fence_regs<16>(&hi[0][0]);
    fence_regs<16>(&lo[0][0]);
    wgmma_fence();
    wgmma_split_nn<D>(acc, hi, lo, k_tile, BN);
    wgmma_commit();
    wgmma_wait_all();
    fence_acc<D>(acc);
    fence_regs<16>(&hi[0][0]);
    fence_regs<16>(&lo[0][0]);
    __syncwarp();
    if (lane == 0) mbar_arrive(bar_empty + 8 * s);
  }
  store_acc<D>(dq + (static_cast<size_t>(bh) * lq + row0) * D, D, acc,
               scale, col0,
               (row0 < lq ? 1u : 0u) | (row0 + 8 < lq ? 2u : 0u));
}

// --- launches ----------------------------------------------------------------

struct Problem {
  int bh, lq, lk, d, kv_groups;
  float scale;
  int causal, window;
};

// The output chunks of DP columns a wide head dim (d > DP) splits into,
// one grid z index each; 1 otherwise.
template <int DP, bool WIDE>
unsigned out_chunks(int d) {
  return WIDE ? static_cast<unsigned>((d + DP - 1) / DP) : 1u;
}

// The FMA kernels at head-dim bucket DP (d <= DP), or, WIDE, at DP 256
// for any d > 256.
template <typename T, int DP, bool WIDE>
int launch_forward(const void* q, const void* k, const void* v, void* out,
                   void* lse, const Problem& p, cudaStream_t stream) {
  constexpr int R = fma_rows<DP>();
  const size_t smem = smem_bytes<DP>();
  cudaError_t err = opt_in_smem<attention_kernel<T, DP, WIDE>>(smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((p.lq + R - 1) / R, p.bh, out_chunks<DP, WIDE>(p.d));
  attention_kernel<T, DP, WIDE><<<grid, R * LANES, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out),
      static_cast<float*>(lse), p.lq, p.lk, p.d, p.kv_groups, p.scale,
      p.causal, p.window);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
cudaError_t launch_delta(const void* out, const void* dout, void* delta,
                         int rows, int d, cudaStream_t stream) {
  const int warps_per_block = DELTA_THREADS / 32;
  delta_kernel<T><<<(rows + warps_per_block - 1) / warps_per_block,
                    DELTA_THREADS, 0, stream>>>(
      static_cast<const T*>(out), static_cast<const T*>(dout),
      static_cast<float*>(delta), rows, d);
  return cudaGetLastError();
}

template <typename T, int DP, bool WIDE>
int launch_backward(const void* q, const void* k, const void* v,
                    const void* out, const void* dout, const void* lse,
                    void* delta, void* dq, void* dk, void* dv,
                    const Problem& p, cudaStream_t stream) {
  constexpr int R = fma_rows<DP>();
  cudaError_t err =
      launch_delta<T>(out, dout, delta, p.bh * p.lq, p.d, stream);
  if (err != cudaSuccess) return static_cast<int>(err);

  const unsigned chunks = out_chunks<DP, WIDE>(p.d);
  const size_t kv_smem = bwd_kv_smem_bytes<DP>();
  err = opt_in_smem<attention_bwd_kv_kernel<T, DP, WIDE>>(kv_smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 kv_grid((p.lk + R - 1) / R, p.bh / p.kv_groups, chunks);
  attention_bwd_kv_kernel<T, DP, WIDE><<<kv_grid, R * LANES, kv_smem,
                                         stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dk), static_cast<T*>(dv), p.lq, p.lk, p.d,
      p.kv_groups, p.scale, p.causal, p.window);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const size_t q_smem = bwd_q_smem_bytes<DP>();
  err = opt_in_smem<attention_bwd_q_kernel<T, DP, WIDE>>(q_smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 q_grid((p.lq + R - 1) / R, p.bh, chunks);
  attention_bwd_q_kernel<T, DP, WIDE><<<q_grid, R * LANES, q_smem,
                                        stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dq), p.lq, p.lk, p.d, p.kv_groups, p.scale, p.causal,
      p.window);
  return static_cast<int>(cudaGetLastError());
}

// A 3-D map over a bf16 (planes, rows, d) tensor: boxes of 64 columns by
// ``box_rows`` rows of one plane, 128-byte swizzled, zeros outside.
bool encode_3d(CUtensorMap* map, const void* base, int planes, int rows,
               int d, int box_rows) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(d),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(planes)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(d) * 2,
                                 static_cast<cuuint64_t>(rows) * d * 2};
  const cuuint32_t box[3] = {64, static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The forward's three maps: Q boxes of a CTA's queries, K and V boxes of a
// tile (V at its own width dv).
bool encode_qkv(const void* q, const void* k, const void* v, const Problem& p,
                int d, int dv, CUtensorMap* tq, CUtensorMap* tk,
                CUtensorMap* tv) {
  const int bhkv = p.bh / p.kv_groups;
  return encode_3d(tq, q, p.bh, p.lq, d, tc_bm(d)) &&
         encode_3d(tk, k, bhkv, p.lk, d, TC_BN) &&
         encode_3d(tv, v, bhkv, p.lk, dv, TC_BN);
}

template <int D, int DV>
int launch_forward_tc(const void* q, const void* k, const void* v, void* out,
                      void* lse, const Problem& p, cudaStream_t stream) {
  cudaError_t err = bind_primary_context();
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap tq, tk, tv;
  if (!encode_qkv(q, k, v, p, D, DV, &tq, &tk, &tv))
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr size_t smem = TcFwdSmem<D, DV>::BYTES;
  err = opt_in_smem<attention_tc_kernel<D, DV>>(smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(p.bh, (p.lq + tc_bm(D) - 1) / tc_bm(D));
  attention_tc_kernel<D, DV><<<grid, tc_threads(D), smem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(out), static_cast<float*>(lse),
      p.lq, p.lk, p.kv_groups, p.scale, p.causal, p.window);
  return static_cast<int>(cudaGetLastError());
}

// delta, then dK/dV, then dQ.  Every bf16 operand is read through a TMA
// map: boxes of 64 rows, and of the dQ kernel's tcb_q_bm(D) rows for its Q
// and dO (one box a sub-tile, as the forward's Q, so that no box lies
// wholly past Lq).
template <int D, int DV>
int launch_backward_tc(const void* q, const void* k, const void* v,
                       const void* out, const void* dout, const void* lse,
                       void* delta, void* dq, void* dk, void* dv,
                       const Problem& p, cudaStream_t stream) {
  using bf16 = __nv_bfloat16;
  cudaError_t err = bind_primary_context();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int bhkv = p.bh / p.kv_groups;
  CUtensorMap tq, tk, tv, tdo, tq_bm, tdo_bm;
  if (!(encode_3d(&tq, q, p.bh, p.lq, D, TCB_BQ) &&
        encode_3d(&tk, k, bhkv, p.lk, D, TCB_BN) &&
        encode_3d(&tv, v, bhkv, p.lk, DV, TCB_BN) &&
        encode_3d(&tdo, dout, p.bh, p.lq, DV, TCB_BQ) &&
        encode_3d(&tq_bm, q, p.bh, p.lq, D, tcb_q_bm(D)) &&
        encode_3d(&tdo_bm, dout, p.bh, p.lq, DV, tcb_q_bm(D))))
    return static_cast<int>(cudaErrorInvalidValue);
  err = launch_delta<bf16>(out, dout, delta, p.bh * p.lq, DV, stream);
  if (err != cudaSuccess) return static_cast<int>(err);

  constexpr size_t kv_smem = TcbKvSmem<D, DV>::BYTES;
  err = opt_in_smem<attention_bwd_kv_tc_kernel<D, DV>>(kv_smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 kv_grid(bhkv, (p.lk + TCB_BN - 1) / TCB_BN);
  attention_bwd_kv_tc_kernel<D, DV><<<kv_grid, TCB_KV_THREADS, kv_smem,
                                      stream>>>(
      tq, tk, tv, tdo, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), p.lq, p.lk, p.kv_groups, p.scale, p.causal,
      p.window);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  constexpr size_t q_smem = TcbQSmem<D, DV>::BYTES;
  err = opt_in_smem<attention_bwd_q_tc_kernel<D, DV>>(q_smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 q_grid(p.bh, (p.lq + tcb_q_bm(D) - 1) / tcb_q_bm(D));
  attention_bwd_q_tc_kernel<D, DV><<<q_grid, tcb_q_threads(D), q_smem,
                                     stream>>>(
      tq_bm, tk, tv, tdo_bm, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dq), p.lq, p.lk,
      p.kv_groups, p.scale, p.causal, p.window);
  return static_cast<int>(cudaGetLastError());
}

struct Forward {
  const void *q, *k, *v;
  void *out, *lse;
  Problem p;
  cudaStream_t stream;
  template <typename T, int DP, bool WIDE = false>
  int fma() const {
    return launch_forward<T, DP, WIDE>(q, k, v, out, lse, p, stream);
  }
  template <int D, int DV>
  int tensor_core() const {
    return launch_forward_tc<D, DV>(q, k, v, out, lse, p, stream);
  }
};

struct Backward {
  const void *q, *k, *v, *out, *dout, *lse;
  void *delta, *dq, *dk, *dv;
  Problem p;
  cudaStream_t stream;
  template <typename T, int DP, bool WIDE = false>
  int fma() const {
    return launch_backward<T, DP, WIDE>(q, k, v, out, dout, lse, delta, dq,
                                        dk, dv, p, stream);
  }
  template <int D, int DV>
  int tensor_core() const {
    return launch_backward_tc<D, DV>(q, k, v, out, dout, lse, delta, dq, dk,
                                     dv, p, stream);
  }
};

constexpr int kRouteFma = 0;
constexpr int kRouteTensorCore = 1;

// The head dims of the tensor-core route (bf16 only); V's width there is
// one of them too, at most D.
bool tc_head_dim(int d) { return d == 64 || d == 128 || d == 192 || d == 256; }

// The FMA route's kernels for element type T at the smallest bucket DP >= d,
// and past 256 the wide kernels (chunks of 256 columns).
template <typename T, typename Fn>
int fma_bucket(int d, const Fn& fn) {
  if (d <= 8) return fn.template fma<T, 8>();
  if (d <= 16) return fn.template fma<T, 16>();
  if (d <= 32) return fn.template fma<T, 32>();
  if (d <= 64) return fn.template fma<T, 64>();
  if (d <= 128) return fn.template fma<T, 128>();
  if (d <= 192) return fn.template fma<T, 192>();
  if (d <= 256) return fn.template fma<T, 256>();
  return fn.template fma<T, 256, true>();
}

// The tensor-core kernels at head dim D for V's width dv (64 up to D).
template <int D, typename Fn>
int tc_value_width(int dv, const Fn& fn) {
  if (dv == 64) return fn.template tensor_core<D, 64>();
  if constexpr (D >= 128)
    if (dv == 128) return fn.template tensor_core<D, 128>();
  if constexpr (D >= 192)
    if (dv == 192) return fn.template tensor_core<D, 192>();
  if constexpr (D >= 256)
    if (dv == 256) return fn.template tensor_core<D, 256>();
  return static_cast<int>(cudaErrorInvalidValue);
}

// Calls the route's kernels for the runtime dtype code, head dim d and V
// width dv: the tensor-core route takes bf16 at d 64, 128, 192 and 256 and
// dv one of those up to d; the FMA route float32 and float16 at every d
// from 1 up and bf16 at every other d, with dv == d.
// cudaErrorInvalidValue for anything else, so a route never takes a case
// that is the other's.
template <typename Fn>
int dispatch(int route, int dtype, int d, int dv, const Fn& fn) {
  const int invalid = static_cast<int>(cudaErrorInvalidValue);
  if (route == kRouteTensorCore) {
    if (dtype != 1) return invalid;
    switch (d) {
      case 64: return tc_value_width<64>(dv, fn);
      case 128: return tc_value_width<128>(dv, fn);
      case 192: return tc_value_width<192>(dv, fn);
      case 256: return tc_value_width<256>(dv, fn);
      default: return invalid;
    }
  }
  if (route != kRouteFma || d < 1 || dv != d) return invalid;
  switch (dtype) {
    case 0: return fma_bucket<float>(d, fn);
    case 1:
      return tc_head_dim(d) ? invalid : fma_bucket<__nv_bfloat16>(d, fn);
    case 2: return fma_bucket<__half>(d, fn);
    default: return invalid;
  }
}

bool valid_problem(const Problem& p) {
  return p.kv_groups >= 1 && p.bh % p.kv_groups == 0 && p.bh <= 65535 &&
         p.lk >= 1 && p.lq >= 0 && p.window >= 0;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16, 2 = float16 (q, k, v and out alike);
// d from 1 up, dv V's (and out's) width; route: 0 = FMA, 1 = tensor
// cores, as ``dispatch`` takes them.  lse, (bh, lq) float32, may be null:
// it is then not written.  Returns cudaErrorInvalidValue for anything
// else.
int local_attention_forward(const void* q, const void* k, const void* v,
                            void* out, void* lse, int dtype, int bh, int lq,
                            int lk, int d, int dv, int kv_groups,
                            float scale, int causal, int window, int route,
                            void* stream) {
  if (bh == 0 || lq == 0) return 0;
  const Problem p{bh, lq, lk, d, kv_groups, scale, causal, window};
  if (!valid_problem(p)) return static_cast<int>(cudaErrorInvalidValue);
  return dispatch(route, dtype, d, dv,
                  Forward{q, k, v, out, lse, p,
                          static_cast<cudaStream_t>(stream)});
}

// The gradients dq (bh, lq, d), dk (bh / kv_groups, lk, d) and dv
// (bh / kv_groups, lk, dv) of the forward above, from its inputs, its
// output, its lse and dout (the output's gradient, (bh, lq, dv)), all in
// the forward's dtype but lse.  delta is (bh, lq) float32 scratch.
int local_attention_backward(const void* q, const void* k, const void* v,
                             const void* out, const void* dout,
                             const void* lse, void* delta, void* dq,
                             void* dk, void* dv, int dtype, int bh, int lq,
                             int lk, int d, int dv_width, int kv_groups,
                             float scale, int causal, int window, int route,
                             void* stream) {
  if (bh == 0) return 0;
  const Problem p{bh, lq, lk, d, kv_groups, scale, causal, window};
  if (!valid_problem(p)) return static_cast<int>(cudaErrorInvalidValue);
  return dispatch(route, dtype, d, dv_width,
                  Backward{q, k, v, out, dout, lse, delta, dq, dk, dv, p,
                           static_cast<cudaStream_t>(stream)});
}

// Encodes the tensor-core forward's three TMA descriptors ``reps`` times
// (what each forward call pays on the host for them); launches nothing.
int local_attention_encode_descriptors(const void* q, const void* k,
                                       const void* v, int bh, int lq, int lk,
                                       int d, int kv_groups, int reps) {
  const Problem p{bh, lq, lk, d, kv_groups, 1.0f, 1, 0};
  if (!valid_problem(p) || !tc_head_dim(d))
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tq, tk, tv;
  for (int i = 0; i < reps; ++i)
    if (!encode_qkv(q, k, v, p, d, d, &tq, &tk, &tv))
      return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

const char* local_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
