// Fused 4f-optics DFT pipeline for Hopper (sm_90a): the two batched stages
// of the unitary 2-D DFT as complex GEMMs, with the DAC fused into stage 1's
// operand path and the square-law detector fused into stage 2's store.
//
//   stage 1:  T[b] = W @ dac(A[b])            W (m, k) complex as (wr, wi),
//                                             A (batch, k, n) real
//   stage 2:  I[b] = |T[b] @ W^T|^2           T (batch, m, k) complex,
//                                             W (n, k) complex, I (batch, m, n)
//
// Replaces the Pallas TPU kernels of the JAX reference,
// src/repro/kernels/optical_dft.py: _stage1_batched_kernel (pallas_call in
// dft_stage1_batched) and _stage2_batched_kernel (pallas_call in
// dft_stage2_batched).  The single-frame kernels there (_stage1_kernel,
// _stage2_kernel) are these kernels at batch 1.
//
// What bounds them on an H100: a 512x512 frame is 0.54 GFLOP in stage 1 and
// 1.07 GFLOP in stage 2 against 3-5 MB of traffic, so both are bound by
// operations.  The parity bounds of the reference (stage 1 rtol 1e-4 /
// atol 1e-5, pipeline rtol 2e-4 / atol 2e-4*max) rule out plain TF32 or
// bf16 products.  Two routes, chosen by the caller from the shapes, the
// operands' alignment and the DAC's bits alone, never by a failure:
//
// * The tensor-core route (k and n multiples of 4, every operand 16-byte
//   aligned, fewer than 24 DAC bits: every 512x512 launch of the offload
//   and serving paths) runs 3xTF32 on wgmma: each fp32 operand x is split
//   into hi = rna_tf32(x) and lo = rna_tf32(x - hi), and lo*hi' + hi*lo' +
//   hi*hi' go into one fp32 accumulator (lo*lo' is dropped): fp32-level
//   error at a third of the TF32 rate, 165 TFLOP/s of fp32-accurate work
//   against 67 for FMA.  The DAC's output is what is split, so the DAC
//   keeps rintf and a true quotient by `levels` (dac_fast: exactly the
//   IEEE quotient below 2^23 levels) and its ties are the FMA route's.  No
//   Gauss trick: each complex product is its real products, as the bounds
//   were set on.
//
//   wgmma takes tf32 shared-memory operands K-major only, and stage 1's A
//   (k, n) is MN-major.  So in both stages the operand that goes through
//   registers is the one that needs work there: stage 1 computes the tile
//   transposed, T^T = dac(A)^T W^T, with dac(A)^T as the register A
//   operand (each element is loaded, quantized and split by the one thread
//   that uses it) and W (m, k) as the K-major shared B operand; stage 2
//   computes T W^T with T as the register operand and W (n, k) as the
//   shared one.  W is the shared operand in both, and its split is the
//   same elementwise pass in both, so it keeps TMA's swizzled positions.
//   The transpose of stage 1 costs nothing: the epilogue goes through
//   shared memory for the cluster reduction anyway.  (Stage 1 the other
//   way round, W in registers and dac(A) split and transposed into shared
//   memory by the split warps, measured slower on the card: the split
//   warps' quantization then bounds every k step.)
//
//   One CTA of three warpgroups owns a 128 x 64 output tile (128 rows of
//   the register operand: two consumer warpgroups of 64; 64 rows of W) of
//   one frame and a slice of the contraction.  Warp 8 issues TMA loads of
//   32-deep k steps (one 128-byte swizzle row of fp32) into a three-stage
//   ring: the register operand's tile and W's (wr, wi) tile, raw, zeros
//   outside the tensors.  Warps 9-11 split each raw W tile into a ring of
//   (hi, lo) tiles at the same swizzled offsets (three stages in stage 1,
//   whose consumers are the quicker, two in stage 2, which has no room for
//   a third).  The consumers load, (quantize,) and split their fragments
//   in registers and issue m64n64k8 wgmmas, 3 real products x 2 (stage 1)
//   or 4 (stage 2) per 8-deep slice, one slice's group in flight while the
//   next slice's fragments are made.  Every mbarrier wait traps after 4 s,
//   so a fault is a launch error and not a hung card.
//
//   At batch 1 a 512x512 frame is only 32 tiles, so the contraction is
//   split across a thread-block cluster of `split` CTAs (1, 2 or 4, chosen
//   by the caller from (m, k, n) alone), each over a disjoint range of k
//   steps.  After the loop each CTA writes its partial sums to its own
//   shared memory; after a cluster barrier CTA r reduces rows r/split of
//   the tile, reading the partials of CTAs 0, 1, ... in that order through
//   distributed shared memory, and writes them coalesced (stage 1: T;
//   stage 2: the detector's |U|^2, which needs the whole sum before the
//   square, hence the reduction inside the cluster rather than atomics or
//   a second pass).  A last cluster barrier keeps every CTA's shared
//   memory alive until its peers have read it.  Nothing depends on the
//   batch, so a frame's bits are the same alone, in any batch, and on a
//   repeat; there are no atomics.
//
// * The FMA route (any other shape or alignment): fp32 FMA on the CUDA
//   cores.  One block computes a BM x BN output tile of one frame (grid =
//   output tiles x batch); the contraction runs as a loop inside the block
//   over BK-deep stages staged through shared memory, which takes the
//   place of the TPU's sequential K grid axis and its VMEM accumulator
//   scratch.  Each of the 256 threads holds a 4 x 4 sub-tile of both the
//   real and the imaginary accumulator in registers, strided by 16 so that
//   shared-memory reads are conflict-free and global stores coalesce.
//   Operand tiles whose contraction axis is contiguous in memory (W, T)
//   are stored transposed with one word of padding.
//
// On both routes the DAC rounds half to even (rintf) and divides by
// `levels` with a true divide, exactly as torch.round / jnp.round and the
// reference's `/ levels` do, so ties such as 0.5 * 255 = 127.5 quantize
// identically.  Ragged edges are masked: loads outside the matrix read 0,
// stores outside it are skipped.  Tile sizes are compile-time; the
// caller's Pallas-style block plan is validated by the Python wrapper and
// not used here.
//
// C ABI: every entry point launches on the given stream, allocates
// nothing, does not synchronise, and returns cudaGetLastError().  It
// launches on the calling thread's current device, which the Python
// wrapper selects; it never changes it.

#include <initializer_list>

#include <stddef.h>

#include "hopper.cuh"

namespace {

// --- the FMA route --------------------------------------------------------------

constexpr int BM = 64;                 // output rows per block
constexpr int BN = 64;                 // output columns per block
constexpr int BK = 16;                 // contraction depth per stage
constexpr int TX = 16;                 // threads along the columns
constexpr int TY = 16;                 // threads along the rows
constexpr int RM = BM / TY;            // rows per thread
constexpr int RN = BN / TX;            // columns per thread
constexpr int THREADS = TX * TY;
constexpr int PAD = 1;                 // breaks transposed-store conflicts

__device__ __forceinline__ float dac(float a, int levels) {
  if (levels > 0) {
    const float l = static_cast<float>(levels);
    a = rintf(unit_clip(a) * l) / l;
  }
  return a;
}

// Load a BR x BK tile of a row-major (rows, k) matrix starting at
// (row0, k0) into s[BK][BR + PAD], transposed; out-of-range reads are 0.
template <int BR>
__device__ __forceinline__ void load_rows_transposed(
    float (*s)[BR + PAD], const float* __restrict__ g, int rows, int k,
    int row0, int k0) {
  for (int e = threadIdx.x; e < BR * BK; e += THREADS) {
    const int r = e / BK, c = e % BK;
    const int gr = row0 + r, gc = k0 + c;
    s[c][r] = (gr < rows && gc < k) ? g[static_cast<size_t>(gr) * k + gc]
                                    : 0.0f;
  }
}

__global__ void __launch_bounds__(THREADS)
stage1_batched_kernel(const float* __restrict__ wr,
                      const float* __restrict__ wi,
                      const float* __restrict__ a, float* __restrict__ tr,
                      float* __restrict__ ti, int m, int k, int n,
                      int levels) {
  __shared__ float s_wr[BK][BM + PAD];
  __shared__ float s_wi[BK][BM + PAD];
  __shared__ float s_a[BK][BN];
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;
  const size_t frame = blockIdx.z;
  const int tx = threadIdx.x % TX;
  const int ty = threadIdx.x / TX;
  const float* __restrict__ af = a + frame * k * n;

  float acc_r[RM][RN] = {};
  float acc_i[RM][RN] = {};
  for (int k0 = 0; k0 < k; k0 += BK) {
    load_rows_transposed<BM>(s_wr, wr, m, k, row0, k0);
    load_rows_transposed<BM>(s_wi, wi, m, k, row0, k0);
    for (int e = threadIdx.x; e < BK * BN; e += THREADS) {
      const int r = e / BN, c = e % BN;
      const int gr = k0 + r, gc = col0 + c;
      // the DAC is fused into the operand load
      s_a[r][c] = (gr < k && gc < n)
                      ? dac(af[static_cast<size_t>(gr) * n + gc], levels)
                      : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float fr[RM], fi[RM], fa[RN];
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        fr[i] = s_wr[kk][ty + i * TY];
        fi[i] = s_wi[kk][ty + i * TY];
      }
#pragma unroll
      for (int j = 0; j < RN; ++j) fa[j] = s_a[kk][tx + j * TX];
#pragma unroll
      for (int i = 0; i < RM; ++i) {
#pragma unroll
        for (int j = 0; j < RN; ++j) {
          acc_r[i][j] = fmaf(fr[i], fa[j], acc_r[i][j]);
          acc_i[i][j] = fmaf(fi[i], fa[j], acc_i[i][j]);
        }
      }
    }
    __syncthreads();
  }
  float* __restrict__ trf = tr + frame * m * n;
  float* __restrict__ tif = ti + frame * m * n;
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int gr = row0 + ty + i * TY;
    if (gr >= m) continue;
#pragma unroll
    for (int j = 0; j < RN; ++j) {
      const int gc = col0 + tx + j * TX;
      if (gc < n) {
        const size_t off = static_cast<size_t>(gr) * n + gc;
        trf[off] = acc_r[i][j];
        tif[off] = acc_i[i][j];
      }
    }
  }
}

__global__ void __launch_bounds__(THREADS)
stage2_batched_kernel(const float* __restrict__ tr,
                      const float* __restrict__ ti,
                      const float* __restrict__ wr,
                      const float* __restrict__ wi, float* __restrict__ out,
                      int m, int k, int n) {
  __shared__ float s_tr[BK][BM + PAD];
  __shared__ float s_ti[BK][BM + PAD];
  __shared__ float s_wr[BK][BN + PAD];
  __shared__ float s_wi[BK][BN + PAD];
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;
  const size_t frame = blockIdx.z;
  const int tx = threadIdx.x % TX;
  const int ty = threadIdx.x / TX;
  const float* __restrict__ trf = tr + frame * m * k;
  const float* __restrict__ tif = ti + frame * m * k;

  float acc_r[RM][RN] = {};
  float acc_i[RM][RN] = {};
  for (int k0 = 0; k0 < k; k0 += BK) {
    load_rows_transposed<BM>(s_tr, trf, m, k, row0, k0);
    load_rows_transposed<BM>(s_ti, tif, m, k, row0, k0);
    // W's rows are contracted: output column j reads W[j, :]
    load_rows_transposed<BN>(s_wr, wr, n, k, col0, k0);
    load_rows_transposed<BN>(s_wi, wi, n, k, col0, k0);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float xr[RM], xi[RM], yr[RN], yi[RN];
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        xr[i] = s_tr[kk][ty + i * TY];
        xi[i] = s_ti[kk][ty + i * TY];
      }
#pragma unroll
      for (int j = 0; j < RN; ++j) {
        yr[j] = s_wr[kk][tx + j * TX];
        yi[j] = s_wi[kk][tx + j * TX];
      }
#pragma unroll
      for (int i = 0; i < RM; ++i) {
#pragma unroll
        for (int j = 0; j < RN; ++j) {
          acc_r[i][j] = fmaf(xr[i], yr[j], acc_r[i][j]);
          acc_r[i][j] = fmaf(-xi[i], yi[j], acc_r[i][j]);
          acc_i[i][j] = fmaf(xr[i], yi[j], acc_i[i][j]);
          acc_i[i][j] = fmaf(xi[i], yr[j], acc_i[i][j]);
        }
      }
    }
    __syncthreads();
  }
  // the square-law detector is fused into the store: only I leaves
  float* __restrict__ of = out + frame * m * n;
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int gr = row0 + ty + i * TY;
    if (gr >= m) continue;
#pragma unroll
    for (int j = 0; j < RN; ++j) {
      const int gc = col0 + tx + j * TX;
      if (gc < n) {
        of[static_cast<size_t>(gr) * n + gc] =
            acc_r[i][j] * acc_r[i][j] + acc_i[i][j] * acc_i[i][j];
      }
    }
  }
}


// --- the tensor-core route: PTX helpers -----------------------------------------

// One box of a 2-D tensor map, as tma_load_3d.
__device__ __forceinline__ void tma_load_2d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar),
         "r"(c0), "r"(c1)
      : "memory");
}

// Orders this thread's generic-proxy shared-memory accesses with the async
// proxy's (TMA writes, wgmma reads) that a barrier lets follow them.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ float ld_shared(uint32_t addr) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(v) : "r"(addr) : "memory");
  return v;
}

__device__ __forceinline__ float4 ld_shared_v4(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w) : "r"(addr)
               : "memory");
  return v;
}

__device__ __forceinline__ void st_shared(uint32_t addr, float v) {
  asm volatile("st.shared.f32 [%0], %1;\n" :: "r"(addr), "f"(v) : "memory");
}

__device__ __forceinline__ void st_shared_v2(uint32_t addr, float x,
                                             float y) {
  asm volatile("st.shared.v2.f32 [%0], {%1, %2};\n"
               :: "r"(addr), "f"(x), "f"(y) : "memory");
}

__device__ __forceinline__ void st_shared_v4u(uint32_t addr, uint32_t x,
                                              uint32_t y, uint32_t z,
                                              uint32_t w) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n"
               :: "r"(addr), "r"(x), "r"(y), "r"(z), "r"(w) : "memory");
}

// The cluster: this CTA's rank, a peer's address for one of ours, a 16-byte
// load from any CTA of the cluster, and the barrier of all its threads.
__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ uint32_t cluster_addr(uint32_t addr,
                                                 uint32_t rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}

__device__ __forceinline__ float4 ld_cluster_v4(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w) : "r"(addr)
               : "memory");
  return v;
}

__device__ __forceinline__ void cluster_sync() {
  __syncwarp();
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// x rounded to TF32 (10 mantissa bits), to nearest with ties away from
// zero; the low 13 bits of the result are 0.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// The 3xTF32 split: hi + lo carries about 22 bits of x.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

__device__ __forceinline__ void wgmma_wait_one() {   // all but the last
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
}

// D (64 x 64, fp32) += SCALE_A * A (64 x 8 tf32, registers) * B (8 x 64
// tf32, shared, K-major).  SCALE_A is +1 or -1 (an exact negation).
template <int SCALE_A>
__device__ __forceinline__ void wgmma_tf32(float* d, const uint32_t* a,
                                           uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, %38, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1),
        "n"(SCALE_A));
}

// acc += a * b in 3xTF32 (the small terms first), b's hi and lo tiles at
// the given descriptors.
template <int SCALE_A>
__device__ __forceinline__ void mma_3xtf32(float* acc, const uint32_t* a_hi,
                                           const uint32_t* a_lo,
                                           uint64_t b_hi, uint64_t b_lo) {
  wgmma_tf32<SCALE_A>(acc, a_lo, b_hi);
  wgmma_tf32<SCALE_A>(acc, a_hi, b_lo);
  wgmma_tf32<SCALE_A>(acc, a_hi, b_hi);
}

// The DAC of the tensor-core route for l = levels < 2^23: rint(clip(a) *
// l) / l as dac() has it, the quotient of the code c by l taken as
// d = c * inv (inv = 1 / l) corrected once, fma(fma(-d, l, c), inv, d),
// which is the IEEE quotient for every code 0 .. l at these l
// (tests/test_torch_kernels.py checks each one).  The IEEE divide is a
// subroutine with a branch that kept the consumers' quantization from
// overlapping the products; l >= 2^23 (dac_bits >= 24) takes the FMA
// route, which keeps it.
__device__ __forceinline__ float dac_fast(float a, float l, float inv) {
  const float c = rintf(__fmul_rn(unit_clip(a), l));
  const float d = __fmul_rn(c, inv);
  return fmaf(fmaf(-d, l, c), inv, d);
}

// --- the tensor-core route: the kernel ------------------------------------------

constexpr int TC_BM = 128;          // register-operand rows: 2 warpgroups of 64
constexpr int TC_BN = 64;           // W rows per tile
constexpr int TC_BK = 32;           // k per step: one 128-byte swizzle row
constexpr int TC_STAGES = 3;        // raw TMA ring
constexpr int TC_THREADS = 384;     // consumers: warps 0-7, TMA: 8, split: 9-11
constexpr int TC_CONSUMER_WARPS = 8;
constexpr int TC_TMA_WARP = 8;
constexpr int TC_SPLIT_WARPS = 3;

// Shared memory of the tensor-core kernels, in bytes from a 1024-aligned
// base.  A raw stage holds the register operand's tile (stage 1: A as four
// [32 k][32 n] boxes; stage 2: tr and ti, each [128 m][32 k]) and W's
// (wr, wi), each [64][32 k]; all 128-byte swizzled as TMA wrote them.  A
// split stage holds wr_hi, wr_lo, wi_hi, wi_lo at W's swizzled offsets.
// After the loop the ring holds this CTA's partial sums for the cluster
// reduction: [plane][row][col] with rows the output's rows (m) and a
// padded row stride against bank conflicts.
template <int STAGE>
struct TcLayout {
  // split W stages: stage 1 has the room for three
  static constexpr int HL_STAGES = STAGE == 1 ? 3 : 2;
  static constexpr int A_BYTES = (STAGE == 1 ? 1 : 2) * TC_BM * TC_BK * 4;
  static constexpr int W_PLANE = TC_BN * TC_BK * 4;
  static constexpr int RAW_BYTES = A_BYTES + 2 * W_PLANE;
  static constexpr int HL_BYTES = 4 * W_PLANE;
  static constexpr int RAW = 0;
  static constexpr int HL = RAW + TC_STAGES * RAW_BYTES;
  static constexpr int BAR = HL + HL_STAGES * HL_BYTES;
  static constexpr int BYTES = BAR + 16 * (TC_STAGES + HL_STAGES) + 1024;
  static constexpr int P_ROWS = STAGE == 1 ? TC_BN : TC_BM;
  static constexpr int P_COLS = STAGE == 1 ? TC_BM : TC_BN;
  static constexpr int P_STRIDE = P_COLS + (STAGE == 1 ? 4 : 8);
  static constexpr int P_PLANE = P_ROWS * P_STRIDE * 4;
  static_assert(2 * P_PLANE <= BAR, "the partial sums fit in the ring");
  static_assert(BYTES <= 232448, "one CTA's shared memory");
};

// Element (row, col) of a [rows][32] fp32 tile, 128-byte swizzled: the
// 16-byte chunk of a 128-byte row is XORed with the row's index mod 8.
__device__ __forceinline__ uint32_t sw128(uint32_t tile, int row, int col) {
  return tile + row * 128 + ((((col >> 2) ^ row) & 7) << 4) + (col & 3) * 4;
}

// The register-operand fragment of one 8-deep slice kk of a k step: the
// four elements of wgmma's tf32 A layout, (r, c), (r + 8, c), (r, c + 4),
// (r + 8, c + 4) with r = row0 (16 warp + lane / 4 of this warpgroup's
// rows) and c = 8 kk + lane % 4, split hi / lo, for each plane p:
//   stage 1: dac(A)^T from the A boxes ([32 k][32 n] each, n = row), the
//            DAC's quotient by dac_fast;
//   stage 2: T (p = re, im) from [128 m][32 k] each.
template <int STAGE, bool DAC>
__device__ __forceinline__ void load_fragment_as(uint32_t raw, int row0,
                                                 int lane, int kk, float l,
                                                 float inv,
                                                 uint32_t (*hi)[4],
                                                 uint32_t (*lo)[4]) {
#pragma unroll
  for (int p = 0; p < (STAGE == 1 ? 1 : 2); ++p)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int row = row0 + 8 * (j & 1);
      const int col = 8 * kk + lane % 4 + 4 * (j >> 1);
      float x;
      if constexpr (STAGE == 1) {
        x = ld_shared(sw128(raw + (row >> 5) * 4096, col, row & 31));
        if constexpr (DAC) x = dac_fast(x, l, inv);
      } else {
        x = ld_shared(sw128(raw + p * TC_BM * 128, row, col));
      }
      split_tf32(x, hi[p][j], lo[p][j]);
    }
}

// The DAC's on/off test once per fragment, not once per element: with
// the NaN-keeping clip, ptxas no longer predicates the per-element test,
// and a branch per element in this loop slows stage 1.
template <int STAGE>
__device__ __forceinline__ void load_fragment(uint32_t raw, int row0,
                                              int lane, int kk, int levels,
                                              float l, float inv,
                                              uint32_t (*hi)[4],
                                              uint32_t (*lo)[4]) {
  if (STAGE == 1 && levels > 0)
    load_fragment_as<STAGE, true>(raw, row0, lane, kk, l, inv, hi, lo);
  else
    load_fragment_as<STAGE, false>(raw, row0, lane, kk, l, inv, hi, lo);
}

// One CTA: a 128 x 64 tile (register-operand rows x W rows) of frame
// blockIdx.z over k steps [rank * per, ...) of its cluster's split.
//   stage 1: out0/out1 = tr/ti (m, n); maps: a0 = A, wr, wi.
//   stage 2: out0 = I (m, n); maps: a0 = tr, a1 = ti, wr, wi.
template <int STAGE>
__device__ __forceinline__ void tc_tile(
    const CUtensorMap* tm_a0, const CUtensorMap* tm_a1,
    const CUtensorMap* tm_wr, const CUtensorMap* tm_wi,
    float* __restrict__ out0, float* __restrict__ out1, int m, int k, int n,
    int levels, int split) {
  using L = TcLayout<STAGE>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t raw_full = base + L::BAR;                 // + 8 * stage
  const uint32_t raw_empty = raw_full + 8 * TC_STAGES;
  const uint32_t hl_full = raw_empty + 8 * TC_STAGES;
  const uint32_t hl_empty = hl_full + 8 * L::HL_STAGES;

  const int rank = static_cast<int>(cluster_rank());
  const int a0 = blockIdx.y * TC_BM;                 // register-operand rows
  const int b0 = (blockIdx.x / split) * TC_BN;       // W rows
  const int frame = blockIdx.z;
  const int steps = (k + TC_BK - 1) / TC_BK;
  const int per = (steps + split - 1) / split;
  const int step0 = min(steps, rank * per);
  const int nsteps = min(steps, step0 + per) - step0;

  if (threadIdx.x == 0) {
    for (int s = 0; s < TC_STAGES; ++s) {
      mbar_init(raw_full + 8 * s, 1);
      mbar_init(raw_empty + 8 * s, TC_SPLIT_WARPS + TC_CONSUMER_WARPS);
    }
    for (int s = 0; s < L::HL_STAGES; ++s) {
      mbar_init(hl_full + 8 * s, TC_SPLIT_WARPS);
      mbar_init(hl_empty + 8 * s, TC_CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float acc[2][32];
#pragma unroll
  for (int p = 0; p < 2; ++p)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[p][i] = 0.0f;

  if (warp == TC_TMA_WARP) {
    if (lane == 0) {
      for (int t = 0; t < nsteps; ++t) {
        const int s = t % TC_STAGES, u = t / TC_STAGES;
        if (u > 0) mbar_wait(raw_empty + 8 * s, (u - 1) & 1);
        const uint32_t bar = raw_full + 8 * s;
        const uint32_t dst = base + L::RAW + s * L::RAW_BYTES;
        const int k0 = (step0 + t) * TC_BK;
        mbar_expect_tx(bar, L::RAW_BYTES);
        if constexpr (STAGE == 1) {
          for (int j = 0; j < TC_BM / 32; ++j)
            tma_load_3d(dst + j * 4096, tm_a0, bar, a0 + 32 * j, k0, frame);
        } else {
          tma_load_3d(dst, tm_a0, bar, k0, a0, frame);
          tma_load_3d(dst + TC_BM * 128, tm_a1, bar, k0, a0, frame);
        }
        tma_load_2d(dst + L::A_BYTES, tm_wr, bar, k0, b0);
        tma_load_2d(dst + L::A_BYTES + L::W_PLANE, tm_wi, bar, k0, b0);
      }
    }
  } else if (warp > TC_TMA_WARP) {
    // Split warps: raw (wr, wi) -> (wr_hi, wr_lo, wi_hi, wi_lo), same
    // offsets inside each [64][32] tile, so the swizzle carries over.
    const int st = threadIdx.x - (TC_TMA_WARP + 1) * 32;
    for (int t = 0; t < nsteps; ++t) {
      const int s = t % TC_STAGES, h = t % L::HL_STAGES;
      mbar_wait(raw_full + 8 * s, (t / TC_STAGES) & 1);
      if (t >= L::HL_STAGES)
        mbar_wait(hl_empty + 8 * h, (t / L::HL_STAGES - 1) & 1);
      const uint32_t src = base + L::RAW + s * L::RAW_BYTES + L::A_BYTES;
      const uint32_t dst = base + L::HL + h * L::HL_BYTES;
      for (int i = st; i < 2 * L::W_PLANE / 16; i += TC_SPLIT_WARPS * 32) {
        const int plane = i / (L::W_PLANE / 16);
        const int off = (i % (L::W_PLANE / 16)) * 16;
        const float4 v = ld_shared_v4(src + plane * L::W_PLANE + off);
        uint32_t hi[4], lo[4];
        split_tf32(v.x, hi[0], lo[0]);
        split_tf32(v.y, hi[1], lo[1]);
        split_tf32(v.z, hi[2], lo[2]);
        split_tf32(v.w, hi[3], lo[3]);
        const uint32_t d = dst + 2 * plane * L::W_PLANE + off;
        st_shared_v4u(d, hi[0], hi[1], hi[2], hi[3]);
        st_shared_v4u(d + L::W_PLANE, lo[0], lo[1], lo[2], lo[3]);
      }
      fence_proxy_async();
      __syncwarp();
      if (lane == 0) {
        mbar_arrive(hl_full + 8 * h);
        mbar_arrive(raw_empty + 8 * s);
      }
    }
  } else {
    // Consumers: warpgroup g owns register-operand rows a0 + 64 g .. + 63.
    // Each 8-deep slice is one commit group of wgmmas; its fragments live
    // in one of two register sets, so the next slice is loaded and split
    // while the last one's products run (wait_group 1 frees the set two
    // slices back).  A step's W tiles are released once its last group is
    // known complete, at the first wait of the next step.
    const int g = warp / 4;
    const int row0 = 64 * g + 16 * (warp % 4) + lane / 4;
    const float l = static_cast<float>(levels), inv = 1.0f / l;
    constexpr int P = STAGE == 1 ? 1 : 2;    // register-operand planes
    uint32_t hi[2][P][4], lo[2][P][4];
    for (int t = 0; t < nsteps; ++t) {
      const int s = t % TC_STAGES, h = t % L::HL_STAGES;
      const uint32_t raw = base + L::RAW + s * L::RAW_BYTES;
      const uint32_t hl = base + L::HL + h * L::HL_BYTES;
      mbar_wait(raw_full + 8 * s, (t / TC_STAGES) & 1);
      mbar_wait(hl_full + 8 * h, (t / L::HL_STAGES) & 1);
#pragma unroll
      for (int kk = 0; kk < TC_BK / 8; ++kk) {
        const int f = kk & 1;
        load_fragment<STAGE>(raw, row0, lane, kk, levels, l, inv, hi[f],
                             lo[f]);
        if (kk == TC_BK / 8 - 1) {   // the raw stage is read
          fence_proxy_async();
          __syncwarp();
          if (lane == 0) mbar_arrive(raw_empty + 8 * s);
        }
#pragma unroll
        for (int p = 0; p < 2; ++p) fence_regs<32>(acc[p]);
        fence_regs<4 * P>(&hi[f][0][0]);
        fence_regs<4 * P>(&lo[f][0][0]);
        wgmma_fence();
        const uint32_t off = kk * 32;
        const uint64_t wr_hi = sw128_desc(hl + off, 0);
        const uint64_t wr_lo = sw128_desc(hl + L::W_PLANE + off, 0);
        const uint64_t wi_hi = sw128_desc(hl + 2 * L::W_PLANE + off, 0);
        const uint64_t wi_lo = sw128_desc(hl + 3 * L::W_PLANE + off, 0);
        if constexpr (STAGE == 1) {
          // T^T = q^T W^T: re and im each one real product.
          mma_3xtf32<1>(acc[0], hi[f][0], lo[f][0], wr_hi, wr_lo);
          mma_3xtf32<1>(acc[1], hi[f][0], lo[f][0], wi_hi, wi_lo);
        } else {
          // U = T W^T: re = tr wr - ti wi, im = tr wi + ti wr.
          mma_3xtf32<1>(acc[0], hi[f][0], lo[f][0], wr_hi, wr_lo);
          mma_3xtf32<-1>(acc[0], hi[f][P - 1], lo[f][P - 1], wi_hi, wi_lo);
          mma_3xtf32<1>(acc[1], hi[f][0], lo[f][0], wi_hi, wi_lo);
          mma_3xtf32<1>(acc[1], hi[f][P - 1], lo[f][P - 1], wr_hi, wr_lo);
        }
        wgmma_commit();
        wgmma_wait_one();
        // the group before this one is complete: its registers are free
#pragma unroll
        for (int p = 0; p < 2; ++p) fence_regs<32>(acc[p]);
        fence_regs<4 * P>(&hi[f ^ 1][0][0]);
        fence_regs<4 * P>(&lo[f ^ 1][0][0]);
        if (kk == 0 && t > 0) {    // ... and with it the last step's W
          __syncwarp();
          if (lane == 0) mbar_arrive(hl_empty + 8 * ((t - 1) % L::HL_STAGES));
        }
      }
    }
    wgmma_wait_all();
#pragma unroll
    for (int p = 0; p < 2; ++p) fence_regs<32>(acc[p]);
    fence_regs<8 * P>(&hi[0][0][0]);
    fence_regs<8 * P>(&lo[0][0][0]);
  }

  // Every load has landed and every product has been read: the ring now
  // takes this CTA's partial sums.  Accumulator element 4 c + e of a
  // consumer is (row0 + 8 (e / 2), 8 c + 2 (lane % 4) + e % 2) of its tile.
  __syncthreads();
  fence_proxy_async();
  if (warp < TC_CONSUMER_WARPS) {
    const int row0 = 64 * (warp / 4) + 16 * (warp % 4) + lane / 4;
#pragma unroll
    for (int p = 0; p < 2; ++p)
#pragma unroll
      for (int c = 0; c < 8; ++c)
#pragma unroll
        for (int e = 0; e < 4; e += 2) {
          const int r = row0 + 8 * (e >> 1), col = 8 * c + 2 * (lane % 4);
          const uint32_t plane = base + p * L::P_PLANE;
          if constexpr (STAGE == 1) {   // the tile is T^T: store it transposed
            st_shared(plane + (col * L::P_STRIDE + r) * 4, acc[p][4 * c + e]);
            st_shared(plane + ((col + 1) * L::P_STRIDE + r) * 4,
                      acc[p][4 * c + e + 1]);
          } else {
            st_shared_v2(plane + (r * L::P_STRIDE + col) * 4,
                         acc[p][4 * c + e], acc[p][4 * c + e + 1]);
          }
        }
  }
  cluster_sync();

  // CTA `rank` reduces its share of the tile's rows over the cluster's
  // partials in rank order and stores them (n % 4 == 0 on this route, so a
  // 4-column group is wholly inside or outside the output).
  constexpr int C4 = L::P_COLS / 4;
  const int rows = L::P_ROWS / split;
  const size_t plane_elems = static_cast<size_t>(m) * n;
  for (int i = threadIdx.x; i < rows * C4; i += TC_THREADS) {
    const int r = rank * rows + i / C4, c = (i % C4) * 4;
    const uint32_t off = base + (r * L::P_STRIDE + c) * 4;
    float4 s0 = make_float4(0.0f, 0.0f, 0.0f, 0.0f), s1 = s0;
    for (int q = 0; q < split; ++q) {
      const uint32_t peer = cluster_addr(off, q);
      const float4 v0 = ld_cluster_v4(peer);
      const float4 v1 = ld_cluster_v4(peer + L::P_PLANE);
      if (q == 0) {
        s0 = v0;
        s1 = v1;
      } else {
        s0.x += v0.x; s0.y += v0.y; s0.z += v0.z; s0.w += v0.w;
        s1.x += v1.x; s1.y += v1.y; s1.z += v1.z; s1.w += v1.w;
      }
    }
    const int gm = (STAGE == 1 ? b0 : a0) + r;
    const int gn = (STAGE == 1 ? a0 : b0) + c;
    if (gm >= m || gn >= n) continue;
    const size_t at = frame * plane_elems + static_cast<size_t>(gm) * n + gn;
    if constexpr (STAGE == 1) {
      *reinterpret_cast<float4*>(out0 + at) = s0;
      *reinterpret_cast<float4*>(out1 + at) = s1;
    } else {   // the square-law detector: only I leaves
      *reinterpret_cast<float4*>(out0 + at) = make_float4(
          s0.x * s0.x + s1.x * s1.x, s0.y * s0.y + s1.y * s1.y,
          s0.z * s0.z + s1.z * s1.z, s0.w * s0.w + s1.w * s1.w);
    }
  }
  cluster_sync();   // no CTA leaves while a peer still reads its partials
}

__global__ void __launch_bounds__(TC_THREADS, 1)
stage1_tc_kernel(const __grid_constant__ CUtensorMap tm_a,
                 const __grid_constant__ CUtensorMap tm_wr,
                 const __grid_constant__ CUtensorMap tm_wi,
                 float* __restrict__ tr, float* __restrict__ ti, int m, int k,
                 int n, int levels, int split) {
  tc_tile<1>(&tm_a, &tm_a, &tm_wr, &tm_wi, tr, ti, m, k, n, levels, split);
}

__global__ void __launch_bounds__(TC_THREADS, 1)
stage2_tc_kernel(const __grid_constant__ CUtensorMap tm_tr,
                 const __grid_constant__ CUtensorMap tm_ti,
                 const __grid_constant__ CUtensorMap tm_wr,
                 const __grid_constant__ CUtensorMap tm_wi,
                 float* __restrict__ out, int m, int k, int n, int split) {
  tc_tile<2>(&tm_tr, &tm_ti, &tm_wr, &tm_wi, out, nullptr, m, k, n, 0,
             split);
}

// --- launches ---------------------------------------------------------------------

dim3 grid_for(int batch, int m, int n) {
  return dim3((n + BN - 1) / BN, (m + BM - 1) / BM, batch);
}

// A map over a row-major fp32 tensor of `rank` dims (innermost first):
// boxes of 32 innermost elements (128 bytes) by box1 rows of one plane,
// 128-byte swizzled, zeros outside.
bool encode(CUtensorMap* map, const float* base, int rank, int d0, int d1,
            int d2, int box1) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(d0),
                              static_cast<cuuint64_t>(d1),
                              static_cast<cuuint64_t>(d2)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(d0) * 4,
                                 static_cast<cuuint64_t>(d0) * d1 * 4};
  const cuuint32_t box[3] = {32, static_cast<cuuint32_t>(box1), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, rank,
            const_cast<float*>(base), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Launches a tensor-core kernel over (W-row tiles x split, register-operand
// row tiles, batch) with clusters of `split` CTAs along x.
template <auto Kernel, int STAGE, typename... Args>
int launch_tc(int batch, int rows_a, int rows_w, int split,
              cudaStream_t stream, Args... args) {
  constexpr size_t smem = TcLayout<STAGE>::BYTES;
  cudaError_t err = opt_in_smem<Kernel>(smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(((rows_w + TC_BN - 1) / TC_BN) * split,
                     (rows_a + TC_BM - 1) / TC_BM, batch);
  cfg.blockDim = dim3(TC_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, Kernel, args...);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

constexpr int kRouteFma = 0;
constexpr int kRouteTensorCore = 1;

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// What the tensor-core route takes: TMA's 16-byte-aligned bases and row
// strides (k and n multiples of 4), whole 16-byte output groups, a split
// of 1, 2 or 4, and fewer than 2^23 DAC levels (dac_fast's exact range).
bool tc_takes(int k, int n, int split, int levels,
              std::initializer_list<const void*> ps) {
  if (k <= 0 || k % 4 != 0 || n % 4 != 0) return false;
  if (levels >= (1 << 23)) return false;
  if (split != 1 && split != 2 && split != 4) return false;
  for (const void* p : ps)
    if (!aligned16(p)) return false;
  return true;
}

}  // namespace

extern "C" {

// T[b] = W @ dac(A[b]); levels = 2^dac_bits - 1, or 0 for no DAC.  route:
// 0 = FMA (any shape; split unused), 1 = tensor cores (returns
// cudaErrorInvalidValue for what it does not take, see tc_takes).
int optical_dft_stage1_batched(const float* wr, const float* wi,
                               const float* a, float* tr, float* ti,
                               int batch, int m, int k, int n, int levels,
                               int route, int split, void* stream) {
  if (batch == 0 || m == 0 || n == 0) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
  if (route == kRouteFma) {
    stage1_batched_kernel<<<grid_for(batch, m, n), THREADS, 0, s>>>(
        wr, wi, a, tr, ti, m, k, n, levels);
    return static_cast<int>(cudaGetLastError());
  }
  if (route != kRouteTensorCore ||
      !tc_takes(k, n, split, levels, {wr, wi, a, tr, ti}))
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap ta, twr, twi;
  if (!encode(&ta, a, 3, n, k, batch, 32) ||
      !encode(&twr, wr, 2, k, m, 1, TC_BN) ||
      !encode(&twi, wi, 2, k, m, 1, TC_BN))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_tc<stage1_tc_kernel, 1>(batch, n, m, split, s, ta, twr, twi,
                                        tr, ti, m, k, n, levels, split);
}

// I[b] = |T[b] @ W^T|^2; route and split as above.
int optical_dft_stage2_batched(const float* tr, const float* ti,
                               const float* wr, const float* wi, float* out,
                               int batch, int m, int k, int n, int route,
                               int split, void* stream) {
  if (batch == 0 || m == 0 || n == 0) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
  if (route == kRouteFma) {
    stage2_batched_kernel<<<grid_for(batch, m, n), THREADS, 0, s>>>(
        tr, ti, wr, wi, out, m, k, n);
    return static_cast<int>(cudaGetLastError());
  }
  if (route != kRouteTensorCore ||
      !tc_takes(k, n, split, 0, {tr, ti, wr, wi, out}))
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap ttr, tti, twr, twi;
  if (!encode(&ttr, tr, 3, k, m, batch, TC_BM) ||
      !encode(&tti, ti, 3, k, m, batch, TC_BM) ||
      !encode(&twr, wr, 2, k, n, 1, TC_BN) ||
      !encode(&twi, wi, 2, k, n, 1, TC_BN))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_tc<stage2_tc_kernel, 2>(batch, m, n, split, s, ttr, tti,
                                        twr, twi, out, m, k, n, split);
}

const char* optical_dft_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
