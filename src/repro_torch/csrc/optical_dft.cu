// Fused 4f-optics DFT pipeline for Hopper (sm_90a): the two batched stages
// of the unitary 2-D DFT as complex GEMMs, with the DAC fused into stage 1's
// operand load and the square-law detector fused into stage 2's store.
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
// What bounds them on an H100: at 512x512 frames and K = 16, stage 1 is
// 8.6 GFLOP and stage 2 17.2 GFLOP against about 50 MB of traffic each, so
// both are bound by operations, not bytes.  The parity bounds of the
// reference (stage 1 rtol 1e-4 / atol 1e-5, pipeline rtol 2e-4 / atol
// 2e-4*max) rule out plain TF32 or bf16 tensor-core products, so the
// arithmetic is full fp32 FMA on the CUDA cores (67 TFLOP/s peak).
//
// Design: one block computes a BM x BN output tile of one frame (grid =
// output tiles x batch); the contraction runs as a loop inside the block
// over BK-deep stages staged through shared memory, which takes the place
// of the TPU's sequential K grid axis and its VMEM accumulator scratch.
// Each of the 256 threads holds a 4 x 4 sub-tile of both the real and the
// imaginary accumulator in registers, strided by 16 so that shared-memory
// reads are conflict-free and global stores coalesce.  Operand tiles whose
// contraction axis is contiguous in memory (W, T) are stored transposed
// with one word of padding.  The DAC rounds half to even (rintf) and
// divides by `levels` with a true divide, exactly as torch.round /
// jnp.round and the reference's `/ levels` do, so ties such as
// 0.5 * 255 = 127.5 quantize identically.  Ragged edges are masked: loads
// outside the matrix read 0, stores outside it are skipped.  The block
// sizes are compile-time; the caller's Pallas-style block plan is validated
// by the Python wrapper and not used here.
//
// C ABI: every entry point launches on the given stream, allocates
// nothing, does not synchronise, and returns cudaGetLastError().  It launches on the
// calling thread's current device, which the Python wrapper selects; it
// never changes it.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

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
    a = rintf(fminf(fmaxf(a, 0.0f), 1.0f) * l) / l;
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

dim3 grid_for(int batch, int m, int n) {
  return dim3((n + BN - 1) / BN, (m + BM - 1) / BM, batch);
}

}  // namespace

extern "C" {

// T[b] = W @ dac(A[b]); levels = 2^dac_bits - 1, or 0 for no DAC.
int optical_dft_stage1_batched(const float* wr, const float* wi,
                               const float* a, float* tr, float* ti,
                               int batch, int m, int k, int n, int levels,
                               void* stream) {
  if (batch == 0 || m == 0 || n == 0) return 0;
  stage1_batched_kernel<<<grid_for(batch, m, n), THREADS, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      wr, wi, a, tr, ti, m, k, n, levels);
  return static_cast<int>(cudaGetLastError());
}

// I[b] = |T[b] @ W^T|^2.
int optical_dft_stage2_batched(const float* tr, const float* ti,
                               const float* wr, const float* wi, float* out,
                               int batch, int m, int k, int n,
                               void* stream) {
  if (batch == 0 || m == 0 || n == 0) return 0;
  stage2_batched_kernel<<<grid_for(batch, m, n), THREADS, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      tr, ti, wr, wi, out, m, k, n);
  return static_cast<int>(cudaGetLastError());
}

const char* optical_dft_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
