// Hopper building blocks shared by the port's kernels (local_attention.cu,
// optical_dft.cu, adc_dac.cu): mbarriers, TMA loads, wgmma descriptors and
// fences as PTX (sm_90a), the converters' NaN-keeping clip, the per-device
// shared-memory opt-in, and cuTensorMapEncodeTiled looked up at run time.
// Each source that includes it gets its own internal copy.

#pragma once

#include <atomic>

#include <cuda.h>   // CUtensorMap and its enums; libcuda is not linked
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxDevices = 64;         // devices one process may launch on

// max(a, b) that returns NaN when either is NaN, as jnp.max and
// torch.amax do (fmaxf returns the other operand).  No branch.
__device__ __forceinline__ float fmax_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;\n" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// clip(v, 0, 1) as jnp.clip and torch.clamp compute it: NaN stays NaN
// (fminf(fmaxf(v, 0), 1) would give 0).  Bit-identical to that for every
// other v; two instructions, no branch.
__device__ __forceinline__ float unit_clip(float v) {
  float r;
  asm("max.NaN.f32 %0, %1, 0f00000000;\n\t"
      "min.NaN.f32 %0, %0, 0f3F800000;\n" : "=f"(r) : "f"(v));
  return r;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}

__device__ __forceinline__ uint32_t mbar_try_wait(uint32_t bar,
                                                  uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  return done;
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// Waits until the barrier's phase of the given parity has completed.  No
// wait of these kernels lasts more than microseconds; one that lasts 4 s
// is a fault, and it traps (a launch error) instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const uint64_t t0 = global_ns();
  while (!mbar_try_wait(bar, parity))
    if (global_ns() - t0 > 4000000000ull) __trap();
}

// One box of a 3-D tensor map into this CTA's shared memory; completion
// (its bytes) is reported to the barrier.
__device__ __forceinline__ void tma_load_3d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar),
         "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// Named barriers between warpgroups: ``n`` threads in all take part; the
// arriving side does not wait, and its shared-memory writes before the
// arrive are seen by the side that syncs.
__device__ __forceinline__ void named_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void named_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" :: "r"(id), "r"(n) : "memory");
}

// A wgmma shared-memory descriptor for a tile written by TMA with the
// 128-byte swizzle: 128-byte rows (64 bf16 or 32 fp32), 8-row groups 1024
// bytes apart (the stride byte offset).  A K-major operand steps along its
// contraction dim by adding 32 bytes (16 bf16, 8 tf32: one instruction's
// k) to the start address inside the swizzle atom, which leaves the
// leading byte offset unused (0).  An MN-major operand (attention's V,
// contracted over its rows) takes its 8-row groups 1024 bytes apart as
// well; its leading offset, the stride to the next 64 columns, is never
// used because each of its products is 64 columns wide, and it is set to
// the same 1024 bytes.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving reads or writes of registers that an
// asynchronous wgmma owns past the wgmma's start or its wait.
template <int N>
__device__ __forceinline__ void fence_regs(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i]) :: "memory");
}

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

// Makes the current device's primary context current on the calling
// thread.  cuTensorMapEncodeTiled needs a current context, and a thread
// that has made no runtime call that binds one, such as autograd's
// backward worker, has none (CUDA_ERROR_INVALID_CONTEXT).
inline cudaError_t bind_primary_context() {
  int device = 0;
  const cudaError_t err = cudaGetDevice(&device);
  return err != cudaSuccess ? err : cudaSetDevice(device);
}

// cuTensorMapEncodeTiled, looked up at run time so that the library needs
// no -lcuda.
using EncodeTiledFn = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult found{};
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &f, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiledFn>(f) : nullptr;
  }();
  return fn;
}

}  // namespace
