// Fused converter-boundary emulation for Hopper (sm_90a): DAC -> analog
// noise -> ADC auto-ranged to a global scale, in one elementwise pass.
//
//   y   = rint(clip(x, 0, 1) * Ld) / Ld                      (DAC, Ld = 2^dac_bits - 1)
//   y  += noise_std * noise                                  (skipped when noise is null)
//   out = rint(clip(y / s, 0, 1) * La) / La * s              (ADC, La = 2^adc_bits - 1)
//   s   = max(max(x), 1e-20), computed by the caller and read from *scale.
//
// Replaces the Pallas TPU kernel of the JAX reference,
// src/repro/kernels/adc_dac.py: _kernel (pallas_call in converter_boundary).
// As there, the global scale comes from a reduction outside the kernel; here
// it arrives as a device pointer, so the host never waits for it.
//
// What bounds it on an H100: it is elementwise, a few dozen operations per
// element against 8-12 bytes moved (x read, noise read, out written), so
// the bytes bound (3.35 TB/s) is the only one that matters: one
// 2048 x 2048 f32 frame with noise moves 50 MB, about 15 us.
//
// Design: a grid-stride loop over h * w elements, one element per thread
// per step, so any 2-D shape works (the reference's pick_block needs
// divisible blocks).  Rounding is rintf, half to even, as jnp.round and
// torch.round do (CUDA's roundf rounds half away from zero).  Every
// multiply, add and divide is an explicitly rounded IEEE operation
// (__fmul_rn, __fadd_rn, __fdiv_rn): nvcc would otherwise contract
// y + noise_std * n into one FMA, which the plain PyTorch version does not,
// and one ulp there can move a value across an ADC step.  The order of
// operations is the reference's: (rint(z * La) / La) * s.
//
// C ABI: the entry point launches on the given stream, allocates nothing,
// does not synchronise, and returns cudaGetLastError().  It launches on the
// calling thread's current device, which the Python wrapper selects.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_BLOCKS = 132 * 16;    // 16 blocks per SM on an H100

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

__device__ __forceinline__ float unit_clip(float v) {
  return fminf(fmaxf(v, 0.0f), 1.0f);
}

template <typename TX, typename TN>
__global__ void __launch_bounds__(THREADS)
converter_boundary_kernel(const TX* __restrict__ x,
                          const TN* __restrict__ noise,
                          const float* __restrict__ scale,
                          TX* __restrict__ out, size_t n, float dac_levels,
                          float adc_levels, float noise_std) {
  const float s = *scale;
  const size_t stride = static_cast<size_t>(gridDim.x) * blockDim.x;
  for (size_t e = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       e < n; e += stride) {
    float y = __fdiv_rn(rintf(__fmul_rn(unit_clip(load_f(x + e)),
                                        dac_levels)), dac_levels);
    if (noise != nullptr)
      y = __fadd_rn(y, __fmul_rn(noise_std, load_f(noise + e)));
    const float z = unit_clip(__fdiv_rn(y, s));
    store_f(out + e, __fmul_rn(__fdiv_rn(rintf(__fmul_rn(z, adc_levels)),
                                         adc_levels), s));
  }
}

template <typename TX, typename TN>
int launch(const void* x, const void* noise, const void* scale, void* out,
           size_t n, float dac_levels, float adc_levels, float noise_std,
           cudaStream_t stream) {
  const size_t want = (n + THREADS - 1) / THREADS;
  const int blocks = static_cast<int>(want < MAX_BLOCKS ? want : MAX_BLOCKS);
  converter_boundary_kernel<TX, TN><<<blocks, THREADS, 0, stream>>>(
      static_cast<const TX*>(x), static_cast<const TN*>(noise),
      static_cast<const float*>(scale), static_cast<TX*>(out), n,
      dac_levels, adc_levels, noise_std);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x_dtype and noise_dtype: 0 = float32, 1 = bfloat16.  noise may be null
// (no noise step; noise_dtype is then ignored).  scale points to one
// float32 on the device.  Returns cudaErrorInvalidValue for anything else.
int converter_boundary_forward(const void* x, const void* noise,
                               const void* scale, void* out, int x_dtype,
                               int noise_dtype, long long n, int dac_bits,
                               int adc_bits, float noise_std, void* stream) {
  if (n == 0) return 0;
  if (n < 0 || dac_bits < 1 || dac_bits > 24 || adc_bits < 1 ||
      adc_bits > 24)
    return static_cast<int>(cudaErrorInvalidValue);
  const float ld = static_cast<float>((1 << dac_bits) - 1);
  const float la = static_cast<float>((1 << adc_bits) - 1);
  const size_t count = static_cast<size_t>(n);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool bf_noise = noise != nullptr && noise_dtype == 1;
  if (noise != nullptr && noise_dtype != 0 && noise_dtype != 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (x_dtype == 0)
    return bf_noise
        ? launch<float, __nv_bfloat16>(x, noise, scale, out, count, ld, la,
                                       noise_std, s)
        : launch<float, float>(x, noise, scale, out, count, ld, la,
                               noise_std, s);
  if (x_dtype == 1)
    return bf_noise
        ? launch<__nv_bfloat16, __nv_bfloat16>(x, noise, scale, out, count,
                                               ld, la, noise_std, s)
        : launch<__nv_bfloat16, float>(x, noise, scale, out, count, ld, la,
                                       noise_std, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* converter_boundary_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
