// Converter-boundary emulation for Hopper (sm_90a): DAC -> analog noise ->
// ADC auto-ranged to the global max, the max fused into the same pass.
//
//   y   = rint(clip(x, 0, 1) * Ld) / Ld                      (DAC, Ld = 2^dac_bits - 1)
//   y  += noise_std * noise                                  (skipped when noise is null)
//   s   = max(max(x), floor)                                 (floor: 1e-20 in x's dtype)
//   out = rint(clip(y / s, 0, 1) * La) / La * s              (ADC, La = 2^adc_bits - 1)
//
// Replaces the Pallas TPU kernel of the JAX reference,
// src/repro/kernels/adc_dac.py: _kernel (pallas_call in converter_boundary),
// and the jnp.max its wrapper takes before it.
//
// What bounds it on an H100: bytes.  A few dozen operations per element
// against 8-12 bytes that must move (x and noise read once, out written
// once): a 2048 x 2048 f32 frame with noise is 50 MB, 15 us at 3.35 TB/s.
// The ADC's scale is global and depends on x alone, so only x has to wait
// for it; done naively (a reduction, then an elementwise pass) x crosses
// HBM twice.
//
// Two routes; the caller picks one from (numel, dtype, SMs, shared memory)
// (kernels/adc_dac.py: route), and a launch that fails raises there:
//
// * resident (x fits in the SMs' shared memory, ~28 MB on an H100): one
//   cooperative launch, one CTA per SM.  Phase 1: each CTA copies its
//   contiguous chunk of x into shared memory with TMA bulk copies and
//   reduces the chunk's max.  A grid barrier.  Phase 2: every CTA reduces
//   the per-CTA maxima itself (max is exact and order-free, so every CTA
//   gets the same s), streams noise in and out with 16-byte accesses, and
//   takes x from shared memory.  HBM sees x, noise and out once each: the
//   bound's count.  Phase 2's arithmetic overlaps its noise and out
//   traffic; without noise there is too little traffic to hide it, so
//   there (for DACs of up to 12 bits) each CTA first tabulates the output
//   of every DAC code, and an element costs a clip, a rounding and a
//   table read.  (Asking L2 to prefetch the noise during phase 1 made the
//   call slower: it moved noise's bytes before the barrier, out of reach
//   of phase 2's arithmetic.)
// * streamed (larger x): a max kernel writes one partial per CTA, then the
//   elementwise kernel, whose CTAs each reduce the partials first.  Two
//   launches, x read twice.
//
// Vector accesses need x, noise and out 16-byte aligned; otherwise both
// routes run the same arithmetic in scalar loops.  A chunk holds a
// multiple of 8 elements, so each chunk starts on 16 bytes; the last
// chunk's ragged end (fewer than one 16-byte group) goes through scalar
// code in the same kernel.
//
// The arithmetic is the plain version's, element by element: every
// multiply, add and divide is an explicitly rounded IEEE operation
// (nvcc would otherwise contract y + noise_std * n into an FMA, which the
// plain PyTorch version does not), rounding is rintf (half to even, as
// torch.round), the clips keep NaN as torch.clamp does, and the max
// propagates NaN as torch.amax does.  The quotients of a code by Ld and
// La take the corrected reciprocal of optical_dft.cu's dac_fast, which is
// the IEEE quotient for every code below 2^23 levels
// (tests/test_torch_kernels.py checks it); 24-bit converters divide.
// y / s is always an IEEE divide.  So out is bit-equal to the plain
// version's.
//
// C ABI: the entry point launches on the given stream, allocates nothing,
// does not synchronise, and returns a cudaError_t code.  It launches on the
// calling thread's current device, which the Python wrapper selects.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int RES_THREADS = 1024;      // resident route: one CTA per SM
constexpr int STREAM_THREADS = 512;    // streamed route
constexpr int STREAM_BLOCKS_PER_SM = 4;
constexpr int PIECES = 4;              // TMA copies (one barrier each) a chunk
constexpr size_t CHUNK_ALIGN = 8;      // elements: 16 bytes of bf16
constexpr int TABLE_BITS = 12;         // DACs whose codes the table holds
constexpr int TABLE_BYTES = (1 << TABLE_BITS) * 4;
constexpr int STATIC_SMEM = 1024;      // at least the kernel's static smem
// bytes of the shared-memory opt-in that x's chunk leaves to the rest
constexpr int SMEM_RESERVED = STATIC_SMEM + TABLE_BYTES;

constexpr int kRouteResident = 0;
constexpr int kRouteStreamed = 1;

struct Params {
  float ld, la;            // converter levels
  float inv_ld, inv_la;    // 1 / levels, for the corrected quotient
  float noise_std;
  float scale_floor;       // 1e-20 in x's dtype
  int fast_dac, fast_adc;  // levels < 2^23: the corrected quotient is exact
};

// --- elements ------------------------------------------------------------------

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void from_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void from_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// c / l for a code c in 0 .. l (or NaN).
__device__ __forceinline__ float quotient(float c, float l, float inv,
                                          int fast) {
  if (!fast) return __fdiv_rn(c, l);
  const float d = __fmul_rn(c, inv);
  return __fmaf_rn(__fmaf_rn(-d, l, c), inv, d);
}

// The output for DAC code c (a whole number 0 .. Ld, or NaN).
__device__ __forceinline__ float from_code(float c, float nz, bool noisy,
                                           float s, const Params& p) {
  float y = quotient(c, p.ld, p.inv_ld, p.fast_dac);
  if (noisy) y = __fadd_rn(y, __fmul_rn(p.noise_std, nz));
  // y / s.  For y = +-0 that is y itself (s is NaN, +inf or >= the
  // floor), but the IEEE divide takes its slow path there, and without
  // noise every x <= 0 gives y = 0; so such a y divides s by itself and
  // the quotient is replaced.  The same bits, no divergent slow path.
  const bool zero = y == 0.0f && s == s;
  const float q = __fdiv_rn(zero ? s : y, s);
  const float z = unit_clip(zero ? y : q);
  return __fmul_rn(quotient(rintf(__fmul_rn(z, p.la)), p.la, p.inv_la,
                            p.fast_adc), s);
}

__device__ __forceinline__ float convert(float x, float nz, bool noisy,
                                         float s, const Params& p) {
  return from_code(rintf(__fmul_rn(unit_clip(x), p.ld)), nz, noisy, s, p);
}

// The table index of x: its DAC code, rounded half to even as rintf does;
// a NaN x gives 0, whose entry is NaN then (s is NaN).
__device__ __forceinline__ int table_code(float x, const Params& p) {
  return __float2int_rn(__fmul_rn(unit_clip(x), p.ld));
}

// --- 16-byte groups ------------------------------------------------------------
//
// A group is the 16 bytes of x at one index: 4 f32 or 8 bf16 elements.
// Its noise is 8, 16 or 32 bytes; each is moved as 32-bit words.

template <typename T> struct Conv;
template <> struct Conv<float> {
  static constexpr int PER_WORD = 1;
  __device__ static void unpack(uint32_t w, float* v) {
    v[0] = __uint_as_float(w);
  }
  __device__ static uint32_t pack(const float* v) {
    return __float_as_uint(v[0]);
  }
};
template <> struct Conv<__nv_bfloat16> {
  static constexpr int PER_WORD = 2;
  __device__ static void unpack(uint32_t w, float* v) {   // bf16 -> f32 exact
    v[0] = __uint_as_float(w << 16);
    v[1] = __uint_as_float(w & 0xFFFF0000u);
  }
  __device__ static uint32_t pack(const float* v) {
    return static_cast<uint32_t>(
               __bfloat16_as_ushort(__float2bfloat16_rn(v[0]))) |
           (static_cast<uint32_t>(
                __bfloat16_as_ushort(__float2bfloat16_rn(v[1])))
            << 16);
  }
};

template <typename T, int G>
constexpr int kWords = G / Conv<T>::PER_WORD;

// G values of T at p (aligned to their size) into floats.  STREAM: a
// global load marked evict-first (read once); otherwise a plain load
// (shared memory, or x that the streamed route reads twice).
template <typename T, int G, bool STREAM>
__device__ __forceinline__ void load_group(const T* p, float* v) {
  constexpr int W = kWords<T, G>;
  uint32_t w[W];
  if constexpr (W == 2) {
    const uint2 q = STREAM ? __ldcs(reinterpret_cast<const uint2*>(p))
                           : *reinterpret_cast<const uint2*>(p);
    w[0] = q.x; w[1] = q.y;
  } else {
#pragma unroll
    for (int i = 0; i < W; i += 4) {
      const uint4* a = reinterpret_cast<const uint4*>(p) + i / 4;
      const uint4 q = STREAM ? __ldcs(a) : *a;
      w[i] = q.x; w[i + 1] = q.y; w[i + 2] = q.z; w[i + 3] = q.w;
    }
  }
#pragma unroll
  for (int i = 0; i < W; ++i) Conv<T>::unpack(w[i], v + i * Conv<T>::PER_WORD);
}

template <typename T, int G>
__device__ __forceinline__ void store_group(T* p, const float* v) {
  static_assert(kWords<T, G> == 4, "a group of x is 16 bytes");
  uint4 q;
  q.x = Conv<T>::pack(v);
  q.y = Conv<T>::pack(v + Conv<T>::PER_WORD);
  q.z = Conv<T>::pack(v + 2 * Conv<T>::PER_WORD);
  q.w = Conv<T>::pack(v + 3 * Conv<T>::PER_WORD);
  __stcs(reinterpret_cast<uint4*>(p), q);      // written once: evict first
}

template <typename TX, typename TN>
__device__ __forceinline__ void convert_group(const float* xv, const TN* noise,
                                              TX* out, float s,
                                              const Params& p) {
  constexpr int G = 16 / sizeof(TX);
  constexpr int H = G * sizeof(TN) > 16 ? G / 2 : G;   // <= 16 bytes a load
  float ov[G];
#pragma unroll
  for (int h = 0; h < G; h += H) {
    float nv[H];
    if (noise != nullptr) load_group<TN, H, true>(noise + h, nv);
#pragma unroll
    for (int i = 0; i < H; ++i)
      ov[h + i] = convert(xv[h + i], noise != nullptr ? nv[i] : 0.0f,
                          noise != nullptr, s, p);
  }
  store_group<TX, G>(out, ov);
}

template <typename TX, typename TN>
__device__ __forceinline__ void convert_one(TX xv, const TN* noise, size_t e,
                                            TX* out, float s,
                                            const Params& p) {
  const bool noisy = noise != nullptr;
  from_f(out + e, convert(to_f(xv), noisy ? to_f(noise[e]) : 0.0f, noisy, s,
                          p));
}

// --- reductions ----------------------------------------------------------------

__device__ __forceinline__ float warp_max(float m) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    m = fmax_nan(m, __shfl_xor_sync(0xffffffffu, m, o));
  return m;
}

// The block's max (NaN if any thread's is), valid in thread 0.
__device__ __forceinline__ float block_max(float m, float* red) {
  m = warp_max(m);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x < 32) {
    m = threadIdx.x < (blockDim.x >> 5) ? red[threadIdx.x] : -INFINITY;
    m = warp_max(m);
  }
  return m;
}

// s = max(partials[0 .. count), floor), computed by warp 0 and handed to
// the whole block.
__device__ __forceinline__ float scale_from(const float* partials, int count,
                                            float scale_floor,
                                            float* shared_s) {
  if (threadIdx.x < 32) {
    float m = -INFINITY;
    for (int i = threadIdx.x; i < count; i += 32)
      m = fmax_nan(m, __ldcg(partials + i));
    m = warp_max(m);
    if (threadIdx.x == 0) *shared_s = fmax_nan(m, scale_floor);
  }
  __syncthreads();
  return *shared_s;
}

// --- TMA bulk copies -----------------------------------------------------------

__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

// --- the resident route --------------------------------------------------------

template <typename TX, typename TN>
__global__ void __launch_bounds__(RES_THREADS, 1)
boundary_resident_kernel(const TX* __restrict__ x,
                         const TN* __restrict__ noise, TX* __restrict__ out,
                         float* __restrict__ partials, size_t n,
                         size_t chunk, int vec, int table_len, Params p) {
  constexpr int G = 16 / sizeof(TX);
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t bars[PIECES];
  __shared__ float red[RES_THREADS / 32];
  __shared__ float shared_s;
  TX* xs = reinterpret_cast<TX*>(smem);

  const size_t begin = min(n, static_cast<size_t>(blockIdx.x) * chunk);
  const size_t len = min(n, begin + chunk) - begin;
  const TX* xg = x + begin;
  const TN* ng = noise == nullptr ? nullptr : noise + begin;
  TX* og = out + begin;

  // phase 1: the chunk of x into shared memory, and its max; its whole
  // 16-byte groups through TMA when the operands are aligned
  const size_t groups = vec ? len / G : 0;
  const uint32_t bulk = static_cast<uint32_t>(groups * 16);
  const uint32_t piece = ((bulk + PIECES - 1) / PIECES + 15) & ~15u;
  if (threadIdx.x == 0) {
    for (int i = 0; i < PIECES; ++i) mbar_init(smem_u32(&bars[i]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int i = 0; i < PIECES && i * piece < bulk; ++i) {
      const uint32_t bytes = min(piece, bulk - i * piece);
      mbar_expect_tx(smem_u32(&bars[i]), bytes);
      bulk_load(smem_u32(smem + i * piece),
                reinterpret_cast<const unsigned char*>(xg) + i * piece,
                bytes, smem_u32(&bars[i]));
    }
  }
  float m = -INFINITY;
  for (size_t e = groups * G + threadIdx.x; e < len; e += blockDim.x) {
    const TX v = xg[e];                 // the rest through registers
    xs[e] = v;
    m = fmax_nan(m, to_f(v));
  }
  __syncthreads();                      // the barriers are initialised
  for (int i = 0; i < PIECES && i * piece < bulk; ++i) {
    mbar_wait(smem_u32(&bars[i]), 0);
    const uint32_t end = min(bulk, (i + 1) * piece) / 16;
    for (uint32_t g = i * piece / 16 + threadIdx.x; g < end;
         g += blockDim.x) {
      float v[G];
      load_group<TX, G, false>(xs + g * G, v);
#pragma unroll
      for (int j = 0; j < G; ++j) m = fmax_nan(m, v[j]);
    }
  }
  m = block_max(m, red);
  if (threadIdx.x == 0) partials[blockIdx.x] = m;
  cooperative_groups::this_grid().sync();
  const float s = scale_from(partials, gridDim.x, p.scale_floor, &shared_s);

  // phase 2: noise in, out out, x from shared memory
  if (table_len > 0) {          // no noise: the output of each DAC code
    float* table = reinterpret_cast<float*>(smem + chunk * sizeof(TX));
    for (int c = threadIdx.x; c < table_len; c += blockDim.x)
      table[c] = from_code(static_cast<float>(c), 0.0f, false, s, p);
    __syncthreads();
    for (size_t g = threadIdx.x; g < groups; g += blockDim.x) {
      float v[G];
      load_group<TX, G, false>(xs + g * G, v);
#pragma unroll
      for (int i = 0; i < G; ++i) v[i] = table[table_code(v[i], p)];
      store_group<TX, G>(og + g * G, v);
    }
    for (size_t e = groups * G + threadIdx.x; e < len; e += blockDim.x)
      from_f(og + e, table[table_code(to_f(xs[e]), p)]);
    return;
  }
  for (size_t g = threadIdx.x; g < groups; g += blockDim.x) {
    float v[G];
    load_group<TX, G, false>(xs + g * G, v);
    convert_group<TX, TN>(v, ng == nullptr ? nullptr : ng + g * G,
                          og + g * G, s, p);
  }
  for (size_t e = groups * G + threadIdx.x; e < len; e += blockDim.x)
    convert_one(xs[e], ng, e, og, s, p);
}

// --- the streamed route --------------------------------------------------------

template <typename TX>
__global__ void __launch_bounds__(STREAM_THREADS)
boundary_max_kernel(const TX* __restrict__ x, size_t n, int vec,
                    float* __restrict__ partials) {
  constexpr int G = 16 / sizeof(TX);
  __shared__ float red[STREAM_THREADS / 32];
  const size_t stride = static_cast<size_t>(gridDim.x) * blockDim.x;
  const size_t first = static_cast<size_t>(blockIdx.x) * blockDim.x +
                       threadIdx.x;
  float m = -INFINITY;
  const size_t groups = vec ? n / G : 0;
  for (size_t g = first; g < groups; g += stride) {
    float v[G];
    load_group<TX, G, false>(x + g * G, v);
#pragma unroll
    for (int j = 0; j < G; ++j) m = fmax_nan(m, v[j]);
  }
  for (size_t e = groups * G + first; e < n; e += stride)
    m = fmax_nan(m, to_f(x[e]));
  m = block_max(m, red);
  if (threadIdx.x == 0) partials[blockIdx.x] = m;
}

template <typename TX, typename TN>
__global__ void __launch_bounds__(STREAM_THREADS)
boundary_stream_kernel(const TX* __restrict__ x, const TN* __restrict__ noise,
                       TX* __restrict__ out,
                       const float* __restrict__ partials, int n_partials,
                       size_t n, int vec, Params p) {
  constexpr int G = 16 / sizeof(TX);
  __shared__ float shared_s;
  const float s = scale_from(partials, n_partials, p.scale_floor, &shared_s);
  const size_t stride = static_cast<size_t>(gridDim.x) * blockDim.x;
  const size_t first = static_cast<size_t>(blockIdx.x) * blockDim.x +
                       threadIdx.x;
  const size_t groups = vec ? n / G : 0;
  for (size_t g = first; g < groups; g += stride) {
    float v[G];
    load_group<TX, G, true>(x + g * G, v);
    convert_group<TX, TN>(v, noise == nullptr ? nullptr : noise + g * G,
                          out + g * G, s, p);
  }
  for (size_t e = groups * G + first; e < n; e += stride)
    convert_one(x[e], noise, e, out, s, p);
}

// --- launches ------------------------------------------------------------------

// SM count and shared-memory opt-in per block of the current device, read
// once per device.
cudaError_t device_limits(int* sms, int* smem) {
  static std::atomic<int> cached_sms[kMaxDevices], cached_smem[kMaxDevices];
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (cached_sms[device].load(std::memory_order_relaxed) == 0) {
    int a = 0, b = 0;
    err = cudaDeviceGetAttribute(&a, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&b, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                 device);
    if (err != cudaSuccess) return err;
    cached_smem[device].store(b, std::memory_order_relaxed);
    cached_sms[device].store(a, std::memory_order_relaxed);
  }
  *sms = cached_sms[device].load(std::memory_order_relaxed);
  *smem = cached_smem[device].load(std::memory_order_relaxed);
  return cudaSuccess;
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

template <typename TX, typename TN>
int launch(const void* x, const void* noise, void* out, float* partials,
           long long n_partials, size_t n, const Params& p, int route,
           cudaStream_t stream) {
  int sms = 0, smem_optin = 0;
  cudaError_t err = device_limits(&sms, &smem_optin);
  if (err != cudaSuccess) return static_cast<int>(err);
  const TX* xp = static_cast<const TX*>(x);
  const TN* np = static_cast<const TN*>(noise);
  TX* op = static_cast<TX*>(out);
  int vec = aligned16(x) && aligned16(out) &&
            (noise == nullptr || aligned16(noise));
  if (route == kRouteResident) {
    size_t chunk = (n + sms - 1) / sms;
    chunk = (chunk + CHUNK_ALIGN - 1) / CHUNK_ALIGN * CHUNK_ALIGN;
    const size_t x_bytes = chunk * sizeof(TX);
    const int capacity = smem_optin - SMEM_RESERVED;
    if (x_bytes > static_cast<size_t>(capacity) || n_partials < sms)
      return static_cast<int>(cudaErrorInvalidValue);
    int table_len = noise == nullptr && p.ld < (1 << TABLE_BITS)
                        ? static_cast<int>(p.ld) + 1 : 0;
    const size_t smem = x_bytes + (table_len > 0 ? TABLE_BYTES : 0);
    auto kernel = boundary_resident_kernel<TX, TN>;
    err = opt_in_smem<boundary_resident_kernel<TX, TN>>(capacity +
                                                         TABLE_BYTES);
    if (err != cudaSuccess) return static_cast<int>(err);
    void* args[] = {&xp, &np, &op, &partials, &n, &chunk, &vec, &table_len,
                    const_cast<Params*>(&p)};
    err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel),
                                      dim3(sms), dim3(RES_THREADS), args,
                                      smem, stream);
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaGetLastError());
  }
  if (route != kRouteStreamed) return static_cast<int>(cudaErrorInvalidValue);
  const size_t units = vec ? (n + 16 / sizeof(TX) - 1) / (16 / sizeof(TX))
                           : n;
  const size_t want = (units + STREAM_THREADS - 1) / STREAM_THREADS;
  const int most = sms * STREAM_BLOCKS_PER_SM;
  const int blocks = static_cast<int>(want < static_cast<size_t>(most)
                                          ? want : most);
  if (n_partials < blocks) return static_cast<int>(cudaErrorInvalidValue);
  boundary_max_kernel<TX><<<blocks, STREAM_THREADS, 0, stream>>>(
      xp, n, vec, partials);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  boundary_stream_kernel<TX, TN><<<blocks, STREAM_THREADS, 0, stream>>>(
      xp, np, op, partials, blocks, n, vec, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The current device's SM count and shared memory a block may opt in to:
// the inputs of the wrapper's route().
int converter_boundary_limits(int* sm_count, int* smem_per_block) {
  return static_cast<int>(device_limits(sm_count, smem_per_block));
}

// x_dtype and noise_dtype: 0 = float32, 1 = bfloat16.  noise may be null
// (no noise step; noise_dtype is then ignored).  partials: a device
// float32 buffer of n_partials >= 4 x the SM count.  scale_floor: 1e-20
// rounded to x's dtype, as the plain version's clamp_min rounds it.  route: 0 = resident (refused with
// cudaErrorInvalidValue when x does not fit), 1 = streamed.  Returns
// cudaErrorInvalidValue for any other argument out of range.
int converter_boundary_forward(const void* x, const void* noise, void* out,
                               void* partials, long long n_partials,
                               int x_dtype, int noise_dtype, long long n,
                               int dac_bits, int adc_bits, float noise_std,
                               float scale_floor, int route, void* stream) {
  if (n == 0) return 0;
  if (n < 0 || dac_bits < 1 || dac_bits > 24 || adc_bits < 1 ||
      adc_bits > 24 || (x_dtype != 0 && x_dtype != 1) ||
      (noise != nullptr && noise_dtype != 0 && noise_dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.ld = static_cast<float>((1 << dac_bits) - 1);
  p.la = static_cast<float>((1 << adc_bits) - 1);
  p.inv_ld = 1.0f / p.ld;
  p.inv_la = 1.0f / p.la;
  p.noise_std = noise_std;
  p.scale_floor = scale_floor;
  p.fast_dac = dac_bits <= 23;
  p.fast_adc = adc_bits <= 23;
  const size_t count = static_cast<size_t>(n);
  float* part = static_cast<float*>(partials);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool bf_noise = noise != nullptr && noise_dtype == 1;
  if (x_dtype == 0)
    return bf_noise
        ? launch<float, __nv_bfloat16>(x, noise, out, part, n_partials, count,
                                       p, route, s)
        : launch<float, float>(x, noise, out, part, n_partials, count, p,
                               route, s);
  return bf_noise
      ? launch<__nv_bfloat16, __nv_bfloat16>(x, noise, out, part, n_partials,
                                             count, p, route, s)
      : launch<__nv_bfloat16, float>(x, noise, out, part, n_partials, count,
                                     p, route, s);
}

const char* converter_boundary_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
