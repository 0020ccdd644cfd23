// Kernel 3 of the FM path: quadrature discriminator + decimating 128-tap
// FIR, hand-written CUDA C++ for Hopper (sm_90a).
//
// Replaces: tdoa_tpu/ops/pallas/fm_demod.py, _kernel via
// fm_demod_decimate_pallas.
//
// What it computes, for every channel c of planar f32 IQ (re, im rows
// with a channel stride) and every output j < n / D:
//   d[g] = atan2(Im p, Re p) * fs / (2*pi*dev),  p = x[g] * conj(x[g-1]),
//          for 0 < g < n; d[0] = 0 (the sample before the capture is
//          zero) and d[g] = 0 for g >= n;
//   y[j] = sum_{k < 128} h[k] * d[j*D + k].
// D divides 128; h is the wrapper's 127-tap lowpass zero-padded to 128.
//
// What bounds it on the H100. Each input sample is 8 bytes read once; the
// work per sample is one complex product, one accurate atan2f (the
// build uses no fast-math) and 128/D FIR multiply-adds (16 at D = 8).
// At the main path's 9 channels x 20 M samples, D = 8: 1.44 GB read +
// 90 MB written, ~0.46 ms at 3.35 TB/s, against ~11 GFLOP, ~0.16 ms at
// 67 TFLOP/s f32. The bytes set the bound. What a kernel spends above
// it goes to the SMs' schedulers: the library's atan2f is ~75 instructions a
// sample (a division, a rational approximation with a second
// reciprocal, the special cases), several times the loads, the product
// and the FIR together. So the design keeps everything around the
// atan2f cheap and enough loads in flight beside it.
//
// The design. One launch covers every channel: grid (output tile,
// channel), a CTA per SPAN input samples plus the 128-sample halo, two
// phases with one barrier between, several CTAs per SM so that one's
// loads overlap another's arithmetic.
//  1. Load + discriminate. A warp walks its share of the tile in chunks
//     of 128 samples, 4 consecutive samples a lane: re and im arrive as
//     one 16-byte load each, issued one chunk ahead of their use; x[g-1]
//     is the lane's own previous element, the neighbouring lane's last
//     (__shfl_up_sync) or, for lane 0, the previous chunk's last, so
//     each sample is loaded once (one scalar look-back per warp and
//     tile). Rows that are not 16-byte aligned (an odd channel stride, an
//     offset base pointer: the wrapper says so per launch) take the same
//     code with four scalar loads; so does the ragged end of a row. d
//     goes to shared memory in polyphase order, ds[q][m] = d[g0 + m*D +
//     q], each row 16-byte aligned and skewed so that these writes spread
//     over the banks.
//  2. FIR from registers. A thread computes R = 4 consecutive outputs:
//     for each polyphase row q it slides a window of that row through
//     registers, loaded as 16-byte shared-memory reads (consecutive
//     lanes read consecutive 16 bytes: no bank conflicts), and
//     multiplies by h[m*D + q] read as a constant-bank operand of the
//     FMA: the taps live in __constant__ memory and every tap index is a
//     compile-time constant of the unrolled loops (D is a template
//     parameter). At D = 8 that is 40 shared-memory loads for 512 FMAs.
//     Each output's sum runs in one fixed order (q, then m), so two
//     launches agree bitwise.
// The taps are copied to constant memory on the launch's stream only when
// (sample rate, D) differs from the device's previous launch; an event
// orders launches that come on different streams.
//
// Per-phase timeline: python3 scripts/kernel_timeline.py --kernels 3
// (the TDOA_TL stamps below, compiled only with -DTDOA_TIMELINE).

#include <cuda_runtime.h>

#include <cstdint>
#include <mutex>
#include <vector>

#include "grid_sync.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int SPAN = 8192;  // input samples per CTA
constexpr int NUM_TAPS = 128;
constexpr int R = 4;        // consecutive outputs a thread computes
constexpr int CHUNK = 128;  // samples a warp discriminates per step
constexpr int NCHUNK = (SPAN + NUM_TAPS) / CHUNK;  // tile + halo
constexpr int CPW = NCHUNK / WARPS;  // chunks per warp; the last warp
                                     // takes the remainder (the halo)

// The FIR's taps h[k] of the device's last launch.
__constant__ float c_taps[NUM_TAPS];

#ifdef TDOA_TIMELINE
// Over the CTAs of the last launch: the summed ns of the load+discriminate
// phase and of the FIR phase, the number of CTAs, the earliest start and
// the latest end.
__device__ unsigned long long tl_k3[5];
#endif

template <int D>
struct Geo {
  static constexpr int T = SPAN / D;        // outputs per CTA
  static constexpr int TPR = NUM_TAPS / D;  // taps per polyphase row
  static constexpr int ROWS = T + TPR;      // polyphase row length
  // Rows start 16-byte aligned. From D = 8 on, a lane's 4 samples fall
  // into 4 rows of one group q / 4 and a warp's 128 samples into D / 4
  // groups: the pitch is a multiple of 32 floats and group i is skewed
  // by 4 * ((i * 32 / D) mod 8) floats, so that a warp's writes of one
  // element cover 32 banks (D <= 32; 2 lanes a bank at D = 64, 4 at
  // D = 128, where the FIR is 2 and 1 multiply-adds a sample).
  static constexpr int PITCH =
      D >= 8 ? ((ROWS + 28 + 31) / 32) * 32 : ((ROWS + 3) / 4) * 4;
  static constexpr int SMEM = D * PITCH * (int)sizeof(float);
  __host__ __device__ static constexpr int row_off(int q) {
    return q * PITCH +
           (D >= 8 ? 4 * (((q >> 2) * (D < 32 ? 32 / D : 1)) & 7) : 0);
  }
  static_assert(SMEM <= 48 * 1024, "dynamic shared memory above 48 KB");
};

// Four consecutive samples of a row from g on, zero past its end n.
template <bool VEC>
__device__ __forceinline__ float4 load4(const float* __restrict__ p,
                                        long long g, long long n) {
  if (VEC && g + 3 < n) return __ldcs(reinterpret_cast<const float4*>(p + g));
  float4 v;
  v.x = g < n ? p[g] : 0.f;
  v.y = g + 1 < n ? p[g + 1] : 0.f;
  v.z = g + 2 < n ? p[g + 2] : 0.f;
  v.w = g + 3 < n ? p[g + 3] : 0.f;
  return v;
}

// d of sample a after sample b (0 where the sample is outside 0 < g < n).
__device__ __forceinline__ float disc(float ar, float ai, float br, float bi,
                                      bool inside, float inv_dev) {
  const float p_re = ar * br + ai * bi;
  const float p_im = ai * br - ar * bi;
  return inside ? atan2f(p_im, p_re) * inv_dev : 0.f;
}

// d of the tile's samples i .. i+3 (i a multiple of 4) into polyphase
// order.
template <int D>
__device__ __forceinline__ void store_d(float* ds, int i, float4 v) {
  using G = Geo<D>;
  if constexpr (D == 1) {
    *reinterpret_cast<float4*>(ds + i) = v;
  } else if constexpr (D == 2) {
    *reinterpret_cast<float2*>(ds + G::row_off(0) + i / 2) =
        make_float2(v.x, v.z);
    *reinterpret_cast<float2*>(ds + G::row_off(1) + i / 2) =
        make_float2(v.y, v.w);
  } else {
    // Rows q .. q+3 are one group: the same skew.
    float* p = ds + G::row_off(i % D) + i / D;
    p[0] = v.x;
    p[G::PITCH] = v.y;
    p[2 * G::PITCH] = v.z;
    p[3 * G::PITCH] = v.w;
  }
}

// acc[r] += sum_k h[k] * d[(jl + r) * D + k] for the R outputs from jl on
// (jl a multiple of 4): row by row, a window of R + 4 floats that slides
// 4 taps a step. Every index but jl is a compile-time constant.
template <int D>
__device__ __forceinline__ void fir_tile(const float* ds, int jl,
                                         float (&acc)[R]) {
  using G = Geo<D>;
  constexpr int STEP = G::TPR < 4 ? G::TPR : 4;  // taps per window step
#pragma unroll
  for (int q = 0; q < D; ++q) {
    const float4* row =
        reinterpret_cast<const float4*>(ds + G::row_off(q) + jl);
    float w[R + 4];
#pragma unroll
    for (int i = 0; i < R / 4; ++i) {
      const float4 v = row[i];
      w[4 * i] = v.x, w[4 * i + 1] = v.y, w[4 * i + 2] = v.z,
            w[4 * i + 3] = v.w;
    }
#pragma unroll
    for (int m0 = 0; m0 < G::TPR; m0 += STEP) {
      if constexpr (G::TPR > 1) {
        const float4 v = row[R / 4 + m0 / 4];
        w[R] = v.x, w[R + 1] = v.y, w[R + 2] = v.z, w[R + 3] = v.w;
      }
#pragma unroll
      for (int mm = 0; mm < STEP; ++mm) {
#pragma unroll
        for (int r = 0; r < R; ++r)
          acc[r] = fmaf(c_taps[(m0 + mm) * D + q], w[r + mm], acc[r]);
      }
#pragma unroll
      for (int i = 0; i < R; ++i) w[i] = w[i + 4];
    }
  }
}

template <int D, bool VEC>
__global__ void __launch_bounds__(THREADS)
fm_demod_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
                long long chan_stride, long long n, float inv_dev,
                float* __restrict__ out, long long n_out) {
  using G = Geo<D>;
  extern __shared__ float4 smem[];
  float* ds = reinterpret_cast<float*>(smem);  // D rows at G::row_off
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const long long c = blockIdx.y;
  const long long j0 = (long long)blockIdx.x * G::T;
  const long long g0 = j0 * D;
  const float* re = xr + c * chan_stride;
  const float* im = xi + c * chan_stride;
  TDOA_TL(const unsigned long long T0 = tdoa::now_ns();)
  {
    int ch = warp * CPW;
    const int ch_end = warp == WARPS - 1 ? NCHUNK : ch + CPW;
    int i = ch * CHUNK + 4 * lane;  // the lane's first sample in the tile
    long long g = g0 + i;
    // The sample before the chunk, lane 0's look-back.
    float cr = 0.f, ci = 0.f;
    if (lane == 0 && g >= 1 && g - 1 < n) cr = re[g - 1], ci = im[g - 1];
    float4 ar = load4<VEC>(re, g, n), ai = load4<VEC>(im, g, n);
    for (; ch < ch_end; ++ch, i += CHUNK, g += CHUNK) {
      float4 nr = ar, ni = ai;
      if (ch + 1 < ch_end) {
        nr = load4<VEC>(re, g + CHUNK, n);
        ni = load4<VEC>(im, g + CHUNK, n);
      }
      float br = __shfl_up_sync(0xffffffffu, ar.w, 1);
      float bi = __shfl_up_sync(0xffffffffu, ai.w, 1);
      if (lane == 0) br = cr, bi = ci;
      cr = __shfl_sync(0xffffffffu, ar.w, 31);
      ci = __shfl_sync(0xffffffffu, ai.w, 31);
      float4 v;
      v.x = disc(ar.x, ai.x, br, bi, g >= 1 && g < n, inv_dev);
      v.y = disc(ar.y, ai.y, ar.x, ai.x, g + 1 < n, inv_dev);
      v.z = disc(ar.z, ai.z, ar.y, ai.y, g + 2 < n, inv_dev);
      v.w = disc(ar.w, ai.w, ar.z, ai.z, g + 3 < n, inv_dev);
      store_d<D>(ds, i, v);
      ar = nr, ai = ni;
    }
  }
  __syncthreads();
  TDOA_TL(const unsigned long long T1 = tdoa::now_ns();)
#pragma unroll 1
  for (int jl = t * R; jl < G::T; jl += THREADS * R) {
    const long long j = j0 + jl;
    if (j >= n_out) break;
    float acc[R] = {};
    fir_tile<D>(ds, jl, acc);
    float* o = out + c * n_out + j;
    if (j + R <= n_out && (reinterpret_cast<uintptr_t>(o) & 15) == 0) {
      *reinterpret_cast<float4*>(o) =
          make_float4(acc[0], acc[1], acc[2], acc[3]);
    } else {
#pragma unroll
      for (int r = 0; r < R; ++r)
        if (j + r < n_out) o[r] = acc[r];
    }
  }
  TDOA_TL(__syncthreads();
          if (t == 0) {
            const unsigned long long T2 = tdoa::now_ns();
            atomicAdd(&tl_k3[0], T1 - T0);
            atomicAdd(&tl_k3[1], T2 - T1);
            atomicAdd(&tl_k3[2], 1ull);
            atomicMin(&tl_k3[3], T0);
            atomicMax(&tl_k3[4], T2);
          })
}

template <int D>
int launch(const float* xr, const float* xi, long long chan_stride, int C,
           long long n, float inv_dev, bool vec, float* out,
           cudaStream_t s) {
  using G = Geo<D>;
  static_assert(R == 4 && G::T % R == 0, "the FIR's tile is one float4");
  const long long n_out = n / D;
  const dim3 grid((unsigned)((n_out + G::T - 1) / G::T), (unsigned)C);
  TDOA_TL(static const unsigned long long init[5] = {0, 0, 0, ~0ull, 0};
          cudaMemcpyToSymbolAsync(tl_k3, init, sizeof(init), 0,
                                  cudaMemcpyHostToDevice, s);)
  if (vec)
    fm_demod_kernel<D, true><<<grid, THREADS, G::SMEM, s>>>(
        xr, xi, chan_stride, n, inv_dev, out, n_out);
  else
    fm_demod_kernel<D, false><<<grid, THREADS, G::SMEM, s>>>(
        xr, xi, chan_stride, n, inv_dev, out, n_out);
  return (int)cudaGetLastError();
}

// What a device's constant-memory taps hold, and where its last launch
// went.
struct TapsState {
  int dev;
  bool set;
  double sample_rate;
  int decim;
  cudaStream_t stream;
  cudaEvent_t done;  // recorded after the last launch
};

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

// Audio out [C, n / decim] (f32, row-major) of planar f32 IQ rows xr, xi
// (channel c at offset c * chan_stride) on `stream`. taps: the 128 f32
// FIR taps of (sample_rate, decim) in host memory, read only when that
// pair differs from the device's previous launch. rows_aligned: every
// row of xr and xi starts on a 16-byte boundary (the 16-byte load path;
// 0 takes scalar loads). Returns 0 or the refused launch's cudaError_t
// (cudaErrorInvalidValue for a decim that does not divide 128,
// cudaErrorMisalignedAddress for rows_aligned on rows that are not).
extern "C" int tdoa_fm_demod(const void* xr, const void* xi,
                             long long chan_stride, int C, long long n,
                             int decim, double sample_rate, float inv_dev,
                             const float* taps, int rows_aligned, void* out,
                             void* stream) {
  static std::mutex mu;
  static std::vector<TapsState> states;
  const float* r = static_cast<const float*>(xr);
  const float* i = static_cast<const float*>(xi);
  float* y = static_cast<float*>(out);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const bool vec = rows_aligned != 0;
  if (decim < 1 || NUM_TAPS % decim != 0) return (int)cudaErrorInvalidValue;
  if (vec && !(aligned16(r) && aligned16(i) &&
               (C == 1 || chan_stride % 4 == 0)))
    return (int)cudaErrorMisalignedAddress;
  int dev;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  std::lock_guard<std::mutex> lock(mu);
  TapsState* st = nullptr;
  for (TapsState& c : states)
    if (c.dev == dev) st = &c;
  if (st == nullptr) {
    cudaEvent_t done;
    e = cudaEventCreateWithFlags(&done, cudaEventDisableTiming);
    if (e != cudaSuccess) return (int)e;
    states.push_back(TapsState{dev, false, 0.0, 0, nullptr, done});
    st = &states.back();
  }
  // A launch on another stream than the last waits for it: for its
  // kernel's reads of the taps and for the copy that set them.
  if (st->set && st->stream != s) {
    e = cudaStreamWaitEvent(s, st->done, 0);
    if (e != cudaSuccess) return (int)e;
  }
  if (!st->set || st->sample_rate != sample_rate || st->decim != decim) {
    st->set = false;
    e = cudaMemcpyToSymbolAsync(c_taps, taps, sizeof(c_taps), 0,
                                cudaMemcpyHostToDevice, s);
    if (e != cudaSuccess) return (int)e;
    st->set = true;
    st->sample_rate = sample_rate;
    st->decim = decim;
  }
  int err;
  switch (decim) {
    case 1: err = launch<1>(r, i, chan_stride, C, n, inv_dev, vec, y, s); break;
    case 2: err = launch<2>(r, i, chan_stride, C, n, inv_dev, vec, y, s); break;
    case 4: err = launch<4>(r, i, chan_stride, C, n, inv_dev, vec, y, s); break;
    case 8: err = launch<8>(r, i, chan_stride, C, n, inv_dev, vec, y, s); break;
    case 16: err = launch<16>(r, i, chan_stride, C, n, inv_dev, vec, y, s); break;
    case 32: err = launch<32>(r, i, chan_stride, C, n, inv_dev, vec, y, s); break;
    case 64: err = launch<64>(r, i, chan_stride, C, n, inv_dev, vec, y, s); break;
    default: err = launch<128>(r, i, chan_stride, C, n, inv_dev, vec, y, s); break;
  }
  st->stream = s;
  e = cudaEventRecord(st->done, s);
  if (err != 0) return err;
  return (int)e;
}

#ifdef TDOA_TIMELINE
// The last launch's stamps, tl_k3 as laid out above.
extern "C" int tdoa_fm_demod_timeline(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, tl_k3, sizeof(tl_k3));
}
#endif
