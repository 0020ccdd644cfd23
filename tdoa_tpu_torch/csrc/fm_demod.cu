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
// work per sample is one complex product, one atan2 and 128/D FIR
// multiply-adds (16 at D = 8). At the main path's 9 channels x 20 M
// samples, D = 8: 1.44 GB read + 90 MB written, ~0.46 ms at 3.35 TB/s,
// against ~11 GFLOP, ~0.16 ms at 67 TFLOP/s f32: memory-bound.
//
// What the design does about it. The TPU kernel's workarounds are gone:
// accurate atan2f (no polynomial; the build uses no fast-math), no
// 128-lane row layout, no (128, 128/D) tap matrices, no halo array. One
// launch covers every channel: grid (output tile, channel). A CTA
// computes d over its span of SPAN input samples plus the 127-sample
// halo straight from coalesced loads of x[g] and x[g-1] (the look-back
// is the neighbour's load, served by L1), and stores it in shared memory
// in polyphase order, ds[q][m] = d[g0 + m*D + q], so that the FIR's reads
// (thread = output, tap k -> ds[k % D][j + k / D]) are consecutive across
// a warp and the row pitch keeps the polyphase writes free of bank
// conflicts. The taps sit in shared memory and are read as broadcasts.
// The decimation D is a template parameter, so the tap loop unrolls with
// constant offsets; the sum runs over k in order, as the plain version's.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int SPAN = 8192;  // input samples per CTA
constexpr int NUM_TAPS = 128;

template <int D>
struct Geo {
  static constexpr int T = SPAN / D;         // outputs per CTA
  static constexpr int ROWS = T + NUM_TAPS / D;  // polyphase row length
  // Pitch = 32/D (mod 32) below D = 32, odd above: a warp's 32
  // consecutive samples then land in 32 distinct banks.
  static constexpr int PITCH =
      D < 32 ? ((ROWS + 31) / 32) * 32 + (32 / D) % 32 : (ROWS | 1);
  static constexpr int SMEM = (NUM_TAPS + D * PITCH) * (int)sizeof(float);
};

template <int D>
__global__ void __launch_bounds__(THREADS)
fm_demod_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
                long long chan_stride, long long n, float inv_dev,
                const float* __restrict__ taps, float* __restrict__ out,
                long long n_out) {
  using G = Geo<D>;
  extern __shared__ float smem[];
  float* hs = smem;             // [NUM_TAPS]
  float* ds = smem + NUM_TAPS;  // [D][PITCH]
  const int t = threadIdx.x;
  const long long c = blockIdx.y;
  const long long j0 = (long long)blockIdx.x * G::T;
  const long long g0 = j0 * D;
  const float* re = xr + c * chan_stride;
  const float* im = xi + c * chan_stride;
  for (int k = t; k < NUM_TAPS; k += THREADS) hs[k] = taps[k];
  for (int i = t; i < SPAN + NUM_TAPS; i += THREADS) {
    const long long g = g0 + i;
    float v = 0.f;
    if (g >= 1 && g < n) {
      const float ar = re[g], ai = im[g], br = re[g - 1], bi = im[g - 1];
      const float p_re = ar * br + ai * bi;
      const float p_im = ai * br - ar * bi;
      v = atan2f(p_im, p_re) * inv_dev;
    }
    ds[(i % D) * G::PITCH + i / D] = v;
  }
  __syncthreads();
  for (int jl = t; jl < G::T; jl += THREADS) {
    const long long j = j0 + jl;
    if (j >= n_out) break;
    float acc = 0.f;
#pragma unroll
    for (int k = 0; k < NUM_TAPS; ++k)
      acc = fmaf(hs[k], ds[(k % D) * G::PITCH + jl + k / D], acc);
    out[c * n_out + j] = acc;
  }
}

template <int D>
int launch(const float* xr, const float* xi, long long chan_stride, int C,
           long long n, float inv_dev, const float* taps, float* out,
           cudaStream_t s) {
  using G = Geo<D>;
  const long long n_out = n / D;
  const dim3 grid((unsigned)((n_out + G::T - 1) / G::T), (unsigned)C);
  fm_demod_kernel<D><<<grid, THREADS, G::SMEM, s>>>(
      xr, xi, chan_stride, n, inv_dev, taps, out, n_out);
  return (int)cudaGetLastError();
}

}  // namespace

// Audio out [C, n / decim] (f32, row-major) of planar f32 IQ rows xr, xi
// (channel c at offset c * chan_stride) on `stream`; taps [128] f32 on the
// device. Returns 0 or the refused launch's cudaError_t
// (cudaErrorInvalidValue for a decim that does not divide 128).
extern "C" int tdoa_fm_demod(const void* xr, const void* xi,
                             long long chan_stride, int C, long long n,
                             int decim, float inv_dev, const void* taps,
                             void* out, void* stream) {
  const float* r = static_cast<const float*>(xr);
  const float* i = static_cast<const float*>(xi);
  const float* h = static_cast<const float*>(taps);
  float* y = static_cast<float*>(out);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  switch (decim) {
    case 1: return launch<1>(r, i, chan_stride, C, n, inv_dev, h, y, s);
    case 2: return launch<2>(r, i, chan_stride, C, n, inv_dev, h, y, s);
    case 4: return launch<4>(r, i, chan_stride, C, n, inv_dev, h, y, s);
    case 8: return launch<8>(r, i, chan_stride, C, n, inv_dev, h, y, s);
    case 16: return launch<16>(r, i, chan_stride, C, n, inv_dev, h, y, s);
    case 32: return launch<32>(r, i, chan_stride, C, n, inv_dev, h, y, s);
    case 64: return launch<64>(r, i, chan_stride, C, n, inv_dev, h, y, s);
    case 128: return launch<128>(r, i, chan_stride, C, n, inv_dev, h, y, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
