// Kernel 1 of the IQ main path: segment FFT + cross-spectra + banked
// accumulation, hand-written for Hopper (sm_90a).
//
// Replaces: tdoa_tpu/ops/pallas/corr_accum.py, _kernel via
// accumulate_cross_spectra_pallas (the TPU kernel's pallas_call).
//
// What it computes. Each 45056-sample segment of every station, zero-
// padded to 65536, is transformed with a four-step 256 x 256 FFT:
//   sample n = 256*r + c (row r < 176 holds data, rows 176..255 are
//   the zero padding), true frequency k = k1 + 256*k2;
//   stage 1: 256-point FFT down each column c over the rows r -> A[k1, c],
//            times the twiddle exp(-2*pi*i*k1*c/65536);
//   stage 2: 256-point FFT along each row k1 over c -> X[k1 + 256*k2].
// Over the segments of each bank (n_banks contiguous groups, the first
// n_seg % n_banks one segment longer), it accumulates per pair
// X_j * conj(X_i), per station |X|^2 and, when track_sums is set, per
// station X. Outputs are written once per chunk, in TRUE frequency order.
//
// What bounds it on the H100. At 3 stations the work per segment and
// station is ~5 MFLOP of FFT against 90 KB of bf16 input; the floor is
// moving the stage-1 spectra through device memory (512 KB per
// station-segment, written once and read once: 1.36 GB per 10 s
// 3-station block, 0.41 ms at 3.35 TB/s). This first version takes
// ~3.1 ms per block, three quarters of it in stage 2, whose CTAs do
// little work between barriers (3 x 128 butterflies per stage over
// 256 threads) and only 256 CTAs per bank are in flight. The tensor
// cores are not used. The TPU design kept every accumulator resident in
// ~100 MB of VMEM across the whole grid; that does not fit the 227 KB
// of shared memory one CTA may hold.
//
// What the design does about it.
//  * Stage 1 runs one CTA per (station, segment, 16-column tile) over a
//    CHUNK of segments and writes the twiddled spectra to a device
//    scratch sized for the chunk, not for the block.
//  * Stage 2 runs one CTA per (k1 row, bank). It owns the 256 output
//    bins k1 + 256*k2 of its bank, loops over that bank's segments in
//    the chunk, and keeps all of its bins' accumulators in shared
//    memory: no atomics, a fixed summation order, deterministic output.
//    Accumulators cross chunk boundaries through the output arrays.
//  * All arithmetic is f32 (inputs may be bf16), twiddles come from
//    sincospif on exactly representable arguments.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int R = 256;
constexpr int SEG_ROWS = 176;
constexpr int FFT_LEN = R * R;
constexpr int SEG_LEN = SEG_ROWS * R;
constexpr int TC = 16;        // stage-1 columns per CTA
constexpr int THREADS = 256;  // both stages

__device__ __forceinline__ int brev8(int v) { return (int)(__brev((unsigned)v) >> 24); }

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

__device__ __forceinline__ float load_f(const float* p, long long o) { return p[o]; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p, long long o) {
  return __bfloat162float(p[o]);
}

// tw[e] = exp(-2*pi*i*e/256), e < 128.
__device__ __forceinline__ void fill_twiddles(float2* tw) {
  for (int e = threadIdx.x; e < R / 2; e += blockDim.x) {
    float s, c;
    sincospif(-(float)e / 128.0f, &s, &c);
    tw[e] = make_float2(c, s);
  }
}

// One radix-2 decimation-in-time stage on element pair (i, j) of a
// bit-reversed 256-point sequence: pos is the butterfly's offset in its
// group of 2*half.
__device__ __forceinline__ void butterfly(float2* a, float2* b, float2 w) {
  float2 u = *a, v = cmul(*b, w);
  *a = make_float2(u.x + v.x, u.y + v.y);
  *b = make_float2(u.x - v.x, u.y - v.y);
}

// Stage 1. grid = (R / TC column tiles, segments in the chunk, n_st).
template <typename T>
__global__ void __launch_bounds__(THREADS)
stage1_kernel(const T* __restrict__ xr, const T* __restrict__ xi,
              long long st_stride, int seg0, int chunk,
              float2* __restrict__ scratch) {
  __shared__ float2 buf[R][TC];
  __shared__ float2 tw[R / 2];
  const int c0 = blockIdx.x * TC;
  const int s_local = blockIdx.y;
  const int st = blockIdx.z;
  const long long base =
      (long long)st * st_stride + (long long)(seg0 + s_local) * SEG_LEN;
  fill_twiddles(tw);
  for (int idx = threadIdx.x; idx < R * TC; idx += THREADS) {
    const int r = idx / TC, col = idx % TC;
    float2 v = make_float2(0.f, 0.f);
    if (r < SEG_ROWS) {
      const long long o = base + (long long)r * R + c0 + col;
      v = make_float2(load_f(xr, o), load_f(xi, o));
    }
    buf[brev8(r)][col] = v;
  }
  __syncthreads();
  for (int s = 0; s < 8; ++s) {
    const int half = 1 << s;
    for (int b = threadIdx.x; b < (R / 2) * TC; b += THREADS) {
      const int col = b % TC, bb = b / TC;
      const int pos = bb & (half - 1);
      const int i = ((bb >> s) << (s + 1)) + pos;
      butterfly(&buf[i][col], &buf[i + half][col], tw[pos << (7 - s)]);
    }
    __syncthreads();
  }
  float2* out = scratch + ((long long)st * chunk + s_local) * FFT_LEN;
  for (int idx = threadIdx.x; idx < R * TC; idx += THREADS) {
    const int k1 = idx / TC, col = idx % TC, c = c0 + col;
    float sn, cs;
    sincospif(-(float)(k1 * c) / 32768.0f, &sn, &cs);
    out[k1 * R + c] = cmul(buf[k1][col], make_float2(cs, sn));
  }
}

// Shared-memory layout of a stage-2 CTA (floats):
//   twiddles [R/2] float2 | rows [n_st][R] float2 |
//   accumulators [n_slots][R] | pairs [2m] int
// slots: cross re/im for each pair (2m), psd (n_st), sums re/im (2 n_st).
__host__ __device__ inline int n_slots(int n_st, int m, int track) {
  return 2 * m + n_st * (track ? 3 : 1);
}

__host__ __device__ inline int stage2_smem(int n_st, int m, int track) {
  return (R / 2) * 8 + n_st * R * 8 + n_slots(n_st, m, track) * R * 4 +
         2 * m * 4;
}

// Stage 2. grid = (R rows k1, n_banks). Segments [c0, c1) are in scratch.
__global__ void __launch_bounds__(THREADS)
stage2_kernel(const float2* __restrict__ scratch, int chunk, int c0, int c1,
              int n_st, const int* __restrict__ pairs, int m, int n_seg,
              int n_banks, int track, float2* __restrict__ cross,
              float* __restrict__ psd, float2* __restrict__ sums) {
  extern __shared__ float4 smem_raw[];
  float2* tw = reinterpret_cast<float2*>(smem_raw);
  float2* rows = tw + R / 2;
  float* acc = reinterpret_cast<float*>(rows + n_st * R);
  int* pr = reinterpret_cast<int*>(acc + n_slots(n_st, m, track) * R);

  const int k1 = blockIdx.x, b = blockIdx.y, t = threadIdx.x;
  const int q = n_seg / n_banks, rem = n_seg % n_banks;
  const int bs = b * q + min(b, rem);
  const int be = bs + q + (b < rem ? 1 : 0);
  const int lo = max(bs, c0), hi = min(be, c1);
  if (lo >= hi) return;  // this bank has no segment in the chunk

  fill_twiddles(tw);
  for (int e = t; e < 2 * m; e += THREADS) pr[e] = pairs[e];
  const long long F = FFT_LEN;
  const long long bin = k1 + (long long)R * t;  // true frequency of bin t
  float* a_cr = acc;
  float* a_ci = acc + m * R;
  float* a_psd = acc + 2 * m * R;
  float* a_sr = a_psd + n_st * R;
  float* a_si = a_sr + n_st * R;
  if (lo == bs) {
    for (int s = 0; s < n_slots(n_st, m, track); ++s) acc[s * R + t] = 0.f;
  } else {
    for (int p = 0; p < m; ++p) {
      const float2 v = cross[((long long)b * m + p) * F + bin];
      a_cr[p * R + t] = v.x;
      a_ci[p * R + t] = v.y;
    }
    for (int st = 0; st < n_st; ++st) {
      a_psd[st * R + t] = psd[((long long)b * n_st + st) * F + bin];
      if (track) {
        const float2 v = sums[((long long)b * n_st + st) * F + bin];
        a_sr[st * R + t] = v.x;
        a_si[st * R + t] = v.y;
      }
    }
  }
  __syncthreads();

  for (int seg = lo; seg < hi; ++seg) {
    for (int st = 0; st < n_st; ++st) {
      rows[st * R + brev8(t)] =
          scratch[((long long)st * chunk + (seg - c0)) * F + k1 * R + t];
    }
    __syncthreads();
    for (int s = 0; s < 8; ++s) {
      const int half = 1 << s;
      for (int b2 = t; b2 < n_st * (R / 2); b2 += THREADS) {
        const int st = b2 >> 7, bb = b2 & 127;
        const int pos = bb & (half - 1);
        const int i = ((bb >> s) << (s + 1)) + pos;
        butterfly(&rows[st * R + i], &rows[st * R + i + half],
                  tw[pos << (7 - s)]);
      }
      __syncthreads();
    }
    for (int st = 0; st < n_st; ++st) {
      const float2 x = rows[st * R + t];
      a_psd[st * R + t] += x.x * x.x + x.y * x.y;
      if (track) {
        a_sr[st * R + t] += x.x;
        a_si[st * R + t] += x.y;
      }
    }
    for (int p = 0; p < m; ++p) {
      const float2 xi = rows[pr[2 * p] * R + t];
      const float2 xj = rows[pr[2 * p + 1] * R + t];
      a_cr[p * R + t] += xj.x * xi.x + xj.y * xi.y;
      a_ci[p * R + t] += xj.y * xi.x - xj.x * xi.y;
    }
    __syncthreads();  // rows are reloaded by the next segment
  }

  for (int p = 0; p < m; ++p) {
    cross[((long long)b * m + p) * F + bin] =
        make_float2(a_cr[p * R + t], a_ci[p * R + t]);
  }
  for (int st = 0; st < n_st; ++st) {
    psd[((long long)b * n_st + st) * F + bin] = a_psd[st * R + t];
    if (track) {
      sums[((long long)b * n_st + st) * F + bin] =
          make_float2(a_sr[st * R + t], a_si[st * R + t]);
    }
  }
}

}  // namespace

extern "C" int tdoa_corr_accum_smem_bytes(int n_st, int m, int track) {
  return stage2_smem(n_st, m, track);
}

// Accumulate all chunks of one capture on `stream`. Returns 0 or the
// first cudaError_t of a refused launch.
extern "C" int tdoa_corr_accum(const void* xr, const void* xi, int is_bf16,
                               long long st_stride, int n_st, int n_seg,
                               const int* pairs, int m, int n_banks,
                               int track, void* scratch, int chunk,
                               void* cross, void* psd, void* sums,
                               void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int smem = stage2_smem(n_st, m, track);
  cudaError_t e = cudaFuncSetAttribute(
      stage2_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  for (int c0 = 0; c0 < n_seg; c0 += chunk) {
    const int c1 = c0 + chunk < n_seg ? c0 + chunk : n_seg;
    const dim3 g1(R / TC, c1 - c0, n_st);
    if (is_bf16) {
      stage1_kernel<__nv_bfloat16><<<g1, THREADS, 0, s>>>(
          static_cast<const __nv_bfloat16*>(xr),
          static_cast<const __nv_bfloat16*>(xi), st_stride, c0, chunk,
          static_cast<float2*>(scratch));
    } else {
      stage1_kernel<float><<<g1, THREADS, 0, s>>>(
          static_cast<const float*>(xr), static_cast<const float*>(xi),
          st_stride, c0, chunk, static_cast<float2*>(scratch));
    }
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    const dim3 g2(R, n_banks);
    stage2_kernel<<<g2, THREADS, smem, s>>>(
        static_cast<const float2*>(scratch), chunk, c0, c1, n_st, pairs, m,
        n_seg, n_banks, track, static_cast<float2*>(cross),
        static_cast<float*>(psd), static_cast<float2*>(sums));
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}
