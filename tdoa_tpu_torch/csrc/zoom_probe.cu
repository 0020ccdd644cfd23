// Kernel 2 of the IQ main path: leave-one-out Hannan-Thomson weighting +
// integer deramp + 33-lag zoom DFT (the split-sigma probe), hand-written
// CUDA C++ for Hopper (sm_90a).
//
// Replaces: tdoa_tpu/ops/pallas/zoom_probe.py, _kernel via
// loo_zoom_windows_pallas / loo_zoom_delays_pallas.
//
// What it computes, for every probe row r = (bank k, pair p = (i, j)) of
// the K*m rows and every frequency bin f < F:
//   LOO sums over the OTHER banks: C = sum_{k' != k} cross[k', p],
//   S_ii, S_jj likewise over max(psd, 0);
//   |C|, den = sqrt(S_ii)*sqrt(S_jj), their row means over F;
//   the HT weight from the LOO coherence, debiased by the LOO segment
//   count, WITHOUT the per-row max normalisation (argmax-invariant);
//   the bank's own cross-spectrum times that weight, deramped by the
//   integer coarse delay d with the exact residue (f*d) mod F, computed
//   in UNSIGNED 32-bit arithmetic (equal to the reference's two's-
//   complement int32 product, without signed-overflow UB);
//   the zoom window  Z[r, delta] = sum_f deramped[r, f] *
//   exp(+i*2*pi*k_signed(f)*delta/F),  delta in [-16, 16].
//
// What bounds it on the H100. The inputs (K*m cross rows + K*n_st PSD
// rows, 65536 bins each) are a few MB and are read twice; the cost is
// the elementwise weight chain and the 33 basis angles per bin
// (accurate sincosf: the basis angle reaches ~50 rad, where the fast
// __sinf is wrong, so the build uses no fast-math).
//
// What the design does about it. The TPU kernel's 0/1 selector matmuls
// become direct sums over the other banks. Row means over F and the
// zoom sums over F are reductions across CTAs, done deterministically
// with per-(row, tile) partials and a second small pass instead of
// atomics:
//   pass 0   (one CTA per 128-bin tile): partial sums of |C| and den;
//   means    (one thread per row): row means in a fixed order;
//   pass 1   (one CTA per tile): weight, deramp, and the tile's partial
//            zoom window, with the tile's 33 basis columns computed
//            once in shared memory and shared by all rows;
//   zoom     (one thread per (row, delta)): sum of the tile partials.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 128;  // bins per CTA = threads per CTA
constexpr int HALF_WIDTH = 16;
constexpr int W = 2 * HALF_WIDTH + 1;
constexpr int RB = 8;  // probe rows per shared-memory pass in pass 1
constexpr float TWO_PI = 6.28318530717958647692f;

struct LooBin {
  float mag, den;
};

// LOO magnitude and coherence denominator of row r at bin f.
__device__ __forceinline__ LooBin loo_bin(const float2* __restrict__ cross,
                                          const float* __restrict__ psd,
                                          const int* __restrict__ pairs,
                                          int K, int m, int n_st, int F,
                                          int r, int f) {
  const int k = r / m, p = r % m;
  const int i = pairs[2 * p], j = pairs[2 * p + 1];
  float lre = 0.f, lim = 0.f, saa = 0.f, sbb = 0.f;
  for (int kk = 0; kk < K; ++kk) {
    if (kk == k) continue;
    const float2 c = cross[((long long)kk * m + p) * F + f];
    lre += c.x;
    lim += c.y;
    saa += fmaxf(psd[((long long)kk * n_st + i) * F + f], 0.f);
    sbb += fmaxf(psd[((long long)kk * n_st + j) * F + f], 0.f);
  }
  LooBin out;
  out.mag = sqrtf(lre * lre + lim * lim);
  out.den = sqrtf(saa) * sqrtf(sbb);
  return out;
}

__device__ __forceinline__ float block_sum(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float s = 0.f;
  if (threadIdx.x == 0) {
    for (int w = 0; w < TILE / 32; ++w) s += red[w];
  }
  return s;  // valid in thread 0
}

// grid = F / TILE; part[(r * n_tiles + tile) * 2 + {0: |C|, 1: den}].
__global__ void __launch_bounds__(TILE)
pass0_kernel(const float2* __restrict__ cross, const float* __restrict__ psd,
             const int* __restrict__ pairs, int K, int m, int n_st, int F,
             float* __restrict__ part) {
  __shared__ float red[TILE / 32];
  const int tile = blockIdx.x, n_tiles = gridDim.x;
  const int f = tile * TILE + threadIdx.x;
  for (int r = 0; r < K * m; ++r) {
    const LooBin lb = loo_bin(cross, psd, pairs, K, m, n_st, F, r, f);
    const float sm = block_sum(lb.mag, red);
    const float sd = block_sum(lb.den, red);
    if (threadIdx.x == 0) {
      part[((long long)r * n_tiles + tile) * 2 + 0] = sm;
      part[((long long)r * n_tiles + tile) * 2 + 1] = sd;
    }
  }
}

// One thread per row: means[r * 2 + {0, 1}] = row sums / F.
__global__ void means_kernel(const float* __restrict__ part, int rows,
                             int n_tiles, int F, float* __restrict__ means) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= rows) return;
  float sm = 0.f, sd = 0.f;
  for (int t = 0; t < n_tiles; ++t) {
    sm += part[((long long)r * n_tiles + t) * 2 + 0];
    sd += part[((long long)r * n_tiles + t) * 2 + 1];
  }
  const float inv_f = 1.0f / (float)F;
  means[2 * r + 0] = sm * inv_f;
  means[2 * r + 1] = sd * inv_f;
}

// grid = F / TILE; zpart[(r * n_tiles + tile) * W + delta].
__global__ void __launch_bounds__(TILE)
pass1_kernel(const float2* __restrict__ cross, const float* __restrict__ psd,
             const int* __restrict__ pairs, const int* __restrict__ coarse,
             const float* __restrict__ nseg, int K, int m, int n_st, int F,
             float eps, const float* __restrict__ means,
             float2* __restrict__ zpart) {
  __shared__ float2 basis[W][TILE];
  __shared__ float2 dsp[RB][TILE];
  const int t = threadIdx.x, tile = blockIdx.x, n_tiles = gridDim.x;
  const int f = tile * TILE + t;
  const float step = TWO_PI / (float)F;
  // Zoom basis exp(+i*2*pi*k_signed*delta/F), in the reference's f32
  // operation order: (k_signed * (2*pi/F)) * delta.
  const float k_signed = (float)(f < F / 2 ? f : f - F);
  for (int d = 0; d < W; ++d) {
    float sn, cs;
    sincosf((k_signed * step) * (float)(d - HALF_WIDTH), &sn, &cs);
    basis[d][t] = make_float2(cs, sn);
  }
  const int KM = K * m;
  for (int r0 = 0; r0 < KM; r0 += RB) {
    const int rows = min(RB, KM - r0);
    for (int rr = 0; rr < rows; ++rr) {
      const int r = r0 + rr;
      const LooBin lb = loo_bin(cross, psd, pairs, K, m, n_st, F, r, f);
      const float mean_mag = means[2 * r + 0], mean_den = means[2 * r + 1];
      const float gamma = lb.mag / fmaxf(lb.den, 1e-30f);
      float g2 = fminf(fmaxf(gamma * gamma, 0.f), 0.98f);
      const float s = nseg[r];
      const float bias = s > 1.f ? 1.f / fmaxf(s, 1.f) : 0.f;
      g2 = fminf(fmaxf((g2 - bias) / fmaxf(1.f - bias, 1e-6f), 0.f), 0.98f);
      float snr_w = g2 / (1.f - g2);
      if (!(lb.den > 1e-9f * mean_den)) snr_w = 0.f;
      const float d_w = lb.mag + eps * mean_mag + 1e-30f;
      const float w = snr_w / d_w;
      const float2 c = cross[(long long)r * F + f];  // bank k's own pair p
      const float wre = c.x * w, wim = c.y * w;
      const uint32_t frac =
          ((uint32_t)f * (uint32_t)coarse[r % m]) & (uint32_t)(F - 1);
      float sn, cs;
      sincosf((float)frac * step, &sn, &cs);
      dsp[rr][t] = make_float2(wre * cs - wim * sn, wre * sn + wim * cs);
    }
    __syncthreads();
    for (int o = t; o < rows * W; o += TILE) {
      const int rr = o / W, d = o % W;
      float are = 0.f, aim = 0.f;
      for (int ff = 0; ff < TILE; ++ff) {
        const float2 x = dsp[rr][ff], e = basis[d][ff];
        are += x.x * e.x - x.y * e.y;
        aim += x.x * e.y + x.y * e.x;
      }
      zpart[((long long)(r0 + rr) * n_tiles + tile) * W + d] =
          make_float2(are, aim);
    }
    __syncthreads();
  }
}

// One thread per (row, delta): out[r * W + delta] = sum over tiles.
__global__ void zoom_kernel(const float2* __restrict__ zpart, int rows,
                            int n_tiles, float2* __restrict__ out) {
  const int o = blockIdx.x * blockDim.x + threadIdx.x;
  if (o >= rows * W) return;
  const int r = o / W, d = o % W;
  float are = 0.f, aim = 0.f;
  for (int t = 0; t < n_tiles; ++t) {
    const float2 v = zpart[((long long)r * n_tiles + t) * W + d];
    are += v.x;
    aim += v.y;
  }
  out[o] = make_float2(are, aim);
}

}  // namespace

// Zoom windows [K*m, W] (complex, float2) of every LOO-weighted probe on
// `stream`. Scratch: part [K*m, F/TILE, 2] f32, means [K*m, 2] f32,
// zpart [K*m, F/TILE, W] float2. Returns 0 or the first refused launch's
// cudaError_t.
extern "C" int tdoa_zoom_probe(const void* cross, const void* psd,
                               const int* pairs, const int* coarse,
                               const float* nseg, int K, int m, int n_st,
                               int F, float eps, void* part, void* means,
                               void* zpart, void* out, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int n_tiles = F / TILE, KM = K * m;
  pass0_kernel<<<n_tiles, TILE, 0, s>>>(
      static_cast<const float2*>(cross), static_cast<const float*>(psd),
      pairs, K, m, n_st, F, static_cast<float*>(part));
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  means_kernel<<<(KM + 127) / 128, 128, 0, s>>>(
      static_cast<const float*>(part), KM, n_tiles, F,
      static_cast<float*>(means));
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  pass1_kernel<<<n_tiles, TILE, 0, s>>>(
      static_cast<const float2*>(cross), static_cast<const float*>(psd),
      pairs, coarse, nseg, K, m, n_st, F, eps,
      static_cast<const float*>(means), static_cast<float2*>(zpart));
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  zoom_kernel<<<(KM * W + 127) / 128, 128, 0, s>>>(
      static_cast<const float2*>(zpart), KM, n_tiles,
      static_cast<float2*>(out));
  e = cudaGetLastError();
  return (int)e;
}
