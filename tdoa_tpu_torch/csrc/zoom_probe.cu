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
// What bounds it on the H100. At K = 4, m = 3, F = 65536 the inputs are
// 9.4 MB (2.8 us at 3.35 TB/s, and they come from L2 after kernel 1)
// and the work 0.24 GFLOP (3.6 us at 67 TFLOP/s), most of it the 33-lag
// DFT. The first port took 0.2 ms in four launches: two reductions
// across its 512 tiles ran as serial chains (one thread per row, one per
// (row, lag)), and every bin computed 33 basis angles with the accurate
// sincosf at arguments up to ~50 rad (the slow range reduction).
//
// What this design does about it. One cooperative launch, three phases
// separated by grid-wide barriers; every reduction is a warp's
// lane-strided sum followed by a fixed shuffle tree or a transpose
// through shared memory, so the result does not depend on scheduling:
//   phase 0  a warp per (row, 256-bin chunk): per bin the LOO |C| and
//            den and the bank's own cross-spectrum deramped, into a
//            per-bin scratch, and the chunk's sums of |C| and den; a
//            lane's 8 bins go in one batch of loads per other bank;
//   phase 1  a warp per (row, chunk): the row means from the chunk sums
//            (every warp of a row sums them in the same order), the
//            weight of its bins, and the chunk's 33-lag window summed in
//            registers, then across the warp;
//   phase 2  a warp per (row, lag): the sum over the chunks.
// The K rows of one pair and chunk are neighbouring warps, so the LOO
// reads of the other banks hit L1. Angles are exact residues: the
// deramp is sincospif(2 (f d mod F) / F) and the basis sincospif(2
// k_signed / F) for lag 1, the other lags by the complex recurrence
// b_{n+1} = b_n b_1 from there (negative lags are the conjugates). Its
// error after 16 steps is at most ~16 roundings, 2e-6 relative: below
// the plain version's own f32 angle rounding (~3e-6 rad at 50 rad).

#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>
#include <vector>

#include "grid_sync.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int CHUNK = 256;  // bins per warp item (fewer when F < CHUNK)
constexpr int HALF_WIDTH = 16;
constexpr int W = 2 * HALF_WIDTH + 1;
constexpr int RED = 2 * W + 1;  // a lane's row in the transpose (padded)
constexpr int BPL = CHUNK / 32;  // bins a lane takes of an item

#ifdef TDOA_TIMELINE
// CTA 0's start, end of phase 0, of barrier 1, of phase 1, of barrier 2
// and of phase 2.
__device__ unsigned long long tl_k2[6];
#endif

struct Params {
  const float2* cross;  // [K, m, F]
  const float* psd;     // [K, n_st, F]
  const int* pairs;     // [m, 2]
  const float* coarse;  // [m] coarse delays, rounded here (half to even)
  const float* nseg;    // [K*m] LOO segment counts
  int K, m, n_st, F;
  float eps;
  float4* loo;          // [K*m, F]: |C|, den, deramped own cross
  float* part;          // [K*m, n_chunks, 2]: chunk sums of |C|, den
  float* zpart;         // [K*m, n_chunks, 2W]: chunk windows (re | im)
  unsigned* bar;        // grid-barrier counter, 0 at launch
  float2* out;          // [K*m, W]
};

// Sum over the warp by a butterfly: every lane ends with the same value,
// and the order of the additions is fixed.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Warp item it -> (chunk, pair, bank): the K rows of one pair and chunk
// are consecutive items.
__device__ __forceinline__ void item_of(const Params& P, int it, int& ch,
                                        int& p, int& k) {
  k = it % P.K;
  p = (it / P.K) % P.m;
  ch = it / (P.K * P.m);
}

__global__ void __launch_bounds__(THREADS, 2)
zoom_probe_kernel(Params P) {
  extern __shared__ float red_all[];  // [WARPS][32][RED]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = gridDim.x * WARPS;
  const int gw = blockIdx.x * WARPS + warp;
  const int F = P.F, KM = P.K * P.m;
  const int clen = min(CHUNK, F), n_ch = F / clen, bpl = clen / 32;
  const int n_items = KM * n_ch;
  TDOA_TL(const bool tl = blockIdx.x == 0 && threadIdx.x == 0;
          if (tl) tl_k2[0] = tdoa::now_ns();)

  // Phase 0: per bin the LOO |C| and den and the bank's own cross-
  // spectrum deramped, and the chunk sums of |C| and den. A lane's bins
  // go in one batch of loads per other bank.
  const float two_over_f = 2.0f / (float)F;  // exact: F is 2^n
  for (int it = gw; it < n_items; it += n_warps) {
    int ch, p, k;
    item_of(P, it, ch, p, k);
    const int r = k * P.m + p;
    const int i = P.pairs[2 * p], j = P.pairs[2 * p + 1];
    const int f0 = ch * clen + lane;
    const float2* own = P.cross + (long long)r * F + f0;
    float2 cv[BPL];
    float lre[BPL], lim[BPL], saa[BPL], sbb[BPL];
#pragma unroll
    for (int q = 0; q < BPL; ++q) {
      if (q < bpl) cv[q] = own[32 * q];
      lre[q] = lim[q] = saa[q] = sbb[q] = 0.f;
    }
#pragma unroll 4
    for (int kk = 0; kk < P.K; ++kk) {
      if (kk == k) continue;
      const float2* cr = P.cross + ((long long)kk * P.m + p) * F + f0;
      const float* pi = P.psd + ((long long)kk * P.n_st + i) * F + f0;
      const float* pj = P.psd + ((long long)kk * P.n_st + j) * F + f0;
#pragma unroll
      for (int q = 0; q < BPL; ++q) {
        if (q < bpl) {
          const float2 c = cr[32 * q];
          lre[q] += c.x;
          lim[q] += c.y;
          saa[q] += fmaxf(pi[32 * q], 0.f);
          sbb[q] += fmaxf(pj[32 * q], 0.f);
        }
      }
    }
    const uint32_t d = (uint32_t)__float2int_rn(P.coarse[p]);
    float sm = 0.f, sd = 0.f;
#pragma unroll
    for (int q = 0; q < BPL; ++q) {
      if (q < bpl) {
        const int f = f0 + 32 * q;
        const float mag = sqrtf(lre[q] * lre[q] + lim[q] * lim[q]);
        const float den = sqrtf(saa[q]) * sqrtf(sbb[q]);
        sm += mag;
        sd += den;
        const uint32_t frac = ((uint32_t)f * d) & (uint32_t)(F - 1);
        float sn, cs;
        sincospif((float)frac * two_over_f, &sn, &cs);
        P.loo[(long long)r * F + f] =
            make_float4(mag, den, cv[q].x * cs - cv[q].y * sn,
                        cv[q].x * sn + cv[q].y * cs);
      }
    }
    sm = warp_sum(sm);
    sd = warp_sum(sd);
    if (lane == 0) {
      P.part[((long long)r * n_ch + ch) * 2 + 0] = sm;
      P.part[((long long)r * n_ch + ch) * 2 + 1] = sd;
    }
  }
  TDOA_TL(if (tl) tl_k2[1] = tdoa::now_ns();)
  tdoa::grid_sync(P.bar, gridDim.x);
  TDOA_TL(if (tl) tl_k2[2] = tdoa::now_ns();)

  // Phase 1: the weight and the chunk's zoom window.
  const float inv_f = 1.0f / (float)F;
  float* red = red_all + warp * 32 * RED;
  for (int it = gw; it < n_items; it += n_warps) {
    int ch, p, k;
    item_of(P, it, ch, p, k);
    const int r = k * P.m + p;
    const int f0 = ch * clen + lane;
    float4 lv[BPL];
#pragma unroll
    for (int q = 0; q < BPL; ++q) {
      if (q < bpl) lv[q] = __ldcg(P.loo + (long long)r * F + f0 + 32 * q);
    }
    float sm = 0.f, sd = 0.f;
    for (int c = lane; c < n_ch; c += 32) {
      sm += __ldcg(P.part + ((long long)r * n_ch + c) * 2 + 0);
      sd += __ldcg(P.part + ((long long)r * n_ch + c) * 2 + 1);
    }
    const float mean_mag = warp_sum(sm) * inv_f;
    const float mean_den = warp_sum(sd) * inv_f;
    const float s = P.nseg[r];
    const float bias = s > 1.f ? 1.f / fmaxf(s, 1.f) : 0.f;
    float are[W], aim[W];
#pragma unroll
    for (int w = 0; w < W; ++w) are[w] = aim[w] = 0.f;
#pragma unroll
    for (int q = 0; q < BPL; ++q) {
      if (q < bpl) {
        const int f = f0 + 32 * q;
        const float mag = lv[q].x, den = lv[q].y;
        const float gamma = mag / fmaxf(den, 1e-30f);
        float g2 = fminf(fmaxf(gamma * gamma, 0.f), 0.98f);
        g2 = fminf(fmaxf((g2 - bias) / fmaxf(1.f - bias, 1e-6f), 0.f), 0.98f);
        float snr_w = g2 / (1.f - g2);
        if (!(den > 1e-9f * mean_den)) snr_w = 0.f;
        const float wgt = snr_w / (mag + P.eps * mean_mag + 1e-30f);
        const float zr = lv[q].z * wgt, zi = lv[q].w * wgt;
        const int ks = f < F / 2 ? f : f - F;
        float b1s, b1c;
        sincospif((float)ks * two_over_f, &b1s, &b1c);
        are[HALF_WIDTH] += zr;
        aim[HALF_WIDTH] += zi;
        float br = b1c, bi = b1s;
#pragma unroll
        for (int n = 1; n <= HALF_WIDTH; ++n) {
          // lag +n: z * b; lag -n: z * conj(b)
          are[HALF_WIDTH + n] =
              fmaf(zr, br, fmaf(-zi, bi, are[HALF_WIDTH + n]));
          aim[HALF_WIDTH + n] =
              fmaf(zr, bi, fmaf(zi, br, aim[HALF_WIDTH + n]));
          are[HALF_WIDTH - n] =
              fmaf(zr, br, fmaf(zi, bi, are[HALF_WIDTH - n]));
          aim[HALF_WIDTH - n] =
              fmaf(zi, br, fmaf(-zr, bi, aim[HALF_WIDTH - n]));
          const float nr = br * b1c - bi * b1s;
          bi = br * b1s + bi * b1c;
          br = nr;
        }
      }
    }
    // Sum the window over the warp: a transpose through shared memory,
    // then lane v adds column v over the 32 lanes in order.
#pragma unroll
    for (int w = 0; w < W; ++w) {
      red[lane * RED + w] = are[w];
      red[lane * RED + W + w] = aim[w];
    }
    __syncwarp();
    float* zp = P.zpart + ((long long)r * n_ch + ch) * (2 * W);
    for (int v = lane; v < 2 * W; v += 32) {
      float acc = 0.f;
      for (int l = 0; l < 32; ++l) acc += red[l * RED + v];
      zp[v] = acc;
    }
    __syncwarp();
  }
  TDOA_TL(if (tl) tl_k2[3] = tdoa::now_ns();)
  tdoa::grid_sync(P.bar, 2 * gridDim.x);
  TDOA_TL(if (tl) tl_k2[4] = tdoa::now_ns();)

  // Phase 2: a warp per (row, lag) sums the chunk windows.
  for (int o = gw; o < KM * W; o += n_warps) {
    const int r = o / W, w = o % W;
    float sr = 0.f, si = 0.f;
#pragma unroll 8
    for (int c = lane; c < n_ch; c += 32) {
      const float* zp = P.zpart + ((long long)r * n_ch + c) * (2 * W);
      sr += __ldcg(zp + w);
      si += __ldcg(zp + W + w);
    }
    sr = warp_sum(sr);
    si = warp_sum(si);
    if (lane == 0) P.out[o] = make_float2(sr, si);
  }
  TDOA_TL(if (tl) tl_k2[5] = tdoa::now_ns();)
}

constexpr int SMEM = WARPS * 32 * RED * 4;

// The grid on the current device: as many CTAs as the work has warps
// for, at most as many as can be resident. Opts the kernel into its
// shared memory. Returns 0 or a cudaError_t.
int choose(int K, int m, int F, int* grid) {
  const void* fn = reinterpret_cast<const void*>(&zoom_probe_kernel);
  int dev, n_sm, fit = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&fit, fn, THREADS, SMEM);
  if (e != cudaSuccess) return (int)e;
  if (fit < 1) return (int)cudaErrorInvalidConfiguration;
  const int clen = F < CHUNK ? F : CHUNK;
  const int items = K * m * (F / clen);
  const int work = items > K * m * W ? items : K * m * W;
  const int want = (work + WARPS - 1) / WARPS;
  *grid = want < fit * n_sm ? want : fit * n_sm;
  return 0;
}

// choose, computed once per device and shape.
int grid_for(int K, int m, int F, int* grid) {
  struct Entry {
    int key[4];
    int grid;
  };
  static std::mutex mu;
  static std::vector<Entry> cache;
  int dev;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  std::lock_guard<std::mutex> lock(mu);
  for (const Entry& c : cache) {
    if (c.key[0] == dev && c.key[1] == K && c.key[2] == m && c.key[3] == F) {
      *grid = c.grid;
      return 0;
    }
  }
  const int err = choose(K, m, F, grid);
  if (err != 0) return err;
  cache.push_back(Entry{{dev, K, m, F}, *grid});
  return 0;
}

}  // namespace

// Zoom windows [K*m, W] (complex, float2) of every LOO-weighted probe on
// `stream`, in one cooperative launch (its grid chosen once per device
// and shape). Scratch: loo [K*m, F] float4, part
// [K*m, F/256, 2] f32, zpart [K*m, F/256, 2W] f32 (F/256 -> 1 when
// F < 256), bar one int. Returns 0 or the cudaError_t of the refused
// launch.
extern "C" int tdoa_zoom_probe(const void* cross, const void* psd,
                               const int* pairs, const float* coarse,
                               const float* nseg, int K, int m, int n_st,
                               int F, float eps, void* loo, void* part,
                               void* zpart, void* bar, void* out,
                               void* stream) {
  int grid;
  const int err = grid_for(K, m, F, &grid);
  if (err != 0) return err;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  cudaError_t e = cudaMemsetAsync(bar, 0, sizeof(unsigned), s);
  if (e != cudaSuccess) return (int)e;
  Params P;
  P.cross = static_cast<const float2*>(cross);
  P.psd = static_cast<const float*>(psd);
  P.pairs = pairs;
  P.coarse = coarse;
  P.nseg = nseg;
  P.K = K;
  P.m = m;
  P.n_st = n_st;
  P.F = F;
  P.eps = eps;
  P.loo = static_cast<float4*>(loo);
  P.part = static_cast<float*>(part);
  P.zpart = static_cast<float*>(zpart);
  P.bar = static_cast<unsigned*>(bar);
  P.out = static_cast<float2*>(out);
  void* args[] = {&P};
  e = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(&zoom_probe_kernel), dim3(grid),
      dim3(THREADS), args, (size_t)SMEM, s);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

#ifdef TDOA_TIMELINE
// The last launch's stamps, tl_k2 as laid out above.
extern "C" int tdoa_zoom_probe_timeline(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, tl_k2, sizeof(tl_k2));
}
#endif
