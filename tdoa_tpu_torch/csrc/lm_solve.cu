// Kernel 4: the multistart Levenberg-Marquardt hyperbolic solve, every
// start and every iteration in one launch, hand-written CUDA C++ for
// Hopper (sm_90a).
//
// Replaces no Pallas kernel. The JAX package's solve
// (tdoa_tpu/solve/multilateration.py, solve_tdoa_enu) is a
// jax.lax.fori_loop that jit compiles into one program; run eagerly,
// the same loop is ~40 small torch operations an iteration on CPU
// tensors, some 1,600 a solve, and their dispatch was the solve's time.
//
// What it computes, for each start s of S (x0[s], lambda = 1e-2) and
// `iters` iterations, exactly as solve_tdoa_enu's plain loop:
//   r_k  = (|x - sj_k| - |x - si_k|) - rd_k
//   J_k  = (x - sj_k)/(|x - sj_k| + 1e-9) - (x - si_k)/(|x - si_k| + 1e-9),
//          its first D components (D = 2 freezes the up-coordinate);
//   (J^T W J + lambda I) step = -J^T W r, x_try = x + step;
//   better = sum w r_try^2 < sum w r^2 (strict);
//   better: x = x_try, lambda = max(lambda / 3, 1e-7); else lambda *= 10;
// and after the loop rms = sqrt(sum w r^2 / max(sum w, 1e-9)). No early
// exit: every start runs all `iters` iterations.
//
// What bounds it on the H100. Not bytes (32 B a pair) nor operations
// (~60 a pair a pass: 2.2e3 pair passes, ~1e5 flops, at m = 3 and
// S = 9): the chain of `iters` dependent iterations, each a pass over
// the pairs, a warp reduction and a D x D solve. Latency, a few hundred
// cycles an iteration.
//
// What this design does about it. One CTA, one warp a start: the pairs
// (si, rd | sj, w as two float4) are staged in shared memory once, a
// warp keeps its start's x, lambda and the sums at x in registers, and
// its lanes stride over the pairs. A pass at x_try sums, per lane,
// J^T W J (D(D+1)/2 entries), J^T W r and the cost, then butterfly
// shuffles give every lane the same totals (a fixed order: the result
// is deterministic, and every lane takes the same branch). One pass an
// iteration: the sums at the accepted point are those of its trial
// pass. The damped system is symmetric positive definite and solved by
// its Cholesky factorisation in closed form.

#include <cuda_runtime.h>

namespace {

constexpr int MAX_STARTS = 32;
// The pairs' 32 bytes each in one CTA's shared memory (227 KB).
constexpr int MAX_PAIRS = 232448 / 32;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <int D>
struct Sums {
  float h[D * (D + 1) / 2];  // J^T W J, upper triangle by rows
  float g[D];                // J^T W r
  float cost;                // sum w r^2
};

// The sums at x over the pairs, every lane holding the totals.
template <int D>
__device__ __forceinline__ Sums<D> pass(const float4* pr, int m,
                                        const float x[3], int lane) {
  Sums<D> s;
#pragma unroll
  for (int t = 0; t < D * (D + 1) / 2; ++t) s.h[t] = 0.f;
#pragma unroll
  for (int a = 0; a < D; ++a) s.g[a] = 0.f;
  s.cost = 0.f;
  for (int k = lane; k < m; k += 32) {
    const float4 pi = pr[2 * k], pj = pr[2 * k + 1];
    const float di[3] = {x[0] - pi.x, x[1] - pi.y, x[2] - pi.z};
    const float dj[3] = {x[0] - pj.x, x[1] - pj.y, x[2] - pj.z};
    const float ri = sqrtf(di[0] * di[0] + di[1] * di[1] + di[2] * di[2]);
    const float rj = sqrtf(dj[0] * dj[0] + dj[1] * dj[1] + dj[2] * dj[2]);
    const float r = (rj - ri) - pi.w;
    const float w = pj.w;
    const float ei = ri + 1e-9f, ej = rj + 1e-9f;
    float j[D], jw[D];
#pragma unroll
    for (int a = 0; a < D; ++a) {
      j[a] = dj[a] / ej - di[a] / ei;
      jw[a] = j[a] * w;
    }
    int t = 0;
#pragma unroll
    for (int a = 0; a < D; ++a) {
#pragma unroll
      for (int b = a; b < D; ++b) s.h[t++] += jw[a] * j[b];
      s.g[a] += jw[a] * r;
    }
    s.cost += (w * r) * r;
  }
#pragma unroll
  for (int t = 0; t < D * (D + 1) / 2; ++t) s.h[t] = warp_sum(s.h[t]);
#pragma unroll
  for (int a = 0; a < D; ++a) s.g[a] = warp_sum(s.g[a]);
  s.cost = warp_sum(s.cost);
  return s;
}

// step = -(H + lambda I)^-1 g by the Cholesky factor L of H + lambda I:
// L y = -g, then L^T step = y. A pivot that is not positive gives NaN,
// the trial's cost is NaN and the step is rejected.
template <int D>
__device__ __forceinline__ void damped_step(const Sums<D>& s, float lam,
                                            float step[D]) {
  float a[D][D];
  int t = 0;
#pragma unroll
  for (int i = 0; i < D; ++i) {
#pragma unroll
    for (int k = i; k < D; ++k) a[i][k] = a[k][i] = s.h[t++];
    a[i][i] += lam;
  }
  float L[D][D];
#pragma unroll
  for (int i = 0; i < D; ++i) {
#pragma unroll
    for (int k = 0; k <= i; ++k) {
      float v = a[i][k];
#pragma unroll
      for (int q = 0; q < k; ++q) v -= L[i][q] * L[k][q];
      L[i][k] = (i == k) ? sqrtf(v) : v / L[k][k];
    }
  }
  float y[D];
#pragma unroll
  for (int i = 0; i < D; ++i) {
    float v = -s.g[i];
#pragma unroll
    for (int q = 0; q < i; ++q) v -= L[i][q] * y[q];
    y[i] = v / L[i][i];
  }
#pragma unroll
  for (int i = D - 1; i >= 0; --i) {
    float v = y[i];
#pragma unroll
    for (int q = i + 1; q < D; ++q) v -= L[q][i] * step[q];
    step[i] = v / L[i][i];
  }
}

// in: [m] pairs as (si.x, si.y, si.z, rd), (sj.x, sj.y, sj.z, w), then
// [S] starts (x, y, z, unused); out: [S] (x, y, z, rms).
template <int D>
__global__ void __launch_bounds__(32 * MAX_STARTS)
lm_solve_kernel(const float4* __restrict__ in, int m, int S, int iters,
                float4* __restrict__ out) {
  extern __shared__ float4 pr[];  // [2m]
  for (int i = threadIdx.x; i < 2 * m; i += blockDim.x) pr[i] = in[i];
  __syncthreads();
  const int lane = threadIdx.x & 31, start = threadIdx.x >> 5;
  if (start >= S) return;
  const float4 x0 = in[2 * m + start];
  float x[3] = {x0.x, x0.y, x0.z};
  float wsum = 0.f;
  for (int k = lane; k < m; k += 32) wsum += pr[2 * k + 1].w;
  wsum = warp_sum(wsum);
  Sums<D> cur = pass<D>(pr, m, x, lane);
  float lam = 1e-2f;
  for (int it = 0; it < iters; ++it) {
    float step[D];
    damped_step<D>(cur, lam, step);
    float xt[3] = {x[0], x[1], x[2]};
#pragma unroll
    for (int a = 0; a < D; ++a) xt[a] += step[a];
    const Sums<D> trial = pass<D>(pr, m, xt, lane);
    if (trial.cost < cur.cost) {
      x[0] = xt[0];
      x[1] = xt[1];
      x[2] = xt[2];
      cur = trial;
      lam = fmaxf(lam / 3.0f, 1e-7f);
    } else {
      lam *= 10.0f;
    }
  }
  if (lane == 0)
    out[start] = make_float4(x[0], x[1], x[2],
                             sqrtf(cur.cost / fmaxf(wsum, 1e-9f)));
}

}  // namespace

// S starts' solutions over m pairs on `stream`: one CTA of 32*S threads,
// 32*m bytes of shared memory. n_dim 2 freezes the up-coordinate, 3
// solves it. Returns 0 or the cudaError_t of the refused launch.
extern "C" int tdoa_lm_solve(const void* in, int m, int S, int n_dim,
                             int iters, void* out, void* stream) {
  if (m < 1 || m > MAX_PAIRS || S < 1 || S > MAX_STARTS || iters < 0 ||
      (n_dim != 2 && n_dim != 3))
    return (int)cudaErrorInvalidValue;
  void (*kern)(const float4*, int, int, int, float4*) =
      n_dim == 2 ? lm_solve_kernel<2> : lm_solve_kernel<3>;
  const size_t smem = 32 * (size_t)m;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<1, 32 * S, smem, reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(in), m, S, iters,
      static_cast<float4*>(out));
  return (int)cudaGetLastError();
}
