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
// station X, written in TRUE frequency order.
//
// What bounds it on the H100. At 3 stations a 10 s block is 8.2 GFLOP
// of f32 FFT and accumulation (0.12 ms at 67 TFLOP/s) against 255 MB of
// input and output (0.08 ms at 3.35 TB/s); the four-step hand-off
// between the stages is 512 KB per station and segment, 1.36 GB per
// block. The first port wrote it to a 64 MB device scratch (larger than
// the 50 MB L2, so it round-tripped HBM), ran each 256-point transform
// as 8 radix-2 stages behind 8 barriers with half the threads idle in
// every other round, and gave stage 2 one CTA per (row, bank) walking
// its bank's segments one at a time: 3.2 ms, barrier- and latency-bound.
// Keeping the accumulators on chip caps the CTAs at two per SM (16
// warps), so what is left is latency: every load is issued one step
// ahead of its use.
//
// What this design does about it.
//  * Every 256-point transform is 16 x 16: a radix-16 pass in one
//    thread's registers, one exchange through a padded, bank-conflict-
//    free shared-memory slot, the twiddle, a second radix-16 pass. A
//    row transform belongs to 16 lanes of one warp, so its exchange
//    needs only __syncwarp; stage 1 transforms 16 columns per CTA with
//    two barriers.
//  * ONE cooperative launch per block; every CTA is resident. The
//    segments go in chunks given by a plan from the host (chunk_plan in
//    ops/kernels/corr_accum.py: chunk c takes the same run of segments
//    from every bank). Phase p runs stage 1 of chunk p into one of two
//    L2-sized scratch buffers and stage 2 of chunk p - 1 from the
//    other; one grid-wide barrier separates the phases, so the hand-off
//    stays in L2 instead of HBM.
//  * Each CTA owns a fixed run of (bank, row) items for the whole
//    launch. Stage 2 transforms a round of (item, segment) tuples, all
//    stations, spread over 16 lane groups, then thread t adds bin t into
//    the items' accumulators. Where every CTA's items fit in shared
//    memory (3 stations: 15 KB an item), the accumulators stay there
//    from the first segment to the last and reach the outputs once.
//    Where they do not (12 stations: 172 KB an item), the same kernel
//    keeps one item's accumulators at a time and reloads them from the
//    outputs at every chunk (the reload branch). One footprint formula,
//    smem_bytes, chooses the branch and, where not even one item fits
//    a CTA, tells the routing gate (fits_device) that the kernel cannot
//    run the shape.
//  * Loads run one step ahead: a stage-1 unit's input is fetched while
//    the previous unit computes (the first of a phase before the grid
//    barrier), a stage-2 round's rows while the previous round
//    accumulates (the first of a phase while stage 1 runs).
//  * No atomics on data: every sum runs in segment order, so two
//    launches give bitwise-equal outputs. All arithmetic is f32 (input
//    bf16 or f32). The twiddles come from 256-entry tables of sincospif
//    on exactly representable arguments; the stage-1 twiddle of
//    exponent e = k1*c is the product of the entries for e >> 8 and
//    e & 255 (one rounding more than a direct sincospif).

#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>
#include <vector>

#include "grid_sync.cuh"

namespace {

constexpr int R = 256;
constexpr int SEG_ROWS = 176;
constexpr int DATA_N1 = SEG_ROWS / 16;  // radix-16 inputs that hold data
constexpr int FFT_LEN = R * R;
constexpr int SEG_LEN = SEG_ROWS * R;
constexpr int THREADS = 256;  // 16 lane groups of 16, one transform each
constexpr int GROUPS = THREADS / 16;
constexpr int SLOT = 16 * 17 + 1;  // float2 per transform buffer (padded)
// CTAs per SM the registers allow: __launch_bounds__(THREADS,
// BLOCKS_PER_SM) holds a thread to 128 of them, 2 x 256 x 128 = the
// SM's 64K.
constexpr int BLOCKS_PER_SM = 2;

#ifdef TDOA_TIMELINE
constexpr int TL_PH = 128;  // phases stamped; row TL_PH: start, store, end
// [first CTA, last CTA][phase][start, stage-1 ns, stage-2 ns, end]
__device__ unsigned long long tl_k1[2][TL_PH + 1][4];
#endif

__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}
__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}
// a * (-i)
__device__ __forceinline__ float2 mul_neg_i(float2 a) {
  return make_float2(a.y, -a.x);
}

// In-place forward 4-point DFT, natural order in and out.
__device__ __forceinline__ void dft4(float2& a0, float2& a1, float2& a2,
                                     float2& a3) {
  const float2 t0 = cadd(a0, a2), t1 = csub(a0, a2);
  const float2 t2 = cadd(a1, a3), t3 = mul_neg_i(csub(a1, a3));
  a0 = cadd(t0, t2);
  a2 = csub(t0, t2);
  a1 = cadd(t1, t3);
  a3 = csub(t1, t3);
}

// exp(-2*pi*i*e/16) for the exponents a 4 x 4 split needs, as correctly
// rounded float constants (e is a compile-time constant once unrolled).
__device__ __forceinline__ float2 w16(int e) {
  constexpr float C1 = 0.92387953251128675613f;  // cos(pi/8)
  constexpr float S1 = 0.38268343236508977173f;  // sin(pi/8)
  constexpr float H = 0.70710678118654752440f;   // sqrt(1/2)
  switch (e) {
    case 1: return make_float2(C1, -S1);
    case 2: return make_float2(H, -H);
    case 3: return make_float2(S1, -C1);
    case 6: return make_float2(-H, -H);
    case 9: return make_float2(-C1, S1);
    default: return make_float2(1.f, 0.f);
  }
}

// Where fft16 leaves X[k]: the 4 x 4 split transposes the digits.
__host__ __device__ constexpr int pos16(int k) {
  return ((k & 3) << 2) | (k >> 2);
}

// Forward 16-point DFT of v in registers: X[k] = sum_n v[n]
// exp(-2*pi*i*n*k/16), left at v[pos16(k)].
__device__ __forceinline__ void fft16(float2 (&v)[16]) {
#pragma unroll
  for (int b = 0; b < 4; ++b) dft4(v[b], v[4 + b], v[8 + b], v[12 + b]);
#pragma unroll
  for (int c = 1; c < 4; ++c) {
#pragma unroll
    for (int b = 1; b < 4; ++b) {
      v[4 * c + b] = b * c == 4 ? mul_neg_i(v[4 * c + b])
                                : cmul(v[4 * c + b], w16(b * c));
    }
  }
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    dft4(v[4 * c], v[4 * c + 1], v[4 * c + 2], v[4 * c + 3]);
  }
}

// Position of exp(-2*pi*i*e/65536), e < 256, in its table: the low four
// bits are XORed with the next four, so the 16 lanes of a stage-1 store
// (exponents k*c, c consecutive) read distinct banks.
__device__ __forceinline__ int swz(int e) { return e ^ ((e >> 4) & 15); }

// 256-point FFT of one row held by a 16-lane group (n2 = l16): on entry
// v[n1] = a[16*n1 + n2]; on exit buf (the group's own slot) holds X[k]
// at buf[(k & 15) + 17*(k >> 4)]. tw2[16*k1 + n2] = exp(-2*pi*i*n2*k1
// /256). Every lane of the warp calls it, for the __syncwarp; `act`
// masks the memory operations of an idle group. Lane k1 reads and
// rewrites only its own positions k1 + 17*j, so the second pass works
// in place.
__device__ __forceinline__ void fft256_row(float2 (&v)[16], float2* buf,
                                           const float2* tw2, int l16,
                                           bool act) {
  fft16(v);  // Y_{n2}[k1] at v[pos16(k1)]
  if (act) {
#pragma unroll
    for (int k1 = 0; k1 < 16; ++k1)
      buf[17 * l16 + k1] = cmul(v[pos16(k1)], tw2[16 * k1 + l16]);
  }
  __syncwarp();
  if (act) {
#pragma unroll
    for (int n2 = 0; n2 < 16; ++n2) v[n2] = buf[l16 + 17 * n2];
  }
  fft16(v);  // X[l16 + 16*k2] at v[pos16(k2)]
  if (act) {
#pragma unroll
    for (int k2 = 0; k2 < 16; ++k2) buf[l16 + 17 * k2] = v[pos16(k2)];
  }
}

// Accumulator slots of an item: cross re/im for each pair (2m), psd
// (n_st), sums re/im (2 n_st) when track.
__host__ __device__ inline int n_slots(int n_st, int m, int track) {
  return 2 * m + n_st * (track ? 3 : 1);
}

// Transform buffers: 16 (stage 1's columns; stage 2's lane groups), or
// one per station where a tuple's stations outnumber the groups.
__host__ __device__ inline int x_slots(int n_st) {
  return n_st > GROUPS ? n_st : GROUPS;
}

__host__ __device__ inline int pad4(int n) { return (n + 3) & ~3; }

// Shared memory of a CTA holding the accumulators of n_res items:
// tw, tw2, twl [R] float2 | xbuf [x_slots][SLOT] float2 | flags
// [x_slots] int | pairs [2m] int | acc [n_res][n_slots][R] f32 (int
// arrays padded to 16 B).
__host__ __device__ inline int smem_bytes(int n_st, int m, int track,
                                          int n_res) {
  return 3 * R * 8 + x_slots(n_st) * SLOT * 8 + 4 * pad4(x_slots(n_st)) +
         4 * pad4(2 * m) + n_res * n_slots(n_st, m, track) * R * 4;
}

struct Params {
  const void* xr;
  const void* xi;
  long long st_stride;  // elements between stations
  int n_st, m, track, n_banks;
  const int* pairs;     // [m, 2]
  const int* plan;      // [n_chunks, n_banks * run]: segment or -1
  int n_chunks, run;
  float2* scratch;      // 2 buffers of [n_st][n_banks * run][F]
  unsigned* bar;        // grid-barrier counter, 0 at launch
  int resident;         // 1: accumulators stay in shared memory
  int ipc;              // items per CTA
  float2* cross;        // [n_banks, m, F]
  float* psd;           // [n_banks, n_st, F]
  float2* sums;         // [n_banks, n_st, F] when track
};

__device__ __forceinline__ unsigned short ldx(const unsigned short* p,
                                              long long o) {
  return __ldcs(p + o);
}
__device__ __forceinline__ float ldx(const float* p, long long o) {
  return __ldcs(p + o);
}
__device__ __forceinline__ float to_f32(unsigned short v) {
  return __uint_as_float((unsigned)v << 16);  // bf16, exact
}
__device__ __forceinline__ float to_f32(float v) { return v; }

// The input of one stage-1 unit as this thread loads it: rows 16*n1 +
// (t >> 4), n1 < 11, of column 16*tile + (t & 15), both planes.
template <typename T>
struct Raw1 {
  T re[DATA_N1], im[DATA_N1];
  bool ok;  // the unit exists and its segment slot holds a segment
};

// Stage-1 unit u of a chunk: (station, segment slot, 16-column tile).
__device__ __forceinline__ void unit_of(int u, int S, int& st, int& sl,
                                        int& tile) {
  tile = u & 15;
  sl = (u >> 4) % S;
  st = (u >> 4) / S;
}

template <typename T>
__device__ __forceinline__ void s1_fetch(const Params& P, int chunk, int u,
                                         Raw1<T>& raw) {
  const int S = P.n_banks * P.run;
  raw.ok = false;
  if (chunk >= P.n_chunks || u >= P.n_st * S * 16) return;
  int st, sl, tile;
  unit_of(u, S, st, sl, tile);
  const int seg = __ldg(P.plan + (long long)chunk * S + sl);
  if (seg < 0) return;  // a bank shorter than this chunk
  raw.ok = true;
  const int t = threadIdx.x;
  const T* xr = static_cast<const T*>(P.xr);
  const T* xi = static_cast<const T*>(P.xi);
  const long long base = (long long)st * P.st_stride +
                         (long long)seg * SEG_LEN + tile * 16 + (t & 15) +
                         (long long)(t >> 4) * R;
#pragma unroll
  for (int n1 = 0; n1 < DATA_N1; ++n1) {
    raw.re[n1] = ldx(xr, base + (long long)16 * n1 * R);
    raw.im[n1] = ldx(xi, base + (long long)16 * n1 * R);
  }
}

// Stage 1 of unit u into the chunk's scratch buffer `dst`. Thread
// (col = t & 15, n2 = t >> 4) runs the first radix-16 pass down its
// column over rows 16*n1 + n2 (rows >= 176 are the zero padding), the
// CTA exchanges through shared memory, thread (col, k1 = t >> 4) runs
// the second pass and applies exp(-2*pi*i*k*c/65536).
template <typename T>
__device__ __forceinline__ void s1_compute(const Params& P, int u,
                                           const Raw1<T>& raw, float2* dst,
                                           const float2* tw,
                                           const float2* tw2,
                                           const float2* twl, float2* xbuf) {
  const int S = P.n_banks * P.run;
  int st, sl, tile;
  unit_of(u, S, st, sl, tile);
  const int t = threadIdx.x, col = t & 15, hi = t >> 4;
  const int c = tile * 16 + col;
  float2 v[16];
#pragma unroll
  for (int n1 = 0; n1 < 16; ++n1) {
    v[n1] = n1 < DATA_N1
                ? make_float2(to_f32(raw.re[n1]), to_f32(raw.im[n1]))
                : make_float2(0.f, 0.f);
  }
  fft16(v);
  float2* buf = xbuf + col * SLOT;
#pragma unroll
  for (int k1 = 0; k1 < 16; ++k1)
    buf[17 * hi + k1] = cmul(v[pos16(k1)], tw2[16 * k1 + hi]);
  __syncthreads();
#pragma unroll
  for (int n2 = 0; n2 < 16; ++n2) v[n2] = buf[hi + 17 * n2];
  fft16(v);
  float2* out = dst + ((long long)st * S + sl) * FFT_LEN + c;
#pragma unroll
  for (int k2 = 0; k2 < 16; ++k2) {
    const int k = hi + 16 * k2, e = k * c;  // e < 65536
    const float2 w = cmul(tw[e >> 8], twl[swz(e & 255)]);
    __stcg(out + k * R, cmul(v[pos16(k2)], w));
  }
  __syncthreads();  // xbuf is reused by the next unit
}

// Stage-2 rounds of a CTA. A tuple tau (counted from the CTA's first
// item) is (item j = tau / run, segment slot l = tau % run). A round
// takes at most tpr tuples: whole items, ipr of them, where an item's
// run fits a round (the resident branch), else one item's tuples in
// rpi rounds (every item of the reload branch, whose single
// accumulator block holds one item at a time).
struct Rounds {
  int ipr, rpi, n;
};

__device__ __forceinline__ Rounds rounds_of(const Params& P, int n_mine,
                                            int tpr) {
  Rounds rs;
  rs.ipr = P.resident ? max(1, tpr / P.run) : 1;
  rs.rpi = (P.run + tpr - 1) / tpr;
  rs.n = (n_mine + rs.ipr - 1) / rs.ipr * rs.rpi;
  return rs;
}

__device__ __forceinline__ void round_at(const Params& P, const Rounds& rs,
                                         int r, int n_mine, int tpr,
                                         int& tau0, int& nt) {
  const int g = r / rs.rpi, sub = r - g * rs.rpi;
  const int j0 = g * rs.ipr, j1 = min(n_mine, j0 + rs.ipr);
  tau0 = j0 * P.run + sub * tpr;
  nt = min(tpr, (j1 - j0) * P.run - sub * tpr);
}

// Loads into v the row of transform tr = (tuple tau0 + tr / n_st,
// station tr % n_st) of a round of the chunk in `src` (zeros past the
// round's transforms). Returns whether the tuple's segment slot holds a
// segment: past a bank's end it does not, and its row is never summed.
__device__ __forceinline__ bool s2_fetch(const Params& P, const float2* src,
                                         const int* plan_c, int item0,
                                         int tau0, int nt, int tr,
                                         float2 (&v)[16]) {
  const int n_st = P.n_st, run = P.run, S = P.n_banks * run;
  const bool act = tr < nt * n_st;
  const int q = act ? tr / n_st : 0, st = tr - q * n_st;
  const int tau = tau0 + q, item = item0 + tau / run;
  const int sl = (item / R) * run + tau % run;
  const float2* row =
      src + ((long long)st * S + sl) * FFT_LEN + (item % R) * R;
  const int l16 = threadIdx.x & 15;
#pragma unroll
  for (int n1 = 0; n1 < 16; ++n1)
    v[n1] = act ? __ldcg(row + 16 * n1 + l16) : make_float2(0.f, 0.f);
  return act && __ldg(plan_c + sl) >= 0;
}

// Thread t adds bin t of a round's transformed tuples (xbuf, flags) into
// the accumulators of their items, in tuple order (a round holds at
// most 32 tuples: tpr <= x_slots / n_st). Item j's block is
// acc + j * jstride (jstride 0: the reload branch's single block).
__device__ __forceinline__ void s2_accumulate(const Params& P, int tau0,
                                              int nt, float* acc,
                                              int jstride,
                                              const float2* xbuf,
                                              const int* flags,
                                              const int* pr) {
  const int n_st = P.n_st, m = P.m, run = P.run, t = threadIdx.x;
  const int pos = (t & 15) + 17 * (t >> 4);
  unsigned fm = 0;  // bit q: tuple q holds a segment
  for (int q = 0; q < nt; ++q) fm |= (unsigned)flags[q] << q;
  int j = tau0 / run, l = tau0 - j * run;
  for (int q0 = 0; q0 < nt;) {
    const int q1 = min(nt, q0 + run - l);  // this item's tuples
    float* a_cr = acc + j * jstride;
    float* a_ci = a_cr + m * R;
    float* a_psd = a_ci + m * R;
    float* a_sr = a_psd + n_st * R;
    float* a_si = a_sr + n_st * R;
    for (int st = 0; st < n_st; ++st) {
      float ps = a_psd[st * R + t];
      float sr = P.track ? a_sr[st * R + t] : 0.f;
      float si = P.track ? a_si[st * R + t] : 0.f;
      for (int q = q0; q < q1; ++q) {
        if (!((fm >> q) & 1u)) continue;
        const float2 x = xbuf[(q * n_st + st) * SLOT + pos];
        ps += x.x * x.x + x.y * x.y;
        sr += x.x;
        si += x.y;
      }
      a_psd[st * R + t] = ps;
      if (P.track) {
        a_sr[st * R + t] = sr;
        a_si[st * R + t] = si;
      }
    }
    for (int p = 0; p < m; ++p) {
      const int i = pr[2 * p], jj = pr[2 * p + 1];
      float cr = a_cr[p * R + t], ci = a_ci[p * R + t];
      for (int q = q0; q < q1; ++q) {
        if (!((fm >> q) & 1u)) continue;
        const float2 xi = xbuf[(q * n_st + i) * SLOT + pos];
        const float2 xj = xbuf[(q * n_st + jj) * SLOT + pos];
        cr += xj.x * xi.x + xj.y * xi.y;
        ci += xj.y * xi.x - xj.x * xi.y;
      }
      a_cr[p * R + t] = cr;
      a_ci[p * R + t] = ci;
    }
    q0 = q1;
    ++j;
    l = 0;
  }
}

// Moves one item's accumulators between shared memory and the outputs
// (bin t of row `row` of bank b is true frequency row + 256*t): load
// (the reload branch, after chunk 0) or store. Thread t moves bin t.
__device__ __forceinline__ void item_io(const Params& P, float* a, int item,
                                        bool load) {
  const int n_st = P.n_st, m = P.m, t = threadIdx.x;
  const long long F = FFT_LEN;
  const int b = item / R;
  const long long bin = item % R + (long long)R * t;
  float* a_cr = a;
  float* a_ci = a + m * R;
  float* a_psd = a + 2 * m * R;
  float* a_sr = a_psd + n_st * R;
  float* a_si = a_sr + n_st * R;
  for (int p = 0; p < m; ++p) {
    float2* o = P.cross + ((long long)b * m + p) * F + bin;
    if (load) {
      const float2 v = __ldcg(o);
      a_cr[p * R + t] = v.x;
      a_ci[p * R + t] = v.y;
    } else {
      *o = make_float2(a_cr[p * R + t], a_ci[p * R + t]);
    }
  }
  for (int st = 0; st < n_st; ++st) {
    float* o = P.psd + ((long long)b * n_st + st) * F + bin;
    if (load) {
      a_psd[st * R + t] = __ldcg(o);
    } else {
      *o = a_psd[st * R + t];
    }
    if (P.track) {
      float2* s = P.sums + ((long long)b * n_st + st) * F + bin;
      if (load) {
        const float2 v = __ldcg(s);
        a_sr[st * R + t] = v.x;
        a_si[st * R + t] = v.y;
      } else {
        *s = make_float2(a_sr[st * R + t], a_si[st * R + t]);
      }
    }
  }
}

// The resident branch's last step: every item's accumulators to the
// outputs. Consecutive threads take consecutive items at one bin, so a
// warp writes runs of n_mine adjacent output elements.
__device__ __forceinline__ void store_items(const Params& P, const float* acc,
                                           int item0, int n_mine) {
  const int n_st = P.n_st, m = P.m;
  const int nsl = n_slots(n_st, m, P.track);
  const long long F = FFT_LEN;
  __syncthreads();
  for (int e = threadIdx.x; e < n_mine * R; e += THREADS) {
    const int j = e % n_mine, tb = e / n_mine, item = item0 + j;
    const int b = item / R;
    const long long bin = item % R + (long long)R * tb;
    const float* a = acc + j * nsl * R + tb;
    for (int p = 0; p < m; ++p) {
      P.cross[((long long)b * m + p) * F + bin] =
          make_float2(a[p * R], a[(m + p) * R]);
    }
    for (int st = 0; st < n_st; ++st) {
      P.psd[((long long)b * n_st + st) * F + bin] = a[(2 * m + st) * R];
      if (P.track) {
        P.sums[((long long)b * n_st + st) * F + bin] = make_float2(
            a[(2 * m + n_st + st) * R], a[(2 * m + 2 * n_st + st) * R]);
      }
    }
  }
}

// The whole block in one cooperative launch: phase p = 0 .. n_chunks
// runs stage 1 of chunk p into scratch buffer p & 1 and stage 2 of chunk
// p - 1 from buffer (p - 1) & 1, then a grid-wide barrier.
template <typename T>
__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM)
corr_accum_kernel(Params P) {
  extern __shared__ float4 smem_raw[];
  const int n_st = P.n_st, run = P.run, S = P.n_banks * run;
  const int xs = x_slots(n_st);
  float2* tw = reinterpret_cast<float2*>(smem_raw);  // exp(-2 pi i e/256)
  float2* tw2 = tw + R;   // [k1][n2]: exp(-2 pi i n2 k1/256)
  float2* twl = tw2 + R;  // exp(-2 pi i e/65536), e < 256, at swz(e)
  float2* xbuf = twl + R;
  int* flags = reinterpret_cast<int*>(xbuf + xs * SLOT);
  int* pr = flags + pad4(xs);
  float* acc = reinterpret_cast<float*>(pr + pad4(2 * P.m));

  const int t = threadIdx.x, G = gridDim.x, cta = blockIdx.x;
  const int l16 = t & 15;
  const int nsl = n_slots(n_st, P.m, P.track);
  const int n_items = R * P.n_banks;
  const int item0 = cta * P.ipc;
  const int n_mine = max(0, min(P.ipc, n_items - item0));
  const int tpr = xs / n_st;  // tuples per round
  const int n_iter = (xs + GROUPS - 1) / GROUPS;  // transforms per group
  const Rounds rs = rounds_of(P, n_mine, tpr);
  const int nr = rs.n;
  const int slot0 = 2 * (t >> 5) + ((t >> 4) & 1);  // this group's
  const int jstride = P.resident ? nsl * R : 0;
  const long long buf_len = (long long)n_st * S * FFT_LEN;
  const int n_units = n_st * S * 16;
  TDOA_TL(const int tl = t != 0 ? -1 : cta == 0 ? 0 : cta == G - 1 ? 1 : -1;
          if (tl >= 0) tl_k1[tl][TL_PH][0] = tdoa::now_ns();
          unsigned long long T0 = 0, D1 = 0, D2 = 0;)

  {
    float s, c;
    sincospif(-(float)t / 128.0f, &s, &c);
    tw[t] = make_float2(c, s);
    sincospif(-(float)t / 32768.0f, &s, &c);
    twl[swz(t)] = make_float2(c, s);
  }
  for (int e = t; e < 2 * P.m; e += THREADS) pr[e] = P.pairs[e];
  if (P.resident) {
    for (int e = t; e < n_mine * nsl * R; e += THREADS) acc[e] = 0.f;
  }
  __syncthreads();
  tw2[t] = tw[(t & 15) * (t >> 4)];
  __syncthreads();

  Raw1<T> raw;
  s1_fetch<T>(P, 0, cta, raw);
  for (int ph = 0; ph <= P.n_chunks; ++ph) {
    const int c = ph - 1;  // the chunk of stage 2
    TDOA_TL(T0 = tdoa::now_ns();)
    const float2* src = P.scratch + (c & 1) * buf_len;
    const int* plan_c = P.plan + (long long)c * S;
    float2 v[16];
    bool ok = false;
    int tau0 = 0, nt = 0;
    if (ph >= 1 && nr > 0) {
      round_at(P, rs, 0, n_mine, tpr, tau0, nt);
      ok = s2_fetch(P, src, plan_c, item0, tau0, nt, slot0, v);
    }

    if (ph < P.n_chunks) {
      float2* dst = P.scratch + (ph & 1) * buf_len;
      for (int u = cta; u < n_units; u += G) {
        const Raw1<T> cur = raw;
        s1_fetch<T>(P, ph, u + G, raw);
        if (cur.ok) s1_compute<T>(P, u, cur, dst, tw, tw2, twl, xbuf);
      }
    }

    TDOA_TL(D1 = tdoa::now_ns() - T0;)
    if (ph >= 1) {
      for (int r = 0; r < nr; ++r) {
        const int n_tr = nt * n_st;
        for (int i = 0; i < n_iter; ++i) {
          const int tr = slot0 + GROUPS * i;
          if (i > 0) ok = s2_fetch(P, src, plan_c, item0, tau0, nt, tr, v);
          fft256_row(v, xbuf + tr * SLOT, tw2, l16, tr < n_tr);
          if (l16 == 0 && tr < n_tr && tr % n_st == 0) flags[tr / n_st] = ok;
        }
        const int cur_tau0 = tau0, cur_nt = nt;
        if (r + 1 < nr) {
          round_at(P, rs, r + 1, n_mine, tpr, tau0, nt);
          ok = s2_fetch(P, src, plan_c, item0, tau0, nt, slot0, v);
        }
        __syncthreads();
        const int j = cur_tau0 / run, l0 = cur_tau0 - j * run;
        if (!P.resident && l0 == 0) {  // the reload branch's next item
          if (c > 0) {
            item_io(P, acc, item0 + j, true);
          } else {
            for (int s = 0; s < nsl; ++s) acc[s * R + t] = 0.f;
          }
        }
        s2_accumulate(P, cur_tau0, cur_nt, acc, jstride, xbuf, flags, pr);
        if (!P.resident && l0 + cur_nt == run) {
          item_io(P, acc, item0 + j, false);
        }
        __syncthreads();  // xbuf and flags are refilled by the next round
      }
    }
    TDOA_TL(D2 = tdoa::now_ns() - T0 - D1;)
    if (ph < P.n_chunks) {
      s1_fetch<T>(P, ph + 1, cta, raw);
      tdoa::grid_sync(P.bar, (unsigned)G * (ph + 1));
    }
    TDOA_TL(if (tl >= 0 && ph < TL_PH) {
      tl_k1[tl][ph][0] = T0;
      tl_k1[tl][ph][1] = D1;
      tl_k1[tl][ph][2] = D2;
      tl_k1[tl][ph][3] = tdoa::now_ns();
    })
  }
  TDOA_TL(if (tl >= 0) tl_k1[tl][TL_PH][1] = tdoa::now_ns();)
  if (P.resident) store_items(P, acc, item0, n_mine);
  TDOA_TL(__syncthreads();
          if (tl >= 0) tl_k1[tl][TL_PH][2] = tdoa::now_ns();)
}

template <typename T>
const void* kernel_fn() {
  return reinterpret_cast<const void*>(&corr_accum_kernel<T>);
}

// A launch shape: whether each CTA keeps its items' accumulators in
// shared memory (resident) or reloads one item's per chunk, the grid,
// CTAs per SM, items per CTA and dynamic shared memory bytes.
struct Shape {
  int resident, grid, bps, ipc, smem;
};

// The launch shape on the current device: the most CTAs per SM (up to
// BLOCKS_PER_SM) at which every CTA holds its items' accumulators,
// else the reload branch with one item's. Opts the kernel into the
// shared memory it needs. Returns 0 or a cudaError_t
// (cudaErrorInvalidConfiguration when not even one item fits a CTA:
// the kernel cannot run this shape on this device).
int choose(int n_st, int m, int track, int n_banks, int is_bf16, Shape* out) {
  const void* fn = is_bf16 ? kernel_fn<unsigned short>() : kernel_fn<float>();
  int dev, n_sm, optin;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             optin);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(fn, cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return (int)e;
  const int n_items = R * n_banks;
  for (int resident = 1; resident >= 0; --resident) {
    for (int bps = BLOCKS_PER_SM; bps >= 1; --bps) {
      const int grid = bps * n_sm;
      const int ipc = (n_items + grid - 1) / grid;
      const int smem = smem_bytes(n_st, m, track, resident ? ipc : 1);
      if (smem > optin) continue;
      int fit = 0;
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&fit, fn, THREADS,
                                                        smem);
      if (e != cudaSuccess) return (int)e;
      if (fit >= bps) {
        *out = Shape{resident, grid, bps, ipc, smem};
        return 0;
      }
    }
  }
  return (int)cudaErrorInvalidConfiguration;
}

// choose, computed once per device and shape.
int shape_for(int n_st, int m, int track, int n_banks, int is_bf16,
              Shape* out) {
  struct Entry {
    int key[6];
    Shape shape;
  };
  static std::mutex mu;
  static std::vector<Entry> cache;
  int dev;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  const int key[6] = {dev, n_st, m, track, n_banks, is_bf16};
  std::lock_guard<std::mutex> lock(mu);
  for (const Entry& c : cache) {
    bool hit = true;
    for (int i = 0; i < 6; ++i) hit = hit && c.key[i] == key[i];
    if (hit) {
      *out = c.shape;
      return 0;
    }
  }
  const int err = choose(n_st, m, track, n_banks, is_bf16, out);
  if (err != 0) return err;
  Entry c;
  for (int i = 0; i < 6; ++i) c.key[i] = key[i];
  c.shape = *out;
  cache.push_back(c);
  return 0;
}

}  // namespace

// The launch shape tdoa_corr_accum takes on the current device: out =
// {resident, grid, CTAs per SM, items per CTA, shared memory bytes}.
// Returns 0, cudaErrorInvalidConfiguration where the kernel cannot run
// the shape on this device (the routing gate fits_device), or another
// cudaError_t.
extern "C" int tdoa_corr_accum_config(int n_st, int m, int track, int n_banks,
                                      int is_bf16, int* out) {
  Shape sh;
  const int e = shape_for(n_st, m, track, n_banks, is_bf16, &sh);
  if (e != 0) return e;
  out[0] = sh.resident;
  out[1] = sh.grid;
  out[2] = sh.bps;
  out[3] = sh.ipc;
  out[4] = sh.smem;
  return 0;
}

// Accumulate one capture on `stream` in one cooperative launch of the
// shape tdoa_corr_accum_config gives. Returns 0 or the cudaError_t of
// the refused launch (a grid that cannot be resident is refused, never
// shrunk).
extern "C" int tdoa_corr_accum(const void* xr, const void* xi, int is_bf16,
                               long long st_stride, int n_st,
                               const int* pairs, int m, int n_banks,
                               int track, const int* plan, int n_chunks,
                               int run, void* scratch, void* bar,
                               void* cross, void* psd, void* sums,
                               void* stream) {
  Shape sh;
  const int err = shape_for(n_st, m, track, n_banks, is_bf16, &sh);
  if (err != 0) return err;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  cudaError_t e = cudaMemsetAsync(bar, 0, sizeof(unsigned), s);
  if (e != cudaSuccess) return (int)e;
  Params P;
  P.xr = xr;
  P.xi = xi;
  P.st_stride = st_stride;
  P.n_st = n_st;
  P.m = m;
  P.track = track;
  P.n_banks = n_banks;
  P.pairs = pairs;
  P.plan = plan;
  P.n_chunks = n_chunks;
  P.run = run;
  P.scratch = static_cast<float2*>(scratch);
  P.bar = static_cast<unsigned*>(bar);
  P.resident = sh.resident;
  P.ipc = sh.ipc;
  P.cross = static_cast<float2*>(cross);
  P.psd = static_cast<float*>(psd);
  P.sums = static_cast<float2*>(sums);
  void* args[] = {&P};
  const void* fn = is_bf16 ? kernel_fn<unsigned short>() : kernel_fn<float>();
  e = cudaLaunchCooperativeKernel(fn, dim3(sh.grid), dim3(THREADS), args,
                                  (size_t)sh.smem, s);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

#ifdef TDOA_TIMELINE
// The last launch's stamps, tl_k1 as laid out above.
extern "C" int tdoa_corr_accum_timeline(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, tl_k1, sizeof(tl_k1));
}
#endif
