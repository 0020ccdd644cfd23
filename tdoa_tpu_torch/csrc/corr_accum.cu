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
// between the stages is 512 KB per station and segment, 0.70 GB a
// block, written once and read back once. The first port wrote it to a
// 64 MB device scratch, ran each 256-point transform as 8 radix-2
// stages behind 8 barriers with half the threads idle in every other
// round, and gave stage 2 one CTA per (row, bank) walking its bank's
// segments one at a time: 3.2 ms, barrier- and latency-bound. Keeping an item's
// accumulators on chip caps the CTAs at two per SM (16 warps), so what
// is left is latency: every load is issued one step ahead of its use.
//
// What this design does about it.
//  * Every 256-point transform is 16 x 16: a radix-16 pass in one
//    thread's registers, one exchange through a padded, bank-conflict-
//    free shared-memory slot, the twiddle, a second radix-16 pass. A
//    row transform belongs to 16 lanes of one warp, so its exchange
//    needs only __syncwarp; stage 1 transforms 16 columns per CTA with
//    two barriers.
//  * The hand-off keeps each row k1's 256 columns in order, 2 KB: the
//    16 lanes of a stage-1 store write 128 contiguous bytes, and the 16
//    lanes that transform the row in stage 2 read it as 16 runs of 128
//    contiguous bytes. (Columns stored in pairs, so that stage 2 reads
//    16 bytes a lane, measured slower: a stage-1 store then fills half
//    of each sector.)
//  * Two launches a block. Stage 1 transforms every segment of every
//    station into one scratch in HBM, n_st x 512 KB a segment (0.70 GB
//    at 3 stations and 443 segments, 2.7 GB at 12, 5.6 GB at 24). Stage
//    2 gives each CTA one item, a (bank, row k1), at a time (items cta,
//    cta + grid, ...: CTAs that run together hold neighbouring rows, so
//    their stores to the true-frequency outputs meet in the same
//    sectors): its accumulators, n_slots rows of 256 f32 (bins k1 +
//    256*k2), are zeroed in shared memory, its bank's segments stream
//    past in rounds of tuples (a segment, all stations), spread over 16
//    lane groups, thread t adds bin t into the accumulators, and they
//    reach the outputs once. Stage 1 depends on the rows alone, so the
//    host launches it once for all pair tiles of a row block (13
//    stations and up). One footprint formula, smem_bytes, says where not
//    even one item fits a CTA: the host then tiles the pair list, and
//    the routing gate (fits_device) reads that the kernel cannot run
//    the shape.
//  * Its bound on the H100 is the hand-off's round trip (2 x 2.7 GB at
//    12 stations, 1.6 ms at 3.35 TB/s, against 0.68 ms of f32
//    operations), and 213,712 B of shared memory a CTA at 12 stations:
//    one CTA (8 warps) per SM in stage 2, whose sums are then paced by
//    shared-memory traffic (two rows and two accumulators a pair and a
//    segment). At 3 stations it replaced one cooperative launch whose
//    CTAs kept all of their items on chip while L2-sized chunks of the
//    hand-off passed, behind a grid-wide barrier a chunk: 0.91 against
//    1.08 ms at 443 segments, 3.0 against 3.5 ms at 1479, bitwise the
//    same outputs.
//  * Loads run one step ahead: a stage-1 unit's input is fetched while
//    the previous unit computes, a stage-2 round's rows while the
//    previous round accumulates.
//  * No atomics on data: every sum runs in segment order, so two
//    launches give bitwise-equal outputs. All arithmetic is f32 (input
//    bf16 or f32). The twiddles come from 256-entry tables of sincospif
//    on exactly representable arguments; the stage-1 twiddle of
//    exponent e = k1*c is the product of the entries for e >> 8 and
//    e & 255 (one rounding more than a direct sincospif).

#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>
#include <mutex>
#include <vector>

#include "grid_sync.cuh"  // tdoa::now_ns and TDOA_TL: the timeline stamps

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
// Stage 2's most tuples a round (4 stations: 4, 3 or fewer: 5); s2_sum
// is unrolled for each count.
constexpr int S2_MAX_NT = 5;

#ifdef TDOA_TIMELINE
// The last launch pair: stage 1's first CTA start and last CTA end,
// stage 2's the same (over all CTAs), then CTA 0 of stage 2: ns fetching
// and transforming, ns accumulating, ns storing, rounds.
constexpr int TL_S = 8;
__device__ unsigned long long tl_k1s[TL_S] = {~0ull, 0, ~0ull, 0, 0, 0, 0, 0};
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

// Shared memory of a stage-2 CTA, which holds one item's accumulators:
// tw, tw2, twl [R] float2 | xbuf [x_slots][SLOT] float2 | flags
// [x_slots] int | pairs [2m] int | acc [n_slots][R] f32 (int arrays
// padded to 16 B).
__host__ __device__ inline int smem_bytes(int n_st, int m, int track) {
  return 3 * R * 8 + x_slots(n_st) * SLOT * 8 + 4 * pad4(x_slots(n_st)) +
         4 * pad4(2 * m) + n_slots(n_st, m, track) * R * 4;
}

// Shared memory of a stage-1 CTA: the twiddle tables and the 16 column
// slots.
__host__ __device__ inline int smem_s1_bytes() {
  return 3 * R * 8 + GROUPS * SLOT * 8;
}

struct Params {
  const void* xr;
  const void* xi;
  long long st_stride;  // elements between stations
  int n_st, m, track, n_banks;
  const int* pairs;     // [m, 2]
  const int* plan;      // [n_banks * run]: bank b's slots b * run ..
                        // hold its segments in order, -1 past its end
  int run;              // slots a bank: the longest bank's segments
  float2* scratch;      // [n_st][n_banks * run][F]: stage 1's hand-off
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

// Stage-1 unit u: (station, segment slot, 16-column tile).
__device__ __forceinline__ void unit_of(int u, int S, int& st, int& sl,
                                        int& tile) {
  tile = u & 15;
  sl = (u >> 4) % S;
  st = (u >> 4) / S;
}

template <typename T>
__device__ __forceinline__ void s1_fetch(const Params& P, int u,
                                         Raw1<T>& raw) {
  const int S = P.n_banks * P.run;
  raw.ok = false;
  if (u >= P.n_st * S * 16) return;
  int st, sl, tile;
  unit_of(u, S, st, sl, tile);
  const int seg = __ldg(P.plan + sl);
  if (seg < 0) return;  // past its bank's end
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

// Stage 1 of unit u into the scratch. Thread (col = t & 15, n2 = t >>
// 4) runs the first radix-16 pass down its column over rows 16*n1 + n2
// (rows >= 176 are the zero padding), the CTA exchanges through shared
// memory, thread (col, k1 = t >> 4) runs the second pass and applies
// exp(-2*pi*i*k*c/65536).
template <typename T>
__device__ __forceinline__ void s1_compute(const Params& P, int u,
                                           const Raw1<T>& raw,
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
  float2* out = P.scratch + ((long long)st * S + sl) * FFT_LEN + c;
#pragma unroll
  for (int k2 = 0; k2 < 16; ++k2) {
    const int k = hi + 16 * k2, e = k * c;  // e < 65536
    const float2 w = cmul(tw[e >> 8], twl[swz(e & 255)]);
    __stcg(out + k * R, cmul(v[pos16(k2)], w));
  }
  __syncthreads();  // xbuf is reused by the next unit
}

// Loads into v the row of transform tr = (tuple l0 + tr / n_st,
// station tr % n_st) of a round of item `item`, whose tuples are its
// bank's segment slots l0 .. l0 + nt - 1 (zeros past the round's
// transforms). Returns whether the tuple's segment slot holds a
// segment: past a bank's end it does not, and its row is never summed.
__device__ __forceinline__ bool s2_fetch(const Params& P, int item, int l0,
                                         int nt, int tr, float2 (&v)[16]) {
  const int n_st = P.n_st, run = P.run, S = P.n_banks * run;
  const bool act = tr < nt * n_st;
  const int q = act ? tr / n_st : 0, st = tr - q * n_st;
  const int sl = (item / R) * run + l0 + q;
  const float2* row =
      P.scratch + ((long long)st * S + sl) * FFT_LEN + (item % R) * R;
  const int l16 = threadIdx.x & 15;
#pragma unroll
  for (int n1 = 0; n1 < 16; ++n1)
    v[n1] = act ? __ldcg(row + 16 * n1 + l16) : make_float2(0.f, 0.f);
  return act && __ldg(P.plan + sl) >= 0;
}

// Thread t adds bin t of a round's transformed tuples (xbuf), the
// first NT of which hold a segment (a bank's slots past its end come
// last in its run, so the others are never summed), into the item's
// accumulators, in tuple order: unrolled over the tuples and four pairs
// at a time, with no aliasing between the accumulators, the transformed
// rows and the pair list, so the loads of several pairs are in flight
// at once.
template <int NT>
__device__ __forceinline__ void s2_sum(const Params& P,
                                       float* __restrict__ acc,
                                       const float2* __restrict__ xbuf,
                                       const int* __restrict__ pr) {
  const int n_st = P.n_st, m = P.m, t = threadIdx.x;
  const int pos = (t & 15) + 17 * (t >> 4);
  float* __restrict__ a_cr = acc;
  float* __restrict__ a_ci = a_cr + m * R;
  float* __restrict__ a_psd = a_ci + m * R;
  float* __restrict__ a_sr = a_psd + n_st * R;
  float* __restrict__ a_si = a_sr + n_st * R;
#pragma unroll 4
  for (int st = 0; st < n_st; ++st) {
    float ps = a_psd[st * R + t];
    float sr = P.track ? a_sr[st * R + t] : 0.f;
    float si = P.track ? a_si[st * R + t] : 0.f;
#pragma unroll
    for (int q = 0; q < NT; ++q) {
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
  const int2* __restrict__ pr2 = reinterpret_cast<const int2*>(pr);
#pragma unroll 4
  for (int p = 0; p < m; ++p) {
    const int2 ij = pr2[p];
    float cr = a_cr[p * R + t], ci = a_ci[p * R + t];
#pragma unroll
    for (int q = 0; q < NT; ++q) {
      const float2 xi = xbuf[(q * n_st + ij.x) * SLOT + pos];
      const float2 xj = xbuf[(q * n_st + ij.y) * SLOT + pos];
      cr += xj.x * xi.x + xj.y * xi.y;
      ci += xj.y * xi.x - xj.x * xi.y;
    }
    a_cr[p * R + t] = cr;
    a_ci[p * R + t] = ci;
  }
}

// Stage 2's last step for an item: its accumulators to the outputs
// (bin t of row `row` of bank b is true frequency row + 256*t). Thread t
// stores bin t: the CTAs that run beside this one store the neighbouring
// rows' bins, so the sectors of the outputs fill together.
__device__ __forceinline__ void store_item(const Params& P, const float* a,
                                           int item) {
  const int n_st = P.n_st, m = P.m, t = threadIdx.x;
  const long long F = FFT_LEN;
  const int b = item / R;
  const long long bin = item % R + (long long)R * t;
  const float* a_cr = a;
  const float* a_ci = a + m * R;
  const float* a_psd = a + 2 * m * R;
  const float* a_sr = a_psd + n_st * R;
  const float* a_si = a_sr + n_st * R;
  for (int p = 0; p < m; ++p) {
    P.cross[((long long)b * m + p) * F + bin] =
        make_float2(a_cr[p * R + t], a_ci[p * R + t]);
  }
  for (int st = 0; st < n_st; ++st) {
    P.psd[((long long)b * n_st + st) * F + bin] = a_psd[st * R + t];
    if (P.track) {
      P.sums[((long long)b * n_st + st) * F + bin] =
          make_float2(a_sr[st * R + t], a_si[st * R + t]);
    }
  }
}

// The twiddle tables in shared memory: tw[e] = exp(-2 pi i e/256),
// tw2[16*k1 + n2] = exp(-2 pi i n2 k1/256), twl[swz(e)] = exp(-2 pi i
// e/65536), e < 256. Ends with a CTA barrier.
__device__ __forceinline__ void init_tables(float2* tw, float2* tw2,
                                            float2* twl) {
  const int t = threadIdx.x;
  float s, c;
  sincospif(-(float)t / 128.0f, &s, &c);
  tw[t] = make_float2(c, s);
  sincospif(-(float)t / 32768.0f, &s, &c);
  twl[swz(t)] = make_float2(c, s);
  __syncthreads();
  tw2[t] = tw[(t & 15) * (t >> 4)];
  __syncthreads();
}

// Stage 1: every (station, segment slot, 16-column tile) unit into the
// scratch, each unit's input fetched while the previous unit computes.
template <typename T>
__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM)
corr_accum_kernel_s1(Params P) {
  extern __shared__ float4 smem_raw[];
  float2* tw = reinterpret_cast<float2*>(smem_raw);
  float2* tw2 = tw + R;
  float2* twl = tw2 + R;
  float2* xbuf = twl + R;
  const int G = gridDim.x;
  const int n_units = P.n_st * P.n_banks * P.run * 16;
  TDOA_TL(if (threadIdx.x == 0) atomicMin(&tl_k1s[0], tdoa::now_ns());)
  init_tables(tw, tw2, twl);
  Raw1<T> raw;
  s1_fetch<T>(P, blockIdx.x, raw);
  for (int u = blockIdx.x; u < n_units; u += G) {
    const Raw1<T> cur = raw;
    s1_fetch<T>(P, u + G, raw);
    if (cur.ok) s1_compute<T>(P, u, cur, tw, tw2, twl, xbuf);
  }
  TDOA_TL(if (threadIdx.x == 0) atomicMax(&tl_k1s[1], tdoa::now_ns());)
}

// Stage 2: CTA cta owns the items cta, cta + G, ... one at a time. An
// item's accumulators are zeroed in shared memory, its bank's segment
// slots (P.run of them) stream past in rounds of tpr tuples — the next
// round's rows fetched while this one accumulates, across the items'
// boundaries too — and reach the outputs once.
__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM)
corr_accum_kernel_s2(Params P) {
  extern __shared__ float4 smem_raw[];
  const int n_st = P.n_st, run = P.run;
  const int xs = x_slots(n_st);
  float2* tw = reinterpret_cast<float2*>(smem_raw);
  float2* tw2 = tw + R;
  float2* twl = tw2 + R;
  float2* xbuf = twl + R;
  int* flags = reinterpret_cast<int*>(xbuf + xs * SLOT);
  int* pr = flags + pad4(xs);
  float* acc = reinterpret_cast<float*>(pr + pad4(2 * P.m));

  const int t = threadIdx.x, G = gridDim.x, cta = blockIdx.x;
  const int l16 = t & 15;
  const int nsl = n_slots(n_st, P.m, P.track);
  const int n_items = R * P.n_banks;
  const int n_mine = cta < n_items ? (n_items - 1 - cta) / G + 1 : 0;
  const int tpr = min(xs / n_st, S2_MAX_NT);      // tuples per round
  const int rpi = (run + tpr - 1) / tpr;          // rounds per item
  const int nr = n_mine * rpi;
  const int n_iter = (xs + GROUPS - 1) / GROUPS;  // transforms per group
  const int slot0 = 2 * (t >> 5) + ((t >> 4) & 1);  // this group's
  TDOA_TL(const bool tl = t == 0;
          if (tl) atomicMin(&tl_k1s[2], tdoa::now_ns());
          unsigned long long T0 = 0, D1 = 0, D2 = 0, D3 = 0;)

  for (int e = t; e < 2 * P.m; e += THREADS) pr[e] = P.pairs[e];
  init_tables(tw, tw2, twl);

  // Round r: item cta + G * (r / rpi), tuples l0 .. l0 + nt - 1 of it.
  int item = cta, l0 = 0, nt = min(tpr, run);
  float2 v[16];
  bool ok = false;
  if (nr > 0) ok = s2_fetch(P, item, l0, nt, slot0, v);
  for (int r = 0; r < nr; ++r) {
    TDOA_TL(T0 = tdoa::now_ns();)
    const int n_tr = nt * n_st;
    for (int i = 0; i < n_iter; ++i) {
      const int tr = slot0 + GROUPS * i;
      if (i > 0) ok = s2_fetch(P, item, l0, nt, tr, v);
      fft256_row(v, xbuf + tr * SLOT, tw2, l16, tr < n_tr);
      if (l16 == 0 && tr < n_tr && tr % n_st == 0) flags[tr / n_st] = ok;
    }
    const int cur_item = item, cur_l0 = l0, cur_nt = nt;
    if (r + 1 < nr) {
      l0 += tpr;
      if (l0 >= run) {
        l0 = 0;
        item += G;
      }
      nt = min(tpr, run - l0);
      ok = s2_fetch(P, item, l0, nt, slot0, v);
    }
    __syncthreads();
    TDOA_TL(const unsigned long long T1 = tdoa::now_ns(); D1 += T1 - T0;)
    if (cur_l0 == 0) {
      for (int s = 0; s < nsl; ++s) acc[s * R + t] = 0.f;
    }
    int nv = 0;  // the round's tuples that hold a segment: a prefix
    while (nv < cur_nt && flags[nv]) ++nv;
    switch (nv) {  // 0 <= nv <= tpr <= S2_MAX_NT
      case 1: s2_sum<1>(P, acc, xbuf, pr); break;
      case 2: s2_sum<2>(P, acc, xbuf, pr); break;
      case 3: s2_sum<3>(P, acc, xbuf, pr); break;
      case 4: s2_sum<4>(P, acc, xbuf, pr); break;
      case 5: s2_sum<5>(P, acc, xbuf, pr); break;
      default: break;
    }
    TDOA_TL(const unsigned long long T2 = tdoa::now_ns(); D2 += T2 - T1;)
    if (cur_l0 + cur_nt == run) store_item(P, acc, cur_item);
    TDOA_TL(D3 += tdoa::now_ns() - T2;)
    __syncthreads();  // xbuf and flags are refilled by the next round
  }
  TDOA_TL(if (tl) {
    atomicMax(&tl_k1s[3], tdoa::now_ns());
    if (cta == 0) {
      tl_k1s[4] = D1;
      tl_k1s[5] = D2;
      tl_k1s[6] = D3;
      tl_k1s[7] = nr;
    }
  })
}

template <typename T>
const void* s1_fn() {
  return reinterpret_cast<const void*>(&corr_accum_kernel_s1<T>);
}
const void* s2_fn() {
  return reinterpret_cast<const void*>(&corr_accum_kernel_s2);
}

// A launch shape: stage 2's grid, its CTAs per SM and dynamic shared
// memory bytes, and stage 1's grid.
struct Shape {
  int grid, bps, smem, grid1;
};

// The launch shape on the current device: stage 1 at the CTAs per SM
// its registers and shared memory allow, stage 2 at the most (up to
// BLOCKS_PER_SM) at which each CTA holds one item's accumulators. Opts
// the kernels into the shared memory they need. Returns 0 or a
// cudaError_t (cudaErrorInvalidConfiguration when not even one item
// fits a CTA: the kernel cannot run this shape on this device).
int choose(int n_st, int m, int track, int is_bf16, Shape* out) {
  const void* s1 = is_bf16 ? s1_fn<unsigned short>() : s1_fn<float>();
  const void* s2 = s2_fn();
  int dev, n_sm, optin;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  for (const void* fn : {s1, s2}) {
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               optin);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(fn,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  }
  if (e != cudaSuccess) return (int)e;
  int per_sm1 = 0, per_sm2 = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm1, s1, THREADS,
                                                    smem_s1_bytes());
  if (e != cudaSuccess) return (int)e;
  const int smem = smem_bytes(n_st, m, track);
  if (smem <= optin) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm2, s2, THREADS,
                                                      smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int bps = per_sm2 < BLOCKS_PER_SM ? per_sm2 : BLOCKS_PER_SM;
  if (per_sm1 < 1 || bps < 1) return (int)cudaErrorInvalidConfiguration;
  *out = Shape{bps * n_sm, bps, smem, per_sm1 * n_sm};
  return 0;
}

// choose, computed once per device and shape.
int shape_for(int n_st, int m, int track, int is_bf16, Shape* out) {
  constexpr int NK = 5;
  struct Entry {
    int key[NK];
    Shape shape;
  };
  static std::mutex mu;
  static std::vector<Entry> cache;
  int dev;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  const int key[NK] = {dev, n_st, m, track, is_bf16};
  std::lock_guard<std::mutex> lock(mu);
  for (const Entry& c : cache) {
    bool hit = true;
    for (int i = 0; i < NK; ++i) hit = hit && c.key[i] == key[i];
    if (hit) {
      *out = c.shape;
      return 0;
    }
  }
  const int err = choose(n_st, m, track, is_bf16, out);
  if (err != 0) return err;
  Entry c;
  for (int i = 0; i < NK; ++i) c.key[i] = key[i];
  c.shape = *out;
  cache.push_back(c);
  return 0;
}

}  // namespace

// The launch shape tdoa_corr_accum takes on the current device: out =
// {stage-2 grid, its CTAs per SM, its shared memory bytes, stage-1
// grid}. Returns 0, cudaErrorInvalidConfiguration where the kernel
// cannot run the shape on this device (the routing gate fits_device),
// or another cudaError_t.
extern "C" int tdoa_corr_accum_config(int n_st, int m, int track, int is_bf16,
                                      int* out) {
  Shape sh;
  const int e = shape_for(n_st, m, track, is_bf16, &sh);
  if (e != 0) return e;
  out[0] = sh.grid;
  out[1] = sh.bps;
  out[2] = sh.smem;
  out[3] = sh.grid1;
  return 0;
}

// Accumulate one capture on `stream` in the shape tdoa_corr_accum_config
// gives: stage 1 into `scratch`, then stage 2. `plan` holds n_banks *
// run segment slots (bank b's segments in order from slot b * run, -1
// past its end). With reuse_stage1 stage 1 is skipped: `scratch`
// already holds the hand-off of these rows and this plan (another pair
// tile's launch over the same rows wrote it). Returns 0 or the
// cudaError_t of the refused launch.
extern "C" int tdoa_corr_accum(const void* xr, const void* xi, int is_bf16,
                               long long st_stride, int n_st,
                               const int* pairs, int m, int n_banks,
                               int track, const int* plan, int run,
                               int reuse_stage1, void* scratch, void* cross,
                               void* psd, void* sums, void* stream) {
  Shape sh;
  const int err = shape_for(n_st, m, track, is_bf16, &sh);
  if (err != 0) return err;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
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
  P.run = run;
  P.scratch = static_cast<float2*>(scratch);
  P.cross = static_cast<float2*>(cross);
  P.psd = static_cast<float*>(psd);
  P.sums = static_cast<float2*>(sums);
  void* args[] = {&P};
  cudaError_t e;
  if (!reuse_stage1) {
    e = cudaLaunchKernel(is_bf16 ? s1_fn<unsigned short>() : s1_fn<float>(),
                         dim3(sh.grid1), dim3(THREADS), args,
                         (size_t)smem_s1_bytes(), s);
    if (e != cudaSuccess) return (int)e;
  }
  e = cudaLaunchKernel(s2_fn(), dim3(sh.grid), dim3(THREADS), args,
                       (size_t)sh.smem, s);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

#ifdef TDOA_TIMELINE
// The last launch pair's stamps (tl_k1s, as laid out above), then reset
// for the next launch pair.
extern "C" int tdoa_corr_accum_timeline(unsigned long long* out) {
  cudaError_t e = cudaMemcpyFromSymbol(out, tl_k1s, sizeof(tl_k1s));
  const unsigned long long init[TL_S] = {~0ull, 0, ~0ull, 0, 0, 0, 0, 0};
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(tl_k1s, init, sizeof(init));
  return (int)e;
}
#endif
