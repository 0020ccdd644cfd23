// Grid-wide barrier for the kernel that runs as one cooperative launch
// (zoom_probe.cu), and the timeline stamps of all three kernels.
#pragma once

#include <cuda_runtime.h>

namespace tdoa {

// The SM's nanosecond clock (%globaltimer).
__device__ __forceinline__ unsigned long long now_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Every CTA arrives once per barrier on *bar, which the host zeroes
// before the launch, so the n-th barrier (n = 1, 2, ...) waits for the
// count gridDim.x * n. The fences make each CTA's writes before the
// barrier visible to every CTA after it (the pattern of cooperative
// groups' grid.sync). A wait of more than 10 s means the co-residency a
// cooperative launch guarantees is broken: trap rather than hang.
__device__ __forceinline__ void grid_sync(unsigned* bar, unsigned target) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(bar, 1u);
    const unsigned long long t0 = now_ns();
    unsigned seen;
    for (;;) {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
                   : "=r"(seen) : "l"(bar) : "memory");
      if (seen >= target) break;
      __nanosleep(32);
      if (now_ns() - t0 > 10000000000ull) __trap();
    }
    __threadfence();
  }
  __syncthreads();
}

}  // namespace tdoa

// Timeline stamps: the statements inside TDOA_TL(...) are compiled only
// with -DTDOA_TIMELINE (scripts/kernel_timeline.py builds the kernels so
// and reads the stamps back); otherwise they vanish.
#ifdef TDOA_TIMELINE
#define TDOA_TL(...) __VA_ARGS__
#else
#define TDOA_TL(...)
#endif
