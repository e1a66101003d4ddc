// Shared helpers of the port's CUDA kernels (plain C entry points, ctypes-bound).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define C_ENTRY extern "C" __attribute__((visibility("default")))

// Per-level layout rows of OrbParams.level_table ([L, 8] int32).
enum LevelField { LV_H = 0, LV_W, LV_OFF, LV_GY, LV_GX, LV_CELL_OFF, LV_BUDGET, LV_KP_OFF, LV_NF };

// Pixel read that returns 0 outside the image (the reference's zero pad).
__device__ __forceinline__ float read_or_zero(const float* img, int h, int w, int y, int x) {
    return (y >= 0 && y < h && x >= 0 && x < w) ? img[y * w + x] : 0.f;
}

// `%globaltimer` stamps of a kernel's phases, for `kernel_times.stamped`,
// which rebuilds with -DKERNEL_STAMPS: stamp(w, i) raises word w[i] to the
// current time in ns, so that each word ends as the latest stamp of its
// point. Without the define it is empty.
__device__ __forceinline__ void stamp(unsigned long long* w, int i) {
#ifdef KERNEL_STAMPS
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    atomicMax(w + i, t);
#endif
}
