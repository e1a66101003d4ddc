// K2 `fast_cells`: FAST-9 score, 3x3 NMS, per-cell best and per-level top-k.
//
// Replaces corbslam_tpu/ops/fast.py: fast_score_map, nms3x3 and
// select_keypoints_cells as called by detect_cells (score at min_th_fast).
//
// Bound on the H100: arithmetic on the CUDA cores, not memory. Every pixel
// of every level needs its 16 ring differences and the min/max over 16 arcs
// of 9 for both polarities (~200 f32 min/max), while it is read from memory
// once (~11 MB for a stereo pair's pyramid). The top-k is small (at most
// 1872 cells a level) but has to order ties exactly as jax.lax.top_k does.
// Design: `fast_cell_max` is one 256-thread block per cell (up to 16x16:
// the flagship's 16, the loop configuration's 12) of every level of both
// images (all in one launch, level found from the level table). The block
// stages the cell plus a 4-px halo (3 for the ring, 1 for NMS) in shared
// memory, scores the (cell+2)^2 cell+1 region (outside the image
// = -inf for NMS, the 16-px border = 0), keeps a pixel when its score is >=
// all 9 in its 3x3 neighbourhood (ties survive, as in the reference), and
// reduces to the cell's max and first row-major argmax with warp shuffles;
// cell pixels beyond the image count as 0. `fast_topk` gives each cell the
// rank #(greater value, or equal value and lower index) over its level's
// cells held in shared memory, and writes cells of rank < budget to slot
// `rank` — exactly top_k's order, in O(cells^2) compares per level with no
// sort; slots beyond the level's cell count are padded as the reference pads.

#include <math.h>

#include "common.cuh"

namespace {

constexpr int MAX_CELL = 16;
constexpr int BORDER = 16;
constexpr int MAX_IN = MAX_CELL + 8;  // cell + 4-px halo each side
constexpr int MAX_SC = MAX_CELL + 2;  // scores of the cell + 1-px NMS halo

__constant__ int8_t RING_Y[16] = {-3, -3, -2, -1, 0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3};
__constant__ int8_t RING_X[16] = {0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3, -3, -3, -2, -1};

__device__ __forceinline__ int level_of_cell(const int* table, int L, int cell) {
    int lvl = 0;
    while (lvl + 1 < L && table[(lvl + 1) * LV_NF + LV_CELL_OFF] <= cell) ++lvl;
    return lvl;
}

// Lexicographic (value desc, index asc) max of (v, i) across the block.
__device__ void block_argmax(float& v, int& i, float* sv, int* si) {
    for (int o = 16; o > 0; o >>= 1) {
        const float ov = __shfl_down_sync(0xffffffffu, v, o);
        const int oi = __shfl_down_sync(0xffffffffu, i, o);
        if (ov > v || (ov == v && oi < i)) { v = ov; i = oi; }
    }
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    if (lane == 0) { sv[warp] = v; si[warp] = i; }
    __syncthreads();
    if (warp == 0) {
        const int nw = blockDim.x >> 5;
        v = lane < nw ? sv[lane] : -INFINITY;
        i = lane < nw ? si[lane] : 0x7fffffff;
        for (int o = 16; o > 0; o >>= 1) {
            const float ov = __shfl_down_sync(0xffffffffu, v, o);
            const int oi = __shfl_down_sync(0xffffffffu, i, o);
            if (ov > v || (ov == v && oi < i)) { v = ov; i = oi; }
        }
    }
}

__global__ void __launch_bounds__(256) fast_cell_max_kernel(
        const float* __restrict__ levels, const int* __restrict__ table,
        float* __restrict__ cell_val, int* __restrict__ cell_arg, int L, int T, float th, int C,
        int CELL) {
    __shared__ float img[MAX_IN * MAX_IN];
    __shared__ float sc[MAX_SC * MAX_SC];
    const int IN = CELL + 8, SC = CELL + 2;
    __shared__ float red_v[8];
    __shared__ int red_i[8];
    const int cell = blockIdx.x, b = blockIdx.y, t = threadIdx.x;
    const int lvl = level_of_cell(table, L, cell);
    const int* lv = table + lvl * LV_NF;
    const int h = lv[LV_H], w = lv[LV_W], gx = lv[LV_GX];
    const int local = cell - lv[LV_CELL_OFF];
    const int y0 = (local / gx) * CELL, x0 = (local % gx) * CELL;
    const float* src = levels + (size_t)b * T + lv[LV_OFF];

    for (int i = t; i < IN * IN; i += blockDim.x) {
        const int r = i / IN, c = i % IN;
        img[r * IN + c] = read_or_zero(src, h, w, y0 - 4 + r, x0 - 4 + c);
    }
    __syncthreads();
    for (int i = t; i < SC * SC; i += blockDim.x) {
        const int r = i / SC, c = i % SC;
        const int py = y0 - 1 + r, px = x0 - 1 + c;
        float s;
        if (py < 0 || py >= h || px < 0 || px >= w) {
            s = -INFINITY;  // reduce_window's padding value
        } else if (py < BORDER || py >= h - BORDER || px < BORDER || px >= w - BORDER) {
            s = 0.f;
        } else {
            const float center = img[(r + 3) * IN + c + 3];
            float d[16];
#pragma unroll
            for (int k = 0; k < 16; ++k)
                d[k] = img[(r + 3 + RING_Y[k]) * IN + c + 3 + RING_X[k]] - center;
            float bright = -INFINITY, dark = INFINITY;
#pragma unroll
            for (int st = 0; st < 16; ++st) {
                float mn = d[st], mx = d[st];
#pragma unroll
                for (int j = 1; j < 9; ++j) {
                    mn = fminf(mn, d[(st + j) & 15]);
                    mx = fmaxf(mx, d[(st + j) & 15]);
                }
                bright = fmaxf(bright, mn);
                dark = fminf(dark, mx);
            }
            s = fmaxf(fmaxf(bright - th, -dark - th), 0.f);
        }
        sc[r * SC + c] = s;
    }
    __syncthreads();
    // Thread t holds the cell's row-major pixel t; threads past CELL^2 hold
    // -inf, below every pixel (scores are >= 0), so they never win.
    const int iy = t / CELL, ix = t % CELL;
    float v = t < CELL * CELL ? 0.f : -INFINITY;
    if (t < CELL * CELL && y0 + iy < h && x0 + ix < w) {
        const float s = sc[(iy + 1) * SC + ix + 1];
        float neigh = -INFINITY;
#pragma unroll
        for (int dy = 0; dy < 3; ++dy)
#pragma unroll
            for (int dx = 0; dx < 3; ++dx) neigh = fmaxf(neigh, sc[(iy + dy) * SC + ix + dx]);
        v = s >= neigh ? s : 0.f;
    }
    int arg = t;
    block_argmax(v, arg, red_v, red_i);
    if (t == 0) {
        cell_val[(size_t)b * C + cell] = v;
        cell_arg[(size_t)b * C + cell] = arg;
    }
}

__global__ void fast_topk_kernel(const float* __restrict__ cell_val, const int* __restrict__ cell_arg,
                                 const int* __restrict__ table, const float* __restrict__ scales,
                                 float* __restrict__ xy, float* __restrict__ resp,
                                 bool* __restrict__ valid, int* __restrict__ cell_id,
                                 int* __restrict__ oiy, int* __restrict__ oix,
                                 int* __restrict__ octave, int C, int N, int cell) {
    extern __shared__ float vals[];
    const int lvl = blockIdx.y, b = blockIdx.z;
    const int* lv = table + lvl * LV_NF;
    const int gx = lv[LV_GX], n = lv[LV_GY] * gx, k = lv[LV_BUDGET];
    const size_t cbase = (size_t)b * C + lv[LV_CELL_OFF];
    for (int j = threadIdx.x; j < n; j += blockDim.x) vals[j] = cell_val[cbase + j];
    __syncthreads();
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    int slot;
    if (i < n) {
        const float v = vals[i];
        int rank = 0;
        for (int j = 0; j < n; ++j) {
            const float u = vals[j];
            rank += (u > v) | ((u == v) & (j < i));
        }
        if (rank >= k) return;
        slot = lv[LV_KP_OFF] + rank;
        const int arg = cell_arg[cbase + i];
        const int iy = arg / cell, ix = arg % cell;
        const float s = scales[lvl];
        const size_t o = (size_t)b * N + slot;
        xy[2 * o] = (float)((i % gx) * cell + ix) * s;
        xy[2 * o + 1] = (float)((i / gx) * cell + iy) * s;
        resp[o] = v;
        valid[o] = v > 0.f;
        cell_id[o] = i;
        oiy[o] = iy;
        oix[o] = ix;
        octave[o] = lvl;
    } else if (i < k) {  // fewer cells than budget: zero-padded slots
        slot = lv[LV_KP_OFF] + i;
        const size_t o = (size_t)b * N + slot;
        xy[2 * o] = 0.f;
        xy[2 * o + 1] = 0.f;
        resp[o] = 0.f;
        valid[o] = false;
        cell_id[o] = 0;
        oiy[o] = 0;
        oix[o] = 0;
        octave[o] = lvl;
    }
}

}  // namespace

// Max and first argmax of the NMS'd FAST score in each of the C cells
// (cell x cell pixels, cell <= 16) of all L levels, for B images:
// cell_val/cell_arg [B, C].
C_ENTRY int fast_cell_max(const float* levels, const int* level_table, float* cell_val,
                          int* cell_arg, int L, int B, int T, float th, int C, int cell,
                          cudaStream_t stream) {
    if (cell < 1 || cell > MAX_CELL) return (int)cudaErrorInvalidValue;
    fast_cell_max_kernel<<<dim3(C, B), 256, 0, stream>>>(levels, level_table, cell_val, cell_arg,
                                                         L, T, th, C, cell);
    return (int)cudaGetLastError();
}

// Top-budget cells of each level into the [B, N] keypoint slots.
// max_cells: the largest level's cell count (shared memory); max_slots:
// max over levels of max(cells, budget) (grid x).
C_ENTRY int fast_topk(const float* cell_val, const int* cell_arg, const int* level_table,
                      const float* scales, float* xy, float* resp, bool* valid, int* cell_id,
                      int* iy, int* ix, int* octave, int L, int B, int C, int N, int max_cells,
                      int max_slots, int cell, cudaStream_t stream) {
    const dim3 grid((max_slots + 255) / 256, L, B);
    fast_topk_kernel<<<grid, 256, max_cells * sizeof(float), stream>>>(
        cell_val, cell_arg, level_table, scales, xy, resp, valid, cell_id, iy, ix, octave, C, N,
        cell);
    return (int)cudaGetLastError();
}
