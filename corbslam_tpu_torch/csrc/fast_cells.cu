// K2 `fast_cells`: FAST-9 score, 3x3 NMS, per-cell best and per-level top-k.
//
// Replaces corbslam_tpu/ops/fast.py: fast_score_map, nms3x3 and
// select_keypoints_cells as called by detect_cells (score at min_th_fast).
//
// Bound on the H100: arithmetic on the CUDA cores, not memory. Every pixel
// of every level needs its 16 ring differences and the min/max over 16 arcs
// of 9 for both polarities, while it is read from memory once (~11 MB for a
// stereo pair's pyramid). The top-k is small (at most 1872 cells a level at
// the flagship's width) but has to order ties exactly as jax.lax.top_k does.
// Design: `fast_cell_max` is one 256-thread CTA per tile of tcx x tcy cells
// (the wrapper picks 64 x 32 px: 4 x 2 cells of 16 px, 5 x 2 of 12) of
// every level of both images, all in one launch; the CTA finds its level
// from the level table's grids. It stages the tile plus a 4-px halo (3 for
// the ring, 1 for NMS) in shared memory, then scores the tile plus 1 px
// (outside the image = -inf for NMS, the 16-px border = 0), neighbouring
// pixels on neighbouring threads, several a thread, the arc min / max as
// the plain version's log-depth windows 2, 4, 8 (64 min and 64 max a
// pixel). An exact early-out (fewer than two of ring points 0, 4, 8, 12
// beyond +-th scores 0) was measured slower on the flagship's texture,
// where 68 % of the interior pixels pass it and nearly every 32-pixel row
// segment holds one that does (`kernel_times`), so a warp runs both
// paths; listing the passing pixels for a second pass was slower as well.
// Each warp then takes one cell at a time: a pixel survives NMS when its
// score is >= all 9 of its 3x3 neighbourhood (ties survive, as in the
// reference), and a warp argmax keeps the cell's max and first row-major
// argmax; cell pixels beyond the image count as 0. `fast_topk` is one CTA per (level, image)
// over 64-bit keys (value descending, cell ascending: top_k's order): a
// radix select of the budget-th key's value in four 8-bit passes (warp-
// aggregated shared-memory histograms), the keys before it and the first
// of its ties in cell order gathered, and a bitonic sort of those alone in
// shared memory (strides below 64 in registers); slot r < budget takes the
// r-th, and slots beyond the level's cell count are padded as the
// reference pads. Sorting all of a level's cells (2048 keys at level 0)
// took 15 µs on one SM.

#include <math.h>

#include "common.cuh"

namespace {

constexpr int MAX_CELL = 16;
constexpr int BORDER = 16;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int TILE_W = 64;  // the most pixels a tile spans in x and y
constexpr int TILE_H = 32;
constexpr int IN_W = TILE_W + 8, IN_H = TILE_H + 8;  // + 4-px halo each side
constexpr int SC_W = TILE_W + 2, SC_H = TILE_H + 2;  // + 1-px NMS halo
constexpr int STAGE_STEPS = (IN_W * IN_H + THREADS - 1) / THREADS;
constexpr int TOPK_THREADS = 1024;

// FAST-9 score of the pixel at img[o] (row stride IN_W): max over the 16
// contiguous 9-arcs of the arc's weakest margin beyond th, bright or dark,
// clipped at 0.
__device__ __forceinline__ float fast_score(const float* img, int o, float th) {
    const int RING_Y[16] = {-3, -3, -2, -1, 0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3};
    const int RING_X[16] = {0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3, -3, -3, -2, -1};
    const float center = img[o];
    float d[16];
#pragma unroll
    for (int k = 0; k < 16; ++k) d[k] = img[o + RING_Y[k] * IN_W + RING_X[k]] - center;
    // Circular windows: w2[i] = min(d[i], d[i+1]), then w4, w8, and the
    // 9-arc min(w8[s], d[s+8]); then the same with max for the dark arcs.
    float m[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) m[i] = fminf(d[i], d[(i + 1) & 15]);
#pragma unroll
    for (int w = 2; w <= 4; w *= 2) {
        float m2[16];
#pragma unroll
        for (int i = 0; i < 16; ++i) m2[i] = fminf(m[i], m[(i + w) & 15]);
#pragma unroll
        for (int i = 0; i < 16; ++i) m[i] = m2[i];
    }
    float bright = -INFINITY;
#pragma unroll
    for (int s = 0; s < 16; ++s) bright = fmaxf(bright, fminf(m[s], d[(s + 8) & 15]));
#pragma unroll
    for (int i = 0; i < 16; ++i) m[i] = fmaxf(d[i], d[(i + 1) & 15]);
#pragma unroll
    for (int w = 2; w <= 4; w *= 2) {
        float m2[16];
#pragma unroll
        for (int i = 0; i < 16; ++i) m2[i] = fmaxf(m[i], m[(i + w) & 15]);
#pragma unroll
        for (int i = 0; i < 16; ++i) m[i] = m2[i];
    }
    float dark = INFINITY;
#pragma unroll
    for (int s = 0; s < 16; ++s) dark = fminf(dark, fmaxf(m[s], d[(s + 8) & 15]));
    return fmaxf(fmaxf(bright - th, -dark - th), 0.f);
}

__global__ void __launch_bounds__(THREADS, 4) fast_cell_max_kernel(
        const float* __restrict__ levels, const int* __restrict__ table,
        float* __restrict__ cell_val, int* __restrict__ cell_arg, int L, int T, float th, int C,
        int cell, int tcx, int tcy) {
    __shared__ float img[IN_W * IN_H];  // rows of IN_W, whatever the tile's width
    __shared__ float sc[SC_W * SC_H];
    const int b = blockIdx.y, t = threadIdx.x, lane = t & 31, warp = t >> 5;
    // The level of this tile: tiles are numbered level by level, row-major.
    int tile = blockIdx.x, lvl = 0, ntx = 0;
    for (;; ++lvl) {
        if (lvl == L) return;
        const int* lv = table + lvl * LV_NF;
        ntx = (lv[LV_GX] + tcx - 1) / tcx;
        const int n = ntx * ((lv[LV_GY] + tcy - 1) / tcy);
        if (tile < n) break;
        tile -= n;
    }
    const int* lv = table + lvl * LV_NF;
    const int h = lv[LV_H], w = lv[LV_W], gx = lv[LV_GX], gy = lv[LV_GY];
    const int cx0 = (tile % ntx) * tcx, cy0 = (tile / ntx) * tcy;
    const int x0 = cx0 * cell, y0 = cy0 * cell;
    const int tw = tcx * cell, th_px = tcy * cell;
    const int iw = tw + 8, ih = th_px + 8, sw = tw + 2, sh = th_px + 2;
    const float* src = levels + (size_t)b * T + lv[LV_OFF];

    // Flat loops over the tile's rows of iw (ih) and sw (sh) pixels: (r, c)
    // steps by THREADS = qr rows + qc columns, without a division. The
    // staging starts all of a thread's loads before its stores.
    {
        const int qr = THREADS / iw, qc = THREADS % iw;
        float v[STAGE_STEPS];
        int r = t / iw, c = t % iw;
#pragma unroll
        for (int j = 0; j < STAGE_STEPS; ++j) {
            v[j] = r < ih ? read_or_zero(src, h, w, y0 - 4 + r, x0 - 4 + c) : 0.f;
            r += qr;
            c += qc;
            if (c >= iw) {
                c -= iw;
                ++r;
            }
        }
        r = t / iw;
        c = t % iw;
#pragma unroll
        for (int j = 0; j < STAGE_STEPS; ++j) {
            if (r < ih) img[r * IN_W + c] = v[j];
            r += qr;
            c += qc;
            if (c >= iw) {
                c -= iw;
                ++r;
            }
        }
    }
    __syncthreads();
    {
        const int qr = THREADS / sw, qc = THREADS % sw;
        for (int r = t / sw, c = t % sw; r < sh;) {
            const int py = y0 - 1 + r, px = x0 - 1 + c;
            float s;
            if (py < 0 || py >= h || px < 0 || px >= w) {
                s = -INFINITY;  // reduce_window's padding value
            } else if (py < BORDER || py >= h - BORDER || px < BORDER || px >= w - BORDER) {
                s = 0.f;
            } else {
                s = fast_score(img, (r + 3) * IN_W + c + 3, th);
            }
            sc[r * SC_W + c] = s;
            r += qr;
            c += qc;
            if (c >= sw) {
                c -= sw;
                ++r;
            }
        }
    }
    __syncthreads();
    const int px_cell = cell * cell;
    for (int ci = warp; ci < tcx * tcy; ci += WARPS) {
        const int ccx = cx0 + ci % tcx, ccy = cy0 + ci / tcx;
        if (ccx >= gx || ccy >= gy) continue;
        float v = -INFINITY;
        int arg = 0x7fffffff;
        const int qy = 32 / cell, qx = 32 % cell;
        for (int p = lane, iy = lane / cell, ix = lane % cell; p < px_cell; p += 32) {
            const int y = ccy * cell + iy, x = ccx * cell + ix;
            float val = 0.f;
            if (y < h && x < w) {
                const int o = (y - y0 + 1) * SC_W + (x - x0 + 1);
                const float s = sc[o];
                float neigh = -INFINITY;
#pragma unroll
                for (int dy = -1; dy <= 1; ++dy)
#pragma unroll
                    for (int dx = -1; dx <= 1; ++dx) neigh = fmaxf(neigh, sc[o + dy * SC_W + dx]);
                val = s >= neigh ? s : 0.f;
            }
            if (val > v) {  // p grows, so the first of equal values stays
                v = val;
                arg = p;
            }
            iy += qy;
            ix += qx;
            if (ix >= cell) {
                ix -= cell;
                ++iy;
            }
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
            const float ov = __shfl_down_sync(0xffffffffu, v, o);
            const int oa = __shfl_down_sync(0xffffffffu, arg, o);
            if (ov > v || (ov == v && oa < arg)) {
                v = ov;
                arg = oa;
            }
        }
        if (lane == 0) {
            const size_t at = (size_t)b * C + lv[LV_CELL_OFF] + ccy * gx + ccx;
            cell_val[at] = v;
            cell_arg[at] = arg;
        }
    }
}

// Sort key: ascending order is (value descending, cell ascending), with -0
// as +0 (top_k sees them equal).
__device__ __forceinline__ unsigned long long topk_key(float v, int i) {
    const unsigned u = __float_as_uint(v == 0.f ? 0.f : v);
    const unsigned asc = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
    return ((unsigned long long)(~asc) << 32) | (unsigned)i;
}

// The bitonic stages of one 64-key chunk at keys[base..base+64) that stay
// inside it: for each size from lo to hi, the strides from min(size, 64) / 2
// down to 1, in registers (a lane holds keys base + lane and base + lane +
// 32: stride 32 is in the lane, the others between lanes by shuffles).
__device__ __forceinline__ void chunk_stages(unsigned long long* keys, int base, int lane, int lo,
                                             int hi) {
    unsigned long long a = keys[base + lane], b = keys[base + lane + 32];
    for (int size = lo; size <= hi; size <<= 1) {
        const bool asc_a = ((base + lane) & size) == 0, asc_b = ((base + lane + 32) & size) == 0;
        for (int stride = (size < 64 ? size : 64) >> 1; stride > 0; stride >>= 1) {
            if (stride == 32) {
                if ((a > b) == asc_a) {
                    const unsigned long long x = a;
                    a = b;
                    b = x;
                }
            } else {
                const unsigned long long pa = __shfl_xor_sync(0xffffffffu, a, stride);
                const unsigned long long pb = __shfl_xor_sync(0xffffffffu, b, stride);
                const bool lower = (lane & stride) == 0;
                a = (lower == asc_a) ? (a < pa ? a : pa) : (a < pa ? pa : a);
                b = (lower == asc_b) ? (b < pb ? b : pb) : (b < pb ? pb : b);
            }
        }
    }
    keys[base + lane] = a;
    keys[base + lane + 32] = b;
}

// The bitonic sort of keys[0..p2) (p2 a power of two >= 64), ascending:
// sizes up to 64 inside each 64-key chunk; then for each larger size its
// strides >= 64 through shared memory and the rest inside the chunks.
__device__ __forceinline__ void bitonic_sort(unsigned long long* keys, int p2) {
    const int t = threadIdx.x, lane = t & 31, warp = t >> 5, warps = blockDim.x >> 5;
    for (int c = warp; c < p2 / 64; c += warps) chunk_stages(keys, 64 * c, lane, 2, 64);
    __syncthreads();
    for (int size = 128; size <= p2; size <<= 1) {
        for (int stride = size >> 1; stride >= 64; stride >>= 1) {
            for (int i = t; i < (p2 >> 1); i += blockDim.x) {
                const int lo = 2 * i - (i & (stride - 1)), hi = lo + stride;
                const unsigned long long a = keys[lo], c = keys[hi];
                if ((a > c) == ((lo & size) == 0)) {
                    keys[lo] = c;
                    keys[hi] = a;
                }
            }
            __syncthreads();
        }
        for (int c = warp; c < p2 / 64; c += warps) chunk_stages(keys, 64 * c, lane, size, size);
        __syncthreads();
    }
}

__global__ void __launch_bounds__(TOPK_THREADS) fast_topk_kernel(
        const float* __restrict__ cell_val, const int* __restrict__ cell_arg,
        const int* __restrict__ table, const float* __restrict__ scales, float* __restrict__ xy,
        float* __restrict__ resp, bool* __restrict__ valid, int* __restrict__ cell_id,
        int* __restrict__ oiy, int* __restrict__ oix, int* __restrict__ octave, int C, int N,
        int cell, int max_cells) {
    extern __shared__ unsigned long long smem[];
    unsigned long long* keys = smem;              // [max_cells] the level's keys, cell order
    unsigned long long* top = smem + max_cells;   // the k selected, then sorted
    __shared__ int hist[256], warp_n[TOPK_THREADS / 32];
    __shared__ int s_digit, s_below, s_count;
    const int lvl = blockIdx.x, b = blockIdx.y, t = threadIdx.x;
    const int lane = t & 31, warp = t >> 5, warps = blockDim.x >> 5;
    const int* lv = table + lvl * LV_NF;
    const int gx = lv[LV_GX], n = lv[LV_GY] * gx, budget = lv[LV_BUDGET];
    const int k = budget < n ? budget : n;
    const size_t cbase = (size_t)b * C + lv[LV_CELL_OFF];
    for (int i = t; i < n; i += blockDim.x) keys[i] = topk_key(cell_val[cbase + i], i);
    if (t == 0) s_count = 0;
    // The k-th smallest high word (the value part), 8 bits a pass from the
    // top: `prefix` holds the bits found, `need` how many keys to take
    // among those that share them.
    unsigned prefix = 0, mask = 0;
    int need = k;
    for (int shift = 24; k > 0 && shift >= 0; shift -= 8) {
        for (int i = t; i < 256; i += blockDim.x) hist[i] = 0;
        __syncthreads();
        for (int i = t; i < n; i += blockDim.x) {
            const unsigned h = (unsigned)(keys[i] >> 32);
            const bool in = (h & mask) == prefix;
            const unsigned active = __activemask();
            const int bin = in ? (int)((h >> shift) & 255u) : -1;
            const unsigned peers = __match_any_sync(active, bin);
            if (in && lane == __ffs(peers) - 1) atomicAdd(&hist[bin], __popc(peers));
        }
        __syncthreads();
        if (warp == 0) {
            int c[8], sum = 0;
#pragma unroll
            for (int j = 0; j < 8; ++j) {
                c[j] = hist[8 * lane + j];
                sum += c[j];
            }
            int incl = sum;
#pragma unroll
            for (int o = 1; o < 32; o <<= 1) {
                const int v = __shfl_up_sync(0xffffffffu, incl, o);
                if (lane >= o) incl += v;
            }
            const int first = __ffs(__ballot_sync(0xffffffffu, incl >= need)) - 1;
            if (lane == first) {
                int below = incl - sum, d = 8 * lane;
#pragma unroll
                for (int j = 0; j < 7; ++j) {
                    if (below + c[j] >= need) break;
                    below += c[j];
                    ++d;
                }
                s_digit = d;
                s_below = below;
            }
        }
        __syncthreads();
        need -= s_below;
        prefix |= (unsigned)s_digit << shift;
        mask |= 255u << shift;
    }
    // Take every key whose high word is below `prefix`, and the first
    // `need` (in cell order) of those equal to it, into top[] (any order).
    int run = 0;  // keys equal to `prefix` in the rounds before
    for (int base = 0; k > 0 && base < n; base += blockDim.x) {
        const int i = base + t;
        const unsigned long long kk = i < n ? keys[i] : ~0ull;
        const unsigned h = (unsigned)(kk >> 32);
        const bool eq = i < n && h == prefix;
        const unsigned bal = __ballot_sync(0xffffffffu, eq);
        if (lane == 0) warp_n[warp] = __popc(bal);
        __syncthreads();
        int before = run + __popc(bal & ((1u << lane) - 1u));
        for (int w = 0; w < warps; ++w) {
            if (w < warp) before += warp_n[w];
            run += warp_n[w];
        }
        if (i < n && (h < prefix || (eq && before < need))) top[atomicAdd(&s_count, 1)] = kk;
        __syncthreads();
    }
    int p2 = 64;
    while (p2 < k) p2 <<= 1;
    for (int i = k + t; i < p2; i += blockDim.x) top[i] = ~0ull;
    __syncthreads();
    bitonic_sort(top, p2);
    const float s = scales[lvl];
    for (int r = t; r < budget; r += blockDim.x) {
        const size_t o = (size_t)b * N + lv[LV_KP_OFF] + r;
        octave[o] = lvl;
        if (r < n) {
            const int i = (int)(top[r] & 0xffffffffu);
            const float v = cell_val[cbase + i];
            const int arg = cell_arg[cbase + i];
            const int iy = arg / cell, ix = arg % cell;
            xy[2 * o] = (float)((i % gx) * cell + ix) * s;
            xy[2 * o + 1] = (float)((i / gx) * cell + iy) * s;
            resp[o] = v;
            valid[o] = v > 0.f;
            cell_id[o] = i;
            oiy[o] = iy;
            oix[o] = ix;
        } else {  // fewer cells than budget: zero-padded slots
            xy[2 * o] = 0.f;
            xy[2 * o + 1] = 0.f;
            resp[o] = 0.f;
            valid[o] = false;
            cell_id[o] = 0;
            oiy[o] = 0;
            oix[o] = 0;
        }
    }
}

}  // namespace

// Max and first argmax of the NMS'd FAST score in each of the C cells
// (cell x cell pixels, cell <= 16) of all L levels, for B images:
// cell_val/cell_arg [B, C]. One CTA per tile of tcx x tcy cells (at most
// 64 x 32 px); n_tiles is the levels' sum of ceil(gx / tcx) * ceil(gy / tcy).
C_ENTRY int fast_cell_max(const float* levels, const int* level_table, float* cell_val,
                          int* cell_arg, int L, int B, int T, float th, int C, int cell,
                          int tcx, int tcy, int n_tiles, cudaStream_t stream) {
    if (cell < 1 || cell > MAX_CELL || tcx < 1 || tcy < 1 || tcx * cell > TILE_W ||
        tcy * cell > TILE_H)
        return (int)cudaErrorInvalidValue;
    if (n_tiles == 0 || B == 0) return (int)cudaSuccess;
    fast_cell_max_kernel<<<dim3(n_tiles, B), THREADS, 0, stream>>>(
        levels, level_table, cell_val, cell_arg, L, T, th, C, cell, tcx, tcy);
    return (int)cudaGetLastError();
}

// Top-budget cells of each level into the [B, N] keypoint slots.
// max_cells: the largest level's cell count (shared memory holds its keys,
// 8 bytes a cell, and the selected keys, up to a power of two >= 64).
C_ENTRY int fast_topk(const float* cell_val, const int* cell_arg, const int* level_table,
                      const float* scales, float* xy, float* resp, bool* valid, int* cell_id,
                      int* iy, int* ix, int* octave, int L, int B, int C, int N, int max_cells,
                      int cell, cudaStream_t stream) {
    int P = 64;
    while (P < max_cells) P <<= 1;
    const size_t smem = (size_t)(max_cells + P) * sizeof(unsigned long long);
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            fast_topk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    if (L == 0 || B == 0) return (int)cudaSuccess;
    fast_topk_kernel<<<dim3(L, B), TOPK_THREADS, smem, stream>>>(
        cell_val, cell_arg, level_table, scales, xy, resp, valid, cell_id, iy, ix, octave, C, N,
        cell, max_cells);
    return (int)cudaGetLastError();
}
