// K1 `pyramid`: bilinear pyramid levels and their 7-tap Gaussian blur.
//
// Replaces corbslam_tpu/ops/pyramid.py: resize_bilinear (Ry @ img @ Rx^T with
// the taps of _resize_matrix), gaussian_blur (separable, sigma 2, reflect pad)
// and build_pyramid (level l resized from level l-1).
//
// Bound on the H100: memory, and in practice latency. Each output pixel
// reads 4 source pixels and two tap pairs, and the blur 7 + 7 taps, a few
// flops per byte; a stereo pair's 8 levels are ~1.4 M pixels an image, ~26
// MB of reads and writes in all, so at 3.35 TB/s the work is ~8 us, while
// the chain of levels (each resized from the one before) and a launch per
// level are what the caller waited for.
// Design: one launch builds every level and every blurred level of all B
// images, and no CTA waits for another. A CTA owns one tile of the level-0
// image (CONE_TILE in ops/pyramid.py: 6 x 11 tiles, 132 CTAs, for a
// 1241x376 pair) and, at every level l, the same share of level l's rows
// and columns. It computes in shared memory the cone of pixels that share
// needs: at the deepest level its tile and the blur's 3-px halo, at each
// level above also the source rows and columns of the next level's taps
// (the host-built plan of ops/pyramid.py cone_plan: exact rectangles from
// the reference's tap tables, their taps' places in shared memory,
// division multipliers and the levels' table). It stages level 0's
// rectangle from the image and every level's taps with cp.async, then runs
// one phase a level with one barrier each: the vertical blur pass of level
// l-1, the horizontal pass of level l (which also copies level l's owned
// pixels to `levels`) and the resize of level l+1 from level l's rectangle
// (two rectangle buffers and two blur buffers in turn, so no phase writes
// what another part of it reads). The resize uses the reference's taps,
// the exact weights of its matrix, row pass then column pass; the blur is
// the separable 7-tap sigma-2 blur with reflect padding, horizontal pass
// then vertical; each pixel in the reference's f32 operations and order. A
// thread of the resize keeps one output row (the rectangles' rows have odd
// strides, so a warp's 32 rows hit 32 banks), one of the horizontal pass 3
// adjacent columns (3 is coprime with the 32 banks) and one of the vertical
// pass 4 rows, so that loaded values are shared. A pixel of a cone's halo
// is computed by the same code from the same inputs as by its owner, so it
// is the owner's value bit for bit. The halo costs ~1.9x the resize work
// at levels 1-2 (less below) and the level-0 rectangle ~1.8x the image's
// reads; on the H100 both cost less than waiting across CTAs (a queue of
// tiles with per-band ready counters was slower).

#include "common.cuh"

namespace {

constexpr int MAX_LEVELS = 16;
constexpr int THREADS = 512;  // ops/pyramid.py CONE_THREADS
constexpr int WARPS = THREADS / 32;
constexpr int HALO = 3;       // 7 taps
constexpr int TAPS = 2 * HALO + 1;
constexpr int HX = 3;         // adjacent columns a thread blurs across (ops/pyramid.py CONE_HX)
constexpr int VY = 4;         // consecutive rows a thread takes in the vertical pass

// A level's row of the plan's level table.
struct Level {
    int h, w, off;         // shape and pixel offset in the flat [B, T] buffers
    int row_tap, col_tap;  // first row / column tap of the level in tap_idx / tap_w (l >= 1)
    int pad[3];
};

struct Geom {
    int L, T, HW, nty;     // levels, pixels of all levels, of an image, tile rows of the plan
    int cap_a, cap_b;      // floats of the even and the odd levels' rectangles
    int cap_t, cap_taps;   // floats of a level's horizontal blur pass, taps of all rectangles
};

// n / d for 0 <= n <= THREADS and d < 4096, with m = ceil(2^21 / d) from
// the plan: one multiply instead of a division.
__device__ __forceinline__ int div_by(int n, int m) { return (n * m) >> 21; }

// jnp.pad(mode="reflect") index (edge not repeated).
__device__ __forceinline__ int reflect(int i, int n) {
    i = abs(i);
    return i > n - 1 ? 2 * (n - 1) - i : i;
}

__device__ __forceinline__ void cp_async(void* dst, const void* src, int bytes) {
    const unsigned int d = (unsigned int)__cvta_generic_to_shared(dst);
    if (bytes == 4)
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
    else
        asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d), "l"(src) : "memory");
}

// Row stride of a rectangle in shared memory: its width made odd, so that
// a warp's lanes on 32 different rows of one column hit 32 banks.
__device__ __forceinline__ int stride_of(int4 pc) { return (pc.y - pc.x + 1) | 1; }

// Level l's rectangle (rows pr.x..pr.y, columns pc.x..pc.y) from level
// l-1's (src, rows ps.x.., columns qs.x..qs.y), with the level's row and
// column taps of the rectangle staged in shared memory: the row pass
// (Ry @ img) at the two source columns, then the column pass, the
// reference's products and sums in its order. A thread keeps one output
// row (its taps in registers) and walks columns, so a warp's lanes read 32
// source rows of the same columns.
__device__ __forceinline__ void resize(const float* src, int4 ps, int4 qs, float* dst, int4 pr,
                                       int4 pc, int mr, const int2* ri, const float2* rw,
                                       const int2* ci, const float2* cw) {
    const int R = pr.y - pr.x + 1, W = pc.y - pc.x + 1;
    const int Wd = stride_of(pc), Ws = stride_of(qs);
    const int g0 = div_by(threadIdx.x, mr), r = threadIdx.x - g0 * R, step = div_by(THREADS, mr);
    if (g0 >= step) return;
    const int2 ry = ri[r];
    const float2 wy = rw[r];
    const float* s0 = src + (ry.x - ps.x) * Ws - qs.x;
    const float* s1 = src + (ry.y - ps.x) * Ws - qs.x;
    float* out = dst + r * Wd;
#pragma unroll 4
    for (int c = g0; c < W; c += step) {
        const int2 cx = ci[c];
        const float2 wx = cw[c];
        const float t0 = wy.x * s0[cx.x] + wy.y * s1[cx.x];
        const float t1 = wy.x * s0[cx.y] + wy.y * s1[cx.y];
        out[c] = wx.x * t0 + wx.y * t1;
    }
}

// Horizontal blur pass of a level's owned columns over its owned rows and
// their 3-row halo (rows pr.z-3 .. pr.w+2, reflected), from its rectangle
// `reg` into tmp [ho + 6][wo]; the owned pixels are also copied to lev. A
// thread takes HX adjacent columns (HX coprime with the 32 banks, so a
// warp's loads hit 32 banks) and walks rows; each sum is the reference's
// k0 a0 + k1 a1 + ... in its order.
__device__ __forceinline__ void blur_rows(const float* reg, float* tmp, int4 pr, int4 pc, int mq,
                                          const Level& lv, const float (&k)[TAPS], float* lev) {
    const int ho = pr.w - pr.z, wo = pc.w - pc.z;
    const int nq = (wo + HX - 1) / HX;
    if (ho <= 0 || nq <= 0 || nq > THREADS) return;
    const int W = stride_of(pc);
    const int r0 = div_by(threadIdx.x, mq), qd = threadIdx.x - r0 * nq, step = div_by(THREADS, mq);
    if (r0 >= step) return;
    const int c0 = qd * HX, x0 = pc.z + c0;
    int cc[HX + TAPS - 1];
#pragma unroll
    for (int q = 0; q < HX + TAPS - 1; ++q)
        cc[q] = min(max(reflect(x0 - HALO + q, lv.w), pc.x), pc.y) - pc.x;  // clamped: unused
    for (int r = r0; r < ho + 2 * HALO; r += step) {
        const int y = pr.z - HALO + r;
        const float* p = reg + (reflect(y, lv.h) - pr.x) * W;
        float v[HX + TAPS - 1];
#pragma unroll
        for (int q = 0; q < HX + TAPS - 1; ++q) v[q] = p[cc[q]];
#pragma unroll
        for (int j = 0; j < HX; ++j) {
            if (c0 + j < wo) {
                float acc = k[0] * v[j];
#pragma unroll
                for (int t = 1; t < TAPS; ++t) acc = acc + k[t] * v[j + t];
                tmp[r * wo + c0 + j] = acc;
                if (r >= HALO && r < ho + HALO) lev[y * lv.w + x0 + j] = v[j + HALO];
            }
        }
    }
}

// Vertical blur pass of the owned pixels from tmp into blur: a thread takes
// a column and VY consecutive rows at a time, the reference's sums in its
// order.
__device__ __forceinline__ void blur_cols(const float* tmp, int4 pr, int4 pc, int mo,
                                          const Level& lv, const float (&k)[TAPS], float* blur) {
    const int ho = pr.w - pr.z, wo = pc.w - pc.z;
    if (ho <= 0 || wo <= 0 || wo > THREADS) return;
    const int g0 = div_by(threadIdx.x, mo), c = threadIdx.x - g0 * wo, step = div_by(THREADS, mo);
    const int x = pc.z + c;
    for (int gr = g0; gr * VY < ho; gr += step) {
        const int r = gr * VY;
        float v[VY + TAPS - 1];
#pragma unroll
        for (int q = 0; q < VY + TAPS - 1; ++q)
            v[q] = r + q < ho + 2 * HALO ? tmp[(r + q) * wo + c] : 0.f;
#pragma unroll
        for (int j = 0; j < VY; ++j) {
            if (r + j < ho) {
                float acc = k[0] * v[j];
#pragma unroll
                for (int t = 1; t < TAPS; ++t) acc = acc + k[t] * v[j + t];
                blur[(pr.z + r + j) * lv.w + x] = acc;
            }
        }
    }
}

__global__ void __launch_bounds__(THREADS, 1) pyramid_kernel(
        const float* __restrict__ imgs, float* __restrict__ levels, float* __restrict__ blurred,
        const int2* __restrict__ tap_idx, const float2* __restrict__ tap_w,
        const float* __restrict__ taps, const int4* __restrict__ plan, const Geom g) {
    extern __shared__ float smem[];
    float* buf_a = smem;             // the even levels' rectangles
    float* buf_b = smem + g.cap_a;   // the odd levels'
    float* tmp0 = buf_b + g.cap_b;   // the horizontal pass of the even levels
    float* tmp1 = tmp0 + g.cap_t;    // and of the odd levels
    int2* s_ti = reinterpret_cast<int2*>(tmp1 + g.cap_t);  // the rectangles' row, then column taps
    float2* s_tw = reinterpret_cast<float2*>(s_ti + g.cap_taps);
    // Per level: (first, last, owned first, owned end) of the rows and the
    // columns; where their taps start in s_ti / s_tw; and the column side's
    // division multipliers (div_by) of the rectangle's width, of the column
    // triples and of the owned width.
    __shared__ int4 s_pr[MAX_LEVELS], s_pc[MAX_LEVELS], s_cm[MAX_LEVELS];
    __shared__ int s_rb[MAX_LEVELS], s_rm[MAX_LEVELS];
    __shared__ Level s_lv[MAX_LEVELS];  // the plan's level table
    const int tid = threadIdx.x;
    const int b = blockIdx.z;
    if (tid >= 64 && tid < 64 + g.L)
        s_lv[tid - 64] = reinterpret_cast<const Level*>(plan)[(g.nty + gridDim.x) * g.L + tid - 64];
    if (tid < g.L) {
        s_pr[tid] = plan[2 * (blockIdx.y * g.L + tid)];
        const int4 e = plan[2 * (blockIdx.y * g.L + tid) + 1];
        s_rb[tid] = e.x;
        s_rm[tid] = e.y;
    } else if (tid >= 32 && tid < 32 + g.L) {
        s_pc[tid - 32] = plan[2 * ((g.nty + blockIdx.x) * g.L + tid - 32)];
        s_cm[tid - 32] = plan[2 * ((g.nty + blockIdx.x) * g.L + tid - 32) + 1];
    }
    float k[TAPS];
#pragma unroll
    for (int q = 0; q < TAPS; ++q) k[q] = __ldg(taps + q);
    __syncthreads();

    // Stage level 0's rectangle and every level's taps (cp.async), all in
    // flight.
    const Level l0 = s_lv[0];
    {
        const int4 pr = s_pr[0], pc = s_pc[0];
        const int R = pr.y - pr.x + 1, W = pc.y - pc.x + 1, Wd = stride_of(pc);
        const float* img = imgs + (size_t)b * g.HW + pr.x * l0.w + pc.x;
        const int lane = tid & 31;
        for (int r = tid >> 5; r < R; r += THREADS / 32)
            for (int c = lane; c < W; c += 32) cp_async(buf_a + r * Wd + c, img + r * l0.w + c, 4);
        for (int l = 1; l < g.L; ++l) {
            const Level lv = s_lv[l];
            const int4 qr = s_pr[l], qc = s_pc[l];
            for (int i = tid; i <= qr.y - qr.x; i += THREADS) {
                cp_async(s_ti + s_rb[l] + i, tap_idx + lv.row_tap + qr.x + i, 8);
                cp_async(s_tw + s_rb[l] + i, tap_w + lv.row_tap + qr.x + i, 8);
            }
            for (int i = tid; i <= qc.y - qc.x; i += THREADS) {
                cp_async(s_ti + s_cm[l].x + i, tap_idx + lv.col_tap + qc.x + i, 8);
                cp_async(s_tw + s_cm[l].x + i, tap_w + lv.col_tap + qc.x + i, 8);
            }
        }
        asm volatile("cp.async.wait_all;\n" ::: "memory");
        __syncthreads();
    }
    // Phase l: the vertical blur pass of level l-1, the horizontal pass of
    // level l and the resize of level l+1 (each reads what the phase before
    // wrote, and none writes what another of the phase reads), then one
    // barrier.
    float* lev = levels + (size_t)b * g.T;
    float* blur = blurred + (size_t)b * g.T;
    for (int l = 0; l <= g.L; ++l) {
        if (l >= 1) {
            const Level lp = s_lv[l - 1];
            blur_cols((l & 1) ? tmp0 : tmp1, s_pr[l - 1], s_pc[l - 1], s_cm[l - 1].w, lp, k,
                      blur + lp.off);
        }
        if (l < g.L) {
            const Level lv = s_lv[l];
            const float* cur = (l & 1) ? buf_b : buf_a;
            blur_rows(cur, (l & 1) ? tmp1 : tmp0, s_pr[l], s_pc[l], s_cm[l].z, lv, k,
                      lev + lv.off);
            if (l + 1 < g.L)
                resize(cur, s_pr[l], s_pc[l], (l & 1) ? buf_a : buf_b, s_pr[l + 1], s_pc[l + 1],
                       s_rm[l + 1], s_ti + s_rb[l + 1], s_tw + s_rb[l + 1],
                       s_ti + s_cm[l + 1].x, s_tw + s_cm[l + 1].x);
        }
        __syncthreads();
    }
}

}  // namespace

// Every level and blurred level of B images [B, H, W] (H x W pixels, HW)
// into the flat [B, T] buffers, in one launch of nty x ntx x B CTAs. plan:
// [nty + ntx + 1, L] pairs of int4s (ops/pyramid.py cone_plan): the CTAs'
// rectangles, rows then columns, with their taps' places in shared memory
// and division multipliers, then the levels' table (shape, pixel offset,
// first row and column tap); cap_a, cap_b: floats of the even and the odd
// levels' shared buffers, cap_t: of a level's horizontal blur pass (two of
// them), cap_taps: the taps of a CTA's rectangles.
C_ENTRY int build_pyramid(const float* imgs, float* levels, float* blurred, const int* tap_idx,
                          const float* tap_w, const float* taps, const int* plan, int L, int B,
                          int T, int HW, int nty, int ntx, int cap_a, int cap_b, int cap_t,
                          int cap_taps, cudaStream_t stream) {
    if (L < 1 || L > MAX_LEVELS || B < 1 || nty < 1 || ntx < 1 || cap_a < 1 || cap_t < 1 ||
        cap_taps < 0)
        return (int)cudaErrorInvalidValue;
    const Geom g{L, T, HW, nty, cap_a, cap_b, cap_t, cap_taps};
    const size_t smem = sizeof(float) * ((size_t)cap_a + cap_b + 2 * (size_t)cap_t + 4 * (size_t)cap_taps);
    static size_t attr = 0;
    if (smem > attr) {
        const cudaError_t err = cudaFuncSetAttribute(
            pyramid_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return (int)err;
        attr = smem;
    }
    pyramid_kernel<<<dim3(ntx, nty, B), THREADS, smem, stream>>>(
        imgs, levels, blurred, reinterpret_cast<const int2*>(tap_idx),
        reinterpret_cast<const float2*>(tap_w), taps, reinterpret_cast<const int4*>(plan), g);
    return (int)cudaGetLastError();
}
