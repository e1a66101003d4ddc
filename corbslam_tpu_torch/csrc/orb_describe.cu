// K3 `orb_describe`: keypoint patches, intensity-centroid angle and steered
// BRIEF-256 for every keypoint of every level and image, in one launch.
//
// Replaces corbslam_tpu/ops/patches.py (cell_windows, winner_patches,
// recenter: keypoint-centred patches, 0 outside the image) and
// corbslam_tpu/ops/brief.py (orientation_from_patches, brief_from_patches:
// atan2(m01, m10) over the r=15 disc, 16 angle bins, per-bin rounded
// pattern offsets clipped to +-19, bit = p0 < p1, LSB-first packing).
//
// Bound on the H100: memory, by the raw 32x32 patch each keypoint writes out
// for stereo SAD (4 KB a keypoint, 16 MB for a stereo pair of 2048 features);
// the reads are the patch window and 512 scattered blurred pixels per
// keypoint, mostly L2 hits, and the arithmetic is ~2 K flops a keypoint.
// Design: one 256-thread block per keypoint. The block reads the raw patch
// straight from the level image (no cell windows, no one-hot recentering),
// writes it out and folds it into m01/m10 with the host-built orientation
// weights; thread 0 takes atan2f and the angle bin with the reference's
// rounding (rintf: half to even; fmod + 2pi: floor modulo). Then thread t
// evaluates pair t: its two endpoints from the [16][256][2][2] int8 offset
// table of that bin, read from the blurred level with 0 outside the image,
// and `__ballot_sync` packs each warp's 32 bits into one little-endian
// word, which is LSB-first byte order.

#include <math.h>

#include "common.cuh"

namespace {

constexpr int RAW = 32;        // raw patch edge (ops/brief.py RAW_PATCH)
constexpr int RAW_C = RAW / 2; // keypoint at (16, 16)
constexpr float TWO_PI_F = 6.28318548f;  // f32(2 * pi), as the reference rounds it
constexpr int BINS = 16;

__global__ void __launch_bounds__(256) orb_describe_kernel(
        const float* __restrict__ levels, const float* __restrict__ blurred,
        const int* __restrict__ table, const float2* __restrict__ orient_w,
        const char4* __restrict__ brief_offsets, const int* __restrict__ cell_id,
        const int* __restrict__ kiy, const int* __restrict__ kix, const int* __restrict__ octave,
        float* __restrict__ patch_out, float* __restrict__ angle_out,
        uint32_t* __restrict__ desc_out, int N, int T, int cell) {
    __shared__ float red[2][8];
    __shared__ int s_bin;
    const int t = threadIdx.x;
    const size_t kb = (size_t)blockIdx.y * N + blockIdx.x;
    const int* lv = table + octave[kb] * LV_NF;
    const int h = lv[LV_H], w = lv[LV_W], gx = lv[LV_GX];
    const int cid = cell_id[kb];
    const int x = (cid % gx) * cell + kix[kb], y = (cid / gx) * cell + kiy[kb];
    const size_t base = (size_t)blockIdx.y * T + lv[LV_OFF];
    const float* img = levels + base;
    const float* bimg = blurred + base;

    float m01 = 0.f, m10 = 0.f;
    float* pout = patch_out + kb * RAW * RAW;
    for (int i = t; i < RAW * RAW; i += blockDim.x) {
        const float v = read_or_zero(img, h, w, y - RAW_C + (i / RAW), x - RAW_C + (i % RAW));
        pout[i] = v;
        const float2 wt = orient_w[i];
        m01 += v * wt.x;
        m10 += v * wt.y;
    }
    for (int o = 16; o > 0; o >>= 1) {
        m01 += __shfl_down_sync(0xffffffffu, m01, o);
        m10 += __shfl_down_sync(0xffffffffu, m10, o);
    }
    const int warp = t >> 5, lane = t & 31;
    if (lane == 0) { red[0][warp] = m01; red[1][warp] = m10; }
    __syncthreads();
    if (t == 0) {
        float a = 0.f, c = 0.f;
        for (int k = 0; k < 8; ++k) { a += red[0][k]; c += red[1][k]; }
        const float ang = atan2f(a, c);
        angle_out[kb] = ang;
        float r = fmodf(ang, TWO_PI_F);
        if (r < 0.f) r = __fadd_rn(r, TWO_PI_F);
        const float q = __fmul_rn(__fdiv_rn(r, TWO_PI_F), (float)BINS);
        s_bin = ((int)rintf(q)) % BINS;
    }
    __syncthreads();
    const char4 o = brief_offsets[s_bin * 256 + t];  // (dy0, dx0, dy1, dx1)
    const float p0 = read_or_zero(bimg, h, w, y + o.x, x + o.y);
    const float p1 = read_or_zero(bimg, h, w, y + o.z, x + o.w);
    const uint32_t bits = __ballot_sync(0xffffffffu, p0 < p1);
    if (lane == 0) desc_out[kb * 8 + warp] = bits;
}

}  // namespace

// B images x N keypoint slots: patch [B, N, 32, 32] f32, angle [B, N] f32,
// desc [B, N, 32] u8. Keypoints given by (cell_id, iy, ix, octave) [B, N]
// on a grid of cell x cell pixels.
C_ENTRY int orb_describe(const float* levels, const float* blurred, const int* level_table,
                         const float* orient_weights, const int8_t* brief_offsets,
                         const int* cell_id, const int* iy, const int* ix, const int* octave,
                         float* patch, float* angle, uint8_t* desc, int B, int N, int T,
                         int cell, cudaStream_t stream) {
    orb_describe_kernel<<<dim3(N, B), 256, 0, stream>>>(
        levels, blurred, level_table, reinterpret_cast<const float2*>(orient_weights),
        reinterpret_cast<const char4*>(brief_offsets), cell_id, iy, ix, octave, patch, angle,
        reinterpret_cast<uint32_t*>(desc), N, T, cell);
    return (int)cudaGetLastError();
}
