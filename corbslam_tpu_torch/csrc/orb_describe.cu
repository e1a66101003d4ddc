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
// Design: one warp a keypoint slot, 8 slots a 256-thread CTA, no barrier.
// Lane l holds patch column l, so each of the 32 rows is one coalesced load
// from the level (0 outside the image) and one 128-byte store of the patch.
// The moment weights (dy and dx inside the r=15 disc, small integers in
// f32) are computed inline. The sums keep the order of the earlier design,
// one 256-thread CTA a slot, so that angles are bit for bit its angles: row
// r was that CTA's thread 32 (r % 8) + l's (r / 8)-th term, so each lane
// keeps 8 partials per moment, one per row residue, adds each row to its
// partial as `m += v * w`, and the warp reduces the 16 partials with
// shfl_xor halving (each partial gets the shfl_down tree of the old warp
// reduction: the same pairs, added in either order); lane 0 adds the 8
// warp sums in order, takes atan2f and the bin with the reference's
// rounding (rintf: half to even; fmod + 2pi: floor modulo) and broadcasts
// the bin. Then lane l evaluates pairs 32 j + l, j = 0..7, from the
// [16][256][2][2] int8 offset table of that bin on the blurred level (0
// outside), and ballot j is little-endian word j, LSB-first byte order.

#include <math.h>

#include "common.cuh"

namespace {

constexpr int RAW = 32;        // raw patch edge (ops/brief.py RAW_PATCH)
constexpr int RAW_C = RAW / 2; // keypoint at (16, 16)
constexpr int R2 = 15 * 15;    // orientation disc (ops/brief.py PATCH_RADIUS)
constexpr float TWO_PI_F = 6.28318548f;  // f32(2 * pi), as the reference rounds it
constexpr int BINS = 16;
constexpr int SLOTS = 8;       // keypoint slots a CTA, one warp each
constexpr unsigned FULL = 0xffffffffu;

// One halving step of the 16-partial warp reduction: lanes with `bit` set
// keep the upper half of `v` and hand the lower half across, the others
// the reverse; afterwards v[0..n/2) holds this lane's half.
template <int N>
__device__ __forceinline__ void halve(float (&v)[16], int lane, int bit) {
    const bool hi = (lane & bit) != 0;
#pragma unroll
    for (int j = 0; j < N / 2; ++j) {
        const float keep = hi ? v[j + N / 2] : v[j];
        const float send = hi ? v[j] : v[j + N / 2];
        v[j] = keep + __shfl_xor_sync(FULL, send, bit);
    }
}

__global__ void __launch_bounds__(32 * SLOTS) orb_describe_kernel(
        const float* __restrict__ levels, const float* __restrict__ blurred,
        const int* __restrict__ table, const char4* __restrict__ brief_offsets,
        const int* __restrict__ cell_id, const int* __restrict__ kiy, const int* __restrict__ kix,
        const int* __restrict__ octave, float* __restrict__ patch_out,
        float* __restrict__ angle_out, uint32_t* __restrict__ desc_out, int N, int T, int cell) {
    const int lane = threadIdx.x & 31;
    const int k = blockIdx.x * SLOTS + (threadIdx.x >> 5);
    if (k >= N) return;
    const size_t kb = (size_t)blockIdx.y * N + k;
    const int* lv = table + octave[kb] * LV_NF;
    const int h = lv[LV_H], w = lv[LV_W], gx = lv[LV_GX];
    const int cid = cell_id[kb];
    const int x = (cid % gx) * cell + kix[kb], y = (cid / gx) * cell + kiy[kb];
    const size_t base = (size_t)blockIdx.y * T + lv[LV_OFF];
    const float* img = levels + base;
    const float* bimg = blurred + base;

    // v[j]: the m01 partial of row residue j; v[8 + j]: the m10 partial.
    const int xc = x - RAW_C + lane;
    const bool col_in = xc >= 0 && xc < w;
    const float dx = (float)(lane - RAW_C);
    float v[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) v[j] = 0.f;
    float* pout = patch_out + kb * RAW * RAW + lane;
#pragma unroll
    for (int r = 0; r < RAW; ++r) {
        const int yr = y - RAW_C + r;
        const float p = (col_in && yr >= 0 && yr < h) ? img[yr * w + xc] : 0.f;
        pout[r * RAW] = p;
        const float dy = (float)(r - RAW_C);
        const float mask = (dy * dy + dx * dx <= (float)R2) ? 1.f : 0.f;
        v[r % 8] += p * (dy * mask);
        v[8 + r % 8] += p * (dx * mask);
    }
    halve<16>(v, lane, 16);
    halve<8>(v, lane, 8);
    halve<4>(v, lane, 4);
    halve<2>(v, lane, 2);
    v[0] += __shfl_xor_sync(FULL, v[0], 1);
    // Lanes 2j and 2j + 1 now hold partial j's warp sum: m01's row residue
    // j at j < 8, m10's row residue j - 8 above. Lane 0 adds m01's in
    // order, lane 1 m10's.
    float a = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) a += __shfl_sync(FULL, v[0], lane == 0 ? 2 * j : 16 + 2 * j);
    const float c = __shfl_sync(FULL, a, 1);
    int bin = 0;
    if (lane == 0) {
        const float ang = atan2f(a, c);
        angle_out[kb] = ang;
        float r = fmodf(ang, TWO_PI_F);
        if (r < 0.f) r = __fadd_rn(r, TWO_PI_F);
        const float q = __fmul_rn(__fdiv_rn(r, TWO_PI_F), (float)BINS);
        bin = ((int)rintf(q)) % BINS;
    }
    bin = __shfl_sync(FULL, bin, 0);

    const char4* offs = brief_offsets + bin * 256 + lane;
    uint32_t word = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
        const char4 o = offs[32 * j];  // pair 32 j + lane: (dy0, dx0, dy1, dx1)
        const float p0 = read_or_zero(bimg, h, w, y + o.x, x + o.y);
        const float p1 = read_or_zero(bimg, h, w, y + o.z, x + o.w);
        const uint32_t bits = __ballot_sync(FULL, p0 < p1);
        if (lane == j) word = bits;
    }
    if (lane < 8) desc_out[kb * 8 + lane] = word;
}

}  // namespace

// B images x N keypoint slots: patch [B, N, 32, 32] f32, angle [B, N] f32,
// desc [B, N, 32] u8. Keypoints given by (cell_id, iy, ix, octave) [B, N]
// on a grid of cell x cell pixels.
C_ENTRY int orb_describe(const float* levels, const float* blurred, const int* level_table,
                         const int8_t* brief_offsets, const int* cell_id, const int* iy,
                         const int* ix, const int* octave, float* patch, float* angle,
                         uint8_t* desc, int B, int N, int T, int cell, cudaStream_t stream) {
    if (B < 1 || N < 1) return (int)cudaErrorInvalidValue;
    orb_describe_kernel<<<dim3((N + SLOTS - 1) / SLOTS, B), 32 * SLOTS, 0, stream>>>(
        levels, blurred, level_table, reinterpret_cast<const char4*>(brief_offsets), cell_id, iy,
        ix, octave, patch, angle, reinterpret_cast<uint32_t*>(desc), N, T, cell);
    return (int)cudaGetLastError();
}
