// K7 `local_map`: the local keyframe window and the compacted local map of a
// tracked frame, and the top covisible keyframes of a keyframe.
//
// Replaces corbslam_tpu/frontend/track_ops.py _candidate_local_kfs together
// with corbslam_tpu/mapstate/covisibility.py local_map_mask, compact_indices
// and dedupe_candidate_weights, and corbslam_tpu/geometry/camera.py
// in_frustum over all map points and over the compacted rows (the frustum
// half of matcher.search_by_projection_points, with its octave prediction);
// and corbslam_tpu/mapstate/covisibility.py top_covisible_of with
// candidate_covis_weights, anchor_candidates and point_mask_of_kf, which run
// launches (1)-(4) with the keyframe's own row as the query (its valid
// features), no previous window, 112 anchors, 47 recent rows and the extra
// [q], and q's weight replaced by `self_weight` on every copy of q before
// the top k.
//
// Bound on the H100: bytes. Every point costs its four byte masks (valid,
// tracked, observed by the window, result: 0.5 MB at 131072 points); the
// valid candidate keyframes' observation rows are read once (at most 160 x
// 2048 indices and flags, 1.3 MB); positions, normals and distances only for
// the observed, untracked points and the L compacted rows. The arithmetic
// (a frustum test per such point) is small. The reference's form,
// a top_k over a [M] key and scatters into [M] masks, is a handful of
// passes over M; the costs to avoid are a sort of M keys, passes that run
// on one SM, and host syncs.
// Design: seven launches with no PyTorch op between them. (1) one block
// clears the tracked-point mask and scatters the tracked points into it,
// with the anchor counts in shared memory (warp-aggregated atomics);
// (2) one block selects the top anchors by a histogram of the counts: the
// threshold bin of the n_anchor-th count, the rows above it ranked among
// themselves (count desc, row asc: lax.top_k's order), the threshold rows
// taken in row order by a block scan; then the candidate list in the
// reference's order: anchors, last local window, newest keyframes, then
// [ref_kf, 0]; (3) one block per candidate sums its shared points;
// (4) one block drops duplicate candidates (first valid kept, invalid
// entries keyed -1-i), takes the first argmax as the new reference keyframe
// and ranks the top K1; (5) after clearing the result mask, one thread per
// window observation marks its point if valid, untracked and in the wide
// frustum (the same point marked by several observations gets the same
// value); (6) the compaction, newest-first over tiles of 4096 rows from the
// top of [M]: a counts launch (one block a tile, 16 mask bytes a thread)
// and a scan-and-scatter launch (each block adds the counts of the tiles
// above it, scans its threads from the top and writes True rows
// descending, then False rows descending, only below L; a tile whose both
// ranges start at or past L returns at once), which is exactly
// top_k(mask * (M + 1) + row, L); (7) one thread per compacted row for the
// matching frustum and the predicted octave. Frustum arithmetic uses
// explicitly rounded f32 operations in the reference's order, so no FMA
// moves a point across a gate. The mapping stages launch (1)-(4) for
// top_covisible_of (candidates: anchors, newest keyframes, [q]; every copy
// of q weighted self_weight in (4)), local_window_mask (a cleared mask and
// the window scatter of (5) with the point validity folded in) for
// local_map_mask, and (6) alone for compact_indices.

#include <math.h>

#include "common.cuh"

namespace {
constexpr int BLOCK = 256;
constexpr int SCAN_THREADS = 1024;
constexpr int MAX_CAND = 1024;
constexpr int HIST = 2048;             // anchor-count bins; counts >= HIST - 1 share the last
constexpr int TILE_ROWS = BLOCK * 16;  // compaction tile: 16 mask bytes a thread


struct CamArgs {
    float fx, fy, cx, cy;
    int width, height;
};

struct View {
    float R[9], t[3], c[3];  // world->camera rotation, translation, camera centre
};

__device__ __forceinline__ View load_view(const float* T) {
    View V;
    for (int i = 0; i < 3; ++i) {
        for (int j = 0; j < 3; ++j) V.R[i * 3 + j] = T[i * 4 + j];
        V.t[i] = T[i * 4 + 3];
    }
    // -R^T t, summed in the order of se3.inverse.
    for (int i = 0; i < 3; ++i)
        V.c[i] = -__fadd_rn(__fadd_rn(__fmul_rn(V.R[i], V.t[0]), __fmul_rn(V.R[3 + i], V.t[1])),
                            __fmul_rn(V.R[6 + i], V.t[2]));
    return V;
}

struct Frustum {
    bool ok;
    float u, v, dist;
};

// camera.in_frustum for one point, in the reference's operation order.
__device__ __forceinline__ Frustum frustum(const View& V, const CamArgs& cam, const float* p,
                                           float min_d, float max_d, const float* n,
                                           float cos_limit) {
    float q[3];
    for (int i = 0; i < 3; ++i)
        q[i] = __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(V.R[i * 3], p[0]),
                                             __fmul_rn(V.R[i * 3 + 1], p[1])),
                                   __fmul_rn(V.R[i * 3 + 2], p[2])),
                         V.t[i]);
    const float z = q[2];
    const float iz = __fdiv_rn(1.0f, fabsf(z) < 1e-9f ? 1e-9f : z);
    Frustum f;
    f.u = __fadd_rn(__fmul_rn(__fmul_rn(cam.fx, q[0]), iz), cam.cx);
    f.v = __fadd_rn(__fmul_rn(__fmul_rn(cam.fy, q[1]), iz), cam.cy);
    const float po0 = __fsub_rn(p[0], V.c[0]), po1 = __fsub_rn(p[1], V.c[1]),
                po2 = __fsub_rn(p[2], V.c[2]);
    f.dist = __fsqrt_rn(__fadd_rn(__fadd_rn(__fmul_rn(po0, po0), __fmul_rn(po1, po1)),
                                  __fmul_rn(po2, po2)));
    const float vc = __fdiv_rn(
        __fadd_rn(__fadd_rn(__fmul_rn(po0, n[0]), __fmul_rn(po1, n[1])), __fmul_rn(po2, n[2])),
        fmaxf(f.dist, 1e-9f));
    f.ok = z > 0.f && f.u >= 0.f && f.u < (float)cam.width && f.v >= 0.f &&
           f.v < (float)cam.height && f.dist >= min_d && f.dist <= max_d && vc > cos_limit;
    return f;
}


// Inclusive scan of one int per thread over the block (blockDim.x a multiple
// of 32, at most 1024).
__device__ int block_inclusive_scan(int v, int* s_warp) {
    const int t = threadIdx.x, lane = t & 31, warp = t >> 5, n_warps = blockDim.x >> 5;
    for (int o = 1; o < 32; o <<= 1) {
        const int u = __shfl_up_sync(0xffffffffu, v, o);
        if (lane >= o) v += u;
    }
    if (lane == 31) s_warp[warp] = v;
    __syncthreads();
    if (warp == 0) {
        int w = lane < n_warps ? s_warp[lane] : 0;
        for (int o = 1; o < 32; o <<= 1) {
            const int u = __shfl_up_sync(0xffffffffu, w, o);
            if (lane >= o) w += u;
        }
        s_warp[lane] = w;
    }
    __syncthreads();
    const int r = v + (warp ? s_warp[warp - 1] : 0);
    __syncthreads();
    return r;
}

// Adds one to s_cnt[a] for every lane with `on`, one shared atomic per
// distinct a in the warp (a frame's points have a handful of anchors).
// Every lane of the warp calls it.
__device__ __forceinline__ void warp_count(int* s_cnt, int a, bool on) {
    const unsigned active = __ballot_sync(0xffffffffu, on);
    if (!on) return;
    const unsigned peers = __match_any_sync(active, a);
    if ((int)(threadIdx.x & 31) == __ffs(peers) - 1) atomicAdd(&s_cnt[a], __popc(peers));
}

// (1) One block: clear cur_mask, mark the tracked points, count their anchors
// in shared memory, write the counts.
__global__ void __launch_bounds__(SCAN_THREADS) scatter_current_kernel(
        const int* __restrict__ mp_idx, const bool* __restrict__ fvalid, int F,
        const int* __restrict__ ref_kf, int M, int N, bool* __restrict__ cur_mask,
        int* __restrict__ counts) {
    extern __shared__ int s_cnt[];
    const int t = threadIdx.x;
    for (int i = t; i < N; i += blockDim.x) s_cnt[i] = 0;
    // 16 bytes a store where the buffer is aligned.
    const int head = (int)min((size_t)M, (16 - ((size_t)cur_mask & 15)) & 15);
    const int n16 = (M - head) / 16;
    uint4* v = reinterpret_cast<uint4*>(cur_mask + head);
    for (int i = t; i < head; i += blockDim.x) cur_mask[i] = false;
    for (int i = t; i < n16; i += blockDim.x) v[i] = make_uint4(0u, 0u, 0u, 0u);
    for (int i = head + n16 * 16 + t; i < M; i += blockDim.x) cur_mask[i] = false;
    __syncthreads();
    for (int base = 0; base < F; base += blockDim.x) {
        const int i = base + t;
        const int idx = i < F ? mp_idx[i] : -1;
        const bool on = idx >= 0 && (!fvalid || fvalid[i]);
        if (on) cur_mask[idx] = true;
        const int a = on ? ref_kf[idx] : -1;
        warp_count(s_cnt, a, a >= 0 && a < N);
    }
    __syncthreads();
    for (int i = t; i < N; i += blockDim.x) counts[i] = s_cnt[i];
}

// (2) One block: the n_anchor top anchor counts (count desc, row asc), then
// the rest of the candidate list.
__global__ void __launch_bounds__(SCAN_THREADS) candidates_kernel(
        const int* __restrict__ counts, int N, const int* __restrict__ n_kf,
        const int* __restrict__ prev_rows, const bool* __restrict__ prev_ok, int K1,
        int n_anchor, int n_recent, const int* __restrict__ extra_dev, int extra_host,
        int* __restrict__ cand, bool* __restrict__ cand_ok) {
    __shared__ int s_hist[HIST];
    __shared__ int s_warp[32];
    __shared__ int s_list[MAX_CAND], s_val[MAX_CAND];
    __shared__ int s_tb, s_above, s_n;
    const int t = threadIdx.x;
    for (int b = t; b < HIST; b += blockDim.x) s_hist[b] = 0;
    if (t == 0) s_n = 0;
    __syncthreads();
    // This thread's rows [r0, r1): contiguous, so that a block scan runs in row order.
    const int per = (N + SCAN_THREADS - 1) / SCAN_THREADS;
    const int r0 = min(t * per, N), r1 = min(r0 + per, N);
    for (int i = r0; i < r0 + per; ++i) {
        const bool on = i < r1;
        warp_count(s_hist, on ? min(counts[i], HIST - 1) : 0, on);
    }
    __syncthreads();
    // Threshold bin tb: the highest bin with at least n_anchor rows at or
    // above it (suffix sums, two bins a thread from the top); s_above: the
    // rows in the bins above it.
    const int b0 = HIST - 2 * (t + 1);
    const int h1 = s_hist[b0 + 1], h0 = s_hist[b0];
    const int over = block_inclusive_scan(h0 + h1, s_warp) - h0 - h1;  // rows in bins > b0 + 1
    if (over < n_anchor && over + h1 >= n_anchor) {
        s_tb = b0 + 1;
        s_above = over;
    } else if (over + h1 < n_anchor && over + h1 + h0 >= n_anchor) {
        s_tb = b0;
        s_above = over + h1;
    }
    __syncthreads();
    const int tb = s_tb;
    const bool exact = tb < HIST - 1;
    // The rows above tb (fewer than n_anchor) and, when tb is the shared last
    // bin, that bin's rows too (at most the F counted features / (HIST - 1)):
    // listed, then each ranked among the list by (count desc, row asc).
    int n_eq = 0;
    for (int i = r0; i < r1; ++i) {
        const int v = counts[i], b = min(v, HIST - 1);
        if (b > tb || (b == tb && !exact)) {
            const int k = atomicAdd(&s_n, 1);
            if (k < MAX_CAND) {
                s_list[k] = i;
                s_val[k] = v;
            }
        } else if (b == tb) {
            ++n_eq;
        }
    }
    __syncthreads();
    const int n_list = min(s_n, MAX_CAND);
    for (int k = t; k < n_list; k += blockDim.x) {
        const int i = s_list[k], v = s_val[k];
        int rank = 0;
        for (int j = 0; j < n_list; ++j)
            rank += (s_val[j] > v) | ((s_val[j] == v) & (s_list[j] < i));
        if (rank < n_anchor) {
            cand[rank] = i;
            cand_ok[rank] = v > 0;
        }
    }
    // The rows of count tb in row order, behind the rows above it.
    int pos = s_above + block_inclusive_scan(n_eq, s_warp) - n_eq;
    if (exact)
        for (int i = r0; i < r1 && pos < n_anchor; ++i)
            if (counts[i] == tb) {
                cand[pos] = i;
                cand_ok[pos] = tb > 0;
                ++pos;
            }
    for (int k = t; k < K1; k += blockDim.x) {
        cand[n_anchor + k] = prev_rows[k];
        cand_ok[n_anchor + k] = prev_ok[k];
    }
    const int nk = *n_kf;
    for (int k = t; k < n_recent; k += blockDim.x) {
        const int r = nk - 1 - k;
        cand[n_anchor + K1 + k] = max(r, 0);
        cand_ok[n_anchor + K1 + k] = r >= 0;
    }
    if (t == 0) {
        int c = n_anchor + K1 + n_recent;
        if (extra_dev) {
            cand[c] = *extra_dev;
            cand_ok[c++] = true;
        }
        if (extra_host >= 0) {
            cand[c] = extra_host;
            cand_ok[c] = true;
        }
    }
}

__global__ void __launch_bounds__(BLOCK) weights_kernel(
        const int* __restrict__ cand, const bool* __restrict__ cand_ok, int N,
        const int* __restrict__ kf_mp_idx, const bool* __restrict__ kf_fvalid,
        const bool* __restrict__ kf_valid, int F, const bool* __restrict__ cur_mask,
        int* __restrict__ w) {
    __shared__ int red[BLOCK / 32];
    const int ci = blockIdx.x, t = threadIdx.x;
    const int c = min(max(cand[ci], 0), N - 1);  // a gather clamps its index
    int s = 0;
    if (cand_ok[ci] && kf_valid[c]) {
        const int* idx = kf_mp_idx + (size_t)c * F;
        const bool* fv = kf_fvalid + (size_t)c * F;
        for (int f = t; f < F; f += BLOCK) {
            const int i = idx[f];
            s += (i >= 0 && fv[f] && cur_mask[i]) ? 1 : 0;
        }
    }
    for (int o = 16; o > 0; o >>= 1) s += __shfl_down_sync(0xffffffffu, s, o);
    if ((t & 31) == 0) red[t >> 5] = s;
    __syncthreads();
    if (t == 0) {
        int total = 0;
        for (int k = 0; k < BLOCK / 32; ++k) total += red[k];
        w[ci] = total;
    }
}

__global__ void __launch_bounds__(MAX_CAND) select_kernel(
        const int* __restrict__ cand, const bool* __restrict__ cand_ok,
        const int* __restrict__ w_in, int C, int K1, int self_q, int self_weight, int min_ok,
        int* __restrict__ local_rows, bool* __restrict__ local_ok, int* __restrict__ ref_new) {
    __shared__ int s_key[MAX_CAND], s_w[MAX_CAND];
    const int i = threadIdx.x;
    if (i < C) s_key[i] = cand_ok[i] ? cand[i] : -1 - i;
    __syncthreads();
    if (i < C) {
        bool dup = false;
        for (int j = 0; j < i; ++j) dup |= s_key[j] == s_key[i];
        s_w[i] = cand[i] == self_q ? self_weight : ((dup || !cand_ok[i]) ? 0 : w_in[i]);
    }
    __syncthreads();
    if (i < C) {
        const int v = s_w[i];
        int rank = 0;
        for (int j = 0; j < C; ++j) rank += (s_w[j] > v) | ((s_w[j] == v) & (j < i));
        if (rank < K1) {
            local_rows[rank] = cand[i];
            local_ok[rank] = v >= min_ok;
        }
        if (rank == 0 && ref_new) *ref_new = cand[i];
    }
    for (int j = C + i; j < K1; j += blockDim.x) {  // k > C: padding rows
        local_rows[j] = 0;
        local_ok[j] = false;
    }
}

// Marks the valid points observed by the ok rows of a keyframe list; grid
// (feature blocks, rows).
__global__ void __launch_bounds__(BLOCK) scatter_window_kernel(
        const int* __restrict__ rows, const bool* __restrict__ ok,
        const int* __restrict__ kf_mp_idx, const bool* __restrict__ kf_fvalid, int F,
        const bool* __restrict__ mp_valid, bool* __restrict__ mask) {
    const int k = blockIdx.y, f = blockIdx.x * BLOCK + threadIdx.x;
    if (!ok[k] || f >= F) return;
    const size_t o = (size_t)rows[k] * F + f;
    const int i = kf_mp_idx[o];
    if (i >= 0 && kf_fvalid[o] && mp_valid[i]) mask[i] = true;
}

// (5) One thread per window observation: its point, if valid, untracked and
// in the wide frustum, is marked in pmask (cleared before).
__global__ void __launch_bounds__(BLOCK) points_kernel(
        const int* __restrict__ local_rows, const bool* __restrict__ local_ok,
        const int* __restrict__ kf_mp_idx, const bool* __restrict__ kf_fvalid, int F,
        const bool* __restrict__ mp_valid, const bool* __restrict__ cur_mask,
        const float* __restrict__ pos, const float* __restrict__ min_dist,
        const float* __restrict__ max_dist, const float* __restrict__ normal,
        const float* __restrict__ T, CamArgs cam, bool* __restrict__ pmask) {
    const int k = blockIdx.y, f = blockIdx.x * BLOCK + threadIdx.x;
    if (!local_ok[k] || f >= F) return;
    const size_t o = (size_t)local_rows[k] * F + f;
    const int i = kf_mp_idx[o];
    if (i < 0 || !kf_fvalid[o] || !mp_valid[i] || cur_mask[i]) return;
    const View V = load_view(T);
    if (frustum(V, cam, pos + 3 * i, __fmul_rn(min_dist[i], 0.5f), __fmul_rn(max_dist[i], 2.0f),
                normal + 3 * i, -1.0f).ok)
        pmask[i] = true;
}

// (6) Compaction tiles are numbered from the top of [M]: tile t holds rows
// [lo, hi), lo = (n_tiles - 1 - t) TILE_ROWS, hi = min(lo + TILE_ROWS, M)
// (only the top tile can be short); thread j reads rows lo + 16 j .. + 15.
__device__ __forceinline__ int2 tile_rows(int t, int M) {
    const int n_tiles = (M + TILE_ROWS - 1) / TILE_ROWS;
    const int lo = (n_tiles - 1 - t) * TILE_ROWS;
    return make_int2(lo, min(lo + TILE_ROWS, M));
}

// Bit k set where row r0 + k is True (rows at or past hi read False): one
// 16-byte load where the 16 rows lie in [.., hi) and are aligned.
__device__ __forceinline__ unsigned mask16(const bool* mask, int r0, int hi) {
    unsigned bits = 0;
    if (r0 + 16 <= hi && ((size_t)(mask + r0) & 15) == 0) {
        const uint4 q = *reinterpret_cast<const uint4*>(mask + r0);
        const unsigned w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
        for (int k = 0; k < 16; ++k) bits |= ((w[k >> 2] >> (8 * (k & 3))) & 1u) << k;
    } else {
        for (int k = 0; k < 16 && r0 + k < hi; ++k) bits |= (mask[r0 + k] ? 1u : 0u) << k;
    }
    return bits;
}

// One block a tile: its True count.
__global__ void __launch_bounds__(BLOCK) compact_count_kernel(const bool* __restrict__ pmask,
                                                              int M, int* __restrict__ tile_true) {
    __shared__ int red[BLOCK / 32];
    const int2 tr = tile_rows(blockIdx.x, M);
    int n = __popc(mask16(pmask, tr.x + 16 * threadIdx.x, tr.y));
    for (int o = 16; o > 0; o >>= 1) n += __shfl_down_sync(0xffffffffu, n, o);
    if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = n;
    __syncthreads();
    if (threadIdx.x == 0) {
        int s = 0;
        for (int k = 0; k < BLOCK / 32; ++k) s += red[k];
        tile_true[blockIdx.x] = s;
    }
}

// One block a tile: True rows go to [0, total) from the top, False rows to
// [total, M) from the top; only places below L are written.
__global__ void __launch_bounds__(BLOCK) compact_scatter_kernel(
        const bool* __restrict__ pmask, int M, int L, const int* __restrict__ tile_true,
        int* __restrict__ rows, bool* __restrict__ rows_ok) {
    __shared__ int s_warp[32];
    __shared__ int s_pre, s_total;
    const int t = blockIdx.x, j = threadIdx.x;
    if (j < 32) {
        int pre = 0, total = 0;
        for (int k = j; k < (int)gridDim.x; k += 32) {
            const int c = tile_true[k];
            total += c;
            pre += k < t ? c : 0;
        }
        for (int o = 16; o > 0; o >>= 1) {
            pre += __shfl_down_sync(0xffffffffu, pre, o);
            total += __shfl_down_sync(0xffffffffu, total, o);
        }
        if (j == 0) {
            s_pre = pre;
            s_total = total;
        }
    }
    __syncthreads();
    const int2 tr = tile_rows(t, M);
    const int pre_true = s_pre, total = s_total;
    const int pre_false = (M - tr.y) - pre_true;
    if (pre_true >= L && total + pre_false >= L) return;  // uniform over the block
    const int r0 = tr.x + 16 * j;
    const unsigned bits = mask16(pmask, r0, tr.y);
    const int n_rows = max(0, min(16, tr.y - r0));
    const int nt = __popc(bits);
    // Rows above this thread's: threads j' > j. Scan (true << 16 | false)
    // over the reversed thread order (a tile's counts stay below 2^16).
    const int packed = (nt << 16) | (n_rows - nt);
    const int rj = BLOCK - 1 - j;
    __shared__ int s_rev[BLOCK];
    s_rev[rj] = packed;
    __syncthreads();
    const int incl = block_inclusive_scan(s_rev[j], s_warp);  // thread j scans slot j
    s_rev[j] = incl - s_rev[j];
    __syncthreads();
    const int ex = s_rev[rj];
    int pt = pre_true + (ex >> 16), pf = total + pre_false + (ex & 0xffff);
    for (int k = n_rows - 1; k >= 0; --k) {
        const int r = r0 + k;
        if ((bits >> k) & 1u) {
            if (pt < L) {
                rows[pt] = r;
                rows_ok[pt] = true;
            }
            ++pt;
        } else {
            if (pf < L) {
                rows[pf] = r;
                rows_ok[pf] = false;
            }
            ++pf;
        }
    }
}

__global__ void __launch_bounds__(BLOCK) frustum_rows_kernel(
        const int* __restrict__ rows, const bool* __restrict__ rows_ok, int L,
        const float* __restrict__ pos, const float* __restrict__ min_dist,
        const float* __restrict__ max_dist, const float* __restrict__ normal,
        const float* __restrict__ T, CamArgs cam, float log_sf, int n_levels,
        float2* __restrict__ uv, bool* __restrict__ visible, int* __restrict__ pred) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= L) return;
    const int r = rows[i];
    const View V = load_view(T);
    const float maxd = max_dist[r];
    const Frustum f = frustum(V, cam, pos + 3 * r, __fdiv_rn(min_dist[r], 1.2f),
                              __fmul_rn(maxd, 1.2f), normal + 3 * r, 0.5f);
    uv[i] = make_float2(f.u, f.v);
    visible[i] = f.ok && rows_ok[i];
    // PredictScale: ceil(log(maxd / d) / log(s) - 1e-3), clipped to the levels.
    const float ratio = __fdiv_rn(fmaxf(maxd, 1e-6f), fmaxf(f.dist, 1e-6f));
    const int lvl = (int)ceilf(__fsub_rn(__fdiv_rn(logf(ratio), log_sf), 1e-3f));
    pred[i] = min(max(lvl, 0), n_levels - 1);
}


int blocks(int n) { return (n + BLOCK - 1) / BLOCK; }

}  // namespace

// (1) Tracked-point mask over [M] and anchor-keyframe counts over [N]; with
// `fvalid` (a keyframe's own row) only its valid features count. N <= 12288.
C_ENTRY int local_scatter_current(const int* mp_idx, const bool* fvalid, int F,
                                  const int* mp_ref_kf, int M, int N, bool* cur_mask, int* counts,
                                  cudaStream_t stream) {
    const size_t shm = (size_t)N * sizeof(int);
    if (shm > 48 * 1024) return (int)cudaErrorInvalidValue;
    scatter_current_kernel<<<1, SCAN_THREADS, shm, stream>>>(mp_idx, fvalid, F, mp_ref_kf, M, N,
                                                             cur_mask, counts);
    return (int)cudaGetLastError();
}

// (2) Candidate keyframe list and its ok flags: n_anchor (<= MAX_CAND)
// anchors, the K1 rows of the previous window (K1 = 0: none), n_recent
// newest rows, then *extra_dev (if not null) and extra_host (if >= 0). The
// tracking step passes [ref_kf, 0], top_covisible_of [q].
C_ENTRY int local_candidates(const int* counts, int N, const int* n_kf, const int* prev_rows,
                             const bool* prev_ok, int K1, int n_anchor, int n_recent,
                             const int* extra_dev, int extra_host, int* cand, bool* cand_ok,
                             cudaStream_t stream) {
    if (n_anchor < 1 || n_anchor > N || n_anchor > MAX_CAND) return (int)cudaErrorInvalidValue;
    candidates_kernel<<<1, SCAN_THREADS, 0, stream>>>(counts, N, n_kf, prev_rows, prev_ok, K1,
                                                      n_anchor, n_recent, extra_dev, extra_host,
                                                      cand, cand_ok);
    return (int)cudaGetLastError();
}

// (3) Shared-point weight of each candidate.
C_ENTRY int local_weights(const int* cand, const bool* cand_ok, int C, int N,
                          const int* kf_mp_idx, const bool* kf_fvalid, const bool* kf_valid,
                          int F, const bool* cur_mask, int* w, cudaStream_t stream) {
    weights_kernel<<<C, BLOCK, 0, stream>>>(cand, cand_ok, N, kf_mp_idx, kf_fvalid, kf_valid, F,
                                            cur_mask, w);
    return (int)cudaGetLastError();
}

// (4) Dedupe (first valid kept), every copy of self_q weighted self_weight
// (self_q = -1: none), the top K1 in lax.top_k order with ok = weight >=
// min_ok, rows past C padded with (0, false), and the first as ref_new (if
// not null). C <= 1024.
C_ENTRY int local_select(const int* cand, const bool* cand_ok, const int* w, int C, int K1,
                         int self_q, int self_weight, int min_ok, int* local_rows, bool* local_ok,
                         int* ref_new, cudaStream_t stream) {
    if (C > MAX_CAND) return (int)cudaErrorInvalidValue;
    select_kernel<<<1, MAX_CAND, 0, stream>>>(cand, cand_ok, w, C, K1, self_q, self_weight,
                                              min_ok, local_rows, local_ok, ref_new);
    return (int)cudaGetLastError();
}

// (5) Local-map point mask: observed by the window, valid, untracked, in the
// wide frustum (distance band [min/2, 2 max], any viewing angle).
C_ENTRY int local_points(const int* local_rows, const bool* local_ok, int K1,
                         const int* kf_mp_idx, const bool* kf_fvalid, int F,
                         const bool* mp_valid, const bool* cur_mask, const float* pos,
                         const float* min_dist, const float* max_dist, const float* normal,
                         const float* T, int M, float fx, float fy, float cx, float cy, int width,
                         int height, bool* pmask, cudaStream_t stream) {
    cudaMemsetAsync(pmask, 0, (size_t)M, stream);
    const CamArgs cam{fx, fy, cx, cy, width, height};
    if (K1 > 0 && F > 0)
        points_kernel<<<dim3(blocks(F), K1), BLOCK, 0, stream>>>(
            local_rows, local_ok, kf_mp_idx, kf_fvalid, F, mp_valid, cur_mask, pos, min_dist,
            max_dist, normal, T, cam, pmask);
    return (int)cudaGetLastError();
}

// Valid points observed by the ok rows of a keyframe list (local_map_mask).
C_ENTRY int local_window_mask(const int* rows, const bool* ok, int K, const int* kf_mp_idx,
                              const bool* kf_fvalid, int F, const bool* mp_valid, int M, bool* mask,
                              cudaStream_t stream) {
    cudaMemsetAsync(mask, 0, (size_t)M, stream);
    if (K > 0 && F > 0)
        scatter_window_kernel<<<dim3(blocks(F), K), BLOCK, 0, stream>>>(rows, ok, kf_mp_idx,
                                                                        kf_fvalid, F, mp_valid,
                                                                        mask);
    return (int)cudaGetLastError();
}

// (6) Newest-first compaction of pmask [M] to L rows; work: ceil(M / 4096)
// ints (each tile's True count).
C_ENTRY int local_compact(const bool* pmask, int M, int L, int* rows, bool* rows_ok, int* work,
                          cudaStream_t stream) {
    const int n_tiles = (M + TILE_ROWS - 1) / TILE_ROWS;
    if (n_tiles == 0) return (int)cudaGetLastError();
    compact_count_kernel<<<n_tiles, BLOCK, 0, stream>>>(pmask, M, work);
    compact_scatter_kernel<<<n_tiles, BLOCK, 0, stream>>>(pmask, M, L, work, rows, rows_ok);
    return (int)cudaGetLastError();
}

// (7) Matching frustum (distance band [min/1.2, 1.2 max], view cos > 0.5),
// projection and predicted octave of the L compacted rows.
C_ENTRY int local_frustum(const int* rows, const bool* rows_ok, int L, const float* pos,
                          const float* min_dist, const float* max_dist, const float* normal,
                          const float* T, float fx, float fy, float cx, float cy, int width,
                          int height, float log_sf, int n_levels, float* uv, bool* visible,
                          int* pred, cudaStream_t stream) {
    const CamArgs cam{fx, fy, cx, cy, width, height};
    frustum_rows_kernel<<<blocks(L), BLOCK, 0, stream>>>(rows, rows_ok, L, pos, min_dist,
                                                         max_dist, normal, T, cam, log_sf,
                                                         n_levels, reinterpret_cast<float2*>(uv),
                                                         visible, pred);
    return (int)cudaGetLastError();
}
