// K9 `vocab`: bag-of-words assignment, tf-idf histogram (dense and sparse)
// and the L1 database scores.
//
// Replaces corbslam_tpu/place/vocab.py _assign (a flat [F, W] Hamming
// argmin as an int8 MXU product), _assign_tree (the 2-level descent: the
// top-2 of G group centres, then their child blocks), transform /
// transform_sparse (segment sums and a sort), transform_batch (the vmap of
// transform over a block of keyframes) and l1_scores / l1_scores_batch
// (sum_i min(q_i, d_i) over a dense [N, W] database).
//
// Bound on the H100: the assignment by operations (F x (G + 2 Cmax)
// distances of 256 bits: vocab32k's tree has G 1024 groups of C 32
// children, 1088 distances a descriptor); the scores by bytes (the whole
// [N, W] f32 database, 256 MB at 2048 x 32768, read once per query).
// Design: `vocab_assign` gives each descriptor one warp. Centres are packed
// LSB-first at load, like descriptors, so a distance is the popcount of an
// XOR. The lanes stride the group centres keeping a top-2 of 64-bit keys
// (distance << 32 | index: lower index first on ties, as lax.top_k), merged
// across the warp by shuffles; then each chosen group's child block is
// scanned in that order for its first minimum (jnp.argmin, padded children
// at 1 << 20), a later group replacing the best only when strictly nearer.
// Without a tree the lanes stride all W words. `vocab_hist` is one CTA a
// keyframe row (`transform`): zero the [W] row (a database row, written in
// place), add 1 per valid feature with float atomics (integer counts, exact
// in any order), scale by idf and divide by the L1 norm from a fixed-order
// block reduction.
// `vocab_transform_batch` (`transform_batch`) is one launch a call; its
// note is at the kernel.
// `vocab_sparse` is one CTA that ranks the F words in shared memory (rank =
// smaller words + equal words before it: the stable sort), counts each
// run and writes the first of each run. `vocab_l1_scores` gives each
// (query, database row) one CTA reading the row with 16-byte loads and
// every row is scored, live or not.

#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int ASSIGN_THREADS = 256;
constexpr int HIST_THREADS = 1024;
constexpr int SCORE_THREADS = 256;
constexpr int PAD_DIST = 1 << 20;

__device__ __forceinline__ int hamming(const uint4& a0, const uint4& a1, const uint4* b) {
    const uint4 b0 = b[0], b1 = b[1];
    return __popc(a0.x ^ b0.x) + __popc(a0.y ^ b0.y) + __popc(a0.z ^ b0.z) + __popc(a0.w ^ b0.w) +
           __popc(a1.x ^ b1.x) + __popc(a1.y ^ b1.y) + __popc(a1.z ^ b1.z) + __popc(a1.w ^ b1.w);
}

__device__ __forceinline__ unsigned long long key(int d, int i) {
    return ((unsigned long long)(unsigned)d << 32) | (unsigned)i;
}

__device__ __forceinline__ unsigned long long warp_min(unsigned long long k) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
        const unsigned long long other = __shfl_down_sync(0xffffffffu, k, o);
        k = other < k ? other : k;
    }
    return __shfl_sync(0xffffffffu, k, 0);
}

__global__ void assign_kernel(const uint4* desc, int F, const uint4* words, int W,
                              const uint4* groups, int G, const int* child, int C, int top_g,
                              int* out) {
    const int f = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
    const int lane = threadIdx.x & 31;
    if (f >= F) return;  // whole warps leave together
    const uint4 d0 = desc[2 * f], d1 = desc[2 * f + 1];
    const unsigned long long NONE = ~0ull;
    if (G == 0) {
        unsigned long long best = NONE;
        for (int w = lane; w < W; w += 32) {
            const unsigned long long k = key(hamming(d0, d1, words + 2 * w), w);
            best = k < best ? k : best;
        }
        best = warp_min(best);
        if (lane == 0) out[f] = (int)(best & 0xffffffffu);
        return;
    }
    unsigned long long k1 = NONE, k2 = NONE;  // lane's two smallest keys
    for (int g = lane; g < G; g += 32) {
        const unsigned long long k = key(hamming(d0, d1, groups + 2 * g), g);
        if (k < k1) {
            k2 = k1;
            k1 = k;
        } else if (k < k2) {
            k2 = k;
        }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
        const unsigned long long o1 = __shfl_down_sync(0xffffffffu, k1, o);
        const unsigned long long o2 = __shfl_down_sync(0xffffffffu, k2, o);
        const unsigned long long lo = k1 < o1 ? k1 : o1, hi = k1 < o1 ? o1 : k1;
        const unsigned long long m2 = k2 < o2 ? k2 : o2;
        k1 = lo;
        k2 = hi < m2 ? hi : m2;
    }
    k1 = __shfl_sync(0xffffffffu, k1, 0);
    k2 = __shfl_sync(0xffffffffu, k2, 0);
    int best_d = PAD_DIST, best_w = 0;
    for (int r = 0; r < top_g; ++r) {
        const int g = (int)(((r == 0) ? k1 : k2) & 0xffffffffu);
        unsigned long long best = NONE;
        for (int j = lane; j < C; j += 32) {
            const int kid = child[g * C + j];
            const int d = kid >= 0 ? hamming(d0, d1, words + 2 * kid) : PAD_DIST;
            const unsigned long long k = key(d, j);
            best = k < best ? k : best;
        }
        best = warp_min(best);
        const int dmin = (int)(best >> 32), jmin = (int)(best & 0xffffffffu);
        if (dmin < best_d) {
            best_d = dmin;
            best_w = child[g * C + jmin];
        }
    }
    if (lane == 0) out[f] = best_w;
}

__device__ float block_sum(float v, float* sh) {
    const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5, nw = blockDim.x >> 5;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    if (lane == 0) sh[wid] = v;
    __syncthreads();
    if (wid == 0) {
        float u = lane < nw ? sh[lane] : 0.f;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) u += __shfl_down_sync(0xffffffffu, u, o);
        if (lane == 0) sh[32] = u;
    }
    __syncthreads();
    const float r = sh[32];
    __syncthreads();
    return r;
}

__global__ void hist_kernel(const int* word, const bool* valid, int F, const float* idf, int W,
                            float* out) {
    __shared__ float sh[33];
    word += (size_t)blockIdx.x * F;  // this CTA's keyframe row
    valid += (size_t)blockIdx.x * F;
    out += (size_t)blockIdx.x * W;
    for (int i = threadIdx.x; i < W; i += blockDim.x) out[i] = 0.f;
    __syncthreads();
    for (int f = threadIdx.x; f < F; f += blockDim.x)
        if (valid[f]) atomicAdd(&out[word[f]], 1.f);
    __syncthreads();
    float part = 0.f;
    for (int i = threadIdx.x; i < W; i += blockDim.x) {
        const float v = __ldcg(out + i) * idf[i];
        out[i] = v;
        part += fabsf(v);
    }
    const float norm = fmaxf(block_sum(part, sh), 1e-9f);
    for (int i = threadIdx.x; i < W; i += blockDim.x) out[i] = out[i] / norm;
}

__global__ void sparse_kernel(const int* word, const bool* valid, int F, const float* idf, int W,
                              int* ids, float* vals) {
    extern __shared__ int shm[];
    int* wv = shm;         // [F] word or W (invalid)
    int* sw = shm + F;     // [F] sorted
    int* cnt = shm + 2 * F;  // [F] run length of sw[k]
    __shared__ float sh[33];
    for (int i = threadIdx.x; i < F; i += blockDim.x) wv[i] = valid[i] ? word[i] : W;
    __syncthreads();
    for (int i = threadIdx.x; i < F; i += blockDim.x) {
        const int x = wv[i];
        int less = 0, before = 0, eq = 0;
        for (int j = 0; j < F; ++j) {
            const int y = wv[j];
            less += y < x;
            eq += y == x;
            before += (y == x) & (j < i);
        }
        sw[less + before] = x;
        cnt[less + before] = eq;
    }
    __syncthreads();
    float part = 0.f;
    for (int k = threadIdx.x; k < F; k += blockDim.x) {
        const int x = sw[k];
        const bool first = k == 0 || sw[k - 1] != x;
        const int id = (first && x < W) ? x : -1;
        const float v = id >= 0 ? (float)cnt[k] * idf[id] : 0.f;
        ids[k] = id;
        vals[k] = v;
        part += fabsf(v);
    }
    const float norm = fmaxf(block_sum(part, sh), 1e-9f);
    for (int k = threadIdx.x; k < F; k += blockDim.x) vals[k] = vals[k] / norm;
}

__global__ void scores_kernel(const float* q, const float* db, int N, int W, float* out) {
    __shared__ float sh[33];
    const int n = blockIdx.x, qi = blockIdx.y;
    const float* d = db + (size_t)n * W;
    const float* qq = q + (size_t)qi * W;
    float part = 0.f;
    if ((W & 3) == 0) {
        const float4* d4 = reinterpret_cast<const float4*>(d);
        const float4* q4 = reinterpret_cast<const float4*>(qq);
        for (int i = threadIdx.x; i < W / 4; i += blockDim.x) {
            const float4 a = q4[i], b = __ldcs(d4 + i);
            part += fminf(a.x, b.x) + fminf(a.y, b.y) + fminf(a.z, b.z) + fminf(a.w, b.w);
        }
    } else {
        for (int i = threadIdx.x; i < W; i += blockDim.x) part += fminf(qq[i], d[i]);
    }
    const float s = block_sum(part, sh);
    if (threadIdx.x == 0) out[(size_t)qi * N + n] = s;
}

// ---------------------------------------------------------------------------
// vocab_transform_batch: K9 over a block of B keyframes in one launch
// ---------------------------------------------------------------------------
//
// transform_batch (the server's inserted chunks, its query blocks of up to
// 256 keyframes and the merge's chunks) in one launch: a CTA of TB_THREADS
// per (keyframe row, chunk of `chunk` descriptors), grid (chunks, B).
// - Centres: up to 1024 group centres (512 for a chunk over 256
//   descriptors; all W words without a tree) are
//   staged in shared memory at a time with their key constants
//   (popc(c) + 256) << 16 | c, the words of a centre interleaved (word t
//   beside word t + 4) so that a lane's two B words are one 64-bit load.
// - Group level: one b1 product of the chunk's valid descriptors (packed
//   to the front first, so an invalid feature costs nothing) against the
//   centres, mma.sync m16n8k256 .b1 .and.popc as K14 (the .xor form is
//   emulated on sm_90): d = popc(a) + popc(c) - 2 <a, c>, and popc(a) is a
//   row's constant, so key (popc(c) + 256 - 2 <a, c>) << 16 | c orders the
//   centres by distance, the lower index first on ties (lax.top_k). A warp
//   takes a tile of 16 descriptors (with few tiles, the warps split the
//   centres) and keeps each row's two least keys.
// - Child level: the chunk's (descriptor, chosen group) pairs are bucketed
//   by group in shared memory (a counting sort). Each touched group's child
//   block is staged once per CTA, from a copy of the tree laid out group by
//   group with each child's key constant (vocab.tree_layout: Cp = C rounded
//   up to 8 slots a group, made once per vocabulary), so a copy needs no
//   child id first. The work is items of 32 child slots of a group (one a
//   group for C <= 32; vocab32k has G 1024 of C 32); warp w takes items w,
//   w + 8, ... and stages each into its own ring of TB_RING slots with
//   cp.async, TB_RING - 1 items ahead of the one it matches, with no CTA
//   barrier (a ring of rounds shared by the CTA, barriers at each, spent
//   most of its time issuing and waiting: each block serves ~2 pairs). The
//   bucket meets the item on the tensor cores, in tiles of 16 pairs (a
//   CUDA-core scan for buckets of one pair measured no faster on the
//   server's blocks).
//   A pair keeps its block's least key (shared atomicMin over the items:
//   distance part << 16 | slot j, the first minimum inside a block; a
//   padded child, -1, at TB_PAD, above any distance). The best word: the
//   first group's, replaced by the second's only when strictly nearer (the
//   reference's scan from PAD_DIST).
//   Without a tree the group level over all W words is the assignment.
// - Finish: each CTA zero-fills its share of the row's [W] output and
//   writes its word ids (-1 for an invalid feature) before a per-row
//   atomic ticket (workspace word 24 + b, set back to 0); the last CTA of a
//   row sorts the row's <= F word ids in shared memory (a counting sort on
//   a bitmap of W bits), counts each distinct word, sums the L1 norm over
//   them in word order in a fixed order (thread i the words i, i + 256,
//   ..., then block_sum), and writes the nonzeros. transform_batch_plain
//   repeats that order. -DKERNEL_STAMPS: the summed durations of the group
//   level, the bucket, the child level, the word ids out, the finish's
//   counts and its end (words 9..14; `tb_phase`).
// Bound: the group level's distances (B x F x G) dominate; on the tensor
// cores a tile product is 128 distances, and each key is folded on the
// integer pipe (the kernel's limit at large B).
constexpr int TB_THREADS = 256;
constexpr int TB_WARPS = TB_THREADS / 32;
constexpr int TB_RING = 4;           // a warp's staging slots (items in flight: TB_RING - 1)
constexpr int TB_SLOT = 32 * 32 + 32 * 4;  // a slot: 32 child slots' words, then their keys
constexpr int TB_MAX_CHUNK = 1024;   // descriptors a CTA, at most
constexpr int TB_MAX_F = 4096;       // features a row (the finish sorts them in shared memory)
constexpr int TB_MAX_G = 4096;       // groups the bucket counts in shared memory
constexpr int TB_MAX_C = 256;        // children a group
constexpr int TB_TICKETS = 24;       // workspace: stamps at 8.., row tickets at 24 + b
constexpr unsigned TB_NO_KEY = 0xFFFFFFFFu;
constexpr unsigned TB_PAD = 0xFFFFu << 16;  // | j: a padded child

struct TbArgs {
    const uint4* desc;        // [B, F] 32 bytes each
    const bool* valid;        // [B, F]
    const uint4* words;       // [W]
    const uint4* groups;      // [G] or NULL (flat)
    const int* child;         // [G, C]
    const uint4* gw;          // [G, Cp] the child blocks' words, group by group (vocab.tree_layout)
    const unsigned* gk;       // [G, Cp] their key constants
    const float* idf;         // [W]
    int B, F, W, G, C, top_g, chunk, n_chunks;
    int* word_out;            // [B, F]
    float* out;               // [B, W]
    unsigned long long* work; // stamps at 8.., tickets at TB_TICKETS + b
};

// Shared-memory layout of a CTA (byte offsets), from the launch's sizes.
struct TbLayout {
    int desc, valid, word, part, off, pos, list, tg, ckey, tile, cen, ck, ring, end;
    // A chunk of up to 1024 descriptors fits two CTAs an SM (227 KB).
    __host__ __device__ TbLayout(int chunk, int G, bool tree) {
        int o = 0;
        desc = o; o += chunk * 32;
        valid = o; o += chunk * 4;
        word = o; o += chunk * 4;
        part = o; o += (chunk > 128 ? chunk : 128) * 8;
        off = o; o += (G + 1) * 4;
        list = o; o += 2 * chunk * 4;
        tg = o; o += (G < 2 * chunk ? G : 2 * chunk) * 4;
        ckey = o; o += 2 * chunk * 4;
        o = (o + 15) & ~15;
        // The centre tile (group level), the bucket positions (bucket) and
        // the warps' staging rings (child level) are not live together.
        const int base = o;
        tile = chunk <= 256 ? 1024 : 512;         // centres staged at a time
        cen = base;
        ck = cen + tile * 32;
        const int tile_end = ck + tile * 4;
        pos = base;                               // [2 chunk]
        const int pos_end = pos + 2 * chunk * 4;
        ring = base;                              // [TB_WARPS][TB_RING][TB_SLOT]
        const int ring_end = ring + (tree ? TB_WARPS * TB_RING * TB_SLOT : 0);
        end = tile_end > ring_end ? tile_end : ring_end;
        end = end > pos_end ? end : pos_end;
    }
};

// The finish's arrays (the last CTA of a row, all else dead): at offset 0.
__host__ __device__ inline int tb_finish_bytes(int F, int W) { return (W + 31) / 32 * 8 + F * 16; }

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

// b1 m16n8k256 with .and.popc (K14's tile product): lane (g, t) holds
// c[0..3] = rows g, g, g + 8, g + 8 and columns 2 t, 2 t + 1, 2 t, 2 t + 1.
__device__ __forceinline__ void tb_mma(int c[4], uint2 a_lo, uint2 a_hi, uint2 b) {
    asm volatile(
        "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
        : "r"(a_lo.x), "r"(a_hi.x), "r"(a_lo.y), "r"(a_hi.y), "r"(b.x), "r"(b.y));
}

// (k1, k2), the two least keys, with key k.
__device__ __forceinline__ void top2_add(unsigned& k1, unsigned& k2, unsigned k) {
    k2 = min(k2, max(k1, k));
    k1 = min(k1, k);
}

// (k1, k2) with another sorted pair (o1, o2).
__device__ __forceinline__ void top2_merge(unsigned& k1, unsigned& k2, unsigned o1, unsigned o2) {
    k2 = min(max(k1, o1), min(k2, o2));
    k1 = min(k1, o1);
}

// Exclusive scan of one int over the CTA (thread order); the total in
// *total. sh: TB_WARPS + 1 ints.
__device__ __forceinline__ int tb_exscan(int v, int* sh, int* total) {
    const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
    int x = v;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, x, o);
        if (lane >= o) x += y;
    }
    if (lane == 31) sh[wid] = x;
    __syncthreads();
    if (threadIdx.x == 0) {
        int s = 0;
        for (int w = 0; w < TB_WARPS; ++w) {
            const int n = sh[w];
            sh[w] = s;
            s += n;
        }
        sh[TB_WARPS] = s;
    }
    __syncthreads();
    const int before = sh[wid] + x - v;
    *total = sh[TB_WARPS];
    __syncthreads();
    return before;
}

// -DKERNEL_STAMPS: thread 0 of each CTA adds the nanoseconds of phase i
// (since its last phase) to workspace word 9 + i, summed over the CTAs (word
// 8 stays 0); without the define nothing.
__device__ __forceinline__ void tb_phase(unsigned long long* w, int i, unsigned long long& t) {
#ifdef KERNEL_STAMPS
    if (threadIdx.x == 0) {
        unsigned long long now;
        asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
        if (i >= 0) atomicAdd(w + 1 + i, now - t);
        t = now;
    }
#endif
}

__global__ void __launch_bounds__(TB_THREADS, 2) transform_batch_kernel(TbArgs a) {
    extern __shared__ __align__(16) unsigned char smem[];
    __shared__ int s_scan[TB_WARPS + 1];
    __shared__ int s_n_touched;
    __shared__ bool s_last;
    __shared__ float s_red[33];
    const TbLayout L(a.chunk, a.G, a.groups != nullptr);
    uint2* s_desc = reinterpret_cast<uint2*>(smem + L.desc);      // [chunk][4]
    int* s_src = reinterpret_cast<int*>(smem + L.valid);           // chunk index of valid k
    int* s_word = reinterpret_cast<int*>(smem + L.word);
    uint2* s_part = reinterpret_cast<uint2*>(smem + L.part);       // [slices][rows] top-2
    int* s_off = reinterpret_cast<int*>(smem + L.off);             // [G + 1]
    int* s_pos = reinterpret_cast<int*>(smem + L.pos);             // [2 chunk]
    int* s_list = reinterpret_cast<int*>(smem + L.list);           // [2 chunk]
    int* s_tg = reinterpret_cast<int*>(smem + L.tg);               // touched groups
    unsigned* s_ckey = reinterpret_cast<unsigned*>(smem + L.ckey); // [2 chunk]
    uint2* s_cen = reinterpret_cast<uint2*>(smem + L.cen);         // [L.tile][4]
    unsigned* s_ck = reinterpret_cast<unsigned*>(smem + L.ck);     // [L.tile]

    const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
    const int gq = lane >> 2, t4 = lane & 3;
    const int b = blockIdx.y, cidx = blockIdx.x;
    const int f0 = cidx * a.chunk;
    const int nloc = max(0, min(a.chunk, a.F - f0));
    const bool tree = a.groups != nullptr;
    unsigned long long* stamps = a.work + 8;
    unsigned long long* tickets = a.work + TB_TICKETS;
    unsigned long long t_ph = 0;
    tb_phase(stamps, -1, t_ph);

    // This CTA's share of the row's zero fill (ordered before the ticket).
    {
        float* row = a.out + (size_t)b * a.W;
        const int per = ((a.W + a.n_chunks - 1) / a.n_chunks + 3) & ~3;
        const int lo = min(a.W, cidx * per), hi = min(a.W, lo + per);
        if ((a.W & 3) == 0) {
            float4* r4 = reinterpret_cast<float4*>(row);
            for (int i = lo / 4 + tid; i < hi / 4; i += TB_THREADS) r4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
        } else {
            for (int i = lo + tid; i < hi; i += TB_THREADS) row[i] = 0.f;
        }
    }

    // The chunk's valid descriptors, in order (k: the k-th valid one,
    // s_src[k] its index in the chunk), interleaved, zeros past the last to
    // a tile's end. An invalid feature's word is -1.
    int nv;
    {
        const int per = (nloc + TB_THREADS - 1) / TB_THREADS;
        const int lo = min(nloc, tid * per), hi = min(nloc, lo + per);
        const bool* vrow = a.valid + (size_t)b * a.F + f0;
        int n = 0;
        for (int i = lo; i < hi; ++i) {
            n += vrow[i] ? 1 : 0;
            s_word[i] = -1;
        }
        int k = tb_exscan(n, s_scan, &nv);
        for (int i = lo; i < hi; ++i)
            if (vrow[i]) s_src[k++] = i;
    }
    __syncthreads();
    const int n_rt = (nv + 15) / 16;
    for (int k = tid; k < n_rt * 16; k += TB_THREADS) {
        uint4 x = make_uint4(0u, 0u, 0u, 0u), y = x;
        if (k < nv) {
            const size_t r = (size_t)b * a.F + f0 + s_src[k];
            x = a.desc[2 * r];
            y = a.desc[2 * r + 1];
        }
        s_desc[4 * k + 0] = make_uint2(x.x, y.x);
        s_desc[4 * k + 1] = make_uint2(x.y, y.y);
        s_desc[4 * k + 2] = make_uint2(x.z, y.z);
        s_desc[4 * k + 3] = make_uint2(x.w, y.w);
    }

    // Group level (all W words without a tree): every row's two least keys.
    const int n_cen = tree ? a.G : a.W;
    const int n_sl = n_rt >= TB_WARPS ? 1 : (n_rt > 0 ? TB_WARPS / n_rt : 1);
    const int n_items = n_rt * n_sl;
    for (int i = tid; i < n_sl * n_rt * 16; i += TB_THREADS) s_part[i] = make_uint2(TB_NO_KEY, TB_NO_KEY);
    for (int c0 = 0; c0 < n_cen && n_rt > 0; c0 += L.tile) {
        const int nc = min(L.tile, n_cen - c0);
        const int n_nt = (nc + 7) / 8;
        __syncthreads();  // the previous tile's readers are done
        const uint4* src = tree ? a.groups : a.words;
        for (int c = tid; c < n_nt * 8; c += TB_THREADS) {
            uint4 x = make_uint4(0u, 0u, 0u, 0u), y = x;
            unsigned k = TB_NO_KEY;
            if (c < nc) {
                x = src[2 * (c0 + c)];
                y = src[2 * (c0 + c) + 1];
                const int p = __popc(x.x) + __popc(x.y) + __popc(x.z) + __popc(x.w) +
                              __popc(y.x) + __popc(y.y) + __popc(y.z) + __popc(y.w);
                k = ((unsigned)(p + 256) << 16) | (unsigned)(c0 + c);
            }
            s_cen[4 * c + 0] = make_uint2(x.x, y.x);
            s_cen[4 * c + 1] = make_uint2(x.y, y.y);
            s_cen[4 * c + 2] = make_uint2(x.z, y.z);
            s_cen[4 * c + 3] = make_uint2(x.w, y.w);
            s_ck[c] = k;
        }
        __syncthreads();
        for (int it = wid; it < n_items; it += TB_WARPS) {
            const int rt = it / n_sl, sl = it % n_sl;
            const int r0 = rt * 16 + gq;
            const uint2 alo = s_desc[4 * r0 + t4], ahi = s_desc[4 * (r0 + 8) + t4];
            // Four tiles a step, each with its own running keys: four
            // products in flight and short key chains, merged after.
            unsigned k1[4], k2[4], m1[4], m2[4];  // rows gq (k) and gq + 8 (m)
#pragma unroll
            for (int u = 0; u < 4; ++u) k1[u] = k2[u] = m1[u] = m2[u] = TB_NO_KEY;
            const int nt0 = n_nt * sl / n_sl, nt1 = n_nt * (sl + 1) / n_sl;
            for (int nt = nt0; nt < nt1; nt += 4) {
                int c[4][4];
                uint2 kk[4];
#pragma unroll
                for (int u = 0; u < 4; ++u) {
                    const bool in = nt + u < nt1;
                    const uint2 bw = in ? s_cen[4 * ((nt + u) * 8 + gq) + t4] : make_uint2(0u, 0u);
                    kk[u] = in ? *reinterpret_cast<const uint2*>(s_ck + (nt + u) * 8 + 2 * t4)
                               : make_uint2(TB_NO_KEY, TB_NO_KEY);
                    c[u][0] = c[u][1] = c[u][2] = c[u][3] = 0;
                    tb_mma(c[u], alo, ahi, bw);
                }
#pragma unroll
                for (int u = 0; u < 4; ++u) {
                    top2_add(k1[u], k2[u], kk[u].x - ((unsigned)c[u][0] << 17));
                    top2_add(m1[u], m2[u], kk[u].x - ((unsigned)c[u][2] << 17));
                    top2_add(k1[u], k2[u], kk[u].y - ((unsigned)c[u][1] << 17));
                    top2_add(m1[u], m2[u], kk[u].y - ((unsigned)c[u][3] << 17));
                }
            }
#pragma unroll
            for (int u = 1; u < 4; ++u) {
                top2_merge(k1[0], k2[0], k1[u], k2[u]);
                top2_merge(m1[0], m2[0], m1[u], m2[u]);
            }
            unsigned p1 = k1[0], p2 = k2[0], q1 = m1[0], q2 = m2[0];
#pragma unroll
            for (int o = 1; o < 4; o <<= 1) {
                const unsigned o1 = __shfl_xor_sync(0xffffffffu, p1, o);
                const unsigned o2 = __shfl_xor_sync(0xffffffffu, p2, o);
                const unsigned o3 = __shfl_xor_sync(0xffffffffu, q1, o);
                const unsigned o4 = __shfl_xor_sync(0xffffffffu, q2, o);
                top2_merge(p1, p2, o1, o2);
                top2_merge(q1, q2, o3, o4);
            }
            if (t4 == 0) {
                uint2& e0 = s_part[sl * n_rt * 16 + r0];
                uint2& e1 = s_part[sl * n_rt * 16 + r0 + 8];
                top2_merge(e0.x, e0.y, p1, p2);
                top2_merge(e1.x, e1.y, q1, q2);
            }
        }
    }
    __syncthreads();
    for (int i = tid; i < nv; i += TB_THREADS) {
        uint2 e = s_part[i];
        for (int sl = 1; sl < n_sl; ++sl) {
            const uint2 o = s_part[sl * n_rt * 16 + i];
            top2_merge(e.x, e.y, o.x, o.y);
        }
        s_part[i] = e;
        if (!tree) s_word[s_src[i]] = (int)(e.x & 0xffffu);
    }
    __syncthreads();
    tb_phase(stamps, 0, t_ph);  // group level

    if (tree && nv > 0) {
        // Child level. Bucket the (descriptor, group) pairs by group.
        const int G = a.G, C = a.C, top_g = a.top_g;
        for (int g = tid; g < G; g += TB_THREADS) s_off[g] = 0;
        __syncthreads();
        for (int i = tid; i < nv; i += TB_THREADS) {
            const uint2 e = s_part[i];
            for (int r = 0; r < top_g; ++r) {
                const int g = (int)((r == 0 ? e.x : e.y) & 0xffffu);
                s_pos[2 * i + r] = atomicAdd(&s_off[g], 1);
                s_ckey[2 * i + r] = TB_NO_KEY;
            }
        }
        __syncthreads();
        {
            const int per = (G + TB_THREADS - 1) / TB_THREADS;
            const int lo = min(G, tid * per), hi = min(G, lo + per);
            int cs = 0, ts = 0;
            for (int g = lo; g < hi; ++g) {
                cs += s_off[g];
                ts += s_off[g] > 0;
            }
            // One scan of both: counts (< 2 chunk) low, touched groups high.
            int tot;
            const int before = tb_exscan((ts << 16) | cs, s_scan, &tot);
            int run = before & 0xffff, tr = before >> 16;
            const int ctot = tot & 0xffff, ttot = tot >> 16;
            for (int g = lo; g < hi; ++g) {
                const int n = s_off[g];
                s_off[g] = run;
                if (n) s_tg[tr++] = g;
                run += n;
            }
            if (tid == 0) {
                s_off[G] = ctot;
                s_n_touched = ttot;
            }
        }
        __syncthreads();
        for (int i = tid; i < nv; i += TB_THREADS) {
            const uint2 e = s_part[i];
            for (int r = 0; r < top_g; ++r) {
                const int g = (int)((r == 0 ? e.x : e.y) & 0xffffu);
                s_list[s_off[g] + s_pos[2 * i + r]] = 2 * i + r;
            }
        }
        __syncthreads();
        tb_phase(stamps, 1, t_ph);  // bucket

        // The touched groups' blocks in items of 32 child slots (one an
        // item for C <= 32), warp w taking items w, w + TB_WARPS, ...; the
        // warp stages each item alone with cp.async into its ring,
        // TB_RING - 1 items ahead of the one it matches (no CTA barrier).
        const int cp = (C + 7) & ~7, n_sl = (cp + 31) / 32;
        const int n_it = s_n_touched * n_sl;
        unsigned char* ring = smem + L.ring + wid * TB_RING * TB_SLOT;
        auto stage = [&](int k) {  // the warp's k-th item into slot k % TB_RING
            const int it = wid + k * TB_WARPS;
            if (it < n_it) {
                const int j = (it % n_sl) * 32 + lane;
                if (j < cp) {
                    const size_t q = (size_t)s_tg[it / n_sl] * cp + j;
                    unsigned char* slot = ring + (k % TB_RING) * TB_SLOT;
                    cp_async16(slot + lane * 32, a.gw + 2 * q);
                    cp_async16(slot + lane * 32 + 16, a.gw + 2 * q + 1);
                    cp_async4(slot + 1024 + lane * 4, a.gk + q);
                }
            }
            asm volatile("cp.async.commit_group;\n" ::);
        };
        for (int k = 0; k < TB_RING - 1; ++k) stage(k);
        for (int k = 0; wid + k * TB_WARPS < n_it; ++k) {
            stage(k + TB_RING - 1);
            asm volatile("cp.async.wait_group %0;\n" ::"n"(TB_RING - 1) : "memory");
            __syncwarp();
            const int it = wid + k * TB_WARPS;
            const int g = s_tg[it / n_sl], ns = min(32, cp - (it % n_sl) * 32);
            const unsigned* sw = reinterpret_cast<const unsigned*>(ring + (k % TB_RING) * TB_SLOT);
            const unsigned* sk = sw + 256;
            const int lo = s_off[g], n = s_off[g + 1] - lo;
            // Tensor cores: the item's 4 column tiles held in registers,
            // tiles of 16 pairs against them.
            uint2 bw[4], kk[4];
#pragma unroll
            for (int u = 0; u < 4; ++u) {
                const bool in = u * 8 < ns;
                const unsigned* w = sw + (u * 8 + gq) * 8;
                bw[u] = in ? make_uint2(w[t4], w[t4 + 4]) : make_uint2(0u, 0u);
                kk[u] = in ? *reinterpret_cast<const uint2*>(sk + u * 8 + 2 * t4)
                           : make_uint2(TB_NO_KEY, TB_NO_KEY);
            }
            for (int m0 = 0; m0 < n; m0 += 16) {
                const int pa = m0 + gq < n ? s_list[lo + m0 + gq] : -1;
                const int pb = m0 + gq + 8 < n ? s_list[lo + m0 + gq + 8] : -1;
                const uint2 z = make_uint2(0u, 0u);
                const uint2 alo = pa >= 0 ? s_desc[4 * (pa >> 1) + t4] : z;
                const uint2 ahi = pb >= 0 ? s_desc[4 * (pb >> 1) + t4] : z;
                unsigned ka = TB_NO_KEY, kb = TB_NO_KEY;
#pragma unroll
                for (int u = 0; u < 4; ++u) {
                    int c[4] = {0, 0, 0, 0};
                    tb_mma(c, alo, ahi, bw[u]);
                    ka = min(ka, min(kk[u].x - ((unsigned)c[0] << 17), kk[u].y - ((unsigned)c[1] << 17)));
                    kb = min(kb, min(kk[u].x - ((unsigned)c[2] << 17), kk[u].y - ((unsigned)c[3] << 17)));
                }
#pragma unroll
                for (int o = 1; o < 4; o <<= 1) {
                    ka = min(ka, __shfl_xor_sync(0xffffffffu, ka, o));
                    kb = min(kb, __shfl_xor_sync(0xffffffffu, kb, o));
                }
                if (t4 == 0) {
                    if (pa >= 0) atomicMin(s_ckey + pa, ka);
                    if (pb >= 0) atomicMin(s_ckey + pb, kb);
                }
            }
            __syncwarp();  // the slot is staged again TB_RING - 1 items on
        }
        asm volatile("cp.async.wait_group 0;\n" ::: "memory");
        __syncthreads();

        // The best word of each valid descriptor.
        for (int i = tid; i < nv; i += TB_THREADS) {
            const uint2 e = s_part[i];
            unsigned best_d = 0xffffu;
            int best_w = 0;
            for (int r = 0; r < top_g; ++r) {
                const unsigned k = s_ckey[2 * i + r];
                const unsigned d = k >> 16;
                if (d < best_d) {
                    best_d = d;
                    const int g = (int)((r == 0 ? e.x : e.y) & 0xffffu);
                    best_w = __ldg(a.child + (size_t)g * C + (int)(k & 0xffffu));
                }
            }
            s_word[s_src[i]] = best_w;
        }
        __syncthreads();
    }
    tb_phase(stamps, 2, t_ph);  // child level

    // Word ids out, then the row's ticket.
    for (int i = tid; i < nloc; i += TB_THREADS) a.word_out[(size_t)b * a.F + f0 + i] = s_word[i];
    __threadfence();
    __syncthreads();
    tb_phase(stamps, 3, t_ph);  // word ids out
    if (tid == 0) {
        s_last = atomicAdd(tickets + b, 1ull) == (unsigned long long)(a.n_chunks - 1);
    }
    __syncthreads();
    if (!s_last) return;
    __threadfence();
    if (tid == 0) atomicExch(tickets + b, 0ull);

    // Finish (the row's last CTA): its distinct words by a counting sort in
    // shared memory (a bitmap of W bits: the set bits in word order, each
    // word's rank the set bits before it), each word's count, the L1 norm
    // over them in word order, then the nonzeros.
    const int F = a.F, nbw = (a.W + 31) / 32;
    unsigned* s_bits = reinterpret_cast<unsigned*>(smem);  // [nbw]
    int* s_rank = reinterpret_cast<int*>(s_bits + nbw);    // [nbw]
    int* s_fw = s_rank + nbw;                              // [F] the row's word ids
    int* s_cnt = s_fw + F;                                 // [F] count by rank
    int* s_wid = s_cnt + F;                                // [F] word by rank
    float* s_val = reinterpret_cast<float*>(s_wid + F);    // [F]
    for (int k = tid; k < nbw; k += TB_THREADS) s_bits[k] = 0u;
    for (int k = tid; k < F; k += TB_THREADS) s_cnt[k] = 0;
    __syncthreads();
    for (int k = tid; k < F; k += TB_THREADS) {
        const int x = __ldcg(a.word_out + (size_t)b * F + k);
        s_fw[k] = x;
        if (x >= 0) atomicOr(s_bits + (x >> 5), 1u << (x & 31));
    }
    __syncthreads();
    int R;
    {
        const int per = (nbw + TB_THREADS - 1) / TB_THREADS;
        const int lo = min(nbw, tid * per), hi = min(nbw, lo + per);
        int n = 0;
        for (int k = lo; k < hi; ++k) n += __popc(s_bits[k]);
        int run = tb_exscan(n, s_scan, &R);
        for (int k = lo; k < hi; ++k) {
            s_rank[k] = run;
            for (unsigned m = s_bits[k]; m; m &= m - 1) s_wid[run++] = 32 * k + __ffs(m) - 1;
        }
    }
    __syncthreads();
    for (int k = tid; k < F; k += TB_THREADS) {
        const int x = s_fw[k];
        if (x >= 0)
            atomicAdd(s_cnt + s_rank[x >> 5] + __popc(s_bits[x >> 5] & ((1u << (x & 31)) - 1u)), 1);
    }
    __syncthreads();
    tb_phase(stamps, 4, t_ph);  // the finish's counts
    float part = 0.f;
#pragma unroll 4
    for (int q = tid; q < R; q += TB_THREADS) {
        const float v = __fmul_rn((float)s_cnt[q], __ldg(a.idf + s_wid[q]));
        s_val[q] = v;
        part = __fadd_rn(part, fabsf(v));
    }
    const float norm = fmaxf(block_sum(part, s_red), 1e-9f);
    float* row = a.out + (size_t)b * a.W;
    for (int q = tid; q < R; q += TB_THREADS) row[s_wid[q]] = __fdiv_rn(s_val[q], norm);
    tb_phase(stamps, 5, t_ph);  // the finish's norm and nonzeros
}

}  // namespace

// Word id of each of F packed descriptors; G = 0 for a flat vocabulary.
C_ENTRY int vocab_assign(const uint8_t* desc, int F, const uint8_t* words, int W,
                         const uint8_t* groups, int G, const int* child, int C, int top_g,
                         int* out, cudaStream_t stream) {
    const int blocks = (F * 32 + ASSIGN_THREADS - 1) / ASSIGN_THREADS;
    if (F > 0)
        assign_kernel<<<blocks, ASSIGN_THREADS, 0, stream>>>(
            reinterpret_cast<const uint4*>(desc), F, reinterpret_cast<const uint4*>(words), W,
            reinterpret_cast<const uint4*>(groups), G, child, C, top_g, out);
    return (int)cudaGetLastError();
}

// L1-normalized tf-idf histograms of B keyframe rows: words and valid
// [B, F] -> out [B, W], a CTA a row.
C_ENTRY int vocab_hist(const int* word, const bool* valid, int B, int F, const float* idf, int W,
                       float* out, cudaStream_t stream) {
    if (B > 0) hist_kernel<<<B, HIST_THREADS, 0, stream>>>(word, valid, F, idf, W, out);
    return (int)cudaGetLastError();
}

// Sparse form (ids [F], weights [F]) in sorted-word order; F <= 4096.
C_ENTRY int vocab_sparse(const int* word, const bool* valid, int F, const float* idf, int W,
                         int* ids, float* vals, cudaStream_t stream) {
    sparse_kernel<<<1, HIST_THREADS, (size_t)3 * F * sizeof(int), stream>>>(word, valid, F, idf,
                                                                           W, ids, vals);
    return (int)cudaGetLastError();
}

// [Q, N] scores of Q queries against every row of an [N, W] database.
C_ENTRY int vocab_l1_scores(const float* q, int Q, const float* db, int N, int W, float* out,
                            cudaStream_t stream) {
    if (N > 0 && Q > 0)
        scores_kernel<<<dim3(N, Q), SCORE_THREADS, 0, stream>>>(q, db, N, W, out);
    return (int)cudaGetLastError();
}

// transform_batch of B keyframe rows in one launch: descriptors [B, F, 32]
// and valid [B, F] -> out [B, W] (L1-normalized tf-idf) and word_out [B, F]
// (-1 for an invalid feature). G = 0 for a flat vocabulary; a tree's blocks
// also group by group (gw [G, Cp, 32], keys gk [G, Cp]). `chunk` (a
// multiple of 16, <= 1024) descriptors a CTA. `work` holds 24 + B words,
// the B row tickets zero between calls on a stream.
C_ENTRY int vocab_transform_batch(const uint8_t* desc, const bool* valid, int B, int F,
                                  const uint8_t* words, int W, const uint8_t* groups, int G,
                                  const int* child, int C, const uint8_t* gw, const int* gk,
                                  int top_g, const float* idf, int chunk, int* word_out, float* out,
                                  unsigned long long* work, cudaStream_t stream) {
    const bool tree = groups != nullptr;
    if (B < 0 || B > 65535 || F < 0 || F > TB_MAX_F || W < 1 || W > 65536 || chunk < 16 ||
        chunk > TB_MAX_CHUNK || (chunk & 15) ||
        (tree ? (G < 1 || G > TB_MAX_G || C < 1 || C > TB_MAX_C || top_g < 1 || top_g > 2 ||
                 top_g > G || child == nullptr || gw == nullptr || gk == nullptr)
              : G != 0))
        return (int)cudaErrorInvalidValue;
    if (B == 0) return (int)cudaGetLastError();
    const int n_chunks = F > 0 ? (F + chunk - 1) / chunk : 1;
    const TbLayout L(chunk, tree ? G : 0, tree);
    const int fin = tb_finish_bytes(F, W);
    const int smem = L.end > fin ? L.end : fin;
    static int attr = 0;
    if (smem > attr) {
        const cudaError_t err = cudaFuncSetAttribute(
            transform_batch_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (err != cudaSuccess) return (int)err;
        attr = smem;
    }
    const TbArgs a{reinterpret_cast<const uint4*>(desc), valid,
                   reinterpret_cast<const uint4*>(words), reinterpret_cast<const uint4*>(groups),
                   child, reinterpret_cast<const uint4*>(gw), reinterpret_cast<const unsigned*>(gk),
                   idf, B, F, W, tree ? G : 0, tree ? C : 0, top_g, chunk, n_chunks,
                   word_out, out, work};
    transform_batch_kernel<<<dim3(n_chunks, B), TB_THREADS, smem, stream>>>(a);
    return (int)cudaGetLastError();
}
