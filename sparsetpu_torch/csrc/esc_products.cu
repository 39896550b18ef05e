// ESC SpGEMM's expansion and merge for Hopper, on the saturating integer
// semirings (u32, u64), each value in one native 64-bit word:
//
//   esc_counts:  counts[e] = nnz of B's row col_A[e], for every slot e of A
//                below nnz(A) (0 past it); the caller's torch.cumsum makes
//                the inclusive product prefix `cum` of it;
//   esc_expand:  for every slot t < expand_cap of the expansion, the fused
//                key row * n_cols + col of a_ik (x) b_kj and the saturating
//                product itself (KEY_SENTINEL and 0 past min(flops,
//                expand_cap));
//   esc_merge_*: over the keys sorted by the caller (torch.sort) and their
//                permutation, the sum of each run of equal keys with the
//                saturating add, zero totals dropped, compacted into CSR:
//                row_ptr (int32, n_rows + 1), col_idx (int32, INT32_SENTINEL
//                past nnz), the (lo, hi) int64 limbs (0 past nnz) and nnz,
//                poisoned to -1 past out_cap or where flops > expand_cap,
//                in four launches (tiles, carry, emit, rows).
//
// Every field equals the tensor-op version's (ops/spgemm.spgemm_reference)
// bit for bit: a saturating sum of non-negative integers is min(true sum,
// MAX) in any order, so the merge needs no order inside a segment.
//
// Replaces no TPU kernel.  The JAX package's ESC (sparsetpu/ops/spgemm.py,
// sparsetpu/ops/segments.py) is plain jnp that XLA fuses on the TPU; in
// PyTorch tensor ops the same ESC took about 130 int64 passes over the
// expansion stream a product (the u64 multiply alone ~60, in 16-bit halves
// of int64 limbs; the slot-to-entry map a scatter and a cumsum; the merge
// three cumsums and two compactions) and ~250 launches, and the ESC chain
// of the 30^3 torus ran at 0.18 % of its products' byte bound on the H100.
// Here the same work is one write of the expansion, the key sort, and two
// reads of the sorted stream.
//
// What bounds it on the card: bytes, and the latency of the searches.  The
// expansion writes 16 B a slot; the merge reads the sorted key and the
// permutation (16 B a position) and gathers the 8-byte product through the
// permutation, twice, and writes the CSR once.  The design:
//   - balance on skewed graphs: expansion threads map to slots, never to
//     rows or entries.  A slot finds its entry of A by a binary search of
//     the inclusive product prefix, and the entry's row by a search of A's
//     row offsets, each inside the window that the block's first and last
//     slots bound (found once a block by two searches of the whole arrays).
//     A hub row, or an entry whose row of B is long, spreads over as many
//     threads as it has products; entries with no products are passed over
//     by the search.  The merge maps threads to positions, so a long segment
//     is summed by the block scans and the carry, never walked by a thread;
//   - the merge in tiles of kTile = 2,048 positions, 8 a thread: a tile's
//     keys and gathered products are staged in shared memory (read striped,
//     so every warp's loads are coalesced; padded one word in nine against
//     bank conflicts), scanned in registers and across the block by warp
//     shuffles.  The first kernel writes a tile's summary (has it a segment
//     head, the sum of its last open segment, the sum of its leading segment
//     where that ends inside it, how many of its own segments are kept); one
//     block carries the open segment's sum and the output offset across the
//     tiles; the third kernel scans the tile again and writes each kept
//     segment at its offset, and the padding.  row_ptr is a lower-bound
//     search of the output rows, a thread a row;
//   - tried and no faster on the H100: the first merge pass writing the
//     gathered products back in sorted order for the second to read in order
//     (the second pass saved what the first spent), and a thread's kItems
//     slot searches run in lockstep, branch-free (the expansion 10 % slower);
//   - no host synchronisation: nnz, the flop count and every offset stay on
//     the device; the sizes come from expand_cap and out_cap;
//   - no __global__ name holds "sort": the benchmark's sort share reads the
//     key sort's own kernels by name.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

typedef long long i64;
typedef unsigned long long u64;

constexpr i64 kKeySentinel = 0x7fffffffffffffffLL;  // ops/segments.KEY_SENTINEL
constexpr int32_t kColSentinel = 0x7fffffff;         // ops/segments.INT32_SENTINEL
constexpr u64 kMask32 = 0xffffffffULL;

constexpr int kThreads = 256;              // a block of the slot and tile kernels
constexpr int kItems = 8;                  // slots or positions a thread takes
constexpr int kTile = kThreads * kItems;   // slots or positions a block takes
constexpr int kPadded = kTile + kTile / 8; // a tile staged with one pad word in nine
constexpr int kCarryThreads = 1024;        // the one block that carries across tiles
constexpr int kCarryItems = 8;             // tiles a thread of it takes at once
constexpr int kSummary = 4;                // a tile's summary: flags, open sum, lead sum, kept
constexpr int kCarry = 2;                  // a tile's carry: open sum before it, output offset
constexpr i64 kMaxBlocks = 1LL << 20;      // grid of the grid-stride kernels

__device__ __forceinline__ i64 lmin(i64 x, i64 y) { return x < y ? x : y; }

__device__ __forceinline__ i64 clamp(i64 x, i64 lo, i64 hi) {
    return x < lo ? lo : (x > hi ? hi : x);
}

// The semiring's saturating add and multiply: Wide is u64 (MAX = 2^64 - 1),
// else u32 (MAX = 2^32 - 1; its values are below 2^32, so nothing wraps).
template <bool Wide>
__device__ __forceinline__ u64 sat_add(u64 x, u64 y) {
    const u64 s = x + y;
    if (Wide) return s < x ? ~0ULL : s;
    return s > kMask32 ? kMask32 : s;
}

template <bool Wide>
__device__ __forceinline__ u64 sat_mul(u64 x, u64 y) {
    if (Wide) return __umul64hi(x, y) != 0 ? ~0ULL : x * y;
    const u64 p = x * y;
    return p > kMask32 ? kMask32 : p;
}

// The first index in [lo, hi) whose value exceeds t (hi if none does); v
// does not decrease.
template <typename T>
__device__ __forceinline__ i64 upper_bound(const T* __restrict__ v, i64 lo, i64 hi, i64 t) {
    while (lo < hi) {
        const i64 mid = lo + ((hi - lo) >> 1);
        if (static_cast<i64>(__ldg(v + mid)) <= t) lo = mid + 1; else hi = mid;
    }
    return lo;
}

// The first index in [lo, hi) whose value is at least t (hi if none is).
__device__ __forceinline__ i64 lower_bound(const int32_t* __restrict__ v, i64 lo, i64 hi, i64 t) {
    while (lo < hi) {
        const i64 mid = lo + ((hi - lo) >> 1);
        if (static_cast<i64>(__ldg(v + mid)) < t) lo = mid + 1; else hi = mid;
    }
    return lo;
}

// ---- expansion -------------------------------------------------------------

struct Operand {  // a SparseCSR's arrays
    const int32_t* row_ptr;
    const int32_t* col;
    const i64* lo;
    const i64* hi;  // null for u32
    i64 n_rows;
    i64 cap;
};

__global__ void __launch_bounds__(kThreads)
esc_counts_kernel(const int32_t* __restrict__ a_col, const i64* __restrict__ a_nnz, i64 cap_a,
                  const int32_t* __restrict__ b_row_ptr, i64 n_b, i64* __restrict__ counts) {
    const i64 nnz = *a_nnz;
    const i64 stride = static_cast<i64>(gridDim.x) * kThreads;
    for (i64 e = static_cast<i64>(blockIdx.x) * kThreads + threadIdx.x; e < cap_a; e += stride) {
        i64 c = 0;
        if (e < nnz && n_b > 0) {
            const i64 k = clamp(a_col[e], 0, n_b - 1);
            c = static_cast<i64>(b_row_ptr[k + 1]) - b_row_ptr[k];
        }
        counts[e] = c;
    }
}

template <bool Wide>
__global__ void __launch_bounds__(kThreads)
esc_expand_kernel(const i64* __restrict__ cum, Operand a, Operand b, i64 n_cols, i64 expand_cap,
                  i64* __restrict__ key, u64* __restrict__ word) {
    __shared__ i64 window[4];  // the block's first and last entry of A, and their rows
    const i64 total = a.cap > 0 ? cum[a.cap - 1] : 0;
    const i64 live = lmin(total, expand_cap);
    const i64 t0 = static_cast<i64>(blockIdx.x) * kTile;
    if (t0 < live && threadIdx.x < 2) {
        const i64 t = threadIdx.x == 0 ? t0 : lmin(t0 + kTile, live) - 1;
        const i64 e = upper_bound(cum, 0, a.cap, t);
        window[threadIdx.x] = e;
        window[2 + threadIdx.x] = upper_bound(a.row_ptr, 0, a.n_rows + 1, e) - 1;
    }
    __syncthreads();
    const i64 e_lo = window[0], e_hi = window[1], r_lo = window[2], r_hi = window[3];
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
        const i64 t = t0 + k * kThreads + threadIdx.x;
        if (t >= expand_cap) break;
        i64 kv = kKeySentinel;
        u64 w = 0;
        if (t < live) {
            // the entry whose products cover t, its first product, its row
            const i64 e = upper_bound(cum, e_lo, e_hi, t);
            const i64 first = e > 0 ? __ldg(cum + e - 1) : 0;
            const i64 r = upper_bound(a.row_ptr, r_lo + 1, r_hi + 1, e) - 1;
            const i64 col = clamp(__ldg(a.col + e), 0, b.n_rows - 1);
            const i64 bp = clamp(__ldg(b.row_ptr + col) + (t - first), 0, b.cap - 1);
            kv = r * n_cols + __ldg(b.col + bp);
            u64 x = static_cast<u64>(__ldg(a.lo + e));
            u64 y = static_cast<u64>(__ldg(b.lo + bp));
            if (Wide) {
                x |= static_cast<u64>(__ldg(a.hi + e)) << 32;
                y |= static_cast<u64>(__ldg(b.hi + bp)) << 32;
            }
            w = sat_mul<Wide>(x, y);
        }
        key[t] = kv;
        word[t] = w;
    }
}

// ---- merge -----------------------------------------------------------------

struct Seg {  // a span of the sorted stream under the segmented sum
    u64 v;    // the sum since the span's last segment head (or its start)
    int f;    // 1 where a segment head lies in the span
};

template <bool Wide>
__device__ __forceinline__ Seg seg_combine(Seg x, Seg y) {  // x, then y
    Seg r;
    r.v = y.f ? y.v : sat_add<Wide>(x.v, y.v);
    r.f = x.f | y.f;
    return r;
}

// The exclusive segmented scan of the block's threads in thread order, and
// the whole block's in `all`.  s_warp holds NT / 32 entries.
template <bool Wide, int NT>
__device__ __forceinline__ Seg block_scan(Seg x, Seg* s_warp, Seg& all) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    Seg inc = x;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
        Seg y;
        y.v = __shfl_up_sync(0xffffffffu, inc.v, d);
        y.f = __shfl_up_sync(0xffffffffu, inc.f, d);
        if (lane >= d) inc = seg_combine<Wide>(y, inc);
    }
    Seg ex;
    ex.v = __shfl_up_sync(0xffffffffu, inc.v, 1);
    ex.f = __shfl_up_sync(0xffffffffu, inc.f, 1);
    if (lane == 0) ex = Seg{0, 0};
    if (lane == 31) s_warp[warp] = inc;
    __syncthreads();
    Seg pre = Seg{0, 0};
    all = Seg{0, 0};
#pragma unroll
    for (int w = 0; w < NT / 32; ++w) {
        if (w == warp) pre = all;
        all = seg_combine<Wide>(all, s_warp[w]);
    }
    __syncthreads();
    return seg_combine<Wide>(pre, ex);
}

// The exclusive sum of the block's threads in thread order, and the whole
// block's in `all`.
template <int NT>
__device__ __forceinline__ i64 block_sum(i64 x, i64* s_warp, i64& all) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    i64 inc = x;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
        const i64 y = __shfl_up_sync(0xffffffffu, inc, d);
        if (lane >= d) inc += y;
    }
    if (lane == 31) s_warp[warp] = inc;
    __syncthreads();
    i64 pre = 0;
    all = 0;
#pragma unroll
    for (int w = 0; w < NT / 32; ++w) {
        if (w == warp) pre = all;
        all += s_warp[w];
    }
    __syncthreads();
    return pre + inc - x;
}

struct TileSmem {
    i64 key[kPadded];
    u64 val[kPadded];
    Seg warp_seg[kThreads / 32];
    i64 warp_sum[kThreads / 32];
    u64 lead;
    int has_lead;
};

// A thread's kItems consecutive positions of a tile, after the scan.
struct Items {
    i64 key[kItems];
    u64 sum[kItems];    // the segment's sum up to here, from its head or the tile's start
    bool own[kItems];   // the segment's head lies in the tile, at or before here
    bool tail[kItems];  // the segment's last position
};

__device__ __forceinline__ int padded(int i) { return i + (i >> 3); }

// Stage tile s0 of the sorted stream (n positions) and scan it: each
// position's key, its segment's running sum inside the tile, whether the
// segment's head lies in the tile, whether it is the segment's tail; `all`
// is the tile's (a head anywhere in it, the sum of its last segment).
template <bool Wide>
__device__ __forceinline__ void scan_tile(const i64* __restrict__ skey, const i64* __restrict__ perm,
                                          const u64* __restrict__ word, i64 n, i64 s0,
                                          TileSmem& sm, Items& it, Seg& all) {
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
        const int i = k * kThreads + threadIdx.x;
        const i64 p = s0 + i;
        i64 kv = kKeySentinel;
        u64 v = 0;
        if (p < n) {
            kv = skey[p];
            if (kv != kKeySentinel) v = __ldg(word + perm[p]);
        }
        sm.key[padded(i)] = kv;
        sm.val[padded(i)] = v;
    }
    const i64 before = s0 > 0 ? skey[s0 - 1] : kKeySentinel;
    const i64 after = s0 + kTile < n ? skey[s0 + kTile] : kKeySentinel;
    __syncthreads();
    Seg run = Seg{0, 0};
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
        const int i = threadIdx.x * kItems + k;
        const i64 kv = sm.key[padded(i)];
        const i64 prev = i > 0 ? sm.key[padded(i - 1)] : before;
        const i64 next = i + 1 < kTile ? sm.key[padded(i + 1)] : after;
        const bool valid = kv != kKeySentinel;
        Seg x;
        x.v = sm.val[padded(i)];
        x.f = valid && kv != prev ? 1 : 0;
        run = seg_combine<Wide>(run, x);
        it.key[k] = kv;
        it.sum[k] = run.v;
        it.own[k] = run.f != 0;
        it.tail[k] = valid && kv != next;
    }
    const Seg pre = block_scan<Wide, kThreads>(run, sm.warp_seg, all);
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
        if (!it.own[k]) it.sum[k] = sat_add<Wide>(pre.v, it.sum[k]);
        it.own[k] = it.own[k] || pre.f != 0;
    }
}

template <bool Wide>
__global__ void __launch_bounds__(kThreads)
esc_merge_tiles_kernel(const i64* __restrict__ skey, const i64* __restrict__ perm,
                       const u64* __restrict__ word, i64 n, i64* __restrict__ summary) {
    __shared__ TileSmem sm;
    if (threadIdx.x == 0) {
        sm.has_lead = 0;
        sm.lead = 0;
    }
    Items it;
    Seg all;
    scan_tile<Wide>(skey, perm, word, n, static_cast<i64>(blockIdx.x) * kTile, sm, it, all);
    i64 kept = 0;
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
        if (!it.tail[k]) continue;
        if (it.own[k]) {
            kept += it.sum[k] != 0;
        } else {  // the one tail of a segment that began before the tile
            sm.lead = it.sum[k];
            sm.has_lead = 1;
        }
    }
    i64 tile_kept;
    block_sum<kThreads>(kept, sm.warp_sum, tile_kept);
    if (threadIdx.x == 0) {
        i64* s = summary + static_cast<i64>(blockIdx.x) * kSummary;
        s[0] = all.f | (sm.has_lead << 1);
        s[1] = static_cast<i64>(all.v);
        s[2] = static_cast<i64>(sm.lead);
        s[3] = tile_kept;
    }
}

template <bool Wide>
__global__ void __launch_bounds__(kCarryThreads)
esc_merge_carry_kernel(const i64* __restrict__ summary, i64 n_tiles, i64* __restrict__ carry,
                       i64* __restrict__ count, const i64* __restrict__ flops, i64 expand_cap,
                       i64 out_cap, i64* __restrict__ nnz) {
    __shared__ Seg s_seg[kCarryThreads / 32];
    __shared__ i64 s_sum[kCarryThreads / 32];
    constexpr i64 kChunk = static_cast<i64>(kCarryThreads) * kCarryItems;
    Seg open = Seg{0, 0};  // the segment open where the chunk starts
    i64 base = 0;          // entries kept before the chunk
    for (i64 c0 = 0; c0 < n_tiles; c0 += kChunk) {
        const i64 b0 = c0 + static_cast<i64>(threadIdx.x) * kCarryItems;
        Seg mine = Seg{0, 0};
#pragma unroll
        for (int k = 0; k < kCarryItems; ++k) {
            const i64 b = b0 + k;
            if (b >= n_tiles) break;
            Seg x;
            x.v = static_cast<u64>(summary[b * kSummary + 1]);
            x.f = static_cast<int>(summary[b * kSummary] & 1);
            mine = seg_combine<Wide>(mine, x);
        }
        Seg chunk;
        Seg cur = seg_combine<Wide>(open, block_scan<Wide, kCarryThreads>(mine, s_seg, chunk));
        i64 kept[kCarryItems];
        i64 mine_kept = 0;
#pragma unroll
        for (int k = 0; k < kCarryItems; ++k) {
            const i64 b = b0 + k;
            kept[k] = 0;
            if (b >= n_tiles) continue;
            const i64* s = summary + b * kSummary;
            const int flags = static_cast<int>(s[0]);
            const bool lead_kept = (flags & 2) != 0 &&
                                   sat_add<Wide>(cur.v, static_cast<u64>(s[2])) != 0;
            kept[k] = s[3] + (lead_kept ? 1 : 0);
            carry[b * kCarry] = static_cast<i64>(cur.v);
            mine_kept += kept[k];
            Seg x;
            x.v = static_cast<u64>(s[1]);
            x.f = flags & 1;
            cur = seg_combine<Wide>(cur, x);
        }
        i64 chunk_kept;
        i64 off = base + block_sum<kCarryThreads>(mine_kept, s_sum, chunk_kept);
#pragma unroll
        for (int k = 0; k < kCarryItems; ++k) {
            const i64 b = b0 + k;
            if (b >= n_tiles) break;
            carry[b * kCarry + 1] = off;
            off += kept[k];
        }
        open = seg_combine<Wide>(open, chunk);
        base += chunk_kept;
    }
    if (threadIdx.x == 0) {
        *count = base;
        const i64 total = flops != nullptr ? *flops : 0;
        *nnz = base <= out_cap && total <= expand_cap ? base : -1;
    }
}

template <bool Wide>
__global__ void __launch_bounds__(kThreads)
esc_merge_emit_kernel(const i64* __restrict__ skey, const i64* __restrict__ perm,
                      const u64* __restrict__ word, i64 n, const i64* __restrict__ carry,
                      const i64* __restrict__ count, i64 n_cols, i64 out_cap,
                      int32_t* __restrict__ col_idx, i64* __restrict__ lo, i64* __restrict__ hi,
                      int32_t* __restrict__ out_row) {
    __shared__ TileSmem sm;
    Items it;
    Seg all;
    scan_tile<Wide>(skey, perm, word, n, static_cast<i64>(blockIdx.x) * kTile, sm, it, all);
    const u64 open = static_cast<u64>(carry[static_cast<i64>(blockIdx.x) * kCarry]);
    i64 mine = 0;
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
        if (it.tail[k] && !it.own[k]) it.sum[k] = sat_add<Wide>(open, it.sum[k]);
        it.tail[k] = it.tail[k] && it.sum[k] != 0;  // now: a kept segment ends here
        mine += it.tail[k];
    }
    i64 tile_kept;
    i64 o = carry[static_cast<i64>(blockIdx.x) * kCarry + 1] +
            block_sum<kThreads>(mine, sm.warp_sum, tile_kept);
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
        if (!it.tail[k]) continue;
        if (o < out_cap) {
            const i64 kv = it.key[k];
            col_idx[o] = static_cast<int32_t>(kv % n_cols);
            out_row[o] = static_cast<int32_t>(kv / n_cols);
            if (Wide) {
                lo[o] = static_cast<i64>(it.sum[k] & kMask32);
                hi[o] = static_cast<i64>(it.sum[k] >> 32);
            } else {
                lo[o] = static_cast<i64>(it.sum[k]);
            }
        }
        ++o;
    }
    // the padding past the kept entries
    const i64 m = lmin(*count, out_cap);
    const i64 stride = static_cast<i64>(gridDim.x) * kThreads;
    for (i64 q = m + static_cast<i64>(blockIdx.x) * kThreads + threadIdx.x; q < out_cap;
         q += stride) {
        col_idx[q] = kColSentinel;
        lo[q] = 0;
        if (Wide) hi[q] = 0;
    }
}

__global__ void __launch_bounds__(kThreads)
esc_merge_rows_kernel(const int32_t* __restrict__ out_row, const i64* __restrict__ count,
                      i64 out_cap, i64 n_rows, int32_t* __restrict__ row_ptr) {
    const i64 m = lmin(*count, out_cap);
    const i64 stride = static_cast<i64>(gridDim.x) * kThreads;
    for (i64 r = static_cast<i64>(blockIdx.x) * kThreads + threadIdx.x; r <= n_rows; r += stride)
        row_ptr[r] = static_cast<int32_t>(lower_bound(out_row, 0, m, r));
}

// Tiles of the merge over n sorted positions.
i64 tiles_of(i64 n) { return (n + kTile - 1) / kTile; }

unsigned grid_for(i64 work, i64 per_block) {
    const i64 want = (work + per_block - 1) / per_block;
    return static_cast<unsigned>(want < 1 ? 1 : (want < kMaxBlocks ? want : kMaxBlocks));
}

template <bool Wide>
int expand(const i64* cum, const Operand& a, const Operand& b, i64 n_cols, i64 expand_cap,
           i64* key, u64* word, cudaStream_t st) {
    const i64 blocks = (expand_cap + kTile - 1) / kTile;
    esc_expand_kernel<Wide><<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
        cum, a, b, n_cols, expand_cap, key, word);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Each entry point launches one kernel on `stream`, allocates nothing and returns
// cudaGetLastError() (0 = launched), or cudaErrorInvalidValue for a shape
// it does not take.  The caller checks the rest: contiguous tensors on one
// card, int32 offsets and columns, int64 limbs and nnz.

// counts: int64[cap_a]; a_nnz: A's nnz (an int64 on the card).
int esc_counts(const void* a_col, const void* a_nnz, int64_t cap_a, const void* b_row_ptr,
               int64_t n_b, void* counts, void* stream) {
    if (cap_a < 1 || n_b < 0) return static_cast<int>(cudaErrorInvalidValue);
    const auto st = static_cast<cudaStream_t>(stream);
    esc_counts_kernel<<<grid_for(cap_a, kThreads), kThreads, 0, st>>>(
        static_cast<const int32_t*>(a_col), static_cast<const i64*>(a_nnz), cap_a,
        static_cast<const int32_t*>(b_row_ptr), n_b, static_cast<i64*>(counts));
    return static_cast<int>(cudaGetLastError());
}

// cum: int64[cap_a], the inclusive prefix of esc_counts' counts; a_hi and
// b_hi null unless wide (u64); key, word: int64[expand_cap].
int esc_expand(const void* cum, int64_t cap_a, const void* a_row_ptr, int64_t n_a,
               const void* a_col, const void* a_lo, const void* a_hi, const void* b_row_ptr,
               int64_t n_b, int64_t cap_b, const void* b_col, const void* b_lo, const void* b_hi,
               int64_t n_cols, int64_t expand_cap, void* key, void* word, int wide,
               void* stream) {
    if (cap_a < 1 || cap_b < 1 || n_a < 0 || n_b < 0 || n_cols < 0 || expand_cap < 1 ||
        (expand_cap - 1) / kTile >= 0x7fffffffLL || (wide && (a_hi == nullptr || b_hi == nullptr)))
        return static_cast<int>(cudaErrorInvalidValue);
    const Operand a{static_cast<const int32_t*>(a_row_ptr), static_cast<const int32_t*>(a_col),
                    static_cast<const i64*>(a_lo), static_cast<const i64*>(a_hi), n_a, cap_a};
    const Operand b{static_cast<const int32_t*>(b_row_ptr), static_cast<const int32_t*>(b_col),
                    static_cast<const i64*>(b_lo), static_cast<const i64*>(b_hi), n_b, cap_b};
    const auto c = static_cast<const i64*>(cum);
    const auto st = static_cast<cudaStream_t>(stream);
    if (wide)
        return expand<true>(c, a, b, n_cols, expand_cap, static_cast<i64*>(key),
                            static_cast<u64*>(word), st);
    return expand<false>(c, a, b, n_cols, expand_cap, static_cast<i64*>(key),
                         static_cast<u64*>(word), st);
}

// The merge is four launches, in this order, over n sorted positions in
// n_tiles = ceil(n / 2048) tiles; the caller's scratch carries from one to
// the next: summary int64[4 * n_tiles], carry int64[2 * n_tiles], count an
// int64 (the kept entries, which may pass out_cap).  summary_len and
// carry_len are the caller's lengths of those buffers: any other length is
// cudaErrorInvalidValue, so a caller that sizes them from another tile
// never has them overrun.

// skey, perm: int64[n], the sorted keys and their permutation; word:
// int64[n], the products in expansion order.
int esc_merge_tiles(const void* skey, const void* perm, const void* word, int64_t n,
                    void* summary, int64_t summary_len, int wide, void* stream) {
    if (n < 1 || (n - 1) / kTile >= 0x7fffffffLL || summary_len != kSummary * tiles_of(n))
        return static_cast<int>(cudaErrorInvalidValue);
    const auto st = static_cast<cudaStream_t>(stream);
    const unsigned tiles = static_cast<unsigned>(tiles_of(n));
    const auto k = static_cast<const i64*>(skey);
    const auto p = static_cast<const i64*>(perm);
    const auto w = static_cast<const u64*>(word);
    const auto s = static_cast<i64*>(summary);
    if (wide)
        esc_merge_tiles_kernel<true><<<tiles, kThreads, 0, st>>>(k, p, w, n, s);
    else
        esc_merge_tiles_kernel<false><<<tiles, kThreads, 0, st>>>(k, p, w, n, s);
    return static_cast<int>(cudaGetLastError());
}

// flops: the true product count (an int64 on the card; null: 0); nnz: an
// int64, the count poisoned to -1 past out_cap or where flops > expand_cap.
int esc_merge_carry(const void* summary, int64_t summary_len, int64_t n, void* carry,
                    int64_t carry_len, void* count, const void* flops, int64_t expand_cap,
                    int64_t out_cap, void* nnz, int wide, void* stream) {
    const i64 n_tiles = tiles_of(n);
    if (n < 1 || out_cap < 1 || summary_len != kSummary * n_tiles || carry_len != kCarry * n_tiles)
        return static_cast<int>(cudaErrorInvalidValue);
    const auto st = static_cast<cudaStream_t>(stream);
    const auto s = static_cast<const i64*>(summary);
    const auto c = static_cast<i64*>(carry);
    const auto k = static_cast<i64*>(count);
    const auto f = static_cast<const i64*>(flops);
    const auto z = static_cast<i64*>(nnz);
    if (wide)
        esc_merge_carry_kernel<true><<<1, kCarryThreads, 0, st>>>(s, n_tiles, c, k, f, expand_cap,
                                                                  out_cap, z);
    else
        esc_merge_carry_kernel<false><<<1, kCarryThreads, 0, st>>>(s, n_tiles, c, k, f,
                                                                   expand_cap, out_cap, z);
    return static_cast<int>(cudaGetLastError());
}

// col_idx, out_row: int32[out_cap]; lo, hi: int64[out_cap] (hi null unless
// wide); out_row holds the kept entries' rows for esc_merge_rows.
int esc_merge_emit(const void* skey, const void* perm, const void* word, int64_t n,
                   const void* carry, int64_t carry_len, const void* count, int64_t n_cols,
                   int64_t out_cap, void* col_idx, void* lo, void* hi, void* out_row, int wide,
                   void* stream) {
    if (n < 1 || (n - 1) / kTile >= 0x7fffffffLL || carry_len != kCarry * tiles_of(n) ||
        n_cols < 0 || out_cap < 1 || (wide && hi == nullptr))
        return static_cast<int>(cudaErrorInvalidValue);
    const auto st = static_cast<cudaStream_t>(stream);
    const unsigned tiles = static_cast<unsigned>(tiles_of(n));
    const auto k = static_cast<const i64*>(skey);
    const auto p = static_cast<const i64*>(perm);
    const auto w = static_cast<const u64*>(word);
    const auto c = static_cast<const i64*>(carry);
    const auto m = static_cast<const i64*>(count);
    const auto col = static_cast<int32_t*>(col_idx);
    const auto l = static_cast<i64*>(lo);
    const auto h = static_cast<i64*>(hi);
    const auto r = static_cast<int32_t*>(out_row);
    if (wide)
        esc_merge_emit_kernel<true><<<tiles, kThreads, 0, st>>>(k, p, w, n, c, m, n_cols, out_cap,
                                                                col, l, h, r);
    else
        esc_merge_emit_kernel<false><<<tiles, kThreads, 0, st>>>(k, p, w, n, c, m, n_cols,
                                                                 out_cap, col, l, h, r);
    return static_cast<int>(cudaGetLastError());
}

// row_ptr: int32[n_rows + 1], a lower-bound search of esc_merge_emit's rows.
int esc_merge_rows(const void* out_row, const void* count, int64_t out_cap, int64_t n_rows,
                   void* row_ptr, void* stream) {
    if (n_rows < 0 || out_cap < 1) return static_cast<int>(cudaErrorInvalidValue);
    const auto st = static_cast<cudaStream_t>(stream);
    esc_merge_rows_kernel<<<grid_for(n_rows + 1, kThreads), kThreads, 0, st>>>(
        static_cast<const int32_t*>(out_row), static_cast<const i64*>(count), out_cap, n_rows,
        static_cast<int32_t*>(row_ptr));
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
