// Per-row sort + saturating merge + pack for Hopper: for every row of an
// (R, L) slab of (column, value) pairs,
//
//   1. sort the pairs by column, sentinel columns (INT32_MAX) last;
//   2. merge equal columns with the semiring's add: saturating u64 or u32,
//      or f32;
//   3. drop sentinels and zero totals;
//   4. pack the survivors to the front in ascending column order, the rest
//      of the row (INT32_MAX, 0).
//
// Layout, as the port stores a slab: cols int32[R, L]; u64 values as two
// int64 tensors lo and hi, each holding a uint32 limb; u32 values one int64
// tensor; f32 values one float32 tensor.  The output has the same layout.
// A u64 value is joined into one unsigned 64-bit integer and added with a
// carry-out test (saturate to 2^64 - 1), never in signed arithmetic.
//
// Replaces the TPU kernel sparsetpu/kernels/sortmerge.py::_kernel (called
// through sortmerge_rows), which runs one (8, L) tile per grid step: a
// lane-axis bitonic network built from rolls and selects, a segmented
// saturating Hillis-Steele scan, and a second bitonic pass to pack.
//
// What bounds it on the card: every slot is read once and written once
// (12-20 bytes each way), so at the rowcat sweep's shapes the floor is the
// slab's bytes over the memory rate; the sort costs log2(L)(log2(L)+1)/2
// compare-exchange stages of shared-memory traffic on top.  The design
// (simple first):
//   - one block of 256 threads per row, or per 2048 / L rows when L < 2048,
//     so a block holds at least 2,048 slots.  The row tile is staged in
//     dynamic shared memory: 12 bytes a slot for the integer semirings, 8
//     for f32, so L up to 16,384 fits one block (196 KB for u64, with the
//     opt-in above 48 KB).  Longer rows take the caller's batched route;
//   - a bitonic network over the tile, compare-exchange distances below L
//     only, so rows never mix; the last merge stage is ascending for every
//     row.  One __syncthreads between stages;
//   - the merge is a segmented inclusive scan with head flags (a head where
//     the column changes or a row starts): each thread scans a contiguous
//     chunk of tile / 256 slots, a Hillis-Steele scan over the 256 chunk
//     aggregates gives each chunk its carry, and a second pass over the
//     chunk writes the running totals in place.  Saturating add is
//     associative, so any grouping is exact for u32/u64; f32 sums take
//     another order than the plain version's (exact on integer values);
//   - the pack is a stream compaction, not a second sort: the survivors
//     already sit in ascending column order, so an exclusive scan of the
//     keep flags within each row gives each survivor its slot, and the
//     remaining slots are filled with the sentinel.  O(L) instead of
//     O(L log^2 L), the same result.
// Warp-shuffle stages for distances below 32, more threads for long rows,
// and conflict-free chunk layouts are later work.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMinTile = 2048;   // slots a block holds at the least
constexpr int kMaxL = 16384;     // the longest row one block's shared memory takes
constexpr int32_t kSentinel = 0x7fffffff;

enum Mode { kU64 = 0, kU32 = 1, kF32 = 2 };

template <int M> struct Sr;

template <> struct Sr<kU64> {
    using T = unsigned long long;
    __device__ static T add(T a, T b) {
        const T s = a + b;
        return s < a ? ~0ull : s;
    }
    __device__ static T load(const void* lo, const void* hi, int64_t g) {
        return static_cast<T>(static_cast<const int64_t*>(lo)[g]) |
               (static_cast<T>(static_cast<const int64_t*>(hi)[g]) << 32);
    }
    __device__ static void store(void* lo, void* hi, int64_t g, T v) {
        static_cast<int64_t*>(lo)[g] = static_cast<int64_t>(v & 0xffffffffull);
        static_cast<int64_t*>(hi)[g] = static_cast<int64_t>(v >> 32);
    }
};

template <> struct Sr<kU32> {
    using T = unsigned long long;  // a uint32 limb, widened: two never wrap
    __device__ static T add(T a, T b) {
        const T s = a + b;
        return s > 0xffffffffull ? 0xffffffffull : s;
    }
    __device__ static T load(const void* lo, const void*, int64_t g) {
        return static_cast<T>(static_cast<const int64_t*>(lo)[g]);
    }
    __device__ static void store(void* lo, void*, int64_t g, T v) {
        static_cast<int64_t*>(lo)[g] = static_cast<int64_t>(v);
    }
};

template <> struct Sr<kF32> {
    using T = float;
    __device__ static T add(T a, T b) { return a + b; }
    __device__ static T load(const void* lo, const void*, int64_t g) {
        return static_cast<const float*>(lo)[g];
    }
    __device__ static void store(void* lo, void*, int64_t g, T v) {
        static_cast<float*>(lo)[g] = v;
    }
};

template <int M> struct SrAdd {
    __device__ typename Sr<M>::T operator()(typename Sr<M>::T a, typename Sr<M>::T b) const {
        return Sr<M>::add(a, b);
    }
};

struct IntAdd {
    __device__ int operator()(int a, int b) const { return a + b; }
};

// Segmented scan over the block's 256 chunk aggregates (f: the chunk holds a
// segment head; v: the sum after its last head, or of the whole chunk).
// Returns the running sum at the end of the previous chunk: the carry into
// this chunk's first segment.  Every thread of the block must call it.
template <typename V, typename Op>
__device__ V chunk_carry(bool f, V v, unsigned char* s_f, V* s_v, Op op) {
    const int tid = threadIdx.x;
    s_f[tid] = f;
    s_v[tid] = v;
    __syncthreads();
    for (int off = 1; off < kThreads; off <<= 1) {
        const bool has = tid >= off;
        bool pf = false;
        V pv = V(0);
        if (has) {
            pf = s_f[tid - off];
            pv = s_v[tid - off];
        }
        __syncthreads();
        if (has) {
            if (!f) v = op(pv, v);
            f = f || pf;
            s_f[tid] = f;
            s_v[tid] = v;
        }
        __syncthreads();
    }
    const V carry = tid > 0 ? s_v[tid - 1] : V(0);
    __syncthreads();
    return carry;
}

template <int M>
__global__ void __launch_bounds__(kThreads)
sortmerge_rows_kernel(const int32_t* __restrict__ cols, const void* __restrict__ lo,
                      const void* __restrict__ hi, int32_t* __restrict__ out_cols,
                      void* __restrict__ out_lo, void* __restrict__ out_hi, int64_t n_rows,
                      int L, int rows_per_block) {
    using T = typename Sr<M>::T;
    extern __shared__ __align__(16) unsigned char smem[];
    const int tile = L * rows_per_block;
    T* s_val = reinterpret_cast<T*>(smem);                                  // [tile]
    unsigned long long* s_scan = reinterpret_cast<unsigned long long*>(s_val + tile);  // [kThreads]
    int32_t* s_col = reinterpret_cast<int32_t*>(s_scan + kThreads);         // [tile]
    int* s_nr = reinterpret_cast<int*>(s_col + tile);                       // [rows_per_block]
    unsigned char* s_flag = reinterpret_cast<unsigned char*>(s_nr + rows_per_block);  // [kThreads]

    const int tid = threadIdx.x;
    const int64_t row0 = static_cast<int64_t>(blockIdx.x) * rows_per_block;
    const int lmask = L - 1;

    // 1. stage the tile; rows past the slab are all sentinels
    for (int i = tid; i < tile; i += kThreads) {
        const int64_t row = row0 + i / L;
        if (row < n_rows) {
            const int64_t g = row * L + (i & lmask);
            s_col[i] = cols[g];
            s_val[i] = Sr<M>::load(lo, hi, g);
        } else {
            s_col[i] = kSentinel;
            s_val[i] = T(0);
        }
    }
    __syncthreads();

    // 2. bitonic sort of every row by column
    for (int k = 2; k <= L; k <<= 1) {
        for (int j = k >> 1; j > 0; j >>= 1) {
            for (int p = tid; p < tile / 2; p += kThreads) {
                const int i = 2 * p - (p & (j - 1));  // bit j of i is clear
                const int l = i + j;
                const bool up = k == L || (i & k) == 0;
                const int32_t ci = s_col[i];
                const int32_t cl = s_col[l];
                if (up ? ci > cl : ci < cl) {
                    s_col[i] = cl;
                    s_col[l] = ci;
                    const T t = s_val[i];
                    s_val[i] = s_val[l];
                    s_val[l] = t;
                }
            }
            __syncthreads();
        }
    }

    // 3. segmented running sums of equal columns, in place
    const int chunk = tile / kThreads;
    const int base = tid * chunk;
    auto is_head = [&](int i) { return (i & lmask) == 0 || s_col[i] != s_col[i - 1]; };
    bool f = false;
    T agg = T(0);
    for (int c = 0; c < chunk; ++c) {
        const int i = base + c;
        const T v = s_val[i];
        if (is_head(i)) {
            f = true;
            agg = v;
        } else {
            agg = Sr<M>::add(agg, v);
        }
    }
    T run = chunk_carry<T>(f, agg, s_flag, reinterpret_cast<T*>(s_scan), SrAdd<M>());
    for (int c = 0; c < chunk; ++c) {
        const int i = base + c;
        const T v = s_val[i];
        run = is_head(i) ? v : Sr<M>::add(run, v);
        s_val[i] = run;
    }

    // 4. keep a run's last slot when its column is real and its total is not
    //    zero; the rank of each kept slot within its row is its output slot
    auto keep = [&](int i) {
        const bool tail = (i & lmask) == lmask || s_col[i + 1] != s_col[i];
        return tail && s_col[i] != kSentinel && !(s_val[i] == T(0));
    };
    f = false;
    int cnt = 0;
    for (int c = 0; c < chunk; ++c) {
        const int i = base + c;
        if ((i & lmask) == 0) {
            f = true;
            cnt = 0;
        }
        cnt += keep(i);
    }
    int pos = chunk_carry<int>(f, cnt, s_flag, reinterpret_cast<int*>(s_scan), IntAdd());
    for (int c = 0; c < chunk; ++c) {
        const int i = base + c;
        const int64_t row = row0 + i / L;
        if ((i & lmask) == 0) pos = 0;
        if (keep(i)) {
            if (row < n_rows) {
                const int64_t g = row * L + pos;
                out_cols[g] = s_col[i];
                Sr<M>::store(out_lo, out_hi, g, s_val[i]);
            }
            ++pos;
        }
        if ((i & lmask) == lmask) s_nr[i / L] = pos;
    }
    __syncthreads();

    // 5. the rest of every row: (sentinel, 0)
    for (int i = tid; i < tile; i += kThreads) {
        const int64_t row = row0 + i / L;
        const int j = i & lmask;
        if (row < n_rows && j >= s_nr[i / L]) {
            const int64_t g = row * L + j;
            out_cols[g] = kSentinel;
            Sr<M>::store(out_lo, out_hi, g, T(0));
        }
    }
}

template <int M>
int launch(const void* cols, const void* lo, const void* hi, void* out_cols, void* out_lo,
           void* out_hi, int64_t n_rows, int L, cudaStream_t stream) {
    using T = typename Sr<M>::T;
    const int rows_per_block = L >= kMinTile ? 1 : kMinTile / L;
    const int tile = L * rows_per_block;
    const size_t smem = static_cast<size_t>(tile) * (sizeof(T) + 4) +
                        kThreads * (sizeof(unsigned long long) + 1) + 4 * rows_per_block;
    cudaError_t err = cudaFuncSetAttribute(sortmerge_rows_kernel<M>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    const int64_t blocks = (n_rows + rows_per_block - 1) / rows_per_block;
    sortmerge_rows_kernel<M><<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
        static_cast<const int32_t*>(cols), lo, hi, static_cast<int32_t*>(out_cols), out_lo,
        out_hi, n_rows, L, rows_per_block);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The longest row the kernel takes (L, a power of two).
int64_t sortmerge_rows_max_l() { return kMaxL; }

// Launches the sort-merge of an (n_rows, L) slab on `stream` and returns
// cudaGetLastError() (0 = launched), or cudaErrorInvalidValue for a shape or
// mode it does not take.  mode 0: u64 (lo, hi int64 limbs); 1: u32 (lo
// int64); 2: f32 (lo float32); hi / out_hi are ignored unless mode is 0.
// The caller checks: contiguous tensors of those types on one card,
// 1 <= n_rows < 2^31 * rows a block, L a power of two in [1, kMaxL].
int sortmerge_rows(const void* cols, const void* lo, const void* hi, void* out_cols,
                   void* out_lo, void* out_hi, int64_t n_rows, int64_t L, int mode,
                   void* stream) {
    if (L < 1 || L > kMaxL || (L & (L - 1)) != 0 || n_rows < 1)
        return static_cast<int>(cudaErrorInvalidValue);
    const int l = static_cast<int>(L);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (mode) {
        case kU64: return launch<kU64>(cols, lo, hi, out_cols, out_lo, out_hi, n_rows, l, s);
        case kU32: return launch<kU32>(cols, lo, hi, out_cols, out_lo, out_hi, n_rows, l, s);
        case kF32: return launch<kF32>(cols, lo, hi, out_cols, out_lo, out_hi, n_rows, l, s);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}

}  // extern "C"
