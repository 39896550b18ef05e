// Per-row sort + saturating merge + pack for Hopper: for every row of an
// (R, L) slab of (column, value) pairs,
//
//   1. sort the pairs by column, sentinel columns (INT32_MAX) last, equal
//      columns in slot order (as a stable sort leaves them);
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
// (12-20 bytes each way), so the floor is the slab's bytes over the memory
// rate.  The bitonic network has log2(L)(log2(L)+1)/2 compare-exchange
// stages (78 at L = 4,096); run through shared memory with a block barrier
// each, they cost several times the floor.
// The design keeps most of them in registers:
//   - the sort moves keys, not slots: one key a slot, its column above its
//     slot in the tile, so keys are unique, sentinels sort last and equal
//     columns keep their slot order.  Values stay put and are fetched once,
//     by the sorted slot, when merged.  A key is 64 bits ((column with its
//     sign bit flipped) << 32 | slot), or 32 bits where every column of the
//     tile fits above the slot's log2(tile) bits (columns below 2^18-2^21,
//     as the SpGEMM's are): a block votes, and the narrow keys halve the
//     shuffle and shared-memory traffic of the sort;
//   - a block holds a tile of max(L, 2,048) slots (2,048 / L rows: rows
//     never mix, since no stage compares across a row's boundary), E = 8,
//     16 or 32 consecutive keys a thread, 256-512 threads.  Stages at
//     distance j < E run in registers, E <= j < 32E through
//     __shfl_xor_sync between the lanes of a warp, and only j >= 32E
//     through shared memory (10 of the 78 stages at L = 4,096, E = 8), with
//     one round trip of the keys per merge size k, in a layout padded by a
//     word every E keys so both the per-thread and the per-pair accesses
//     are free of bank conflicts;
//   - a tile that holds only sentinels (the padding rows of a category's
//     slab) is written out as sentinels without a sort;
//   - after the sort the same shared memory holds the tile's values,
//     loaded coalesced, 16 bytes a thread where the slab is aligned.  The
//     merge is a segmented scan with head flags (a head where the column
//     changes or a row starts): each thread folds its E slots, warps scan
//     the thread aggregates with shuffles, and one carry a warp goes
//     through shared memory.  Saturating add is associative, so any
//     grouping is exact for u32/u64; f32 sums take another order than the
//     plain version's (exact on integer values).  Each run's total goes
//     back to its own slot (slots are unique, so no two threads collide);
//   - the pack is a stream compaction, O(L): a second segmented scan, of
//     the keep flags within each row, gives each survivor its place; the
//     rest of each row is written as sentinels, 16 bytes a thread where
//     aligned.
// Measured times are in PERF.md (chip_smoke.py phase 3).

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kMaxThreads = 512;
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kMinTile = 2048;   // slots a block holds at the least
constexpr int kMaxL = 16384;     // the longest row one block's shared memory takes
constexpr int32_t kSentinel = 0x7fffffff;

using u64 = unsigned long long;

enum Mode { kU64 = 0, kU32 = 1, kF32 = 2 };

template <int M> struct Sr;

template <> struct Sr<kU64> {
    using T = u64;
    __device__ static T add(T a, T b) {
        const T s = a + b;
        return s < a ? ~0ull : s;
    }
    __device__ static T load(const void* lo, const void* hi, int64_t g) {
        return static_cast<T>(static_cast<const int64_t*>(lo)[g]) |
               (static_cast<T>(static_cast<const int64_t*>(hi)[g]) << 32);
    }
    // slots g and g + 1 (g even, 16-byte aligned)
    __device__ static void load2(const void* lo, const void* hi, int64_t g, T& a, T& b) {
        const longlong2 l = __ldg(reinterpret_cast<const longlong2*>(
            static_cast<const int64_t*>(lo) + g));
        const longlong2 h = __ldg(reinterpret_cast<const longlong2*>(
            static_cast<const int64_t*>(hi) + g));
        a = static_cast<T>(l.x) | (static_cast<T>(h.x) << 32);
        b = static_cast<T>(l.y) | (static_cast<T>(h.y) << 32);
    }
    __device__ static void store(void* lo, void* hi, int64_t g, T v) {
        static_cast<int64_t*>(lo)[g] = static_cast<int64_t>(v & 0xffffffffull);
        static_cast<int64_t*>(hi)[g] = static_cast<int64_t>(v >> 32);
    }
    // zeros over slots g..g + 3 (g a multiple of 4, 16-byte aligned)
    __device__ static void zero4(void* lo, void* hi, int64_t g) {
        longlong2* l = reinterpret_cast<longlong2*>(static_cast<int64_t*>(lo) + g);
        longlong2* h = reinterpret_cast<longlong2*>(static_cast<int64_t*>(hi) + g);
        l[0] = l[1] = h[0] = h[1] = make_longlong2(0, 0);
    }
};

template <> struct Sr<kU32> {
    using T = u64;  // a uint32 limb, widened: two never wrap
    __device__ static T add(T a, T b) {
        const T s = a + b;
        return s > 0xffffffffull ? 0xffffffffull : s;
    }
    __device__ static T load(const void* lo, const void*, int64_t g) {
        return static_cast<T>(static_cast<const int64_t*>(lo)[g]);
    }
    __device__ static void load2(const void* lo, const void*, int64_t g, T& a, T& b) {
        const longlong2 l = __ldg(reinterpret_cast<const longlong2*>(
            static_cast<const int64_t*>(lo) + g));
        a = static_cast<T>(l.x);
        b = static_cast<T>(l.y);
    }
    __device__ static void store(void* lo, void*, int64_t g, T v) {
        static_cast<int64_t*>(lo)[g] = static_cast<int64_t>(v);
    }
    __device__ static void zero4(void* lo, void*, int64_t g) {
        longlong2* l = reinterpret_cast<longlong2*>(static_cast<int64_t*>(lo) + g);
        l[0] = l[1] = make_longlong2(0, 0);
    }
};

template <> struct Sr<kF32> {
    using T = float;
    __device__ static T add(T a, T b) { return a + b; }
    __device__ static T load(const void* lo, const void*, int64_t g) {
        return static_cast<const float*>(lo)[g];
    }
    __device__ static void load2(const void* lo, const void*, int64_t g, T& a, T& b) {
        const float2 v = __ldg(reinterpret_cast<const float2*>(static_cast<const float*>(lo) + g));
        a = v.x;
        b = v.y;
    }
    __device__ static void store(void* lo, void*, int64_t g, T v) {
        static_cast<float*>(lo)[g] = v;
    }
    __device__ static void zero4(void* lo, void*, int64_t g) {
        *reinterpret_cast<float4*>(static_cast<float*>(lo) + g) = make_float4(0.f, 0.f, 0.f, 0.f);
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

// The sort key of a slot: its column, then its slot in the tile, so keys
// are unique, sentinels sort last and equal columns keep their slot order.
// Two widths: 64 bits take any column (its sign bit flipped, so unsigned
// order is int32 order, above a 32-bit slot); 32 bits take a tile whose
// columns are all sentinels or in [0, 2^(32 - sb) - 1), sb = log2(tile)
// slot bits (18-21 column bits), the sentinel as the largest column code.
template <typename K> struct Keys;

template <> struct Keys<u64> {
    __device__ static u64 make(int32_t col, int slot, int) {
        return (static_cast<u64>(static_cast<uint32_t>(col) ^ 0x80000000u) << 32) |
               static_cast<uint32_t>(slot);
    }
    __device__ static int32_t col(u64 k, int) {
        return static_cast<int32_t>(static_cast<uint32_t>(k >> 32) ^ 0x80000000u);
    }
    __device__ static int slot(u64 k, int) { return static_cast<int>(k & 0xffffffffu); }
};

template <> struct Keys<uint32_t> {
    __device__ static uint32_t top(int sb) { return 0xffffffffu >> sb; }
    __device__ static bool fits(int32_t col, int sb) {
        return col == kSentinel || (col >= 0 && static_cast<uint32_t>(col) < top(sb));
    }
    __device__ static uint32_t make(int32_t col, int slot, int sb) {
        const uint32_t c = col == kSentinel ? top(sb) : static_cast<uint32_t>(col);
        return (c << sb) | static_cast<uint32_t>(slot);
    }
    __device__ static int32_t col(uint32_t k, int sb) {
        const uint32_t c = k >> sb;
        return c == top(sb) ? kSentinel : static_cast<int32_t>(c);
    }
    __device__ static int slot(uint32_t k, int sb) { return static_cast<int>(k & ((1u << sb) - 1)); }
};

// A key's word in shared memory: one pad word every E keys.
template <int E>
__device__ __forceinline__ int pad(int i) { return i + i / E; }

// Segmented scan over the block's threads in order.  (f, v): the thread's
// slots hold a segment head; the sum after its last head, or of all its
// slots.  Returns the carry into this thread, the running sum at the end of
// the previous thread (V(0) for thread 0).  Every thread of the block calls
// it; s_f and s_v hold kMaxWarps entries.
template <typename V, typename Op>
__device__ V block_carry(bool f, V v, Op op, int* s_f, V* s_v) {
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int nwarps = blockDim.x >> 5;
    int fi = f;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
        const int pf = __shfl_up_sync(0xffffffffu, fi, off);
        const V pv = __shfl_up_sync(0xffffffffu, v, off);
        if (lane >= off) {
            if (!fi) v = op(pv, v);
            fi |= pf;
        }
    }
    const int ef = __shfl_up_sync(0xffffffffu, fi, 1);
    const V ev = __shfl_up_sync(0xffffffffu, v, 1);
    if (lane == 31) {
        s_f[warp] = fi;
        s_v[warp] = v;
    }
    __syncthreads();
    if (warp == 0) {
        int wf = lane < nwarps ? s_f[lane] : 0;
        V wv = lane < nwarps ? s_v[lane] : V(0);
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
            const int pf = __shfl_up_sync(0xffffffffu, wf, off);
            const V pv = __shfl_up_sync(0xffffffffu, wv, off);
            if (lane >= off) {
                if (!wf) wv = op(pv, wv);
                wf |= pf;
            }
        }
        const V xv = __shfl_up_sync(0xffffffffu, wv, 1);
        if (lane < nwarps) s_v[lane] = lane ? xv : V(0);  // the running sum before each warp
    }
    __syncthreads();
    const V wc = s_v[warp];
    const V carry = lane == 0 ? wc : (ef ? ev : op(wc, ev));
    __syncthreads();  // s_f and s_v are free for the next call
    return carry;
}

// What a tile's threads share besides the key/value region.
template <typename T>
struct Scratch {
    int32_t* first;  // [threads]: each thread's first and last column
    int32_t* last;
    int* nr;         // [tile / L]: survivors of each row of the tile
    int* wf;         // [kMaxWarps]: block_carry's
    T* wv;
    int* wi;
};

// Bitonic sort of every row of the tile, keys in the blocked layout (thread
// t holds slots tE..tE+E-1); the last merge (k = L) ascending for all rows.
template <int E, typename K>
__device__ __forceinline__ void sort_rows(K (&key)[E], K* s_key, int L) {
    const int nthreads = blockDim.x;
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int base = tid * E;
    for (int k = 2; k <= L; k <<= 1) {
        const bool kfull = k == L;
        if (k > 32 * E) {  // distances 32E and up: through shared memory
#pragma unroll
            for (int e = 0; e < E; ++e) s_key[pad<E>(base + e)] = key[e];
            __syncthreads();
            for (int j = k >> 1; j >= 32 * E; j >>= 1) {
#pragma unroll 4
                for (int m = 0; m < E / 2; ++m) {
                    const int p = tid + m * nthreads;
                    const int i = 2 * p - (p & (j - 1));  // bit j of i is clear
                    const bool up = kfull || (i & k) == 0;
                    const K a = s_key[pad<E>(i)];
                    const K b = s_key[pad<E>(i + j)];
                    if (up ? a > b : a < b) {
                        s_key[pad<E>(i)] = b;
                        s_key[pad<E>(i + j)] = a;
                    }
                }
                __syncthreads();
            }
#pragma unroll
            for (int e = 0; e < E; ++e) key[e] = s_key[pad<E>(base + e)];
        }
        // distances E..16E: the partner sits in lane ^ (j / E), same register
        {
            const bool up = kfull || (base & k) == 0;
            for (int j = min(k >> 1, 16 * E); j >= E; j >>= 1) {
                const int m = j / E;
                const bool take_min = ((lane & m) == 0) == up;
#pragma unroll
                for (int e = 0; e < E; ++e) {
                    const K o = __shfl_xor_sync(0xffffffffu, key[e], m);
                    key[e] = take_min ? min(key[e], o) : max(key[e], o);
                }
            }
        }
        // distances below E: within the thread's registers
#pragma unroll
        for (int j = E / 2; j >= 1; j >>= 1) {
            if (j < k) {
#pragma unroll
                for (int e = 0; e < E; ++e) {
                    if ((e & j) == 0) {
                        const bool up = kfull || ((base + e) & k) == 0;
                        const K a = key[e];
                        const K b = key[e + j];
                        const bool sw = up ? a > b : a < b;
                        key[e] = sw ? b : a;
                        key[e + j] = sw ? a : b;
                    }
                }
            }
        }
    }
}

// The rest of every row of the tile, past its sc.nr[row] survivors:
// (sentinel, 0), four slots at a time where the four lie in one row past
// its survivors.  After a barrier that published sc.nr.
template <int M>
__device__ __forceinline__ void fill_rows(int32_t* out_cols, void* out_lo, void* out_hi,
                                          const int* nr, int64_t g0, int64_t total, int tile,
                                          int L, int log2_l, bool whole) {
    using T = typename Sr<M>::T;
    const int lmask = L - 1;
    if (whole && L >= 4) {
        for (int q = threadIdx.x; q < tile / 4; q += blockDim.x) {
            const int i = 4 * q;
            const int n = nr[i >> log2_l];
            const int j = i & lmask;
            const int64_t g = g0 + i;
            if (j >= n) {
                *reinterpret_cast<int4*>(out_cols + g) =
                    make_int4(kSentinel, kSentinel, kSentinel, kSentinel);
                Sr<M>::zero4(out_lo, out_hi, g);
            } else {
                for (int e = n - j; e < 4; ++e) {
                    out_cols[g + e] = kSentinel;
                    Sr<M>::store(out_lo, out_hi, g + e, T(0));
                }
            }
        }
    } else {
        for (int i = threadIdx.x; i < tile; i += blockDim.x) {
            const int64_t g = g0 + i;
            if (g < total && (i & lmask) >= nr[i >> log2_l]) {
                out_cols[g] = kSentinel;
                Sr<M>::store(out_lo, out_hi, g, T(0));
            }
        }
    }
}

// Sort, merge and pack one tile whose columns c[] are loaded (blocked), with
// keys of type K.
template <int M, int E, typename K>
__device__ __forceinline__ void sortmerge_tile(const int32_t (&c)[E], const void* lo,
                                               const void* hi, int32_t* out_cols, void* out_lo,
                                               void* out_hi, unsigned char* smem,
                                               const Scratch<typename Sr<M>::T>& sc, int64_t g0,
                                               int64_t total, int L, int log2_l, int sb,
                                               bool whole) {
    using T = typename Sr<M>::T;
    K* s_key = reinterpret_cast<K*>(smem);  // [tile + tile / E]: keys, then values
    T* s_val = reinterpret_cast<T*>(smem);  // [tile], by slot
    const int nthreads = blockDim.x;
    const int tile = nthreads * E;
    const int tid = threadIdx.x;
    const int base = tid * E;
    const int lmask = L - 1;

    K key[E];
#pragma unroll
    for (int e = 0; e < E; ++e) key[e] = Keys<K>::make(c[e], base + e, sb);
    sort_rows<E, K>(key, s_key, L);

    // the tile's values, by slot, into the shared memory the keys left
    __syncthreads();
    sc.first[tid] = Keys<K>::col(key[0], sb);
    sc.last[tid] = Keys<K>::col(key[E - 1], sb);
    if (whole) {
        for (int i = 2 * tid; i < tile; i += 2 * nthreads)
            Sr<M>::load2(lo, hi, g0 + i, s_val[i], s_val[i + 1]);
    } else {
        for (int i = tid; i < tile; i += nthreads) {
            const int64_t g = g0 + i;
            s_val[i] = g < total ? Sr<M>::load(lo, hi, g) : T(0);
        }
    }
    __syncthreads();

    // head bit e: slot base + e starts a run (a row start or a new column);
    // the run ends at e when bit e + 1 (or the next thread's first) is a head
    unsigned head = 0;
    {
        int32_t prev = tid > 0 ? sc.last[tid - 1] : 0;
#pragma unroll
        for (int e = 0; e < E; ++e) {
            const int32_t col = Keys<K>::col(key[e], sb);
            if (((base + e) & lmask) == 0 || col != prev) head |= 1u << e;
            prev = col;
        }
    }
    const bool next_head = tid + 1 == nthreads || ((base + E) & lmask) == 0 ||
                           sc.first[tid + 1] != Keys<K>::col(key[E - 1], sb);
    const unsigned tail = (head >> 1) | (static_cast<unsigned>(next_head) << (E - 1));

    // merge: the segmented scan of the values in sorted order
    bool f = false;
    T agg = T(0);
#pragma unroll
    for (int e = 0; e < E; ++e) {
        const T v = s_val[Keys<K>::slot(key[e], sb)];
        if (head >> e & 1u) {
            f = true;
            agg = v;
        } else {
            agg = Sr<M>::add(agg, v);
        }
    }
    T run = block_carry<T>(f, agg, SrAdd<M>(), sc.wf, sc.wv);
    unsigned keep = 0;
    bool rf = false;
    int cnt = 0;
#pragma unroll
    for (int e = 0; e < E; ++e) {
        const int slot = Keys<K>::slot(key[e], sb);
        const T v = s_val[slot];
        run = (head >> e & 1u) ? v : Sr<M>::add(run, v);
        if ((tail >> e & 1u) && Keys<K>::col(key[e], sb) != kSentinel && !(run == T(0))) {
            keep |= 1u << e;
            s_val[slot] = run;  // the run's total, at its own slot
        }
        if (((base + e) & lmask) == 0) {
            rf = true;
            cnt = 0;
        }
        cnt += keep >> e & 1u;
    }

    // pack: each survivor's place is the count of survivors before it in
    // its row
    int pos = block_carry<int>(rf, cnt, IntAdd(), sc.wf, sc.wi);
#pragma unroll
    for (int e = 0; e < E; ++e) {
        const int i = base + e;
        if ((i & lmask) == 0) pos = 0;
        if (keep >> e & 1u) {
            const int64_t g = g0 + (i & ~lmask) + pos;
            if (g < total) {
                out_cols[g] = Keys<K>::col(key[e], sb);
                Sr<M>::store(out_lo, out_hi, g, s_val[Keys<K>::slot(key[e], sb)]);
            }
            ++pos;
        }
        if ((i & lmask) == lmask) sc.nr[i >> log2_l] = pos;
    }
    __syncthreads();
    fill_rows<M>(out_cols, out_lo, out_hi, sc.nr, g0, total, tile, L, log2_l, whole);
}

template <int M, int E>
__global__ void __launch_bounds__(kMaxThreads)
sortmerge_rows_kernel(const int32_t* __restrict__ cols, const void* __restrict__ lo,
                      const void* __restrict__ hi, int32_t* __restrict__ out_cols,
                      void* __restrict__ out_lo, void* __restrict__ out_hi, int64_t n_rows,
                      int L, int log2_l, int vec) {
    using T = typename Sr<M>::T;
    extern __shared__ __align__(16) unsigned char smem[];
    __shared__ int32_t s_first[kMaxThreads];
    __shared__ int32_t s_last[kMaxThreads];
    __shared__ int s_nr[kMinTile];
    __shared__ int s_wf[kMaxWarps];
    __shared__ T s_wv[kMaxWarps];
    __shared__ int s_wi[kMaxWarps];
    const Scratch<T> sc{s_first, s_last, s_nr, s_wf, s_wv, s_wi};

    const int nthreads = blockDim.x;
    const int tile = nthreads * E;
    const int base = threadIdx.x * E;
    int sb = 0;  // log2(tile)
    while ((1 << sb) < tile) ++sb;
    const int64_t g0 = static_cast<int64_t>(blockIdx.x) * tile;  // the tile's first slot
    const int64_t total = n_rows * L;
    const bool whole = vec && g0 + tile <= total;

    // the thread's E consecutive columns; slots past the slab are sentinels
    int32_t c[E];
    if (whole) {
        const int4* src = reinterpret_cast<const int4*>(cols + g0 + base);
#pragma unroll
        for (int q = 0; q < E / 4; ++q) {
            const int4 v = __ldg(src + q);
            c[4 * q + 0] = v.x;
            c[4 * q + 1] = v.y;
            c[4 * q + 2] = v.z;
            c[4 * q + 3] = v.w;
        }
    } else {
#pragma unroll
        for (int e = 0; e < E; ++e) {
            const int64_t g = g0 + base + e;
            c[e] = g < total ? __ldg(cols + g) : kSentinel;
        }
    }
    bool real = false, narrow = true;
#pragma unroll
    for (int e = 0; e < E; ++e) {
        real |= c[e] != kSentinel;
        narrow &= Keys<uint32_t>::fits(c[e], sb);
    }
    if (!__syncthreads_or(real)) {  // a tile of padding rows: sentinels out
        for (int r = threadIdx.x; r < tile / L; r += nthreads) s_nr[r] = 0;
        __syncthreads();
        fill_rows<M>(out_cols, out_lo, out_hi, s_nr, g0, total, tile, L, log2_l, whole);
    } else if (__syncthreads_and(narrow)) {
        sortmerge_tile<M, E, uint32_t>(c, lo, hi, out_cols, out_lo, out_hi, smem, sc, g0, total,
                                       L, log2_l, sb, whole);
    } else {
        sortmerge_tile<M, E, u64>(c, lo, hi, out_cols, out_lo, out_hi, smem, sc, g0, total, L,
                                  log2_l, sb, whole);
    }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

template <int M, int E>
int launch_e(const void* cols, const void* lo, const void* hi, void* out_cols, void* out_lo,
             void* out_hi, int64_t n_rows, int L, int tile, cudaStream_t stream) {
    const int threads = tile / E;
    const size_t smem = static_cast<size_t>(tile + tile / E) * sizeof(u64);
    cudaError_t err = cudaFuncSetAttribute(sortmerge_rows_kernel<M, E>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    const int rows_per_block = tile / L;
    const int64_t blocks = (n_rows + rows_per_block - 1) / rows_per_block;
    const int vec = aligned16(cols) && aligned16(lo) && aligned16(hi) && aligned16(out_cols) &&
                    aligned16(out_lo) && aligned16(out_hi);
    int log2_l = 0;
    while ((1 << log2_l) < L) ++log2_l;
    sortmerge_rows_kernel<M, E><<<static_cast<unsigned>(blocks), threads, smem, stream>>>(
        static_cast<const int32_t*>(cols), lo, hi, static_cast<int32_t*>(out_cols), out_lo,
        out_hi, n_rows, L, log2_l, vec);
    return static_cast<int>(cudaGetLastError());
}

// E keys a thread: 8 in tiles of 2,048 and 4,096 slots (256 and 512
// threads), 16 in 8,192 and 32 in 16,384 (512 threads).  At L = 4,096,
// E = 8 runs faster than E = 16 (256 threads at over 100 registers): more
// threads an SM hide more of the loads' latency than the extra shuffle
// stages cost.
template <int M>
int launch(const void* cols, const void* lo, const void* hi, void* out_cols, void* out_lo,
           void* out_hi, int64_t n_rows, int L, cudaStream_t stream) {
    const int tile = L >= kMinTile ? L : kMinTile;
    if (tile <= 4096)
        return launch_e<M, 8>(cols, lo, hi, out_cols, out_lo, out_hi, n_rows, L, tile, stream);
    if (tile <= 8192)
        return launch_e<M, 16>(cols, lo, hi, out_cols, out_lo, out_hi, n_rows, L, tile, stream);
    return launch_e<M, 32>(cols, lo, hi, out_cols, out_lo, out_hi, n_rows, L, tile, stream);
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
        case kU32: return launch<kU32>(cols, lo, lo, out_cols, out_lo, out_lo, n_rows, l, s);
        case kF32: return launch<kF32>(cols, lo, lo, out_cols, out_lo, out_lo, n_rows, l, s);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}

}  // extern "C"
