// The two sweeps of the tiled dense routes (ops/denseacc._two_sweeps) over
// one dense C panel: an (n, w) row-major f32 carrier, columns [lo, lo + w)
// of the product:
//
//   panel_count: sweep 1.  counts[r] = the cells of row r that are != 0
//                (int32), and, where asked (the integer semirings), the
//                panel's exactness fault OR-ed into a device word: a cell
//                that is not below 2^24, a NaN included, as the tensor ops'
//                max() < 2^24 poisons;
//   panel_pack:  sweep 2.  Each nonzero of row r, in row-major order, at
//                slot row_ptr[r] + prior[r] + (its rank in the row) of the
//                product: its column lo + j (int32) and its value as the
//                semiring's limbs (u32: the int64 lo limb; u64: the lo limb
//                and a 0 hi limb; f32: the value itself).
//
// Every slot written equals the tensor ops' (ops/denseacc's plain sweeps,
// which take CPU tensors) bit for bit: the same cells, in the same order, at
// the same offsets; a limb is the value truncated to int64, and a value
// outside int64's range (or a NaN) gives INT64_MIN, as the CPU's conversion
// does.  The caller fills the slots past the product's total.
//
// Replaces no TPU kernel.  The JAX package packs with jnp
// (sparsetpu/ops/denseacc.py::_panel_pack_merge: a lane sort and scatters),
// which XLA fuses on the TPU.  In PyTorch tensor ops the two sweeps read each
// dense panel five times (the exactness max and count_nonzero in sweep 1;
// max, != 0, nonzero_static and count_nonzero in sweep 2) and ran ~15 int64
// passes over pow2(the largest panel's nnz) slots to scatter the entries into
// the product: 62 % of the device time of Graph 500's SCALE-17 A^2 on the
// H100 (64 panels of 131,072 x 2,048, 1 GiB each), against 38 % for the
// dense-accumulator kernel that makes the panels.
//
// What bounds it on the card: bytes.  Each launch reads its panel once (4 B a
// cell); the count writes 4 B a row, the pack reads two int32 offsets a row
// and writes 4 B of column and the limbs an entry, nothing else.  The design:
//   - a warp a row, eight rows a block: a row's cells are read by the warp in
//     chunks of 128 (a float4 a lane, where w % 4 == 0 and the panel is
//     16-byte aligned) or of 32 (a float a lane, any other width), streamed
//     past the L1 (__ldcs: a panel is read once and is far larger than the
//     L2);
//   - the count: a lane counts its cells, one warp reduction a row, lane 0
//     writes it; one atomicOr a warp only where a fault is found;
//   - the pack: a warp loads kBatch = 4 chunks of its row (four loads in
//     flight a lane) before it ranks them, by ballots, one a cell position
//     of the lane (popc of the lanes below); the batch's entries are staged
//     in the warp's slice of shared memory in row order and then written
//     lane by lane to consecutive slots, so each store instruction writes
//     32 consecutive entries of the row's run (writing each entry from the
//     lane that found it took 0.634 ms against 0.521 on the cell's panel,
//     and loading one chunk at a time 0.68 ms; NVIDIA H100 80GB HBM3,
//     700 W).  A write past the row's end (row_ptr[r + 1]) is dropped, so no
//     panel that disagrees with sweep 1's counts can write outside its row;
//   - no host synchronisation and no allocation; the caller sizes the
//     product from sweep 1's counts (one small read);
//   - no __global__ name holds "spmm_dense_acc": the benchmark finds the
//     dense-accumulator kernel's time by that name.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

typedef long long i64;

constexpr int kWarps = 8;                  // rows a block takes, a warp each
constexpr int kThreads = 32 * kWarps;
constexpr int kBatch = 4;                  // chunks of a row a warp loads before it packs them
constexpr unsigned kFull = 0xffffffffu;
constexpr float kExactLimit = 16777216.0f;           // 2^24, csr.F32_EXACT_LIMIT
constexpr float kI64Limit = 9223372036854775808.0f;  // 2^63
constexpr i64 kI64Min = -0x7fffffffffffffffLL - 1;

// V cells of a row from column j: a float4 (V == 4; j + 3 < w) or a float
// (V == 1); zeros past the row's end.
template <int V>
__device__ __forceinline__ void load_cells(const float* __restrict__ row, i64 j, i64 w,
                                           float (&v)[V]) {
    if constexpr (V == 4) {
        float4 q = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (j < w) q = __ldcs(reinterpret_cast<const float4*>(row + j));
        v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
    } else {
        v[0] = j < w ? __ldcs(row + j) : 0.0f;
    }
}

// The int64 lo limb of an f32 carrier value: truncated toward zero, and
// INT64_MIN outside [-2^63, 2^63) or for a NaN (the CPU's conversion).
__device__ __forceinline__ i64 to_limb(float v) {
    return (v >= -kI64Limit && v < kI64Limit) ? static_cast<i64>(v) : kI64Min;
}

template <int V>
__global__ void __launch_bounds__(kThreads)
panel_count_kernel(const float* __restrict__ panel, i64 n, i64 w, int32_t* __restrict__ counts,
                   int* __restrict__ fault, bool check) {
    const i64 r = static_cast<i64>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
    if (r >= n) return;  // the whole warp: r is the warp's
    const int lane = threadIdx.x & 31;
    const float* row = panel + r * w;
    int count = 0;
    bool bad = false;
#pragma unroll 4
    for (i64 j = static_cast<i64>(lane) * V; j < w; j += 32 * V) {
        float v[V];
        load_cells<V>(row, j, w, v);
#pragma unroll
        for (int k = 0; k < V; ++k) {
            count += v[k] != 0.0f;
            bad |= !(v[k] < kExactLimit);
        }
    }
    count = __reduce_add_sync(kFull, count);
    if (check && __any_sync(kFull, bad) && lane == 0) atomicOr(fault, 1);
    if (lane == 0) counts[r] = count;
}

// Limbs: 0 the f32 value, 1 the u32 lo limb, 2 the u64 lo and hi limbs.
template <int V, int Limbs>
__global__ void __launch_bounds__(kThreads)
panel_pack_kernel(const float* __restrict__ panel, i64 n, i64 w, i64 lo,
                  const int32_t* __restrict__ row_ptr, const int32_t* __restrict__ prior,
                  int32_t* __restrict__ col, void* __restrict__ val_lo,
                  i64* __restrict__ val_hi) {
    constexpr int kCells = kBatch * 32 * V;  // cells of a row a warp takes at once
    __shared__ int32_t s_col[kWarps][kCells];
    __shared__ float s_val[kWarps][kCells];
    const int wi = threadIdx.x >> 5;
    const i64 r = static_cast<i64>(blockIdx.x) * kWarps + wi;
    if (r >= n) return;  // the whole warp; only warp barriers below
    const int lane = threadIdx.x & 31;
    const unsigned below = (1u << lane) - 1u;
    const float* row = panel + r * w;
    i64 base = static_cast<i64>(row_ptr[r]) + prior[r];
    const i64 end = row_ptr[r + 1];
    for (i64 j0 = 0; j0 < w; j0 += kCells) {
        float v[kBatch][V];  // kBatch chunks' loads in flight before any is ranked
#pragma unroll
        for (int b = 0; b < kBatch; ++b)
            load_cells<V>(row, j0 + (b * 32 + lane) * V, w, v[b]);
        int seen = 0;  // the batch's entries so far (the same in every lane)
#pragma unroll
        for (int b = 0; b < kBatch; ++b) {
            int before = 0, chunk = 0;
#pragma unroll
            for (int k = 0; k < V; ++k) {
                const unsigned ball = __ballot_sync(kFull, v[b][k] != 0.0f);
                before += __popc(ball & below);
                chunk += __popc(ball);
            }
            int t = seen + before;
#pragma unroll
            for (int k = 0; k < V; ++k) {
                if (v[b][k] != 0.0f) {
                    s_col[wi][t] = static_cast<int32_t>(lo + j0 + (b * 32 + lane) * V + k);
                    s_val[wi][t] = v[b][k];
                    ++t;
                }
            }
            seen += chunk;
        }
        __syncwarp();
        for (int i = lane; i < seen; i += 32) {  // consecutive slots, lane by lane
            const i64 s = base + i;
            if (s < end) {
                col[s] = s_col[wi][i];
                if constexpr (Limbs == 0) {
                    static_cast<float*>(val_lo)[s] = s_val[wi][i];
                } else {
                    static_cast<i64*>(val_lo)[s] = to_limb(s_val[wi][i]);
                    if constexpr (Limbs == 2) val_hi[s] = 0;
                }
            }
        }
        base += seen;
        __syncwarp();  // the staging is read before the next batch writes it
    }
}

bool vectorised(const void* panel, i64 w) {
    return w % 4 == 0 && reinterpret_cast<uintptr_t>(panel) % 16 == 0;
}

unsigned blocks_for(i64 n) { return static_cast<unsigned>((n + kWarps - 1) / kWarps); }

template <int V>
void launch_pack(const float* p, i64 n, i64 w, i64 lo, const int32_t* rp, const int32_t* pr,
                 int32_t* col, void* vlo, i64* vhi, int limbs, cudaStream_t st) {
    const unsigned g = blocks_for(n);
    if (limbs == 0)
        panel_pack_kernel<V, 0><<<g, kThreads, 0, st>>>(p, n, w, lo, rp, pr, col, vlo, vhi);
    else if (limbs == 1)
        panel_pack_kernel<V, 1><<<g, kThreads, 0, st>>>(p, n, w, lo, rp, pr, col, vlo, vhi);
    else
        panel_pack_kernel<V, 2><<<g, kThreads, 0, st>>>(p, n, w, lo, rp, pr, col, vlo, vhi);
}

}  // namespace

extern "C" {

// Each entry point launches one kernel on `stream`, allocates nothing and
// returns cudaGetLastError() (0 = launched), or cudaErrorInvalidValue for a
// shape it does not take (n or w < 1, n >= 2^31, a column past int32).  The
// caller checks the rest: contiguous tensors on one card, an f32 panel,
// int32 counts and offsets, the limbs' types.

// panel: float[n * w]; counts: int32[n]; fault: an int32 on the card, OR-ed
// with 1 where `check` and a cell is not below 2^24.
int panel_count(const void* panel, int64_t n, int64_t w, void* counts, void* fault, int check,
                void* stream) {
    if (n < 1 || n >= 0x80000000LL || w < 1 || (check && fault == nullptr))
        return static_cast<int>(cudaErrorInvalidValue);
    const auto st = static_cast<cudaStream_t>(stream);
    const auto p = static_cast<const float*>(panel);
    const auto c = static_cast<int32_t*>(counts);
    const auto f = static_cast<int*>(fault);
    if (vectorised(panel, w))
        panel_count_kernel<4><<<blocks_for(n), kThreads, 0, st>>>(p, n, w, c, f, check != 0);
    else
        panel_count_kernel<1><<<blocks_for(n), kThreads, 0, st>>>(p, n, w, c, f, check != 0);
    return static_cast<int>(cudaGetLastError());
}

// row_ptr: int32[n + 1], the product's; prior: int32[n], each row's entries
// in the panels before this one; col: int32 and val_lo: int64 (f32 where
// limbs == 0) at every slot the rows reach; val_hi: int64, null unless
// limbs == 2.
int panel_pack(const void* panel, int64_t n, int64_t w, int64_t lo, const void* row_ptr,
               const void* prior, void* col, void* val_lo, void* val_hi, int limbs,
               void* stream) {
    if (n < 1 || n >= 0x80000000LL || w < 1 || lo < 0 || lo + w > 0x80000000LL ||
        limbs < 0 || limbs > 2 || (limbs == 2) != (val_hi != nullptr))
        return static_cast<int>(cudaErrorInvalidValue);
    const auto st = static_cast<cudaStream_t>(stream);
    const auto p = static_cast<const float*>(panel);
    const auto rp = static_cast<const int32_t*>(row_ptr);
    const auto pr = static_cast<const int32_t*>(prior);
    const auto c = static_cast<int32_t*>(col);
    const auto hi = static_cast<i64*>(val_hi);
    if (vectorised(panel, w))
        launch_pack<4>(p, n, w, lo, rp, pr, c, val_lo, hi, limbs, st);
    else
        launch_pack<1>(p, n, w, lo, rp, pr, c, val_lo, hi, limbs, st);
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
