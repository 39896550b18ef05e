// The tiled dense accumulator's CSR-panel form: one dense C panel,
//
//     C[i, j - lo] = sum over entries (i, k, a) of A, and over entries
//                    (k, j, v) of B with lo <= j < lo + w:  a * v,
//
// for columns [lo, lo + w) of C = A x B, with B read from its CSR: no dense
// panel of B exists.  A is the dense form's operand (int32 row_ptr, int32
// col, f32 val); B is its columns (int32) and its values in the f32 carrier,
// with a (k, panels + 1) int32 table of each row's first slot at each panel
// boundary (ops/denseacc builds it once a product, on the card), so row k's
// entries in panel p are slots [table[k, p], table[k, p + 1]).  C is the
// (n_rows, w) row-major f32 panel that the count and pack kernels
// (csrc/panel_pack.cu) read, written whole.
//
// Replaces no TPU kernel: the JAX package densifies B's panel and runs the
// Pallas dense accumulator (sparsetpu/ops/denseacc.py::spgemm_dense_acc_tiled),
// which csrc/spmm_dense_acc.cu ports.  Added because on a sparse B that form
// gathers one whole panel row of B for each entry of A: 30.5 GB a launch on
// Graph 500's SCALE-17 A^2 (3.7M entries x 2,048 columns x 4 B), from a
// panel ~99.98 % zeros, against ~54M products a launch.  This is the
// reference's Gustavson SpGEMM (a dense accumulator over B's sparse rows),
// a panel at a time.
//
// What bounds it on the card: C's write, n_rows x w x 4 B (1.07 GB a panel
// of the SCALE-17 graph, 0.32 ms at 3.35 TB/s), which no form avoids; then
// the shared-memory adds, one a product (~54M a panel there), and the
// latency of the loads that feed them (A's arrays once, the table, B's
// entries of the panel, ~0.5 MB, from L2).  On that panel the writes alone
// take 0.34 ms and the adds alone 0.30 (NVIDIA H100 80GB HBM3, 700 W), and
// the two overlap little: 0.53 ms a panel.  The design:
//   - a block owns R rows of C and a chunk of up to 8,192 of the panel's
//     columns: an R x chunk accumulator in shared memory (32 KiB; R = 4 at
//     w = 2,048, up to 32 for narrow panels), zeroed, summed into, then
//     written to C once by streaming stores (float4 where w % 4 == 0 and C
//     is 16-byte aligned).  A panel wider than 8,192 columns is cut into
//     chunks, each block cutting its rows' B segments to its chunk by a
//     binary search;
//   - hub rows: the block takes its rows' entries of A 256 at a time, one
//     a thread (its row, its value, B's segment from the table), scans the
//     segments' lengths, and then every thread takes every 256th product of
//     the batch, finding its entry by a binary search of the scan.  So the
//     8 warps share a batch's products equally, however they fall on the
//     entries: a row of 15,642 entries whose products are ~14 times theirs
//     holds no warp while the others idle.  Blocks start heaviest first
//     (the order ops/denseacc gives, by products), so a hub row's block
//     does not start last and hold the launch alone;
//   - exactness: the accumulator is unsigned, each product an integer
//     atomicAdd (native in shared memory; a float atomicAdd there is a
//     compare-and-swap loop, 11 % slower on the panels of the SCALE-17
//     graph).  Every sum below 2^24 is exact at any order, since the
//     partial sums of non-negative integers stay below the final one.  A
//     block where an add reaches 2^24 (the count kernel's exactness limit,
//     csr.F32_EXACT_LIMIT) sums again in f32, so its panel holds what the
//     dense form's would and the count kernel's check trips as it does;
//   - the f32 semiring keeps the dense form: its values are not integers,
//     and adds in no fixed order would give another float in each run,
//     where the dense form's fixed order gives one;
//   - no host synchronisation and no allocation: the caller allocates C.

#include <cuda_runtime.h>
#include <algorithm>
#include <cstdint>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxRows = 32;        // rows of C a block owns
constexpr int kBlockFloats = 8192;  // the block's accumulator: 32 KiB of shared memory
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kExact = 1u << 24;  // 2^24, csr.F32_EXACT_LIMIT

// A batch of the block's entries of A, one a thread: the first product of
// each in the batch (an exclusive scan), B's slot of its first product less
// that, its row's offset in the accumulator, its value; and each warp's
// products.
struct Batch {
    int32_t first[kThreads], slot[kThreads], row[kThreads];
    float val[kThreads];
    int32_t warp_total[kWarps];
};

// One product into a cell of the accumulator.  unsigned: the integer sum,
// with a product at or above 2^24 counted as 2^24; true while the cell
// stays below 2^24, where it is exact.  float: the carrier's sum; true.
__device__ __forceinline__ bool add(unsigned* cell, float v) {
    const unsigned u = v < static_cast<float>(kExact) ? static_cast<unsigned>(v) : kExact;
    return static_cast<uint64_t>(atomicAdd(cell, u)) + u < kExact;
}
__device__ __forceinline__ bool add(float* cell, float v) {
    atomicAdd(cell, v);
    return true;
}

__device__ __forceinline__ float to_f32(unsigned u) { return __uint2float_rn(u); }
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float4 to_f32x4(const unsigned* x) {
    const uint4 q = *reinterpret_cast<const uint4*>(x);
    return make_float4(to_f32(q.x), to_f32(q.y), to_f32(q.z), to_f32(q.w));
}
__device__ __forceinline__ float4 to_f32x4(const float* x) {
    return *reinterpret_cast<const float4*>(x);
}

// The first of slots [lo, hi) of a row of B whose column is at least x.
__device__ __forceinline__ int lower_bound(const int32_t* __restrict__ b_col, int lo, int hi,
                                           int64_t x) {
    while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (b_col[mid] < x) lo = mid + 1;
        else hi = mid;
    }
    return lo;
}

// The block's entries of A into acc (rows of `chunk` cells), kThreads
// entries at a time (the last row in the block starting at or before
// each, and B's segment of it from the table, cut to the block's columns
// where the panel is cut into chunks), then the batch's
// products kThreads at a time, each thread finding its product's entry by
// a binary search of the scan: every warp takes an equal share of the
// products, however they fall on the entries.  Returns false where an add
// of this thread was not exact (unsigned only).
template <typename T>
__device__ __forceinline__ bool accumulate(
        T* acc, Batch& batch, const int32_t* s_ptr, int rows,
        const int32_t* __restrict__ col_idx, const float* __restrict__ vals,
        const int32_t* __restrict__ offsets, int64_t stride, const int32_t* __restrict__ b_col,
        const float* __restrict__ b_val, int64_t col0, int width, int chunk, bool cut) {
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    bool exact = true;
    for (int base = s_ptr[0]; base < s_ptr[rows]; base += kThreads) {
        const int e = base + threadIdx.x;
        int r = 0, sb = 0, len = 0;
        float a = 0.f;
        if (e < s_ptr[rows]) {
            const int64_t k = __ldcs(col_idx + e);
            a = __ldcs(vals + e);
            sb = offsets[k * stride];
            int se = offsets[k * stride + 1];
            if (cut) {
                sb = lower_bound(b_col, sb, se, col0);
                se = lower_bound(b_col, sb, se, col0 + width);
            }
            len = se - sb;
#pragma unroll
            for (int step = kMaxRows / 2; step > 0; step >>= 1)
                if (r + step < rows && s_ptr[r + step] <= e) r += step;
        }
        int first = len;  // the warp's inclusive scan, then the block's exclusive one
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
            const int x = __shfl_up_sync(kFull, first, d);
            if (lane >= d) first += x;
        }
        if (lane == 31) batch.warp_total[warp] = first;
        __syncthreads();
        int total = 0;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) {
            if (w == warp) first += total - len;
            total += batch.warp_total[w];
        }
        batch.first[threadIdx.x] = first;
        batch.slot[threadIdx.x] = sb - first;
        batch.row[threadIdx.x] = r * chunk;
        batch.val[threadIdx.x] = a;
        __syncthreads();
        for (int t = threadIdx.x; t < total; t += kThreads) {
            int u = 0;  // the entry of product t: the last whose first <= t
#pragma unroll
            for (int step = kThreads / 2; step > 0; step >>= 1)
                if (batch.first[u + step] <= t) u += step;
            const int slot = batch.slot[u] + t;
            exact &= add(acc + batch.row[u] + static_cast<int>(b_col[slot] - col0),
                         batch.val[u] * b_val[slot]);
        }
        __syncthreads();  // the batch is read before the next one is staged
    }
    return exact;
}

// The block's rows of the accumulator to C once, streaming past the L2.
template <typename T>
__device__ __forceinline__ void write_rows(float* __restrict__ c0, const T* acc, int rows,
                                           int width, int chunk, int64_t w, bool vec) {
    if (vec) {
        const int q = width / 4;
        for (int t = threadIdx.x; t < rows * q; t += kThreads) {
            const int rr = t / q, jj = (t - rr * q) * 4;
            __stcs(reinterpret_cast<float4*>(c0 + rr * w + jj), to_f32x4(acc + rr * chunk + jj));
        }
    } else {
        for (int t = threadIdx.x; t < rows * width; t += kThreads) {
            const int rr = t / width, jj = t - rr * width;
            __stcs(c0 + rr * w + jj, to_f32(acc[rr * chunk + jj]));
        }
    }
}

__device__ __forceinline__ void zero(float* acc, int n) {
    for (int t = threadIdx.x; t < n / 4; t += kThreads)
        reinterpret_cast<float4*>(acc)[t] = make_float4(0.f, 0.f, 0.f, 0.f);
}

__global__ void __launch_bounds__(kThreads)
spmm_dense_acc_kernel_csr_panel(const int32_t* __restrict__ row_ptr,
                                const int32_t* __restrict__ col_idx,
                                const float* __restrict__ vals,
                                const int32_t* __restrict__ b_col,
                                const float* __restrict__ b_val,
                                const int32_t* __restrict__ offsets,  // table column p
                                int64_t stride, const int32_t* __restrict__ order,
                                float* __restrict__ c, int64_t n_rows, int64_t lo, int64_t w,
                                int rows_per_block, int chunk, int64_t chunks, int64_t n_blocks,
                                bool vec) {
    extern __shared__ __align__(16) float acc[];  // rows_per_block x chunk
    __shared__ int32_t s_ptr[kMaxRows + 1];
    __shared__ Batch batch;

    for (int64_t b = blockIdx.x; b < n_blocks; b += gridDim.x) {
        const int64_t rb = order[b / chunks];
        const int64_t j0 = (b % chunks) * chunk;  // the chunk's first column in the panel
        const int width = static_cast<int>(min(static_cast<int64_t>(chunk), w - j0));
        const int64_t row0 = rb * rows_per_block;
        const int rows = static_cast<int>(min(static_cast<int64_t>(rows_per_block), n_rows - row0));
        __syncthreads();  // the previous block's rows are written out
        for (int t = threadIdx.x; t <= rows; t += kThreads) s_ptr[t] = row_ptr[row0 + t];
        zero(acc, rows * chunk);
        __syncthreads();

        const int64_t col0 = lo + j0;  // the chunk's first column of C
        float* const c0 = c + row0 * w + j0;
        unsigned* const sums = reinterpret_cast<unsigned*>(acc);
        const bool exact = accumulate(sums, batch, s_ptr, rows, col_idx, vals, offsets, stride,
                                      b_col, b_val, col0, width, chunk, chunks > 1);
        if (!__syncthreads_or(!exact)) {
            write_rows(c0, sums, rows, width, chunk, w, vec);
            continue;
        }
        // a cell reached 2^24: the block again in the f32 carrier, so that
        // the panel holds what the dense form's would and the count
        // kernel's check trips
        zero(acc, rows * chunk);
        __syncthreads();
        accumulate(acc, batch, s_ptr, rows, col_idx, vals, offsets, stride, b_col, b_val, col0,
                   width, chunk, chunks > 1);
        __syncthreads();
        write_rows(c0, acc, rows, width, chunk, w, vec);
    }
}

}  // namespace

extern "C" {

// Launches one C panel, columns [lo, lo + w), on `stream` and returns
// cudaGetLastError() (0 = launched), or cudaErrorInvalidValue for a shape
// it does not take (n_rows < 1, n_rows >= 2^31, w < 1, p outside the
// table, rows_per_block outside [1, 32] or its accumulator past 8,192
// floats).  row_ptr: int32[n_rows + 1]; col_idx: int32 and vals: f32 at A's
// entries; b_col: int32 and b_val: f32 at B's slots; offsets: int32[k *
// stride], B's table, p + 1 < stride; order: int32[ceil(n_rows /
// rows_per_block)], the row blocks in the order they start (a permutation);
// c: f32[n_rows * w].  The caller checks types, devices, contiguity and
// the order.
int spmm_dense_acc_csr_panel_f32(const void* row_ptr, const void* col_idx, const void* vals,
                                 const void* b_col, const void* b_val, const void* offsets,
                                 int64_t stride, int64_t p, const void* order,
                                 int64_t rows_per_block, void* c, int64_t n_rows, int64_t lo,
                                 int64_t w, void* stream) {
    const int64_t chunk = std::min<int64_t>((w + 3) / 4 * 4, kBlockFloats);
    if (n_rows < 1 || n_rows >= 0x80000000LL || w < 1 || p < 0 || p + 1 >= stride ||
        rows_per_block < 1 || rows_per_block > kMaxRows || rows_per_block * chunk > kBlockFloats)
        return static_cast<int>(cudaErrorInvalidValue);
    const int64_t chunks = (w + chunk - 1) / chunk;
    const int64_t n_blocks = (n_rows + rows_per_block - 1) / rows_per_block * chunks;
    const auto grid = static_cast<unsigned>(n_blocks < INT32_MAX ? n_blocks : INT32_MAX);
    const bool vec = w % 4 == 0 && (reinterpret_cast<uintptr_t>(c) & 15u) == 0;
    const size_t smem = static_cast<size_t>(rows_per_block * chunk) * sizeof(float);
    spmm_dense_acc_kernel_csr_panel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(row_ptr), static_cast<const int32_t*>(col_idx),
        static_cast<const float*>(vals), static_cast<const int32_t*>(b_col),
        static_cast<const float*>(b_val), static_cast<const int32_t*>(offsets) + p, stride,
        static_cast<const int32_t*>(order), static_cast<float*>(c), n_rows, lo, w,
        static_cast<int>(rows_per_block), static_cast<int>(chunk), chunks, n_blocks, vec);
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
