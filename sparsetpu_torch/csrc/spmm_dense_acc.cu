// Dense-accumulator SpMM for Hopper: C = A x P, A sparse CSR, P and C dense.
//
// Replaces the TPU kernel sparsetpu/kernels/spmm_pallas.py::_spmm_kernel
// (called through spmm_pallas).  It computes
//
//     C[i, :] = sum over entries e of row i of A:  val[e] * P[col[e], :]
//
// with A as int32 row_ptr[n_rows + 1], int32 col[nnz], f32 val[nnz], and P
// (n_p, m) and C (n_rows, m) dense row-major f32.  Integer values carried in
// f32 are exact while every value stays below 2^24; the callers guard that.
// There is no matrix product here, so TF32 cannot enter; its plain version
// (kernels/spmm.py) must not be replaced by a dense TF32 product either.
//
// What bounds it on the card.  Every entry of A reads m floats of one P
// row, so a call gathers nnz(A) * m * 4 B: 8.74 GB for a step of the
// thinned 30^3 torus chain (3 entries a row), 93.3 GB for the ER 27,000 x 32
// operand times its dense self (32 a row), against compulsory bytes (A,
// each P row and C once) of 5.8 GB.  The gathers come at the L2's rate only
// if the P rows they re-read are still there, and the rows of a random
// graph reference P rows all over: a whole P (2.9 GB at n = 27,000) never
// fits.  So the design cuts the columns into panels:
//   - a launch works on panels of W columns, W a power of two from 128 to
//     1,024 (whole 512-byte warp lines), the widest with n x W x 4 B within
//     3/5 of the device's L2 (cudaDevAttrL2CacheSize), and no wider than m
//     needs.  P's row count is not passed in, so A's row count n_rows stands
//     for it: every caller's A is square, and a row slice of A only takes a
//     wider panel than its P would fit.  At n = 27,000 W = 256 (27.6 MB):
//     W = 128 keeps more of a random graph's re-reads in L2, but its 512-byte
//     bursts cost the torus, whose re-reads are local, more device-memory
//     time than the L2 saves (PERF.md);
//   - blocks go panel-major (a 1-D grid, panel = block / row blocks), so all
//     rows of one panel run before the next and re-read that panel's P
//     columns from L2: P comes from device memory about once.  Blocks are
//     small (32 rows), so the blocks in flight span under one panel;
//   - a block's 8 warps split its rows' entries into 8 equal runs, in CSR
//     order; a warp stages 32 (col, val) entries with one coalesced load,
//     hands them out by __shfl_sync, and keeps 8 P floats a lane in flight
//     (float4 loads where m % 4 == 0 and P and C are 16-byte aligned, else
//     scalar loads with the ragged columns masked), running ahead across
//     row boundaries: rows of 3 entries keep as many loads in flight as
//     rows of 700, and a long row is shared by every warp whose run it
//     covers instead of holding one warp while the others idle;
//   - each output element is summed in a fixed order, with no atomics on
//     floats: in CSR order within a warp's run, then, for a row that spans
//     runs, the runs' partial rows (met in shared memory) in warp order.
//     The result is the same in every run, and exact on integer values
//     below 2^24, where every order is exact;
//   - C is written once, by streaming stores (no memset), and A's arrays are
//     read by streaming loads, leaving L2 to P; addresses are int64
//     (col * m + j overflows int32 once n > 46,340).
// The TPU kernel's DMA ring over P rows (spmm_pallas.py:128-158) was its
// answer to the same latency; here the loads in flight across the warps are.
// Its padded branch-free entries and row-plane layout are TPU artifacts and
// are not carried over.  Nothing here changes a stream attribute or device
// state: panel order alone keeps the panel in L2.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerBlock = 32;
constexpr int kMinPanel = 128;     // columns: one float4 a lane of a warp
constexpr int kMaxPanel = 1024;
constexpr int kInFlight = 8;       // P floats a lane has in flight
constexpr unsigned kFull = 0xffffffffu;

// A lane's unit of P: a float4 (4 columns) or a float (1 column).
__device__ __forceinline__ void zero(float4& x) { x = make_float4(0.f, 0.f, 0.f, 0.f); }
__device__ __forceinline__ void zero(float& x) { x = 0.f; }
__device__ __forceinline__ void load(float4& x, const float* ptr) {
    x = __ldg(reinterpret_cast<const float4*>(ptr));
}
__device__ __forceinline__ void load(float& x, const float* ptr) { x = __ldg(ptr); }
__device__ __forceinline__ void fma_into(float4& acc, float v, const float4& x) {
    acc.x = fmaf(v, x.x, acc.x);
    acc.y = fmaf(v, x.y, acc.y);
    acc.z = fmaf(v, x.z, acc.z);
    acc.w = fmaf(v, x.w, acc.w);
}
__device__ __forceinline__ void fma_into(float& acc, float v, float x) { acc = fmaf(v, x, acc); }
__device__ __forceinline__ void store(float* ptr, const float4& x) {
    __stcs(reinterpret_cast<float4*>(ptr), x);
}
__device__ __forceinline__ void store(float* ptr, float x) { __stcs(ptr, x); }
__device__ __forceinline__ void store_shared(float* ptr, const float4& x) {
    *reinterpret_cast<float4*>(ptr) = x;
}
__device__ __forceinline__ void store_shared(float* ptr, float x) { *ptr = x; }
__device__ __forceinline__ void load_shared(float4& x, const float* ptr) {
    x = *reinterpret_cast<const float4*>(ptr);
}
__device__ __forceinline__ void load_shared(float& x, const float* ptr) { x = *ptr; }
__device__ __forceinline__ void add_into(float4& acc, const float4& x) {
    acc.x += x.x;
    acc.y += x.y;
    acc.z += x.z;
    acc.w += x.w;
}
__device__ __forceinline__ void add_into(float& acc, float x) { acc += x; }

// Stores a lane's slots of one row of one panel into C's row `out`.
template <typename T, int kSlots>
__device__ __forceinline__ void store_row(float* out, const T (&acc)[kSlots], int64_t col0,
                                          int64_t m) {
    constexpr int kWidth = sizeof(T) / sizeof(float);
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
        const int64_t j = col0 + s * 32 * kWidth;
        if (j < m) store(out + j, acc[s]);
    }
}

// One launch over row blocks x panels of kSlots * 32 * width columns,
// panel-major.  T = float4 needs m % 4 == 0 and 16-byte aligned P and C.
template <typename T, int kSlots>
__global__ void __launch_bounds__(kThreads)
spmm_dense_acc_kernel(const int32_t* __restrict__ row_ptr,
                      const int32_t* __restrict__ col_idx,
                      const float* __restrict__ vals,
                      const float* __restrict__ p,
                      float* __restrict__ c, int64_t n_rows, int64_t m,
                      int64_t row_blocks, int64_t n_blocks) {
    constexpr int kWidth = sizeof(T) / sizeof(float);
    constexpr int kPanel = kSlots * 32 * kWidth;
    constexpr int kUnroll = kInFlight / (kSlots * kWidth) > 0 ? kInFlight / (kSlots * kWidth) : 1;
    __shared__ int32_t s_ptr[kRowsPerBlock + 1];
    __shared__ int s_cont[kWarps];  // the row whose partial warp w left in s_part[w], or -1
    __shared__ __align__(16) float s_part[kWarps][kPanel];
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;

    for (int64_t b = blockIdx.x; b < n_blocks; b += gridDim.x) {
        const int64_t panel = b / row_blocks;
        const int64_t row0 = (b - panel * row_blocks) * kRowsPerBlock;
        const int rows = static_cast<int>(min(static_cast<int64_t>(kRowsPerBlock), n_rows - row0));
        // this lane's first column; its slot s starts s * 32 * kWidth later
        // (with float4, m % 4 == 0 keeps a slot's four columns inside m)
        const int64_t col0 = panel * kPanel + lane * kWidth;
        float* const c_rows = c + row0 * m;
        __syncthreads();  // the previous row block is done with shared memory
        for (int t = threadIdx.x; t <= rows; t += kThreads) s_ptr[t] = __ldcs(row_ptr + row0 + t);
        if (lane == 0) s_cont[warp] = -1;
        __syncthreads();

        T acc[kSlots];
#pragma unroll
        for (int s = 0; s < kSlots; ++s) zero(acc[s]);
        for (int r = warp; r < rows; r += kWarps)  // empty rows: zeros
            if (s_ptr[r + 1] == s_ptr[r]) store_row(c_rows + r * m, acc, col0, m);

        // warp w walks the w-th of 8 equal runs of the block's entries in
        // CSR order; loads run ahead across row boundaries
        const int e_all = s_ptr[rows];
        const int run = (e_all - s_ptr[0] + kWarps - 1) / kWarps;
        const int lo = min(s_ptr[0] + warp * run, e_all);
        const int hi = min(lo + run, e_all);
        // the block row of entry e: the last r < rows with s_ptr[r] <= e
        const auto row_of = [&](int e) {
            int r = 0;
#pragma unroll
            for (int step = kRowsPerBlock / 2; step > 0; step >>= 1)
                if (r + step < rows && s_ptr[r + step] <= e) r += step;
            return r;
        };
        int cur = lo < hi ? row_of(lo) : 0;  // the row acc sums
        bool cont = s_ptr[cur] < lo;         // it began in an earlier warp's run
        int next = s_ptr[cur + 1];           // the entry that ends it
        // a finished row goes to C, or, begun in an earlier warp, to s_part
        auto finish = [&](int r, bool partial) {
            if (partial) {
#pragma unroll
                for (int s = 0; s < kSlots; ++s)
                    store_shared(&s_part[warp][(s * 32 + lane) * kWidth], acc[s]);
                if (lane == 0) s_cont[warp] = r;
            } else {
                store_row(c_rows + r * m, acc, col0, m);
            }
        };
        for (int base = lo; base < hi; base += 32) {
            const int cnt = min(32, hi - base);
            int my_col = 0;
            float my_val = 0.f;
            if (lane < cnt) {
                my_col = __ldcs(col_idx + base + lane);
                my_val = __ldcs(vals + base + lane);
            }
            for (int k = 0; k < cnt; k += kUnroll) {
                T x[kUnroll][kSlots];
                float v[kUnroll];
#pragma unroll
                for (int u = 0; u < kUnroll; ++u) {
                    const int src = (k + u) & 31;
                    const float* row = p + static_cast<int64_t>(__shfl_sync(kFull, my_col, src)) * m;
                    v[u] = __shfl_sync(kFull, my_val, src);
#pragma unroll
                    for (int s = 0; s < kSlots; ++s) {
                        const int64_t j = col0 + s * 32 * kWidth;
                        if (k + u < cnt && j < m) load(x[u][s], row + j);
                        else zero(x[u][s]);
                    }
                }
#pragma unroll
                for (int u = 0; u < kUnroll; ++u) {
                    if (k + u < cnt) {
                        if (base + k + u == next) {  // a new row: skip the empty ones
                            finish(cur, cont);
                            do ++cur; while (s_ptr[cur + 1] == next);
                            next = s_ptr[cur + 1];
                            cont = false;
#pragma unroll
                            for (int s = 0; s < kSlots; ++s) zero(acc[s]);
                        }
#pragma unroll
                        for (int s = 0; s < kSlots; ++s) fma_into(acc[s], v[u], x[u][s]);
                    }
                }
            }
        }
        // the run's last row: finished here, or continued by later warps,
        // whose partials its first warp adds in warp order
        const bool open = lo < hi && next > hi;
        if (lo < hi && (cont || !open)) finish(cur, cont);
        __syncthreads();
        if (open && !cont) {
            for (int w = warp + 1; w < kWarps && s_cont[w] == cur; ++w) {
#pragma unroll
                for (int s = 0; s < kSlots; ++s) {
                    T part;
                    load_shared(part, &s_part[w][(s * 32 + lane) * kWidth]);
                    add_into(acc[s], part);
                }
            }
            store_row(c_rows + cur * m, acc, col0, m);
        }
    }
}

bool aligned16(const void* ptr) {
    return (reinterpret_cast<uintptr_t>(ptr) & 15u) == 0;
}

template <typename T, int kSlots>
cudaError_t launch(const int32_t* rp, const int32_t* ci, const float* vv, const float* pp,
                   float* cc, int64_t n_rows, int64_t m, cudaStream_t s) {
    constexpr int64_t kPanel = kSlots * 32 * (sizeof(T) / sizeof(float));
    const int64_t row_blocks = (n_rows + kRowsPerBlock - 1) / kRowsPerBlock;
    const int64_t n_blocks = row_blocks * ((m + kPanel - 1) / kPanel);
    const auto grid = static_cast<unsigned>(n_blocks < INT32_MAX ? n_blocks : INT32_MAX);
    spmm_dense_acc_kernel<T, kSlots><<<grid, kThreads, 0, s>>>(rp, ci, vv, pp, cc, n_rows, m,
                                                               row_blocks, n_blocks);
    return cudaGetLastError();
}

}  // namespace

extern "C" {

// Largest m the wrapper passes (the launch itself takes any m: its grid
// strides over the blocks).
int64_t spmm_dense_acc_max_cols() {
    return static_cast<int64_t>(65535) * kMaxPanel;
}

// The panel width W of a launch with n_rows rows of A and m columns of P
// on the current device: the widest power of two from 128 to 1,024 with
// n_rows * W * 4 B within 3/5 of the L2, and no wider than m needs.
int64_t spmm_dense_acc_panel_cols(int64_t n_rows, int64_t m) {
    int dev = 0, l2 = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&l2, cudaDevAttrL2CacheSize, dev);
    int64_t w = kMaxPanel;
    while (w > kMinPanel && n_rows * w * 4 > static_cast<int64_t>(l2) * 3 / 5) w /= 2;
    while (w > kMinPanel && w / 2 >= m) w /= 2;
    return w;
}

// Launches C = A x P on `stream` and returns cudaGetLastError() (0 = launched).
// The caller checks shapes, types and m <= spmm_dense_acc_max_cols().
int spmm_dense_acc_f32(const void* row_ptr, const void* col_idx,
                       const void* vals, const void* p, void* c,
                       int64_t n_rows, int64_t m, void* stream) {
    if (n_rows <= 0 || m <= 0) return static_cast<int>(cudaGetLastError());
    const auto s = static_cast<cudaStream_t>(stream);
    const auto* rp = static_cast<const int32_t*>(row_ptr);
    const auto* ci = static_cast<const int32_t*>(col_idx);
    const auto* vv = static_cast<const float*>(vals);
    const auto* pp = static_cast<const float*>(p);
    auto* cc = static_cast<float*>(c);
    const int64_t w = spmm_dense_acc_panel_cols(n_rows, m);
    cudaError_t err;
    if (m % 4 == 0 && aligned16(p) && aligned16(c)) {
        switch (w) {
            case 128: err = launch<float4, 1>(rp, ci, vv, pp, cc, n_rows, m, s); break;
            case 256: err = launch<float4, 2>(rp, ci, vv, pp, cc, n_rows, m, s); break;
            case 512: err = launch<float4, 4>(rp, ci, vv, pp, cc, n_rows, m, s); break;
            default: err = launch<float4, 8>(rp, ci, vv, pp, cc, n_rows, m, s); break;
        }
    } else {
        switch (w) {
            case 128: err = launch<float, 4>(rp, ci, vv, pp, cc, n_rows, m, s); break;
            case 256: err = launch<float, 8>(rp, ci, vv, pp, cc, n_rows, m, s); break;
            case 512: err = launch<float, 16>(rp, ci, vv, pp, cc, n_rows, m, s); break;
            default: err = launch<float, 32>(rp, ci, vv, pp, cc, n_rows, m, s); break;
        }
    }
    return static_cast<int>(err);
}

const char* spmm_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
