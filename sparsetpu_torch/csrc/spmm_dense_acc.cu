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
// What bounds it on the card: device-memory bytes.  Every P row is read once
// for each entry that references it and C is written once, so a step of the
// thinned 30^3 torus chain moves nnz(A) * m * 4 B = 80,882 * 27,000 * 4 B
// (8.74 GB) of P-row reads and n * m * 4 B (2.92 GB) of C writes, against a
// handful of FLOPs per byte.  The design keeps to that minimum and leaves the
// rest to the 50 MB L2, which catches re-reads of the rows that neighbouring
// output rows share:
//   - one block per (output row, 1024-column chunk): rows on gridDim.x (no
//     65,535 cap there), chunks on gridDim.y;
//   - each thread owns 4 consecutive columns and keeps their sums in
//     registers, as one float4 where m % 4 == 0 and the pointers are 16-byte
//     aligned, else as 4 masked scalars;
//   - the thread walks the row's entries, reading col/val (the same address
//     across the block) and then its 16 bytes of the P row (coalesced across
//     the warp), and writes its part of C exactly once;
//   - addresses are computed in int64: col * m + j overflows int32 once
//     n > 46,340.
// The TPU kernel's DMA ring, padded branch-free entries and row-plane layout
// are TPU artifacts and are not carried over.  Staging P rows through
// cp.async/TMA is left to later tuning.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kColsPerThread = 4;
constexpr int kColsPerBlock = kThreads * kColsPerThread;

template <bool kVec4>
__global__ void __launch_bounds__(kThreads)
spmm_dense_acc_kernel(const int32_t* __restrict__ row_ptr,
                      const int32_t* __restrict__ col_idx,
                      const float* __restrict__ vals,
                      const float* __restrict__ p,
                      float* __restrict__ c, int64_t m) {
    const int64_t row = blockIdx.x;
    const int64_t j =
        (static_cast<int64_t>(blockIdx.y) * kThreads + threadIdx.x) * kColsPerThread;
    if (j >= m) return;
    const int32_t e0 = row_ptr[row];
    const int32_t e1 = row_ptr[row + 1];
    float* out = c + row * m + j;
    if (kVec4) {
        // m % 4 == 0, so j < m implies all four columns are in range
        float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
        for (int32_t e = e0; e < e1; ++e) {
            const float v = vals[e];
            const float4 x = __ldg(reinterpret_cast<const float4*>(
                p + static_cast<int64_t>(col_idx[e]) * m + j));
            acc.x = fmaf(v, x.x, acc.x);
            acc.y = fmaf(v, x.y, acc.y);
            acc.z = fmaf(v, x.z, acc.z);
            acc.w = fmaf(v, x.w, acc.w);
        }
        *reinterpret_cast<float4*>(out) = acc;
    } else {
        const int w = m - j < kColsPerThread ? static_cast<int>(m - j) : kColsPerThread;
        float acc[kColsPerThread] = {0.f, 0.f, 0.f, 0.f};
        for (int32_t e = e0; e < e1; ++e) {
            const float v = vals[e];
            const float* x = p + static_cast<int64_t>(col_idx[e]) * m + j;
#pragma unroll
            for (int q = 0; q < kColsPerThread; ++q)
                if (q < w) acc[q] = fmaf(v, __ldg(x + q), acc[q]);
        }
#pragma unroll
        for (int q = 0; q < kColsPerThread; ++q)
            if (q < w) out[q] = acc[q];
    }
}

bool aligned16(const void* ptr) {
    return (reinterpret_cast<uintptr_t>(ptr) & 15u) == 0;
}

}  // namespace

extern "C" {

// Largest m the launch takes: gridDim.y is capped at 65,535 chunks.
int64_t spmm_dense_acc_max_cols() {
    return static_cast<int64_t>(65535) * kColsPerBlock;
}

// Launches C = A x P on `stream` and returns cudaGetLastError() (0 = launched).
// The caller checks shapes, types and m <= spmm_dense_acc_max_cols().
int spmm_dense_acc_f32(const void* row_ptr, const void* col_idx,
                       const void* vals, const void* p, void* c,
                       int64_t n_rows, int64_t m, void* stream) {
    const dim3 grid(static_cast<unsigned>(n_rows),
                    static_cast<unsigned>((m + kColsPerBlock - 1) / kColsPerBlock));
    const auto s = static_cast<cudaStream_t>(stream);
    const auto* rp = static_cast<const int32_t*>(row_ptr);
    const auto* ci = static_cast<const int32_t*>(col_idx);
    const auto* vv = static_cast<const float*>(vals);
    const auto* pp = static_cast<const float*>(p);
    auto* cc = static_cast<float*>(c);
    if (m % kColsPerThread == 0 && aligned16(p) && aligned16(c))
        spmm_dense_acc_kernel<true><<<grid, kThreads, 0, s>>>(rp, ci, vv, pp, cc, m);
    else
        spmm_dense_acc_kernel<false><<<grid, kThreads, 0, s>>>(rp, ci, vv, pp, cc, m);
    return static_cast<int>(cudaGetLastError());
}

const char* spmm_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
