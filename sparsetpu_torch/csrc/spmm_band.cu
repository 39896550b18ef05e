// Fold-band SpMM for Hopper: C_band = A x P_band, A sparse CSR, P and C band
// matrices stored as per-row column windows.
//
// Replaces the TPU kernel sparsetpu/kernels/bandplanes.py::_band_kernel
// (called through spmm_band).  A band matrix is a row-major (rows, w) f32
// array plus an int32 base[rows]: element (r, j) is column base[r] + j.  For
// every output row i and window column j it computes
//
//     C[i, j] = sum over entries e of row i of A, c = col[e]:
//               val[e] * P[c, j - dp]   where 0 <= j - dp < w_in,
//     dp = base_in[c] - base_out[i]
//
// i.e. the gather form of the TPU kernel's shifted FMA: the TPU adds the
// whole input window at offset dp and so needs output windows widened by the
// worst dp; here the out-of-range source columns are masked, so each output
// window need only cover its row's true support (the callers check that the
// masked columns are zeros of the source row).  Integers carried in f32 are
// exact below 2^24; there is no matrix product here, so TF32 cannot enter.
//
// What bounds it on the card: device-memory bytes, as for the full-width
// kernel (spmm_dense_acc.cu), but each entry reads at most w_in floats of its
// source row and C is w_out wide: on the thinned 30^3 torus the windows run
// from 3,808 to 26,144 of 27,008 columns across A^2..A^7.  The design:
//   - one block per (output row, 1024-column chunk of its window): rows on
//     gridDim.x (no 65,535 cap there), chunks on gridDim.y;
//   - each thread owns 4 consecutive window columns and keeps their sums in
//     registers; where every window start is a multiple of 4 and w_in, w_out
//     are too, j - dp is a multiple of 4 and the four columns are in or out
//     of the source window together: one masked float4 load per entry;
//     otherwise 4 masked scalars;
//   - the thread walks the row's entries (col, val and base_in[col] are the
//     same address across the block) and writes its part of C once;
//   - addresses are computed in int64.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kColsPerThread = 4;
constexpr int kColsPerBlock = kThreads * kColsPerThread;

template <bool kVec4>
__global__ void __launch_bounds__(kThreads)
spmm_band_kernel(const int32_t* __restrict__ row_ptr,
                 const int32_t* __restrict__ col_idx,
                 const float* __restrict__ vals,
                 const int32_t* __restrict__ base_in,
                 const int32_t* __restrict__ base_out,
                 const float* __restrict__ p,
                 float* __restrict__ c, int64_t w_in, int64_t w_out) {
    const int64_t row = blockIdx.x;
    const int64_t j =
        (static_cast<int64_t>(blockIdx.y) * kThreads + threadIdx.x) * kColsPerThread;
    if (j >= w_out) return;
    const int32_t e0 = row_ptr[row];
    const int32_t e1 = row_ptr[row + 1];
    const int64_t bo = base_out[row];
    float* out = c + row * w_out + j;
    if (kVec4) {
        float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
        for (int32_t e = e0; e < e1; ++e) {
            const int64_t col = col_idx[e];
            const int64_t s = j - (base_in[col] - bo);  // source window column
            if (s < 0 || s >= w_in) continue;
            const float v = vals[e];
            const float4 x = __ldg(reinterpret_cast<const float4*>(p + col * w_in + s));
            acc.x = fmaf(v, x.x, acc.x);
            acc.y = fmaf(v, x.y, acc.y);
            acc.z = fmaf(v, x.z, acc.z);
            acc.w = fmaf(v, x.w, acc.w);
        }
        *reinterpret_cast<float4*>(out) = acc;
    } else {
        const int w = w_out - j < kColsPerThread ? static_cast<int>(w_out - j)
                                                 : kColsPerThread;
        float acc[kColsPerThread] = {0.f, 0.f, 0.f, 0.f};
        for (int32_t e = e0; e < e1; ++e) {
            const int64_t col = col_idx[e];
            const int64_t s = j - (base_in[col] - bo);
            if (s + kColsPerThread <= 0 || s >= w_in) continue;
            const float v = vals[e];
            const float* x = p + col * w_in;
#pragma unroll
            for (int q = 0; q < kColsPerThread; ++q)
                if (q < w && s + q >= 0 && s + q < w_in)
                    acc[q] = fmaf(v, __ldg(x + s + q), acc[q]);
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

// Largest w_out the launch takes: gridDim.y is capped at 65,535 chunks.
int64_t spmm_band_max_cols() {
    return static_cast<int64_t>(65535) * kColsPerBlock;
}

// Launches C_band = A x P_band on `stream` and returns cudaGetLastError()
// (0 = launched).  `bases_aligned4` says every base_in and base_out value is a
// multiple of 4.  The caller checks shapes, types and w_out <=
// spmm_band_max_cols().
int spmm_band_f32(const void* row_ptr, const void* col_idx, const void* vals,
                  const void* base_in, const void* base_out, const void* p,
                  void* c, int64_t n_rows, int64_t w_in, int64_t w_out,
                  int bases_aligned4, void* stream) {
    const dim3 grid(static_cast<unsigned>(n_rows),
                    static_cast<unsigned>((w_out + kColsPerBlock - 1) / kColsPerBlock));
    const auto s = static_cast<cudaStream_t>(stream);
    const auto* rp = static_cast<const int32_t*>(row_ptr);
    const auto* ci = static_cast<const int32_t*>(col_idx);
    const auto* vv = static_cast<const float*>(vals);
    const auto* bi = static_cast<const int32_t*>(base_in);
    const auto* bo = static_cast<const int32_t*>(base_out);
    const auto* pp = static_cast<const float*>(p);
    auto* cc = static_cast<float*>(c);
    if (bases_aligned4 && w_in % kColsPerThread == 0 && w_out % kColsPerThread == 0
        && aligned16(p) && aligned16(c))
        spmm_band_kernel<true><<<grid, kThreads, 0, s>>>(rp, ci, vv, bi, bo, pp, cc,
                                                         w_in, w_out);
    else
        spmm_band_kernel<false><<<grid, kThreads, 0, s>>>(rp, ci, vv, bi, bo, pp, cc,
                                                          w_in, w_out);
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
