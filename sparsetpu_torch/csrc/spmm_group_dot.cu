// Group-dot SpMM for Hopper: C = A x P by one small dense contraction per
// group of G entries of A.
//
// Replaces the TPU kernel sparsetpu/kernels/spmm_pallas.py::_spmm_mxu_kernel
// (called through spmm_pallas_mxu).  A is cut into tiles of R output rows;
// each tile's entries form groups of G slots, group q holding the P rows
// cols[q*G .. q*G+G) and an (R, G) f32 matrix M_q (row-major, M_q[r, e] is the
// value of slot e if it lies in the tile's row r, else 0).  Tile t owns groups
// [group_ptr[t], group_ptr[t+1]) and computes
//
//     C[t*R + r, j] = sum over its groups q, slots e:  M_q[r, e] * P[cols[e], j]
//
// for r < R (rows past n_rows are not written), with P (n_p, m) and C
// (n_rows, m) dense row-major f32.  The TPU contracts each group on the MXU at
// HIGHEST precision; here every product is an fp32 FMA on the CUDA cores,
// never TF32, so A's values below 2^8 and P's below 2^24 (the callers guard
// both) stay exact.
//
// What bounds it on the card: fp32 FMAs.  A step of the thinned 30^3 chain at
// R = 40, G = 32 has 2,984 groups, 2,984 * 40 * 32 * 27,000 * 2 = 206 GFLOP
// (3.1 ms at the data sheet's 67 TFLOP/s), against 10.3 GB of padded P-row
// reads and 2.9 GB of C writes.  The design keeps the FMA loop fed from
// registers and shared memory:
//   - one block per (row tile, 512-column chunk): tiles on gridDim.x;
//   - per group, the block stages M_q transposed (G x R) and the G column
//     indices in shared memory, then each thread, owning 2 consecutive
//     columns, loads 2 floats of each of the G P rows (coalesced across the
//     warp) and does R x 2 FMAs against one float4 of M per 4 rows, keeping
//     all R x 2 sums in registers (R is a template parameter, 8..64);
//   - C is written once; addresses are computed in int64.
// Double-buffering the staging (the TPU kernel's two group slots) and a
// tensor-core form (exact only as u8/s8 limbs with s32 sums) are left to
// later tuning.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kColsPerThread = 2;
constexpr int kColsPerBlock = kThreads * kColsPerThread;

template <int kR, bool kVec2>
__global__ void __launch_bounds__(kThreads)
spmm_group_dot_kernel(const int32_t* __restrict__ group_ptr,
                      const int32_t* __restrict__ cols,
                      const float* __restrict__ m,
                      const float* __restrict__ p,
                      float* __restrict__ c, int64_t n_rows, int64_t m_cols,
                      int g) {
    extern __shared__ float4 smem[];
    float* mt = reinterpret_cast<float*>(smem);                   // [g][kR]
    int32_t* scol = reinterpret_cast<int32_t*>(mt + g * kR);      // [g]
    const int64_t tile = blockIdx.x;
    const int64_t j =
        (static_cast<int64_t>(blockIdx.y) * kThreads + threadIdx.x) * kColsPerThread;
    const bool active = j < m_cols;
    const bool second = j + 1 < m_cols;
    float acc[kR][kColsPerThread];
#pragma unroll
    for (int r = 0; r < kR; ++r) {
        acc[r][0] = 0.f;
        acc[r][1] = 0.f;
    }
    const int32_t q0 = group_ptr[tile];
    const int32_t q1 = group_ptr[tile + 1];
    for (int32_t q = q0; q < q1; ++q) {
        __syncthreads();  // the previous group's shared data is consumed
        const float* mq = m + static_cast<int64_t>(q) * kR * g;
        for (int idx = threadIdx.x; idx < kR * g; idx += kThreads) {
            const int r = idx / g;
            const int e = idx - r * g;
            mt[e * kR + r] = mq[idx];
        }
        for (int e = threadIdx.x; e < g; e += kThreads)
            scol[e] = cols[static_cast<int64_t>(q) * g + e];
        __syncthreads();
        if (!active) continue;  // still takes part in every barrier
        for (int e = 0; e < g; ++e) {
            const float* prow = p + static_cast<int64_t>(scol[e]) * m_cols + j;
            float b0, b1;
            if (kVec2) {
                const float2 x = __ldg(reinterpret_cast<const float2*>(prow));
                b0 = x.x;
                b1 = x.y;
            } else {
                b0 = __ldg(prow);
                b1 = second ? __ldg(prow + 1) : 0.f;
            }
            const float4* mrow = reinterpret_cast<const float4*>(mt + e * kR);
#pragma unroll
            for (int r4 = 0; r4 < kR / 4; ++r4) {
                const float4 mv = mrow[r4];
                acc[4 * r4 + 0][0] = fmaf(mv.x, b0, acc[4 * r4 + 0][0]);
                acc[4 * r4 + 0][1] = fmaf(mv.x, b1, acc[4 * r4 + 0][1]);
                acc[4 * r4 + 1][0] = fmaf(mv.y, b0, acc[4 * r4 + 1][0]);
                acc[4 * r4 + 1][1] = fmaf(mv.y, b1, acc[4 * r4 + 1][1]);
                acc[4 * r4 + 2][0] = fmaf(mv.z, b0, acc[4 * r4 + 2][0]);
                acc[4 * r4 + 2][1] = fmaf(mv.z, b1, acc[4 * r4 + 2][1]);
                acc[4 * r4 + 3][0] = fmaf(mv.w, b0, acc[4 * r4 + 3][0]);
                acc[4 * r4 + 3][1] = fmaf(mv.w, b1, acc[4 * r4 + 3][1]);
            }
        }
    }
    if (!active) return;
#pragma unroll
    for (int r = 0; r < kR; ++r) {
        const int64_t row = tile * kR + r;
        if (row >= n_rows) break;
        float* out = c + row * m_cols + j;
        if (kVec2) {
            *reinterpret_cast<float2*>(out) = make_float2(acc[r][0], acc[r][1]);
        } else {
            out[0] = acc[r][0];
            if (second) out[1] = acc[r][1];
        }
    }
}

bool aligned8(const void* ptr) {
    return (reinterpret_cast<uintptr_t>(ptr) & 7u) == 0;
}

template <int kR>
int launch(const int32_t* group_ptr, const int32_t* cols, const float* m,
           const float* p, float* c, int64_t n_tiles, int64_t n_rows,
           int64_t m_cols, int g, cudaStream_t s) {
    const dim3 grid(static_cast<unsigned>(n_tiles),
                    static_cast<unsigned>((m_cols + kColsPerBlock - 1) / kColsPerBlock));
    const size_t smem = static_cast<size_t>(g) * (kR * sizeof(float) + sizeof(int32_t));
    if (m_cols % kColsPerThread == 0 && aligned8(p) && aligned8(c))
        spmm_group_dot_kernel<kR, true><<<grid, kThreads, smem, s>>>(
            group_ptr, cols, m, p, c, n_rows, m_cols, g);
    else
        spmm_group_dot_kernel<kR, false><<<grid, kThreads, smem, s>>>(
            group_ptr, cols, m, p, c, n_rows, m_cols, g);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Largest m the launch takes: gridDim.y is capped at 65,535 chunks.
int64_t spmm_group_dot_max_cols() {
    return static_cast<int64_t>(65535) * kColsPerBlock;
}

// Launches C = A x P on `stream` and returns cudaGetLastError() (0 =
// launched), or cudaErrorInvalidValue for a tile height R other than
// 8, 16, ..., 64 or a g outside 1..128 (shared memory is g * (R + 1) words).
// The caller checks shapes, types and m <= spmm_group_dot_max_cols().
int spmm_group_dot_f32(const void* group_ptr, const void* cols, const void* m,
                       const void* p, void* c, int64_t n_tiles, int64_t n_rows,
                       int64_t m_cols, int rows_per_tile, int g, void* stream) {
    const auto* gp = static_cast<const int32_t*>(group_ptr);
    const auto* cl = static_cast<const int32_t*>(cols);
    const auto* mm = static_cast<const float*>(m);
    const auto* pp = static_cast<const float*>(p);
    auto* cc = static_cast<float*>(c);
    const auto s = static_cast<cudaStream_t>(stream);
    if (g < 1 || g > 128) return static_cast<int>(cudaErrorInvalidValue);
    switch (rows_per_tile) {
        case 8: return launch<8>(gp, cl, mm, pp, cc, n_tiles, n_rows, m_cols, g, s);
        case 16: return launch<16>(gp, cl, mm, pp, cc, n_tiles, n_rows, m_cols, g, s);
        case 24: return launch<24>(gp, cl, mm, pp, cc, n_tiles, n_rows, m_cols, g, s);
        case 32: return launch<32>(gp, cl, mm, pp, cc, n_tiles, n_rows, m_cols, g, s);
        case 40: return launch<40>(gp, cl, mm, pp, cc, n_tiles, n_rows, m_cols, g, s);
        case 48: return launch<48>(gp, cl, mm, pp, cc, n_tiles, n_rows, m_cols, g, s);
        case 56: return launch<56>(gp, cl, mm, pp, cc, n_tiles, n_rows, m_cols, g, s);
        case 64: return launch<64>(gp, cl, mm, pp, cc, n_tiles, n_rows, m_cols, g, s);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}

}  // extern "C"
