// Sampled dense-dense (SDD) block scores for Hopper: for every listed pair
// t of a block row qi[t] of Q and a block row ki[t] of K,
//
//     out[t] = Q[qi[t]*128 : +128, :] @ K[ki[t]*128 : +128, :]^T
//
// with q f32[M, D] and k f32[N, D] row-major, qi/ki int32[T], out
// f32[T, 128, 128].  Only the listed score blocks are computed; absent
// blocks cost nothing.
//
// Replaces the TPU kernel sparsetpu/kernels/blocksparse.py::_sdd_kernel
// (called through sdd_block_scores), which runs one grid step per pair with
// the pair list scalar-prefetched and the product on the MXU at HIGHEST
// precision.  Here every product is an fp32 FMA on the CUDA cores: no TF32,
// no reduced-precision mma/wgmma, no library call, since the reference's
// agreement bar is 1e-4 relative and TF32 keeps about three digits.  The
// summation order differs from a plain matmul's, so the results agree to
// rounding (rtol 1e-5, atol 1e-4), not bit for bit.
//
// What bounds it on the card: at the GPT-2 117M attention shape (config 1:
// 98,304 rows, D = 64) the pair list has T = 1,792 blocks: 1,792 * 128 *
// 128 * 64 * 2 = 3.76 GFLOP, 117 MB of score blocks written and 50 MB of
// distinct Q and K rows read.  Both limits come to roughly 56 us: the FLOPs
// at the data-sheet 67 TFLOP/s fp32 rate, the bytes at ~3 TB/s.  The design:
//   - one block per pair t, which loads its own qi[t] and ki[t] (the
//     counterpart of the scalar prefetch); an out-of-range index fills its
//     block with NaN, so it can never pass as zeros;
//   - 256 threads as 16 x 16, each holding an 8 x 8 register tile of the
//     128 x 128 block: rows {4ty..4ty+3, 64+4ty..64+4ty+3} and the same
//     pattern in columns with tx, so the float4 reads of a quarter-warp in
//     the k-loop fall on 8 consecutive 16-byte words (no bank conflicts);
//   - Q and K staged through shared memory in chunks of 32 columns of D,
//     transposed (the chunk's column index outermost): 2 x 32 x 128 x 4 B =
//     32 KB of static shared memory, 2 blocks per SM.  The staging reads are
//     float4 loads by consecutive rows, so the transposed stores hit
//     consecutive banks and need no padding;
//   - each output row segment is written once as float4s, coalesced.
// Measured on NVIDIA H100 80GB HBM3, 700.00 W: 0.144 ms on the config-1
// pair list (26 TFLOP/s, 39 % of the FLOP bound; the plain batched product
// 0.220 ms), at 127 registers a thread and no spills.
// A TMA-fed, double-buffered pipeline and a tensor-core form (which needs a
// split-precision scheme to keep fp32 accuracy, e.g. 3xTF32) are later work.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kBlock = 128;    // bm = bn
constexpr int kThreads = 256;  // 16 x 16 threads
constexpr int kChunk = 32;     // columns of D staged per pass

__global__ void __launch_bounds__(kThreads, 2)
sdd_block_scores_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const int32_t* __restrict__ qi, const int32_t* __restrict__ ki,
                        float* __restrict__ out, int64_t nqb, int64_t nkb, int d) {
    __shared__ __align__(16) float qs[kChunk][kBlock];  // qs[c][row]
    __shared__ __align__(16) float ks[kChunk][kBlock];
    const int64_t t = blockIdx.x;
    const int tid = threadIdx.x;
    const int tx = tid % 16;
    const int ty = tid / 16;
    const int32_t qb = qi[t];
    const int32_t kb = ki[t];
    float* o = out + t * kBlock * kBlock;
    if (qb < 0 || qb >= nqb || kb < 0 || kb >= nkb) {
        for (int e = tid; e < kBlock * kBlock; e += kThreads)
            o[e] = __int_as_float(0x7fffffff);
        return;
    }
    const float* qbase = q + static_cast<int64_t>(qb) * kBlock * d;
    const float* kbase = k + static_cast<int64_t>(kb) * kBlock * d;

    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

    for (int c0 = 0; c0 < d; c0 += kChunk) {
        const int w = d - c0 < kChunk ? d - c0 : kChunk;  // a multiple of 8
        const int n4 = kBlock * (w / 4);
        for (int e = tid; e < n4; e += kThreads) {
            const int row = e % kBlock;
            const int c4 = e / kBlock;
            const float4 a = __ldg(reinterpret_cast<const float4*>(
                qbase + static_cast<int64_t>(row) * d + c0) + c4);
            const float4 b = __ldg(reinterpret_cast<const float4*>(
                kbase + static_cast<int64_t>(row) * d + c0) + c4);
            qs[4 * c4 + 0][row] = a.x;
            qs[4 * c4 + 1][row] = a.y;
            qs[4 * c4 + 2][row] = a.z;
            qs[4 * c4 + 3][row] = a.w;
            ks[4 * c4 + 0][row] = b.x;
            ks[4 * c4 + 1][row] = b.y;
            ks[4 * c4 + 2][row] = b.z;
            ks[4 * c4 + 3][row] = b.w;
        }
        __syncthreads();
#pragma unroll 8
        for (int c = 0; c < w; ++c) {
            const float4 a0 = *reinterpret_cast<const float4*>(&qs[c][4 * ty]);
            const float4 a1 = *reinterpret_cast<const float4*>(&qs[c][64 + 4 * ty]);
            const float4 b0 = *reinterpret_cast<const float4*>(&ks[c][4 * tx]);
            const float4 b1 = *reinterpret_cast<const float4*>(&ks[c][64 + 4 * tx]);
            const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
            const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
            for (int i = 0; i < 8; ++i)
#pragma unroll
                for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
        }
        __syncthreads();
    }

#pragma unroll
    for (int i = 0; i < 8; ++i) {
        const int r = i < 4 ? 4 * ty + i : 64 + 4 * ty + (i - 4);
        float4* dst = reinterpret_cast<float4*>(o + r * kBlock);
        dst[tx] = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
        dst[16 + tx] = make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
    }
}

}  // namespace

extern "C" {

// The most pairs one launch takes (gridDim.x).
int64_t sdd_block_scores_max_pairs() { return 2147483647; }

// Launches the T-pair SDD on `stream` and returns cudaGetLastError()
// (0 = launched).  The caller checks: q (m, d) and k (n, d) contiguous f32,
// 16-byte aligned; m and n multiples of 128 (the block, bm = bn); d a
// positive multiple of 8; 0 < t <= sdd_block_scores_max_pairs().
int sdd_block_scores_f32(const void* q, const void* k, const void* qi,
                         const void* ki, void* out, int64_t t, int64_t m,
                         int64_t n, int64_t d, void* stream) {
    sdd_block_scores_kernel<<<static_cast<unsigned>(t), kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const int32_t*>(qi), static_cast<const int32_t*>(ki),
        static_cast<float*>(out), m / kBlock, n / kBlock, static_cast<int>(d));
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
