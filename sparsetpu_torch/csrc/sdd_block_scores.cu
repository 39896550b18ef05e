// Sampled dense-dense (SDD) block scores for Hopper: for every listed pair
// t of a block row qi[t] of Q and a block row ki[t] of K,
//
//     out[t] = Q[qi[t]*128 : +128, :] @ K[ki[t]*128 : +128, :]^T
//
// with q f32[M, D] and k f32[N, D] row-major, qi/ki int32[T], out
// f32[T, 128, 128].  Only the listed score blocks are computed; absent
// blocks cost nothing; a pair whose index is out of range gets a block of
// NaN, so it can never pass as zeros.
//
// Replaces the TPU kernel sparsetpu/kernels/blocksparse.py::_sdd_kernel
// (called through sdd_block_scores), which runs one grid step per pair with
// the pair list scalar-prefetched and the product on the MXU at HIGHEST
// precision.
//
// Precision: the products run on the tensor cores in a 3xTF32 split.  Each
// operand x splits into hi, x rounded to TF32 (to nearest, ties away, as
// cvt.rna.tf32.f32 rounds), and lo = x - hi, which the tensor cores read
// truncated to TF32; every k8 step accumulates lo_q.hi_k + hi_q.lo_k +
// hi_q.hi_k (small terms first) in fp32 with mma.sync m16n8k8.  What is
// dropped, lo.lo and lo's low bits, is below 2^-20 |q||k| a product; plain
// TF32 (hi.hi alone, ~3 digits) would miss the reference's 1e-4 bar, and
// stays unused.
// The sums run in another order than a plain matmul's, so the results agree
// with the plain version to rounding (rtol 1e-5, atol 1e-4), not bit for bit.
//
// What bounds it on the card: at the GPT-2 117M attention shape (config 1:
// D = 64, T = 1,792 pairs over 768 Q and 768 K blocks) the function writes
// 117 MB of score blocks and reads 50 MB of distinct Q and K rows: 0.050 ms
// at 3.35 TB/s.  Its 3 x 3.76 GFLOP of TF32 products take 0.023 ms at the
// data sheet's 495 TFLOP/s, so the bytes bound it.  The design:
//   - a persistent grid (as many blocks as fit on the card, two an SM at
//     D <= 64) in which each block walks a contiguous range of the pair
//     list.  The list is sorted by (qi, ki), so consecutive pairs share qi;
//   - 256 threads as 2 x 4 warps, each warp a 64 x 32 quarter-column of the
//     128 x 128 block: 4 x 4 m16n8 fragments, 64 fp32 sums a thread;
//   - K staged in chunks of 32 columns of D through a two-slot cp.async
//     ring: the next chunk (or the next pair's first) loads while this one
//     multiplies.  For D <= 64 the whole Q tile stays in shared memory while
//     qi repeats, in one of two buffers, so the next qi's tile loads behind
//     the current pair; for wider D, Q's chunks ride the ring beside K's.
//     Staged rows are 4 words longer than their data (4 mod 32 words
//     apart), so each fragment load hits 32 distinct banks;
//   - fragments come in with ldmatrix (one x4 gives an m16n8k8 A fragment,
//     or the B fragments of two n-tiles) and are split in registers: two
//     integer operations and one subtraction an element, where the
//     conversion instruction for both halves is measurably slower (PERF.md),
//     and splitting once into hi and lo copies in shared memory costs as
//     much in barriers and doubled fragment loads;
//   - not wgmma, the path to the tensor cores' full TF32 rate (mma.sync's
//     TF32 path issues at about a quarter of it and bounds this kernel):
//     with 64 sums a thread held across its asynchronous products, ptxas
//     serialises them (it injects warpgroup waits), and every arrangement
//     tried ran slower than this one (PERF.md);
//   - each finished block leaves the fragments directly: neighbouring lanes
//     swap halves with one shuffle, so every thread writes whole 16-byte
//     runs, with streaming stores (__stcs): each store instruction fills
//     whole 32-byte sectors of 16 rows.
// Measured times are in PERF.md (chip_smoke.py phase 3).

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kBlock = 128;                // bm = bn
constexpr int kThreads = 256;              // 8 warps: 2 (rows) x 4 (columns)
constexpr int kStages = 2;                 // ring slots: chunks in flight + 1
constexpr int kChunk = 32;                 // columns of D a ring slot holds
constexpr int kChunkStride = kChunk + 4;   // floats a staged chunk row
constexpr int kResidentMaxD = 64;          // Q kept whole (two tiles) up to this D

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Rows 0..127, columns [c0, c0 + w) of the (128, d) block at src into dst
// (row stride ds floats); w a multiple of 4.
__device__ __forceinline__ void stage_rows(float* dst, int ds, const float* src, int d, int c0,
                                           int w) {
    const int per_row = w / 4;
    const int n = kBlock * per_row;
    for (int e = threadIdx.x; e < n; e += kThreads) {
        const int r = e / per_row;
        const int c = (e - r * per_row) * 4;
        cp_async16(dst + r * ds + c, src + static_cast<int64_t>(r) * d + c0 + c);
    }
}

// x = hi + lo: hi is x's nearest TF32 value, ties away from zero (what
// cvt.rna.tf32.f32 gives for a finite x: the 13 low bits of the magnitude
// rounded off, here in two integer operations), and lo = x - hi, exact in
// fp32.  lo goes to the tensor cores as it is: an m16n8k8 .tf32 operand's
// 13 low bits are not read, so the product uses lo truncated to TF32,
// within 2^-21 |x| of x altogether.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
    hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
    lo = __float_as_uint(x - __uint_as_float(hi));
}

// Four 8 x 4 fp32 blocks from shared memory: this lane names row lane % 8
// of block lane / 8 at p; it gets element (lane / 4, lane % 4) of each, as
// an m16n8k8 .tf32 fragment holds them.
__device__ __forceinline__ void ldmatrix_x4(float (&r)[4], const float* p) {
    const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(*reinterpret_cast<uint32_t*>(&r[0])),
                   "=r"(*reinterpret_cast<uint32_t*>(&r[1])),
                   "=r"(*reinterpret_cast<uint32_t*>(&r[2])),
                   "=r"(*reinterpret_cast<uint32_t*>(&r[3]))
                 : "r"(a));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
    asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__global__ void __launch_bounds__(kThreads, 2)
sdd_block_scores_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const int32_t* __restrict__ qi, const int32_t* __restrict__ ki,
                        float* __restrict__ out, int64_t n_pairs, int64_t nqb, int64_t nkb,
                        int d, int64_t per_block, int resident) {
    extern __shared__ __align__(16) float smem[];
    const int qs = resident ? d + 4 : kChunkStride;  // Q row stride, 4 mod 8 words
    const int nq = resident ? 2 : kStages;
    float* qbuf = smem;                              // [nq][128][qs]
    float* kbuf = smem + nq * kBlock * qs;           // [kStages][128][kChunkStride]
    const int64_t t0 = static_cast<int64_t>(blockIdx.x) * per_block;
    const int64_t t1 = t0 + per_block < n_pairs ? t0 + per_block : n_pairs;
    if (t0 >= t1) return;
    const int nc = (d + kChunk - 1) / kChunk;
    const int64_t n_stages = (t1 - t0) * nc;

    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const int wm = warp >> 2;  // rows wm*64 .. +64
    const int wn = warp & 3;   // columns wn*32 .. +32
    const int gid = lane >> 2;
    const int tig = lane & 3;
    // the row this lane names to ldmatrix, and its column offset: an A
    // fragment's four blocks are (rows 0-7, 8-15) x (k 0-3, 4-7); one x4
    // gives the B fragments (k 0-3, 4-7) of two n-tiles
    const int a_row = (lane & 7) + 8 * ((lane >> 3) & 1);
    const int a_col = 4 * (lane >> 4);
    const int b_row = (lane & 7) + 8 * (lane >> 4);
    const int b_col = 4 * ((lane >> 3) & 1);

    auto pair_ok = [&](int32_t qb, int32_t kb) {
        return qb >= 0 && qb < nqb && kb >= 0 && kb < nkb;
    };

    // the loader runs one stage ahead of the compute; both keep the same
    // record of which Q buffer holds which qi
    int32_t load_q = -1;
    int load_slot = 1;
    auto issue = [&](int64_t s) {
        const int64_t t = t0 + s / nc;
        const int c = static_cast<int>(s % nc);
        const int32_t qb = s < n_stages ? qi[t] : -1;
        const int32_t kb = s < n_stages ? ki[t] : -1;
        if (pair_ok(qb, kb)) {
            const int c0 = c * kChunk;
            const int w = d - c0 < kChunk ? d - c0 : kChunk;
            const int slot = static_cast<int>(s % kStages);
            stage_rows(kbuf + slot * kBlock * kChunkStride, kChunkStride,
                       k + static_cast<int64_t>(kb) * kBlock * d, d, c0, w);
            const float* qsrc = q + static_cast<int64_t>(qb) * kBlock * d;
            if (!resident) {
                stage_rows(qbuf + slot * kBlock * kChunkStride, kChunkStride, qsrc, d, c0, w);
            } else if (c == 0 && qb != load_q) {
                load_slot ^= 1;
                load_q = qb;
                stage_rows(qbuf + load_slot * kBlock * qs, qs, qsrc, d, 0, d);
            }
        }
        cp_async_commit();
    };

    int32_t cur_q = -1;
    int cur_slot = 1;
    float acc[4][4][4];
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
            for (int r = 0; r < 4; ++r) acc[mt][nt][r] = 0.f;

    for (int s = 0; s < kStages - 1; ++s) issue(s);
    for (int64_t s = 0; s < n_stages; ++s) {
        cp_async_wait<kStages - 2>();
        __syncthreads();  // stage s has landed; stage s - 1's slot is free
        issue(s + kStages - 1);  // past the end: an empty group, so the wait stays uniform

        const int64_t t = t0 + s / nc;
        const int c = static_cast<int>(s % nc);
        const bool ok = pair_ok(qi[t], ki[t]);
        if (ok) {
            const int slot = static_cast<int>(s % kStages);
            if (resident && c == 0 && qi[t] != cur_q) {
                cur_slot ^= 1;
                cur_q = qi[t];
            }
            const float* A = resident ? qbuf + cur_slot * kBlock * qs + c * kChunk
                                      : qbuf + slot * kBlock * kChunkStride;
            const float* B = kbuf + slot * kBlock * kChunkStride;
            const int w = d - c * kChunk < kChunk ? d - c * kChunk : kChunk;
            for (int kk = 0; kk < w; kk += 8) {
                uint32_t bh[4][2], bl[4][2];
#pragma unroll
                for (int p = 0; p < 2; ++p) {  // n-tiles 2p, 2p + 1
                    float b[4];
                    ldmatrix_x4(b, B + (wn * 32 + p * 16 + b_row) * kChunkStride + kk + b_col);
#pragma unroll
                    for (int i = 0; i < 4; ++i)
                        split(b[i], bh[2 * p + i / 2][i % 2], bl[2 * p + i / 2][i % 2]);
                }
                // A fragments of the warp's 4 m-tiles; each term over all 16
                // fragments before the next, so an accumulator's three
                // products are 16 issues apart
                uint32_t ah[4][4], al[4][4];
#pragma unroll
                for (int mt = 0; mt < 4; ++mt) {
                    float a[4];
                    ldmatrix_x4(a, A + (wm * 64 + mt * 16 + a_row) * qs + kk + a_col);
#pragma unroll
                    for (int i = 0; i < 4; ++i) split(a[i], ah[mt][i], al[mt][i]);
                }
#pragma unroll
                for (int mt = 0; mt < 4; ++mt)
#pragma unroll
                    for (int nt = 0; nt < 4; ++nt) mma_tf32(acc[mt][nt], al[mt], bh[nt]);
#pragma unroll
                for (int mt = 0; mt < 4; ++mt)
#pragma unroll
                    for (int nt = 0; nt < 4; ++nt) mma_tf32(acc[mt][nt], ah[mt], bl[nt]);
#pragma unroll
                for (int mt = 0; mt < 4; ++mt)
#pragma unroll
                    for (int nt = 0; nt < 4; ++nt) mma_tf32(acc[mt][nt], ah[mt], bh[nt]);
            }
        }

        if (c == nc - 1) {
            float* o = out + t * kBlock * kBlock;
            if (ok) {
                const bool even = (tig & 1) == 0;
#pragma unroll
                for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
                    for (int nt = 0; nt < 4; ++nt) {
                        const float* cf = acc[mt][nt];
                        // even lanes take row gid's four columns, odd lanes
                        // row gid + 8's, each half from the neighbour
                        const float r0 = __shfl_xor_sync(0xffffffffu, even ? cf[2] : cf[0], 1);
                        const float r1 = __shfl_xor_sync(0xffffffffu, even ? cf[3] : cf[1], 1);
                        const int row = wm * 64 + mt * 16 + gid + (even ? 0 : 8);
                        const int col = wn * 32 + nt * 8 + 2 * tig - (even ? 0 : 2);
                        __stcs(reinterpret_cast<float4*>(o + row * kBlock + col),
                               even ? make_float4(cf[0], cf[1], r0, r1)
                                    : make_float4(r0, r1, cf[2], cf[3]));
                    }
                }
            } else {
                const float nan = __int_as_float(0x7fffffff);
                for (int e = tid; e < kBlock * kBlock / 4; e += kThreads)
                    __stcs(reinterpret_cast<float4*>(o) + e, make_float4(nan, nan, nan, nan));
            }
#pragma unroll
            for (int mt = 0; mt < 4; ++mt)
#pragma unroll
                for (int nt = 0; nt < 4; ++nt)
#pragma unroll
                    for (int r = 0; r < 4; ++r) acc[mt][nt][r] = 0.f;
        }
    }
    cp_async_wait<0>();
}

}  // namespace

extern "C" {

// The most pairs one launch takes.
int64_t sdd_block_scores_max_pairs() { return 2147483647; }

// Launches the T-pair SDD on `stream` and returns cudaGetLastError()
// (0 = launched).  The caller checks: q (m, d) and k (n, d) contiguous f32,
// 16-byte aligned; m and n multiples of 128 (the block, bm = bn); d a
// positive multiple of 8; 0 < t <= sdd_block_scores_max_pairs().
int sdd_block_scores_f32(const void* q, const void* k, const void* qi,
                         const void* ki, void* out, int64_t t, int64_t m,
                         int64_t n, int64_t d, void* stream) {
    // Q whole in two buffers: the next qi's tile loads kStages - 1 chunks
    // ahead, so the buffer it fills must be past its last use by then
    const int64_t nc = (d + kChunk - 1) / kChunk;
    const int resident = d <= kResidentMaxD && nc >= kStages - 1;
    const int qs = resident ? static_cast<int>(d) + 4 : kChunkStride;
    const size_t smem = ((resident ? 2 : kStages) * static_cast<size_t>(kBlock) * qs +
                         kStages * static_cast<size_t>(kBlock) * kChunkStride) * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(sdd_block_scores_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    int dev = 0;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess) return static_cast<int>(err);
    // the persistent grid: as many blocks as the card holds at once
    int n_sm = 0, per_sm = 0;
    if ((err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev)) !=
            cudaSuccess ||
        (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, sdd_block_scores_kernel, kThreads, smem)) != cudaSuccess)
        return static_cast<int>(err);
    if (per_sm < 1) per_sm = 1;
    const int64_t slots = static_cast<int64_t>(n_sm) * per_sm;
    const int64_t per_block = (t + slots - 1) / slots;
    const int64_t blocks = (t + per_block - 1) / per_block;
    sdd_block_scores_kernel<<<static_cast<unsigned>(blocks), kThreads, smem,
                              static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const int32_t*>(qi), static_cast<const int32_t*>(ki),
        static_cast<float*>(out), t, m / kBlock, n / kBlock, static_cast<int>(d), per_block,
        resident);
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
