// Group-dot SpMM for Hopper on the int8 tensor cores: C = A x P by one small
// exact integer contraction per group of G entries of A.
//
// Replaces the TPU kernel sparsetpu/kernels/spmm_pallas.py::_spmm_mxu_kernel
// (called through spmm_pallas_mxu), which contracts each group on the MXU.
// A is cut into tiles of R output rows; each tile's entries form groups of G
// slots, group q holding the P rows cols[q*G .. q*G+G) and an (R, G) matrix
// M_q (M_q[r, e] is the value of slot e if it lies in the tile's row r, else
// 0).  Tile t owns groups [group_ptr[t], group_ptr[t+1]), its first count[t]
// slots are its entries and the rest padding, and it computes
//
//     C[t*R + r, j] = sum over its groups q, slots e:  M_q[r, e] * P[cols[e], j]
//
// for r < R (rows past n_rows are not written), with P (n_p, m) and C
// (n_rows, m) dense row-major f32.
//
// The arithmetic is exact by construction, with no TF32 and no fp32 product:
//   - M_q's values are below 2^8 (prepare_group_operand guards it) and come
//     as u8, M_q's slots zero-padded to kpad, a multiple of 32;
//   - every P value p must be an integer in [0, 2^24); it splits into three
//     u8 limbs p_k = (p >> 8k) & 255, and S_k = sum M * p_k is taken in s32
//     by mma.sync m16n8k32 u8 x u8 (PTX written here, no library);
//   - a k-step adds at most 32 * 255 * 255 < 2^21 to a limb sum, and C =
//     S_0 + (S_1 << 8) + (S_2 << 16) is summed in s32 a step at a time: exact
//     while C < 2^31, the bound three s32 limb sums would have (S_0 <= C),
//     far past the 2^24 below which C is exact in f32 (the callers guard
//     that); C is rounded to f32 once, when it is written;
//   - a limb that is zero in every value a warp stages for a step adds 0, so
//     the warp votes (__any_sync) and skips its MMAs: values below 2^8 take
//     one MMA a step, below 2^16 two.
// P's domain is checked on every value staged for a real slot: one that is
// not an integer in [0, 2^24) (negative, fractional, 2^24 or more, inf, NaN)
// makes the warp that staged it write NaN over its whole output tile (its
// R rows x 16 columns), never a finite wrong number.  A warp's outputs depend
// only on the values it checked itself.
//
// One MMA puts P's columns on M and the tile's rows on N:
//     D (16 columns x 8 rows) += A (16 columns x 32 slots) . B (32 slots x 8 rows)
// so R = 8 * kNT is kNT n8 tiles and a group is kpad / 32 k32 steps.  A
// ("row", K contiguous) packs four consecutive slots of one P column in a
// register: each thread reads its four f32 values from the staged rows,
// converts and checks them and splits them into limb registers with byte
// permutes, so no limb plane ever goes to device memory.  B ("col", K
// contiguous per row) is M_q's own row-major [r][e] bytes.
//
// What bounds it on the card: bytes.  C = A x P must read A, each distinct P
// row it references and write C once: 1.70 ms at 3.35 TB/s for a step of the
// thinned 30^3 chain (80,882 entries, P and C 27,000 x 27,000).  The
// gathered rows, one per entry (8.7 GB a step, the dense-acc kernel's
// reads), come mostly from the 50 MB L2.  The padded (R, G) blocks' products
// (2,984 groups x 40 x 32 x 27,000 x 2 = 0.21 TOP a limb) run on the tensor
// cores.  The design:
//   - one block of 8 warps per (row tile, up to 8 chunks of 128 columns),
//     tiles on gridDim.x; each warp owns 16 columns of a chunk and keeps its
//     kNT x 4 s32 sums in registers (at most 85 a thread at R <= 40, so
//     3 blocks an SM);
//   - the block walks the tile's k32 steps that hold a real slot, chunk after
//     chunk through one ring (trailing groups of pure padding are skipped,
//     padded slots are zero-filled rather than read), staging each step's 32
//     P-row segments (16 KB) and its R x 32 bytes of M through kStages
//     shared-memory stages with 16-byte cp.async (4-byte where m % 4 != 0 or
//     P is unaligned), so the copies of the next steps overlap the MMAs of
//     this one (the TPU kernel's two group slots); each step's P columns are
//     loaded into registers a step ahead of the copy that needs them;
//   - the staged P rows are XOR-swizzled in 16-byte chunks so the A-fragment
//     reads are free of bank conflicts; M rows are padded to 48 bytes for the
//     same reason;
//   - C is written from the D fragments: each store instruction of a warp
//     fills four whole 32-byte sectors; addresses are computed in int64.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kColsPerBlock = kWarps * 16;   // one m16 tile of P columns a warp
constexpr int kChunks = kColsPerBlock / 4;   // 16-byte chunks of a staged P row
constexpr int kK = 32;                       // slots of one MMA k-step
constexpr int kStages = 4;
constexpr int kPStageBytes = kK * kColsPerBlock * 4;
constexpr int kMRowBytes = 48;               // 32 bytes of M a row, padded
constexpr int kRowsPerThread = kK * kChunks / kThreads;  // staged P rows a thread copies
constexpr int kMaxChunksPerBlock = 8;
constexpr int kMinBlocks = 3;  // blocks an SM should hold at R <= 40: caps registers at 85

__host__ __device__ constexpr int stage_bytes(int r) { return kPStageBytes + r * kMRowBytes; }
__host__ __device__ constexpr int smem_bytes(int r) { return kStages * stage_bytes(r); }

// the 16-byte chunk swizzle of staged P row e: rows 4t..4t+3 XOR by 2t
__device__ __forceinline__ int swizzle(int e) { return ((e >> 2) & 3) << 1; }

__device__ __forceinline__ uint32_t smem_addr(const void* ptr) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

// global -> shared copies that zero-fill what src_bytes leaves out
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(smem_addr(dst)), "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(smem_addr(dst)), "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::);
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(kPending));
}

// d += a . b on u8 operands with s32 sums
__device__ __forceinline__ void mma_u8(int32_t (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int kNT, bool kVec>
__global__ void __launch_bounds__(kThreads, kNT <= 5 ? kMinBlocks : 1)
spmm_group_dot_kernel(const int32_t* __restrict__ group_ptr,
                      const int32_t* __restrict__ count,
                      const int32_t* __restrict__ cols,
                      const uint8_t* __restrict__ m8,
                      const float* __restrict__ p,
                      float* __restrict__ c, int64_t n_rows, int64_t m_cols,
                      int g, int kpad, int chunks_per_block) {
    constexpr int kR = kNT * 8;
    extern __shared__ __align__(16) unsigned char smem[];
    const int tid = threadIdx.x;
    const int warp = tid >> 5;
    const int gq = (tid & 31) >> 2;  // the MMA fragments' groupID
    const int tq = tid & 3;          // and thread in group
    const int ch = tid % kChunks;    // the 16-byte chunk of the staged rows it copies
    const int64_t tile = blockIdx.x;
    const int32_t q0 = group_ptr[tile];
    const int32_t n_groups = group_ptr[tile + 1] - q0;
    const int32_t cnt = count[tile];
    const int ksteps = kpad / kK;
    // real slots are the prefix [0, cnt) of the tile's slot stream: walk
    // only the k-steps that hold one
    const int32_t n_steps =
        min((cnt / g) * ksteps + (cnt % g + kK - 1) / kK, n_groups * ksteps);
    // the block's column chunks, walked one after another through one ring
    const int64_t chunk0 = static_cast<int64_t>(blockIdx.y) * chunks_per_block;
    const int64_t left = (m_cols + kColsPerBlock - 1) / kColsPerBlock - chunk0;
    const int n_chunks = static_cast<int>(left < chunks_per_block ? left : chunks_per_block);

    // C's entries this thread holds: rows nt*8 + 2tq + (k & 1), columns
    // warp*16 + gq + 8(k >> 1) of the chunk (the m16n8 D fragment)
    auto store = [&](int64_t chunk, const int32_t (&total)[kNT][4], bool poison) {
        const int64_t col0 = (chunk0 + chunk) * kColsPerBlock + warp * 16 + gq;
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
            for (int k = 0; k < 4; ++k) {
                const int64_t row = tile * kR + nt * 8 + 2 * tq + (k & 1);
                const int64_t col = col0 + (k >> 1) * 8;
                if (row < n_rows && col < m_cols)
                    c[row * m_cols + col] =
                        poison ? __int_as_float(0x7fc00000) : static_cast<float>(total[nt][k]);
            }
    };
    if (n_steps == 0) {  // no entries: C's rows are 0
        const int32_t zero[kNT][4] = {};
        for (int k = 0; k < n_chunks; ++k) store(k, zero, false);
        return;
    }

    // where a stream of steps stands: step s of chunk `chunk`, k-step kk of
    // group gi; moved on once a step, so the loop does no division
    struct Cursor {
        int32_t s, gi;
        int kk, chunk;
    };
    auto advance = [&](Cursor& cu) {
        if (++cu.s == n_steps) {
            cu = Cursor{0, 0, 0, cu.chunk + 1};
        } else if (++cu.kk == ksteps) {
            cu.kk = 0;
            ++cu.gi;
        }
    };
    // the P column of each staged row this thread copies (rows warp + 8k),
    // -1 for a padded slot; loaded a step ahead of the copy, so the load's
    // latency hides behind a step of MMAs
    auto load_cols = [&](const Cursor& cu, int32_t (&cl)[kRowsPerThread]) {
#pragma unroll
        for (int k = 0; k < kRowsPerThread; ++k) {
            const int eg = cu.kk * kK + tid / kChunks + 8 * k;  // slot within the group
            cl[k] = eg < g && cu.gi * g + eg < cnt
                        ? __ldg(cols + static_cast<int64_t>(q0 + cu.gi) * g + eg) : -1;
        }
    };
    auto issue = [&](const Cursor& cu, int stage_idx, const int32_t (&cl)[kRowsPerThread]) {
        unsigned char* stage = smem + stage_idx * stage_bytes(kR);
        float* ps = reinterpret_cast<float*>(stage);
        const int64_t j = (chunk0 + cu.chunk) * kColsPerBlock + ch * 4;
#pragma unroll
        for (int k = 0; k < kRowsPerThread; ++k) {
            const int e = tid / kChunks + 8 * k;
            float* dst = ps + e * kColsPerBlock + ((ch ^ swizzle(e)) << 2);
            const float* src = p + static_cast<int64_t>(cl[k] < 0 ? 0 : cl[k]) * m_cols + j;
            if (kVec) {
                cp_async16(dst, src, cl[k] >= 0 && j < m_cols ? 16 : 0);
            } else {
#pragma unroll
                for (int w = 0; w < 4; ++w) {
                    const bool ok = cl[k] >= 0 && j + w < m_cols;
                    cp_async4(dst + w, ok ? src + w : p, ok ? 4 : 0);
                }
            }
        }
        unsigned char* ms = stage + kPStageBytes;
        const int64_t q = q0 + cu.gi;
        for (int idx = tid; idx < kR * 2; idx += kThreads) {
            const int r = idx >> 1, h = idx & 1;
            cp_async16(ms + r * kMRowBytes + h * 16,
                       m8 + (q * kR + r) * kpad + cu.kk * kK + h * 16, 16);
        }
    };

    const int32_t total_steps = n_steps * n_chunks;
    Cursor at_load{0, 0, 0, 0}, at_issue{0, 0, 0, 0}, at{0, 0, 0, 0};
    {
        int32_t cl[kStages - 1][kRowsPerThread];
#pragma unroll
        for (int s = 0; s < kStages - 1; ++s)
            if (s < total_steps) {
                load_cols(at_load, cl[s]);
                advance(at_load);
            }
#pragma unroll
        for (int s = 0; s < kStages - 1; ++s) {
            if (s < total_steps) {
                issue(at_issue, s, cl[s]);
                advance(at_issue);
            }
            cp_async_commit();  // an empty group keeps the count of pending groups uniform
        }
    }
    int32_t cn[kRowsPerThread];
    if (kStages - 1 < total_steps) {
        load_cols(at_load, cn);
        advance(at_load);
    }

    // C = S_0 + (S_1 << 8) + (S_2 << 16), summed a step at a time in s32:
    // exact while C < 2^31, the same bound as three s32 limb sums
    int32_t total[kNT][4];
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int k = 0; k < 4; ++k) total[nt][k] = 0;
    // the domain check's state: |v - float(uint(v))| summed (a fraction, a
    // negative value, inf or NaN leaves it nonzero) and the OR of the
    // integers (2^24 and more set a bit above 23)
    float err = 0.f;
    uint32_t seen = 0;
    int stage_idx = 0, issue_idx = kStages - 1;
    for (int32_t i = 0; i < total_steps; ++i) {
        cp_async_wait<kStages - 2>();
        __syncthreads();  // step i's stage has landed, and step i - 1's is consumed by all
        if (i + kStages - 1 < total_steps) {
            issue(at_issue, issue_idx, cn);
            advance(at_issue);
        }
        cp_async_commit();
        if (i + kStages < total_steps) {
            load_cols(at_load, cn);
            advance(at_load);
        }
        issue_idx = issue_idx == kStages - 1 ? 0 : issue_idx + 1;

        const unsigned char* stage = smem + stage_idx * stage_bytes(kR);
        stage_idx = stage_idx == kStages - 1 ? 0 : stage_idx + 1;
        const float* ps = reinterpret_cast<const float*>(stage);
        const unsigned char* ms = stage + kPStageBytes;
        uint32_t u[4][4];  // A register, slot
        uint32_t step_or = 0;
#pragma unroll
        for (int reg = 0; reg < 4; ++reg) {
            // rows e0..e0+3 (slots) at one column; their swizzle is 2 * tq
            const int e0 = (reg >> 1) * 16 + 4 * tq;
            const int col = warp * 16 + gq + (reg & 1) * 8;
            const int off = (((col >> 2) ^ (tq << 1)) << 2) | (col & 3);
#pragma unroll
            for (int k = 0; k < 4; ++k) {
                const float v = ps[(e0 + k) * kColsPerBlock + off];
                u[reg][k] = __float2uint_rz(v);
                err += fabsf(v - __uint2float_rz(u[reg][k]));
                step_or |= u[reg][k];
            }
        }
        seen |= step_or;
        // the limbs any value of this warp's step needs: a zero limb adds 0
        const bool need1 = __any_sync(0xffffffffu, step_or >= (1u << 8));
        const bool need2 = __any_sync(0xffffffffu, step_or >= (1u << 16));
        uint32_t a[3][4];  // limb, A register
#pragma unroll
        for (int reg = 0; reg < 4; ++reg) {
            const uint32_t lo01 = __byte_perm(u[reg][0], u[reg][1], 0x5140);  // u0.b0 u1.b0 u0.b1 u1.b1
            const uint32_t lo23 = __byte_perm(u[reg][2], u[reg][3], 0x5140);
            a[0][reg] = __byte_perm(lo01, lo23, 0x5410);
            a[1][reg] = __byte_perm(lo01, lo23, 0x7632);
            if (need2) {
                const uint32_t hi01 = __byte_perm(u[reg][0], u[reg][1], 0x0062);  // u0.b2 u1.b2
                const uint32_t hi23 = __byte_perm(u[reg][2], u[reg][3], 0x0062);
                a[2][reg] = __byte_perm(hi01, hi23, 0x5410);
            }
        }
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt) {
            const unsigned char* mrow = ms + (nt * 8 + gq) * kMRowBytes + 4 * tq;
            const uint32_t b0 = *reinterpret_cast<const uint32_t*>(mrow);
            const uint32_t b1 = *reinterpret_cast<const uint32_t*>(mrow + 16);
            mma_u8(total[nt], a[0], b0, b1);
            if (need1) {
                int32_t s1[4] = {0, 0, 0, 0};
                mma_u8(s1, a[1], b0, b1);
#pragma unroll
                for (int k = 0; k < 4; ++k) total[nt][k] += s1[k] << 8;
            }
            if (need2) {
                int32_t s2[4] = {0, 0, 0, 0};
                mma_u8(s2, a[2], b0, b1);
#pragma unroll
                for (int k = 0; k < 4; ++k) total[nt][k] += s2[k] << 16;
            }
        }

        if (at.s == n_steps - 1) {  // the chunk's last step: write its C entries
            // a warp's entries depend only on the values it checked itself
            const bool poison = __any_sync(0xffffffffu, !(err == 0.f) || seen >= (1u << 24));
            store(at.chunk, total, poison);
#pragma unroll
            for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
                for (int k = 0; k < 4; ++k) total[nt][k] = 0;
            err = 0.f;
            seen = 0;
        }
        advance(at);
    }
    cp_async_wait<0>();
}

bool aligned16(const void* ptr) {
    return (reinterpret_cast<uintptr_t>(ptr) & 15u) == 0;
}

template <int kNT>
int launch(const int32_t* group_ptr, const int32_t* count, const int32_t* cols,
           const uint8_t* m8, const float* p, float* c, int64_t n_tiles, int64_t n_rows,
           int64_t m_cols, int g, cudaStream_t s) {
    constexpr int kSmem = smem_bytes(kNT * 8);
    const int kpad = (g + kK - 1) / kK * kK;
    int dev = 0, sms = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    // chunks a block walks: as many as leave ~8 blocks an SM (long rings,
    // one start-up a block), at most kMaxChunksPerBlock
    const int64_t n_chunks = (m_cols + kColsPerBlock - 1) / kColsPerBlock;
    const int64_t per = n_tiles * n_chunks / (8 * static_cast<int64_t>(sms));
    const int cpb = static_cast<int>(per < 1 ? 1 : per > kMaxChunksPerBlock ? kMaxChunksPerBlock
                                                                             : per);
    const dim3 grid(static_cast<unsigned>(n_tiles),
                    static_cast<unsigned>((n_chunks + cpb - 1) / cpb));
    const bool vec = m_cols % 4 == 0 && aligned16(p) && aligned16(c);
    auto kernel = vec ? spmm_group_dot_kernel<kNT, true> : spmm_group_dot_kernel<kNT, false>;
    // above 48 KB of dynamic shared memory the launch needs the opt-in
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<grid, kThreads, kSmem, s>>>(group_ptr, count, cols, m8, p, c, n_rows, m_cols,
                                         g, kpad, cpb);
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
// 8, 16, ..., 64, a g outside 1..128 or an m8 not 16-byte aligned.  m8 is
// uint8 (n_groups, R, kpad), kpad = g rounded up to a multiple of 32.  The
// caller checks shapes, types and m <= spmm_group_dot_max_cols().
int spmm_group_dot_u8(const void* group_ptr, const void* count, const void* cols,
                      const void* m8, const void* p, void* c, int64_t n_tiles,
                      int64_t n_rows, int64_t m_cols, int rows_per_tile, int g,
                      void* stream) {
    const auto* gp = static_cast<const int32_t*>(group_ptr);
    const auto* ct = static_cast<const int32_t*>(count);
    const auto* cl = static_cast<const int32_t*>(cols);
    const auto* mm = static_cast<const uint8_t*>(m8);
    const auto* pp = static_cast<const float*>(p);
    auto* cc = static_cast<float*>(c);
    const auto s = static_cast<cudaStream_t>(stream);
    if (g < 1 || g > 128 || !aligned16(m8)) return static_cast<int>(cudaErrorInvalidValue);
    switch (rows_per_tile) {
        case 8: return launch<1>(gp, ct, cl, mm, pp, cc, n_tiles, n_rows, m_cols, g, s);
        case 16: return launch<2>(gp, ct, cl, mm, pp, cc, n_tiles, n_rows, m_cols, g, s);
        case 24: return launch<3>(gp, ct, cl, mm, pp, cc, n_tiles, n_rows, m_cols, g, s);
        case 32: return launch<4>(gp, ct, cl, mm, pp, cc, n_tiles, n_rows, m_cols, g, s);
        case 40: return launch<5>(gp, ct, cl, mm, pp, cc, n_tiles, n_rows, m_cols, g, s);
        case 48: return launch<6>(gp, ct, cl, mm, pp, cc, n_tiles, n_rows, m_cols, g, s);
        case 56: return launch<7>(gp, ct, cl, mm, pp, cc, n_tiles, n_rows, m_cols, g, s);
        case 64: return launch<8>(gp, ct, cl, mm, pp, cc, n_tiles, n_rows, m_cols, g, s);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}

}  // extern "C"
