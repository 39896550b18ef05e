// Prefix-coalesce for Hopper: compact the survivor prefixes of K (nb, L)
// streams into flat streams of out_cap elements, plus a block id a position:
//
//   out_k[offs[b] + j] = in_k[b, j],  block_id[offs[b] + j] = b,
//   for 0 <= j < offs[b + 1] - offs[b],
//
// positions outside [offs[0], offs[nb]) filled with a value a stream (and
// block id -1), positions at or past out_cap dropped.  The copy moves bytes
// only: a 4-byte stream (int32, float32) or an 8-byte one (the port's int64
// limbs), so one kernel serves every type.
//
// Replaces the TPU kernel sparsetpu/kernels/coalesce.py::_kernel (called
// through coalesce_blocks), which DMAs every block's full L lanes to offs[b]
// and relies on the TPU's grid steps running in order so that block b + 1
// overwrites block b's dead tail.  CUDA blocks run concurrently in no order,
// so here a block writes only its own survivor prefix and no two threads
// ever write one address.
//
// What bounds it on the card: bytes.  Every survivor is read once and
// written once in each stream, with a 4-byte block id, and the tail fill is
// written once; there is no arithmetic.  The design (simple first):
//   - a 1-D grid: nb * ceil(L / kTile) copy blocks, block (b, tile) copying
//     lanes [tile * kTile, (tile + 1) * kTile) of block b's prefix, then
//     kFillBlocks blocks that stride over the positions no block covers.  A
//     copy block past its prefix returns at once, so the work follows the
//     survivors, not nb * L;
//   - thread i of a block handles lanes tile * kTile + i + r * kThreads: the
//     reads are L-aligned and neighbouring threads touch neighbouring
//     addresses in both the read and the write, so both coalesce, the
//     writes at an arbitrary (unaligned) offset;
//   - offsets are clamped (a survivor count to [0, L], a position to
//     [0, out_cap)), so offsets that break the precondition never make it
//     read or write out of bounds.
// Vector (16-byte) loads, which need the write offsets aligned too, and one
// block per several small prefixes are later work.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 4;
constexpr int kTile = kThreads * kPerThread;  // lanes a copy block covers
constexpr int kMaxStreams = 4;
constexpr int kFillBlocks = 528;               // 4 a streaming multiprocessor

struct Streams {
    const void* in[kMaxStreams];
    void* out[kMaxStreams];
    long long fill[kMaxStreams];
    int k;
    int wide;  // bit s set: stream s has 8-byte elements
};

__device__ __forceinline__ void copy_elem(const Streams& s, int64_t src, int64_t dst) {
#pragma unroll
    for (int q = 0; q < kMaxStreams; ++q) {
        if (q >= s.k) break;
        if ((s.wide >> q) & 1) {
            static_cast<long long*>(s.out[q])[dst] = static_cast<const long long*>(s.in[q])[src];
        } else {
            static_cast<int32_t*>(s.out[q])[dst] = static_cast<const int32_t*>(s.in[q])[src];
        }
    }
}

__device__ __forceinline__ void fill_elem(const Streams& s, int64_t dst) {
#pragma unroll
    for (int q = 0; q < kMaxStreams; ++q) {
        if (q >= s.k) break;
        if ((s.wide >> q) & 1) {
            static_cast<long long*>(s.out[q])[dst] = s.fill[q];
        } else {
            static_cast<int32_t*>(s.out[q])[dst] = static_cast<int32_t>(s.fill[q]);
        }
    }
}

__global__ void __launch_bounds__(kThreads)
coalesce_blocks_kernel(const int32_t* __restrict__ offs, Streams s, int32_t* __restrict__ block_id,
                       int64_t nb, int64_t L, int64_t out_cap, int64_t tiles, int64_t copy_blocks) {
    const int64_t bx = blockIdx.x;
    if (bx < copy_blocks) {
        const int64_t b = bx / tiles;
        const int64_t lane0 = (bx - b * tiles) * kTile;
        const int64_t start = offs[b];
        int64_t sb = static_cast<int64_t>(offs[b + 1]) - start;
        sb = sb < 0 ? 0 : (sb > L ? L : sb);
        if (lane0 >= sb) return;
#pragma unroll
        for (int r = 0; r < kPerThread; ++r) {
            const int64_t j = lane0 + threadIdx.x + r * kThreads;
            const int64_t t = start + j;
            if (j < sb && t >= 0 && t < out_cap) {
                copy_elem(s, b * L + j, t);
                block_id[t] = static_cast<int32_t>(b);
            }
        }
        return;
    }
    // the fill: [0, offs[0]) and [offs[nb], out_cap)
    const int64_t head = offs[0] < 0 ? 0 : (offs[0] < out_cap ? offs[0] : out_cap);
    const int64_t tail = offs[nb] < head ? head : (offs[nb] < out_cap ? offs[nb] : out_cap);
    const int64_t gaps = head + (out_cap - tail);
    const int64_t stride = static_cast<int64_t>(gridDim.x - copy_blocks) * kThreads;
    for (int64_t g = (bx - copy_blocks) * kThreads + threadIdx.x; g < gaps; g += stride) {
        const int64_t t = g < head ? g : tail + (g - head);
        fill_elem(s, t);
        block_id[t] = -1;
    }
}

}  // namespace

extern "C" {

// Launches the compaction on `stream` and returns cudaGetLastError() (0 =
// launched), or cudaErrorInvalidValue for a shape it does not take.
// offs: int32[nb + 1]; in_q: (nb, L) streams, out_q: out_cap-element
// outputs, for q < k (the rest ignored); bit q of `wide` marks an 8-byte
// stream; fill_q: the bit pattern of stream q's fill (its low 4 bytes for a
// 4-byte stream).  The caller checks: contiguous tensors on one card,
// 1 <= k <= 4, L >= 1, out_cap >= 1.
int coalesce_blocks(const void* offs, int64_t nb, int64_t L, int64_t out_cap, int k, int wide,
                    const void* in0, const void* in1, const void* in2, const void* in3,
                    void* out0, void* out1, void* out2, void* out3, void* block_id,
                    int64_t fill0, int64_t fill1, int64_t fill2, int64_t fill3, void* stream) {
    if (k < 1 || k > kMaxStreams || nb < 0 || L < 1 || out_cap < 1)
        return static_cast<int>(cudaErrorInvalidValue);
    const int64_t tiles = (L + kTile - 1) / kTile;
    const int64_t copy_blocks = nb * tiles;
    const int64_t blocks = copy_blocks + kFillBlocks;
    if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
    Streams s;
    const void* ins[kMaxStreams] = {in0, in1, in2, in3};
    void* outs[kMaxStreams] = {out0, out1, out2, out3};
    const long long fills[kMaxStreams] = {fill0, fill1, fill2, fill3};
    for (int q = 0; q < kMaxStreams; ++q) {
        s.in[q] = ins[q];
        s.out[q] = outs[q];
        s.fill[q] = fills[q];
    }
    s.k = k;
    s.wide = wide;
    coalesce_blocks_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(offs), s, static_cast<int32_t*>(block_id), nb, L, out_cap,
        tiles, copy_blocks);
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
