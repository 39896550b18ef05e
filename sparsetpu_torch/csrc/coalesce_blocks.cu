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
// so here no two threads ever write one address and nothing depends on an
// order of writes.
//
// What bounds it on the card: bytes.  Every survivor is read once and
// written once in each stream, with a 4-byte block id, and every other
// position below out_cap is written once with the fills; there is no
// arithmetic beyond addressing.  On the slab's inputs about half of the
// bytes are the fill.  The design, one output-stationary sweep:
//   - a persistent grid (the blocks that fit on the card at once) walks
//     [0, out_cap) in vectors of kVec = 4 positions, a thread a vector, so
//     copy and fill are one uniform loop and every output byte is written
//     exactly once by it: no block idles on a short prefix;
//   - a position finds its source block by an upper-bound search over offs
//     (staged in shared memory when nb + 1 entries fit): once per warp for
//     the first and last position of the warp's 128 (the same address in
//     every lane), and again per position only where a block boundary falls
//     inside the warp's span, searching between those two blocks, so blocks
//     with no survivors and several boundaries in one vector come out right;
//   - every output stream and the block id are written by aligned 16-byte
//     stores (one for 4 positions of a 4-byte stream, two for an 8-byte
//     one); the wrapper allocates the outputs, so they are aligned, and the
//     last vector of an out_cap that is not a multiple of 4 is written by
//     scalar stores.  The fill is pure vector stores of a constant;
//   - loads stay scalar: a block's source run is contiguous, so a warp's
//     loads of one stream touch 512 or 1,024 contiguous bytes, at whatever
//     alignment offs[b] and the input view give (aligned 16-byte loads with
//     the next lane's vector taken by a shuffle, and streaming cache hints
//     on the loads or the stores, were no faster on the H100);
//   - the stream loop sits outside the position loop: all of a vector's
//     loads are issued before its stores, and the width test is uniform;
//   - 32-bit positions and source indices where out_cap and nb * L fit (every
//     caller today), 64-bit otherwise.  A source index is computed unsigned
//     and clamped to nb * L - 1, so offsets that break the precondition
//     never make the kernel read out of bounds; it writes only [0, out_cap).

#include <cuda_runtime.h>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 4;                 // positions a thread writes at once
constexpr int kWarpSpan = 32 * kVec;    // positions a warp covers at once
constexpr int kMaxStreams = 4;
constexpr int kSmemOffs = 4096;         // offsets staged in shared memory when nb + 1 fit

struct Streams {
    const void* in[kMaxStreams];
    void* out[kMaxStreams];
    long long fill[kMaxStreams];
    int k;
    int wide;  // bit s set: stream s has 8-byte elements
};

// The largest b in [lo, hi] with offs[b] <= t (lo when there is none).
template <typename Idx>
__device__ __forceinline__ int owner(const int32_t* offs, int lo, int hi, Idx t) {
    while (lo < hi) {
        const int mid = (lo + hi + 1) >> 1;
        if (static_cast<Idx>(offs[mid]) <= t) lo = mid; else hi = mid - 1;
    }
    return lo;
}

template <typename Idx>
__global__ void __launch_bounds__(kThreads)
coalesce_blocks_kernel(const int32_t* __restrict__ offs_g, Streams s,
                       int32_t* __restrict__ block_id, int nb, Idx L, Idx out_cap) {
    using U = typename std::make_unsigned<Idx>::type;
    extern __shared__ int32_t offs_s[];
    const int32_t* offs = offs_g;
    if (nb < kSmemOffs) {
        for (int i = threadIdx.x; i <= nb; i += kThreads) offs_s[i] = offs_g[i];
        __syncthreads();
        offs = offs_s;
    }
    const Idx head = offs[0], total = offs[nb];
    const U n_src = static_cast<U>(nb) * static_cast<U>(L);
    const Idx nvec = (out_cap + kVec - 1) / kVec;
    const Idx stride = static_cast<Idx>(gridDim.x) * kThreads;
    for (Idx v = static_cast<Idx>(blockIdx.x) * kThreads + threadIdx.x; v < nvec; v += stride) {
        const Idx t0 = v * kVec;
        // the warp's span [w0, w1): the same in every lane
        const Idx w0 = (v & ~static_cast<Idx>(31)) * kVec;
        const Idx w1 = min(w0 + kWarpSpan, out_cap);
        const Idx lo_t = max(w0, head), hi_t = min(w1, total);
        int b0 = 0, b1 = 0;
        if (lo_t < hi_t) {
            b0 = owner(offs, 0, nb - 1, lo_t);
            b1 = owner(offs, b0, nb - 1, hi_t - 1);
        }
        bool cov[kVec];
        U src[kVec];
        int bid[kVec];
#pragma unroll
        for (int p = 0; p < kVec; ++p) {
            const Idx t = t0 + p;
            cov[p] = t >= head && t < total;
            const int b = b0 == b1 ? b0 : owner(offs, b0, b1, t);
            const U j = static_cast<U>(b) * static_cast<U>(L) +
                        (static_cast<U>(t) - static_cast<U>(static_cast<Idx>(offs[b])));
            src[p] = j < n_src ? j : n_src - 1;
            bid[p] = cov[p] ? b : -1;
        }
        // every load of the vector first, then every store
        long long val[kMaxStreams][kVec];
#pragma unroll
        for (int q = 0; q < kMaxStreams; ++q) {
            if (q >= s.k) break;
            if ((s.wide >> q) & 1) {
                const long long* in = static_cast<const long long*>(s.in[q]);
#pragma unroll
                for (int p = 0; p < kVec; ++p) val[q][p] = cov[p] ? __ldg(in + src[p]) : s.fill[q];
            } else {
                const int32_t* in = static_cast<const int32_t*>(s.in[q]);
#pragma unroll
                for (int p = 0; p < kVec; ++p)
                    val[q][p] = cov[p] ? __ldg(in + src[p]) : static_cast<int32_t>(s.fill[q]);
            }
        }
        if (t0 + kVec <= out_cap) {
#pragma unroll
            for (int q = 0; q < kMaxStreams; ++q) {
                if (q >= s.k) break;
                if ((s.wide >> q) & 1) {
                    longlong2* out = reinterpret_cast<longlong2*>(static_cast<long long*>(s.out[q]) + t0);
                    out[0] = make_longlong2(val[q][0], val[q][1]);
                    out[1] = make_longlong2(val[q][2], val[q][3]);
                } else {
                    *reinterpret_cast<int4*>(static_cast<int32_t*>(s.out[q]) + t0) =
                        make_int4(static_cast<int32_t>(val[q][0]), static_cast<int32_t>(val[q][1]),
                                  static_cast<int32_t>(val[q][2]), static_cast<int32_t>(val[q][3]));
                }
            }
            *reinterpret_cast<int4*>(block_id + t0) = make_int4(bid[0], bid[1], bid[2], bid[3]);
        } else {  // the last vector of an out_cap that is not a multiple of kVec
#pragma unroll
            for (int p = 0; p < kVec; ++p) {
                if (t0 + p >= out_cap) break;
#pragma unroll
                for (int q = 0; q < kMaxStreams; ++q) {
                    if (q >= s.k) break;
                    if ((s.wide >> q) & 1)
                        static_cast<long long*>(s.out[q])[t0 + p] = val[q][p];
                    else
                        static_cast<int32_t*>(s.out[q])[t0 + p] = static_cast<int32_t>(val[q][p]);
                }
                block_id[t0 + p] = bid[p];
            }
        }
    }
}

// Blocks of kThreads that fit on the card at once, for the instantiation.
template <typename Idx>
int resident_blocks() {
    static int per_sm = 0;  // one value for the one architecture built
    int dev = 0, sms = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (per_sm == 0) {
        int n = 0;
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, coalesce_blocks_kernel<Idx>, kThreads,
                                                      kSmemOffs * sizeof(int32_t));
        per_sm = n > 0 ? n : 1;
    }
    return sms * per_sm;
}

template <typename Idx>
int launch(const int32_t* offs, const Streams& s, int32_t* block_id, int64_t nb, int64_t L,
           int64_t out_cap, cudaStream_t stream) {
    const int64_t nvec = (out_cap + kVec - 1) / kVec;
    const int64_t want = (nvec + kThreads - 1) / kThreads;
    const int64_t most = resident_blocks<Idx>();
    const unsigned blocks = static_cast<unsigned>(want < most ? want : most);
    const size_t smem = nb < kSmemOffs ? (nb + 1) * sizeof(int32_t) : 0;
    coalesce_blocks_kernel<Idx><<<blocks, kThreads, smem, stream>>>(
        offs, s, block_id, static_cast<int>(nb), static_cast<Idx>(L), static_cast<Idx>(out_cap));
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches the compaction on `stream` and returns cudaGetLastError() (0 =
// launched), or cudaErrorInvalidValue for a shape it does not take.
// offs: int32[nb + 1]; in_q: (nb, L) streams, out_q: out_cap-element
// outputs, 16-byte aligned, for q < k (the rest ignored); bit q of `wide`
// marks an 8-byte stream; fill_q: the bit pattern of stream q's fill (its
// low 4 bytes for a 4-byte stream).  The caller checks: contiguous tensors
// on one card, 1 <= k <= 4, L >= 1, out_cap >= 1.
int coalesce_blocks(const void* offs, int64_t nb, int64_t L, int64_t out_cap, int k, int wide,
                    const void* in0, const void* in1, const void* in2, const void* in3,
                    void* out0, void* out1, void* out2, void* out3, void* block_id,
                    int64_t fill0, int64_t fill1, int64_t fill2, int64_t fill3, void* stream) {
    if (k < 1 || k > kMaxStreams || nb < 0 || nb >= 0x7fffffffLL || L < 1 || out_cap < 1 ||
        out_cap > (1LL << 62) || L > (1LL << 62) / (nb + 1))
        return static_cast<int>(cudaErrorInvalidValue);
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
    const auto st = static_cast<cudaStream_t>(stream);
    const auto o = static_cast<const int32_t*>(offs);
    const auto bid = static_cast<int32_t*>(block_id);
    // 32-bit positions while every position, a warp's span past out_cap and
    // every source index fit
    if (out_cap <= 0x7fffffffLL - 2 * kWarpSpan && L <= 0x7fffffffLL && nb * L <= 0x7fffffffLL)
        return launch<int32_t>(o, s, bid, nb, L, out_cap, st);
    return launch<int64_t>(o, s, bid, nb, L, out_cap, st);
}

}  // extern "C"
