"""The port's prefix-coalesce (sparsetpu_torch.kernels.coalesce) against the
JAX package's Pallas kernel (sparsetpu.kernels.coalesce, interpret mode on
the CPU).

On the CPU the wrapper runs the plain version; the CUDA kernel is held
against it where a card is present (marker ``cuda``).  Tolerance: exact.
Compared: every position below min(total, out_cap), the streams and the
block ids.  JAX passes nb offsets and lets later blocks overwrite earlier
tails (its positions at or past the total hold leftovers); the port passes
nb + 1 and fills those positions, which the port-only test pins.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from sparsetpu.kernels import coalesce as jco

from sparsetpu_torch.kernels import coalesce as pco

JAX_DTYPE = {"int32": np.int32, "uint32": np.uint32, "float32": np.float32}
PORT_DTYPE = {"int32": torch.int32, "uint32": torch.int64, "float32": torch.float32}


def _streams(nb, L, kinds, seed):
    rng = np.random.default_rng(seed)
    out = []
    for kind in kinds:
        if kind == "float32":
            out.append(rng.integers(-1000, 1000, (nb, L)).astype(np.float32))
        else:
            lo, hi = (-2**31, 2**31) if kind == "int32" else (0, 2**32)
            out.append(rng.integers(lo, hi, (nb, L)).astype(JAX_DTYPE[kind]))
    return out


# name -> (survivor counts a block, L, stream types, out_cap - total)
CASES = {
    "int32-K1": ([5, 0, 16, 3, 16, 0], 16, ["int32"], 4),
    "uint32-K2-empty-and-full": ([0, 16, 0, 0, 7, 16], 16, ["int32", "uint32"], 0),
    "K3-one-block": ([9], 32, ["int32", "uint32", "uint32"], 3),
    "K3-cap-below-total": ([12, 3, 8, 0, 16, 16, 1], 16, ["int32", "int32", "uint32"], -20),
    "float32-K2": ([1, 2, 3, 4], 8, ["float32", "int32"], 2),
    # the kernel writes 4 positions a thread and searches a block per warp
    # span of 128: several block boundaries inside one 4-position vector,
    # L, the total and out_cap not multiples of 4
    "K4-blocks-of-0-to-3": ([1, 0, 3, 2, 0, 0, 1, 3, 1, 2, 0, 3, 1, 1, 0, 2, 3], 3,
                            ["int32", "int32", "uint32", "uint32"], 3),
    "odd-L-total-and-cap": ([5, 4, 0, 5, 1], 5, ["float32"], 6),
    "cap-below-total-inside-a-vector": ([5, 2, 7, 0, 6], 7, ["int32", "uint32"], -3),
    "block-longer-than-a-tile": ([3, 1025, 0, 2, 130], 1030, ["uint32", "int32"], 7),
}


@pytest.mark.parametrize("name", list(CASES))
def test_coalesce_matches_jax(name):
    sb, L, kinds, slack = CASES[name]
    nb = len(sb)
    offs = np.concatenate([[0], np.cumsum(sb)]).astype(np.int32)
    total = int(offs[-1])
    out_cap = total + slack
    streams = _streams(nb, L, kinds, seed=len(name))
    want = jco.coalesce_blocks(jnp.asarray(offs[:-1]), [jnp.asarray(s) for s in streams],
                               out_cap)
    got = pco.coalesce_blocks(
        torch.from_numpy(offs),
        [torch.from_numpy(s.astype(np.int64) if k == "uint32" else s)
         for s, k in zip(streams, kinds)], out_cap)
    assert len(got) == len(kinds) + 1
    m = min(total, out_cap)  # out_cap below the total: the excess is dropped
    for g, w, kind in zip(got, want, kinds + ["int32"]):
        assert g.shape == (out_cap,) and g.dtype == PORT_DTYPE[kind]
        np.testing.assert_array_equal(g.numpy()[:m], np.asarray(w)[:m].astype(g.numpy().dtype))
    # the block ids are the docstring's reference loop's
    bid = np.concatenate([np.full(c, b) for b, c in enumerate(sb)])[:m]
    np.testing.assert_array_equal(got[-1].numpy()[:m], bid)


def test_fills_past_the_total_and_before_the_first_offset():
    streams = [torch.arange(12, dtype=torch.int32).view(3, 4),
               torch.arange(12, dtype=torch.float32).view(3, 4)]
    offs = torch.tensor([0, 2, 2, 5], dtype=torch.int32)
    col, val, bid = pco.coalesce_blocks(offs, streams, 8, fills=[-5, 0.5])
    np.testing.assert_array_equal(col.numpy(), [0, 1, 8, 9, 10, -5, -5, -5])
    np.testing.assert_array_equal(val.numpy(), [0, 1, 8, 9, 10, 0.5, 0.5, 0.5])
    np.testing.assert_array_equal(bid.numpy(), [0, 0, 2, 2, 2, -1, -1, -1])
    # positions below offs[0] hold no survivor either
    col, bid = pco.coalesce_blocks(torch.tensor([2, 4], dtype=torch.int32),
                                   [torch.arange(4, dtype=torch.int32).view(1, 4)], 6)
    np.testing.assert_array_equal(col.numpy(), [0, 0, 0, 1, 0, 0])
    np.testing.assert_array_equal(bid.numpy(), [-1, -1, 0, 0, -1, -1])
    # no blocks at all
    empty = pco.coalesce_blocks(torch.zeros(1, dtype=torch.int32),
                                [torch.zeros((0, 4), dtype=torch.int64)], 3, fills=[9])
    np.testing.assert_array_equal(empty[0].numpy(), [9, 9, 9])
    np.testing.assert_array_equal(empty[1].numpy(), [-1, -1, -1])


def test_streams_may_be_views_at_any_offset():
    sb, L, kinds, slack = CASES["K4-blocks-of-0-to-3"]
    offs = torch.tensor(np.concatenate([[0], np.cumsum(sb)]), dtype=torch.int32)
    streams = [torch.from_numpy(s.astype(np.int64) if k == "uint32" else s)
               for s, k in zip(_streams(len(sb), L, kinds, seed=5), kinds)]
    out_cap = int(offs[-1]) + slack
    want = pco.coalesce_blocks(offs, streams, out_cap, fills=[7] * len(kinds))
    got = pco.coalesce_blocks(offs, [_odd_view(s) for s in streams], out_cap,
                              fills=[7] * len(kinds))
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def _odd_view(s):
    """A contiguous view of ``s``'s values one element into a larger buffer."""
    buf = s.new_zeros(s.numel() + 1)
    buf[1:] = s.reshape(-1)
    view = buf[1:].view(s.shape)
    assert view.is_contiguous() and view.storage_offset() == 1
    return view


def test_checks_raise():
    s = torch.zeros((2, 4), dtype=torch.int32)
    offs = torch.tensor([0, 1, 2], dtype=torch.int32)
    with pytest.raises(ValueError, match="nb \\+ 1"):
        pco.coalesce_blocks(offs[:2], [s], 4)
    with pytest.raises(ValueError, match="1 to 4"):
        pco.coalesce_blocks(offs, [s] * 5, 4)
    with pytest.raises(ValueError, match="contiguous"):
        pco.coalesce_blocks(offs, [s.bool()], 4)
    with pytest.raises(ValueError, match="contiguous"):
        pco.coalesce_blocks(offs, [s, torch.zeros((2, 5), dtype=torch.int32)], 4)
    with pytest.raises(ValueError, match="fill"):
        pco.coalesce_blocks(offs, [s], 4, fills=[0, 1])


@pytest.mark.cuda
def test_cuda_coalesce_kernel_matches_plain_version():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for sb, L, kinds, slack in CASES.values():
        offs = torch.tensor(np.concatenate([[0], np.cumsum(sb)]), dtype=torch.int32)
        streams = [torch.from_numpy(s.astype(np.int64) if k == "uint32" else s)
                   for s, k in zip(_streams(len(sb), L, kinds, seed=3), kinds)]
        out_cap = int(offs[-1]) + slack
        want = pco.coalesce_blocks(offs, streams, out_cap, fills=[7] * len(kinds))
        # contiguous streams, and views one element into a buffer (unaligned)
        for on_card in ([s.cuda() for s in streams], [_odd_view(s.cuda()) for s in streams]):
            before = pco.LAUNCHES
            got = pco.coalesce_blocks(offs.cuda(), on_card, out_cap, fills=[7] * len(kinds))
            torch.cuda.synchronize()
            assert pco.LAUNCHES == before + 1
            for g, w in zip(got, want):
                assert torch.equal(g.cpu(), w)
