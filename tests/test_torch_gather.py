"""The port's exact byte-plane gather (ops/gather.py) against the JAX
package's, on the CPU.

The JAX side runs as tests/test_gather.py runs it here: `GatherTable` with
interpret=True (the Pallas kernel interpreted). The port runs the plain
version of its kernel. Tolerance: none. Every comparison is bit-exact, as
int32, special values (inf, -inf, -0.0, NaN, denormal-adjacent 1e-38)
included: the gather moves bytes and never does float arithmetic.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ntrace_tpu.ops import gather as ref
from ntrace_tpu_torch.ops import gather

CASES = [  # (n, c, q, page, tile), as tests/test_gather.py
    (1000, 16, 2048, 256, 256),
    (100, 12, 513, 128, 128),      # Q not a multiple of tile: padded
    (65536, 16, 4096, 512, 512),
]
SPECIAL = [np.inf, -np.inf, -0.0, np.nan, 1e-38, 255.5]


def _bits(a) -> np.ndarray:
    return np.asarray(a, np.float32).view(np.int32)


def _table(rng, n, c) -> np.ndarray:
    t = rng.standard_normal((n, c)).astype(np.float32)
    flat = t.reshape(-1)
    flat[:len(SPECIAL)] = SPECIAL
    flat[-len(SPECIAL):] = SPECIAL
    # A NaN with a payload other than the default quiet NaN's.
    flat[len(SPECIAL)] = np.array([0x7FC01234], np.int32).view(np.float32)[0]
    return t


def test_split_table_bytes_bit_equal():
    rng = np.random.default_rng(0)
    t = _table(rng, 64, 4)
    t[0] = [0.0, -0.0, np.inf, -np.inf]
    t[1] = [np.nan, 1e-38, -1e38, 255.5]
    got = gather.split_table_bytes(torch.from_numpy(t)).numpy()
    want = np.asarray(ref.split_table_bytes(jnp.asarray(t)))
    assert got.dtype == np.int8 and got.shape == (64, 16)
    np.testing.assert_array_equal(got, want)
    bits = t.view(np.int32)
    for k in range(4):
        np.testing.assert_array_equal(
            got[:, 4 * k:4 * (k + 1)].astype(np.int32) & 0xFF,
            (bits >> (8 * k)) & 0xFF)


def _both(table, idx, page, tile):
    """(port output, JAX output, port GatherTable, JAX GatherTable)."""
    gt = gather.GatherTable(table, page=page, tile=tile, device="cpu")
    jt = ref.GatherTable(table, page=page, tile=tile)
    got = gt(torch.from_numpy(idx)).numpy()
    want = np.asarray(jt(jnp.asarray(idx), interpret=True))
    return got, want, gt, jt


@pytest.mark.parametrize("n,c,q,page,tile", CASES)
def test_gather_bit_equal_to_jax_and_table(n, c, q, page, tile):
    rng = np.random.default_rng(1)
    table = _table(rng, n, c)
    idx = rng.integers(0, n, q).astype(np.int32)
    idx[:3] = [0, n - 1, 0]     # the rows that hold the special values
    got, want, gt, jt = _both(table, idx, page, tile)
    assert got.shape == (q, c) and got.dtype == np.float32
    np.testing.assert_array_equal(_bits(got), _bits(table[idx]))
    np.testing.assert_array_equal(_bits(got), _bits(want))
    # The padded, split table is the JAX wrapper's, byte for byte.
    assert gt.bytes.shape[0] % page == 0
    np.testing.assert_array_equal(gt.bytes.numpy(), np.asarray(jt.bytes))


def test_skewed_and_repeated_indices():
    rng = np.random.default_rng(2)
    table = _table(rng, 512, 8)
    # All on one page, many duplicates, and the boundary rows.
    idx = np.concatenate([np.zeros(200, np.int32), np.full(200, 511, np.int32),
                          rng.integers(0, 128, 112).astype(np.int32)])
    got, want, _, _ = _both(table, idx, 128, 128)
    np.testing.assert_array_equal(_bits(got), _bits(table[idx]))
    np.testing.assert_array_equal(_bits(got), _bits(want))


def test_paged_gather_contract():
    """Q must be a multiple of tile; an index outside [0, Np) is clamped
    for the read; the CPU takes the plain version (no launch)."""
    table = np.arange(24, dtype=np.float32).reshape(8, 3)
    gt = gather.GatherTable(table, page=4, tile=4, device="cpu")
    idx = torch.tensor([0, 7, -5, 100], dtype=torch.int32)
    before = gather.paged_gather_bytes.launches
    out = gather.paged_gather_bytes(gt.bytes, idx, n_rows=8, c=3, page=4,
                                    tile=4)
    assert gather.paged_gather_bytes.launches == before
    np.testing.assert_array_equal(out.numpy(), table[[0, 7, 0, 7]])
    with pytest.raises(ValueError, match="tile"):
        gather.paged_gather_bytes(gt.bytes, idx[:3], n_rows=8, c=3, page=4,
                                  tile=4)
    with pytest.raises(ValueError):
        gather.paged_gather_bytes(gt.bytes, idx.long(), n_rows=8, c=3,
                                  page=4, tile=4)
    with pytest.raises(ValueError):
        gather.split_table_bytes(torch.zeros((4, 3), dtype=torch.float64))


def test_cuda_input_never_reaches_the_plain_version(monkeypatch):
    """A CUDA tensor goes to the kernel or raises; here the launch is
    replaced by one that fails, and the call must raise."""
    planes = gather.split_table_bytes(torch.zeros((4, 2)))
    monkeypatch.setattr(gather, "uses_kernel", lambda t: True)

    def failing_launch(*a):
        raise RuntimeError("ntrace_gather_bytes launch failed")

    def no_plain(*a, **k):
        raise AssertionError("the plain version ran for a kernel tensor")

    monkeypatch.setattr(gather, "_launch", failing_launch)
    monkeypatch.setattr(gather, "paged_gather_bytes_ref", no_plain)
    with pytest.raises(RuntimeError):
        gather.paged_gather_bytes(planes, torch.zeros(4, dtype=torch.int32),
                                  n_rows=4, c=2, page=4, tile=4)


@pytest.mark.cuda
@pytest.mark.parametrize("n,c,q,page,tile", CASES)
def test_gather_kernel_on_cuda(n, c, q, page, tile):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    rng = np.random.default_rng(3)
    table = _table(rng, n, c)
    idx = rng.integers(0, n, -(-q // tile) * tile).astype(np.int32)
    gt = gather.GatherTable(table, page=page, tile=tile, device="cuda")
    idx_d = torch.from_numpy(idx).cuda()
    before = gather.paged_gather_bytes.launches
    got = gt(idx_d)
    torch.cuda.synchronize()
    assert gather.paged_gather_bytes.launches == before + 1
    plain = gather.paged_gather_bytes_ref(gt.bytes, idx_d, n_rows=n, c=c,
                                          page=page, tile=tile)
    assert torch.equal(got.view(torch.int32), plain.view(torch.int32))
    np.testing.assert_array_equal(_bits(got.cpu().numpy()),
                                  _bits(table[idx]))
