"""ma_tpu_torch's FMD-index operations (ma_tpu_torch/ops/occ.py) against
ma_tpu's (ma_tpu/ops/occ.py) on the same host FMDIndex: every BWT row of a
small index, the rows around `primary`, and BWT words with the top bit set.
Every output is an integer, so equality is exact."""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from ma_tpu.containers.pack import Pack as JPack  # noqa: E402
from ma_tpu.index.fmd_index import FMDIndex as JFMDIndex  # noqa: E402
from ma_tpu.ops import occ as J  # noqa: E402
from ma_tpu_torch.containers.pack import Pack  # noqa: E402
from ma_tpu_torch.index.fmd_index import FMDIndex, fm_text_from_pack  # noqa: E402
from ma_tpu_torch.ops import occ as T  # noqa: E402

# the suite runs several test processes side by side on the CPU; one
# intra-op thread each keeps torch's many small ops from contending
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def index():
    """A 3 kbp genome with a tandem repeat (text 6,000 + $): 47 occ blocks.
    Each package's FMDDev comes from its own host index."""
    rng = np.random.default_rng(5)
    genome = rng.integers(0, 4, 3000).astype(np.uint8)
    genome[1000:1210] = np.tile(rng.integers(0, 4, 7), 30).astype(np.uint8)
    jpack, pack = JPack.empty(), Pack.empty()
    jpack.append("g", genome)
    pack.append("g", genome)
    fmd = FMDIndex.build(pack)
    return fmd, J.FMDDev.from_host(JFMDIndex.build(jpack)), T.FMDDev.from_host(fmd, "cpu"), pack


def _rows(fmd):
    """Every BWT row, -1 and n (the last row) included."""
    return np.arange(-1, fmd.n + 1, dtype=np.int32)


def test_index_has_words_with_the_top_bit_set(index):
    fmd, _, tdev, _ = index
    assert (fmd.bwt_words >= 2**31).mean() > 0.3
    assert tdev.bwt_words.dtype == torch.int64 and int(tdev.bwt_words.min()) >= 0


def test_match_bits_and_masks_on_top_bit_words():
    words = np.asarray([0xFFFFFFFF, 0x80000000, 0xC0000000, 0x40000000, 0x7FFFFFFF,
                        0xAAAAAAAA, 0x55555555, 0x1B1B1B1B, 0xE4E4E4E4], np.uint32)
    for c in range(4):
        want = np.asarray(J._match_bits(jnp.asarray(words), c))
        got = T._match_bits(torch.as_tensor(words.astype(np.int64)), c).numpy()
        assert np.array_equal(got, want.astype(np.int64)), c
        pc = T._popcount32(torch.as_tensor(want.astype(np.int64))).numpy()
        assert np.array_equal(pc, [bin(int(x)).count("1") for x in want])
    off = np.arange(128, dtype=np.int32)
    want = np.asarray(J._inclusive_masks(jnp.asarray(off))).astype(np.int64)
    assert np.array_equal(T._inclusive_masks(torch.as_tensor(off)).numpy(), want)


def test_occ4_every_row(index):
    fmd, jdev, tdev, _ = index
    k = _rows(fmd)
    want = np.asarray(J.occ4(jdev, jnp.asarray(k)))
    got = T.occ4(tdev, torch.as_tensor(k)).numpy()
    assert got.dtype == np.int32 and np.array_equal(got, want)
    # and against the host index, around the $ row
    for kk in range(fmd.primary - 3, fmd.primary + 4):
        assert got[kk + 1].tolist() == [int(v) for v in fmd.occ4(kk)]


def test_occ1_and_bwt_char_every_row(index):
    fmd, jdev, tdev, _ = index
    k = _rows(fmd)
    c = np.random.default_rng(1).integers(0, 4, k.shape).astype(np.int32)
    want = np.asarray(J.occ1(jdev, jnp.asarray(k), jnp.asarray(c)))
    assert np.array_equal(T.occ1(tdev, torch.as_tensor(k), torch.as_tensor(c)).numpy(), want)
    kk = np.arange(fmd.n, dtype=np.int32)  # stored (without $) indices
    want = np.asarray(J.bwt_char(jdev, jnp.asarray(kk)))
    assert np.array_equal(T.bwt_char(tdev, torch.as_tensor(kk)).numpy(), want)


def _sai(mod, fields, lib):
    return mod.SAI(*(lib(x) for x in fields))


def test_init_interval_and_extend_backward(index):
    fmd, jdev, tdev, pack = index
    rng = np.random.default_rng(2)
    c = np.arange(5, dtype=np.int32)
    ji = J.init_interval(jdev, jnp.asarray(c))
    ti = T.init_interval(tdev, torch.as_tensor(c))
    for a, b in zip(ji, ti):
        assert np.array_equal(np.asarray(a), b.numpy())
    # random intervals, empty ones and intervals straddling the primary
    # row, with every char 0..4
    n = 4000
    start = rng.integers(0, fmd.n + 1, n).astype(np.int32)
    size = rng.integers(0, 40, n).astype(np.int32)
    size[:50] = 0
    start[50:100] = fmd.primary - rng.integers(0, 20, 50)
    size[50:100] = 30
    start_rc = rng.integers(0, fmd.n + 1, n).astype(np.int32)
    start = np.minimum(start, fmd.n + 1 - size).astype(np.int32)
    ch = rng.integers(0, 5, n).astype(np.int32)
    fields = (start, start_rc, size)
    want = J.extend_backward(jdev, _sai(J, fields, jnp.asarray), jnp.asarray(ch))
    got = T.extend_backward(tdev, _sai(T, fields, torch.as_tensor), torch.as_tensor(ch))
    for a, b in zip(want, got):
        assert np.array_equal(np.asarray(a), b.numpy())
    # a batched [B, K] walk: every step of several real searches
    text = fm_text_from_pack(pack).astype(np.int32)
    reads = np.stack([text[s : s + 12] for s in rng.integers(0, fmd.n - 12, 8)])
    reads[5:] = rng.integers(0, 4, (3, 12))  # mostly absent: intervals run empty
    jik = J.init_interval(jdev, jnp.asarray(reads[:, -1]))
    tik = T.init_interval(tdev, torch.as_tensor(reads[:, -1]))
    for i in range(10, -1, -1):
        jik = J.extend_backward(jdev, jik, jnp.asarray(reads[:, i]))
        tik = T.extend_backward(tdev, tik, torch.as_tensor(reads[:, i]))
        for a, b in zip(jik, tik):
            assert np.array_equal(np.asarray(a), b.numpy()), i
    # the host index agrees on one of them
    h = fmd.init_interval(int(reads[0, -1]))
    for i in range(10, -1, -1):
        h = fmd.extend_backward(h, int(reads[0, i]))
    assert int(tik.size[0]) > 0
    assert (int(tik.start[0]), int(tik.start_rc[0]), int(tik.size[0])) == tuple(int(v) for v in h)


def test_inv_psi_and_sa_lookup_every_row(index):
    fmd, jdev, tdev, _ = index
    k = np.arange(0, fmd.n + 1, dtype=np.int32)
    want = np.asarray(J.inv_psi(jdev, jnp.asarray(k)))
    assert np.array_equal(T.inv_psi(tdev, torch.as_tensor(k)).numpy(), want)
    want = np.asarray(J.sa_lookup(jdev, jnp.asarray(k)))
    got = T.sa_lookup(tdev, torch.as_tensor(k)).numpy()
    assert np.array_equal(got, want)
    assert [int(got[r]) for r in range(0, fmd.n + 1, 97)] == \
        [fmd.bwt_sa(r) for r in range(0, fmd.n + 1, 97)]
    # a [B, S] batch, as extract_seeds gives it
    kb = k[1 : 1 + 40 * 50].reshape(40, 50)
    assert np.array_equal(T.sa_lookup(tdev, torch.as_tensor(kb)).numpy(),
                          want[1 : 1 + 40 * 50].reshape(40, 50))


def test_sa_walks_outlast_the_sample_interval(index):
    """The SA is sampled by row, so an LF walk to a sampled row has no bound
    of SA_INTERVAL - 1 steps: some rows of this index need more."""
    fmd = index[0]
    steps = []
    for r in range(0, fmd.n + 1, 7):
        s, k = 0, r
        while k % 32:
            k, s = fmd.inv_psi(k), s + 1
        steps.append(s)
    assert max(steps) >= 32


def test_occ4_blocks_every_row_class(index):
    """The packed 64-byte blocks the FM-walk kernel reads give occ4 at every
    row, so at k = -1, the rows around `primary`, each block's edges (47
    blocks) and the last row n."""
    fmd, _, tdev, _ = index
    assert tdev.occ_blocks.shape == (fmd.bwt_words.shape[0], 16)
    assert tdev.occ_blocks.element_size() * 16 == 64
    kt = torch.as_tensor(_rows(fmd))  # every row: -1 to n, so every class
    assert torch.equal(T.occ4_blocks(tdev, kt), T.occ4(tdev, kt))
    # the padding ints stay zero and the words keep their top bits
    assert int(tdev.occ_blocks[:, 12:].abs().sum()) == 0
    words = tdev.occ_blocks[:, 4:12].to(torch.int64) & 0xFFFFFFFF
    assert torch.equal(words, tdev.bwt_words)
