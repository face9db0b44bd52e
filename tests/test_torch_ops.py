"""The port's host tables, CRC algebra and kernel plain versions, held
against the JAX package on the same seeded inputs.  Every comparison is
exact: bytes equal, CRC values equal."""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seaweedfs_tpu.ops import codec as j_codec
from seaweedfs_tpu.ops import crc32c as j_crc
from seaweedfs_tpu.ops import crc_device as j_crc_device
from seaweedfs_tpu.ops import gf256 as j_gf256
from seaweedfs_tpu.ops import rs_jax as j_rs_jax
from seaweedfs_tpu.ops import rs_numpy as j_rs_numpy
from seaweedfs_tpu.ops import rs_pallas as j_rs_pallas
from seaweedfs_tpu.parallel import mesh as j_mesh
from seaweedfs_tpu_torch.ops import codec as t_codec
from seaweedfs_tpu_torch.ops import crc32c as t_crc
from seaweedfs_tpu_torch.ops import crc_device as t_crc_device
from seaweedfs_tpu_torch.ops import gf256 as t_gf256
from seaweedfs_tpu_torch.ops import rs_cuda
from seaweedfs_tpu_torch.ops import rs_numpy as t_rs_numpy
from seaweedfs_tpu_torch.ops import rs_torch
from seaweedfs_tpu_torch.parallel import mesh as t_mesh

PARITY = np.ascontiguousarray(j_gf256.parity_matrix(10, 14))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Keep torch's CPU ops on one thread: the suite runs test files in
    parallel worker processes beside timing-sensitive cluster tests."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bytes(seed, shape):
    return np.random.default_rng(seed).integers(0, 256, shape,
                                                dtype=np.uint8)


# -- tables ---------------------------------------------------------------------


@pytest.mark.parametrize("data,total", [(10, 14), (4, 6), (6, 9), (12, 16)])
def test_build_and_parity_matrix_equal(data, total):
    assert np.array_equal(t_gf256.build_matrix(data, total),
                          j_gf256.build_matrix(data, total))
    assert np.array_equal(t_gf256.parity_matrix(data, total),
                          j_gf256.parity_matrix(data, total))


def test_mul_table_and_invert_equal():
    assert np.array_equal(t_gf256.mul_table(), j_gf256.mul_table())
    m = j_gf256.build_matrix(10, 14)[[0, 2, 3, 4, 6, 7, 8, 9, 11, 13]]
    assert np.array_equal(t_gf256.gf_invert(m), j_gf256.gf_invert(m))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_coeff_bit_matrix_equal(seed):
    m = _bytes(seed, (4, 10))
    assert np.array_equal(t_gf256.coeff_bit_matrix(m),
                          j_gf256.coeff_bit_matrix(m))
    assert np.array_equal(rs_torch._bit_matrix_cached(*rs_torch._matrix_key(m)),
                          j_rs_jax._bit_matrix_cached(*j_rs_jax._matrix_key(m)))


@pytest.mark.parametrize("lost_count", [1, 2, 3, 4])
def test_decode_rows_every_erasure_pattern(lost_count):
    for lost in itertools.combinations(range(14), lost_count):
        present = [i for i in range(14) if i not in lost]
        survivors = present[:10]
        assert np.array_equal(
            t_rs_numpy.decode_rows(10, 14, survivors, lost),
            j_rs_numpy.decode_rows(10, 14, survivors, lost)), lost


# -- the host CRC ----------------------------------------------------------------


@pytest.mark.parametrize("length", [0, 1, 7, 100, 4097])
def test_host_crc_algebra_equal(length):
    a = _bytes(length, length)
    b = _bytes(length + 1, 37)
    assert t_crc.crc32c(a) == j_crc.crc32c(a)
    assert t_crc._crc32c_py(5, a.tobytes()) == j_crc._crc32c_py(5, a.tobytes())
    assert t_crc.raw_update(0, a.tobytes()) == j_crc.raw_update(0, a.tobytes())
    assert np.array_equal(t_crc.advance_matrix(length),
                          j_crc.advance_matrix(length))
    assert t_crc.crc32c_zeros(length) == j_crc.crc32c_zeros(length)
    assert t_crc.crc32c_combine(t_crc.crc32c(a), t_crc.crc32c(b), 37) \
        == j_crc.crc32c(np.concatenate([a, b]))
    raw = t_crc.raw_update(0, a.tobytes())
    assert t_crc.finalize_raw(raw, length) == j_crc.finalize_raw(raw, length)


@pytest.mark.parametrize("length", [0, 1, 3, 4, 100, 4096, 300_000, 1 << 20])
def test_table_advances_equal_the_advance_and_concatenations(length):
    """The table-driven fixed-length advance and its inverse: equal to
    `advance`, inverse to each other, and they combine and un-pad raw
    images as crc32c of the concatenations says."""
    rng = np.random.default_rng(length)
    adv, inv = t_crc.advance_by(length), t_crc.unadvance_by(length)
    for x in rng.integers(0, 1 << 32, 8, dtype=np.uint64):
        x = int(x)
        assert adv(x) == j_crc.advance(x, length) == t_crc.advance(x, length)
        assert inv(adv(x)) == x == adv(inv(x))
    a = _bytes(length + 2, int(rng.integers(0, 5000)))
    m = _bytes(length + 3, min(length, 5000))
    # a chain: crc32c(A || M) from crc32c(A), crc32c(M) and |M|
    assert t_crc.advance_by(len(m))(t_crc.crc32c(a)) ^ t_crc.crc32c(m) \
        == j_crc.crc32c(np.concatenate([a, m]))
    # un-padding: g(M) from g(M || 0^length)
    padded = np.concatenate([m, np.zeros(length, dtype=np.uint8)])
    if length <= 5000:
        assert inv(j_crc.raw_update(0, padded.tobytes())) == \
            j_crc.raw_update(0, m.tobytes())


@pytest.mark.parametrize("length", [1, 7, 100, 1000, 65536])
def test_batched_crc32c_raw_equal(length):
    data = _bytes(length, (3, length))
    want = np.asarray(jax.jit(j_crc_device.batched_crc32c_raw)(
        jnp.asarray(data)))
    got = t_crc_device.batched_crc32c_raw(torch.from_numpy(data))
    assert got.dtype == torch.int64
    assert np.array_equal(got.numpy().astype(np.uint32), want)
    assert np.array_equal(t_crc_device.finalize(got, length),
                          j_crc_device.finalize(want, length))


def test_adv_columns_apply_the_advance():
    """K2's packed operators: XOR of the columns picked by x's bits is the
    CRC state advanced over n zero bytes."""
    rng = np.random.default_rng(7)
    for n in (1, 16, 256, 4096, 1 << 20):
        cols = rs_cuda._adv_columns(n)
        for x in rng.integers(0, 1 << 32, 4, dtype=np.uint64):
            x = int(x)
            got = 0
            for i in range(32):
                if (x >> i) & 1:
                    got ^= int(cols[i])
            assert got == j_crc.advance(x, n)


def test_k2_geometry():
    assert rs_cuda.k2_geometry(4, 10, 1 << 20) == (4096, 16)
    assert rs_cuda.k2_geometry(4, 10, 50) == (1024, 16)
    assert rs_cuda.k2_geometry(1, 3, 1) == (2048, 32)
    assert rs_cuda.k2_geometry(16, 10, 1 << 20) == (4096, 8)
    tile, sub = rs_cuda.k2_geometry(16, 40, 1 << 20)
    assert tile < 4096 and rs_cuda._smem_bytes(16, 40, tile, sub) <= rs_cuda.MAX_SMEM
    # two blocks per SM at RS(10,4): 228 KiB per SM, 1 KiB reserved each
    assert 2 * (rs_cuda._smem_bytes(4, 10, 4096, 16) + 1024) <= 228 * 1024
    with pytest.raises(ValueError):
        rs_cuda.k2_geometry(16, 255, 1 << 20)


# -- the kernels' table steps, emulated in numpy -------------------------------


def _byte_perm(x, y, sel):
    """CUDA's __byte_perm(x, y, sel) on uint32 arrays."""
    src = [(x >> np.uint32(8 * i)) & np.uint32(0xFF) for i in range(4)] + \
          [(y >> np.uint32(8 * i)) & np.uint32(0xFF) for i in range(4)]
    out = np.zeros_like(x)
    for n in range(4):
        out |= src[(sel >> (4 * n)) & 7] << np.uint32(8 * n)
    return out


def _offsets(v, e):
    """gf_core.cuh's lookup offsets for byte e of words v: (low, high)
    nibble as 16-word table indices."""
    lo = (v << np.uint32(2)) & np.uint32(0x3C3C3C3C)
    hi = (v >> np.uint32(2)) & np.uint32(0x3C3C3C3C)
    sh = np.uint32(8 * e)
    mask = np.uint32(0xFF)
    return ((lo >> sh) & mask) // 4, ((hi >> sh) & mask) // 4


def _emulate_gf(tables, data):
    """gf_mac over every input row, then gf_rows: (d, L) bytes, L % 4 == 0
    -> (4G, L) bytes."""
    d, groups = tables.shape[:2]
    words = np.ascontiguousarray(data).view("<u4")
    acc = np.zeros((4, groups, words.shape[1]), dtype=np.uint32)
    for j in range(d):
        for e in range(4):
            il, ih = _offsets(words[j], e)
            for g in range(groups):
                acc[e, g] ^= tables[j, g, 0, il] ^ tables[j, g, 1, ih]
    rows = []
    for g in range(groups):
        t0 = _byte_perm(acc[0, g], acc[1, g], 0x5140)
        t1 = _byte_perm(acc[2, g], acc[3, g], 0x5140)
        t2 = _byte_perm(acc[0, g], acc[1, g], 0x7362)
        t3 = _byte_perm(acc[2, g], acc[3, g], 0x7362)
        rows += [_byte_perm(t0, t1, 0x5410), _byte_perm(t0, t1, 0x7632),
                 _byte_perm(t2, t3, 0x5410), _byte_perm(t2, t3, 0x7632)]
    return np.stack(rows).view(np.uint8)


def _nib_apply(m, x):
    """gf_core.cuh nib_apply for one uint32 x and an (8, 16) map."""
    r = 0
    for k in range(8):
        r ^= int(m[k, (x >> (4 * k)) & 15])
    return r


def _table_matrices():
    survivors = [1, 2, 3, 4, 6, 7, 8, 9, 10, 12]
    return {
        "parity": PARITY,
        "rebuild4": np.ascontiguousarray(j_rs_numpy.decode_rows(
            10, 14, survivors, (0, 5, 11, 13))),
        "decode1": np.ascontiguousarray(j_rs_numpy.decode_rows(
            10, 14, [0, 1, 2, 4, 5, 6, 7, 8, 9, 10], (3,))),
        "random16": _bytes(16, (16, 10)),
    }


@pytest.mark.parametrize("name", ["parity", "rebuild4", "decode1",
                                  "random16"])
def test_gf_tables_decode_to_jax_products(name):
    m = _table_matrices()[name]
    p, d = m.shape
    tables = rs_cuda.gf_tables(m)
    groups = -(-p // 4)
    assert tables.shape == (d, groups, 2, 16) and tables.dtype == np.uint32
    mt = j_gf256.mul_table()
    low, high = j_gf256.nibble_tables()
    n = np.arange(16)
    for j in range(d):
        for g in range(groups):
            for q in range(4):
                lo = (tables[j, g, 0] >> np.uint32(8 * q)) & np.uint32(0xFF)
                hi = (tables[j, g, 1] >> np.uint32(8 * q)) & np.uint32(0xFF)
                i = 4 * g + q
                if i >= p:
                    assert not lo.any() and not hi.any()
                    continue
                assert np.array_equal(lo, mt[m[i, j], n])
                assert np.array_equal(hi, mt[m[i, j], n << 4])
                assert np.array_equal(lo, low[m[i, j]])
                assert np.array_equal(hi, high[m[i, j]])


@pytest.mark.parametrize("name", ["parity", "rebuild4", "decode1",
                                  "random16"])
def test_gf_table_step_equals_jax_apply(name):
    """The kernels' lookup and byte-transpose steps, run in numpy on the
    packed tables, give the JAX package's GF apply."""
    m = _table_matrices()[name]
    data = _bytes(len(name), (10, 64))
    got = _emulate_gf(rs_cuda.gf_tables(m), data)
    assert np.array_equal(got[:m.shape[0]],
                          j_rs_numpy.gf_apply_matrix(m, data))
    assert not got[m.shape[0]:].any()


def test_nibble_maps_apply_the_advance():
    rng = np.random.default_rng(9)
    for n in (4, 16, 256, 4096):
        m = rs_cuda.nibble_map(rs_cuda._adv_columns(n))
        for x in rng.integers(0, 1 << 32, 4, dtype=np.uint64):
            assert _nib_apply(m, int(x)) == j_crc.advance(int(x), n)


def _kernel_crc(row, tile, sub):
    """The raw CRC of `row` as K2 and K8 run it (crc_core.cuh), in numpy:
    the row front-padded to whole tiles; each sub-segment CRC'd as four
    interleaved streams of 4-byte words through the Adv_4 nibble map, the
    streams joined with Adv_{T/4S} and Adv_{T/2S}; the sub-segments folded
    in the shuffle tree's order with the Adv_{T/S 2^k} maps; the tiles
    folded with Adv_T."""
    length = len(row)
    maps = rs_cuda.crc_maps(tile, sub)
    assert maps.shape == (3 + sub.bit_length() - 1, 8, 16)
    ntiles = -(-length // tile)
    padded = np.zeros(ntiles * tile, dtype=np.uint8)
    padded[ntiles * tile - length:] = row
    words = padded.view("<u4").reshape(ntiles, sub, rs_cuda.K2_STREAMS, -1)
    crc = 0
    for t in range(ntiles):
        parts = []
        for s in range(sub):
            sk = []
            for stream in words[t, s]:
                st = 0
                for w in stream:
                    st = _nib_apply(maps[0], st ^ int(w))
                sk.append(st)
            parts.append(_nib_apply(maps[2], _nib_apply(maps[1], sk[0])
                                    ^ sk[1])
                         ^ _nib_apply(maps[1], sk[2]) ^ sk[3])
        for k in range(sub.bit_length() - 1):  # lane s takes lane s + 2^k
            parts = [_nib_apply(maps[3 + k], parts[i]) ^ parts[i + 1]
                     for i in range(0, len(parts), 2)]
        crc = j_crc.advance(crc, tile) ^ parts[0]
    return crc


@pytest.mark.parametrize("length", [1, 7, 256, 4096 + 3])
def test_crc_table_step_equals_jax_raw_update(length):
    """K2's CRC as the kernel runs it (_kernel_crc) at K2's geometry."""
    row = _bytes(length, length)
    tile, sub = rs_cuda.k2_geometry(4, 10, length)
    assert _kernel_crc(row, tile, sub) == j_crc.raw_update(0, row.tobytes())


def test_k8_geometry():
    assert rs_cuda.k8_geometry(1 << 20) == (4096, 32)
    assert rs_cuda.k8_geometry(4097) == (4096, 32)
    assert rs_cuda.k8_geometry(2048) == (2048, 32)
    assert rs_cuda.k8_geometry(1000) == (1024, 16)
    assert rs_cuda.k8_geometry(16) == (64, 1)
    assert rs_cuda.k8_geometry(1) == (64, 1)
    for length in (1, 16, 100, 1000, 2048, 1 << 20):
        tile, sub = rs_cuda.k8_geometry(length)
        assert tile % (16 * rs_cuda.K2_STREAMS * sub) == 0
        # at least two blocks per SM: 228 KiB per SM, 1 KiB reserved each
        assert 2 * (rs_cuda._k8_smem_bytes(tile, sub) + 1024) <= 228 * 1024


@pytest.mark.parametrize("length", [1, 16, 100, 1000, 2048 + 5, 4096 * 3])
def test_k8_crc_step_equals_jax_raw_update(length):
    """K8's CRC as the kernel runs it (_kernel_crc) at K8's geometry."""
    row = _bytes(length + 7, length)
    tile, sub = rs_cuda.k8_geometry(length)
    assert _kernel_crc(row, tile, sub) == j_crc.raw_update(0, row.tobytes())


@pytest.mark.parametrize("batch,rows,length", [(1, 1, 16), (3, 18, 4096),
                                               (2, 14, 1001)])
def test_crc32c_rows_plain_equals_batched_raw_and_jax(batch, rows, length):
    """K8's plain version (the host's native CRC per row) on a permuted
    slab view: the raw images of batched_crc32c_raw and of the JAX
    package's raw_update, written into `out` when given."""
    slab = torch.from_numpy(_bytes(length, (rows, batch, length)))
    view = slab.permute(1, 0, 2)
    got = rs_cuda.crc32c_rows(view)
    assert got.dtype == torch.int64 and got.shape == (batch, rows)
    assert torch.equal(got, t_crc_device.batched_crc32c_raw(view))
    assert got[-1, -1].item() == j_crc.raw_update(
        0, view[-1, -1].numpy().tobytes())
    out = torch.empty((batch, rows), dtype=torch.int64)
    assert rs_cuda.crc32c_rows(view, out=out) is out
    assert torch.equal(out, got)
    with pytest.raises(ValueError):
        rs_cuda.crc32c_rows(view, out=torch.empty((batch, rows + 1),
                                                  dtype=torch.int64))
    with pytest.raises(ValueError):
        rs_cuda.crc32c_rows(slab[0])


@pytest.mark.parametrize("ntiles", [1, 5, 33, 100])
def test_tile_fold_order_equals_sequential_fold(ntiles):
    """fold_kernel's order, in numpy: virtual zero tiles in front up to
    32 m, lane l Horner-folds tiles 32 q + l with Adv_{32 T}, a shuffle
    tree joins lanes with Adv_{T 2^k}; equal to folding the tiles in
    order with Adv_T."""
    tile = 4096
    rng = np.random.default_rng(ntiles)
    parts = [int(x) for x in rng.integers(0, 1 << 32, ntiles,
                                          dtype=np.uint64)]
    want = 0
    for v in parts:
        want = j_crc.advance(want, tile) ^ v
    maps = [rs_cuda.nibble_map(rs_cuda._adv_columns(n))
            for n in [32 * tile] + [tile << k for k in range(5)]]
    m = -(-ntiles // 32)
    lead = 32 * m - ntiles
    lanes = []
    for lane in range(32):
        acc = 0
        for q in range(m):
            t = 32 * q + lane - lead
            acc = _nib_apply(maps[0], acc) ^ (parts[t] if t >= 0 else 0)
        lanes.append(acc)
    for k in range(5):
        lanes = [_nib_apply(maps[1 + k], lanes[i]) ^ lanes[i + 1]
                 for i in range(0, len(lanes), 2)]
    assert lanes[0] == want


# -- K1 -------------------------------------------------------------------------


@pytest.mark.parametrize("length", [1, 7, 4096, 8192 + 3])
def test_gf_apply_plain_equals_pallas_and_swar(length):
    data = _bytes(length, (10, length))
    rows = j_rs_numpy.decode_rows(10, 14, [0, 1, 2, 4, 5, 6, 7, 8, 9, 10],
                                  (3, 12))
    for m in (PARITY, np.ascontiguousarray(rows)):
        got = rs_torch.apply_matrix(m, torch.from_numpy(data)).numpy()
        assert np.array_equal(got, np.asarray(
            j_rs_pallas.apply_matrix_pallas(m, data, interpret=True)))
        assert np.array_equal(got, np.asarray(
            j_rs_jax.apply_matrix(m, data, method="swar")))


def test_gf_apply_plain_batched_and_many_rows():
    data = _bytes(3, (2, 10, 300))
    got = rs_cuda.gf_apply_plain(PARITY, torch.from_numpy(data)).numpy()
    for b in range(2):
        assert np.array_equal(got[b], j_rs_numpy.gf_apply_matrix(PARITY,
                                                                 data[b]))
    wide = _bytes(4, (20, 10))  # more rows than one launch takes
    x = _bytes(5, (10, 33))
    assert np.array_equal(rs_cuda.gf_apply(wide, torch.from_numpy(x)).numpy(),
                          j_rs_numpy.gf_apply_matrix(wide, x))


def test_wrappers_validate_inputs():
    with pytest.raises(ValueError):
        rs_cuda.gf_apply(PARITY, torch.zeros((9, 8), dtype=torch.uint8))
    with pytest.raises(ValueError):
        rs_cuda.gf_apply(PARITY, torch.zeros((10, 8), dtype=torch.int32))
    with pytest.raises(ValueError):
        rs_cuda.fused_apply_crc(PARITY, torch.zeros((10, 8),
                                                    dtype=torch.uint8))
    with pytest.raises(ValueError):
        rs_cuda.fused_apply_crc(PARITY, torch.zeros((1, 10, 0),
                                                    dtype=torch.uint8))


# -- K2 -------------------------------------------------------------------------


@pytest.mark.parametrize("batch,length,block",
                         [(1, 512, None), (2, 2048, 512), (2, 4096, 512),
                          (1, 16384, None)])
def test_fused_encode_words_equals_pallas(batch, length, block):
    data = _bytes(batch * length, (batch, 10, length))
    want_w, want_crc = j_rs_pallas.fused_encode_words(
        PARITY, data.view(np.int32), block=block, interpret=True)
    got_w, got_crc = rs_cuda.fused_encode_words(
        PARITY, torch.from_numpy(data.view(np.int32)))
    assert got_w.dtype == torch.int32
    assert np.array_equal(got_w.numpy(), np.asarray(want_w))
    assert np.array_equal(got_crc.numpy().astype(np.uint32),
                          np.asarray(want_crc))


@pytest.mark.parametrize("length", [1, 50, 1001, 4099])
def test_fused_apply_crc_equals_xla_encode_step(length):
    data = _bytes(length, (2, 10, length))
    bm = jnp.asarray(j_rs_jax._bit_matrix_cached(*j_rs_jax._matrix_key(PARITY)))
    want_par, want_crc = j_mesh.batched_encode_step(bm, jnp.asarray(data))
    got_par, got_crc = rs_cuda.fused_apply_crc(PARITY, torch.from_numpy(data))
    assert np.array_equal(got_par.numpy(), np.asarray(want_par))
    assert np.array_equal(got_crc.numpy().astype(np.uint32),
                          np.asarray(want_crc))


@pytest.mark.parametrize("length", [7, 1001])
def test_rebuild_step_equals_sharded_apply(length):
    survivors = [1, 2, 3, 4, 6, 7, 8, 9, 10, 12]
    matrix = np.array(j_rs_numpy.decode_rows(10, 14, survivors,
                                             (0, 5, 11, 13)))
    data = _bytes(length + 1, (2, 10, length))
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                             ("data", "block"))
    want_out, want_crc = j_mesh.make_sharded_apply(mesh, matrix)(
        jnp.asarray(data))
    got_out, got_crc = t_mesh.make_sharded_apply(matrix)(
        torch.from_numpy(data))
    assert np.array_equal(got_out.numpy(), np.asarray(want_out))
    assert np.array_equal(got_crc.numpy().astype(np.uint32),
                          np.asarray(want_crc))


def test_encode_batch_matches_host_codec():
    data = _bytes(11, (3, 10, 4096))
    parity, crcs = t_mesh.encode_batch(data, device="cpu")
    for b in range(3):
        expect = j_rs_numpy.gf_apply_matrix(PARITY, data[b])
        assert np.array_equal(parity[b], expect)
        full = np.concatenate([data[b], expect])
        for s in range(14):
            assert int(crcs[b, s]) == j_crc.crc32c(full[s])


# -- the Encoder seam -----------------------------------------------------------


def _shards(seed, length=1000):
    data = _bytes(seed, (10, length))
    return j_rs_numpy.NumpyEncoder(10, 4).encode(list(data) + [None] * 4)


@pytest.mark.parametrize("lost", [(0,), (3, 12), (0, 5, 11, 13),
                                  (10, 11, 12, 13)])
def test_encoder_seam_equals_numpy_encoder(lost):
    ref = j_rs_numpy.NumpyEncoder(10, 4)
    enc = t_codec.new_encoder(10, 4, backend="torch")
    full = _shards(sum(lost))
    data = list(full[:10]) + [None] * 4
    assert all(np.array_equal(a, b) for a, b in
               zip(enc.encode(list(data)), ref.encode(list(data))))
    assert enc.verify(full) and ref.verify(full)
    damaged = [None if i in lost else s for i, s in enumerate(full)]
    for method in ("reconstruct", "reconstruct_data"):
        got = getattr(enc, method)(list(damaged))
        want = getattr(ref, method)(list(damaged))
        for g, w in zip(got, want):
            assert (g is None and w is None) or np.array_equal(g, w), method


@pytest.mark.parametrize("target", [0, 3, 11])
def test_reconstruct_span_equals_jax(target):
    full = _shards(target, length=5000)
    survivors = [i for i in range(14) if i != target][:10]
    inputs = np.stack([full[i] for i in survivors])
    got = t_codec.reconstruct_span(survivors, inputs, target, device="cpu")
    want = j_codec.reconstruct_span(survivors, inputs, target)
    assert np.array_equal(got, want)
    assert np.array_equal(got, full[target])


def test_numpy_backend_and_unknown_backend():
    assert isinstance(t_codec.new_encoder(10, 4, backend="numpy"),
                      t_rs_numpy.NumpyEncoder)
    with pytest.raises(ValueError):
        t_codec.new_encoder(10, 4, backend="nope")


@pytest.mark.parametrize("backend", ["jax", "tpu"])
def test_jax_codec_names_give_the_device_codec(backend, monkeypatch):
    """The JAX package's device codec names resolve to the port's
    TorchEncoder on `device`; its parity and reconstruction equal the
    JAX package's codec of the same name.  Without a card and without
    device="cpu" the codec raises."""
    enc = t_codec.new_encoder(10, 4, backend=backend, device="cpu")
    assert isinstance(enc, rs_torch.TorchEncoder)
    assert enc.device == torch.device("cpu")
    ref = j_codec.new_encoder(10, 4, backend=backend)
    full = _shards(7)
    data = list(full[:10]) + [None] * 4
    got, want = enc.encode(list(data)), ref.encode(list(data))
    assert all(np.array_equal(np.asarray(a), np.asarray(b))
               for a, b in zip(got, want))
    damaged = [None if i in (0, 5, 11, 13) else s for i, s in enumerate(full)]
    for g, w in zip(enc.reconstruct(list(damaged)),
                    ref.reconstruct(list(damaged))):
        assert np.array_equal(np.asarray(g), np.asarray(w))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_codec.new_encoder(10, 4, backend=backend)


# -- K7: the portable step formulations ------------------------------------------

K7_LENGTHS = [4096, 1, 7, 4099]


@pytest.mark.parametrize("p", [1, 2, 3, 4])
@pytest.mark.parametrize("length", K7_LENGTHS)
@pytest.mark.parametrize("method", ["swar", "mxu", "pallas"])
def test_k7_apply_matrix_methods_equal_jax(method, length, p):
    """rs_torch.apply_matrix(method=) and its single-formulation entry
    points against rs_jax's, bit-exact, for a (p, 10) matrix over a
    (10, L) stack; on the CPU each method runs its own formulation."""
    m = np.ascontiguousarray(_bytes(100 + p, (p, 10)))
    data = _bytes(length + p, (10, length))
    want = np.asarray(j_rs_jax.apply_matrix(m, data, method=method))
    got = rs_torch.apply_matrix(m, torch.from_numpy(data), method=method)
    assert np.array_equal(got.numpy(), want)
    out = torch.empty((p, length), dtype=torch.uint8)
    assert rs_torch.apply_matrix(m, torch.from_numpy(data), out=out,
                                 method=method) is out
    assert np.array_equal(out.numpy(), want)
    if method != "pallas":
        single = {"swar": (rs_torch.apply_matrix_swar,
                           j_rs_jax.apply_matrix_swar),
                  "mxu": (rs_torch.apply_matrix_mxu,
                          j_rs_jax.apply_matrix_mxu)}[method]
        assert np.array_equal(
            single[0](m, torch.from_numpy(data)).numpy(),
            np.asarray(single[1](m, jnp.asarray(data))))


@pytest.mark.parametrize("method", ["swar", "mxu", "pallas"])
def test_k7_encoder_method_equal_jax(method):
    """TorchEncoder(method=) against JaxEncoder(method=): encode, then
    reconstruct of two data and two parity shards."""
    shards = [_bytes(200 + i, (1001,)) for i in range(10)] + [None] * 4
    te = rs_torch.TorchEncoder(device="cpu", method=method)
    je = j_rs_jax.JaxEncoder(method=method)
    assert te.method == je.method == method
    t_full = te.encode(list(shards))
    j_full = je.encode(list(shards))
    assert all(np.array_equal(np.asarray(a), np.asarray(b))
               for a, b in zip(t_full, j_full))
    lost = list(t_full)
    for i in (0, 5, 11, 13):
        lost[i] = None
    back = te.reconstruct(list(lost))
    assert all(np.array_equal(np.asarray(a), np.asarray(b))
               for a, b in zip(back, j_full))
    with pytest.raises(ValueError):
        rs_torch.TorchEncoder(device="cpu", method="nope")


def _j_mesh1():
    return j_mesh.make_mesh(jax.devices("cpu")[:1])


@pytest.mark.parametrize("p", [1, 2, 3, 4])
@pytest.mark.parametrize("length", K7_LENGTHS)
def test_k7_batched_steps_equal_jax(length, p):
    """batched_encode_step, batched_swar_encode_step (L % 4 == 0) and
    _parity_bits_matmul against parallel/mesh.py's, bit-exact: parity
    and the (B, 10 + p) raw CRC images of a (2, 10, L) batch."""
    m = np.ascontiguousarray(PARITY[:p])
    bm = j_gf256.coeff_bit_matrix(m).astype(np.int8)
    data = _bytes(300 + length, (2, 10, length))
    x = torch.from_numpy(data)
    j_par, j_crc = j_mesh.batched_encode_step(jnp.asarray(bm),
                                              jnp.asarray(data))
    t_par, t_crc = t_mesh.batched_encode_step(bm, x)
    assert np.array_equal(t_par.numpy(), np.asarray(j_par))
    assert np.array_equal(t_crc.numpy(), np.asarray(j_crc).astype(np.int64))
    assert np.array_equal(t_mesh._parity_bits_matmul(bm, x).numpy(),
                          np.asarray(j_mesh._parity_bits_matmul(
                              jnp.asarray(bm), jnp.asarray(data))))
    if length % 4 == 0:
        consts = j_rs_jax._bit_constants_cached(*j_rs_jax._matrix_key(m))
        js_par, js_crc = j_mesh.batched_swar_encode_step(
            jnp.asarray(consts), jnp.asarray(data))
        ts_par, ts_crc = t_mesh.batched_swar_encode_step(consts, x)
        assert np.array_equal(ts_par.numpy(), np.asarray(js_par))
        assert np.array_equal(ts_crc.numpy(),
                              np.asarray(js_crc).astype(np.int64))


@pytest.mark.parametrize("length", K7_LENGTHS)
def test_k7_sharded_encoder_forms_equal_jax(length):
    """make_sharded_encoder(words=False) against the reference's portable
    step on a one-device CPU mesh, and the words=True form (K2) against
    both; make_mesh resolves the CPU."""
    data = _bytes(400 + length, (2, 10, length))
    want_par, want_crc = j_mesh.make_sharded_encoder(
        _j_mesh1(), words=False)(jnp.asarray(data))
    for words in (False, True):
        par, crc = t_mesh.make_sharded_encoder(words=words)(
            torch.from_numpy(data))
        assert np.array_equal(par.numpy(), np.asarray(want_par))
        assert np.array_equal(crc.numpy(),
                              np.asarray(want_crc).astype(np.int64))
    assert t_mesh.make_mesh("cpu") == [torch.device("cpu")]
    assert t_mesh.make_mesh(["cpu", "cpu"]) == [torch.device("cpu")] * 2
