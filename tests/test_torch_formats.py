"""Port parity: record codecs and the chunk store against the JAX package.

The same numpy inputs go through ``repro`` (JAX on the CPU) and
``repro_torch``.  ``decode_ref`` must agree bit for bit: both decode each
field with one fused multiply-add per digit in digit order, so no tolerance
is needed.  A store written by either package opens in the other with the
same manifest, and a corrupted chunk fails its CRC32 in both.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import chunkstore as j_cs
from repro.data import formats as j_fmt
from repro.data import generator as j_gen
from repro.data.faults import CorruptChunkError as JCorrupt
from repro_torch.data import chunkstore as t_cs
from repro_torch.data import formats as t_fmt
from repro_torch.data import generator as t_gen
from repro_torch.data.faults import CorruptChunkError as TCorrupt


def _values(n, c, seed):
    rng = np.random.default_rng(seed)
    v = j_gen.make_synthetic_zipf(n, c, seed=seed)
    # signs and fractions on top of the zipf grid
    return v * rng.choice([-1.0, 1.0], size=v.shape) + rng.random(v.shape)


@pytest.mark.parametrize("c,seed", [(8, 0), (16, 1), (5, 2)])
def test_ascii_decode_matches_reference_bit_for_bit(c, seed):
    v = _values(2048, c, seed)
    raw = j_fmt.AsciiFixedFormat(c).encode(v)
    assert np.array_equal(raw, t_fmt.AsciiFixedFormat(c).encode(v))
    want = np.asarray(jax.jit(jax.vmap(j_fmt.AsciiFixedFormat(c).decode_ref))(
        jnp.asarray(raw.reshape(4, 512, -1))))
    got = t_fmt.AsciiFixedFormat(c).decode_ref(
        torch.from_numpy(raw.reshape(4, 512, -1))).numpy()
    assert got.dtype == np.float32
    assert np.array_equal(got, want)


def test_binary_decode_matches_reference():
    v = _values(512, 6, 3).astype(np.float32)
    raw = j_fmt.BinaryBigEndianFormat(6).encode(v)
    want = np.asarray(j_fmt.BinaryBigEndianFormat(6).decode_ref(
        jnp.asarray(raw)))
    got = t_fmt.BinaryBigEndianFormat(6).decode_ref(
        torch.from_numpy(raw)).numpy()
    assert np.array_equal(got, want)
    assert np.array_equal(got, v)


def test_codec_geometry_and_cost_match():
    for cls in ("AsciiFixedFormat", "BinaryBigEndianFormat"):
        a, b = getattr(j_fmt, cls)(16), getattr(t_fmt, cls)(16)
        assert a.record_bytes == b.record_bytes
        assert a.extract_cost_per_tuple() == b.extract_cost_per_tuple()
    assert (j_fmt.FIELD_BYTES, j_fmt.INT_DIGITS, j_fmt.FRAC_DIGITS) == (
        t_fmt.FIELD_BYTES, t_fmt.INT_DIGITS, t_fmt.FRAC_DIGITS)


@pytest.mark.parametrize("uneven", [False, True])
def test_generator_and_store_match(uneven):
    jv = j_gen.make_synthetic_zipf(3000, 8, seed=4)
    tv = t_gen.make_synthetic_zipf(3000, 8, seed=4)
    assert np.array_equal(jv, tv)
    js = j_gen.store_dataset(jv, 12, "ascii", uneven=uneven, seed=4)
    ts = t_gen.store_dataset(tv, 12, "ascii", uneven=uneven, seed=4)
    assert np.array_equal(js.chunk_sizes, ts.chunk_sizes)
    for j in range(js.num_chunks):
        assert np.array_equal(js.chunk_bytes(j), ts.chunk_bytes(j))
        assert js.meta[j].crc32 == ts.meta[j].crc32
    packed, sizes = ts.packed_device_view("cpu")
    j_packed, j_sizes = js.packed_device_view()
    assert packed.dtype == torch.uint8
    assert np.array_equal(packed.numpy(), j_packed)
    assert np.array_equal(sizes, j_sizes)


@pytest.mark.parametrize("writer", ["repro", "repro_torch"])
def test_disk_store_opens_across_packages(tmp_path, writer):
    vals = j_gen.make_synthetic_zipf(1024, 4, seed=5)
    gen, other = (j_gen, t_cs) if writer == "repro" else (t_gen, j_cs)
    store = gen.store_dataset(vals, 8, "ascii", name="t",
                              directory=str(tmp_path))
    reopened = other.ChunkStore.open(str(tmp_path), "t")
    with open(tmp_path / "t.manifest.json") as f:
        manifest = json.load(f)
    assert manifest["codec"] == "AsciiFixedFormat"
    assert [m.crc32 for m in reopened.meta] == [
        c["crc32"] for c in manifest["chunks"]]
    assert np.array_equal(reopened.chunk_sizes, store.chunk_sizes)
    for j in range(store.num_chunks):
        assert np.array_equal(reopened.chunk_bytes(j), store.chunk_bytes(j))


@pytest.mark.parametrize("pkg", ["repro", "repro_torch"])
def test_corrupt_chunk_fails_crc_in_both(tmp_path, pkg):
    vals = j_gen.make_synthetic_zipf(512, 4, seed=6)
    j_gen.store_dataset(vals, 4, "ascii", name="c", directory=str(tmp_path))
    path = tmp_path / "c.chunk00002.bin"
    data = bytearray(path.read_bytes())
    data[7] ^= 0x01
    path.write_bytes(bytes(data))
    cs, err = (j_cs, JCorrupt) if pkg == "repro" else (t_cs, TCorrupt)
    store = cs.ChunkStore.open(str(tmp_path), "c")
    store.chunk_bytes(1)
    with pytest.raises(err) as exc:
        store.chunk_bytes(2)
    assert exc.value.chunk_id == 2
    assert os.path.exists(path)
