"""The port's `.huffman` codec copies and B12's plain version vs the
JAX package, on the CPU, bit for bit.

* `preprocess_las` (and the preprocessor's `main`, which picks the
  writer by the output's extension) writes a `.huffman` byte-identical
  to the reference's; `encode_batch` (C++ and NumPy paths) and the C++
  encoder, decoder and fused transcode give the reference's arrays;
  `transcode_huffman_to_tpc` writes the reference's `.tpc`.
* `transcode_ref_batch` retries only a too-narrow buffer, up to the
  widest fbatch stream, and raises on any other return code (ROADMAP
  C3: the reference doubles the buffer on any nonzero code, unbounded).
* `decode_ref_plain` equals `decode_batches_core` on a real file at
  points 64 and 48 and on every crafted kind of `crafted.huffman_batches`
  (at 64, and its 48-point prefix; the last four kinds aim at B12's
  staging); the kinds reach their corners; a
  CPU tensor takes the plain version and launches nothing.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcrhpg24_tpu import native as ref_native
from pcrhpg24_tpu.codec import batch_codec as ref_codec
from pcrhpg24_tpu.formats.huffman_file import read_batch as ref_read_batch
from pcrhpg24_tpu.formats.huffman_file import read_file_header as ref_read_header
from pcrhpg24_tpu.formats.las import write_las
from pcrhpg24_tpu.formats.native_file import transcode_huffman_to_tpc as ref_transcode
from pcrhpg24_tpu.preprocess import preprocess_las as ref_preprocess
from pcrhpg24_tpu.render.decode_jax import batches_to_device, decode_batches
from pcrhpg24_tpu.utils.synthetic import cloud_to_grid, terrain_cloud
from pcrhpg24_tpu_torch import native
from pcrhpg24_tpu_torch import preprocess as port_preprocess
from pcrhpg24_tpu_torch.codec import batch_codec
from pcrhpg24_tpu_torch.formats.huffman_file import read_batch, read_file_header
from pcrhpg24_tpu_torch.formats.native_file import transcode_huffman_to_tpc
from pcrhpg24_tpu_torch.kernels import build
from pcrhpg24_tpu_torch.render.decode_huffman import decode_ref_batches, decode_ref_plain
from pcrhpg24_tpu_torch.tools import crafted
from pcrhpg24_tpu_torch.u32 import from_u32
from tests.torch_fixtures import one_torch_thread  # noqa: F401  (autouse)

KEYS = ("encoding", "enc_offsets", "cluster_sizes", "separate", "sep_offsets",
        "separate_sizes", "table_values", "table_cw_len", "start_values")


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """A two-batch `.huffman` with a ragged tail (the reference writes it)."""
    d = tmp_path_factory.mktemp("thuf")
    las, huf = str(d / "t.las"), str(d / "t.huffman")
    xyz, rgb = terrain_cloud(2 * 65536 - 700, seed=5, extent=600.0)
    grid = cloud_to_grid(xyz)
    write_las(las, grid[:, 0], grid[:, 1], grid[:, 2], rgb)
    ref_preprocess(las, huf, sort=True, verbose=False)
    hdr = ref_read_header(huf)
    return las, huf, [ref_read_batch(huf, hdr, i) for i in range(hdr.num_batches)]


def _port_args(dev: dict):
    return [from_u32(dev[k]) if k == "encoding" else torch.from_numpy(np.array(dev[k]))
            for k in KEYS]


def _chain_major(coords: torch.Tensor) -> np.ndarray:
    """(B, points, 3, 8, 128) -> the reference's (B, 1024, points, 3)."""
    B, P = coords.shape[:2]
    return coords.numpy().reshape(B, P, 3, 1024).transpose(0, 3, 1, 2)


def test_huffman_writer_byte_identical(files, tmp_path):
    las, want, ref_batches = files
    got = str(tmp_path / "port.huffman")
    port_preprocess.preprocess_las(las, got, sort=True, verbose=False)
    assert native.available()  # the streams came from the port's C++ core
    with open(want, "rb") as f, open(got, "rb") as g:
        assert f.read() == g.read()
    hdr = read_file_header(got)
    assert hdr.num_batches == 2
    for i, rb in enumerate(ref_batches):
        pb = read_batch(got, hdr, i)
        for f in dataclasses.fields(rb):
            np.testing.assert_array_equal(getattr(pb, f.name), getattr(rb, f.name))


@pytest.mark.parametrize("ext,args", [(".huffman", []), (".tpc", ["1", "huffman"])])
def test_preprocess_main_picks_the_writer(files, tmp_path, ext, args):
    las, huf, _ = files
    out = str(tmp_path / f"port{ext}")
    assert port_preprocess.main([las, out, *args]) == 0
    if ext == ".huffman":
        want = open(huf, "rb").read()
    else:
        from pcrhpg24_tpu.preprocess import preprocess_las_tpc

        ref_out = str(tmp_path / "ref.tpc")
        preprocess_las_tpc(las, ref_out, sort=True, verbose=False, codec="huffman")
        want = open(ref_out, "rb").read()
        assert want[:4] == b"TPC1"
    assert open(out, "rb").read() == want


@pytest.mark.parametrize("path", ["cpp", "numpy"])
def test_encode_batch_equals_reference(path, monkeypatch):
    rng = np.random.default_rng(11)
    steps = rng.integers(-90, 90, (65536, 3))
    steps += rng.integers(-(2**22), 2**22, (65536, 3)) * (rng.random((65536, 1)) < 0.01)
    pts = np.cumsum(steps, axis=0).astype(np.int32)
    want = ref_codec.encode_batch(pts[:, 0], pts[:, 1], pts[:, 2])
    if path == "numpy":
        monkeypatch.setattr(native, "available", lambda: False)
    got = batch_codec.encode_batch(pts[:, 0], pts[:, 1], pts[:, 2])
    assert len(want.separate) > 0  # the 2**22 jumps escape
    for f in dataclasses.fields(want):
        np.testing.assert_array_equal(getattr(got, f.name), getattr(want, f.name),
                                      err_msg=f.name)


def test_cpp_codec_equals_reference(files):
    _las, _huf, batches = files
    for b in batches:
        deltas = ref_native.decode_ref_batch_deltas(
            b.encoding, b.cluster_sizes, b.separate, b.separate_sizes,
            b.decoder_values, b.decoder_cw_len)
        got = native.decode_ref_batch_deltas(
            b.encoding, b.cluster_sizes, b.separate, b.separate_sizes,
            b.decoder_values, b.decoder_cw_len)
        np.testing.assert_array_equal(got, deltas)
        for g, w in zip(native.transcode_ref_batch(b), ref_native.transcode_ref_batch(b)):
            np.testing.assert_array_equal(g, w)
    # the C++ encoder on the last batch's deltas and one symbol table
    from pcrhpg24_tpu.codec.huffman import build_pjn_dictionary

    dic = build_pjn_dictionary(deltas.reshape(-1))
    keys = np.array(sorted(dic.codes), np.int64)
    codes = np.array([dic.codes[int(k)][0] for k in keys], np.uint32)
    lens = np.array([dic.codes[int(k)][1] for k in keys], np.int32)
    want = ref_native.encode_ref_batch_streams(deltas, keys.astype(np.int32), codes, lens)
    got = native.encode_ref_batch_streams(deltas, keys.astype(np.int32), codes, lens)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("codec", ["fixed", "huffman"])
def test_transcode_to_tpc_byte_identical(files, tmp_path, codec):
    _las, huf, _ = files
    want, got = str(tmp_path / "ref.tpc"), str(tmp_path / "port.tpc")
    ref_transcode(huf, want, verbose=False, codec=codec, workers=2)
    transcode_huffman_to_tpc(huf, got, verbose=False, codec=codec, workers=2)
    assert open(got, "rb").read() == open(want, "rb").read()


class _FakeLib:
    """A codec library whose transcode returns `rc` and records maxw."""

    def __init__(self, rc: int):
        self.rc = rc
        self.maxws = []

    def transcode_ref_batch(self, *args):
        self.maxws.append(args[-1])
        if len(self.maxws) > 50:  # the reference's unbounded retry
            raise AssertionError("transcode retried without bound")
        return self.rc


def test_transcode_retries_only_a_narrow_buffer(files, monkeypatch):
    """ROADMAP C3: a buffer too narrow is retried up to the widest
    fbatch stream (the real batch from maxw=1 gives the default's
    result); any other code raises at once; a stream still too narrow at
    the cap raises."""
    _las, _huf, batches = files
    for g, w in zip(native.transcode_ref_batch(batches[0], maxw=1),
                    native.transcode_ref_batch(batches[0])):
        np.testing.assert_array_equal(g, w)
    fake = _FakeLib(-7)
    monkeypatch.setattr(native, "_lib", fake)
    with pytest.raises(RuntimeError, match="rc -7"):
        native.transcode_ref_batch(batches[0])
    assert fake.maxws == [16384]
    fake = _FakeLib(native.TOO_NARROW)
    monkeypatch.setattr(native, "_lib", fake)
    with pytest.raises(RuntimeError, match="rc -1"):
        native.transcode_ref_batch(batches[0], maxw=1000)
    assert fake.maxws == [1000, 2000, 4000, 8000, 16000, native.MAX_FIXED_GROUP_WORDS]
    assert native.MAX_FIXED_GROUP_WORDS == 24576


@pytest.mark.parametrize("points", [64, 48])
def test_decode_plain_equals_reference_on_a_file(files, points):
    _las, _huf, batches = files
    dev = batches_to_device(batches)
    want = np.asarray(decode_batches(*(jnp.asarray(dev[k]) for k in KEYS),
                                     points_per_thread=points))
    got = decode_ref_plain(*_port_args(dev), points=points)
    assert got.shape == (2, points, 3, 8, 128) and got.dtype == torch.int32
    np.testing.assert_array_equal(_chain_major(got), want)


@pytest.fixture(scope="module")
def crafted_batches():
    return {kind: crafted.huffman_batches(kind, seed=3) for kind in crafted.HUFFMAN_KINDS}


@pytest.mark.parametrize("kind", crafted.HUFFMAN_KINDS)
def test_decode_plain_equals_reference_on_crafted(crafted_batches, kind):
    dev = crafted_batches[kind]
    want = np.asarray(decode_batches(*(jnp.asarray(dev[k]) for k in KEYS)))
    args = _port_args(dev)
    np.testing.assert_array_equal(_chain_major(decode_ref_plain(*args)), want)
    np.testing.assert_array_equal(_chain_major(decode_ref_plain(*args, points=48)),
                                  want[:, :, :48])


def test_crafted_kinds_reach_their_corners(crafted_batches):
    c = crafted_batches
    tl = {k: v["table_cw_len"] for k, v in c.items()}
    syms = 2 * 1024 * 192
    assert c["escapes"]["separate"].size > syms // 2 and (tl["escapes"] == -12).any()
    assert (tl["cw12"] == 12).all()
    assert (tl["boundary"] == 4).all() and (tl["one_symbol"] == 1).all()
    # every lane's stream a whole number of words (192 x 12, 192 x 4,
    # 192 x 1 bits): 72, 24 and 6 words a lane plus two phantoms
    for kind, words in (("cw12", 72), ("boundary", 24), ("one_symbol", 6)):
        assert (c[kind]["cluster_sizes"][:, -1] == 1024 * (words + 2)).all(), kind
    last = c["last_batch"]
    assert last["encoding"].size == (last["enc_offsets"][-1]
                                     + last["cluster_sizes"][-1, -1] - 200)
    empty = c["empty_separate"]
    assert empty["separate"].size == 0
    assert (tl["empty_separate"] == 0).any() and (tl["empty_separate"] == -3).any()
    # B12's staging corners
    uneven = c["uneven"]
    words = _per_unit(uneven["cluster_sizes"])
    assert (tl["uneven"] == 1).any() and (words[:, 0] == 32 * 6 + 64).all()
    assert (words[:, 1] == 32 * (72 + 2)).all() and (words.max(1) > 5 * words.min(1)).all()
    lane_esc = _per_unit(uneven["separate_sizes"])
    assert (lane_esc[:, 32:64] == 192).all() and (lane_esc == 0).any()
    lane_esc = _per_unit(c["escape_lane"]["separate_sizes"]).reshape(-1, 32, 32)
    assert ((lane_esc == 192).sum(2) == 1).all() and ((lane_esc == 0).sum(2) == 31).all()
    una = c["unaligned"]
    starts = una["enc_offsets"][:, None] + np.pad(una["cluster_sizes"][:, :-1], ((0, 0), (1, 0)))
    assert len(una["enc_offsets"]) >= 3 and set((starts % 4).ravel()) == {0, 1, 2, 3}
    assert una["encoding"].size % 4 and una["separate"].size % 4
    # the words each batch holds beyond what its counts claim: 40 a warp
    und = c["understated"]
    held = np.diff(np.append(und["enc_offsets"], und["encoding"].size))
    assert (held - und["cluster_sizes"][:, -1] == 40 * 32).all()
    wild = np.abs(tl["wild_lengths"])
    assert ((wild > 12).sum(1) > 100).all() and wild.max() == 40


def _per_unit(inclusive: np.ndarray) -> np.ndarray:
    """Per-warp (or per-lane) counts from inclusive prefix counts."""
    return np.diff(inclusive, axis=1, prepend=0)


def test_cpu_tensors_take_the_plain_decode(crafted_batches):
    before = build.KERNELS["pcr_decode_huffman"].launches
    args = _port_args(crafted_batches["boundary"])
    torch.testing.assert_close(decode_ref_batches(*args, points=16),
                               decode_ref_plain(*args, points=16), rtol=0, atol=0)
    assert build.KERNELS["pcr_decode_huffman"].launches == before
