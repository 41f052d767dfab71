"""The port's packed tile store (maskedsst_tpu_torch/native) on the CPU: the
native reader (g++ builds it here) against the numpy reader, bit for bit,
for every gather and the fused standardize; bounds and format errors; the
.msts format shared with the JAX package both ways; and the store as a
map-style dataset behind split_dataset, DataLoader and DeviceTileStore.
Every comparison is exact: the readers copy the same fp32 words, and the
standardize is (x - mean) * (1 / std) in fp32 in both."""

import numpy as np
import pytest

from maskedsst_tpu.native import PackedTileStore as JaxStore
from maskedsst_tpu.native import pack_tiles as jax_pack
from maskedsst_tpu_torch.data.constants import ENMAP_MEANS_CLIPPED, ENMAP_STDS_CLIPPED
from maskedsst_tpu_torch.data.device_store import DeviceTileStore
from maskedsst_tpu_torch.data.pipeline import DataLoader, split_dataset
from maskedsst_tpu_torch.data.synthetic import SyntheticCubeDataset
from maskedsst_tpu_torch.native import PackedTileStore, pack_tiles
from maskedsst_tpu_torch.native import tilestore

BANDS = 200  # the EnMAP shape, so the band tables apply
STANDARDIZE = (ENMAP_MEANS_CLIPPED[:BANDS], ENMAP_STDS_CLIPPED[:BANDS])


def _bits(a):
    return np.ascontiguousarray(a).view(np.uint32 if a.dtype == np.float32 else a.dtype)


@pytest.fixture(scope="module")
def packed(tmp_path_factory):
    """12 labeled and 5 unlabeled seeded 200-band 16x16 tiles, packed."""
    d = tmp_path_factory.mktemp("msts")
    data = SyntheticCubeDataset(num_tiles=12, n_bands=BANDS, tile_size=16, seed=3)
    unlabeled = SyntheticCubeDataset(num_tiles=5, n_bands=BANDS, tile_size=16, seed=4,
                                     labeled=False)
    pack_tiles(data, str(d / "lab.msts"))
    pack_tiles(unlabeled, str(d / "unlab.msts"))
    return data, unlabeled, d


@pytest.mark.parametrize("standardize", [None, STANDARDIZE], ids=["raw", "standardized"])
def test_native_reader_equals_numpy_reader(packed, standardize):
    data, _, d = packed
    native = PackedTileStore(str(d / "lab.msts"), standardize=standardize)
    plain = PackedTileStore(str(d / "lab.msts"), standardize=standardize, native=False)
    assert native._handle is not None and plain._handle is None
    rng = np.random.default_rng(0)
    idx = rng.integers(0, 12, 9)
    xs, ys = rng.integers(0, 16 - 8 + 1, 9), rng.integers(0, 16 - 8 + 1, 9)
    got, want = native.gather(idx), plain.gather(idx)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    np.testing.assert_array_equal(_bits(native.gather_crop(idx, xs, ys, 8)),
                                  _bits(plain.gather_crop(idx, xs, ys, 8)))
    np.testing.assert_array_equal(native.gather_labels(idx), plain.gather_labels(idx))
    raw = np.stack([data[int(i)]["img"] for i in idx])
    if standardize is None:
        np.testing.assert_array_equal(got, raw)
    else:
        mean, std = (np.asarray(v, np.float32)[:, None, None] for v in standardize)
        np.testing.assert_array_equal(got, (raw - mean) * (np.float32(1) / std))
    np.testing.assert_array_equal(native.gather_labels(idx),
                                  np.stack([data[int(i)]["label"] for i in idx]))
    crop = native.gather_crop(idx[:1], xs[:1], ys[:1], 8)[0]
    np.testing.assert_array_equal(crop, got[0][:, xs[0] : xs[0] + 8, ys[0] : ys[0] + 8])


@pytest.mark.parametrize("native", [True, False], ids=["native", "numpy"])
def test_bounds_and_format_errors(packed, native, tmp_path):
    _, _, d = packed
    store = PackedTileStore(str(d / "lab.msts"), native=native)
    with pytest.raises(IndexError, match="tile index"):
        store.gather([0, 12])
    with pytest.raises(IndexError, match="tile index"):
        store.gather_labels([-1])
    with pytest.raises(IndexError, match="crop x"):
        store.gather_crop([0], [9], [0], 8)
    with pytest.raises(IndexError, match="crop y"):
        store.gather_crop([0], [0], [-1], 8)
    with pytest.raises(KeyError, match="no labels"):
        PackedTileStore(str(d / "unlab.msts"), native=native).gather_labels([0])
    bad = tmp_path / "bad.msts"
    bad.write_bytes(b"\0" * 64)
    with pytest.raises(ValueError, match="not a version-1"):
        PackedTileStore(str(bad), native=native)


def test_failed_open_and_closed_store_raise(packed, tmp_path):
    """A truncated file passes the header check and fails ts_open: the
    native reader raises instead of falling back to numpy; so does a closed
    store."""
    _, _, d = packed
    cut = tmp_path / "cut.msts"
    cut.write_bytes((d / "lab.msts").read_bytes()[:4096])
    with pytest.raises(RuntimeError, match="ts_open failed"):
        PackedTileStore(str(cut))
    store = PackedTileStore(str(d / "lab.msts"))
    store.close()
    with pytest.raises(RuntimeError, match="closed"):
        store.gather([0])


def test_failed_build_raises(monkeypatch, tmp_path):
    """A source g++ refuses raises, naming the compiler's exit; no library
    is left behind."""
    bad = tmp_path / "tilestore.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(tilestore, "SOURCE", bad)
    monkeypatch.setattr(tilestore, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="g\\+\\+ exited"):
        tilestore.build_library()
    assert not list((tmp_path / "build").glob("*.so"))


@pytest.mark.parametrize("labeled", [True, False], ids=["labeled", "unlabeled"])
def test_format_is_shared_with_the_jax_package(tmp_path, labeled):
    """A file the JAX packer writes reads the same in the port, and the
    reverse; both packers write the same bytes."""
    data = SyntheticCubeDataset(num_tiles=6, n_bands=BANDS, tile_size=16, seed=5,
                                labeled=labeled)
    jax_pack(data, str(tmp_path / "jax.msts"))
    pack_tiles(data, str(tmp_path / "port.msts"))
    assert (tmp_path / "jax.msts").read_bytes() == (tmp_path / "port.msts").read_bytes()
    idx, xs, ys = [5, 0, 3], [0, 8, 3], [8, 2, 0]
    for writer, reader in (("jax", PackedTileStore), ("port", JaxStore)):
        a = reader(str(tmp_path / f"{writer}.msts"), standardize=None)
        b = PackedTileStore(str(tmp_path / f"{writer}.msts"), native=False)
        assert (a.num_tiles, a.bands, a.height, a.width, a.has_labels) == (6, BANDS, 16, 16,
                                                                            labeled)
        np.testing.assert_array_equal(a.gather(idx), b.gather(idx))
        np.testing.assert_array_equal(a.gather_crop(idx, xs, ys, 8), b.gather_crop(idx, xs, ys, 8))
        if labeled:
            np.testing.assert_array_equal(a.gather_labels(idx), b.gather_labels(idx))
            np.testing.assert_array_equal(a[4]["label"], data[4]["label"])


def test_store_plugs_into_the_pipeline(packed):
    data, _, d = packed
    store = PackedTileStore(str(d / "lab.msts"))
    val, train = split_dataset(store, 0.75, seed=5)
    dval, dtrain = split_dataset(data, 0.75, seed=5)
    assert val.indices == dval.indices and train.indices == dtrain.indices
    for got, want in zip(DataLoader(train, 4, seed=1, pad_to_multiple=4),
                         DataLoader(dtrain, 4, seed=1, pad_to_multiple=4), strict=True):
        for key in ("img", "label"):
            np.testing.assert_array_equal(got[key], want[key])
            assert got[key].dtype == want[key].dtype
    dev = DeviceTileStore(train, "cpu")
    assert set(dev.arrays) == {"img", "label"} and len(dev) == len(train)
    np.testing.assert_array_equal(dev.arrays["img"][2].numpy(), data[train.indices[2]]["img"])
    np.testing.assert_array_equal(dev.arrays["label"][2].numpy(), data[train.indices[2]]["label"])


class PerSample:
    """The store without its batch read: the loader reads sample by sample."""

    def __init__(self, store):
        self.store = store

    def __len__(self):
        return len(self.store)

    def __getitem__(self, i):
        return self.store[i]


@pytest.mark.parametrize("native", [True, False], ids=["native", "numpy"])
@pytest.mark.parametrize("standardize", [None, STANDARDIZE], ids=["raw", "standardized"])
@pytest.mark.parametrize("labeled", [True, False], ids=["labeled", "unlabeled"])
def test_batch_reads_equal_per_sample_reads(packed, native, standardize, labeled):
    """DataLoader batches through read_batch (the store, and a Subset of
    it) equal the collated per-sample reads bit for bit, padding and the
    dropped tail included."""
    _, _, d = packed
    store = PackedTileStore(str(d / ("lab.msts" if labeled else "unlab.msts")),
                            standardize=standardize, native=native)
    val, train = split_dataset(store, 0.75, seed=5)
    pval, ptrain = split_dataset(PerSample(store), 0.75, seed=5)
    assert train.read_batch is not None and ptrain.read_batch is None
    for kw in (dict(pad_to_multiple=5), dict(drop_last=True)):
        for ds, ref in ((store, PerSample(store)), (train, ptrain), (val, pval)):
            got = list(DataLoader(ds, 2, seed=2, prefetch=0, **kw))
            want = list(DataLoader(ref, 2, seed=2, prefetch=0, **kw))
            assert len(got) == len(want) > 0
            for g, w in zip(got, want):
                assert g.keys() == w.keys() == ({"img", "label"} if labeled else {"img"})
                for key in g:
                    assert g[key].dtype == w[key].dtype
                    np.testing.assert_array_equal(_bits(g[key]), _bits(w[key]))


def test_packer_cli(tmp_path):
    from maskedsst_tpu_torch.etl import pack_tiles as cli

    out = cli.main(["--synthetic", "--synthetic-tiles", "3", "--n-bands", "20", "--unlabeled",
                    "--out", str(tmp_path / "s.msts")])
    store = PackedTileStore(out)
    assert (len(store), store.bands, store.has_labels) == (3, 20, False)
    want = SyntheticCubeDataset(num_tiles=3, n_bands=20, labeled=False, seed=0)[1]["img"]
    np.testing.assert_array_equal(store[1]["img"], want)
    with pytest.raises(SystemExit):
        cli.main(["--out", str(tmp_path / "x.msts")])  # no --train-path, no --synthetic
