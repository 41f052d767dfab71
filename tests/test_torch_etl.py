"""The port's EnMAP ETL scripts (``maskedsst_tpu_torch/etl/``) against the
JAX package's copies: their numpy parts (``cut_tiles``,
``downsample_majority``, ``cut_aligned_tiles``) on seeded arrays, and both
drivers end to end against in-memory fakes of the rasterio / shapely
surface they touch (neither is installed), whose output trees are compared
file for file and array for array with the JAX drivers' on the same
inputs. The fakes are this file's own copy of tests/test_etl.py's."""

import os
import sys
import types

import numpy as np
import pytest

import maskedsst_tpu.etl.create_enmap_dataset as jax_enmap
import maskedsst_tpu.etl.create_enmap_dfc_dataset as jax_dfc
import maskedsst_tpu_torch.etl.create_enmap_dataset as enmap
import maskedsst_tpu_torch.etl.create_enmap_dfc_dataset as dfc


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_cut_tiles_matches_jax(seed):
    rng = np.random.default_rng(seed)
    raster = rng.standard_normal((3, 150, 140)).astype(np.float32)  # trailing remainders
    raster[:, :64, :64] = -32768.0  # an all-nodata tile
    raster[1, 64:128, :64] = -32768.0  # one band's nodata only: kept
    got = enmap.cut_tiles(raster, 64, -32768.0)
    want = jax_enmap.cut_tiles(raster, 64, -32768.0)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("shape,factor,labels", [((31, 29), 3, 11), ((40, 44), 2, 3),
                                                 ((192, 192), 3, 9)])
def test_downsample_majority_matches_jax(shape, factor, labels):
    data = np.random.default_rng(sum(shape)).integers(0, labels, size=shape).astype(np.int32)
    got = dfc.downsample_majority(data, factor)
    want = jax_dfc.downsample_majority(data, factor)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_cut_aligned_tiles_matches_jax():
    rng = np.random.default_rng(3)
    img = rng.standard_normal((4, 200, 140)).astype(np.float32)
    img[:, 64:128, :64] = -32768.0
    labels = rng.integers(1, 6, size=(1, 600, 420)).astype(np.int32)
    labels[0, 5, 200] = 0  # one label tile with nodata
    got = dfc.cut_aligned_tiles(img, labels, -32768.0, 0)
    want = jax_dfc.cut_aligned_tiles(img, labels, -32768.0, 0)
    assert len(got) == len(want) == 4
    for (ge, gl), (we, wl) in zip(got, want):
        np.testing.assert_array_equal(ge, we)
        np.testing.assert_array_equal(gl, wl)


# --- the drivers against a fake rasterio / shapely -------------------------------

class _FakeTransform:
    """Pixel grid: (origin_x, origin_y_top, pixel_size); y grows downward."""

    def __init__(self, x0, y1, px):
        self.x0, self.y1, self.px = x0, y1, px


class _Window:
    def __init__(self, row0, col0, rows, cols):
        self.row0, self.col0, self.rows, self.cols = row0, col0, rows, cols


class _FakeDataset:
    def __init__(self, path):
        with open(path, "rb") as f:
            payload = np.load(f, allow_pickle=True).item()
        self.arr = payload["arr"]
        self.meta = payload["meta"]
        self.transform = payload["transform"]
        self.count, self.height, self.width = self.arr.shape
        self.crs = self.meta.get("crs")

    @property
    def bounds(self):
        t = self.transform
        return (t.x0, t.y1 - self.height * t.px, t.x0 + self.width * t.px, t.y1)

    def read(self, out_shape=None, resampling=None, window=None):
        arr = self.arr
        if window is not None:
            arr = arr[
                :,
                window.row0 : window.row0 + window.rows,
                window.col0 : window.col0 + window.cols,
            ]
        if out_shape is not None and out_shape != arr.shape:
            c, h, w = out_shape
            fy, fx = h // arr.shape[1], w // arr.shape[2]
            arr = np.repeat(np.repeat(arr, fy, axis=1), fx, axis=2)
        return arr

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


class _FakeWriter:
    def __init__(self, path, meta):
        self.path, self.meta = path, meta

    def write(self, arr):
        meta = dict(self.meta)
        transform = meta.pop("transform", _FakeTransform(0.0, float(arr.shape[1]), 1.0))
        with open(self.path, "wb") as f:
            np.save(
                f,
                {"arr": np.asarray(arr), "meta": meta, "transform": transform},
                allow_pickle=True,
            )

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def _write_fake_tif(path, arr, nodata, crs="EPSG:32614", x0=0.0, y1=None, px=1.0):
    meta = {"nodata": nodata, "crs": crs, "driver": "GTiff", "count": arr.shape[0],
            "height": arr.shape[1], "width": arr.shape[2], "dtype": arr.dtype}
    t = _FakeTransform(x0, float(arr.shape[1]) * px if y1 is None else y1, px)
    _FakeWriter(path, {**meta, "transform": t}).write(arr)


def _install_fake_geo(monkeypatch):
    rio = types.ModuleType("rasterio")

    def _open(path, mode="r", **meta):
        return _FakeDataset(path) if mode == "r" else _FakeWriter(path, meta)

    rio.open = _open

    merge_mod = types.ModuleType("rasterio.merge")

    def _merge(datasets):
        assert len(datasets) == 1, "fake merge supports single-product mosaics"
        d = datasets[0]
        return d.arr.copy(), d.transform

    merge_mod.merge = _merge
    rio.merge = merge_mod

    windows_mod = types.ModuleType("rasterio.windows")

    def _from_bounds(left, bottom, right, top, transform):
        px = transform.px
        col0 = int(round((left - transform.x0) / px))
        row0 = int(round((transform.y1 - top) / px))
        return _Window(row0, col0, int(round((top - bottom) / px)), int(round((right - left) / px)))

    windows_mod.from_bounds = _from_bounds
    rio.windows = windows_mod

    warp_mod = types.ModuleType("rasterio.warp")
    warp_mod.Resampling = types.SimpleNamespace(bilinear="bilinear")
    rio.warp = warp_mod

    shapely_mod = types.ModuleType("shapely")
    geometry_mod = types.ModuleType("shapely.geometry")

    class _Box:
        def __init__(self, l, b, r, t):
            self.bounds = (l, b, r, t)

        def intersection(self, other):
            l1, b1, r1, t1 = self.bounds
            l2, b2, r2, t2 = other.bounds
            return _Box(max(l1, l2), max(b1, b2), min(r1, r2), min(t1, t2))

    geometry_mod.box = lambda l, b, r, t: _Box(l, b, r, t)
    shapely_mod.geometry = geometry_mod

    for name, mod in [
        ("rasterio", rio), ("rasterio.merge", merge_mod),
        ("rasterio.windows", windows_mod), ("rasterio.warp", warp_mod),
        ("shapely", shapely_mod), ("shapely.geometry", geometry_mod),
    ]:
        monkeypatch.setitem(sys.modules, name, mod)


def _product_tree(root, name="ENMAP01-____L2A-DT0000001"):
    d = os.path.join(root, "a", "b", "c", name)
    os.makedirs(d, exist_ok=True)
    return os.path.join(d, f"{name}-SPECTRAL_IMAGE.TIF")


def _product_tree(root, name="ENMAP01-____L2A-DT0000001"):
    d = os.path.join(root, "a", "b", "c", name)
    os.makedirs(d, exist_ok=True)
    return os.path.join(d, f"{name}-SPECTRAL_IMAGE.TIF")


def _tree(root):
    """{relative path: (array, meta)} of every file the fake writer wrote."""
    out = {}
    for dirpath, _, files in os.walk(root):
        for name in files:
            path = os.path.join(dirpath, name)
            d = _FakeDataset(path)
            out[os.path.relpath(path, root)] = (d.arr, d.meta)
    return out


def _assert_same_outputs(got_root, want_root):
    got, want = _tree(got_root), _tree(want_root)
    assert sorted(got) == sorted(want) and got
    for key in want:
        np.testing.assert_array_equal(got[key][0], want[key][0], err_msg=key)
        assert got[key][0].dtype == want[key][0].dtype
        assert {k: v for k, v in got[key][1].items() if k != "transform"} == \
            {k: v for k, v in want[key][1].items() if k != "transform"}, key


def test_enmap_driver_writes_what_the_jax_driver_writes(tmp_path, monkeypatch):
    _install_fake_geo(monkeypatch)
    rng = np.random.default_rng(0)
    raster = rng.standard_normal((3, 128, 192)).astype(np.float32)
    raster[:, :64, :64] = -32768.0
    for pid in ("ENMAP01-____L2A-DT0000001", "ENMAP01-____L2A-DT0000002"):
        _write_fake_tif(_product_tree(str(tmp_path / "enmap"), pid), raster, nodata=-32768.0)
    manifest = tmp_path / "testfiles.txt"
    manifest.write_text("ENMAP01-____L2A-DT0000002-SPECTRAL_IMAGE\n")
    args = ["--enmap-path", str(tmp_path / "enmap"), "--testfiles", str(manifest),
            "--upscale", "2"]
    enmap.main(args + ["--output-dir", str(tmp_path / "port" / "train")])
    monkeypatch.setattr(sys, "argv", ["etl"] + args + ["--output-dir",
                                                       str(tmp_path / "jax" / "train")])
    jax_enmap.main()
    _assert_same_outputs(tmp_path / "port", tmp_path / "jax")
    # 2x upscaled to 256 x 384: 24 tiles, the 4 of the nodata corner dropped
    assert len(_tree(tmp_path / "port" / "test")) == 20


def test_enmap_dfc_driver_writes_what_the_jax_driver_writes(tmp_path, monkeypatch):
    _install_fake_geo(monkeypatch)
    rng = np.random.default_rng(1)
    img = rng.standard_normal((3, 128, 128)).astype(np.float32)
    labels = rng.integers(1, 6, size=(1, 384, 384)).astype(np.int32)
    labels[0, 0, 0] = 0  # the first label tile holds nodata: dropped
    pid = "ENMAP01-____L2A-DT0000003"
    _write_fake_tif(_product_tree(str(tmp_path / "enmap"), pid), img, nodata=-32768.0)
    dfc_dir = tmp_path / "dfc" / "DFC_Public_Dataset" / "ROIs0000_winter" / "dfc_MexicoCity"
    os.makedirs(dfc_dir)
    _write_fake_tif(str(dfc_dir / "roi.tif"), labels, nodata=0, px=1.0 / 3.0)
    test_ids = tmp_path / "test_ids.txt"
    test_ids.write_text("1\n")
    args = ["--dfc-path", str(tmp_path / "dfc"), "--enmap-path", str(tmp_path / "enmap"),
            "--enmap-ids", pid, "--test-ids", str(test_ids)]
    dfc.main(args + ["--output-dir", str(tmp_path / "port")])
    monkeypatch.setattr(sys, "argv", ["etl"] + args + ["--output-dir", str(tmp_path / "jax")])
    jax_dfc.main()
    _assert_same_outputs(tmp_path / "port", tmp_path / "jax")
    assert sorted(os.listdir(tmp_path / "port" / "test")) == [
        "tile1_dfc.tif", "tile1_dfc_30m.tif", "tile1_enmap.tif"]
