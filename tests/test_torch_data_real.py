"""The port's real data path against the JAX package's, on the CPU and without
geo libraries: the constants and transforms, the Houston2018 dataset on an
injected scene (all modes, the random draws of one seed included), the
scene and label loaders and the EnMAP reader through fake ``spectral`` and
``rasterio`` modules put in ``sys.modules`` for both packages, and the
resolution of a config to a dataset. Every comparison is exact: both
packages run the same numpy operations on the same arrays."""

import pickle
import sys
import types

import numpy as np
import pytest

from maskedsst_tpu.config import get_finetune_config as jax_finetune_config
from maskedsst_tpu.config import get_pretrain_config as jax_pretrain_config
from maskedsst_tpu.data import constants as jax_constants
from maskedsst_tpu.data import enmap as jax_enmap
from maskedsst_tpu.data import houston2018 as jax_houston
from maskedsst_tpu.data import transforms as jax_transforms
from maskedsst_tpu.data.synthetic import SyntheticCubeDataset as JaxCubes
from maskedsst_tpu.data.resolve import get_dataset as jax_get_dataset
from maskedsst_tpu_torch.config import get_finetune_config, get_pretrain_config
from maskedsst_tpu_torch.data import constants, enmap, houston2018, transforms
from maskedsst_tpu_torch.data.resolve import get_dataset, tile_size
from maskedsst_tpu_torch.data.synthetic import SyntheticCubeDataset
from maskedsst_tpu_torch.native import PackedTileStore, pack_tiles

CONFIGS = ("configs/finetune_config_enmap.yaml", "configs/config.yaml")
HOUSTON = ("configs/finetune_config_houston2018.yaml", "configs/config.yaml")
PRETRAIN = ("configs/pretrain_config.yaml", "configs/config.yaml")


def _equal(got, want):
    """Same type, and the same value: arrays bit for bit with their dtype."""
    if isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    elif isinstance(want, dict):
        assert isinstance(got, dict) and got.keys() == want.keys()
        for k in want:
            _equal(got[k], want[k])
    else:
        assert type(got) is type(want) and got == want


# --- constants and transforms ------------------------------------------------

@pytest.mark.parametrize("name", sorted(n for n in dir(jax_constants) if n.isupper()))
def test_constants_equal_jax(name):
    _equal(getattr(constants, name), getattr(jax_constants, name))


@pytest.mark.parametrize("name", ["standardize_enmap", "unstandardize_enmap",
                                  "max_normalize_enmap", "max_normalize_all_bands_same",
                                  "standardize_houston2018"])
def test_normalizers_equal_jax(name):
    rng = np.random.default_rng(len(name))
    bands = 48 if "houston" in name else 200
    for dtype in (np.float32, np.float64):
        x = (rng.standard_normal((bands, 5, 6)) * 900 + 1500).astype(dtype)
        _equal(getattr(transforms, name)(x), getattr(jax_transforms, name)(x))
    if name.endswith("enmap") and "max" not in name:
        _equal(getattr(transforms, name)(x, use_clipped=False),
               getattr(jax_transforms, name)(x, use_clipped=False))


@pytest.mark.parametrize("name,codes", [
    ("worldcover_label_transform", [0, 10, 20, 30, 40, 50, 60, 70, 80, 90, 95, 100]),
    ("dfc_label_transform", list(range(0, 12))),
    ("houston2018_label_transform", list(range(0, 21))),
])
def test_label_transforms_equal_jax(name, codes):
    rng = np.random.default_rng(7)
    for dtype in (np.uint8, np.int16, np.int64):
        x = rng.choice(np.asarray(codes, dtype), size=(9, 11))
        before = x.copy()
        _equal(getattr(transforms, name)(x), getattr(jax_transforms, name)(x))
        np.testing.assert_array_equal(x, before)  # the input is not changed


def test_label_transforms_golden():
    """The reference transforms' values, its WorldCover quirk included: codes
    90 and 100 collapse to class 0."""
    wc = np.array([0, 10, 20, 90, 95, 100])
    np.testing.assert_array_equal(transforms.worldcover_label_transform(wc), [-1, 0, 1, 0, 8, 0])
    np.testing.assert_array_equal(transforms.dfc_label_transform(np.arange(1, 11)),
                                  [0, 1, -1, 2, 3, 4, 5, -1, 6, 7])
    np.testing.assert_array_equal(transforms.houston2018_label_transform(np.array([0, 1, 20])),
                                  [-1, 0, 19])


# --- fake geo libraries --------------------------------------------------------

class _Raster:
    def __init__(self, arr):
        self.arr = arr
        self.count, self.height, self.width = arr.shape
        self.indexes = list(range(1, self.count + 1))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def read(self, indexes=None, out_shape=None, resampling=None):
        if out_shape is not None:  # nearest at half resolution: every other pixel
            fy, fx = self.height // out_shape[1], self.width // out_shape[2]
            return self.arr[:, ::fy, ::fx][:, : out_shape[1], : out_shape[2]].copy()
        if indexes is None:
            return self.arr.copy()
        return self.arr[[i - 1 for i in indexes]]


@pytest.fixture
def fake_geo(monkeypatch):
    """``rasterio`` (with ``rasterio.enums``) and ``spectral.io.envi`` serving
    arrays registered by path, in sys.modules for both packages."""
    files: dict = {}
    rio = types.ModuleType("rasterio")
    rio.open = lambda path, **kw: _Raster(files[str(path)])
    enums = types.ModuleType("rasterio.enums")
    enums.Resampling = types.SimpleNamespace(nearest="nearest")
    rio.enums = enums

    class Envi:
        def __init__(self, arr):
            self.arr, self.shape = arr, arr.shape

        def read_bands(self, bands):
            return self.arr[:, :, list(bands)]

    spectral = types.ModuleType("spectral")
    io = types.ModuleType("spectral.io")
    envi = types.ModuleType("spectral.io.envi")
    envi.open = lambda header, pix: Envi(files[str(header)])
    spectral.io, io.envi = io, envi
    for name, mod in (("rasterio", rio), ("rasterio.enums", enums), ("spectral", spectral),
                      ("spectral.io", io), ("spectral.io.envi", envi)):
        monkeypatch.setitem(sys.modules, name, mod)
    return files


# --- Houston2018 ------------------------------------------------------------------

def _scene(h=640, w=3000, c=4, seed=0, labeled=0.3):
    """A scene covering the train rectangle (rows 601:, columns 596:2980) and
    the three test rectangles; labels mostly 0 (a patch summing to 0 counts
    as unlabeled, the reference's test), some -1..19."""
    rng = np.random.default_rng(seed)
    img = rng.standard_normal((c, h, w)).astype(np.float32)
    label = np.zeros((h, w), np.int64)
    hit = rng.random((h, w)) < labeled
    label[hit] = rng.integers(-1, 20, int(hit.sum()))
    return img, label


def _houston_pair(img, label, **kw):
    return (houston2018.Houston2018Dataset("", "", img=img, label=label, **kw),
            jax_houston.Houston2018Dataset("", "", img=img, label=label, **kw))


@pytest.mark.parametrize("drop", [False, True], ids=["keep", "drop_unlabeled"])
@pytest.mark.parametrize("mode", ["fixed", "test", "test_pixelwise"])
def test_houston_patch_modes_equal_jax(mode, drop):
    img, label = _scene(labeled=0.002)
    kw = dict(patch_size=8, drop_unlabeled=drop, fix_train_patches=mode == "fixed",
              test=mode.startswith("test"), pixelwise=mode == "test_pixelwise")
    got, want = _houston_pair(img, label, **kw)
    assert len(got) == len(want) > 0 and got.stochastic is want.stochastic is False
    if mode != "test_pixelwise":
        _equal(got.img_patches, want.img_patches)
        _equal(got.label_patches, want.label_patches)
    if mode.startswith("test"):
        assert got.img_patches_sections == want.img_patches_sections
    _equal(got.labeled_idx, want.labeled_idx)
    for i in (0, len(want) // 2, len(want) - 1):
        _equal(got[i], want[i])


@pytest.mark.parametrize("p", [7, 8])
def test_houston_pixelwise_equal_jax(p):
    img, label = _scene(labeled=0.01)
    got, want = _houston_pair(img, label, patch_size=p, fix_train_patches=False, pixelwise=True)
    assert len(got) == len(want) > 0 and not got.stochastic
    _equal(got.labeled_idx, want.labeled_idx)
    for i in (0, 1, len(want) - 1):
        _equal(got[i], want[i])
        assert got[i]["img"].shape == (img.shape[0], p, p)


@pytest.mark.parametrize("drop", [False, True], ids=["keep", "drop_unlabeled"])
def test_houston_random_patches_equal_jax(drop):
    """The same draws from the same seed, the bounded redraws for labeled
    patches included; a label-free scene raises after 10,000 draws."""
    img, label = _scene(labeled=0.0005)
    got, want = _houston_pair(img, label, patch_size=8, fix_train_patches=False,
                              drop_unlabeled=drop, seed=11)
    assert got.stochastic and want.stochastic and len(got) == len(want) == 4 * 298
    for _ in range(25):
        _equal(got[0], want[0])
    empty = np.zeros_like(label)
    got, want = _houston_pair(img, empty, patch_size=8, fix_train_patches=False,
                              drop_unlabeled=True)
    for ds in (got, want):
        with pytest.raises(RuntimeError, match="10000 draws"):
            ds[0]


def test_houston_train_labels_are_sliced_with_the_image():
    """The deliberate fix: the random train patches' labels are the image's
    own rectangle (the reference keeps the whole scene's labels)."""
    h, w = 640, 3000
    coords = (np.arange(h)[:, None] * w + np.arange(w)[None, :]) % 17
    img = np.broadcast_to(coords[None].astype(np.float32), (2, h, w)).copy()
    ds = houston2018.Houston2018Dataset("", "", patch_size=8, fix_train_patches=False,
                                        img=img, label=coords.astype(np.int64))
    for _ in range(5):
        s = ds[0]
        np.testing.assert_array_equal(s["img"][0].astype(np.int64), s["label"])


@pytest.mark.parametrize("shape,p", [((3, 20, 26), 8), ((2, 16, 16), 8), ((5, 9, 31), 3)])
def test_patchify_equal_jax(shape, p):
    rng = np.random.default_rng(p)
    img = rng.standard_normal(shape).astype(np.float32)
    label = rng.integers(-1, 20, shape[1:])
    got = houston2018._patchify(img, label, p)
    for g, w in zip(got, jax_houston._patchify(img, label, p), strict=True):
        _equal(g, w)


@pytest.mark.parametrize("rgb_only", [False, True])
def test_houston_scene_and_label_loaders_equal_jax(fake_geo, tmp_path, rgb_only):
    rng = np.random.default_rng(3)
    raw = (rng.random((12, 14, 50)) * 6000).astype(np.float32)  # [H, W, 48 + 2] as ENVI reads
    fake_geo[str(tmp_path / "20170218_UH_CASI_S4_NAD83.hdr")] = raw
    gt = rng.integers(0, 21, (1, 24, 28)).astype(np.uint8)
    fake_geo["gt.tif"] = gt
    got = houston2018.load_houston2018_scene(str(tmp_path), rgb_only=rgb_only)
    _equal(got, jax_houston.load_houston2018_scene(str(tmp_path), rgb_only=rgb_only))
    assert got.shape == ((3 if rgb_only else 50), 12, 14)
    if not rgb_only:
        assert not got[48:].any()  # the zero padding from 48 to 50 bands
    labels = houston2018.load_houston2018_labels("gt.tif")
    _equal(labels, jax_houston.load_houston2018_labels("gt.tif"))
    np.testing.assert_array_equal(labels, gt[0, ::2, ::2].astype(np.int64) - 1)


# --- EnMAP ------------------------------------------------------------------------

def _enmap_tiles(fake_geo, root, target, n=3, seed=0):
    """n 224-band 64x64 tiles and their labels under root/train, laid out
    as the ETL writes them (per-product directories for WorldCover and
    unlabeled, flat for DFC), plus a crashed run's staging directory."""
    rng = np.random.default_rng(seed)
    train = root / "train"
    for i in range(n):
        d = train if target == "dfc" else train / f"prod{i}"
        d.mkdir(parents=True, exist_ok=True)
        tif = d / f"t{i}_enmap.tif"
        tif.touch()
        tile = rng.normal(1500, 900, (224, 64, 64)).astype(np.int16)
        tile[:, 0, :4] = [-32768, -300, 12000, 30000]  # no-data and beyond the clip bounds
        fake_geo[str(tif)] = tile
        codes = ([0, 10, 20, 30, 40, 50, 60, 70, 80, 90, 95, 100] if target != "dfc"
                 else list(range(1, 11)))
        fake_geo[str(tif).replace("enmap.tif", f"{target}_30m.tif")] = rng.choice(
            np.asarray(codes, np.uint8), (1, 64, 64))
    stale = train / "prod9.tmp123"
    stale.mkdir(parents=True, exist_ok=True)
    (stale / "t9_enmap.tif").touch()
    return str(train)


@pytest.mark.parametrize("target,kw", [
    ("worldcover", {"remove_bands": [200, 201]}),
    ("dfc", {"remove_bands": [200, 201]}),
    ("unlabeled", {"remove_bands": [200, 201], "load_to_memory": True}),
    ("dfc", {"remove_bands": [200, 201], "rgb_only": True}),
    ("worldcover", {"remove_bands": [200, 201], "standardize": False}),
    ("dfc", {"remove_bands": [200, 201], "clip": None}),
], ids=["worldcover", "dfc", "unlabeled_in_memory", "rgb_only", "raw_clipped", "no_clip"])
def test_enmap_tiles_equal_jax(fake_geo, tmp_path, target, kw):
    path = _enmap_tiles(fake_geo, tmp_path, "worldcover" if target == "unlabeled" else target)
    got = enmap.EnMAPWorldCoverDataset(path, target_type=target, **kw)
    want = jax_enmap.EnMAPWorldCoverDataset(path, target_type=target, **kw)
    assert got.enmap_files == want.enmap_files and len(got) == 3  # the staging dir is skipped
    assert got.target_files == want.target_files
    for i in range(3):
        _equal(got[i], want[i])
    sample = got[0]
    bands = 3 if kw.get("rgb_only") else 224 - 22 - len(kw.get("remove_bands", []))
    assert sample["img"].shape == (bands, 64, 64) and sample["img"].dtype == np.float32
    assert ("label" in sample) is (target != "unlabeled")
    if kw.get("standardize") is False:  # raw units: the clip bounds cut
        assert sample["img"].min() == -200 and sample["img"].max() == 10000


@pytest.mark.parametrize("shuffle", [False, True])
def test_enmap_pixel_location_mode_equal_jax(fake_geo, tmp_path, shuffle):
    path = _enmap_tiles(fake_geo, tmp_path, "dfc")
    files = sorted(f for f in fake_geo if f.endswith("enmap.tif"))
    rng = np.random.default_rng(1)
    locations = {c: [(files[int(rng.integers(0, 3))], (int(rng.integers(0, 64)),
                                                       int(rng.integers(0, 64))))
                     for _ in range(40)] for c in range(3)}
    with open(tmp_path / "locs.pkl", "wb") as f:
        pickle.dump(locations, f)
    kw = dict(target_type="dfc", remove_bands=[200, 201],
              pixel_location_file=str(tmp_path / "locs.pkl"), num_samples_per_class=6,
              patch_size=3, patch_offset=5, shuffle_samples=shuffle, seed=4)
    got = enmap.EnMAPWorldCoverDataset(path, **kw)
    want = jax_enmap.EnMAPWorldCoverDataset(path, **kw)
    assert len(got) == len(want) > 0 and got.patch_labels == want.patch_labels
    for i in range(len(want)):
        _equal(got[i], want[i])
        assert got.patches[i].base is None  # a copy, not a view pinning the tile


# --- resolve ----------------------------------------------------------------------

def test_resolve_picks_a_packed_store_first(tmp_path):
    lab, unlab = tmp_path / "train.msts", tmp_path / "unlab.msts"
    pack_tiles(SyntheticCubeDataset(num_tiles=4, n_bands=200, seed=1), str(lab))
    pack_tiles(SyntheticCubeDataset(num_tiles=3, n_bands=200, labeled=False, seed=1), str(unlab))
    cfg = get_finetune_config(*CONFIGS)
    cfg.train_path = str(lab)
    ds = get_dataset(cfg, supervised=True)
    assert isinstance(ds, PackedTileStore) and ds.has_labels and len(ds) == 4
    assert tile_size(ds) == 64
    np.testing.assert_array_equal(ds[2]["img"], jax_get_dataset(cfg, supervised=True)[2]["img"])
    cfg.train_path = str(unlab)
    with pytest.raises(ValueError, match="unlabeled tile store"):
        get_dataset(cfg, supervised=True)
    pcfg = get_pretrain_config(*PRETRAIN)
    pcfg.train_path = str(unlab)
    assert len(get_dataset(pcfg, supervised=False)) == 3
    # synthetic, when asked for, comes before the store
    assert isinstance(get_dataset(pcfg, supervised=False, synthetic=True), SyntheticCubeDataset)


def test_resolve_raises_on_a_missing_dataset(tmp_path):
    """Where the JAX function trains on synthetic cubes, the port raises."""
    for cfg, what in ((get_finetune_config(*CONFIGS), "dfc train_path"),
                      (get_finetune_config(*HOUSTON), "houston2018 train_path"),
                      (get_pretrain_config(*PRETRAIN), "enmap train_path")):
        with pytest.raises(FileNotFoundError, match=what):
            get_dataset(cfg, supervised=cfg.get("method_name") is not None)
        cfg.synthetic_tiles = 2
        assert isinstance(jax_get_dataset(cfg, supervised=True), JaxCubes)
    cfg = get_finetune_config(*CONFIGS)
    cfg.train_path = str(tmp_path / "absent.msts")
    with pytest.raises(FileNotFoundError, match="absent.msts"):
        get_dataset(cfg, supervised=True)
    cfg.train_path = str(tmp_path)  # the directory exists; rasterio does not
    with pytest.raises(ImportError, match="rasterio"):
        get_dataset(cfg, supervised=True)


def test_resolve_real_readers_equal_jax(fake_geo, tmp_path):
    path = _enmap_tiles(fake_geo, tmp_path / "dfc", "dfc")
    cfg, jcfg = get_finetune_config(*CONFIGS), jax_finetune_config(*CONFIGS)
    for c in (cfg, jcfg):
        c.train_path = path
    got, want = get_dataset(cfg, supervised=True), jax_get_dataset(jcfg, supervised=True)
    assert isinstance(got, enmap.EnMAPWorldCoverDataset) and got.target_type == "dfc"
    assert len(got) == len(want) == 3 and tile_size(got) == 64
    _equal(got[1], want[1])
    pcfg, jpcfg = get_pretrain_config(*PRETRAIN), jax_pretrain_config(*PRETRAIN)
    wc = _enmap_tiles(fake_geo, tmp_path / "wc", "worldcover")
    for c in (pcfg, jpcfg):
        c.train_path = wc
    got, want = get_dataset(pcfg, supervised=False), jax_get_dataset(jpcfg, supervised=False)
    assert got.target_type == want.target_type == "unlabeled"
    _equal(got[0], want[0])

    scene = tmp_path / "houston"
    scene.mkdir()
    rng = np.random.default_rng(2)
    # rows 601:610 and columns 596:620 of the train rectangle
    fake_geo[str(scene / "20170218_UH_CASI_S4_NAD83.hdr")] = rng.random((610, 620, 50),
                                                                        np.float32) * 5000
    (tmp_path / "gt.tif").touch()
    fake_geo[str(tmp_path / "gt.tif")] = rng.integers(0, 21, (1, 1220, 1240)).astype(np.uint8)
    hcfg = get_finetune_config(*HOUSTON)
    hcfg.train_path, hcfg.train_label_path = str(scene), str(tmp_path / "gt.tif")
    ds = get_dataset(hcfg, supervised=True)
    assert isinstance(ds, houston2018.Houston2018Dataset) and ds.stochastic
    assert tile_size(ds) == 8 and ds.img.shape == (50, 9, 24)
