"""The HyperX benchmark of the port (``maskedsst_tpu_torch/hyperx/``)
against the JAX package's ``hyperx/`` on the CPU: the numpy utilities and
the patch dataset on the same arrays and seeds (equal), the trainer's
steps for li, boulch and mou from the same weights over an epoch whose
last batch is padded, the sliding-window maps, checkpoints, and both CLIs
end to end with ``--cpu``.

Tolerances: the trainers' epoch losses 1e-5 relative; their updates
(parameters after minus before) per tensor 1e-4 * max|ref update| for li,
1e-2 for boulch and mou, whose training-mode BatchNorm leaves the fp32
gradients of either implementation ~1e-4 from a float64 run of the same
step (mou's GRU at batch 32: JAX 1.4e-4, the port 7.8e-5), which an
epoch's three steps carry to 2.6e-3 (mou's GRU) and 1e-2 (boulch's first
conv bias, whose update the BatchNorm after it nearly cancels); their
BatchNorm statistics after the epoch 1e-4 * max|ref| (steps 2 and 3 see
weights those updates apart: mou's read 4.7e-5); test() maps rtol 1e-4, atol 3e-5 x
the number of windows summed at a pixel."""

import json
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from maskedsst_tpu.hyperx import datasets as jdatasets
from maskedsst_tpu.hyperx import utils as jutils
from maskedsst_tpu.hyperx.main import synthetic_scene as jax_synthetic_scene
from maskedsst_tpu.hyperx.training import HyperXTrainer as JaxTrainer
from maskedsst_tpu.models.zoo import get_model as jax_get_model
from maskedsst_tpu.utils.tracking import Tracker as JaxTracker
from maskedsst_tpu_torch.hyperx import datasets, inference, utils, viz
from maskedsst_tpu_torch.hyperx import main as hx_main
from maskedsst_tpu_torch.hyperx.training import HyperXTrainer
from maskedsst_tpu_torch.io.flax_params import zoo_flax_from_state, zoo_state_from_flax
from maskedsst_tpu_torch.models.zoo import get_model
from tests.quiet_tracker import QuietTracker

ROOT = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this module's torch CPU work (the suite runs
    files in parallel workers)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _close_per_tensor(got: dict, want: dict, tol: float):
    assert set(got) == set(want)
    for key, ref in want.items():
        scale = max(float(np.abs(ref).max()), 1e-30)
        err = float(np.abs(np.asarray(got[key]) - ref).max())
        assert err <= tol * scale, (key, err, scale)


# --- utilities ----------------------------------------------------------------

@pytest.mark.parametrize("shape,step,window", [((7, 7, 3), 1, (3, 3)), ((8, 8, 3), 2, (3, 3)),
                                               ((10, 13, 2), 4, (5, 5)), ((9, 9, 1), 3, (1, 1))])
def test_sliding_window_matches_jax(shape, step, window):
    img = np.random.default_rng(0).random(shape)
    got = list(utils.sliding_window(img, step=step, window_size=window))
    want = list(jutils.sliding_window(img, step=step, window_size=window))
    assert [g[1:] for g in got] == [w[1:] for w in want]
    assert all(np.array_equal(g[0], w[0]) for g, w in zip(got, want))
    assert utils.count_sliding_window(img, step, window) == jutils.count_sliding_window(
        img, step, window) == len(want)
    assert list(utils.grouper(3, range(7))) == list(jutils.grouper(3, range(7)))


@pytest.mark.parametrize("mode,size", [("random", 0.3), ("random_numpy", 0.3), ("fixed", 0.5),
                                       ("fixed", 5), ("disjoint", 0.5)])
def test_sample_gt_matches_jax(mode, size, monkeypatch):
    """The same split from the same global numpy seed: random through
    sklearn's stratified split (and through the numpy fallback when sklearn
    does not import), fixed per-class fractions or counts, disjoint."""
    gt = np.random.default_rng(1).integers(0, 4, (30, 30))
    if mode == "random_numpy":
        monkeypatch.setitem(sys.modules, "sklearn", None)
        monkeypatch.setitem(sys.modules, "sklearn.model_selection", None)
        mode = "random"
    outs = []
    for mod in (utils, jutils):
        np.random.seed(11)
        outs.append(mod.sample_gt(gt, size, mode=mode))
    (tr, te), (jtr, jte) = outs
    np.testing.assert_array_equal(tr, jtr)
    np.testing.assert_array_equal(te, jte)
    assert not np.any((tr > 0) & (te > 0)) and np.count_nonzero(tr) > 0


def test_weights_metrics_and_report_match_jax(capsys):
    gt = np.random.default_rng(2).integers(0, 5, (20, 20))
    for ignored in ([0], [0, 3], []):
        np.testing.assert_array_equal(utils.compute_imf_weights(gt, 5, ignored),
                                      jutils.compute_imf_weights(gt, 5, ignored))
    pred = np.random.default_rng(3).integers(0, 5, (20, 20))
    got = utils.metrics(pred, gt, ignored_labels=[0], n_classes=5)
    want = jutils.metrics(pred, gt, ignored_labels=[0], n_classes=5)
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key])
    assert utils.show_results(got, ["u"] + list("abcd")) == jutils.show_results(
        want, ["u"] + list("abcd"))
    assert utils.show_results([got, got], agregated=True) == jutils.show_results(
        [want, want], agregated=True)
    from maskedsst_tpu_torch.train.metrics import classification_report

    rep = classification_report(torch.from_numpy(got["Confusion matrix"]))
    assert float(rep["accuracy"]) == pytest.approx(got["Accuracy"], rel=1e-6)
    np.testing.assert_allclose(rep["f1"].numpy(), got["F1 scores"], rtol=1e-6)
    assert float(rep["kappa"]) == pytest.approx(got["Kappa"], rel=1e-5)


def test_files_palettes_and_scenes_match_jax(tmp_path):
    import scipy.io

    gt = np.zeros((10, 10), np.int64)
    gt[:5], gt[5:] = 1, 2
    train = np.zeros_like(gt)
    train[0, :3] = 1
    test = np.zeros_like(gt)
    test[9, :4] = 2
    np.save(tmp_path / "train.npy", train)
    scipy.io.savemat(tmp_path / "test.mat", {"gt": test})
    for a, b in ((str(tmp_path / "train.npy"), str(tmp_path / "test.mat")),
                 (str(tmp_path / "train.npy"), None), (None, str(tmp_path / "test.mat"))):
        for g, w in zip(utils.resolve_gt(gt, a, b, 0.1, "random"),
                        jutils.resolve_gt(gt, a, b, 0.1, "random")):
            np.testing.assert_array_equal(g, w)
    assert utils.camel_to_snake("LiEtAl") == jutils.camel_to_snake("LiEtAl") == "li_et_al"
    assert viz.hls_palette(6) == pytest.approx(
        __import__("maskedsst_tpu.hyperx.viz", fromlist=["x"]).hls_palette(6))
    pal = viz.generate_palette(5)
    colored = utils.convert_to_color_(gt, pal)
    np.testing.assert_array_equal(colored, jutils.convert_to_color_(gt, pal))
    np.testing.assert_array_equal(
        utils.convert_from_color_(colored, {v: k for k, v in pal.items()}), gt)
    # a scene file through get_dataset: NaNs zeroed, 0 ignored, min-max scaled
    scene = np.random.default_rng(4).random((12, 12, 6)).astype(np.float32) * 7
    scene[2, 3, 1] = np.nan
    folder = tmp_path / "Fake"
    folder.mkdir()
    scipy.io.savemat(folder / "img.mat", {"img": scene})
    scipy.io.savemat(folder / "gt.mat", {"gt": np.random.default_rng(5).integers(0, 3, (12, 12))})
    cfg = {"Fake": {"img": "img.mat", "gt": "gt.mat", "img_key": "img", "gt_key": "gt",
                    "rgb_bands": (0, 1, 2), "label_values": ["u", "a", "b"], "download": False}}
    got = datasets.get_dataset("Fake", str(tmp_path), datasets=cfg, download=False)
    want = jdatasets.get_dataset("Fake", str(tmp_path), datasets=cfg, download=False)
    for g, w in zip(got, want):
        if isinstance(w, np.ndarray):
            np.testing.assert_array_equal(g, w)
        else:
            assert g == w
    for g, w in zip(hx_main.synthetic_scene(n_bands=12, size=16, n_classes=3),
                    jax_synthetic_scene(n_bands=12, size=16, n_classes=3)):
        if isinstance(w, np.ndarray):
            np.testing.assert_array_equal(g, w)
        else:
            assert g == w


@pytest.mark.parametrize("patch,center,semi", [(5, True, False), (1, True, False),
                                               (3, False, False), (5, True, True)])
def test_patch_dataset_matches_jax(patch, center, semi):
    """Sample for sample under one seed, with the flip, radiation and
    mixture augmentations on: the layouts ([1, C, p, p], [C], dense labels)
    and every draw."""
    rng = np.random.default_rng(6)
    img = rng.random((20, 20, 8)).astype(np.float32)
    gt = rng.integers(0, 4, (20, 20))
    hp = dict(patch_size=patch, ignored_labels=[0], center_pixel=center,
              supervision="semi" if semi else "full", flip_augmentation=True,
              radiation_augmentation=True, mixture_augmentation=True, seed=3)
    ds, jds = datasets.HyperX(img, gt, **hp), jdatasets.HyperX(img, gt, **hp)
    assert len(ds) == len(jds) > 0
    np.testing.assert_array_equal(ds.indices, jds.indices)
    for i in range(min(len(ds), 40)):
        s, js = ds[i], jds[i]
        assert s["img"].shape == js["img"].shape and s["img"].dtype == np.float32
        np.testing.assert_array_equal(s["img"], js["img"])
        np.testing.assert_array_equal(s["label"], js["label"])
    want = (1, 8, patch, patch) if patch > 1 else (8,)
    assert ds[0]["img"].shape == want
    assert np.ndim(ds[0]["label"]) == (0 if center or patch == 1 else 2)


# --- the trainer --------------------------------------------------------------

def _scene(bands=16, size=20, seed=0):
    np.random.seed(seed)
    img, gt, labels, ignored, _, _ = hx_main.synthetic_scene(n_bands=bands, size=size,
                                                             n_classes=4)
    return img, gt, labels, ignored


def _pair(name, bands=16, **overrides):
    """(port trainer, JAX trainer, hyperparameters) on the JAX trainer's
    initial weights."""
    kwargs = dict(n_classes=5, n_bands=bands, ignored_labels=[0], **overrides)
    model, opt, crit, hp = get_model(name, **kwargs)
    jmodel, jopt, jcrit, jhp = jax_get_model(name, **kwargs)
    jt = JaxTrainer(jmodel, jopt, jcrit, jhp)
    trainer = HyperXTrainer(model, opt, crit, hp, device="cpu")
    variables = {"params": jt.params}
    if jt.batch_stats:
        variables["batch_stats"] = jt.batch_stats
    trainer.model.load_state_dict(
        zoo_state_from_flax(jax.tree_util.tree_map(np.asarray, variables)))
    return trainer, jt, hp


def _variables(trainer, jt):
    like = {"params": jt.params}
    return zoo_flax_from_state(trainer.model.state_dict(), like)


@pytest.mark.parametrize("name", ["li", "boulch", "mou"])
def test_trainer_epoch_matches_jax(name):
    """One epoch of 70 samples at batch 32 (the last batch 6 real rows and
    26 zero rows under label -100, which BatchNorm's batch statistics see,
    as in the JAX trainer) through ``train``: the epoch loss, every update
    and the BatchNorm statistics."""
    img, gt, _, _ = _scene()
    trainer, jt, hp = _pair(name, batch_size=32)
    ds = datasets.HyperX(img, gt, **hp)
    ds.indices = ds.indices[:70]
    ds.labels = ds.labels[:70]
    before = _leaves(_variables(trainer, jt)["params"])
    hist = trainer.train(ds, epochs=1, tracker=QuietTracker())
    jhist = jt.train(ds, epochs=1, tracker=JaxTracker("t", use_wandb=False, quiet=True))
    assert hist["loss"][0] == pytest.approx(jhist["loss"][0], rel=1e-5)
    got = _variables(trainer, jt)
    jparams = _leaves(jt.params)
    _close_per_tensor({k: v - before[k] for k, v in _leaves(got["params"]).items()},
                      {k: v - before[k] for k, v in jparams.items()},
                      1e-4 if name == "li" else 1e-2)
    if jt.batch_stats:
        stats = zoo_flax_from_state({k: v for k, v in trainer.model.state_dict().items()
                                     if "running" in k}, {"params": jt.params})
        _close_per_tensor(_leaves(stats["batch_stats"]), _leaves(jt.batch_stats), 1e-4)
        assert any(np.abs(v).max() > 0 for k, v in _leaves(stats["batch_stats"]).items()
                   if "mean" in k)


@pytest.mark.parametrize("name", ["li", "lee"])
def test_scene_maps_match_jax(name):
    """test()'s summed scores over a scene at stride 2: center-pixel (li)
    and dense (lee, every window's patch summed)."""
    img, _, _, _ = _scene(bands=12, size=14)
    trainer, jt, hp = _pair(name, bands=12, test_stride=2, batch_size=16)
    got = trainer.test(img, batch_size=16)
    want = jt.test(img, batch_size=16)
    assert got.shape == want.shape == (14, 14, 5)
    windows = 9.0 if name == "lee" else 1.0
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=3e-5 * windows)


def test_save_and_restore_carry_the_batchnorm_statistics(tmp_path):
    img, gt, _, _ = _scene(bands=12)
    model, opt, crit, hp = get_model("liu", n_classes=5, n_bands=12, ignored_labels=[0],
                                     batch_size=32)
    trainer = HyperXTrainer(model, opt, crit, hp, device="cpu")
    trainer.train(datasets.HyperX(img, gt, **hp), epochs=1, max_steps=2,
                  tracker=QuietTracker(), save_dir=str(tmp_path))
    path = tmp_path / "best.pt"
    assert path.exists()
    trainer.save(str(path))
    fresh_model, *_ = get_model("liu", n_classes=5, n_bands=12, ignored_labels=[0], seed=9)
    fresh = HyperXTrainer(fresh_model, opt, crit, hp, device="cpu")
    fresh.restore(str(path))
    want = trainer.model.state_dict()
    assert any("running_mean" in k and float(v.abs().max()) > 0 for k, v in want.items())
    for key, val in fresh.model.state_dict().items():
        assert torch.equal(val, want[key]), key


# --- the CLIs -----------------------------------------------------------------

def test_benchmark_and_inference_clis_on_the_cpu(tmp_path, capsys):
    """hyperx.main with GT files, checkpoints, image outputs and a JSON
    record; again from its checkpoint (--restore); the inference CLI on that
    checkpoint over the scene as .npy; an sklearn baseline."""
    np.random.seed(3)
    img, gt, labels, _, _, _ = hx_main.synthetic_scene()
    train_gt, test_gt = utils.sample_gt(gt, 0.2, mode="random")
    np.save(tmp_path / "train.npy", train_gt)
    np.save(tmp_path / "test.npy", test_gt)
    argv = ["--model", "li", "--synthetic-scene", "--cpu", "--epoch", "1", "--max-steps", "3",
            "--train_set", str(tmp_path / "train.npy"), "--test_set", str(tmp_path / "test.npy"),
            "--checkpoint-dir", str(tmp_path / "ckpt"), "--out-dir", str(tmp_path / "viz"),
            "--json-out", str(tmp_path / "run.json")]
    results = hx_main.main(argv)
    assert 0.0 <= results[0]["Accuracy"] <= 100.0
    ckpt = tmp_path / "ckpt" / "li_et_al" / "synthetic" / "best.pt"
    assert ckpt.exists()
    for name in ("rgb.png", "gt.png", "run0_train_gt.png", "run0_test_gt.png",
                 "run0_prediction.tif", "color_run0_prediction.tif"):
        assert (tmp_path / "viz" / "synthetic" / name).exists(), name
    record = json.loads((tmp_path / "run.json").read_text())
    assert record["platform"] == "cpu" and record["device"] == "cpu"
    assert record["model"] == "li" and len(record["runs"]) == 1
    hx_main.main(argv + ["--restore", str(ckpt), "--out-dir", "none"])
    assert "restored params from" in capsys.readouterr().out

    np.save(tmp_path / "scene.npy", img)
    out = tmp_path / "out"
    inference.main(["--model", "li", "--checkpoint", str(ckpt), "--image",
                    str(tmp_path / "scene.npy"), "--n-classes", str(len(labels)),
                    "--batch-size", "256", "--out", str(out), "--cpu"])
    probs, pred = np.load(out / "probs.npy"), np.load(out / "prediction.npy")
    assert probs.shape == img.shape[:2] + (len(labels),) and np.isfinite(probs).all()
    np.testing.assert_array_equal(pred, probs.argmax(-1))
    from PIL import Image

    np.testing.assert_array_equal(np.asarray(Image.open(out / "prediction.tif")),
                                  pred.astype(np.uint8))
    again = inference.predict_scene("li", str(ckpt), inference.load_scene(
        str(tmp_path / "scene.npy")), len(labels), batch_size=256, device="cpu")
    np.testing.assert_array_equal(again[1], pred)

    np.random.seed(0)
    results = hx_main.main(["--model", "SVM", "--synthetic-scene", "--training_sample", "0.05",
                            "--checkpoint-dir", "none", "--out-dir", "none", "--cpu"])
    assert results[0]["Accuracy"] > 100.0 / len(labels)


def test_clis_need_neither_pil_nor_sklearn(tmp_path):
    """With PIL and sklearn made unimportable, the benchmark CLI runs with
    --out-dir none and the inference module's functions run; a card is
    asked for unless --cpu is given."""
    code = (
        "import sys\n"
        "for m in ('PIL', 'sklearn', 'matplotlib'):\n"
        "    sys.modules[m] = None\n"
        "from maskedsst_tpu_torch.hyperx import inference, main\n"
        "res = main.main(['--model', 'li', '--synthetic-scene', '--cpu', '--epoch', '1',\n"
        "                 '--max-steps', '2', '--out-dir', 'none', '--checkpoint-dir',\n"
        f"                 {str(tmp_path / 'ck')!r}])\n"
        "ck = " + repr(str(tmp_path / "ck" / "li_et_al" / "synthetic" / "best.pt")) + "\n"
        "img, *_ = main.synthetic_scene()\n"
        "probs, pred = inference.predict_scene('li', ck, img, 7, device='cpu')\n"
        "assert pred.shape == img.shape[:2], pred.shape\n"
        "print('ran', res[0]['Accuracy'])\n"
    )
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=240, cwd=ROOT)
    assert res.returncode == 0, res.stderr[-2000:]
    assert "ran" in res.stdout
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="--cpu"):
            hx_main.main(["--model", "li", "--synthetic-scene"])
        with pytest.raises(SystemExit, match="--cpu"):
            inference.main(["--model", "li", "--checkpoint", "x.pt", "--image", "x.npy",
                            "--n-classes", "3"])
