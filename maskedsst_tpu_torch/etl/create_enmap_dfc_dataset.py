"""Build the labeled EnMAP-DFC (Mexico City) dataset
(reference enmap_data/create_enmap_dfc_dataset.py:19-260).

Pipeline: merge the city's EnMAP L2A products and the DFC2020 label rasters
into single mosaics, intersect their bounds, cut aligned 64x64 EnMAP tiles
with 3x-resolution 192x192 label tiles, drop tiles with nodata, split
train/test by the tile-id manifest, and write majority-vote 30 m label
downsamples alongside.

  python -m maskedsst_tpu_torch.etl.create_enmap_dfc_dataset \
      --dfc-path .../grss-dfc-20 --enmap-path .../enmap --output-dir out/ \
      --enmap-ids ID1 ID2 [--test-ids test_tile_ids.txt]
"""

from __future__ import annotations

import argparse
import glob
import os

import numpy as np


def downsample_majority(data: np.ndarray, factor: int = 3) -> np.ndarray:
    """Majority-vote downsample by factor x factor windows (reference
    ``downsample``, :25-41 — vectorized instead of the per-pixel loop)."""
    h, w = data.shape[0] // factor, data.shape[1] // factor
    blocks = data[: h * factor, : w * factor].reshape(h, factor, w, factor)
    blocks = blocks.transpose(0, 2, 1, 3).reshape(h, w, factor * factor)
    out = np.zeros((h, w), data.dtype)
    # per-block bincount argmax; labels are small non-negative ints
    max_label = int(blocks.max()) + 1
    counts = np.zeros((h, w, max_label), np.int32)
    for v in range(max_label):
        counts[..., v] = (blocks == v).sum(-1)
    # ties resolve to the smallest label, matching np.unique+argmax order
    out = counts.argmax(-1).astype(data.dtype)
    return out


def merge_products(datasets):
    """Merge adjacent rasterio datasets into one mosaic (reference :44-74)."""
    import rasterio
    import rasterio.merge

    combined, transform = rasterio.merge.merge(datasets)
    meta = datasets[0].meta.copy()
    meta.update(
        {
            "driver": "GTiff",
            "height": combined.shape[1],
            "width": combined.shape[2],
            "transform": transform,
        }
    )
    return combined, meta


def match_rasters(enmap_path: str, dfc_path: str):
    """Read the overlapping window of two rasters (reference :131-166)."""
    import rasterio as rio
    from shapely.geometry import box

    with rio.open(enmap_path) as ef, rio.open(dfc_path) as df:
        intersection = box(*ef.bounds).intersection(box(*df.bounds))
        win1 = rio.windows.from_bounds(*intersection.bounds, ef.transform)
        win2 = rio.windows.from_bounds(*intersection.bounds, df.transform)
        enmap = ef.read(window=win1)
        dfc = df.read(window=win2)
        enmap_meta, dfc_meta = ef.meta.copy(), df.meta.copy()
    return enmap, dfc, enmap_meta, dfc_meta


def cut_aligned_tiles(enmap, dfc, enmap_nodata, dfc_nodata, tile_size=64, label_factor=3):
    """Aligned (enmap 64x64, dfc 192x192) tile pairs; drop nodata
    (reference :179-200)."""
    tiles = []
    for i in range(0, enmap.shape[1], tile_size):
        for j in range(0, enmap.shape[2], tile_size):
            if i + tile_size > enmap.shape[1] or j + tile_size > enmap.shape[2]:
                continue
            et = enmap[:, i : i + tile_size, j : j + tile_size]
            if (et == enmap_nodata).mean(axis=(1, 2)).all():
                continue
            lt = dfc[0][
                i * label_factor : (i + tile_size) * label_factor,
                j * label_factor : (j + tile_size) * label_factor,
            ]
            if (lt == dfc_nodata).sum() > 0:
                continue
            tiles.append((et, lt))
    return tiles


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--dfc-path", required=True)
    parser.add_argument("--enmap-path", required=True)
    parser.add_argument("--output-dir", required=True)
    parser.add_argument("--enmap-ids", nargs="+", required=True)
    parser.add_argument("--test-ids", default=None)
    parser.add_argument("--tile-size", type=int, default=64)
    args = parser.parse_args(argv)

    import rasterio as rio  # heavy geo dep, imported only when actually run

    train_dir = os.path.join(args.output_dir, "train")
    test_dir = os.path.join(args.output_dir, "test")
    os.makedirs(train_dir, exist_ok=True)
    os.makedirs(test_dir, exist_ok=True)

    dfc_files = glob.glob(
        os.path.join(args.dfc_path, "DFC_Public_Dataset/ROIs0000_winter/dfc_MexicoCity", "*.tif")
    )
    print(f"Number of DFC files: {len(dfc_files)}")
    dfc_datasets = [rio.open(f) for f in dfc_files]
    assert len({d.crs for d in dfc_datasets}) == 1, "products have different crs"
    combined_dfc, dfc_meta = merge_products(dfc_datasets)

    product_dirs = [
        d
        for d in glob.glob(os.path.join(args.enmap_path, "*", "*", "*", "*L2A-DT*"))
        if os.path.isdir(d)
    ]
    spectral = [glob.glob(os.path.join(d, "*SPECTRAL_IMAGE.TIF"))[0] for d in product_dirs]
    city_files = [f for f in spectral if any(pid in f for pid in args.enmap_ids)]
    print(f"EnMAP files for the city: {len(city_files)}")
    enmap_datasets = [rio.open(f) for f in city_files]
    assert len({d.crs for d in enmap_datasets}) == 1
    combined_enmap, enmap_meta = merge_products(enmap_datasets)
    assert dfc_meta["crs"] == enmap_meta["crs"], "crs mismatch — reproject first"

    enmap_mosaic = os.path.join(args.output_dir, "enmap.tif")
    dfc_mosaic = os.path.join(args.output_dir, "dfc.tif")
    with rio.open(enmap_mosaic, "w", **enmap_meta) as f:
        f.write(combined_enmap)
    with rio.open(dfc_mosaic, "w", **dfc_meta) as f:
        f.write(combined_dfc)

    enmap, dfc, enmap_meta, dfc_meta = match_rasters(enmap_mosaic, dfc_mosaic)
    tiles = cut_aligned_tiles(
        enmap, dfc, enmap_meta.get("nodata", -32768.0), dfc_meta.get("nodata", 0.0),
        args.tile_size,
    )
    print(f"Number of valid tiles: {len(tiles)}")

    test_idx = set()
    if args.test_ids:
        with open(args.test_ids) as f:
            test_idx = {int(x.strip()) for x in f if x.strip()}

    for idx, (et, lt) in enumerate(tiles):
        outdir = test_dir if idx in test_idx else train_dir
        with rio.open(
            os.path.join(outdir, f"tile{idx}_enmap.tif"), "w", driver="GTiff",
            nodata=-32768.0, dtype=et.dtype, count=et.shape[0],
            width=et.shape[2], height=et.shape[1],
        ) as f:
            f.write(et)
        with rio.open(
            os.path.join(outdir, f"tile{idx}_dfc.tif"), "w", driver="GTiff",
            nodata=0.0, dtype=lt.dtype, count=1, width=lt.shape[1], height=lt.shape[0],
        ) as f:
            f.write(lt[None])
        # 30 m majority-vote label (the loaders read *_dfc_30m.tif)
        low = downsample_majority(lt, 3)
        with rio.open(
            os.path.join(outdir, f"tile{idx}_dfc_30m.tif"), "w", driver="GTiff",
            nodata=0.0, dtype=lt.dtype, count=1, width=low.shape[1], height=low.shape[0],
        ) as f:
            f.write(low[None])
    print("done")


if __name__ == "__main__":
    main()
