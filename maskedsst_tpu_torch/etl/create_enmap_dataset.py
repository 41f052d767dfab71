"""Cut EnMAP L2A products into 64x64 training tiles
(reference enmap_data/create_enmap_dataset.py:19-109).

Walks EnMAP product directories for ``*SPECTRAL_IMAGE.TIF`` rasters, optionally
bilinear-upscales, cuts non-overlapping TILE_SIZE tiles, drops tiles where
every pixel of every band is nodata, and writes per-product tile directories
under train/ (or test/ for products listed in the testfiles manifest).

  python -m maskedsst_tpu_torch.etl.create_enmap_dataset \
      --enmap-path /data/enmap --output-dir out/train \
      [--testfiles testfiles.txt] [--tile-size 64] [--upscale 1]
"""

from __future__ import annotations

import argparse
import glob
import os
import shutil
import socket
import time

NODATA = -32768.0


def cut_tiles(raster, tile_size: int, nodata: float):
    """Non-overlapping tiles [C, t, t]; skips the all-nodata ones and
    trailing remainders (reference :79-93)."""
    tiles = []
    for i in range(0, raster.shape[1], tile_size):
        for j in range(0, raster.shape[2], tile_size):
            if i + tile_size > raster.shape[1] or j + tile_size > raster.shape[2]:
                continue
            tile = raster[:, i : i + tile_size, j : j + tile_size]
            if (tile == nodata).mean(axis=(1, 2)).all():
                continue
            tiles.append(tile)
    return tiles


def process_product(path: str, outdir: str, tile_size: int, upscale: float) -> int:
    import rasterio
    from rasterio.warp import Resampling

    with rasterio.open(path) as dataset:
        nodata = dataset.meta.get("nodata", NODATA)
        raster = dataset.read(
            out_shape=(
                dataset.count,
                int(dataset.height * upscale),
                int(dataset.width * upscale),
            ),
            resampling=Resampling.bilinear,
        )
    tiles = cut_tiles(raster, tile_size, nodata if nodata is not None else NODATA)
    os.makedirs(outdir, exist_ok=True)
    for idx, tile in enumerate(tiles):
        with rasterio.open(
            os.path.join(outdir, f"tile{idx}_enmap.tif"),
            "w",
            driver="GTiff",
            nodata=NODATA,
            dtype=tile.dtype,
            count=tile.shape[0],
            width=tile.shape[2],
            height=tile.shape[1],
        ) as f:
            f.write(tile)
    return len(tiles)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--enmap-path", required=True)
    parser.add_argument("--output-dir", required=True, help=".../train directory")
    parser.add_argument(
        "--test-output-dir", default=None,
        help="directory for products listed in --testfiles; defaults to the "
        "output dir with its last 'train' path component replaced by 'test' "
        "(<output-dir>_test when no such component exists)",
    )
    parser.add_argument("--testfiles", default=None, help="manifest of held-out product names")
    parser.add_argument("--tile-size", type=int, default=64)
    parser.add_argument("--upscale", type=float, default=1.0)
    args = parser.parse_args(argv)

    product_dirs = [
        d
        for d in glob.glob(os.path.join(args.enmap_path, "*", "*", "*", "*L2A-DT*"))
        if os.path.isdir(d)
    ]
    products = [glob.glob(os.path.join(d, "*SPECTRAL_IMAGE.TIF"))[0] for d in product_dirs]
    print(f"Found {len(products)} EnMAP products.")
    names = [os.path.basename(p) for p in products]
    assert len(names) == len(set(names)), "duplicate EnMAP product files"

    testfiles = set()
    if args.testfiles:
        with open(args.testfiles) as f:
            testfiles = {line.strip() for line in f if line.strip()}

    # explicit test root: the reference's outdir.replace('train', 'test')
    # silently routed test products into the TRAIN split when the path had
    # no 'train' component, and rewrote every occurrence when it had several
    test_root = args.test_output_dir
    if test_root is None:
        parts = os.path.normpath(args.output_dir).split(os.sep)
        for i in range(len(parts) - 1, -1, -1):
            if parts[i] == "train":
                parts[i] = "test"
                test_root = os.sep.join(parts)
                break
        else:
            test_root = os.path.normpath(args.output_dir) + "_test"

    for product in products:
        filename = os.path.basename(product).split(".TIF")[0]
        outdir = os.path.join(args.output_dir, filename)
        if filename in testfiles:
            outdir = os.path.join(test_root, filename)
        # Sweep stale staging dirs from CRASHED prior runs (they carry other
        # pids) BEFORE the already-processed skip, so litter next to a
        # since-completed product is still reclaimed; without the sweep the
        # dataset's '*/ *enmap.tif' glob would pick up partial tiles (the
        # loader also defends by skipping '*.tmp*' dirs). Only dirs
        # untouched for >10 min are swept: a CONCURRENT run actively writing
        # its own staging dir must not be clobbered mid-product (tile writes
        # refresh the dir mtime continuously).
        for stale in glob.glob(f"{outdir}.tmp*"):
            try:
                idle = time.time() - os.path.getmtime(stale)
            except OSError:
                continue  # vanished (its owner just renamed it into place)
            if idle > 600:
                shutil.rmtree(stale, ignore_errors=True)
        if os.path.exists(outdir):
            print(f"{filename}: already processed, skipping")
            continue
        # write into a host+pid-unique temp dir and rename into place: a
        # crash mid-product must not leave a partial outdir that the skip
        # above would treat as complete on the next run (silently dropping
        # tiles). Host-unique because two HOSTS sharing an output dir (NFS)
        # can collide on bare pids, and the collider would rmtree the other
        # run's live staging as "its own stale dir".
        tmpdir = f"{outdir}.tmp{socket.gethostname()}-{os.getpid()}"
        if os.path.exists(tmpdir):  # our own host+pid, re-used: always stale
            shutil.rmtree(tmpdir)
        n = process_product(product, tmpdir, args.tile_size, args.upscale)
        os.makedirs(os.path.dirname(outdir) or ".", exist_ok=True)
        try:
            os.rename(tmpdir, outdir)
        except OSError:
            if os.path.exists(outdir):
                # a concurrent run finished this product first — its output
                # is complete; discard our duplicate staging and move on
                # instead of aborting the remaining products
                print(f"{filename}: completed by a concurrent run, skipping")
                shutil.rmtree(tmpdir, ignore_errors=True)
            else:
                raise
        else:
            print(f"{filename}: {n} valid tiles")


if __name__ == "__main__":
    main()
