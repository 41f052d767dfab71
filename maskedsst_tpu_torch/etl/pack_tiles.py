"""Pack a tile dataset into the ``.msts`` tile store, once, so that training
reads one memory-mapped file instead of one GeoTIFF per tile and epoch:

  python -m maskedsst_tpu_torch.etl.pack_tiles --dataset dfc \
      --train-path data/enmap_dfc_dataset/MexicoCity/train --out dfc_train.msts
  python -m maskedsst_tpu_torch.etl.pack_tiles --synthetic --out synth.msts

Reading GeoTIFF tiles needs rasterio (``--dataset``); ``--synthetic`` packs
seeded SyntheticCubeDataset tiles and needs nothing. Point a config's
``train_path`` at the ``.msts`` file to train from it.
"""

from __future__ import annotations

import argparse


def main(argv=None) -> str:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--out", required=True)
    parser.add_argument("--dataset", default="enmap", choices=["enmap", "dfc", "worldcover"])
    parser.add_argument("--train-path", default=None)
    parser.add_argument("--target-type", default=None, help="worldcover|dfc|unlabeled")
    parser.add_argument("--synthetic", action="store_true")
    parser.add_argument("--synthetic-tiles", type=int, default=256)
    parser.add_argument("--n-bands", type=int, default=200)
    parser.add_argument("--unlabeled", action="store_true",
                        help="synthetic tiles without labels (a pretraining store)")
    args = parser.parse_args(argv)

    from maskedsst_tpu_torch.native import pack_tiles

    if args.synthetic:
        from maskedsst_tpu_torch.data.synthetic import SyntheticCubeDataset

        ds = SyntheticCubeDataset(num_tiles=args.synthetic_tiles, n_bands=args.n_bands,
                                  labeled=not args.unlabeled)
    else:
        from maskedsst_tpu_torch.data.enmap import EnMAPWorldCoverDataset

        if not args.train_path:
            parser.error("--train-path is required without --synthetic")
        target = args.target_type or ("dfc" if args.dataset == "dfc" else "worldcover")
        ds = EnMAPWorldCoverDataset(args.train_path, target_type=target)

    pack_tiles(ds, args.out)
    print(f"packed {len(ds)} tiles -> {args.out}")
    return args.out


if __name__ == "__main__":
    main()
