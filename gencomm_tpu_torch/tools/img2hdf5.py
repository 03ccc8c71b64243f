"""Pack OPV2V camera PNGs into one ``<timestamp>_imgs.hdf5`` a frame.

Counterpart of ``gencomm_tpu/tools/img2hdf5.py`` (the reference's
dataset-preparation step: camera0..3 of a timestamp in one hdf5, which the
loader reads in one call):

    python -m gencomm_tpu_torch.tools.img2hdf5 --root dataset/OPV2V/train \
        [--overwrite]

PIL and h5py are imported when a directory is packed.
"""

from __future__ import annotations

import argparse
import glob
import os

import numpy as np


def pack_scenario(cav_dir: str, cameras=(0, 1, 2, 3),
                  overwrite: bool = False) -> int:
    """Bundle every timestamp's camera PNGs of one CAV directory; returns
    the number of frames written (an existing file is kept unless
    ``overwrite``)."""
    import h5py
    from PIL import Image

    stamps = sorted({os.path.basename(p).split("_")[0]
                     for p in glob.glob(os.path.join(cav_dir,
                                                     "*_camera0.png"))})
    n = 0
    for ts in stamps:
        out = os.path.join(cav_dir, f"{ts}_imgs.hdf5")
        if os.path.exists(out) and not overwrite:
            continue
        with h5py.File(out, "w") as f:
            for cam in cameras:
                png = os.path.join(cav_dir, f"{ts}_camera{cam}.png")
                if not os.path.exists(png):
                    continue
                f.create_dataset(f"camera{cam}",
                                 data=np.asarray(Image.open(png)),
                                 compression="gzip", compression_opts=4)
        n += 1
    return n


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", required=True,
                    help="an OPV2V split directory (scenario/cav/frames)")
    ap.add_argument("--overwrite", action="store_true")
    args = ap.parse_args(argv)
    total = 0
    for scenario in sorted(os.listdir(args.root)):
        sdir = os.path.join(args.root, scenario)
        if not os.path.isdir(sdir):
            continue
        for cav in sorted(os.listdir(sdir)):
            cdir = os.path.join(sdir, cav)
            if os.path.isdir(cdir):
                total += pack_scenario(cdir, overwrite=args.overwrite)
    print(f"packed {total} frames")
    return total


if __name__ == "__main__":
    main()
