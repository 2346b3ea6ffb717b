"""The DetMatch SSL split files under ``<root>/ssl_splits`` (counterpart
of ``tools/create_ssl_splits.py``, whose files it writes equal). Per
labeled fraction ``frac`` and split index ``s``:

* ``kitti_infos_train_proj_3d_lab_{frac}_{s}.pkl`` — the labeled frames'
  infos, each frame's 2D gt (``annos['bbox']``) replaced by the
  projection of its 3D gt box clipped to the image (boxes behind the
  camera or out of view keep the label file's);
* ``kitti_infos_train_unlab_{frac}_{s}.pkl`` — the other frames, annos
  untouched;
* ``kitti_dbinfos_train_lab_{frac}_{s}.pkl`` — the gt database limited to
  objects of the labeled frames (a global database would paste
  unlabeled frames' objects into training scenes).

Also the global ``kitti_infos_train_proj_3d.pkl``. Fractions are named as
Python formats the float (``0.01``, ``0.2``). The labeled frames of
(frac, s): ``max(1, round(n * frac))`` frames drawn without replacement
by ``RandomState(seed * 1000 + s)``.

Usage:
    python -m detmatch_tpu_torch.tools.create_ssl_splits --root data/kitti
        [--fracs 0.01 0.02 0.2] [--num-splits 3] [--seed 3]
"""
from __future__ import annotations

import argparse
import copy
import os
import pickle

import numpy as np

from ..data import kitti
from ..data.np_geometry import boxes_3d_to_2d


def project_annos_bbox(info):
    """A copy of ``info`` whose non-DontCare ``annos['bbox']`` rows are the
    projected 3D boxes."""
    info = copy.deepcopy(info)
    annos = info["annos"]
    calib = kitti.calib_from_info(info)
    boxes, _, keep = kitti.annos_to_lidar_boxes(annos, calib)
    if len(boxes):
        h, w = info["image"]["image_shape"][:2]
        bb2d, ok = boxes_3d_to_2d(boxes, calib.lidar2img, img_shape=(h, w))
        new_bbox = annos["bbox"].astype(np.float32).copy()
        rows = np.flatnonzero(keep)
        new_bbox[rows[ok]] = bb2d.astype(np.float32)[ok]
        annos["bbox"] = new_bbox
    return info


def labeled_indices(n_frames, frac, split, seed):
    """The sorted labeled frame indices of (frac, split)."""
    rng = np.random.RandomState(seed * 1000 + split)
    n_lab = max(1, int(round(n_frames * frac)))
    return np.sort(rng.permutation(n_frames)[:n_lab])


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", required=True)
    ap.add_argument("--train-infos", default="kitti_infos_train.pkl")
    ap.add_argument("--db-infos", default="kitti_dbinfos_train.pkl")
    ap.add_argument("--fracs", type=float, nargs="+",
                    default=[0.01, 0.02, 0.2])
    ap.add_argument("--num-splits", type=int, default=3)
    ap.add_argument("--seed", type=int, default=3)
    args = ap.parse_args(argv)

    with open(os.path.join(args.root, args.train_infos), "rb") as f:
        infos = pickle.load(f)
    out_dir = os.path.join(args.root, "ssl_splits")
    os.makedirs(out_dir, exist_ok=True)

    proj = [project_annos_bbox(i) for i in infos]
    gpath = os.path.join(args.root, "kitti_infos_train_proj_3d.pkl")
    with open(gpath, "wb") as f:
        pickle.dump(proj, f)
    print(f"wrote {gpath} ({len(proj)} frames)")

    db_path = os.path.join(args.root, args.db_infos)
    db_infos = None
    if os.path.exists(db_path):
        with open(db_path, "rb") as f:
            db_infos = pickle.load(f)
    else:
        print(f"WARNING: {db_path} missing — per-split gt databases skipped "
              "(run detmatch_tpu_torch.tools.create_data first)")

    for frac in args.fracs:
        for s in range(args.num_splits):
            lab_idx = labeled_indices(len(infos), frac, s, args.seed)
            lab_set = {int(infos[i]["image"]["image_idx"]) for i in lab_idx}
            lab = [proj[i] for i in lab_idx]
            unlab = [infos[i] for i in range(len(infos))
                     if i not in set(lab_idx.tolist())]
            tag = f"{frac}_{s}"
            for name, obj in (
                    (f"kitti_infos_train_proj_3d_lab_{tag}.pkl", lab),
                    (f"kitti_infos_train_unlab_{tag}.pkl", unlab)):
                with open(os.path.join(out_dir, name), "wb") as f:
                    pickle.dump(obj, f)
            msg = f"split {tag}: {len(lab)} labeled / {len(unlab)} unlabeled"
            if db_infos is not None:
                db_lab = {cls: [e for e in entries
                                if int(e["image_idx"]) in lab_set]
                          for cls, entries in db_infos.items()}
                with open(os.path.join(
                        out_dir, f"kitti_dbinfos_train_lab_{tag}.pkl"),
                        "wb") as f:
                    pickle.dump(db_lab, f)
                n_obj = sum(len(v) for v in db_lab.values())
                msg += f", {n_obj} DB objects (labeled frames only)"
            print(msg)


if __name__ == "__main__":
    main()
