"""CPU parity of the port's data layer (``detmatch_tpu_torch/data``:
``np_geometry``, ``kitti``, ``pipelines``, ``dbsampler``, ``collate``,
``loader``, and ``apis/build.py:build_dataset``) against the JAX
package, on generated mini-KITTI trees (``tests/kitti_fixture.py``).

Everything is compared exactly (values and dtypes): the layer is numpy in
both packages. Random transforms get two ``RandomState``s with one seed
and are called in the same order; the JAX collision test is its jitted
jnp kernel, the port's the torch twin on CPU tensors, and the boolean
they give must agree. The loader's shared ``RandomState`` makes its
batches depend on thread interleaving, so the loader is checked by its
index stream; datasets by ``dataset[i]`` in order.
"""
import os
import pickle
import sys
import threading

import numpy as np
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from detmatch_tpu.apis import build as jbuild  # noqa: E402
from detmatch_tpu.core import geometry as jgeo  # noqa: E402
from detmatch_tpu.data import collate as jcollate  # noqa: E402
from detmatch_tpu.data import dbsampler as jdb  # noqa: E402
from detmatch_tpu.data import kitti as jkitti  # noqa: E402
from detmatch_tpu.data import loader as jloader  # noqa: E402
from detmatch_tpu.data import pipelines as jpipe  # noqa: E402
from detmatch_tpu_torch.apis import build as pbuild  # noqa: E402
from detmatch_tpu_torch.config import Config  # noqa: E402
from detmatch_tpu_torch.data import collate as pcollate  # noqa: E402
from detmatch_tpu_torch.data import dbsampler as pdb  # noqa: E402
from detmatch_tpu_torch.data import kitti as pkitti  # noqa: E402
from detmatch_tpu_torch.data import loader as ploader  # noqa: E402
from detmatch_tpu_torch.data import np_geometry as pgeo  # noqa: E402
from detmatch_tpu_torch.data import pipelines as ppipe  # noqa: E402
from kitti_fixture import make_kitti, make_kitti_random  # noqa: E402
from torch_port_ssl_fixture import one_torch_thread  # noqa: E402,F401

ROOT = os.path.join(os.path.dirname(__file__), "..")
SSL_CONFIG = os.path.join(ROOT, "configs/detmatch/001/detmatch/split_0.py")


def assert_same(a, b, where="x"):
    """Equal trees: dicts, lists and tuples by item, arrays by dtype,
    shape and value (NaNs equal), scalars by value and type."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), (
            where, set(a) ^ set(b))
        for k in a:
            assert_same(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{where}[{i}]")
    elif isinstance(a, (np.ndarray, np.generic)):
        b = np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, (
            where, a.dtype, b.dtype, a.shape, b.shape)
        if a.dtype.kind in "fc":
            np.testing.assert_array_equal(a, b, err_msg=where)
        else:
            assert np.array_equal(a, b), where
    else:
        assert type(a) is type(b) and a == b, (where, a, b)


def write_infos(root, infos, name):
    path = os.path.join(root, name)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(infos, f)
    return path


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """A 3-frame fixed tree (DontCare rows, clusters at the objects)."""
    root = str(tmp_path_factory.mktemp("kitti"))
    split = make_kitti(root)
    return root, split


@pytest.fixture(scope="module")
def split_tree(tmp_path_factory):
    """A 5-frame random tree laid out as ``split_0.py`` reads it: the
    train infos as both the labeled and the unlabeled split (the labeled
    2D boxes are the projected 3D ones already), the labeled gt database
    and the val infos."""
    root = str(tmp_path_factory.mktemp("kitti_split"))
    split = make_kitti_random(root, 5, seed=4, x_range=(6.0, 40.0),
                              max_objects=4)
    infos = pkitti.create_infos(root, split)
    write_infos(root, infos, "kitti_infos_val.pkl")
    for name in ("kitti_infos_train_proj_3d_lab_0.01_0.pkl",
                 "kitti_infos_train_unlab_0.01_0.pkl"):
        write_infos(root, infos, os.path.join("ssl_splits", name))
    pdb.create_gt_database(
        root, infos, ["Pedestrian", "Cyclist", "Car"],
        db_info_path="ssl_splits/kitti_dbinfos_train_lab_0.01_0.pkl")
    return root


# ---------------------------------------------------------------------------
# np_geometry against the numpy branch of core/geometry.py
# ---------------------------------------------------------------------------

def _boxes(rng, n):
    b = np.zeros((n, 7), np.float32)
    b[:, :2] = rng.rand(n, 2) * 30 - [0, 15]
    b[:, 2] = rng.rand(n) - 1
    b[:, 3:6] = rng.rand(n, 3) * 3 + 0.5
    b[:, 6] = rng.rand(n) * 7 - 3.5
    return b


GEOMETRY_CASES = {
    "limit_period": lambda r: ((r.rand(9).astype(np.float32) * 20 - 10,),
                               dict(offset=0.5, period=2 * np.pi)),
    "rotation_matrix_z": lambda r: ((r.rand(5).astype(np.float32),), {}),
    "rotate_points_z": lambda r: ((r.rand(7, 4).astype(np.float32),
                                   np.float32(0.7)), {}),
    "boxes_to_corners_3d": lambda r: ((_boxes(r, 6),), {}),
    "boxes_to_corners_bev": lambda r: ((_boxes(r, 6),), {}),
    "boxes_to_bev": lambda r: ((_boxes(r, 6),), {}),
    "points_in_boxes": lambda r: ((r.rand(50, 3).astype(np.float32) * 20,
                                   _boxes(r, 4)), {}),
    "flip_boxes": lambda r: ((_boxes(r, 5),), dict(axis="y")),
    "flip_points": lambda r: ((r.rand(6, 4).astype(np.float32),),
                              dict(axis="x")),
    "boxes_camera_to_lidar": lambda r: ((_boxes(r, 5),
                                         r.rand(4, 4).astype(np.float32)),
                                        {}),
    "boxes_lidar_to_camera": lambda r: ((_boxes(r, 5),
                                         r.rand(4, 4).astype(np.float32)),
                                        {}),
    "project_to_image": lambda r: ((r.rand(6, 3).astype(np.float32) * 9,
                                    r.rand(4, 4).astype(np.float32)), {}),
    "boxes_3d_to_2d": lambda r: ((_boxes(r, 6) + [5, 0, 0, 0, 0, 0, 0],
                                  np.array([[0, -700, 0, 600],
                                            [0, 0, -700, 180],
                                            [1, 0, 0, 0], [0, 0, 0, 1]],
                                           np.float32)),
                                 dict(img_shape=np.array([375, 1242]))),
    "mask_boxes_outside_range": lambda r: ((_boxes(r, 8),
                                            [0, -8, -3, 16, 8, 1]), {}),
    "mask_points_by_range": lambda r: ((r.rand(30, 4).astype(np.float32)
                                        * 20 - 5, [0, -8, -3, 16, 8, 1]),
                                       {}),
    "in_range_bev": lambda r: ((_boxes(r, 8), [0, -8, -3, 16, 8, 1]), {}),
}


@pytest.mark.parametrize("name", sorted(GEOMETRY_CASES))
def test_np_geometry_matches_jax_numpy_branch(name):
    args, kw = GEOMETRY_CASES[name](np.random.RandomState(3))
    assert_same(getattr(pgeo, name)(*args, **kw),
                getattr(jgeo, name)(*args, **kw), name)


# ---------------------------------------------------------------------------
# kitti: infos, the gt database, export_2d_annotation
# ---------------------------------------------------------------------------

def test_create_infos_match_jax(tree):
    root, split = tree
    infos = pkitti.create_infos(root, split)
    assert len(infos) == 3 and "num_points_in_gt" in infos[0]["annos"]
    assert_same(infos, jkitti.create_infos(root, split), "infos")


def test_gt_database_matches_jax(tree):
    root, split = tree
    infos = pkitti.create_infos(root, split)
    out = {}
    for tag, mod in (("port", pdb), ("jax", jdb)):
        out[tag] = mod.create_gt_database(
            root, infos, ["Pedestrian", "Cyclist", "Car"],
            out_dir=f"gt_{tag}", db_info_path=f"db_{tag}.pkl")
        with open(os.path.join(root, f"db_{tag}.pkl"), "rb") as f:
            assert_same(out[tag], pickle.load(f), f"{tag} pickle")
    assert sum(len(v) for v in out["port"].values()) == 5
    for cls, entries in out["port"].items():
        for e, j in zip(entries, out["jax"][cls]):
            pe, je = os.path.join(root, e["path"]), os.path.join(root,
                                                                 j["path"])
            with open(pe, "rb") as f, open(je, "rb") as g:
                assert f.read() == g.read()
            e, j = dict(e), dict(j)
            e.pop("path"), j.pop("path")
            assert_same(e, j, cls)


def test_export_2d_annotation_matches_jax(tree, tmp_path):
    root, split = tree
    info_path = write_infos(str(tmp_path), pkitti.create_infos(root, split),
                            "infos.pkl")
    ours = pkitti.export_2d_annotation(root, info_path,
                                       out_path=str(tmp_path / "p.json"))
    theirs = jkitti.export_2d_annotation(root, info_path,
                                         out_path=str(tmp_path / "j.json"))
    assert ours == theirs and len(ours["annotations"]) == 5
    assert (tmp_path / "p.json").read_text() == (tmp_path / "j.json"
                                                 ).read_text()


# ---------------------------------------------------------------------------
# pipelines: every transform of the registry, ObjectSample, TSDataset
# ---------------------------------------------------------------------------

PCR = [0.0, -40.0, -3.0, 70.4, 40.0, 1.0]
TRANSFORMS = {
    "LoadPoints": dict(load_dim=4, use_dim=4),
    "LoadImage": {},
    "Resize": dict(img_scale=((640, 192), (2560, 768))),
    "RandomFlip3D": dict(flip_ratio=0.5),
    "GlobalRotScaleTrans": dict(translation_std=(0.2, 0.2, 0.1)),
    "ObjectNoise": {},
    "PointsRangeFilter": dict(point_cloud_range=PCR),
    "ObjectRangeFilter": dict(point_cloud_range=[0.0, -5, -3, 14, 5, 1]),
    "PointShuffle": {},
    "PhotoMetricAugs": {},
    "Normalize": {},
    "PadToCanvas": dict(canvas=(384, 1280)),
    "MultiScaleFlipAug3D": dict(
        transforms=[dict(type="PointsRangeFilter", point_cloud_range=PCR)],
        flip=True, pcd_horizontal_flip=True, pcd_vertical_flip=True,
        pts_scale_ratio=[1.0, 0.9]),
}


def _loaded(root, split, idx, mod):
    infos = mod.create_infos(root, split)
    path = write_infos(root, infos, f"infos_{mod.__name__}.pkl")
    ds = mod.KittiDataset(root, path)
    return mod.__name__, ds[idx]


def _run(build_mod, pipe_mod, cfgs, results, seed, root=None):
    rng = np.random.RandomState(seed)
    steps = build_mod.build_pipeline(cfgs, root=root, rng=rng)
    for _ in range(3):  # three draws of each random transform
        out = pipe_mod.Compose(steps)(dict(results))
    return out, rng.randint(1 << 30)


@pytest.mark.parametrize("name", sorted(TRANSFORMS))
def test_transform_matches_jax(tree, name):
    """Each transform on a loaded frame (points, image, 3D and 2D gt),
    called three times on one ``RandomState``: the result and the state's
    next draw equal JAX's."""
    root, split = tree
    base = jkitti.KittiDataset(
        root, write_infos(root, jkitti.create_infos(root, split),
                          "infos_base.pkl"))[1]
    base = jpipe.LoadImage()(jpipe.LoadPoints()(base))
    cfg = dict(TRANSFORMS[name], type=name)
    if name == "MultiScaleFlipAug3D":
        cfg["transforms"] = [jbuild.build_pipeline(cfg["transforms"])[0]]
        ours_cfg = dict(TRANSFORMS[name], type=name)
        ours_cfg["transforms"] = [pbuild.build_pipeline(
            ours_cfg["transforms"])[0]]
    else:
        ours_cfg = cfg
    ours = _run(pbuild, ppipe, [ours_cfg], base, 11)
    theirs = _run(jbuild, jpipe, [cfg], base, 11)
    assert_same(ours, theirs, name)


def test_object_sample_matches_jax(split_tree):
    """``ObjectSample`` (the gt database, collision rejection with the
    torch overlap on the port's side, the 2D projection) on a loaded
    labeled frame: equal results and gt counts above the labels'."""
    cfg = Config.fromfile(SSL_CONFIG)
    sample = dict(cfg["shared_pipeline"][2], type="ObjectSample")
    info = os.path.join(split_tree, "kitti_infos_val.pkl")
    base = jkitti.KittiDataset(split_tree, info)[0]
    base = jpipe.LoadImage()(jpipe.LoadPoints()(base))
    n_gt = len(base["gt_bboxes_3d"])
    for seed in (0, 1):
        ours = _run(pbuild, ppipe, [sample], base, seed, root=split_tree)
        theirs = _run(jbuild, jpipe, [sample], base, seed, root=split_tree)
        assert_same(ours, theirs, f"seed {seed}")
        assert len(ours[0]["gt_bboxes_3d"]) > n_gt


def _split_datasets(mod, root, rng_seed):
    cfg = Config.fromfile(SSL_CONFIG)
    rng = np.random.RandomState(rng_seed)
    out = []
    for key in ("train_lab", "train_unlab", "val"):
        d = dict(cfg["data"][key])
        inner = dict(d.get("dataset", d))
        inner["data_root"] = root
        inner["ann_file"] = os.path.join(
            root, inner["ann_file"][len(cfg["data_root"]):])
        if "dataset" in d:
            d["dataset"] = inner
        else:
            d = inner
        out.append(mod.build_dataset(d, rng=rng))
    return out


def test_split_datasets_and_collate_match_jax(split_tree):
    """``build_dataset`` on ``split_0.py``'s data section (labeled and
    unlabeled ``TSDataset``s, the val set), ``dataset[i]`` in order on
    one ``RandomState`` per package: every sample, and ``collate_ts`` /
    ``collate_view`` of them (the aug records field by field against
    JAX's NamedTuples), equal JAX's."""
    ours = _split_datasets(pbuild, split_tree, 5)
    theirs = _split_datasets(jbuild, split_tree, 5)
    assert len(ours[0]) == 500 and len(ours[1]) == 5
    ck = Config.fromfile(SSL_CONFIG)["data"]["collate"]
    for k, (ds, jds) in enumerate(zip(ours, theirs)):
        samples = [ds[i] for i in (0, 1)]
        jsamples = [jds[i] for i in (0, 1)]
        assert_same(samples, jsamples, f"dataset {k}")
        fn = (pcollate.collate_view if k == 2 else pcollate.collate_ts)
        jfn = (jcollate.collate_view if k == 2 else jcollate.collate_ts)
        got, want = fn(samples, **ck), jfn(jsamples, **ck)
        if k == 0:
            stu = got["stu"]
        for view, jview in ((got, want),) if k == 2 else (
                (got["stu"], want["stu"]), (got["tea"], want["tea"])):
            for rec in ("aug3d", "aug2d"):
                assert isinstance(view[rec], dict)
                jview[rec] = jview[rec]._asdict()
            assert_same(view, jview, f"collate {k}")
    assert stu["points"].shape == (2, ck["max_points"], 4)
    assert stu["img"].shape == (2, 384, 1280, 3)
    assert stu["gt_boxes"].shape == (2, ck["max_gt"], 8)


# ---------------------------------------------------------------------------
# loader
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,bs,shuffle,drop_last", [
    (10, 4, True, True), (10, 4, True, False), (10, 4, False, False),
    (3, 4, True, True), (1, 4, True, False), (3, 5, False, True)])
def test_loader_index_stream_matches_jax(n, bs, shuffle, drop_last):
    """The first 12 batches of indices, including a dataset smaller than
    the batch (tiled with fresh permutations, as JAX does)."""
    kw = dict(shuffle=shuffle, seed=7, drop_last=drop_last)
    ours = ploader.Loader(range(n), bs, list, **kw)._index_stream()
    theirs = jloader.Loader(range(n), bs, list, **kw)._index_stream()
    for _ in range(12):
        assert_same(next(ours), next(theirs))


def test_epoch_batches_matches_jax():
    """The ordered pass pads its last batch with the final sample."""
    ds = [dict(points=np.full((2, 4), i, np.float32)) for i in range(5)]

    def coll(samples):
        return np.stack([s["points"] for s in samples])

    assert_same(list(ploader.epoch_batches(ds, 2, coll)),
                list(jloader.epoch_batches(ds, 2, coll)))


class _Indexed:
    """A dataset whose sample i is i, slow enough for the threads to
    interleave; ``fail`` raises at that index."""

    def __init__(self, n, fail=None):
        self.n, self.fail = n, fail

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        if i == self.fail:
            raise KeyError(i)
        threading.Event().wait(0.001)
        return int(i)


def test_loader_batches_follow_the_index_stream_and_stop():
    """With 4 workers each batch holds the stream's indices in order;
    ``stop`` ends the prefetch thread although its queue is full."""
    loader = ploader.Loader(_Indexed(9), 4, list, seed=3, num_workers=4)
    stream = ploader.Loader(_Indexed(9), 4, list, seed=3)._index_stream()
    it = iter(loader)
    for _ in range(6):
        assert next(it) == [int(i) for i in next(stream)]
    loader.stop(timeout=10.0)
    assert not loader._thread.is_alive()


def test_loader_raises_the_dataset_error():
    loader = ploader.Loader(_Indexed(6, fail=2), 6, list, shuffle=False)
    with pytest.raises(KeyError):
        next(iter(loader))
    loader.stop(timeout=10.0)
    assert not loader._thread.is_alive()
