"""The port's NOCS chain against the JAX package, on the CPU.

The NOCS mask fills (largest component, convex hull) bit for bit on rendered
masks, random blobs, a spiral, an empty and a full mask; the NOCS preset;
the loader and the export; the evaluation protocol and its app; a 6-frame
NOCS-preset trajectory against the JAX tracker with its RANSAC phases; and
the CLI chain run_tracking --dataset nocs -> eval_nocs with the bars of
tests/test_e2e_parity.py::TestE2ENocs.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from bundletrack_tpu.apps.eval_nocs import main as jax_eval_nocs
from bundletrack_tpu.config import KeyframeConfig, ShapeConfig
from bundletrack_tpu.config import SegmentationConfig as JaxSegmentationConfig
from bundletrack_tpu.config import nocs_config as jax_nocs_config
from bundletrack_tpu.data import nocs as jax_nocs
from bundletrack_tpu.data.export import export_nocs_sequence as jax_export_nocs
from bundletrack_tpu.eval import nocs_protocol as jproto
from bundletrack_tpu.eval import pose_errors
from bundletrack_tpu.ops import masks as jmasks
from bundletrack_tpu.tracker.driver import Tracker as JaxTracker
from bundletrack_tpu_torch.apps.eval_nocs import main as eval_nocs
from bundletrack_tpu_torch.apps.run_tracking import main as run_tracking
from bundletrack_tpu_torch.config import SegmentationConfig, load_config, nocs_config
from bundletrack_tpu_torch.data import render_synthetic_sequence
from bundletrack_tpu_torch.data.export import export_nocs_sequence
from bundletrack_tpu_torch.data.nocs import NocsLoader, class_id_for_model
from bundletrack_tpu_torch.eval import nocs_protocol as proto
from bundletrack_tpu_torch.kernels.matching import _thresholds
from bundletrack_tpu_torch.ops import masks
from bundletrack_tpu_torch.ops.numerics import cos_deg_f32, square_f32
from bundletrack_tpu_torch.tracker.driver import Tracker

torch.set_num_threads(2)

H, W = 120, 160
# 6-frame NOCS-preset trajectory against the JAX tracker (measured 1.5e-6 m
# and 1e-5 deg: f32 summation order only)
TRAJ_TRANS_TOL, TRAJ_ROT_TOL = 1e-5, 1e-4  # m, deg


# ---- mask fills ---------------------------------------------------------------


def _blobs(seed, shape=(96, 128)):
    rng = np.random.RandomState(seed)
    m = np.zeros(shape, bool)
    yy, xx = np.ogrid[: shape[0], : shape[1]]
    for _ in range(rng.randint(2, 7)):
        cy, cx, r = rng.randint(0, shape[0]), rng.randint(0, shape[1]), rng.randint(3, 20)
        m |= (yy - cy) ** 2 + (xx - cx) ** 2 < r * r
    return m & (rng.rand(*shape) > 0.05)  # speckle splits some blobs into several components


def _spiral(n):
    """A square spiral corridor one pixel wide, with about n / 2 bends: the
    fill needs 15 rounds at n=32 and 31 at n=64 (more than its 16)."""
    m = np.zeros((n, n), bool)
    y, x, d = 1, 1, 0
    lo, hi = 1, n - 2
    steps = [(0, 1), (1, 0), (0, -1), (-1, 0)]
    while hi - lo >= 2:
        dy, dx = steps[d % 4]
        length = hi - lo
        for _ in range(length):
            m[y, x] = True
            y, x = y + dy, x + dx
        d += 1
        if d % 4 == 3:
            lo += 2
        if d % 4 == 1 and d > 1:
            hi -= 2
    return m


def _fill_cases():
    seq = render_synthetic_sequence(num_frames=2, H=120, W=160, orbit_deg_per_frame=5.0)
    big = render_synthetic_sequence(num_frames=2, H=480, W=640, orbit_deg_per_frame=5.0)
    return {
        "rendered_120x160_f0": seq.mask[0], "rendered_120x160_f1": seq.mask[1],
        "rendered_480x640": big.mask[1],
        "blobs_0": _blobs(0), "blobs_1": _blobs(1), "blobs_2": _blobs(2),
        "spiral_32": _spiral(32), "spiral_64": _spiral(64),
        "empty": np.zeros((40, 50), bool), "full": np.ones((40, 50), bool),
    }


_CASES = _fill_cases()


@pytest.mark.parametrize("case", sorted(_CASES))
def test_mask_fills_are_bit_identical(case):
    m = _CASES[case]
    lcc = masks.largest_component_fill(torch.from_numpy(m)).numpy()
    np.testing.assert_array_equal(lcc, np.asarray(jmasks.largest_component_fill(jnp.asarray(m))))
    for src in (m, lcc):
        got = masks.convex_hull_fill(torch.from_numpy(src)).numpy()
        want = np.asarray(jmasks.convex_hull_fill(jnp.asarray(src)))
        assert np.array_equal(got, want), f"{case}: hull differs at {np.argwhere(got != want)[:10].tolist()}"
    if case == "empty":
        assert not lcc.any()
    if case == "full":
        assert lcc.all()


def test_spiral_needs_many_rounds_and_is_one_component():
    from scipy import ndimage

    m = _spiral(32)
    assert ndimage.label(m)[1] == 1  # one 4-connected component
    np.testing.assert_array_equal(masks.largest_component_fill(torch.from_numpy(m)).numpy(), m)
    few = masks.largest_component_fill(torch.from_numpy(m), num_iters=14).numpy()
    assert few.sum() < m.sum()  # 14 rounds do not reach every bend


def test_largest_component_is_scipys_largest():
    from scipy import ndimage

    for seed in range(4):
        m = _blobs(seed)
        labels, n = ndimage.label(m)
        sizes = np.bincount(labels.ravel())[1:]
        if np.sort(sizes)[-2:].tolist().count(sizes.max()) > 1:
            continue  # a tie in size; the fill takes the smallest pixel index
        got = masks.largest_component_fill(torch.from_numpy(m)).numpy()
        np.testing.assert_array_equal(got, labels == 1 + int(np.argmax(sizes)))


def test_preprocess_mask_nocs_chain():
    m = _CASES["blobs_1"]
    cfg = SegmentationConfig(seg_dilation_iter=1, nocs_mask_fill=True)
    got = masks.preprocess_mask(torch.from_numpy(m), cfg).numpy()
    want = np.asarray(jmasks.preprocess_mask(jnp.asarray(m), JaxSegmentationConfig(seg_dilation_iter=1,
                                                                                    nocs_mask_fill=True)))
    np.testing.assert_array_equal(got, want)


# ---- the preset, the loader, the protocol -------------------------------------


def test_nocs_config_equals_the_jax_preset():
    got, want = dataclasses.asdict(nocs_config()), dataclasses.asdict(jax_nocs_config())
    got.pop("debug_dir"), want.pop("debug_dir")  # a host path, not part of the contract
    want["feature_corres"].pop("backend")  # the port has one matcher route
    assert got == want
    # the loose neighbour gates: the port's thresholds equal the JAX package's
    fc = nocs_config().feature_corres
    assert square_f32(fc.max_dist_neighbor) == float(jnp.asarray(fc.max_dist_neighbor, jnp.float32) ** 2)
    assert cos_deg_f32(fc.max_normal_neighbor) == float(jnp.cos(jnp.deg2rad(jnp.float32(fc.max_normal_neighbor))))
    assert _thresholds(fc.max_dist_neighbor, fc.max_normal_neighbor) == (1e8, -1.0)


def test_class_id_for_model():
    for name in ("camera_mini", "mug_white", "bottle_red", "laptop_air", "unknown"):
        assert class_id_for_model(name) == jax_nocs.class_id_for_model(name)


class _PythonPrefetcher:
    """The JAX loader's prefetcher, decoding with the JAX package's own
    Python PNG reader (its native prefetcher races, ROADMAP item 9)."""

    def __init__(self, paths):
        self.paths = list(paths)

    def get(self, idx):
        from bundletrack_tpu.data.native_io import _read_png_python

        return _read_png_python(self.paths[idx])


def test_loader_and_export_equal_the_jax_ones(tmp_path, monkeypatch):
    seq = render_synthetic_sequence(num_frames=4, H=H, W=W, orbit_deg_per_frame=3.0, seed=5)
    ours = export_nocs_sequence(seq, str(tmp_path / "port"))
    theirs = jax_export_nocs(seq, str(tmp_path / "jax"))
    for a, b in zip(ours, theirs):
        if os.path.isdir(a):
            assert sorted(os.listdir(a)) == sorted(os.listdir(b))
            for name in sorted(os.listdir(a)):
                with open(os.path.join(a, name), "rb") as fa, open(os.path.join(b, name), "rb") as fb:
                    assert fa.read() == fb.read(), name
    monkeypatch.setattr(jax_nocs, "SequencePrefetcher", _PythonPrefetcher)
    scene, mask_dir, gt_dir, _ = ours
    loader = NocsLoader(scene, "camera_mini", mask_dir=mask_dir, gt_dir=gt_dir)
    ref = jax_nocs.NocsLoader(scene, "camera_mini", mask_dir=mask_dir, gt_dir=gt_dir)
    try:
        assert len(loader) == len(ref) == 4 and loader.ids == ref.ids and loader.scene_id == ref.scene_id == 1
        np.testing.assert_array_equal(loader.K, ref.K)
        np.testing.assert_array_equal(loader.init_pose_in_model, ref.init_pose_in_model)
        for i in (0, 3):
            a, b = loader[i], ref[i]
            for field in a._fields:
                np.testing.assert_array_equal(getattr(a, field), getattr(b, field), err_msg=field)
    finally:
        loader.close()
    with pytest.raises(FileNotFoundError, match="no frames"):
        NocsLoader(str(tmp_path), "camera_mini")


def test_loader_reads_the_6pack_datalist(tmp_path):
    seq = render_synthetic_sequence(num_frames=4, H=32, W=32)
    root = tmp_path / "real" / "real_test"
    scene, _, _, _ = export_nocs_sequence(seq, str(root))
    lst = tmp_path / "real" / "NOCS-REAL275-additional" / "data_list" / "real_val" / "3" / "camera_mini"
    lst.mkdir(parents=True)
    (lst / "list.txt").write_text("real_test/scene_1/0001\nreal_test/scene_2/0000\nreal_test/scene_1/0003\n")
    loader = NocsLoader(scene, "camera_mini", use_6pack_datalist=True)
    try:
        assert loader.ids == ["0001", "0003"]
        np.testing.assert_array_equal(loader[1].color[..., 0], (seq.gray[3] * 255 + 0.5).astype(np.uint8))
    finally:
        loader.close()


def _random_pose(rng):
    w = rng.randn(3)
    th = np.linalg.norm(w)
    k = w / th
    Kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    p = np.eye(4)
    p[:3, :3] = np.eye(3) + np.sin(th) * Kx + (1 - np.cos(th)) * Kx @ Kx
    p[:3, 3] = rng.randn(3) * 0.1 + [0, 0, 0.6]
    return p


@pytest.mark.parametrize("class_name,handle", [("camera", 1), ("bowl", 1), ("mug", 0), ("mug", 1), ("laptop", 1)])
def test_nocs_protocol_equals_jax(class_name, handle):
    rng = np.random.RandomState(0)
    bbox = (rng.rand(3, 8) - 0.5) * 0.2
    gts = [_random_pose(rng) for _ in range(5)]
    preds = [g @ _random_pose(np.random.RandomState(i)) if i % 2 else g.copy() for i, g in enumerate(gts)]
    preds[1][:3, 3] += 0.02  # near the gates
    for g, p in zip(gts, preds):
        assert proto.compute_3d_iou(g, p, bbox, class_name, handle) == jproto.compute_3d_iou(g, p, bbox, class_name,
                                                                                             handle)
        assert proto.degree_cm_error(g, p, class_name, handle) == jproto.degree_cm_error(g, p, class_name, handle)
    for rot in (0.0, 5.0):
        a = proto.perturb_init_pose(gts[0], 0.02, rot, np.random.RandomState(7))
        b = jproto.perturb_init_pose(gts[0], 0.02, rot, np.random.RandomState(7))
        np.testing.assert_array_equal(a, b)
        for x, y in zip(proto.reanchor_trajectory(preds, a), jproto.reanchor_trajectory(preds, b)):
            np.testing.assert_array_equal(x, y)
    assert proto.evaluate_nocs(preds, gts, bbox, class_name, handle) == jproto.evaluate_nocs(preds, gts, bbox,
                                                                                          class_name, handle)


def _write_pose_dirs(tmp_path, n, step):
    gt_dir, pred_dir = tmp_path / "gt", tmp_path / "pred"
    os.makedirs(gt_dir)
    os.makedirs(pred_dir)
    for i in range(n):
        th = 0.05 * i
        p = np.eye(4)
        p[:3, :3] = [[np.cos(th), -np.sin(th), 0], [np.sin(th), np.cos(th), 0], [0, 0, 1]]
        p[:3, 3] = [step[0] * i, step[1] * i, 0.6]
        np.savetxt(gt_dir / f"{i:04d}.txt", p)
        np.savetxt(pred_dir / f"{i:04d}.txt", p)
    return str(gt_dir), str(pred_dir)


@pytest.mark.parametrize("class_name,noise", [("camera", "0"), ("bowl", "0.02")])
def test_eval_nocs_app(tmp_path, class_name, noise):
    """tests/test_cloud_utils_and_new_apps.py::TestEvalNocsApp on the port,
    and the same JSON as the JAX app."""
    gt_dir, pred_dir = _write_pose_dirs(tmp_path, 6, (0.01, 0.005))
    model = tmp_path / "model.xyz"
    np.savetxt(model, np.random.RandomState(0).rand(200, 3) * 0.2 - 0.1)
    args = ["--pred_dir", pred_dir, "--gt_dir", gt_dir, "--model", str(model), "--class_name", class_name,
            "--noise_trans", noise]
    out = eval_nocs(args)
    assert out == jax_eval_nocs(args)
    if noise == "0":  # identical trajectories score perfectly
        assert out["IoU25"] == 100.0 and out["5deg5cm"] == 100.0
    else:  # the translation error equals the injected noise (<= ~3.5 cm) every frame
        assert out["IoU25"] > 0 and out["trans_err_cm_mean"] < 4.0
    assert out["missing"] == 0


# ---- the tracker on the NOCS preset ------------------------------------------


def _phases_from_key(rng_key, cfg):
    """The RANSAC phases the JAX step draws from its state's key, as in
    tests/test_torch_tracker.py."""
    M = cfg.shapes.max_matches
    n_rep = -(-cfg.ransac.max_iter // M)
    K = cfg.bundle.max_ba_frames
    _, kn, km = jax.random.split(rng_key, 3)
    draw = lambda k: jax.random.randint(k, (3, n_rep), 0, M, dtype=jnp.int32)  # noqa: E731
    return np.asarray(draw(kn)), np.asarray(jax.vmap(draw)(jax.random.split(km, K * (K - 1) // 2)))


def test_nocs_preset_trajectory_matches_jax():
    """Six frames through both trackers with the NOCS preset (loose
    neighbour gates, mask fills); the port takes the JAX step's RANSAC
    phases."""
    base = jax_nocs_config()
    jcfg = base.replace(
        bundle=dataclasses.replace(base.bundle, max_ba_frames=4),
        keyframe=KeyframeConfig(pool_size=8, min_rot=5.0),
        frontend=dataclasses.replace(base.frontend, top_k=128),
        ransac=dataclasses.replace(base.ransac, max_iter=256),
        feature_corres=dataclasses.replace(base.feature_corres, backend="pallas_interpret"),
        shapes=ShapeConfig(max_matches=128, image_h=H, image_w=W),
    )
    pcfg = load_config(dataclasses.asdict(jcfg), nocs_config())
    assert pcfg.segmentation.nocs_mask_fill and pcfg.feature_corres.max_normal_neighbor == 180.0
    seq = render_synthetic_sequence(num_frames=6, H=H, W=W, orbit_deg_per_frame=3.0, seed=5)
    init_pose = np.linalg.inv(seq.ob_in_cam[0])
    jtrk = JaxTracker(jcfg, H, W)
    ttrk = Tracker(pcfg, H, W, device="cpu")
    for f in range(6):
        phases = _phases_from_key(jtrk.state.rng_key, jcfg)
        j = jax.tree.map(np.array, jtrk.process_frame(seq.gray[f], seq.depth[f], seq.mask[f], seq.K, init_pose))
        t = ttrk.process_frame(seq.gray[f], seq.depth[f], seq.mask[f], seq.K, init_pose, phases=phases)
        assert int(t.status) == int(j.status) == 0, f
        rot, trans = pose_errors(t.ob_in_cam.numpy(), j.ob_in_cam)
        print(f"frame {f}: port vs JAX {rot:.2e} deg {trans:.2e} m")
        assert rot < TRAJ_ROT_TOL and trans < TRAJ_TRANS_TOL, (f, rot, trans)


@pytest.mark.parametrize("args,raw", [(["--dataset", "nocs"], {}), ([], {"use_6pack_datalist": True})],
                         ids=["flag", "auto"])
def test_nocs_cli_chain(tmp_path, args, raw):
    """tests/test_e2e_parity.py::TestE2ENocs on the port: NOCS layout on
    disk -> run_tracking (NOCS preset) -> eval_nocs (init-pose noise +
    re-anchoring).  With `auto`, use_6pack_datalist picks the dataset and
    the 6-PACK list names every frame."""
    seq = render_synthetic_sequence(num_frames=12, H=H, W=W, orbit_deg_per_frame=3.0, seed=5)
    root = tmp_path / "real" / "real_test"
    scene, mask_dir, gt_dir, model_path = export_nocs_sequence(seq, str(root))
    if raw:
        lst = tmp_path / "real" / "NOCS-REAL275-additional" / "data_list" / "real_val" / "3" / "camera_mini"
        lst.mkdir(parents=True)
        (lst / "list.txt").write_text("".join(f"real_test/scene_1/{f:04d}\n" for f in range(12)))
    out_dir = str(tmp_path / "out")
    cfg_yaml = str(tmp_path / "config.yml")
    with open(cfg_yaml, "w") as f:
        yaml.safe_dump({"data_dir": scene, "mask_dir": mask_dir, "model_name": "camera_mini", "debug_dir": out_dir,
                        "LOG": 0, "use_6pack_datalist": False,
                        "bundle": {"max_BA_frames": 8, "dense_src_capacity": 512}, "keyframe": {"pool_size": 8},
                        "frontend": {"top_k": 256}, "ransac": {"max_iter": 512}, "shapes": {"max_matches": 128},
                        **raw}, f)
    tracker = run_tracking([cfg_yaml, "--device", "cpu", *args])
    assert tracker.cfg.segmentation.nocs_mask_fill and tracker.cfg.bundle.min_fm_edges_newframe == 10
    res = eval_nocs(["--pred_dir", os.path.join(out_dir, "poses"), "--gt_dir", gt_dir, "--model", model_path,
                     "--class_name", "camera", "--noise_trans", "0.02", "--seed", "0"])
    print(json.dumps(res))
    assert res["missing"] == 0
    assert res["IoU25"] > 90.0, res
    assert res["5deg5cm"] > 70.0, res
