"""Coverage scoring in the PyTorch port against the JAX package, on the CPU:
the port's spray simulator (``maskplanner_tpu_torch/sim``) bitwise equal to
``maskplanner_tpu.sim`` on the same seeded inputs, its coverage metric equal
to the repo-root ``standalone/`` one, its program export equal to the
repo-root tool's on a port run's final-eval dumps (to 1e-9), and its three
tools chained on the fixture category closing the GT round trip.
"""
import os
import shutil
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__))), "standalone"))

from maskplanner_tpu import sim as jax_sim  # noqa: E402
from maskplanner_tpu_torch import sim  # noqa: E402

torch.set_num_threads(1)

CATEGORY = "minibox-v1"
# the JAX package's coverage loop (tests/test_spray_sim.py) at its sizes
RUN_ARGS = ["config=[maskplanner,cuboids_v2,longx_v2,debug]",
            f"dataset={CATEGORY}", "pc_points=64", "traj_points=240",
            "n_pred_traj_points=120", "batch_size=2", "epochs=2",
            "eval_freq=2", "no_save=false", "seed=0",
            "data_scale_factor=700.0", "max_n_strokes=8",
            "traj_with_equally_spaced_points=false", "device=cpu",
            "model.hidden_size=[32,32]", "skip_rendering=true"]


def _box(path, dims=(2.0, 1.0, 1.5), center=(0.3, -0.2, 0.1)):
    corners = np.array([[x, y, z] for x in (-1, 1) for y in (-1, 1)
                        for z in (-1, 1)], np.float64)
    verts = corners * np.asarray(dims) / 2 + np.asarray(center)
    faces = np.array([(0, 1, 3), (0, 3, 2), (4, 6, 7), (4, 7, 5), (0, 4, 5),
                      (0, 5, 1), (2, 3, 7), (2, 7, 6), (0, 2, 6), (0, 6, 4),
                      (1, 5, 7), (1, 7, 3)], np.int64)
    with open(path, "w") as fh:
        fh.writelines(f"v {a} {b} {c}\n" for a, b, c in verts)
        fh.writelines(f"f {a + 1} {b + 1} {c + 1}\n" for a, b, c in faces)
    return verts, faces


def _poses(rng, n=40):
    """Gun poses on a ring around the origin, spraying roughly inward."""
    ang = rng.uniform(0, 2 * np.pi, n)
    positions = np.stack([2.5 * np.cos(ang), 2.5 * np.sin(ang),
                          rng.normal(0, 0.3, n)], -1)
    dirs = -positions + rng.normal(0, 0.2, (n, 3))
    return positions, dirs


def _assert_bitwise(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("weighted", [False, True])
def test_simulate_spray_is_bitwise_the_jax_packages(weighted):
    rng = np.random.default_rng(0)
    points = rng.normal(size=(300, 3))
    normals = rng.normal(size=(300, 3))
    normals /= np.linalg.norm(normals, axis=-1, keepdims=True)
    positions, dirs = _poses(rng)
    kw = dict(chunk=128)
    if weighted:
        kw["pose_weights"] = rng.uniform(0.5, 2.0, positions.shape[0])
    _assert_bitwise(sim.simulate_spray(points, normals, positions, dirs,
                                       **kw),
                    jax_sim.simulate_spray(points, normals, positions, dirs,
                                           **kw))
    kw = dict(sigma_deg=8.0, cone_deg=20.0, r0=1.7)
    _assert_bitwise(sim.simulate_spray(points, normals, positions, dirs,
                                       **kw),
                    jax_sim.simulate_spray(points, normals, positions, dirs,
                                           **kw))


def test_thickness_and_dwell_weights_are_bitwise_the_jax_packages(tmp_path):
    from maskplanner_tpu.sim.spray import pose_arclength_weights

    rng = np.random.default_rng(1)
    verts, faces = _box(tmp_path / "box.obj")
    positions, dirs = _poses(rng)
    _assert_bitwise(sim.facevertex_thickness(verts, faces, positions, dirs),
                    jax_sim.facevertex_thickness(verts, faces, positions,
                                                 dirs))
    ids = rng.integers(0, 4, positions.shape[0])
    ids[5] = 9                                       # a single-pose stroke
    for stroke_ids in (ids, None):
        _assert_bitwise(sim.pose_arclength_weights(positions, stroke_ids),
                        pose_arclength_weights(positions, stroke_ids))
    _assert_bitwise(sim.surface_centroid(verts, faces),
                    jax_sim.surface_centroid(verts, faces))


@pytest.mark.parametrize("per_arclength", [False, True])
def test_simulate_program_is_bitwise_the_jax_packages(tmp_path,
                                                      per_arclength):
    from maskplanner_tpu_torch.data.io import orientnorm_to_euler, \
        save_traj_file

    rng = np.random.default_rng(2)
    mesh = tmp_path / "box.obj"
    _box(mesh)
    positions, dirs = _poses(rng, 60)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    ids = np.repeat(np.arange(3), 20).astype(np.float64)
    rows = np.concatenate([positions, orientnorm_to_euler(dirs),
                           ids[:, None]], axis=1)
    program = tmp_path / "box.txt"
    save_traj_file(rows, str(program), kind="euler")
    got = sim.simulate_program(str(mesh), str(program),
                               str(tmp_path / "port.csv"),
                               per_arclength=per_arclength)
    want = jax_sim.simulate_program(str(mesh), str(program),
                                    str(tmp_path / "jax.csv"),
                                    per_arclength=per_arclength)
    _assert_bitwise(got, want)
    assert got.shape == (36,) and (got > 0).any()
    assert (tmp_path / "port.csv").read_bytes() == \
        (tmp_path / "jax.csv").read_bytes()


def test_coverage_metric_is_the_standalone_tools(tmp_path):
    import compute_paint_coverage_per_face as ref

    rng = np.random.default_rng(3)
    gt = rng.uniform(0, 2, 3 * 50)
    gt[:30] = 0.0
    pred = gt * rng.uniform(0.5, 1.5, gt.shape)
    for name, values in (("gt", gt), ("pred", pred)):
        sim.write_thickness_csv(str(tmp_path / f"{name}.csv"), values)
    got = [sim.get_thicknesses_values_per_face(str(tmp_path / f"{n}.csv"))
           for n in ("gt", "pred")]
    want = [ref.get_thicknesses_values_per_face(str(tmp_path / f"{n}.csv"))
            for n in ("gt", "pred")]
    for g, w in zip(got, want):
        _assert_bitwise(g, w)
    for percentile in (5, 10, 50):
        cov = sim.coverage_for_pair(got[0], got[1], percentile)
        assert cov == ref.coverage_for_pair(want[0], want[1], percentile)
        assert 0.0 < cov < 1.0
    with pytest.raises(ValueError, match="no painted faces"):
        sim.coverage_for_pair(np.zeros(4), np.ones(4), 10)


@pytest.fixture(scope="module")
def port_run(tmp_path_factory):
    """A port run on the fixture category whose final eval wrote its
    ``.npy`` dumps."""
    from maskplanner_tpu_torch import train_maskplanner
    from maskplanner_tpu_torch.data.fixture_category import write_category

    tmp = tmp_path_factory.mktemp("port_cov")
    root = tmp / "paintnet"
    cat_dir = write_category(str(root), CATEGORY, n_train=2, n_test=2,
                             seed=3)
    os.environ["PAINTNET_ROOT"] = str(root)
    try:
        run_dir, _ = train_maskplanner.main([*RUN_ARGS,
                                             f"output_dir={tmp}"])
    finally:
        os.environ.pop("PAINTNET_ROOT", None)
    return dict(tmp=tmp, cat_dir=cat_dir, run_dir=run_dir)


def _programs(out_dir):
    return {os.path.relpath(os.path.join(d, f), out_dir):
            np.genfromtxt(os.path.join(d, f), delimiter=";", skip_header=1)
            for d, _, files in os.walk(out_dir) for f in files}


@pytest.mark.parametrize("flags", [[], ["--postprocess", "--cover_all"]])
def test_program_export_matches_the_standalone_tool(port_run, tmp_path,
                                                    monkeypatch, flags):
    import from_pred_to_offline_v2 as ref

    from maskplanner_tpu_torch.standalone import from_pred_to_offline_v2

    run = port_run["run_dir"]
    assert any(n.startswith("last_test_batch")
               for n in os.listdir(os.path.join(run, "results")))
    from_pred_to_offline_v2.main(["--run", run, "--output_dir",
                                  str(tmp_path / "port"), *flags])
    monkeypatch.setattr(sys, "argv", ["from_pred_to_offline_v2.py", "--run",
                                      run, "--output_dir",
                                      str(tmp_path / "jax"), *flags])
    ref.main()
    got, want = _programs(tmp_path / "port"), _programs(tmp_path / "jax")
    assert sorted(got) == sorted(want) and len(got) == 4
    for name in want:
        assert got[name].shape == want[name].shape, name
        np.testing.assert_allclose(got[name], want[name], rtol=0, atol=1e-9,
                                   err_msg=name)


def test_the_three_tools_close_the_gt_round_trip(port_run, tmp_path):
    from maskplanner_tpu_torch.standalone import (
        compute_paint_coverage_per_face, from_pred_to_offline_v2,
        simulate_spray_thickness)

    cat_dir = port_run["cat_dir"]
    progs = tmp_path / "programs"
    gt_dir, pred_dir = from_pred_to_offline_v2.main(
        ["--run", port_run["run_dir"], "--output_dir", str(progs)])
    # the original programs of the test items, as the simulator's truth
    truth = progs / "truth"
    truth.mkdir()
    names = sorted(os.path.splitext(f)[0] for f in os.listdir(gt_dir))
    for name in names:
        shutil.copy(os.path.join(cat_dir, name, f"{name}_trajectory.txt"),
                    truth / f"{name}.txt")
    thick = tmp_path / "thickness"
    simulate_spray_thickness.main(["--programs", str(truth), gt_dir,
                                   pred_dir, "--meshes", cat_dir, "--out",
                                   str(thick)])
    cov = compute_paint_coverage_per_face.main(
        ["--gt-run", str(thick / "truth"), "--runs",
         str(thick / f"gt_{CATEGORY}"), str(thick / f"pred_{CATEGORY}"),
         "--percentile", "10"])
    assert cov.shape == (2, len(names))
    # the exported GT is the original program after the λ-segmentation and
    # normalization round trip: near-lossless
    assert cov[0].mean() >= 0.9, cov[0]
    assert ((cov[1] >= 0.0) & (cov[1] <= 1.0)).all()
