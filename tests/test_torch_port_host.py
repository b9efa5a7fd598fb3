"""The PyTorch port's own copies of the host modules against the JAX
package's, on the CPU.

The port keeps copies of the numpy-only modules it needs (config loading,
the data pipeline, the postprocess, ``resolve_scale``) so that it imports
nothing of the JAX package. Each copy must give what its original gives; a
child process shows that the port's entry points import none of
``maskplanner_tpu``, ``jax`` and ``flax``.
"""
import filecmp
import os
import subprocess
import sys

import numpy as np
import pytest

from maskplanner_tpu.utils.args import load_args as jax_load_args
from maskplanner_tpu_torch.utils.args import load_args

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGSHIP = "config=[maskplanner,windows_v2,longx_v2]"


def test_config_tree_is_byte_identical():
    a = os.path.join(REPO_ROOT, "maskplanner_tpu", "configs", "maskplanner")
    b = os.path.join(REPO_ROOT, "maskplanner_tpu_torch", "configs",
                     "maskplanner")
    names = sorted(n for n in os.listdir(a) if n.endswith(".yaml"))
    assert names == sorted(n for n in os.listdir(b) if n.endswith(".yaml"))
    assert len(names) == 46
    _, mismatch, errors = filecmp.cmpfiles(a, b, names, shallow=False)
    assert not mismatch and not errors, (mismatch, errors)


@pytest.mark.parametrize("argv", [
    [FLAGSHIP],
    [FLAGSHIP, "pc_points=64", "model.hidden_size=[32,32]", "seed=3"],
    ["config=[maskplanner,cuboids_v2,longx_v2,debug]", "lr=1e-4"],
], ids=["flagship", "flagship-overrides", "cuboids-debug"])
def test_load_args_matches(argv):
    ref = jax_load_args(argv=argv)
    got = load_args(argv=argv)
    assert dict(got) == dict(ref)
    assert got.cli_overrides == ref.cli_overrides


@pytest.mark.parametrize("split", ["train", "test"])
def test_paint_dataset_items_match(split):
    from maskplanner_tpu.data import PaintDataset as JaxPaintDataset
    from maskplanner_tpu_torch.data import PaintDataset, collate

    argv = [FLAGSHIP, "pc_points=256"]
    ref_ds = JaxPaintDataset(jax_load_args(argv=argv), split=split, size=4)
    ds = PaintDataset(load_args(argv=argv), split=split, size=4)
    assert len(ds) == len(ref_ds) and ds.scale == ref_ds.scale
    for i in range(4):
        a, b = ds[i], ref_ds[i]
        assert sorted(a) == sorted(b)
        for key in a:
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    batch = collate([ds[i] for i in range(2)])
    assert batch["traj"].shape == (2, 449, 24)


def test_extras_request_raises():
    """A config that asks for the extras gets the JAX dataset's items, bit
    for bit (once it raised, before ``data/extras.py`` was ported); with
    ``out_segments_per_stroke`` / ``out_points_per_stroke`` unset each item
    pads to its own longest stroke, as the JAX dataset's do."""
    from maskplanner_tpu.data import PaintDataset as JaxPaintDataset
    from maskplanner_tpu_torch.data import PaintDataset

    argv = [FLAGSHIP, "pc_points=64", "load_extra_data=[segments_per_stroke]"]
    ref_ds = JaxPaintDataset(jax_load_args(argv=argv), split="train", size=2)
    ds = PaintDataset(load_args(argv=argv), split="train", size=2)
    for i in range(2):
        a, b = ds[i], ref_ds[i]
        assert sorted(a) == sorted(b) and "segments_per_stroke" in a
        for key in a:
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)


def test_resolve_scale_matches():
    from maskplanner_tpu.serve import resolve_scale as jax_resolve_scale
    from maskplanner_tpu_torch.serve import resolve_scale

    for argv in ([FLAGSHIP], [FLAGSHIP, "data_scale_factor=3.5"],
                 [FLAGSHIP, "normalization=none"]):
        assert resolve_scale(load_args(argv=argv)) == \
            jax_resolve_scale(jax_load_args(argv=argv))
    assert resolve_scale(load_args(argv=[FLAGSHIP]), 2.0) == 2.0


def test_postprocess_rows_match():
    """Stroke ids from seeded mask logits, then the segment postprocess
    (ordering, overlap removal, resampling, smoothing), in both copies."""
    from maskplanner_tpu.postprocess import \
        process_pred_stroke_masks_to_stroke_ids as jax_ids
    from maskplanner_tpu.postprocess.segments import \
        process_stroke_segments as jax_segments
    from maskplanner_tpu_torch.postprocess import \
        process_pred_stroke_masks_to_stroke_ids
    from maskplanner_tpu_torch.postprocess.segments import \
        process_stroke_segments

    from maskplanner_tpu_torch.data import PaintDataset

    argv = [FLAGSHIP, "pc_points=64"]
    cfg, ref_cfg = load_args(argv=argv), jax_load_args(argv=argv)
    item = PaintDataset(cfg, split="test", size=1)[0]
    rng = np.random.default_rng(0)
    valid = item["stroke_ids"] >= 0
    traj = item["traj"][valid][None].astype(np.float64)
    traj = traj + rng.normal(size=traj.shape) * 1e-3       # a "prediction"
    masks = rng.normal(size=(1, 22, traj.shape[1])).astype(np.float32)
    for s, sid in enumerate(item["stroke_ids"][valid]):
        masks[0, sid, s] += 6.0                              # confident
    scores = np.where(np.arange(22) < item["n_strokes"], 4.0,
                      -4.0)[None].astype(np.float32)
    ids = process_pred_stroke_masks_to_stroke_ids(masks, scores)
    ref_ids = jax_ids(masks, scores)
    np.testing.assert_array_equal(np.asarray(ids), np.asarray(ref_ids))
    for cover_all in (False, True):
        got = process_stroke_segments(traj, ids, cfg, cover_all=cover_all)
        ref = jax_segments(traj, ref_ids, ref_cfg, cover_all=cover_all)
        np.testing.assert_array_equal(np.asarray(got[0][0]),
                                      np.asarray(ref[0][0]))
        np.testing.assert_array_equal(np.asarray(got[1][0]),
                                      np.asarray(ref[1][0]))
        assert len(got[0][0]) > 0


@pytest.mark.parametrize("deterministic", [False, True],
                         ids=["random", "deterministic"])
def test_fixture_category_writes_the_same_files(deterministic, tmp_path):
    """The port's copy of the fixture corpus writer gives the original's
    files, byte for byte."""
    from maskplanner_tpu.data.fixture_category import \
        write_category as jax_write
    from maskplanner_tpu_torch.data.fixture_category import write_category

    kw = dict(n_train=3, n_test=1, seed=7, deterministic=deterministic)
    a = write_category(str(tmp_path / "port"), "cuboids-v2", **kw)
    b = jax_write(str(tmp_path / "jax"), "cuboids-v2", **kw)
    files = sorted(os.path.relpath(os.path.join(d, f), a)
                   for d, _, fs in os.walk(a) for f in fs)
    assert files == sorted(os.path.relpath(os.path.join(d, f), b)
                           for d, _, fs in os.walk(b) for f in fs)
    assert len(files) == 2 + 4 * 3
    _, mismatch, errors = filecmp.cmpfiles(a, b, files, shallow=False)
    assert not mismatch and not errors, (mismatch, errors)


def test_clustering_scores_match():
    """V-measure (with homogeneity and completeness), ARI and mutual
    information of the port's copy on seeded labelings, outliers and
    single-cluster edge cases included."""
    from maskplanner_tpu.metrics import clustering as ref
    from maskplanner_tpu_torch.metrics import clustering as got

    rng = np.random.default_rng(0)
    cases = [(rng.integers(0, 5, 200), rng.integers(-1, 7, 200)),
             (rng.integers(0, 3, 50), rng.integers(0, 3, 50)),
             (np.zeros(10, int), np.zeros(10, int)),
             (np.arange(6), np.zeros(6, int)), (np.array([], int),) * 2]
    for t, p in cases:
        for fn in ("homogeneity_completeness_v_measure",
                   "adjusted_rand_score"):
            if fn == "adjusted_rand_score" and len(t) == 0:
                continue
            assert getattr(got, fn)(t, p) == getattr(ref, fn)(t, p), fn
        if len(t):
            assert got.mutual_info_score(t, p) == ref.mutual_info_score(t, p)


def test_port_imports_nothing_of_the_jax_package():
    code = """
import sys
import maskplanner_tpu_torch.serve
import maskplanner_tpu_torch.models
import maskplanner_tpu_torch.train_maskplanner
import maskplanner_tpu_torch.utils.args
import maskplanner_tpu_torch.data
import maskplanner_tpu_torch.postprocess.segments
import maskplanner_tpu_torch.test_maskplanner
import maskplanner_tpu_torch.data.fixture_category
import maskplanner_tpu_torch.sim
import maskplanner_tpu_torch.standalone.from_pred_to_offline_v2
import maskplanner_tpu_torch.standalone.simulate_spray_thickness
import maskplanner_tpu_torch.standalone.compute_paint_coverage_per_face
import maskplanner_tpu_torch.ops.library
import maskplanner_tpu_torch.predict
import maskplanner_tpu_torch.data.extras
import maskplanner_tpu_torch.postprocess.strokewise
import maskplanner_tpu_torch.postprocess.sop
import maskplanner_tpu_torch.postprocess.beam_search
import maskplanner_tpu_torch.train.rollout
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("maskplanner_tpu", "jax", "flax"))
assert not bad, bad
print("ok")
"""
    env = dict(os.environ, PYTHONPATH=REPO_ROOT)
    res = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO_ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0 and res.stdout.strip() == "ok", \
        res.stdout + res.stderr
