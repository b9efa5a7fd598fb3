"""The port's JAX-run converter, offline postprocess tool and end-of-run
rendering, on the CPU.

- ``tools/orbax_to_torch.py`` turns a JAX run's orbax ``last_checkpoint/``
  into the port's ``last_checkpoint.torch.pt``; the port's driver then
  warm-starts from it, and its forward lies within 1e-5 · max|ref| of the
  JAX forward on the same weights (both float32 on the CPU).
- ``postprocess/align.py`` gives the JAX package's ids on the same dumps,
  and ``standalone/from_pred_to_postprocess_pred.py`` the root tool's
  arrays.
- A driver run without ``skip_rendering`` renders its final dumps in a
  child process (PNGs under ``renders/``); a failing render never fails a
  run; the driver's import path loads no matplotlib.
"""
import glob
import os
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from maskplanner_tpu.utils.args import load_args as jax_load_args
from maskplanner_tpu_torch.utils.args import load_args

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = ["config=[maskplanner,windows_v2,longx_v2,debug]", "pc_points=64",
         "model.hidden_size=[32,32]", "n_pred_traj_points=120",
         "max_n_strokes=6"]
# debug=false: the debug recipe's sizes, with the end-of-run rendering on
RUN = [*SMALL, "debug=false", "batch_size=2", "device=cpu", "epochs=1",
       "eval_freq=1", "dataset_size=4", "test_dataset_size=2",
       "no_save=false", "seed=4"]


@pytest.fixture(scope="module")
def driver_run(tmp_path_factory):
    """A one-epoch CPU run of the driver with rendering, and its output."""
    from maskplanner_tpu_torch import train_maskplanner

    out = tmp_path_factory.mktemp("render")
    run_dir, _ = train_maskplanner.main([*RUN, f"output_dir={out}"])
    return run_dir


def test_a_driver_run_renders_its_final_dumps(driver_run):
    pngs = glob.glob(os.path.join(driver_run, "renders", "*.png"))
    assert pngs, "no PNGs under renders/"
    assert all(os.path.getsize(p) > 0 for p in pngs)
    assert {os.path.basename(p) for p in pngs} >= {
        "last_test_batch0_sample0.png", "last_test_batch0_sample1.png"}


def _failing_run(argv, **kw):
    """A stand-in for ``subprocess.run`` whose child fails: it runs a child
    that exits 3 in place of the render."""
    return subprocess.run([sys.executable, "-c", "raise SystemExit(3)"],
                          check=False, timeout=60)


def _timed_out(argv, **kw):
    raise subprocess.TimeoutExpired(argv, kw.get("timeout"))


@pytest.mark.parametrize("child", [_failing_run, _timed_out],
                         ids=["exits-3", "times-out"])
def test_a_failing_render_never_fails_the_run(tmp_path, monkeypatch, capsys,
                                              child):
    """The run ends with its summary whether the render child exits
    non-zero or outlasts its limit; the exit status is printed."""
    from maskplanner_tpu_torch import train_maskplanner

    class Stub:
        TimeoutExpired = subprocess.TimeoutExpired

        @staticmethod
        def run(argv, **kw):
            assert argv[1:3] == ["-m", "maskplanner_tpu_torch.render_results"]
            assert kw["check"] is False and kw["timeout"] == 600
            return child(argv, **kw)

    monkeypatch.setattr(train_maskplanner, "subprocess", Stub)
    run_dir, _ = train_maskplanner.main([*RUN, f"output_dir={tmp_path}"])
    with open(os.path.join(run_dir, "summary.json")) as fh:
        assert "final_test_loss" in fh.read()
    said = capsys.readouterr().out
    assert ("rendering exited with status 3" in said
            if child is _failing_run else "rendering skipped" in said)


def test_a_render_of_a_run_without_dumps_fails_in_its_child(tmp_path, capsys):
    """The real child on a run with no dumps: it fails, the driver's
    ``render`` prints its status and returns."""
    from maskplanner_tpu_torch.train_maskplanner import render
    from maskplanner_tpu_torch.utils.config import save_config

    save_config(load_args(argv=SMALL), str(tmp_path))
    render(str(tmp_path), str(tmp_path / "results"), "last")
    said = capsys.readouterr().out
    assert "rendering exited with status 1" in said


@pytest.mark.parametrize("module", ["maskplanner_tpu_torch.train_maskplanner",
                                    "maskplanner_tpu_torch.serve"])
def test_the_driver_and_server_do_not_load_matplotlib(module):
    code = (f"import sys, {module}\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('matplotlib', 'maskplanner_tpu_torch') and ('viz' in m or "
            "'matplotlib' in m or 'render_results' in m)))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, check=True).stdout
    assert out.strip() == "[]", out


def test_the_new_modules_import_nothing_of_the_jax_package():
    code = ("import sys\n"
            "import maskplanner_tpu_torch.render_results\n"
            "import maskplanner_tpu_torch.viz.pcp\n"
            "import maskplanner_tpu_torch.postprocess.align\n"
            "import maskplanner_tpu_torch.standalone."
            "from_pred_to_postprocess_pred\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('maskplanner_tpu', 'jax', 'flax')))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, check=True).stdout
    assert out.strip() == "[]", out


def test_render_results_flags(driver_run):
    """``--with_postprocess --align_stroke_ids --batch_grid --animated``
    write the grid and a gif beside the PNGs."""
    from maskplanner_tpu_torch import render_results

    render_results.main(["--run", driver_run, "--max_samples", "1",
                         "--with_postprocess", "--align_stroke_ids",
                         "--batch_grid", "--animated"])
    renders = os.path.join(driver_run, "renders")
    assert os.path.isfile(os.path.join(renders, "last_test_batch0_grid.png"))
    assert os.path.getsize(os.path.join(
        renders, "last_test_batch0_sample0.gif")) > 0


def test_align_matches_jax_on_the_dumps(driver_run):
    from maskplanner_tpu.postprocess.align import \
        permute_and_align_stroke_ids_for_visualization as jax_align
    from maskplanner_tpu.utils.config import load_config as jax_load_config
    from maskplanner_tpu_torch.postprocess import \
        process_pred_stroke_masks_to_stroke_ids
    from maskplanner_tpu_torch.postprocess.align import \
        permute_and_align_stroke_ids_for_visualization
    from maskplanner_tpu_torch.utils.config import load_config

    for path in sorted(glob.glob(os.path.join(driver_run, "results",
                                              "last_*_batch*.npy"))):
        dump = np.load(path, allow_pickle=True).item()
        ids = process_pred_stroke_masks_to_stroke_ids(
            dump["pred_stroke_masks"], dump["stroke_masks_scores"])
        args = (dump["traj_pred"], ids, dump["traj"], dump["stroke_ids"])
        got = permute_and_align_stroke_ids_for_visualization(
            *args, load_config(driver_run))
        ref = jax_align(*args, jax_load_config(driver_run))
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("cover_all", [False, True],
                         ids=["default", "cover-all"])
def test_postprocess_tool_matches_the_root_tool(driver_run, tmp_path,
                                                cover_all):
    """The port's tool and root ``standalone/from_pred_to_postprocess_pred.
    py`` on copies of the run's dumps: the same files, equal arrays."""
    import shutil

    from maskplanner_tpu_torch.standalone import from_pred_to_postprocess_pred

    port, root = tmp_path / "port", tmp_path / "root"
    for dest in (port, root):
        shutil.copytree(driver_run, dest)
    flag = ["--cover_all"] if cover_all else []
    from_pred_to_postprocess_pred.main(["--run", str(port), *flag])
    subprocess.run([sys.executable, os.path.join(
        ROOT, "standalone", "from_pred_to_postprocess_pred.py"),
        "--run", str(root), *flag], check=True, cwd=ROOT,
        env={**os.environ, "JAX_PLATFORMS": "cpu"}, capture_output=True)
    names = sorted(os.path.basename(p) for p in glob.glob(
        str(root / "results" / "*_postprocessed.npy")))
    assert names and names == sorted(os.path.basename(p) for p in glob.glob(
        str(port / "results" / "*_postprocessed.npy")))
    for name in names:
        a = np.load(port / "results" / name, allow_pickle=True).item()
        b = np.load(root / "results" / name, allow_pickle=True).item()
        assert sorted(a) == sorted(b)
        np.testing.assert_array_equal(a["dirnames"], b["dirnames"])
        np.testing.assert_array_equal(a["n_strokes"], b["n_strokes"])
        for key in ("traj_pred_postprocessed",
                    "stroke_ids_pred_postprocessed"):
            assert len(a[key]) == len(b[key])
            for x, y in zip(a[key], b[key]):
                np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """A JAX run dir: its frozen config and an orbax ``last_checkpoint/``
    of perturbed weights (``train/checkpoints.py::save_checkpoint``) ->
    (run dir, the variables, a batch of clouds)."""
    from maskplanner_tpu.models import get_model as get_flax_model
    from maskplanner_tpu.train import checkpoints
    from maskplanner_tpu.train.trainer import create_train_state
    from maskplanner_tpu.utils.config import save_config

    cfg = jax_load_args(argv=SMALL)
    run = str(tmp_path_factory.mktemp("jax") / "run")
    os.makedirs(run)
    save_config(cfg, run)
    rng = np.random.default_rng(3)
    pc = rng.random((2, 64, 3), dtype=np.float32)
    model = get_flax_model(cfg)
    state = create_train_state(model, cfg, jax.random.PRNGKey(2),
                               pc[:1])
    perturb = lambda a: (np.asarray(a) + rng.normal(size=a.shape) * 0.1
                         ).astype(np.float32)
    state = state.replace(
        params=jax.tree_util.tree_map(perturb, state.params),
        batch_stats=jax.tree_util.tree_map(
            lambda a: rng.uniform(0.5, 1.5, a.shape).astype(np.float32),
            state.batch_stats))
    checkpoints.save_checkpoint(run, "last_checkpoint", state, 3)
    variables = {"params": state.params, "batch_stats": state.batch_stats}
    ref = model.apply(variables, jnp.asarray(pc), train=False)
    return run, pc, ref


def test_a_jax_run_warm_starts_the_port_after_conversion(jax_run, tmp_path,
                                                         capsys):
    """Before the conversion the warm start raises, naming the tool; after
    ``tools/orbax_to_torch.py`` the driver loads every tensor
    (``load_strict``), and the port's forward lies within 1e-5 · max|ref|
    of the JAX forward."""
    from maskplanner_tpu_torch.models import get_model
    from maskplanner_tpu_torch.train_maskplanner import warm_start_custom

    run, pc, ref = jax_run
    cfg = load_args(argv=[*SMALL, f"model.pretrained_custom={run}",
                          "model.load_strict=true"])
    model = get_model(cfg, device="cpu")
    with pytest.raises(FileNotFoundError, match="tools/orbax_to_torch.py"):
        warm_start_custom(model, cfg)
    done = subprocess.run(
        [sys.executable, os.path.join(ROOT, "tools", "orbax_to_torch.py"),
         "--run", run], capture_output=True, text=True, cwd=str(tmp_path),
        env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert done.returncode == 0, done.stderr[-2000:]
    assert os.path.isfile(os.path.join(run, "last_checkpoint.torch.pt"))
    loaded = warm_start_custom(model, cfg)
    assert sorted(loaded) == sorted(model.state_dict())
    with torch.inference_mode():
        out = model(torch.from_numpy(pc))
    for field in ("traj", "stroke_masks", "mask_scores"):
        a = np.asarray(getattr(ref, field))
        b = getattr(out, field).numpy()
        assert b.shape == a.shape
        np.testing.assert_allclose(b, a, rtol=0,
                                   atol=1e-5 * np.abs(a).max(), err_msg=field)


def test_the_converter_rejects_a_run_without_the_checkpoint(tmp_path):
    done = subprocess.run(
        [sys.executable, os.path.join(ROOT, "tools", "orbax_to_torch.py"),
         "--run", str(tmp_path)], capture_output=True, text=True,
        env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert done.returncode != 0
    assert "no orbax checkpoint last_checkpoint/" in done.stderr
