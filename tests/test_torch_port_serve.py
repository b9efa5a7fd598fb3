"""The PyTorch port's serving path against the JAX package's, on the CPU.

A fabricated on-disk category and a run dir from a fresh Flax init (as
tests/test_serve.py), plus the port checkpoint written from the same
variables: both ``Predictor``s must give the same program rows within 1e-4,
raw and postprocessed. A child process shows that the port imports none of
the JAX package, jax and flax.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from maskplanner_tpu.data.io import _euler_yzx_to_orient
from maskplanner_tpu.utils.args import load_args
from maskplanner_tpu.utils.config import save_config
from test_disk_data import write_obj, write_traj

torch.set_num_threads(1)

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def serve_run(tmp_path_factory):
    import jax

    from maskplanner_tpu.models import get_model
    from maskplanner_tpu.train import checkpoints, create_train_state
    from maskplanner_tpu.utils import set_seed
    from maskplanner_tpu_torch.convert import save_checkpoint, \
        state_dict_from_flax
    from maskplanner_tpu_torch.models import get_model as get_port_model

    mp = pytest.MonkeyPatch()
    # the port's distances are the JAX package's fixed-order form
    mp.setenv("MASKPLANNER_DETERMINISTIC_NN", "1")
    root = tmp_path_factory.mktemp("paintnet_root")
    cat = root / "minicubes-v1"
    names = [f"cube_{i:03d}" for i in range(3)]
    for i, name in enumerate(names):
        d = cat / name
        d.mkdir(parents=True)
        write_obj(d / f"{name}.obj", scale=1.0 + 0.1 * i)
        write_traj(d / f"{name}_trajectory.txt", seed=i)
    (cat / "train_split.json").write_text(json.dumps(names[:2]))
    (cat / "test_split.json").write_text(json.dumps(names[2:]))
    mp.setenv("PAINTNET_ROOT", str(root))

    run_dir = tmp_path_factory.mktemp("run") / "serve_run"
    run_dir.mkdir()
    cfg = load_args(argv=[
        "config=[maskplanner,cuboids_v2,longx_v2,debug]",
        "dataset=minicubes-v1", "pc_points=64", "traj_points=120",
        "n_pred_traj_points=120", "batch_size=2", "seed=5",
        "traj_with_equally_spaced_points=false"])
    state = create_train_state(get_model(cfg), cfg, set_seed(5),
                               np.zeros((1, 64, 3), np.float32))
    save_config(cfg, str(run_dir))
    checkpoints.save_checkpoint(str(run_dir), "last_checkpoint", state, 1,
                                0.0)
    variables = jax.tree_util.tree_map(
        np.asarray, {"params": state.params,
                     "batch_stats": state.batch_stats})
    port = get_port_model(cfg, device="cpu")
    port.load_state_dict(state_dict_from_flax(variables), strict=True)
    save_checkpoint(str(run_dir), "last_checkpoint", port, epoch=1)
    yield str(run_dir), str(cat / names[2] / f"{names[2]}.obj")
    mp.undo()


@pytest.fixture(scope="module")
def predictors(serve_run):
    from maskplanner_tpu.serve import Predictor as JaxPredictor
    from maskplanner_tpu.serve import resolve_scale
    from maskplanner_tpu.utils.config import (apply_retrocompat_defaults,
                                              load_config)
    from maskplanner_tpu_torch.serve import Predictor

    run_dir, _ = serve_run
    # the first scale probe writes the category's preprocessed-sample cache
    # and later probes read it back, a few ulps apart: warm it for both
    resolve_scale(apply_retrocompat_defaults(load_config(run_dir)))
    return (JaxPredictor(run_dir, model="last"),
            Predictor(run_dir, model="last", device="cpu"))


@pytest.mark.parametrize("postprocess", [False, True],
                         ids=["raw", "postprocessed"])
def test_rows_match_jax_predictor(serve_run, predictors, postprocess):
    _, mesh = serve_run
    jax_pred, port_pred = predictors
    ref = jax_pred.predict_program(mesh, postprocess=postprocess,
                                   cover_all=True)
    got = port_pred.predict_program(mesh, postprocess=postprocess,
                                    cover_all=True)
    assert got.shape == ref.shape and got.shape[1] == 7
    assert np.isfinite(got).all()
    np.testing.assert_array_equal(got[:, 6], ref[:, 6])
    np.testing.assert_allclose(got[:, :3], ref[:, :3], rtol=1e-4, atol=1e-4)
    # A;B;C come from align_vectors on one vector, which leaves the roll
    # free, so f32 noise can move the angles more than the pose: compare
    # the spray directions they encode
    np.testing.assert_allclose(_euler_yzx_to_orient(got[:, 3:6], "orientnorm"),
                               _euler_yzx_to_orient(ref[:, 3:6], "orientnorm"),
                               rtol=1e-4, atol=1e-4)


def test_preprocess_and_epoch_match(serve_run, predictors):
    _, mesh = serve_run
    jax_pred, port_pred = predictors
    a, ca = jax_pred.preprocess(mesh)
    b, cb = port_pred.preprocess(mesh)
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(ca, cb)
    assert port_pred.epoch == 1 and port_pred.scale == jax_pred.scale


def test_cli_writes_the_program(serve_run, tmp_path, capsys):
    """The CLI serves in bf16 by default, as the JAX CLI does, and in the
    run's own dtype (f32 here) with ``--dtype train``; ``--export`` alone
    writes the exported forward and serves nothing
    (``tests/test_torch_port_export.py`` serves from it)."""
    from maskplanner_tpu_torch import predict

    run_dir, mesh = serve_run
    name = os.path.splitext(os.path.basename(mesh))[0]
    for extra, dtype in (([], "bf16"), (["--dtype", "bf16"], "bf16"),
                         (["--dtype", "train"], "f32")):
        out = tmp_path / dtype / str(len(extra))
        predict.main(["--run", run_dir, "--meshes", mesh, "--out", str(out),
                      "--device", "cpu", *extra])
        rows = np.genfromtxt(out / f"{name}.txt", delimiter=";",
                             skip_header=1)
        assert rows.shape[1] == 7 and np.isfinite(rows).all()
        said = capsys.readouterr().out
        assert "poses" in said and f"in {dtype}" in said
    path = tmp_path / "forward.pt2"
    predict.main(["--run", run_dir, "--device", "cpu", "--export",
                  str(path)])
    said = capsys.readouterr().out
    assert f"exported the forward -> {path}" in said and "poses" not in said
    assert path.stat().st_size > 0


def test_bf16_predictor_rows_near_f32(serve_run, predictors):
    """A bf16 Predictor on the f32 run's checkpoint: the raw program's
    positions (every predicted pose, in order) within 3e-2 of the f32
    Predictor's largest coordinate, as tests/test_torch_port_bf16.py holds
    the model's outputs (the stroke ids may differ where a mask logit lies
    near its threshold); the postprocessed program has rows, finite."""
    from maskplanner_tpu_torch.serve import Predictor

    run_dir, mesh = serve_run
    _, f32 = predictors
    bf16 = Predictor(run_dir, model="last", device="cpu",
                     compute_dtype="bf16")
    assert f32.model.dtype == torch.float32
    assert bf16.model.dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in bf16.model.parameters())
    ref = f32.predict_program(mesh, postprocess=False)
    got = bf16.predict_program(mesh, postprocess=False)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got[:, :3], ref[:, :3],
                               atol=3e-2 * np.abs(ref[:, :3]).max())
    rows = bf16.predict_program(mesh, cover_all=True)
    assert rows.shape[0] > 0 and rows.shape[1] == 7
    assert np.isfinite(rows).all()
    with pytest.raises(ValueError, match="compute_dtype"):
        Predictor(run_dir, device="cpu", compute_dtype="fp16")


def test_cuda_without_a_card_raises(serve_run):
    from maskplanner_tpu_torch.serve import Predictor

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Predictor(serve_run[0], device="cuda")


def test_predictor_defaults_to_the_card(serve_run):
    """``Predictor(run_dir)`` takes the JAX signature: its device defaults
    to the card, which raises without one."""
    from maskplanner_tpu_torch.serve import Predictor

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Predictor(serve_run[0])


def test_port_never_imports_jax(serve_run):
    run_dir, mesh = serve_run
    code = f"""
import sys
import numpy as np
import torch
torch.set_num_threads(1)
from maskplanner_tpu_torch.utils.args import load_args
from maskplanner_tpu_torch.models import get_model
from maskplanner_tpu_torch.serve import Predictor
cfg = load_args(argv=["config=[maskplanner,windows_v2,longx_v2]",
                      "pc_points=64", "model.hidden_size=[32,32]"])
with torch.inference_mode():
    out = get_model(cfg, device="cpu")(torch.zeros(1, 64, 3))
assert np.isfinite(out.traj.numpy()).all()
rows = Predictor({run_dir!r}, device="cpu").predict_program({mesh!r})
assert rows.shape[1] == 7
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
