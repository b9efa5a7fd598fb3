"""The reference BatchNorm recipe (``model.norm=batch``) through the port's
entry points, on the CPU: the training driver and a ``Predictor`` serving
what it wrote, the encoder warm start from the original repository's
ShapeNet checkpoint against the JAX package's loader, the weights round
trip, and the serving CLI's default device.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from maskplanner_tpu_torch.convert import (flax_tree_from_state_dict,
                                           load_shapenet_encoder,
                                           state_dict_from_flax)
from maskplanner_tpu_torch.models import get_model
from maskplanner_tpu_torch.utils.args import load_args

torch.set_num_threads(1)

FLAGSHIP = "config=[maskplanner,windows_v2,longx_v2]"
SMALL = [FLAGSHIP, "pc_points=64", "model.hidden_size=[32,32]",
         "n_pred_traj_points=120", "max_n_strokes=6", "model.norm=batch"]
ENCODER = {"sa1": (3, (64, 64, 128)), "sa2": (131, (128, 128, 256)),
           "sa3": (259, (256, 512, 1024))}


def _write_box(path):
    corners = np.array([[x, y, z] for x in (-1, 1) for y in (-1, 1)
                        for z in (-1, 1)], float) * [450.0, 60.0, 550.0]
    faces = [(0, 1, 3), (0, 3, 2), (4, 6, 7), (4, 7, 5), (0, 4, 5),
             (0, 5, 1), (2, 3, 7), (2, 7, 6), (0, 2, 6), (0, 6, 4),
             (1, 5, 7), (1, 7, 3)]
    path.write_text("".join(f"v {a} {b} {c}\n" for a, b, c in corners)
                    + "".join(f"f {a + 1} {b + 1} {c + 1}\n"
                              for a, b, c in faces))


def test_driver_trains_the_batchnorm_recipe_and_the_predictor_serves(
        tmp_path):
    from maskplanner_tpu_torch import train_maskplanner
    from maskplanner_tpu_torch.serve import Predictor

    run_dir, model = train_maskplanner.main([
        *SMALL, "batch_size=2", "device=cpu", "epochs=2", "eval_freq=1",
        "dataset_size=4", "test_dataset_size=2", "seed=3",
        f"output_dir={tmp_path}"])
    # the train forward moved the grouped levels' running statistics
    assert not torch.equal(model.sa1.mlp_bns[0].running_var,
                           torch.ones(64))
    mesh = tmp_path / "box.obj"
    _write_box(mesh)
    pred = Predictor(run_dir, model="last", device="cpu")
    assert pred.epoch == 2 and pred.model.sa2.norm == "batch"
    rows = pred.predict_program(str(mesh), postprocess=False)
    assert rows.ndim == 2 and rows.shape[1] == 7 and np.isfinite(rows).all()


def _shapenet_checkpoint(path, seed=0):
    """A classifier checkpoint in the original repository's layout: 1x1
    Conv2d weights (C_out, C_in, 1, 1), BatchNorm2d statistics, the
    classifier head, under ``model_state_dict``."""
    rng = np.random.default_rng(seed)

    def t(*shape, scale=0.1, offset=0.0):
        return torch.from_numpy(
            (rng.normal(size=shape) * scale + offset).astype(np.float32))

    sd = {}
    for sa, (cin, widths) in ENCODER.items():
        for j, co in enumerate(widths):
            sd[f"{sa}.mlp_convs.{j}.weight"] = t(co, cin, 1, 1)
            sd[f"{sa}.mlp_convs.{j}.bias"] = t(co)
            sd[f"{sa}.mlp_bns.{j}.weight"] = t(co, offset=1.0)
            sd[f"{sa}.mlp_bns.{j}.bias"] = t(co)
            sd[f"{sa}.mlp_bns.{j}.running_mean"] = t(co)
            sd[f"{sa}.mlp_bns.{j}.running_var"] = t(co).abs() + 0.5
            sd[f"{sa}.mlp_bns.{j}.num_batches_tracked"] = torch.tensor(7)
            cin = co
    for name, (co, ci) in (("fc1", (512, 1024)), ("fc2", (256, 512)),
                           ("fc3", (40, 256))):
        sd[f"{name}.weight"] = t(co, ci)
        sd[f"{name}.bias"] = t(co)
    for name, c in (("bn1", 512), ("bn2", 256)):
        sd[f"{name}.weight"] = t(c, offset=1.0)
        sd[f"{name}.bias"] = t(c)
        sd[f"{name}.running_mean"] = t(c)
        sd[f"{name}.running_var"] = t(c).abs() + 0.5
        sd[f"{name}.num_batches_tracked"] = torch.tensor(7)
    torch.save({"epoch": 3, "model_state_dict": sd}, path)
    return sd


def test_warm_start_matches_the_jax_loader(tmp_path):
    from maskplanner_tpu.models import get_model as get_flax_model
    from maskplanner_tpu.train.torch_convert import load_torch_pretrained
    from maskplanner_tpu.utils.args import load_args as jax_load_args
    from maskplanner_tpu_torch.train_maskplanner import warm_start_encoder

    pth = tmp_path / "pointnet2_cls_ssg.pth"
    _shapenet_checkpoint(pth)
    argv = [*SMALL, f"model.pretrained_path={pth}"]
    model = get_model(load_args(argv=argv), device="cpu")
    loaded = warm_start_encoder(model, load_args(argv=argv))
    assert len(loaded) == 3 * 3 * 6      # 9 Linear and 9 BatchNorm layers

    flax_model = get_flax_model(jax_load_args(argv=argv))
    variables = flax_model.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 3)),
                                train=False)

    class State:
        params = variables["params"]
        batch_stats = variables["batch_stats"]

        def replace(self, **kw):
            new = State()
            new.__dict__.update(kw)
            return new

    new, jax_loaded = load_torch_pretrained(str(pth), State(), mode="encoder")
    assert sorted(loaded) == sorted(k for k in jax_loaded)
    want = state_dict_from_flax(jax.tree_util.tree_map(
        np.asarray, {"params": new.params, "batch_stats": new.batch_stats}))
    got = model.state_dict()
    encoder = [k for k in want if k.startswith("sa")
               and not k.endswith("num_batches_tracked")]
    assert len(encoder) == len(loaded)
    for k in encoder:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0,
                                   msg=k)


def test_warm_start_skips_other_norms_and_missing_files(tmp_path, capsys):
    from maskplanner_tpu_torch.train_maskplanner import warm_start_encoder

    pth = tmp_path / "pointnet2_cls_ssg.pth"
    _shapenet_checkpoint(pth)
    argv = [*SMALL, "model.norm=layer+layer+batch",
            f"model.pretrained_path={pth}"]
    model = get_model(load_args(argv=argv), device="cpu")
    before = {k: v.clone() for k, v in model.state_dict().items()}
    assert warm_start_encoder(model, load_args(argv=argv)) is None
    assert "requires model.norm=batch" in capsys.readouterr().out
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k
    missing = [*SMALL, f"model.pretrained_path={tmp_path / 'none.pth'}"]
    assert warm_start_encoder(model, load_args(argv=missing)) is None
    assert "not found" in capsys.readouterr().out


def test_warm_start_refuses_a_shape_mismatch(tmp_path):
    pth = tmp_path / "bad.pth"
    sd = _shapenet_checkpoint(pth)
    sd["sa1.mlp_convs.0.weight"] = torch.zeros(64, 5, 1, 1)
    torch.save({"model_state_dict": sd}, pth)
    model = get_model(load_args(argv=SMALL), device="cpu")
    with pytest.raises(ValueError, match="shape mismatch"):
        load_shapenet_encoder(model, str(pth))


def test_weights_round_trip_of_a_batchnorm_tree():
    from maskplanner_tpu.models import get_model as get_flax_model
    from maskplanner_tpu.utils.args import load_args as jax_load_args

    flax_model = get_flax_model(jax_load_args(argv=SMALL))
    variables = flax_model.init(jax.random.PRNGKey(2), jnp.zeros((1, 64, 3)),
                                train=False)
    rng = np.random.default_rng(2)
    variables = jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + rng.normal(size=a.shape)).astype(
            np.float32), variables)
    model = get_model(load_args(argv=SMALL), device="cpu")
    model.load_state_dict(state_dict_from_flax(variables), strict=True)
    assert any(k.startswith("sa1.mlp_bns.") for k in model.state_dict())
    back = flax_tree_from_state_dict(model.state_dict())
    leaves = jax.tree_util.tree_leaves_with_path(variables)
    assert len(leaves) == len(jax.tree_util.tree_leaves(back))
    for path, a in leaves:
        node = back
        for p in path:
            node = node[p.key]
        np.testing.assert_array_equal(node, a,
                                      err_msg=jax.tree_util.keystr(path))


def test_predict_cli_runs_on_the_card_by_default(tmp_path):
    from maskplanner_tpu_torch import predict

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert predict.parse_args(["--run", str(tmp_path)]).device == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        predict.main(["--run", str(tmp_path)])
