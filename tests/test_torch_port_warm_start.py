"""Warm starts from other runs (``model.pretrained_custom``) in the PyTorch
port, on the CPU: a port run warm-starts another (every tensor equal, the
output layers ``fc3`` and ``fc_normals`` at their fresh init unless
``load_strict``), a reference run's ``.pth`` loads bitwise as the JAX
package's ``load_torch_pretrained(mode="full")`` loads it, a JAX run's
orbax checkpoint raises, an empty run warns and trains from scratch, and a
shape mismatch raises.
"""
import numpy as np
import jax
import pytest
import torch

from maskplanner_tpu_torch.convert import (flax_tree_from_state_dict,
                                           load_params_only,
                                           load_torch_pretrained,
                                           state_dict_from_flax)
from maskplanner_tpu_torch.models import get_model
from maskplanner_tpu_torch.utils.args import load_args

torch.set_num_threads(1)

SMALL = ["config=[maskplanner,windows_v2,longx_v2,debug]", "pc_points=64",
         "model.hidden_size=[32,32]", "n_pred_traj_points=120",
         "max_n_strokes=6"]
RUN = [*SMALL, "batch_size=2", "device=cpu", "epochs=1", "eval_freq=1",
       "dataset_size=4", "test_dataset_size=2", "no_save=false",
       "skip_rendering=true"]
HEADS = ("fc3.", "fc_normals.")
RECIPES = ["layer+layer+batch", "batch"]


def _model(norm, seed, *extra):
    cfg = load_args(argv=[*SMALL, f"model.norm={norm}", *extra])
    return get_model(cfg, device="cpu",
                     generator=torch.Generator().manual_seed(seed))


@pytest.fixture(scope="module")
def source_run(tmp_path_factory):
    """A one-epoch port run of the default recipe."""
    from maskplanner_tpu_torch import train_maskplanner

    out = tmp_path_factory.mktemp("source")
    run_dir, _ = train_maskplanner.main([*RUN, "seed=4",
                                         f"output_dir={out}"])
    blob = torch.load(f"{run_dir}/last_checkpoint.torch.pt",
                      weights_only=True)
    return run_dir, blob["model"]


@pytest.mark.parametrize("strict", [False, True])
def test_a_port_run_warm_starts_the_driver(source_run, tmp_path,
                                           monkeypatch, capsys, strict):
    """The driver loads the run before Adam is built: the model Adam is
    made for is the checkpoint (its heads the fresh init's unless
    ``load_strict``)."""
    from maskplanner_tpu_torch import train_maskplanner

    run_dir, saved = source_run
    fresh = _model("layer+layer+batch", 9).state_dict()
    seen = {}
    make_optimizer = train_maskplanner.make_optimizer

    def spy(model, config):
        seen.update({k: v.clone() for k, v in model.state_dict().items()})
        return make_optimizer(model, config)

    monkeypatch.setattr(train_maskplanner, "make_optimizer", spy)
    train_maskplanner.main([*RUN, "seed=9", f"output_dir={tmp_path}",
                            f"model.pretrained_custom={run_dir}",
                            f"model.load_strict={str(strict).lower()}"])
    assert f"Initialized from pretrained run {run_dir}" in \
        capsys.readouterr().out
    assert set(seen) == set(saved)
    for key, value in seen.items():
        want = fresh[key] if key.startswith(HEADS) and not strict \
            else saved[key]
        assert torch.equal(value, want), key
    assert not torch.equal(saved["fc3.weight"], fresh["fc3.weight"])


def test_load_params_only_copies_in_place(source_run):
    run_dir, saved = source_run
    model = _model("layer+layer+batch", 9)
    storages = {k: v.data_ptr() for k, v in model.state_dict().items()}
    loaded = load_params_only(run_dir, "last_checkpoint", model,
                              filter_heads=True)
    assert not any(k.startswith(HEADS) for k in loaded)
    assert len(loaded) == len(saved) - 4
    for k, v in model.state_dict().items():
        assert v.data_ptr() == storages[k], k


def _reference_pth(path, seed=5):
    """A reference run's ``last_checkpoint.pth``: the original repository's
    layout (1x1 Conv2d weights, a BatchNorm in every encoder layer, the
    ``out_confidence`` twin of ``mask_conf_out``) under ``"model"``, with
    Adam's state and the epoch."""
    ref = _model("batch", seed).state_dict()
    rng = np.random.default_rng(seed)
    sd = {}
    for key, value in ref.items():
        if value.is_floating_point():
            value = value + torch.from_numpy(
                rng.normal(0, 0.05, value.shape).astype(np.float32))
        if key.startswith("sa") and ".mlp_convs." in key \
                and key.endswith("weight"):
            value = value[:, :, None, None]
        if key.endswith("running_var"):
            value = value.abs() + 0.5
        sd[key.replace("mask_conf_out", "out_confidence")] = value
    opt = {"state": {0: {"step": torch.tensor(40.0),
                         "exp_avg": torch.zeros(3),
                         "exp_avg_sq": torch.ones(3)}},
           "param_groups": [{"lr": 1e-3, "betas": (0.9, 0.999),
                             "eps": 1e-8, "weight_decay": 0.0,
                             "amsgrad": False, "params": [0]}]}
    torch.save({"epoch": 12, "model": sd, "optimizer": opt}, path)
    return sd


@pytest.mark.parametrize("strict", [False, True])
@pytest.mark.parametrize("norm", RECIPES)
def test_a_reference_run_loads_as_the_jax_loader_loads_it(tmp_path, norm,
                                                          strict):
    from maskplanner_tpu.train.torch_convert import \
        load_torch_pretrained as jax_load

    pth = tmp_path / "last_checkpoint.pth"
    _reference_pth(pth)
    model = _model(norm, 1)
    init = flax_tree_from_state_dict(model.state_dict())

    class State:
        params = init["params"]
        batch_stats = init.get("batch_stats", {})

        def replace(self, **kw):
            new = State()
            new.__dict__.update(kw)
            return new

    new, jax_loaded = jax_load(str(pth), State(), mode="full",
                               load_strict=strict)
    loaded = load_torch_pretrained(model, str(pth), mode="full",
                                   load_strict=strict)
    assert sorted(loaded) == sorted(jax_loaded)
    assert ("fc3.weight" in loaded) == strict
    assert "out_confidence.weight" in loaded
    if norm != "batch":      # a LayerNorm level has no BatchNorm to load
        assert not any(k.startswith("sa1.mlp_bns") for k in loaded)
    want = state_dict_from_flax(jax.tree_util.tree_map(
        np.asarray, {"params": new.params, "batch_stats": new.batch_stats}))
    got = model.state_dict()
    keys = [k for k in want if not k.endswith("num_batches_tracked")]
    assert set(keys) == {k for k in got
                         if not k.endswith("num_batches_tracked")}
    for k in keys:
        assert got[k].dtype == want[k].dtype, k
        assert torch.equal(got[k], want[k]), k


def test_the_driver_warm_starts_from_a_reference_run(tmp_path, capsys):
    from maskplanner_tpu_torch.train_maskplanner import warm_start_custom

    run = tmp_path / "reference_run"
    run.mkdir()
    sd = _reference_pth(run / "last_checkpoint.pth")
    cfg = load_args(argv=[*SMALL, f"model.pretrained_custom={run}"])
    model = get_model(cfg, device="cpu")
    loaded = warm_start_custom(model, cfg)
    assert "Initialized from reference torch run" in capsys.readouterr().out
    assert torch.equal(model.state_dict()["mask_conf_out.weight"],
                       sd["out_confidence.weight"])
    assert "fc3.weight" not in loaded


def test_a_jax_run_raises(tmp_path):
    from maskplanner_tpu_torch import train_maskplanner

    run = tmp_path / "jax_run"
    (run / "last_checkpoint").mkdir(parents=True)
    with pytest.raises(NotImplementedError, match="Queue 1 item 5"):
        train_maskplanner.main([*RUN, f"output_dir={tmp_path}",
                                f"model.pretrained_custom={run}"])


def test_an_empty_run_warns_and_trains_from_scratch(tmp_path, capsys):
    from maskplanner_tpu_torch.train_maskplanner import warm_start_custom

    run = tmp_path / "empty"
    run.mkdir()
    cfg = load_args(argv=[*SMALL, f"model.pretrained_custom={run}"])
    model = get_model(cfg, device="cpu")
    before = {k: v.clone() for k, v in model.state_dict().items()}
    assert warm_start_custom(model, cfg) is None
    assert "has no last_checkpoint; training from scratch" in \
        capsys.readouterr().out
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k


def test_a_shape_mismatch_raises(tmp_path, source_run):
    pth = tmp_path / "last_checkpoint.pth"
    sd = _reference_pth(pth)
    sd["sm_fc1.weight"] = torch.zeros(32, 7)
    torch.save({"model": sd}, pth)
    with pytest.raises(ValueError, match="shape mismatch at sm_fc1.weight"):
        load_torch_pretrained(_model("batch", 1), str(pth), mode="full")
    torch.save({"model": {"unrelated.weight": torch.zeros(2)}}, pth)
    with pytest.raises(ValueError, match="no convertible weights"):
        load_torch_pretrained(_model("batch", 1), str(pth), mode="full")
    wider = _model("layer+layer+batch", 1, "model.hidden_size=[16,16]")
    with pytest.raises(ValueError, match="shape mismatch"):
        load_params_only(source_run[0], "last_checkpoint", wider)
