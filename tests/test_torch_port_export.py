"""The exported serving forward of the PyTorch port, on the CPU: the
inference kernels as custom ops (``ops/library.py``) pass
``torch.library.opcheck``, the ``torch.export`` graph of the eval forward
names them, the exported forward is bitwise the live one, it lies within
``test_torch_port_serve.py``'s tolerance (1e-4) of the JAX package's
exported forward on the same weights, corrupt artifacts raise, and the
``predict`` CLI's ``--export``/``--from_export`` round trip gives the live
rows. A file for two devices (``export_compiled(devices=)``, ``predict
--platforms cuda cpu``) serves on the CPU bitwise the CPU-only export,
names its devices where it is asked for another, and is refused on
``cuda`` without a card. Tracing for ``cuda`` needs a card, so here the
file's ``cuda`` entry is a program traced on the CPU (at another batch,
so that the two entries differ) through the same writer; it is never
served here. ``chip_smoke.py`` (phase 29) serves both entries of a real
``cuda`` + ``cpu`` file on the card's machine.
"""
import json
import os
import struct

import numpy as np
import pytest
import torch

from maskplanner_tpu_torch.models import get_model
from maskplanner_tpu_torch.ops import library
from maskplanner_tpu_torch.utils.args import load_args
from test_torch_port_serve import serve_run  # noqa: F401  (a fixture)

torch.set_num_threads(1)

SMALL = ["config=[maskplanner,windows_v2,longx_v2]", "pc_points=64",
         "model.hidden_size=[32,32]", "n_pred_traj_points=120",
         "max_n_strokes=6"]
# (model.norm, bf16) -> the custom ops its eval forward calls
RECIPES = {("layer+layer+batch", False): {"fps", "fused_sa_fwd"},
           ("layer+layer+batch", True): {"fps", "fused_sa_fwd_bf16"},
           ("batch", False): {"fps", "ball_group"},
           ("batch", True): {"fps", "ball_group_single"}}
SERVE_TOL = 1e-4


def _level(rng, B=2, N=48, S=8, F=5, widths=(8, 12), layer_norm=True):
    xyz = torch.from_numpy(rng.normal(size=(B, N, 3)).astype(np.float32))
    new_xyz = xyz[:, :S].clone()
    feats = torch.from_numpy(rng.normal(size=(B, N, F)).astype(np.float32))
    params, ci = [], 3 + F
    for co in widths:
        params += [torch.from_numpy(rng.normal(size=s).astype(np.float32))
                   for s in ((co, ci), (co,))]
        if layer_norm:
            params += [torch.ones(co), torch.zeros(co)]
        ci = co
    return xyz, new_xyz, feats, params


@pytest.mark.parametrize("layer_norm", [True, False])
@pytest.mark.parametrize("with_features", [True, False])
def test_opcheck_every_op(layer_norm, with_features):
    rng = np.random.default_rng(0)
    xyz, new_xyz, feats, params = _level(rng, layer_norm=layer_norm,
                                         F=5 if with_features else 0)
    feats = feats if with_features else None
    if not with_features:
        params[0] = params[0][:, :3].contiguous()
    start = torch.tensor([0, 7], dtype=torch.int32)
    cases = [(library.fps, (xyz, 8, start))]
    for op in (library.fused_sa_fwd, library.fused_sa_fwd_bf16):
        cases.append((op, (xyz, new_xyz, feats, params, 0.9, 6,
                           layer_norm)))
    for op in (library.ball_group, library.ball_group_single):
        cases.append((op, (xyz, new_xyz, feats, 0.9, 6)))
    for op, args in cases:
        torch.library.opcheck(op, args)


def _model(norm, bf16, seed=0):
    cfg = load_args(argv=[*SMALL, f"model.norm={norm}",
                          f"model.bf16={str(bf16).lower()}"])
    return get_model(cfg, device="cpu",
                     generator=torch.Generator().manual_seed(seed))


@pytest.mark.parametrize("norm,bf16", list(RECIPES),
                         ids=[f"{n}-{'bf16' if b else 'f32'}"
                              for n, b in RECIPES])
def test_export_names_the_ops_and_is_bitwise_the_live_forward(norm, bf16):
    from maskplanner_tpu_torch.serve import _ServingForward

    model = _model(norm, bf16)
    x = torch.from_numpy(np.random.default_rng(1).normal(
        size=(2, 64, 3)).astype(np.float32))
    with torch.no_grad():
        program = torch.export.export(_ServingForward(model), (x,))
    called = {n.target.name().split("::")[1].split(".")[0]
              for n in program.graph.nodes
              if n.op == "call_function"
              and str(n.target).startswith("maskplanner.")}
    assert called == RECIPES[(norm, bf16)]
    with torch.inference_mode():
        live = model(x)
        got = program.module()(x)
    assert got[3] is None and live.seg_conf is None
    for a, b in zip(got[:3], live[:3]):
        assert a.dtype == b.dtype == torch.float32
        assert torch.equal(a, b)


def test_exported_forward_matches_live_and_the_jax_export(serve_run,
                                                          tmp_path):
    from maskplanner_tpu.serve import Predictor as JaxPredictor
    from maskplanner_tpu.serve import load_exported as jax_load_exported
    from maskplanner_tpu_torch.serve import Predictor, load_exported

    run_dir, mesh = serve_run
    pred = Predictor(run_dir, model="last", device="cpu")
    path = str(tmp_path / "forward.pt2")
    blob = pred.export_compiled(path)
    assert os.path.getsize(path) == len(blob) > 0
    fn = load_exported(path)
    assert fn.meta == {"device": "cpu", "batch": 1, "pc_points": 64,
                       "dtype": "f32"}
    pc, _ = pred.preprocess(mesh)
    got = fn(pc[None])
    live = pred.forward(pc[None])
    for a, b in zip(got[:3], live[:3]):
        assert torch.equal(a, b)

    jax_pred = JaxPredictor(run_dir, model="last")
    jax_path = str(tmp_path / "forward.hlo")
    jax_pred.export_compiled(jax_path)
    ref = jax_load_exported(jax_path)(pc[None])
    for a, b in zip(got[:3], ref[:3]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=SERVE_TOL,
                                   atol=SERVE_TOL)


def test_corrupt_artifacts_raise(serve_run, tmp_path):
    from maskplanner_tpu_torch.serve import Predictor, load_exported

    run_dir, mesh = serve_run
    pred = Predictor(run_dir, model="last", device="cpu")
    path = str(tmp_path / "forward.pt2")
    blob = pred.export_compiled(path)
    bad = bytearray(blob)
    for i in range(64, min(2048, len(bad)), 97):
        bad[i] ^= 0xFF
    # a flip in the weights alone, past the program's records
    weight = bytearray(blob)
    weight[len(weight) // 2] ^= 0x01
    broken = {"truncated": blob[: len(blob) // 2], "flipped": bytes(bad),
              "weight": bytes(weight), "empty": b""}
    pc, _ = pred.preprocess(mesh)
    for name, data in broken.items():
        p = tmp_path / f"{name}.pt2"
        p.write_bytes(data)
        with pytest.raises(ValueError, match="corrupt|not an exported"):
            load_exported(str(p))(pc[None])
    good = load_exported(path)
    assert torch.isfinite(good(pc[None])[0]).all()


def test_a_card_artifact_raises_without_a_card(serve_run, tmp_path):
    """The metadata names the device the program was traced for; one
    traced for the card is refused where there is none (and a CPU one
    where the card is asked for)."""
    from maskplanner_tpu_torch.serve import (_HEADER, Predictor, _seal,
                                             load_exported)

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    run_dir, _ = serve_run
    path = tmp_path / "forward.pt2"
    blob = Predictor(run_dir, device="cpu").export_compiled(str(path))
    _, _, n_meta = struct.Struct("<8s32sI").unpack_from(blob)
    meta = json.loads(blob[_HEADER.size:_HEADER.size + n_meta])
    with pytest.raises(ValueError, match="exported for cpu, not for cuda"):
        load_exported(str(path), device="cuda")
    meta["device"] = "cuda"
    card = tmp_path / "card.pt2"
    card.write_bytes(_seal(json.dumps(meta).encode(),
                           blob[_HEADER.size + n_meta:]))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_exported(str(card))


def test_predict_cli_export_then_serve_gives_the_live_rows(serve_run,
                                                           tmp_path, capsys):
    from maskplanner_tpu_torch import predict

    run_dir, mesh = serve_run
    name = os.path.splitext(os.path.basename(mesh))[0]
    path = str(tmp_path / "forward.pt2")
    common = ["--run", run_dir, "--device", "cpu", "--dtype", "f32"]
    predict.main([*common, "--export", path, "--platforms", "cpu"])
    assert "exported the forward" in capsys.readouterr().out
    rows = {}
    for how, extra in (("live", []), ("exported", ["--from_export", path])):
        out = tmp_path / how
        predict.main([*common, "--meshes", mesh, "--out", str(out), *extra])
        said = capsys.readouterr().out
        assert ("serving the forward from" in said) == bool(extra)
        rows[how] = np.genfromtxt(out / f"{name}.txt", delimiter=";",
                                  skip_header=1)
    assert rows["live"].shape[0] > 0
    np.testing.assert_array_equal(rows["exported"], rows["live"])


def test_predict_cli_takes_one_platform(serve_run, tmp_path):
    """(Several now.) ``--platforms cuda cpu`` without a card raises before
    anything is traced or written, and a device named twice raises."""
    from maskplanner_tpu_torch import predict

    run_dir, _ = serve_run
    common = ["--run", run_dir, "--device", "cpu", "--export",
              str(tmp_path / "f.pt2")]
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        predict.main([*common, "--platforms", "cuda", "cpu"])
    with pytest.raises(ValueError, match="each device once"):
        predict.main([*common, "--platforms", "cpu", "cpu"])
    assert not (tmp_path / "f.pt2").exists()


@pytest.fixture(scope="module")
def two_device_file(serve_run, tmp_path_factory):
    """A ``cuda`` + ``cpu`` file written by ``export_compiled(devices=)``,
    its ``cuda`` entry traced on the CPU at batch 2 (the module's
    docstring), and the CPU-only export beside it."""
    from maskplanner_tpu_torch import serve
    from maskplanner_tpu_torch.serve import Predictor

    run_dir, mesh = serve_run
    tmp = tmp_path_factory.mktemp("two_devices")
    pred = Predictor(run_dir, model="last", device="cpu",
                     compute_dtype="f32")
    traced = Predictor._traced

    def on_the_cpu(self, device, batch):
        if device.type == "cuda":
            return traced(self, torch.device("cpu"), 2)
        return traced(self, device, batch)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(serve, "resolve_device", lambda d: torch.device(d))
        mp.setattr(Predictor, "_traced", on_the_cpu)
        both = pred.export_compiled(str(tmp / "both.pt2"),
                                    devices=["cuda", "cpu"])
    single = pred.export_compiled(str(tmp / "cpu.pt2"), devices=["cpu"])
    return pred, mesh, tmp, both, single


def test_two_device_file_serves_the_cpu_bitwise(two_device_file):
    from maskplanner_tpu_torch.serve import load_exported

    pred, mesh, tmp, both, single = two_device_file
    assert len(both) > len(single)
    pc, _ = pred.preprocess(mesh)
    one = load_exported(str(tmp / "cpu.pt2"), "cpu")
    assert one.meta == {"device": "cpu", "batch": 1, "pc_points": 64,
                        "dtype": "f32"}
    for device in ("cpu", None):     # without a card None picks the CPU
        fn = load_exported(str(tmp / "both.pt2"), device)
        assert fn.meta == {"device": "cpu", "devices": ["cuda", "cpu"],
                           "batch": 1, "pc_points": 64, "dtype": "f32"}
        for a, b in zip(fn(pc[None])[:3], one(pc[None])[:3]):
            assert torch.equal(a, b)


def test_two_device_file_names_its_devices(two_device_file):
    from maskplanner_tpu_torch.serve import load_exported

    _, _, tmp, _, _ = two_device_file
    with pytest.raises(ValueError, match="holds programs for cuda, cpu, "
                                         "not for meta"):
        load_exported(str(tmp / "both.pt2"), "meta")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            load_exported(str(tmp / "both.pt2"), "cuda")
    # the sealed file covers both programs: a flip in either raises
    blob = bytearray((tmp / "both.pt2").read_bytes())
    blob[-10] ^= 0x01
    (tmp / "flipped.pt2").write_bytes(bytes(blob))
    with pytest.raises(ValueError, match="corrupt"):
        load_exported(str(tmp / "flipped.pt2"), "cuda")
