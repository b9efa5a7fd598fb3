"""The PyTorch port's ops against the JAX package, on the CPU.

Inputs are made with numpy from a seed and go through both packages. FPS
indices and ball-query indices must be identical; pooled features agree
with the exact unfused reference to f32 summation order (rtol 1e-5, atol
1e-5). The JAX Pallas kernels run in interpret mode. The kernel-vs-plain cases need a CUDA card and skip here.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch
from jax.experimental import pallas as pl

from maskplanner_tpu_torch.ops.cuda.fps import fps_cuda
from maskplanner_tpu_torch.ops.cuda.fused_sa import fused_sa_cuda
from maskplanner_tpu_torch.ops.fused_sa import (fused_sa_forward,
                                                fused_sa_forward_plain)
from maskplanner_tpu_torch.ops.sampling import (farthest_point_sample,
                                                fps_plain, index_points,
                                                query_ball_point)

torch.set_num_threads(1)


@pytest.fixture
def interpret_mode(monkeypatch):
    orig = pl.pallas_call

    def interp(*a, **k):
        k["interpret"] = True
        return orig(*a, **k)

    monkeypatch.setattr(pl, "pallas_call", interp)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _grid_cloud(B=2, side=4):
    """Points on an exactly representable grid: many equal distances."""
    g = np.stack(np.meshgrid(*[np.arange(side)] * 3, indexing="ij"),
                 -1).reshape(-1, 3).astype(np.float32) * 0.25
    return np.stack([np.roll(g, 5 * b, axis=0) for b in range(B)])


def _fps_cases():
    """Random clouds, exact ties on a grid, more picks than points, clouds
    whose sizes leave the kernel's last warp partly empty (1, 33, 513,
    1000), and a cloud of 4 copies of each of 50 points in shuffled order
    (duplicates tie at distance 0)."""
    rng = np.random.default_rng(3)
    rand = rng.normal(size=(3, 200, 3)).astype(np.float32)
    small = rng.normal(size=(2, 10, 3)).astype(np.float32)
    dup = np.concatenate([rng.normal(size=(2, 50, 3))] * 4, axis=1)
    dup = dup[:, rng.permutation(200)].astype(np.float32)
    sized = {f"n{n}": (rng.normal(size=(2, n, 3)).astype(np.float32),
                       min(n + 3, 96), np.array([0, n - 1], np.int32))
             for n in (1, 33, 513, 1000)}
    return {
        "start0": (rand, 64, None),
        "starts": (rand, 64, np.array([0, 17, 199], np.int32)),
        "ties": (_grid_cloud(), 40, np.array([0, 63], np.int32)),
        "npoint_gt_n": (small, 16, None),
        "duplicates": (dup, 80, np.array([3, 150], np.int32)),
        **sized,
    }


FPS_CASES = _fps_cases()


class TestFPS:
    @pytest.mark.parametrize("case", sorted(FPS_CASES))
    def test_matches_jax_xla(self, case):
        from maskplanner_tpu.ops.sampling import farthest_point_sample as jfps

        xyz, npoint, start = FPS_CASES[case]
        ref = np.asarray(jfps(jnp.asarray(xyz), npoint,
                              start_idx=0 if start is None
                              else jnp.asarray(start)))
        t_start = None if start is None else torch.from_numpy(start)
        got = farthest_point_sample(torch.from_numpy(xyz), npoint, t_start)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), ref)

    @pytest.mark.parametrize("case", sorted(FPS_CASES))
    def test_matches_pallas_interpret(self, case, interpret_mode):
        from maskplanner_tpu.ops.pallas.fps import fps_pallas

        xyz, npoint, start = FPS_CASES[case]
        ref = np.asarray(fps_pallas(
            jnp.asarray(xyz), npoint,
            start=None if start is None else jnp.asarray(start)))
        zeros = np.zeros(xyz.shape[0], np.int32)
        got = fps_plain(torch.from_numpy(xyz), npoint,
                        torch.from_numpy(zeros if start is None else start))
        np.testing.assert_array_equal(got.numpy(), ref)

    def test_start_out_of_range_raises(self):
        xyz = torch.zeros(1, 8, 3)
        with pytest.raises(ValueError, match="start"):
            farthest_point_sample(xyz, 4, torch.tensor([8]))


def _sa_case(norm, with_features, empty_ball=False, B=2, N=256, S=64,
             chans=(16, 24), seed=0):
    rng = np.random.default_rng(seed)
    xyz = rng.normal(size=(B, N, 3)).astype(np.float32) * 0.5
    new_xyz = xyz[:, :S].copy()
    if empty_ball:
        new_xyz[:, ::7] += 50.0            # no point within the radius
    feats = (rng.normal(size=(B, N, 5)).astype(np.float32)
             if with_features else None)
    ci = 3 + (5 if with_features else 0)
    params = []
    for co in chans:
        layer = [rng.normal(size=(co, ci)).astype(np.float32) * 0.3,
                 rng.normal(size=(co,)).astype(np.float32) * 0.1]
        if norm == "layer":
            layer += [rng.normal(size=(co,)).astype(np.float32) * 0.2 + 1.0,
                      rng.normal(size=(co,)).astype(np.float32) * 0.1]
        params.append(tuple(layer))
        ci = co
    return xyz, new_xyz, feats, tuple(params)


def _torch_args(xyz, new_xyz, feats, params):
    t = torch.from_numpy
    return (t(xyz), t(new_xyz), None if feats is None else t(feats),
            tuple(tuple(t(a) for a in layer) for layer in params))


def _jax_args(xyz, new_xyz, feats, params):
    return (jnp.asarray(xyz), jnp.asarray(new_xyz),
            None if feats is None else jnp.asarray(feats),
            tuple(tuple(jnp.asarray(a) for a in layer) for layer in params))


SA_CASES = [("layer", False, False), ("layer", True, False),
            ("none", False, False), ("none", True, False),
            ("layer", True, True), ("none", False, True)]
RADIUS, K = 0.35, 16


class TestFusedSA:
    @pytest.mark.parametrize("norm,with_features,empty_ball", SA_CASES)
    def test_matches_pallas_interpret(self, norm, with_features, empty_ball,
                                      interpret_mode):
        from maskplanner_tpu.ops.pallas.fused_sa_train import (
            _fsa_train_fwd_raw, _pack_xt)

        case = _sa_case(norm, with_features, empty_ball)
        xyz, new_xyz, feats, params = _jax_args(*case)
        out, idx = _fsa_train_fwd_raw(
            RADIUS, K, norm, _pack_xt(xyz, feats), jnp.swapaxes(new_xyz, 1, 2),
            params)
        ref_pooled = np.swapaxes(np.asarray(out), 1, 2)
        ref_idx = np.swapaxes(np.asarray(idx)[:, :K, :out.shape[-1]], 1,
                               2).astype(np.int32)

        pooled, got_idx = fused_sa_forward(RADIUS, K, norm,
                                           *_torch_args(*case))
        np.testing.assert_array_equal(got_idx.numpy(), ref_idx)
        # the Pallas kernel gathers through a hi/lo bf16 one-hot split, so it
        # holds its own unfused reference only to 2e-5 x max|ref|
        # (tests/test_fused_sa_train.py); the exact reference is held to
        # 1e-5 in test_matches_unfused_jax
        np.testing.assert_allclose(pooled.numpy(), ref_pooled,
                                   atol=2e-5 * np.abs(ref_pooled).max())

    @pytest.mark.parametrize("norm,with_features,empty_ball", SA_CASES)
    def test_matches_unfused_jax(self, norm, with_features, empty_ball,
                                 monkeypatch):
        # the JAX ball query's fixed-order distance form is the port's
        monkeypatch.setenv("MASKPLANNER_DETERMINISTIC_NN", "1")
        from maskplanner_tpu.ops.sampling import query_ball_point as jqbp
        from test_fused_sa_train import _unfused

        case = _sa_case(norm, with_features, empty_ball)
        jargs = _jax_args(*case)
        ref = np.asarray(_unfused(RADIUS, K, norm, *jargs))
        ref_idx = np.asarray(jqbp(RADIUS, K, jargs[0], jargs[1]))

        pooled, idx = fused_sa_forward(RADIUS, K, norm, *_torch_args(*case))
        np.testing.assert_array_equal(idx.numpy(), ref_idx)
        np.testing.assert_allclose(pooled.numpy(), ref, rtol=1e-5, atol=1e-5)

    def test_empty_ball_gives_index_zero(self):
        xyz = torch.zeros(1, 8, 3)
        q = torch.full((1, 2, 3), 9.0)
        q[0, 1] = 0.0
        idx = query_ball_point(0.1, 4, xyz, q)
        assert idx[0, 0].tolist() == [0, 0, 0, 0]
        assert idx[0, 1].tolist() == [0, 1, 2, 3]

    def test_gradient_request_raises(self):
        """The level is differentiable in its inputs and weights; its
        neighbour indices are not, and asking for their gradient raises."""
        case = _torch_args(*_sa_case("layer", True))
        w = case[3][0][0].clone().requires_grad_(True)
        params = ((w,) + case[3][0][1:],) + case[3][1:]
        pooled, idx = fused_sa_forward(RADIUS, K, "layer", case[0], case[1],
                                       case[2], params)
        assert pooled.requires_grad and not idx.requires_grad
        pooled.sum().backward()
        assert w.grad is not None and bool(torch.isfinite(w.grad).all())
        with pytest.raises(RuntimeError):
            idx.float().sum().backward()

    def test_cpu_tensors_never_count_a_launch(self):
        fps_before = fps_cuda.launches
        sa_before = fused_sa_cuda.launches
        case = _torch_args(*_sa_case("layer", True))
        farthest_point_sample(case[0], 16)
        with torch.no_grad():
            fused_sa_forward(RADIUS, K, "layer", *case)
        assert fps_cuda.launches == fps_before
        assert fused_sa_cuda.launches == sa_before


@pytest.mark.cuda
class TestKernelsOnCard:
    """Kernel vs plain version on the card, as chip_smoke.py's phase 3."""

    def test_fps_kernel_matches_plain(self, cuda_device):
        rng = np.random.default_rng(0)
        xyz = torch.tensor(rng.normal(size=(4, 5120, 3)).astype(np.float32),
                           device=cuda_device)
        start = torch.tensor([0, 1, 77, 5119], dtype=torch.int32,
                             device=cuda_device)
        before = fps_cuda.launches
        got = farthest_point_sample(xyz, 512, start)
        assert fps_cuda.launches == before + 1
        assert torch.equal(got, fps_plain(xyz, 512, start))
        for case, (pts, npoint, first) in FPS_CASES.items():
            pts = torch.from_numpy(pts).to(cuda_device)
            first = torch.zeros(pts.shape[0], dtype=torch.int32,
                                device=cuda_device) if first is None \
                else torch.from_numpy(first).to(cuda_device)
            assert torch.equal(farthest_point_sample(pts, npoint, first),
                               fps_plain(pts, npoint, first)), case

    def test_fps_start_out_of_range_traps(self, cuda_device):
        """A start index outside [0, N) is checked on the card: the kernel
        traps (which ends the CUDA context), so a child process runs it and
        must fail after the launch."""
        import os
        import subprocess
        import sys

        code = ("import torch\n"
                "from maskplanner_tpu_torch.ops.sampling import "
                "farthest_point_sample\n"
                "x = torch.rand(2, 100, 3, device='cuda')\n"
                "farthest_point_sample(x, 8, torch.tensor([0, 100], "
                "dtype=torch.int32, device='cuda'))\n"
                "print('launched', flush=True)\n"
                "torch.cuda.synchronize()\n")
        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                           text=True, timeout=300, cwd=root)
        assert p.returncode != 0
        assert "launched" in p.stdout

    @pytest.mark.parametrize("norm", ["layer", "none"])
    def test_fused_sa_kernel_matches_plain(self, cuda_device, norm):
        case = _sa_case(norm, True, empty_ball=True, N=512, S=128,
                        chans=(32, 32, 64))
        args = [None if a is None else a.to(cuda_device) if
                isinstance(a, torch.Tensor) else
                tuple(tuple(t.to(cuda_device) for t in l) for l in a)
                for a in _torch_args(*case)]
        with torch.no_grad():
            pooled, idx = fused_sa_forward(0.4, 64, norm, *args)
            ref, ref_idx = fused_sa_forward_plain(0.4, 64, norm, *args)
        assert torch.equal(idx, ref_idx)
        tol = 1e-4 * float(ref.abs().max())
        assert float((pooled - ref).abs().max()) <= tol

    def test_index_points_on_card(self, cuda_device):
        pts = torch.arange(12.0, device=cuda_device).reshape(1, 4, 3)
        idx = torch.tensor([[[3, 0]]], device=cuda_device)
        assert index_points(pts, idx)[0, 0, 0].tolist() == [9.0, 10.0, 11.0]
