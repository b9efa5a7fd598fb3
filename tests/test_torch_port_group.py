"""The port's ball grouping, ball query and folded BatchNorm level against the
JAX package, on the CPU.

Inputs are made with numpy from a seed and go through both packages; the
JAX Pallas kernels run in interpret mode, the JAX distances in their
fixed-order form (``MASKPLANNER_DETERMINISTIC_NN``), which the port uses.

- ``ball_group`` (the counterpart of ``ball_group_pallas``): indices equal
  to the Pallas kernel's and the XLA path's; values exact against the XLA
  path, and within rtol 1e-4, atol 3e-5 of the Pallas kernel, whose hi/lo
  bf16 one-hot extraction holds its own XLA reference only that far
  (``tests/test_pallas_kernels.py``). The backward within rtol 1e-5, atol
  1e-6 of ``jax.vjp`` through the kernel's one-hot scatter: both sum the
  same terms in another order.
- ``query_ball_point``: indices equal to ``ball_query_pallas``'s.
- ``fold_pointmlp_params``: within 1e-6 relative of the JAX fold.
- ``fused_set_abstraction``: within 2e-5 · max|ref| of the JAX kernel,
  which gathers through the hi/lo split and forms layer 1 as
  ``W·[x; f] − W[:, :3]·q``; the gaps measured on these inputs are
  7.3e-6 · max|ref| without features and 3.2e-6 · max|ref| with 13.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.experimental import pallas as pl

from maskplanner_tpu_torch.convert import state_dict_from_flax
from maskplanner_tpu_torch.models.pointnet2 import PointMLP, SetAbstraction
from maskplanner_tpu_torch.ops.cuda.fused_sa import folded_sa_cuda
from maskplanner_tpu_torch.ops.cuda.group_gather import (ball_group_cuda,
                                                         ball_query_cuda)
from maskplanner_tpu_torch.ops.fused_sa import (fold_pointmlp_params,
                                                fused_set_abstraction)
from maskplanner_tpu_torch.ops.group_gather import (BallGroup, ball_group,
                                                    ball_group_backward,
                                                    ball_group_plain)
from maskplanner_tpu_torch.ops.sampling import query_ball_point

torch.set_num_threads(1)


@pytest.fixture
def interpret_mode(monkeypatch):
    orig = pl.pallas_call

    def interp(*a, **k):
        k["interpret"] = True
        return orig(*a, **k)

    monkeypatch.setattr(pl, "pallas_call", interp)


@pytest.fixture
def fixed_order(monkeypatch):
    monkeypatch.setenv("MASKPLANNER_DETERMINISTIC_NN", "1")


# name: (N, S, K, F, radius)
GROUP_CASES = {"xyz-only": (384, 64, 8, 0, 0.5),
               "f5": (256, 64, 8, 5, 0.5),
               "f29": (256, 32, 4, 29, 0.5),
               "sparse": (256, 64, 8, 5, 0.15)}


def _group_case(name, B=2, seed=0):
    N, S, K, F, r = GROUP_CASES[name]
    rng = np.random.default_rng(seed)
    xyz = rng.normal(size=(B, N, 3)).astype(np.float32)
    q = xyz[:, :S].copy()
    feats = rng.normal(size=(B, N, F)).astype(np.float32) if F else None
    ct = rng.normal(size=(B, S, K, 3 + F)).astype(np.float32)
    return r, K, xyz, q, feats, ct


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


class TestBallGroup:
    @pytest.mark.parametrize("case", sorted(GROUP_CASES))
    def test_matches_pallas_interpret(self, case, interpret_mode):
        from maskplanner_tpu.ops.pallas.group_gather import ball_group_pallas

        r, K, xyz, q, feats, _ = _group_case(case)
        ref, ref_idx = ball_group_pallas(r, K, _j(xyz), _j(q), _j(feats))
        got, idx = ball_group(r, K, _t(xyz), _t(q), _t(feats))
        assert idx.dtype == torch.int32 and got.shape == ref.shape
        np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_idx))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4,
                                   atol=3e-5)

    @pytest.mark.parametrize("case", sorted(GROUP_CASES))
    def test_matches_xla_path_exactly(self, case, fixed_order):
        from maskplanner_tpu.ops.sampling import index_points as jip
        from maskplanner_tpu.ops.sampling import query_ball_point as jqbp

        r, K, xyz, q, feats, _ = _group_case(case)
        ref_idx = jqbp(r, K, _j(xyz), _j(q))
        ref = jip(_j(xyz), ref_idx) - _j(q)[:, :, None, :]
        if feats is not None:
            ref = jnp.concatenate([ref, jip(_j(feats), ref_idx)], axis=-1)
        got, idx = ball_group_plain(r, K, _t(xyz), _t(q), _t(feats))
        np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_idx))
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))

    def test_empty_ball_gives_index_zero(self, interpret_mode):
        from maskplanner_tpu.ops.pallas.group_gather import ball_group_pallas

        rng = np.random.default_rng(1)
        xyz = rng.normal(size=(1, 128, 3)).astype(np.float32)
        far = np.full((1, 8, 3), 100.0, np.float32)
        feats = rng.normal(size=(1, 128, 5)).astype(np.float32)
        got, idx = ball_group(0.1, 4, _t(xyz), _t(far), _t(feats))
        _, ref_idx = ball_group_pallas(0.1, 4, _j(xyz), _j(far), _j(feats))
        assert (idx == 0).all()
        np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_idx))
        np.testing.assert_array_equal(got[..., 3:].numpy(),
                                      np.broadcast_to(feats[:, :1, None],
                                                      got[..., 3:].shape))

    @pytest.mark.parametrize("case", sorted(GROUP_CASES))
    def test_backward_matches_pallas_vjp(self, case, interpret_mode):
        from maskplanner_tpu.ops.pallas.group_gather import ball_group_pallas

        r, K, xyz, q, feats, ct = _group_case(case)
        args = [_j(xyz), _j(q)] + ([] if feats is None else [_j(feats)])
        _, vjp = jax.vjp(lambda *a: ball_group_pallas(r, K, *a)[0], *args)
        ref = vjp(jnp.asarray(ct))
        _, idx = ball_group_plain(r, K, _t(xyz), _t(q), _t(feats))
        got = ball_group_backward(idx, torch.from_numpy(ct), xyz.shape[1],
                                  True, True, feats is not None)
        for g, want in zip(got, ref):
            np.testing.assert_allclose(g.numpy(), np.asarray(want),
                                       rtol=1e-5, atol=1e-6)
        if feats is None:
            assert got[2] is None

    def test_backward_computes_only_what_is_asked(self):
        r, K, xyz, q, feats, ct = _group_case("f5")
        _, idx = ball_group_plain(r, K, _t(xyz), _t(q), _t(feats))
        d_xyz, d_new, d_feat = ball_group_backward(
            idx, torch.from_numpy(ct), xyz.shape[1], False, False, True)
        assert d_xyz is None and d_new is None
        assert d_feat.shape == feats.shape

    def test_autograd_function_routes_the_gradient(self, monkeypatch):
        """:class:`BallGroup` with its kernel replaced by the plain version
        (the kernel runs only on a card): its backward gives autograd's
        gradient through the plain ops, for the inputs that ask for one."""
        import maskplanner_tpu_torch.ops.cuda.group_gather as cuda_gg

        monkeypatch.setattr(cuda_gg, "ball_group_cuda", ball_group_plain)
        r, K, xyz, q, feats, ct = _group_case("f5")
        ct = torch.from_numpy(ct)
        for need in ((True, True, True), (False, False, True)):
            leaves = [_t(a).clone().requires_grad_(w)
                      for a, w in zip((xyz, q, feats), need)]
            got, _ = BallGroup.apply(r, K, *leaves)
            g = torch.autograd.grad((got * ct).sum(),
                                    [t for t in leaves if t.requires_grad])
            ref_leaves = [_t(a).clone().requires_grad_(w)
                          for a, w in zip((xyz, q, feats), need)]
            ref, _ = ball_group_plain(r, K, *ref_leaves)
            gr = torch.autograd.grad((ref * ct).sum(),
                                     [t for t in ref_leaves
                                      if t.requires_grad])
            for a, b in zip(g, gr):
                torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


class TestBallQuery:
    @pytest.mark.parametrize("r,k", [(0.3, 8), (0.8, 4), (0.05, 8)])
    def test_matches_pallas_interpret(self, r, k, interpret_mode):
        from maskplanner_tpu.ops.pallas.ball_query import ball_query_pallas

        xyz = np.random.default_rng(0).normal(size=(2, 256, 3)).astype(
            np.float32)
        q = xyz[:, :64]
        ref = np.asarray(ball_query_pallas(r, k, _j(xyz), _j(q), tile_s=64))
        got = query_ball_point(r, k, _t(xyz), _t(np.ascontiguousarray(q)))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), ref)

    def test_same_indices_as_the_grouping(self):
        r, K, xyz, q, feats, _ = _group_case("sparse")
        _, idx = ball_group(r, K, _t(xyz), _t(q), _t(feats))
        assert torch.equal(query_ball_point(r, K, _t(xyz), _t(q)), idx)

    def test_cpu_tensors_never_count_a_launch(self):
        before = (ball_group_cuda.launches, ball_query_cuda.launches,
                  folded_sa_cuda.launches)
        r, K, xyz, q, feats, _ = _group_case("f5")
        ball_group(r, K, _t(xyz), _t(q), _t(feats))
        query_ball_point(r, K, _t(xyz), _t(q))
        mlp = PointMLP(8, (16, 32), "batch").eval()
        with torch.no_grad():
            fused_set_abstraction(r, K, _t(xyz), _t(q), _t(feats),
                                  fold_pointmlp_params(mlp))
        assert (ball_group_cuda.launches, ball_query_cuda.launches,
                folded_sa_cuda.launches) == before

    def test_other_devices_raise(self):
        xyz = torch.zeros(1, 8, 3, device="meta")
        with pytest.raises(ValueError, match="device"):
            query_ball_point(0.1, 4, xyz, xyz)
        with pytest.raises(ValueError, match="device"):
            ball_group(0.1, 4, xyz, xyz)


def _flax_pointmlp(cin, widths, seed):
    """A seeded Flax BatchNorm PointMLP variable tree (numpy), statistics
    and affine parameters away from their init so that the fold is not
    trivial."""
    from maskplanner_tpu.models.pointnet2 import PointMLP as FlaxPointMLP

    rng = np.random.default_rng(seed)
    v = FlaxPointMLP(tuple(widths), norm="batch").init(
        jax.random.PRNGKey(seed), jnp.zeros((1, 1, 1, cin)), train=False)

    def noise(path, a):
        leaf = path[-1].key
        if leaf == "var":
            return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        if leaf == "scale":
            return (1.0 + rng.normal(size=a.shape) * 0.2).astype(np.float32)
        if leaf in ("bias", "mean"):
            return (rng.normal(size=a.shape) * 0.2).astype(np.float32)
        return np.asarray(a)

    return jax.tree_util.tree_map_with_path(noise, v)


def _port_pointmlp(variables, cin, widths):
    """The same variables in a port PointMLP (``state_dict_from_flax``)."""
    wrap = {c: {"encoder": {"sa2": {"PointMLP_0": variables[c]}}}
            for c in ("params", "batch_stats")}
    sd = {k[len("sa2."):]: v for k, v in state_dict_from_flax(wrap).items()}
    mlp = PointMLP(cin, widths, "batch")
    mlp.load_state_dict(sd, strict=True)
    return mlp.eval()


class TestFoldedLevel:
    @pytest.mark.parametrize("cin,widths", [(3, (64, 64, 128)),
                                            (131, (32, 32, 64))])
    def test_fold_matches_jax(self, cin, widths):
        from maskplanner_tpu.ops.pallas.fused_sa import \
            fold_pointmlp_params as jax_fold

        v = _flax_pointmlp(cin, widths, seed=cin)
        ref = jax_fold(v)
        with torch.no_grad():
            got = fold_pointmlp_params(_port_pointmlp(v, cin, widths))
        assert len(got) == len(ref)
        for (w, b), (rw, rb) in zip(got, ref):
            for a, want in ((w, rw), (b, rb)):
                want = np.asarray(want)
                assert a.shape == want.shape
                np.testing.assert_allclose(a.numpy(), want, rtol=1e-6,
                                           atol=1e-6 * np.abs(want).max())

    @pytest.mark.parametrize("feat_dim", [None, 13])
    def test_matches_pallas_interpret(self, feat_dim, interpret_mode):
        from maskplanner_tpu.ops.pallas.fused_sa import \
            fold_pointmlp_params as jax_fold
        from maskplanner_tpu.ops.pallas.fused_sa import \
            fused_set_abstraction as jax_fsa

        rng = np.random.default_rng(7)
        B, N, S, K, r = 2, 200, 70, 8, 0.5
        xyz = rng.normal(size=(B, N, 3)).astype(np.float32)
        q = xyz[:, :S].copy()
        feats = (rng.normal(size=(B, N, feat_dim)).astype(np.float32)
                 if feat_dim else None)
        cin = 3 + (feat_dim or 0)
        v = _flax_pointmlp(cin, (16, 16, 32), seed=3)
        ref = np.asarray(jax_fsa(r, K, _j(xyz), _j(q), _j(feats),
                                 jax_fold(v), tile_s=64))
        with torch.no_grad():
            folded = fold_pointmlp_params(_port_pointmlp(v, cin,
                                                         (16, 16, 32)))
            got = fused_set_abstraction(r, K, _t(xyz), _t(q), _t(feats),
                                        folded).numpy()
        assert got.shape == ref.shape == (B, S, 32)
        np.testing.assert_allclose(got, ref, rtol=0,
                                   atol=2e-5 * np.abs(ref).max())

    def test_model_level_in_eval_is_the_folded_level(self):
        """A grouped BatchNorm level with features, in eval, computes
        ``fused_set_abstraction`` on its folded weights."""
        rng = np.random.default_rng(5)
        sa = SetAbstraction(32, 0.4, 8, 3 + 9, (16, 16, 32), False, "batch")
        with torch.no_grad():
            for bn in sa.mlp_bns:
                bn.running_mean.uniform_(-0.2, 0.2)
                bn.running_var.uniform_(0.5, 1.5)
        sa.eval()
        xyz = _t(rng.normal(size=(2, 128, 3)).astype(np.float32))
        feats = _t(rng.normal(size=(2, 128, 9)).astype(np.float32))
        with torch.no_grad():
            new_xyz, pooled = sa(xyz, feats)
            ref = fused_set_abstraction(sa.radius, sa.nsample, xyz, new_xyz,
                                        feats, fold_pointmlp_params(sa))
        torch.testing.assert_close(pooled, ref, rtol=0, atol=0)


@pytest.mark.cuda
class TestKernelsOnCard:
    """The kernels against their plain versions on the card, as
    chip_smoke.py's BatchNorm-recipe phase."""

    @pytest.fixture
    def cuda_device(self):
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA device")
        return torch.device("cuda")

    @pytest.mark.parametrize("case", sorted(GROUP_CASES))
    def test_ball_group_and_query_kernels_match_plain(self, case,
                                                      cuda_device):
        r, K, xyz, q, feats, _ = _group_case(case)
        args = [None if a is None else _t(a).to(cuda_device)
                for a in (xyz, q, feats)]
        got, idx = ball_group_cuda(r, K, *args)
        ref, ref_idx = ball_group_plain(r, K, *args)
        assert torch.equal(idx, ref_idx) and torch.equal(got, ref)
        assert torch.equal(ball_query_cuda(r, K, *args[:2]), ref_idx)

    def test_folded_level_kernel_matches_plain(self, cuda_device):
        r, K, xyz, q, feats, _ = _group_case("f5")
        mlp = PointMLP(8, (16, 32), "batch").eval().to(cuda_device)
        args = [_t(a).to(cuda_device) for a in (xyz, q, feats)]
        with torch.no_grad():
            folded = fold_pointmlp_params(mlp)
            got = folded_sa_cuda(r, K, *args, folded)
            ref = fused_set_abstraction(r, K, *(a.cpu() for a in args),
                                        [(w.cpu(), b.cpu())
                                         for w, b in folded])
        assert float((got.cpu() - ref).abs().max()) <= \
            1e-4 * float(ref.abs().max())
