"""The masked farthest point sampling of the port
(``ops.sampling.farthest_point_sample(..., mask=)``, the masked mode of
kernel #1, ``csrc/fps.cu``) against the JAX package's
``farthest_point_sample(mask=...)`` on the CPU, index for index: partial
masks, clouds with fewer valid points than ``npoint``, invalid starts, an
all-invalid cloud and a cloud whose only valid point is its last, in the
sizes of the kernel's two paths' tests (the plain version runs here; the
kernel is held against it on the card by ``chip_smoke.py``, phase 29).
Also ``torch.library.opcheck`` of ``maskplanner::fps`` with the mask, and
the unmasked call unchanged by a mask of all points.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maskplanner_tpu.ops.sampling import farthest_point_sample as jax_fps
from maskplanner_tpu_torch.ops import library
from maskplanner_tpu_torch.ops.sampling import farthest_point_sample

torch.set_num_threads(1)


def _case(B, N, npoint, seed, keep=0.8):
    """Clouds, a mask keeping about ``keep`` of the points, and starts;
    cloud 1 has fewer valid points than ``npoint``, cloud 2 none, cloud 3
    only its last point; every start of an even cloud is invalid where the
    mask allows."""
    rng = np.random.default_rng(seed)
    xyz = rng.normal(size=(B, N, 3)).astype(np.float32)
    mask = rng.uniform(size=(B, N)) < keep
    mask[1] = False
    mask[1, rng.choice(N, size=max(1, npoint // 3), replace=False)] = True
    mask[2] = False
    mask[3] = False
    mask[3, N - 1] = True
    start = rng.integers(0, N, size=B).astype(np.int32)
    for b in range(0, B, 2):
        invalid = np.flatnonzero(~mask[b])
        if invalid.size:
            start[b] = invalid[len(invalid) // 2]
    return xyz, mask, start


CASES = {"sa1-like": (6, 160, 32, 0), "sa2-like": (5, 32, 8, 1),
         "npoint above N": (4, 12, 20, 2), "sparse": (4, 64, 16, 3)}


@pytest.mark.parametrize("case", list(CASES))
def test_masked_fps_matches_jax(case):
    B, N, npoint, seed = CASES[case]
    xyz, mask, start = _case(B, N, npoint, seed,
                             keep=0.2 if case == "sparse" else 0.8)
    ref = np.asarray(jax_fps(jnp.asarray(xyz), npoint,
                             start_idx=jnp.asarray(start),
                             mask=jnp.asarray(mask)))
    got = farthest_point_sample(torch.from_numpy(xyz), npoint,
                                torch.from_numpy(start),
                                torch.from_numpy(mask))
    assert got.dtype == torch.int32 and got.shape == (B, npoint)
    np.testing.assert_array_equal(got.numpy(), ref)
    picked = np.take_along_axis(mask, got.numpy().astype(np.int64), axis=1)
    counts = mask.sum(1)
    for b in range(B):
        if counts[b]:
            # only valid points, each valid point once before any repeats
            assert picked[b].all(), b
            first = got.numpy()[b, :min(npoint, counts[b])]
            assert len(set(first.tolist())) == len(first), b
        else:
            np.testing.assert_array_equal(got.numpy()[b], 0)
    # the cases reach every listed situation
    assert (~mask[np.arange(B), start]).any() and (counts < npoint).any()


def test_a_full_mask_is_the_unmasked_sampling():
    xyz, _, start = _case(4, 48, 12, 4)
    x, s = torch.from_numpy(xyz), torch.from_numpy(start)
    torch.testing.assert_close(
        farthest_point_sample(x, 12, s, torch.ones(4, 48, dtype=torch.bool)),
        farthest_point_sample(x, 12, s), rtol=0, atol=0)


def test_opcheck_with_the_mask():
    xyz, mask, start = _case(4, 40, 10, 5)
    torch.library.opcheck(library.fps, (torch.from_numpy(xyz), 10,
                                        torch.from_numpy(start),
                                        torch.from_numpy(mask)))
