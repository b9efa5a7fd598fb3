"""Loss registry and handler (``maskplanner_tpu/losses/__init__.py``).

The weighted sum of the configured terms, each ``weight_<name>`` times its
value, over the JAX package's registry of 32 names and with its
compatibility checks. Loss weights are a plain dict of floats that the
PSACD curriculum and the delayed activations change between epochs, or the
same weights as 0-d tensors on the model's device (:class:`DeviceWeights`,
the JAX step's "weights as a traced dict"), which a captured CUDA graph
reads and the driver fills in place from the float dict after each change.

Every term is ported (``PORTED``, all 32; ``WAITING`` is empty).
``train.build_loss_batch`` supplies the MaskPlanner and regressor terms'
inputs; the stroke-wise, rollout, start-of-path and contrastive
(``latent_segments``, the segmenters' output) terms take batches that their
caller builds, under the JAX handler's batch keys, as in the JAX package.
The adversarial terms (``discriminator``, ``wdiscriminator``) read the
critic from the batch keys ``gan_module`` (``losses.gan.AdversarialLoss``)
and ``gan_state`` (its ``CriticState``), which
``train.trainer.gan_train_step`` passes; without them (the eval) they are
0.
"""
from __future__ import annotations

from typing import Callable

import torch

from ..data.pointcloud import get_dim_traj_points
from . import chamfer_losses as C
from . import mask_losses as M
from . import regularizers as R
from . import stroke_losses as S

LOSS_NAMES = [
    "chamfer", "repulsion", "mse", "align", "velcosine", "intra_align",
    "discriminator", "wdiscriminator", "attraction_chamfer",
    "rich_attraction_chamfer", "contrastive_v1", "asymm_segment_chamfer",
    "reverse_asymm_point_chamfer", "stoch_reverse_asymm_segment_chamfer",
    "reverse_asymm_segment_chamfer", "chamfer_bbox", "mse_strokes",
    "chamfer_strokes", "asymm_v6_chamfer_strokes", "masked_mse_strokes",
    "masked_mse_strokes_v2", "symm_segment_chamfer", "symm_point_chamfer",
    "mse_nexttoken", "mse_nexttoken_v2", "emd", "chamfer_with_stroke_masks",
    "asymm_v6_chamfer_with_stroke_masks", "asymm_v11_chamfer_with_stroke_masks",
    "symm_v1_chamfer_with_stroke_masks", "masked_mse_strokes_from_segments",
    "hungarian_SoPs",
]

# the names whose inputs no ported model produces: none any more
WAITING: dict[str, str] = {}
# the names the JAX handler accepts without their weight_<name> key
_NO_WEIGHT_KEY = ("masked_mse_strokes_from_segments",)
PORTED = tuple(n for n in LOSS_NAMES if n not in WAITING)
# the terms whose step a CUDA graph cannot capture, with why
_SVD = ("torch.linalg.svdvals (cuSOLVER) copies to the host during a CUDA "
        "graph capture")
UNCAPTURABLE = {"align": _SVD, "intra_align": _SVD}

# the terms allowed at lambda_points > 1 (the JAX handler's set)
_LAMBDA_GT_1 = {
    "hungarian_SoPs", "masked_mse_strokes_from_segments",
    "asymm_v6_chamfer_with_stroke_masks", "symm_v1_chamfer_with_stroke_masks",
    "asymm_v11_chamfer_with_stroke_masks", "chamfer_with_stroke_masks",
    "emd", "chamfer", "symm_segment_chamfer", "symm_point_chamfer",
    "intra_align", "attraction_chamfer", "rich_attraction_chamfer",
    "repulsion", "contrastive_v1", "asymm_segment_chamfer",
    "reverse_asymm_point_chamfer", "stoch_reverse_asymm_segment_chamfer",
    "reverse_asymm_segment_chamfer", "chamfer_strokes", "mse_nexttoken",
    "mse_nexttoken_v2",
}

# weights consumed inside the loss terms (beyond weight_<name>)
_EXPLICIT_WEIGHT_KEYS = [
    "weight_asymm_segment_chamfer",
    "weight_reverse_asymm_point_chamfer",
    "weight_reverse_asymm_segment_chamfer",
    "weight_symm_segment_chamfer",
    "weight_symm_point_chamfer",
    "explicit_weight_stroke_masks",
    "explicit_weight_stroke_masks_confidence",
    "explicit_no_stroke_weight",
    "explicit_weight_segments_confidence",
    "explicit_weight_endofpath_confidence_loss",
    "explicit_no_sop_weight",
    "explicit_weight_sop_confidence_loss",
    "explicit_weight_masked_mse_loss",
    "explicit_weight_point_confidence_loss",
    "explicit_weight_stroke_confidence_loss",
]


class DeviceWeights(dict):
    """The loss weights as 0-d float32 tensors on ``device``.

    The loss uses a weight only as a factor, so a tensor weight gives the
    float weight's result bit for bit. A CUDA graph captured on these
    tensors reads whatever they hold at replay: :meth:`load` writes the
    values of a dict of float weights into them in place (``fill_``)."""

    def __init__(self, weights: dict, device):
        super().__init__({k: torch.tensor(float(v), dtype=torch.float32,
                                          device=device)
                          for k, v in weights.items()})

    def load(self, weights: dict) -> None:
        """Each float weight of ``weights`` into its tensor, in place."""
        for key, value in weights.items():
            self[key].fill_(float(value))


class LossHandler:
    """Builds and evaluates the weighted sum of the configured loss terms."""

    def __init__(self, loss, config):
        unknown = set(loss) - set(LOSS_NAMES)
        assert not unknown, f"invalid loss names: {unknown}"
        self.loss = list(loss)
        self.config = config
        self.outdim = get_dim_traj_points(config["extra_data"])
        self.lambda_points = int(config["lambda_points"])

        # the JAX handler's compatibility checks
        for name in self.loss:
            assert f"weight_{name}" in config or name in _NO_WEIGHT_KEY, \
                f"missing weight_{name} in config"
        assert not ("chamfer" in self.loss and "mse" in self.loss)
        if self.lambda_points > 1:
            assert set(self.loss) <= _LAMBDA_GT_1, (
                f"losses {set(self.loss) - _LAMBDA_GT_1} unsupported for "
                f"lambda > 1")
        if "intra_align" in self.loss:
            assert self.lambda_points > 3
        if "align" in self.loss:
            assert config["knn_repulsion"] > 1
        self._dispatch = self._build_dispatch()

    @property
    def uncapturable(self) -> dict[str, str]:
        """The configured terms that a CUDA graph cannot capture, each with
        why."""
        return {n: UNCAPTURABLE[n] for n in self.loss if n in UNCAPTURABLE}

    def init_weights(self) -> dict[str, float]:
        """Flat dict of the dynamic loss weights."""
        w: dict[str, float] = {}
        for name in self.loss:
            w[f"weight_{name}"] = float(self.config.get(f"weight_{name}", 1.0))
        for key in _EXPLICIT_WEIGHT_KEYS:
            if key in self.config and self.config[key] is not None:
                w[key] = float(self.config[key])
        return w

    def compute(self, weights, generator: torch.Generator | None = None,
                return_list=True, **batch):
        """Weighted total + per-term values. ``generator``: the step's
        generator, from which the stochastic term draws its subset."""
        total = 0.0
        terms = {}
        for name in self.loss:
            value = self._dispatch[name](batch, weights, generator)
            total = total + weights[f"weight_{name}"] * value
            terms[name] = value
        if return_list:
            return total, terms
        return total

    def _build_dispatch(self) -> dict[str, Callable]:
        cfg = self.config
        outdim = self.outdim

        def std(b):
            return dict(y_pred=b["y_pred"], y=b.get("y"),
                        y_mask=b.get("y_mask"),
                        traj_as_pc=b.get("traj_as_pc"),
                        pc_mask=b.get("pc_mask"), outdim=outdim)

        def masks(b, w):
            return dict(pred_stroke_masks=b["pred_stroke_masks"],
                        mask_scores=b["mask_scores"],
                        stroke_ids=b["stroke_ids"], weights=w)

        def strokes(b):
            return dict(y_pred=b["stacked_segments_per_stroke_pred"],
                        y=b["stacked_segments_per_stroke_gt"],
                        y_mask=b.get("stacked_segments_per_stroke_gt_mask"))

        def v6_args(b, w):
            return dict(**std(b), **masks(b, w),
                        seg_logits=b.get("seg_logits"),
                        per_segment_confidence=bool(
                            cfg.get("per_segment_confidence")),
                        smooth_targets=bool(
                            cfg.get("smooth_target_stroke_masks")))

        def adversarial(b, w, g):
            # the eval (no critic in the batch) reads 0
            if b.get("gan_module") is None:
                return torch.zeros((), device=b["y_pred"].device)
            return b["gan_module"].generator_loss(b["gan_state"], b["y_pred"])

        return {
            "discriminator": adversarial,
            "wdiscriminator": adversarial,
            "contrastive_v1": lambda b, w, g: R.contrastive_v1(
                b["latent_segments"], b["stroke_ids"], generator=g,
                margin=float(cfg.get("contrastive_loss_margin", 0.3)),
                balance_negatives=bool(
                    cfg.get("contrastive_balance_negatives", True)),
                n_strokes_max=int(cfg.get("max_n_strokes") or 64)),
            "chamfer": lambda b, w, g: C.chamfer(
                **std(b), min_centroids=bool(cfg.get("min_centroids")),
                velocities="vel" in cfg["extra_data"]),
            "symm_segment_chamfer": lambda b, w, g:
                C.symm_segment_chamfer(**std(b)),
            "symm_point_chamfer": lambda b, w, g:
                C.symm_point_chamfer(**std(b)),
            "asymm_segment_chamfer": lambda b, w, g:
                C.asymm_segment_chamfer(**std(b)),
            "reverse_asymm_point_chamfer": lambda b, w, g:
                C.reverse_asymm_point_chamfer(**std(b)),
            "reverse_asymm_segment_chamfer": lambda b, w, g:
                C.reverse_asymm_segment_chamfer(**std(b)),
            "stoch_reverse_asymm_segment_chamfer": lambda b, w, g:
                C.stoch_reverse_asymm_segment_chamfer(generator=g, **std(b)),
            "attraction_chamfer": lambda b, w, g:
                C.attraction_chamfer(**std(b)),
            "rich_attraction_chamfer": lambda b, w, g:
                C.rich_attraction_chamfer(
                    soft_attraction=bool(cfg.get("soft_attraction")),
                    **std(b)),
            "chamfer_bbox": lambda b, w, g: C.chamfer_bbox(
                bbox_pred=b["y_pred"], bbox_gt=b["y"],
                bbox_mask=b.get("y_mask")),
            "repulsion": lambda b, w, g: R.repulsion(
                knn_repulsion=int(cfg["knn_repulsion"]),
                rep_target=cfg.get("rep_target"),
                lambda_points=self.lambda_points, **std(b)),
            "align": lambda b, w, g: R.align(
                b["y_pred"], knn_repulsion=int(cfg["knn_repulsion"])),
            "intra_align": lambda b, w, g: R.intra_align(b["y_pred"]),
            "velcosine": lambda b, w, g: R.velcosine(
                b["y_pred"], knn_repulsion=int(cfg["knn_repulsion"])),
            "mse": lambda b, w, g: R.mse(b["y_pred"], b["y"]),
            "emd": lambda b, w, g: S.emd(b["y_pred"], b["y"],
                                         y_mask=b.get("y_mask")),
            "chamfer_with_stroke_masks": lambda b, w, g:
                M.chamfer_with_stroke_masks(
                    y_pred=b["y_pred"], y=b["y"], y_mask=b.get("y_mask"),
                    **masks(b, w)),
            "asymm_v6_chamfer_with_stroke_masks": lambda b, w, g:
                M.asymm_v6_chamfer_with_stroke_masks(**v6_args(b, w)),
            "asymm_v11_chamfer_with_stroke_masks": lambda b, w, g:
                M.asymm_v11_chamfer_with_stroke_masks(**v6_args(b, w)),
            "symm_v1_chamfer_with_stroke_masks": lambda b, w, g:
                M.symm_v1_chamfer_with_stroke_masks(**std(b), **masks(b, w)),
            "chamfer_strokes": lambda b, w, g: C.chamfer_strokes(
                b["stacked_segments_per_stroke_pred"],
                b["stacked_segments_per_stroke_gt"],
                gt_mask=b.get("stacked_segments_per_stroke_gt_mask")),
            "asymm_v6_chamfer_strokes": lambda b, w, g: (
                C.asymm_segment_chamfer(**strokes(b))
                + C.reverse_asymm_segment_chamfer(**strokes(b))),
            "mse_strokes": lambda b, w, g: S.mse_strokes(
                b["stacked_strokes_pred"], b["stacked_strokes_gt"]),
            "mse_nexttoken": lambda b, w, g: S.mse_nexttoken(
                b["stacked_pred_nexttoken"], b["stacked_gt_nexttoken"]),
            "mse_nexttoken_v2": lambda b, w, g: S.mse_nexttoken_v2(
                b["stacked_pred_nexttoken"], b["stacked_gt_nexttoken"],
                b["end_of_path_scores"], b["end_of_path_gt"], w),
            "masked_mse_strokes": lambda b, w, g: S.masked_mse_strokes(
                b["stacked_points_per_stroke_pred"],
                b["stacked_points_per_stroke_gt"], b["confidence_scores"]),
            "masked_mse_strokes_v2": lambda b, w, g: S.masked_mse_strokes_v2(
                b["pred_points_per_stroke"], b["points_per_stroke"],
                b["pred_point_scores"], b["pred_stroke_scores"],
                b["gt_stroke_mask"], w, outdim=outdim),
            "masked_mse_strokes_from_segments": lambda b, w, g:
                S.masked_mse_strokes_from_segments(
                    b["stacked_points_per_stroke_pred"],
                    b["stacked_points_per_stroke_gt"],
                    b["confidence_scores"], b["output_mask"]),
            "hungarian_SoPs": lambda b, w, g: S.hungarian_sops(
                b["sop_pred"], b["sop_gt"], b["pred_sop_conf_scores"], w,
                sop_mask=b.get("sop_mask")),
        }
