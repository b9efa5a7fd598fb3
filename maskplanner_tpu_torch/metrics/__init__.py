"""Evaluation metrics (``maskplanner_tpu/metrics/__init__.py``).

A ``MetricsHandler(config, metrics, renormalize_output_config)`` with the
same registry, output names and checks. The chamfer metrics run on
tensors through the port's ``ops.chamfer`` (the nearest-neighbour argmin
kernel on the card) and sync the host once each; the stroke-count and
clustering metrics copy the mask heads to the host and run the port's
numpy postprocess; the SoP families count the start-of-path tokens with
``postprocess/sop.py`` on the host.
"""
from __future__ import annotations

import inspect
from typing import Dict

import numpy as np
import torch

from ..data.pointcloud import get_dim_traj_points
from ..ops.chamfer import chamfer_distance
from ..postprocess.sop import postprocess_sop_predictions, unpad_rows
from ..postprocess.stroke_ids import process_pred_stroke_masks_to_stroke_ids
from .clustering import adjusted_rand_score, v_measure_score

METRIC_OUTPUTS = {
    "pcd": ("point-wise chamfer distance",),
    "chamfer_original": ("chamfer original",),
    "stroke_chamfer": ("stroke chamfer distance",),
    "clustering_metrics": ("v_measure", "adjusted_rand_score",
                           "avg_num_of_outliers"),
    "sop_metrics": (
        "avg_num_of_pred_sops", "avg_num_of_gt_sops",
        "avg_ratio_pred_over_gt_sops",
        "avg_num_of_pred_sops_if_higher_threshold",
        "avg_num_of_pred_sops_if_lower_threshold",
        "avg_ratio_pred_over_gt_sops_if_higher_threshold",
        "avg_ratio_pred_over_gt_sops_if_lower_threshold",
    ),
    "sop_metrics_v2": (
        "perc_correct_n_strokes", "avg_num_of_pred_strokes",
        "avg_num_of_gt_strokes", "mean_absolute_error_NoP",
        "avg_num_of_pred_strokes_if_higher_threshold",
        "avg_num_of_pred_strokes_if_lower_threshold",
        "mean_absolute_error_NoP_if_higher_threshold",
        "mean_absolute_error_NoP_if_lower_threshold",
    ),
    "stroke_masks_metrics": (
        "perc_correct_n_strokes", "avg_num_of_pred_strokes",
        "avg_num_of_gt_strokes", "mean_absolute_error_NoP",
    ),
    "strokewise_num_of_strokes_metrics": (
        "perc_correct_n_strokes", "avg_num_of_pred_strokes",
        "avg_num_of_gt_strokes", "mean_absolute_error_NoP",
    ),
}


def _host(x) -> np.ndarray:
    """A tensor (any device, f32 or bf16) or array -> a numpy array."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return (x.float() if x.is_floating_point() else x).cpu().numpy()
    return np.asarray(x)


class MetricsHandler:
    """Compute evaluation metrics (reference metrics_handler.py:25-166)."""

    def __init__(self, config, metrics=(), renormalize_output_config=None):
        self.config = config
        self.metrics = list(metrics)
        unknown = set(self.metrics) - set(METRIC_OUTPUTS)
        assert not unknown, f"invalid metrics: {unknown}"
        # several families emit the same output names; results are keyed
        # by name, so a collision would silently drop one family's values
        names = [n for m in self.metrics for n in METRIC_OUTPUTS[m]]
        dup = {n for n in names if names.count(n) > 1}
        assert not dup, (
            f"metrics {self.metrics} share output names {sorted(dup)}; "
            f"enable only one family per name (reference contract)")
        self.renorm = renormalize_output_config or {}
        self.renormalize_output = bool(self.renorm.get("active"))
        self.outdim = get_dim_traj_points(config["extra_data"])
        self._required: Dict[str, list] = {}
        for m in self.metrics:
            fn = getattr(self, f"get_{m}")
            self._required[m] = [
                p.name for p in inspect.signature(fn).parameters.values()
                if p.default is inspect.Parameter.empty
                and p.kind in (p.POSITIONAL_OR_KEYWORD, p.KEYWORD_ONLY)
            ]
        # only clustering_metrics reads ids derived from the mask heads
        self._needs_derived_ids = any(
            "stroke_ids_pred" in req for req in self._required.values())

    def output_names(self):
        return [n for m in self.metrics for n in METRIC_OUTPUTS[m]]

    def compute(self, **kw) -> Dict[str, float]:
        if (self._needs_derived_ids
                and kw.get("stroke_ids_pred") is None
                and kw.get("pred_stroke_masks") is not None
                and kw.get("mask_scores") is not None):
            kw["stroke_ids_pred"] = process_pred_stroke_masks_to_stroke_ids(
                _host(kw["pred_stroke_masks"]), _host(kw["mask_scores"]))

        out: Dict[str, float] = {}
        for m in self.metrics:
            missing = [r for r in self._required[m] if kw.get(r) is None]
            if missing:
                raise ValueError(
                    f"metric '{m}' requires inputs {missing} that this "
                    f"eval path does not produce")
            vals = getattr(self, f"get_{m}")(**kw)
            if not isinstance(vals, (list, tuple)):
                vals = [vals]
            for name, v in zip(METRIC_OUTPUTS[m], vals):
                out[name] = float(v)
        return out

    def _renorm_traj(self, traj: torch.Tensor) -> torch.Tensor:
        """Rescale the positions to another data_scale_factor for
        cross-category comparison; −100 padding rows stay as they are."""
        if not self.renormalize_output:
            return traj
        fake = torch.all(traj == -100.0, dim=-1, keepdim=True)
        scaled = torch.cat([traj[..., :3] * (self.renorm["from"]
                                             / self.renorm["to"]),
                            traj[..., 3:]], dim=-1)
        return torch.where(fake, traj, scaled)

    def _poses(self, y_pred) -> torch.Tensor:
        y_pred = torch.as_tensor(y_pred)
        return y_pred.reshape(y_pred.shape[0], -1, self.outdim)

    def get_pcd(self, y_pred, traj_as_pc, pc_mask=None, **kw):
        """Point-wise chamfer ×10⁴: the predicted poses against the padded
        GT poses, symmetric (two argmin launches)."""
        pred_pc = self._renorm_traj(self._poses(y_pred))
        gt = self._renorm_traj(torch.as_tensor(traj_as_pc,
                                               device=pred_pc.device))
        if pc_mask is not None:
            pc_mask = torch.as_tensor(pc_mask, device=pred_pc.device)
        cham, _ = chamfer_distance(pred_pc, gt, padded=True, y_mask=pc_mask)
        return 1e4 * float(cham)

    def get_chamfer_original(self, y_pred, traj_pc, **kw):
        """Chamfer against the full untrimmed GT pose cloud, ×10⁴."""
        pred_pc = self._poses(y_pred)
        cham, _ = chamfer_distance(
            pred_pc, torch.as_tensor(traj_pc, device=pred_pc.device))
        return 1e4 * float(cham)

    def get_stroke_masks_metrics(self, n_strokes, pred_stroke_masks,
                                 mask_scores, confidence_threshold=0.5, **kw):
        """Stroke-count metrics via the mask -> id postprocess."""
        ids_pred = process_pred_stroke_masks_to_stroke_ids(
            _host(pred_stroke_masks), _host(mask_scores),
            confidence_threshold)
        n_pred = np.array([len(np.unique(row)) for row in ids_pred])
        return _count_metrics(n_pred, n_strokes)

    def get_strokewise_num_of_strokes_metrics(self, n_strokes, traj_pred,
                                              **kw):
        """``traj_pred``: per-sample arrays of the retained strokes."""
        n_pred = np.array([t.shape[0] for t in traj_pred]).astype(int)
        return _count_metrics(n_pred, n_strokes)

    def get_clustering_metrics(self, stroke_ids_pred, stroke_ids, **kw):
        """V-measure, ARI and outliers over the per-point stroke labels."""
        vms, aris, outliers = [], [], []
        for t, p in zip(_host(stroke_ids), _host(stroke_ids_pred)):
            valid = t >= 0
            vms.append(v_measure_score(t[valid], p[valid]))
            aris.append(adjusted_rand_score(t[valid], p[valid]))
            outliers.append(float((p[valid] < 0).sum()))
        return [float(np.mean(vms)), float(np.mean(aris)),
                float(np.mean(outliers))]

    def get_sop_metrics(self, sop_pred, processed_sop_pred, sop_gt,
                        pred_sop_conf_scores, sop_conf_threshold, **kw):
        """Start-of-path counts: mean predicted (``processed_sop_pred``, the
        tokens kept), mean GT, their mean ratio, and the same counts and
        ratios at the thresholds halfway to 1 and halfway to 0."""
        n_gt, n_pred, swept = _sop_counts(
            sop_pred, processed_sop_pred, sop_gt, pred_sop_conf_scores,
            sop_conf_threshold)
        res = [float(np.mean(n_pred)), float(np.mean(n_gt)),
               float(np.mean(n_pred / np.maximum(n_gt, 1)))]
        return (res + [float(np.mean(n_t)) for n_t in swept]
                + [float(np.mean(n_t / np.maximum(n_gt, 1)))
                   for n_t in swept])

    def get_sop_metrics_v2(self, sop_pred, processed_sop_pred, sop_gt,
                           pred_sop_conf_scores, sop_conf_threshold, **kw):
        """Start-of-path counts as stroke counts: % correct, mean
        predicted, mean GT, mean absolute error, then the mean predicted
        and the mean absolute error at the thresholds halfway to 1 and
        halfway to 0."""
        n_gt, n_pred, swept = _sop_counts(
            sop_pred, processed_sop_pred, sop_gt, pred_sop_conf_scores,
            sop_conf_threshold)
        res = [float(np.mean(n_gt == n_pred)), float(np.mean(n_pred)),
               float(np.mean(n_gt)), float(np.mean(np.abs(n_pred - n_gt)))]
        return (res + [float(np.mean(n_t)) for n_t in swept]
                + [float(np.mean(np.abs(n_t - n_gt))) for n_t in swept])

    def get_stroke_chamfer(self, y_pred, traj_pc, stroke_ids, **kw):
        """Debug metric: each predicted segment's least asymmetric chamfer
        to a GT stroke, ×10⁴, averaged; a launch and a host sync per
        (segment, stroke) pair."""
        y_pred = torch.as_tensor(y_pred)
        traj_pc = torch.as_tensor(traj_pc, device=y_pred.device)
        stroke_ids = torch.as_tensor(stroke_ids, device=y_pred.device)
        n_pred = y_pred.shape[1]
        chamfers = []
        for b in range(y_pred.shape[0]):
            gt_ids = torch.unique(stroke_ids[b][stroke_ids[b] >= 0])
            total = 0.0
            for i in range(n_pred):
                pred_pc = y_pred[b, i].reshape(1, -1, self.outdim)
                best = np.inf
                for g in gt_ids:
                    gt_pc = traj_pc[b][stroke_ids[b] == g][None]
                    c, _ = chamfer_distance(pred_pc, gt_pc, asymmetric=True)
                    best = min(best, 1e4 * float(c))
                total += best
            chamfers.append(total / n_pred)
        return float(np.mean(chamfers))


def _count_metrics(n_pred: np.ndarray, n_strokes) -> list[float]:
    """% correct, mean predicted, mean GT and mean absolute error of the
    stroke counts."""
    n_gt = _host(n_strokes).astype(int)
    return [float(np.mean(n_gt == n_pred)), float(np.mean(n_pred)),
            float(np.mean(n_gt)), float(np.mean(np.abs(n_pred - n_gt)))]


def _sop_counts(sop_pred, processed_sop_pred, sop_gt, pred_sop_conf_scores,
                threshold):
    """-> (GT tokens a sample, kept tokens a sample, [kept tokens a sample
    at (threshold + 1) / 2, at threshold / 2])."""
    n_gt = np.array([len(unpad_rows(g)) for g in _host(sop_gt)])
    n_pred = np.array([len(p) for p in processed_sop_pred])
    swept = [np.array([len(p) for p in postprocess_sop_predictions(
        _host(sop_pred), _host(pred_sop_conf_scores), thr)])
        for thr in ((threshold + 1) / 2, threshold / 2)]
    return n_gt, n_pred, swept
