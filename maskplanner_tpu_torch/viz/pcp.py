"""Parallel-coordinates plot for hyperparameter sweeps.

Reference: ``utils/pcp.py`` (a vendored copy of the public gregornickel/
pcp utility, 269 LoC) — mixed categorial/linear/log axes, smooth Bezier
curves colored by the last (objective) column, per-axis scales drawn as
twin y-axes, optional colorbar, CSV loading. Same public surface
(``pcp(data, labels, ...)``, ``load_csv``), reimplemented on matplotlib
from the observed behavior.
"""
from __future__ import annotations

import csv
from typing import Sequence

import numpy as np
import matplotlib

matplotlib.use("Agg")
import matplotlib as mpl  # noqa: E402
import matplotlib.pyplot as plt  # noqa: E402
from matplotlib.patches import PathPatch  # noqa: E402
from matplotlib.path import Path  # noqa: E402


def load_csv(filename):
    """CSV -> (rows, header); numeric cells become int/float (float when
    the token carries a '.' or exponent, reference utils/pcp.py:14-36)."""
    with open(filename, "r", encoding="utf-8") as f:
        raw = list(csv.reader(f))
    header, rows = raw[0], []
    for line in raw[1:]:
        row = []
        for tok in line:
            try:
                row.append(float(tok) if ("." in tok or "e" in tok)
                           else int(tok))
            except ValueError:
                row.append(tok)
        rows.append(row)
    return rows, header


def _auto_types(data, n_cols, ytype, colorbar):
    ytype = list(ytype) if ytype else [[]] * n_cols
    out = []
    for i in range(n_cols):
        t = ytype[i] if i < len(ytype) and ytype[i] else (
            "categorial" if isinstance(data[0][i], str) else "linear")
        out.append(t)
    if colorbar:
        assert out[-1] == "linear", "colorbar axis needs to be linear"
    return out


def _auto_category_labels(data, n_cols, ytypes, ylabels):
    ylabels = list(ylabels) if ylabels else [[]] * n_cols
    out = []
    for i in range(n_cols):
        lab = ylabels[i] if i < len(ylabels) and ylabels[i] else []
        if not lab and ytypes[i] == "categorial":
            lab = sorted({row[i] for row in data})
            if len(lab) == 1:
                lab.append("")
        out.append(lab)
    return out


def _auto_limits(mat, n_cols, ylim, ytypes):
    ylim = list(ylim) if ylim else [[]] * n_cols
    out = []
    for i in range(n_cols):
        lim = list(ylim[i]) if i < len(ylim) and ylim[i] else []
        if not lim:
            lim = [float(mat[i].min()), float(mat[i].max())]
        if lim[0] == lim[1]:
            # constant column (or degenerate caller-supplied limits):
            # widen so downstream divisions stay finite; log axes must
            # widen multiplicatively — an additive pad can push the
            # lower limit nonpositive, poisoning log10 below
            if ytypes[i] == "log" and lim[0] > 0:
                lim = [lim[0] / 1.1, lim[1] * 1.1]
            else:
                pad = max(abs(lim[0]) * 0.05, 0.5)
                lim = [lim[0] - pad, lim[1] + pad]
        out.append(lim)
    return out


def _bezier_path(ys):
    """Smooth left-to-right curve through the per-axis values: cubic
    Bezier segments with control points at the axis x-positions."""
    n = len(ys)
    xs = np.linspace(0, n - 1, 3 * n - 2)
    yv = np.repeat(ys, 3)[1:-1]
    codes = [Path.MOVETO] + [Path.CURVE4] * (len(xs) - 1)
    return Path(list(zip(xs, yv)), codes)


def pcp(data, labels, ytype=None, ylim=None, ylabels=None,
        figsize=(10, 5), rect=(0.125, 0.1, 0.75, 0.8), curves=True,
        alpha=1.0, colorbar=True, colorbar_width=0.02,
        cmap=None):
    """Parallel-coordinates plot (reference utils/pcp.py:135-260).

    ``data``: list of per-run rows (str cells allowed -> categorial
    axes); ``labels``: one per column. Runs are colored by the last
    column (the objective) through ``cmap`` unless ``colorbar=False``.
    Returns the matplotlib Figure.
    """
    cmap = cmap or plt.get_cmap("inferno")
    n_cols = len(labels)
    for row in data:
        assert len(row) == n_cols, (len(row), n_cols)

    ytypes = _auto_types(data, n_cols, ytype, colorbar)
    cat_labels = _auto_category_labels(data, n_cols, ytypes, ylabels)

    # numeric matrix (columns x runs); categorial cells -> label index
    mat = np.empty((n_cols, len(data)), np.float64)
    for i in range(n_cols):
        for j, row in enumerate(data):
            mat[i, j] = (cat_labels[i].index(row[i])
                         if ytypes[i] == "categorial" else float(row[i]))

    lims = _auto_limits(mat, n_cols, ylim, ytypes)
    lo_last, hi_last = lims[-1]
    score = (mat[-1] - lo_last) / (hi_last - lo_last)

    # rescale every secondary axis into the first axis' coordinate frame
    lo0, hi0 = lims[0]
    scaled = mat.copy()
    for i in range(1, n_cols):
        lo, hi = lims[i]
        if ytypes[i] == "log":
            t = (np.log10(mat[i]) - np.log10(lo)) / (np.log10(hi)
                                                     - np.log10(lo))
        else:
            t = (mat[i] - lo) / (hi - lo)
        if ytypes[0] == "log":
            # ax0 renders values through a log transform: invert it so
            # pixel fraction t lands at the right height on ax0
            scaled[i] = lo0 * (hi0 / lo0) ** t
        else:
            scaled[i] = t * (hi0 - lo0) + lo0

    left, bottom, width, height = rect
    fig = plt.figure(figsize=figsize)
    ax0 = fig.add_axes([left, bottom, width, height])
    axes = [ax0] + [ax0.twinx() for _ in range(n_cols - 1)]

    for j in range(scaled.shape[1]):
        color = cmap(score[j]) if colorbar else "blue"
        if curves:
            ax0.add_patch(PathPatch(_bezier_path(scaled[:, j]),
                                    facecolor="None", lw=1.5, alpha=alpha,
                                    edgecolor=color, clip_on=False))
        else:
            ax0.plot(scaled[:, j], color=color, alpha=alpha, clip_on=False)

    ax0.xaxis.tick_top()
    ax0.xaxis.set_ticks_position("none")
    ax0.set_xlim([0, n_cols - 1])
    ax0.set_xticks(range(n_cols))
    ax0.set_xticklabels(labels)

    for i, ax in enumerate(axes):
        ax.spines["left"].set_position(("axes", i / (n_cols - 1)))
        for side in ("top", "right", "bottom"):
            ax.spines[side].set_visible(False)
        ax.yaxis.set_ticks_position("left")
        ax.set_ylim(lims[i])
        if ytypes[i] == "log":
            ax.set_yscale("log")
        if ytypes[i] == "categorial":
            ax.set_yticks(range(len(cat_labels[i])))
        if cat_labels[i]:
            ax.set_yticklabels(cat_labels[i])

    if colorbar:
        bar = fig.add_axes([left + width, bottom, colorbar_width, height])
        norm = mpl.colors.Normalize(vmin=lims[-1][0], vmax=lims[-1][1])
        mpl.colorbar.ColorbarBase(bar, cmap=cmap, norm=norm,
                                  orientation="vertical")
        bar.tick_params(size=0)
        bar.set_yticklabels([])
    return fig


def parallel_coordinates_plot(
    data: Sequence[dict],
    columns: Sequence[str],
    color_by: str | None = None,
    save_path: str | None = None,
    cmap: str = "viridis",
    title: str = "",
):
    """Convenience wrapper: list-of-dicts sweep records -> pcp figure
    (objective column moved last so it drives the coloring)."""
    cols = list(columns)
    if color_by is not None and color_by in cols:
        cols = [c for c in cols if c != color_by] + [color_by]
    rows = [[d[c] for c in cols] for d in data]
    fig = pcp(rows, cols, cmap=plt.get_cmap(cmap),
              colorbar=color_by is not None)
    if title:
        fig.suptitle(title)
    if save_path:
        fig.savefig(save_path, dpi=140)
        plt.close(fig)
        return save_path
    return fig
