"""Matplotlib 3D renderers for trajectories and predictions.

Reference behaviors: ``utils/visualize.py:589-910`` (visualize_mesh_traj —
mesh/pc + per-stroke colored segments + orientation arrows) and
``render_results.py:249-350`` (side-by-side GT/pred views, batch grids).
"""
from __future__ import annotations

import numpy as np

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402


def stroke_colors(n: int):
    """Distinct per-stroke colors (reference utils/visualize.py:1170-1203)."""
    cmap = plt.get_cmap("tab20")
    return [cmap(i % 20) for i in range(max(n, 1))]


def _axis_equal(ax, pts):
    lo, hi = pts.min(axis=0), pts.max(axis=0)
    center, radius = (lo + hi) / 2, (hi - lo).max() / 2 + 1e-6
    ax.set_xlim(center[0] - radius, center[0] + radius)
    ax.set_ylim(center[1] - radius, center[1] + radius)
    ax.set_zlim(center[2] - radius, center[2] + radius)


def visualize_traj(ax, traj, stroke_ids=None, with_orientations=False,
                   point_size=2.0, lw=0.6):
    """Scatter/plot per-stroke colored trajectory points on a 3D axis."""
    traj = np.asarray(traj)
    valid = ~np.all(traj[:, :3] == -100.0, axis=-1)
    traj = traj[valid]
    if stroke_ids is None:
        stroke_ids = np.zeros(traj.shape[0])
    else:
        stroke_ids = np.asarray(stroke_ids).reshape(-1)[valid]
    colors = stroke_colors(int(stroke_ids.max()) + 1 if len(stroke_ids) else 1)
    for sid in np.unique(stroke_ids):
        if sid < 0:
            continue
        pts = traj[stroke_ids == sid]
        ax.plot(pts[:, 0], pts[:, 1], pts[:, 2], ".-", ms=point_size,
                lw=lw, color=colors[int(sid) % len(colors)])
        if with_orientations and traj.shape[-1] >= 6:
            step = max(1, len(pts) // 25)
            q = pts[::step]
            ax.quiver(q[:, 0], q[:, 1], q[:, 2], q[:, 3], q[:, 4], q[:, 5],
                      length=0.08, color="gray", lw=0.4)
    if len(traj):
        _axis_equal(ax, traj[:, :3])


def get_mesh_face_colors(vertices, faces, vertices_thickness,
                         normalize_to_max=None, clamp=None):
    """Per-face paint thickness from face-vertex thickness rows (3 per
    face, simulator CSV order) — reference utils/visualize.py:1111-1147.
    """
    vertices_thickness = np.asarray(vertices_thickness, np.float64)
    faces = np.asarray(faces)
    assert vertices_thickness.shape[0] == faces.shape[0] * 3
    colors = vertices_thickness.reshape(-1, 3).mean(axis=1)
    if clamp is not None:
        colors = np.minimum(colors, clamp)
    if normalize_to_max is not None:
        colors = colors / max(colors.max(), 1e-12) * normalize_to_max
    return colors


def visualize_mesh_faces(ax, verts, faces, face_colors=None,
                         cmap="viridis", clim=None,
                         below_threshold=None, below_color="#ececec",
                         color="lightgray", alpha=1.0, lw=0.1):
    """Mesh-surface rendering (triangles, not a point scatter) —
    reference visualize_mesh_traj's pyvista ``add_mesh`` path
    (utils/visualize.py:651-721). With ``face_colors`` the faces are
    colored through ``cmap`` clipped to ``clim``; faces under
    ``below_threshold`` (e.g. the coverage metric's GT percentile
    threshold) render in ``below_color`` like the reference's
    ``below_color='#ececec'`` uncovered-face grey."""
    from mpl_toolkits.mplot3d.art3d import Poly3DCollection

    verts = np.asarray(verts, np.float64)
    faces = np.asarray(faces, np.int64)
    tris = verts[faces]
    if face_colors is None:
        colors = color
    else:
        face_colors = np.asarray(face_colors, np.float64)
        lo, hi = clim if clim is not None else (
            float(face_colors.min()), float(max(face_colors.max(), 1e-12)))
        t = np.clip((face_colors - lo) / max(hi - lo, 1e-12), 0.0, 1.0)
        colors = plt.get_cmap(cmap)(t)
        if below_threshold is not None:
            from matplotlib.colors import to_rgba

            colors[face_colors < below_threshold] = to_rgba(below_color)
    coll = Poly3DCollection(tris, facecolors=colors, edgecolors="k",
                            linewidths=lw, alpha=alpha)
    ax.add_collection3d(coll)
    _axis_equal(ax, verts)
    return coll


def visualize_coverage_mesh(verts, faces, pred_vertices_thickness,
                            gt_vertices_thickness, percentile=10,
                            save_path=None, traj=None, stroke_ids=None,
                            elev=25, azim=45, cmap="viridis"):
    """Side-by-side GT | pred paint-coverage figure: faces colored by
    deposited thickness with the visual clamp at the GT's p-th
    percentile and uncovered faces (under the coverage threshold) in
    grey — the reference's paint_coverage_kwargs rendering
    (utils/visualize.py:654-721) fed by the in-repo spray simulator.
    Returns the coverage fraction of the prediction."""
    gt_fc = get_mesh_face_colors(verts, faces, gt_vertices_thickness)
    pred_fc = get_mesh_face_colors(verts, faces, pred_vertices_thickness)
    nonzero = ~np.isclose(gt_fc, 0.0)
    threshold = np.percentile(gt_fc[nonzero], percentile) if nonzero.any() \
        else 0.0
    clamp = threshold if threshold > 0 else max(gt_fc.max(), 1e-12)
    covered = nonzero & (gt_fc >= threshold)
    cov = (float((pred_fc[covered] >= threshold).sum())
           / max(int(covered.sum()), 1))

    fig = plt.figure(figsize=(11, 5))
    for i, (fc, label) in enumerate(((gt_fc, "GT"), (pred_fc, "pred"))):
        ax = fig.add_subplot(1, 2, i + 1, projection="3d")
        visualize_mesh_faces(ax, verts, faces, face_colors=fc, cmap=cmap,
                             clim=(0.0, clamp), below_threshold=threshold)
        if traj is not None:
            visualize_traj(ax, traj, stroke_ids)
        ax.view_init(elev=elev, azim=azim)
        ax.set_axis_off()
        ax.set_title(f"{label} paint thickness", fontsize=9)
    fig.suptitle(f"coverage: {cov * 100:.1f}% "
                 f"(p{percentile} threshold {threshold:.3g})", fontsize=10)
    if save_path:
        fig.savefig(save_path, dpi=130, bbox_inches="tight")
        plt.close(fig)
    return cov


def visualize_mesh_traj(point_cloud, traj, stroke_ids=None, save_path=None,
                        title=None, with_orientations=False, elev=25,
                        azim=45, mesh=None):
    """Object point cloud + per-stroke colored trajectory -> PNG.

    Pass ``mesh=(verts, faces)`` to render the actual mesh surface
    (reference renders the OBJ mesh; the point scatter is the fallback
    when only the sampled cloud is available)."""
    fig = plt.figure(figsize=(6, 6))
    ax = fig.add_subplot(111, projection="3d")
    if mesh is not None:
        visualize_mesh_faces(ax, mesh[0], mesh[1], alpha=0.35)
    else:
        pc = np.asarray(point_cloud)
        ax.scatter(pc[:, 0], pc[:, 1], pc[:, 2], s=0.3, c="lightgray",
                   alpha=0.5)
    visualize_traj(ax, traj, stroke_ids, with_orientations)
    ax.view_init(elev=elev, azim=azim)
    ax.set_axis_off()
    if title:
        ax.set_title(title, fontsize=9)
    if save_path:
        fig.savefig(save_path, dpi=150, bbox_inches="tight")
        plt.close(fig)
        return save_path
    return fig


def visualize_sample_pred_gt(point_cloud, traj_gt, ids_gt, traj_pred,
                             ids_pred, save_path, title=""):
    """Side-by-side GT | prediction views from multiple cameras
    (reference render_results.py:249-313 uses a 2×4 camera grid)."""
    cams = [(25, 45), (25, 225)]
    fig = plt.figure(figsize=(4 * len(cams), 8))
    pc = np.asarray(point_cloud)
    for col, (elev, azim) in enumerate(cams):
        for row, (traj, ids, label) in enumerate(
                [(traj_gt, ids_gt, "GT"), (traj_pred, ids_pred, "pred")]):
            ax = fig.add_subplot(2, len(cams), row * len(cams) + col + 1,
                                 projection="3d")
            ax.scatter(pc[:, 0], pc[:, 1], pc[:, 2], s=0.3, c="lightgray",
                       alpha=0.5)
            visualize_traj(ax, traj, ids)
            ax.view_init(elev=elev, azim=azim)
            ax.set_axis_off()
            if col == 0:
                ax.set_title(f"{label} {title}", fontsize=8)
    fig.tight_layout()
    fig.savefig(save_path, dpi=130, bbox_inches="tight")
    plt.close(fig)
    return save_path


def visualize_batch_grid(point_clouds, trajs, ids_list, save_path,
                         max_items=8, title=""):
    """Grid of per-sample renders (reference render_results.py:321-350)."""
    n = min(len(trajs), max_items)
    cols = min(4, n)
    rows = -(-n // cols)
    fig = plt.figure(figsize=(3 * cols, 3 * rows))
    for i in range(n):
        ax = fig.add_subplot(rows, cols, i + 1, projection="3d")
        pc = np.asarray(point_clouds[i])
        ax.scatter(pc[:, 0], pc[:, 1], pc[:, 2], s=0.2, c="lightgray",
                   alpha=0.4)
        visualize_traj(ax, trajs[i], ids_list[i])
        ax.view_init(elev=25, azim=45)
        ax.set_axis_off()
    if title:
        fig.suptitle(title, fontsize=10)
    fig.tight_layout()
    fig.savefig(save_path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return save_path


def visualize_mesh_traj_animated(point_cloud, traj, stroke_ids=None,
                                 save_path=None, n_frames=40, elev=25,
                                 azim=45, interval_ms=80):
    """Progressive trajectory-reveal animation over the object
    (reference visualize_mesh_traj_animated, utils/visualize.py:912-1027;
    pyvista movie -> matplotlib animation here). A ``.gif`` save_path
    uses the Pillow writer; a ``.mp4`` save_path matches the reference
    render driver's movie mode (render_results.py:255-275) via OpenCV's
    VideoWriter (this container has no ffmpeg). Returns the Animation.
    """
    from matplotlib import animation

    traj = np.asarray(traj)
    valid = ~np.all(traj[:, :3] == -100.0, axis=-1)
    traj = traj[valid]
    sids = (np.zeros(len(traj)) if stroke_ids is None
            else np.asarray(stroke_ids).reshape(-1)[valid])

    fig = plt.figure(figsize=(5, 5))
    ax = fig.add_subplot(111, projection="3d")
    pc = np.asarray(point_cloud)

    def draw(frame):
        ax.clear()
        ax.scatter(pc[:, 0], pc[:, 1], pc[:, 2], s=0.3, c="lightgray",
                   alpha=0.5)
        upto = max(1, int(len(traj) * (frame + 1) / n_frames))
        visualize_traj(ax, traj[:upto], sids[:upto])
        if len(traj):
            _axis_equal(ax, traj[:, :3])
        ax.view_init(elev=elev, azim=azim)
        ax.set_axis_off()
        return []

    anim = animation.FuncAnimation(fig, draw, frames=n_frames,
                                   interval=interval_ms, blit=False)
    if save_path:
        fps = max(1, 1000 // interval_ms)
        if str(save_path).lower().endswith(".mp4"):
            _write_mp4(fig, draw, n_frames, save_path, fps)
        else:
            anim.save(save_path, writer=animation.PillowWriter(fps=fps))
        plt.close(fig)
    return anim


def _write_mp4(fig, draw, n_frames, save_path, fps):
    """Encode animation frames to H.264-less mp4 (mp4v) with OpenCV —
    matplotlib's FFMpegWriter needs an ffmpeg binary this image lacks."""
    import cv2

    writer = None
    for frame in range(n_frames):
        draw(frame)
        fig.canvas.draw()
        buf = np.asarray(fig.canvas.buffer_rgba())[..., :3]
        if writer is None:
            h, w = buf.shape[:2]
            writer = cv2.VideoWriter(
                str(save_path), cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
            assert writer.isOpened(), f"cv2 VideoWriter failed: {save_path}"
        writer.write(cv2.cvtColor(buf, cv2.COLOR_RGB2BGR))
    if writer is not None:
        writer.release()


def randomize_labels_except_special(labels, rng=None):
    """Random permutation of non-negative label values (keeps padding ids
    intact) — disambiguates adjacent stroke colors across subplot columns
    (reference utils/visualize.py randomize_labels_except_special)."""
    labels = np.asarray(labels)
    rng = rng or np.random.default_rng()
    uniq = np.unique(labels[labels >= 0])
    perm = rng.permutation(len(uniq))
    lut = dict(zip(uniq.tolist(), uniq[perm].tolist()))
    return np.array([lut.get(int(l), int(l)) for l in labels])


def _project_2d(x):
    """2-D embedding of latent vectors: t-SNE when sklearn is available,
    PCA (SVD) otherwise."""
    try:
        from sklearn.manifold import TSNE

        return TSNE(n_components=2, learning_rate="auto", init="random",
                    perplexity=min(3, max(1, x.shape[0] - 1))
                    ).fit_transform(x)
    except Exception:
        x = x - x.mean(axis=0)
        _, _, vt = np.linalg.svd(x, full_matrices=False)
        return x @ vt[:2].T


def visualize_latent_segments(latent_segments, stroke_ids, n_permutations=3,
                              save_path=None, figax=None, row=None, rng=None):
    """Scatter the learned per-segment latents (contrastive clustering
    task) in 2-D, colored by stroke id with color permutations
    (reference utils/visualize.py:1028-1105). latent_segments: (1, N, D);
    stroke_ids: (1, N)."""
    x = np.asarray(latent_segments)[0]
    sids = np.asarray(stroke_ids)[0]
    x = x / (np.linalg.norm(x, axis=1, keepdims=True) + 1e-12)
    if x.shape[1] > 2:
        x = _project_2d(x)

    if figax is None:
        fig, ax = plt.subplots(1, n_permutations,
                               figsize=(4 * n_permutations, 4))
        axes = np.atleast_1d(ax)
    else:
        fig, ax = figax
        axes = ax[row]
    rng = rng or np.random.default_rng(0)
    for k in range(n_permutations):
        colors = randomize_labels_except_special(sids, rng)
        axes[k].scatter(x[:, 0], x[:, 1], s=40, c=colors, alpha=0.6,
                        cmap="Set1", marker="o")
        axes[k].set_title(f"Norm latent segments [color perm {k}]",
                          fontsize=8)
    fig.suptitle(f"# strokes = {len(np.unique(sids[sids >= 0]))}")
    if figax is None and save_path:
        fig.savefig(save_path, dpi=100, bbox_inches="tight")
        plt.close(fig)
    return fig


def visualize_latent_segments_batch(latent_segments, stroke_ids,
                                    save_path=None, batch_size=None,
                                    n_permutations=3):
    """Grid of per-sample latent-segment plots
    (reference utils/visualize.py:1028-1053)."""
    lat = np.asarray(latent_segments)
    B = batch_size or lat.shape[0]
    fig, ax = plt.subplots(B, n_permutations,
                           figsize=(4 * n_permutations, 4 * B),
                           squeeze=False)
    for b in range(B):
        visualize_latent_segments(lat[b:b + 1], stroke_ids[b:b + 1],
                                  n_permutations=n_permutations,
                                  figax=(fig, ax), row=b)
    if save_path:
        fig.savefig(save_path, dpi=100, bbox_inches="tight")
        plt.close(fig)
    return fig


def visualize_pc(ax, pc, color="lightgray", point_size=0.5, alpha=0.6):
    """Scatter an object point cloud on a 3D axis
    (reference utils/visualize.py:459-511)."""
    pc = np.asarray(pc)
    ax.scatter(pc[:, 0], pc[:, 1], pc[:, 2], s=point_size, c=color,
               alpha=alpha)
    if len(pc):
        _axis_equal(ax, pc[:, :3])


def visualize_sops(ax, sops, stroke_ids=None, confidences=None, outdim=6,
                   point_size=30.0):
    """Start-of-path tokens as per-stroke colored markers.

    Reference utils/visualize.py:131-244 (visualize_sops/visualize_sop):
    each token is ``token_length`` concatenated poses; −100 rows are
    padding and skipped; marker opacity follows the SoP confidence when
    given (sigmoid applied to raw logits outside).
    """
    sops = np.asarray(sops)
    n = len(sops)
    colors = stroke_colors(n)
    for i, sop in enumerate(sops):
        tok = np.asarray(sop).reshape(-1)
        if np.all(tok == -100.0):
            continue
        pts = tok.reshape(-1, outdim)[:, :3]
        alpha = 1.0
        if confidences is not None:
            alpha = float(np.clip(confidences[i], 0.05, 1.0))
        cid = int(stroke_ids[i]) if stroke_ids is not None else i
        ax.scatter(pts[:, 0], pts[:, 1], pts[:, 2], s=point_size,
                   color=colors[cid % len(colors)], alpha=alpha,
                   marker="o", edgecolors="black", linewidths=0.4)
        if pts.shape[-1] >= 3 and tok.reshape(-1, outdim).shape[-1] >= 6:
            o = tok.reshape(-1, outdim)[:, 3:6]
            ax.quiver(pts[:, 0], pts[:, 1], pts[:, 2],
                      o[:, 0], o[:, 1], o[:, 2], length=0.1,
                      color="gray", lw=0.5, alpha=alpha)


_BOX_EDGES = [(0, 1), (1, 3), (3, 2), (2, 0), (4, 5), (5, 7), (7, 6),
              (6, 4), (0, 4), (1, 5), (2, 6), (3, 7)]


def visualize_box(ax, box, color="tab:blue", lw=1.0, alpha=0.8):
    """One 3-D bounding box as a wireframe.

    Reference utils/visualize.py:105-128: ``box`` is
    (xmin, xmax, ymin, ymax, zmin, zmax) — the ``get_3dbbox`` output
    order (reference utils/pointcloud.py:552-556); center/size encodings
    convert via ``from_bbox_encoding_to_visual_format``
    (data/pointcloud.py).
    """
    box = np.asarray(box).reshape(-1)[:6]
    mins = box[0::2]
    maxs = box[1::2]
    corners = np.array(
        [[x, y, z] for x in (mins[0], maxs[0]) for y in (mins[1], maxs[1])
         for z in (mins[2], maxs[2])]
    )
    for a, b in _BOX_EDGES:
        seg = corners[[a, b]]
        ax.plot(seg[:, 0], seg[:, 1], seg[:, 2], color=color, lw=lw,
                alpha=alpha)


def visualize_boxes(ax, boxes, colors=None, **kwargs):
    """A set of 3-D boxes; −100 rows are padding and skipped
    (reference utils/visualize.py:92-102)."""
    boxes = np.asarray(boxes)
    cs = colors if colors is not None and len(colors) else stroke_colors(
        len(boxes))
    for i, b in enumerate(boxes):
        if np.all(np.asarray(b) == -100.0):
            continue
        visualize_box(ax, b, color=cs[i % len(cs)], **kwargs)


def visualize_sequence_traj(ax, traj, cmap="viridis", point_size=2.0):
    """Trajectory colored by sequence position (reference
    utils/visualize.py:292-313) — reveals the in-stroke pose ordering."""
    traj = np.asarray(traj)
    valid = ~np.all(traj[:, :3] == -100.0, axis=-1)
    pts = traj[valid][:, :3]
    if not len(pts):
        return
    c = np.linspace(0.0, 1.0, len(pts))
    ax.scatter(pts[:, 0], pts[:, 1], pts[:, 2], c=c, cmap=cmap,
               s=point_size)
    _axis_equal(ax, pts)


def visualize_centroid_traj(ax, traj, lambda_points, outdim=6,
                            stroke_ids=None):
    """λ-segment centroids as a point set (reference
    utils/visualize.py:366-403)."""
    traj = np.asarray(traj)
    valid = ~np.all(traj == -100.0, axis=-1)
    segs = traj[valid].reshape(-1, lambda_points, outdim)
    centroids = segs[..., :3].mean(axis=1)
    ids = (np.asarray(stroke_ids).reshape(-1)[valid]
           if stroke_ids is not None else None)
    visualize_traj(ax, centroids, ids)


def visualize_complete_traj(ax, traj, stroke_ids=None, lw=0.8):
    """Strokes drawn as continuous polylines in index order (reference
    utils/visualize.py:316-363)."""
    visualize_traj(ax, traj, stroke_ids, point_size=0.5, lw=lw)


def visualize_complete_traj_tour(ax, traj, stroke_ids, tour, lw=0.8):
    """Continuous polyline following an explicit segment ordering
    (``tour``), e.g. a beam-search/TSP concat order (reference
    utils/visualize.py:406-456)."""
    traj = np.asarray(traj)
    order = np.asarray(tour).reshape(-1)
    order = order[(order >= 0) & (order < len(traj))]
    pts = traj[order][:, :3]
    pts = pts[~np.all(pts == -100.0, axis=-1)]
    if not len(pts):
        return
    ax.plot(pts[:, 0], pts[:, 1], pts[:, 2], "-", lw=lw, color="tab:red")
    visualize_traj(ax, traj, stroke_ids)


def visualize_mesh_traj_multiangle(point_cloud, traj, stroke_ids=None,
                                   save_path=None, title="", n_views=4,
                                   elev=25):
    """One sample rendered from ``n_views`` azimuths in a row (reference
    utils/visualize.py:526-586)."""
    fig = plt.figure(figsize=(3.2 * n_views, 3.4))
    pc = np.asarray(point_cloud)
    for k in range(n_views):
        ax = fig.add_subplot(1, n_views, k + 1, projection="3d")
        ax.scatter(pc[:, 0], pc[:, 1], pc[:, 2], s=0.3, c="lightgray",
                   alpha=0.5)
        visualize_traj(ax, traj, stroke_ids)
        ax.view_init(elev=elev, azim=45 + 90 * k)
        ax.set_axis_off()
    if title:
        fig.suptitle(title, fontsize=10)
    if save_path:
        fig.savefig(save_path, dpi=130, bbox_inches="tight")
        plt.close(fig)
        return save_path
    return fig
