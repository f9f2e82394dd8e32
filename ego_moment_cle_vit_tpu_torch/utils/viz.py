"""Visualization suite (matplotlib): the port's copy of
``ego_moment_cle_vit_tpu/utils/viz.py``, numpy only, matplotlib imported
where a figure is drawn.

All functions accept numpy arrays, save to ``save_path`` when given (Agg
backend — headless-safe), and return the figure.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _finish(fig, save_path: Optional[str]):
    if save_path:
        fig.savefig(save_path, dpi=120, bbox_inches="tight")
        _plt().close(fig)
    return fig


def plot_similarity_matrix(
    matrix: np.ndarray,
    title: str = "Similarity Matrix",
    save_path: Optional[str] = None,
):
    """Heatmap of one [N, N] similarity matrix."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(6, 5))
    im = ax.imshow(np.asarray(matrix), cmap="viridis")
    ax.set_title(title)
    ax.set_xlabel("token")
    ax.set_ylabel("token")
    fig.colorbar(im, ax=ax)
    return _finish(fig, save_path)


def plot_graph_weights(
    graph: np.ndarray,
    spatial_size: Optional[int] = None,
    title: str = "Graph Weights",
    save_path: Optional[str] = None,
):
    """4-panel view of one [N, N] relation graph: adjacency heatmap,
    per-token connectivity strength map, center-token attention pattern,
    eigen-spectrum."""
    plt = _plt()
    g = np.asarray(graph)
    n = g.shape[0]
    if spatial_size is None:
        spatial_size = int(round(n**0.5))
    has_spatial = spatial_size * spatial_size == n

    fig, axes = plt.subplots(2, 2, figsize=(11, 9))
    im = axes[0, 0].imshow(g, cmap="viridis")
    axes[0, 0].set_title("adjacency")
    fig.colorbar(im, ax=axes[0, 0])

    strength = g.sum(-1)
    if has_spatial:
        im = axes[0, 1].imshow(
            strength.reshape(spatial_size, spatial_size), cmap="hot"
        )
        axes[0, 1].set_title("connectivity strength")
        fig.colorbar(im, ax=axes[0, 1])
        center = g[(spatial_size // 2) * spatial_size + spatial_size // 2]
        im = axes[1, 0].imshow(
            center.reshape(spatial_size, spatial_size), cmap="hot"
        )
        axes[1, 0].set_title("center-token pattern")
        fig.colorbar(im, ax=axes[1, 0])
    else:
        axes[0, 1].bar(np.arange(n), strength)
        axes[0, 1].set_title("connectivity strength")
        axes[1, 0].plot(g[n // 2])
        axes[1, 0].set_title("center-token weights")

    eigvals = np.linalg.eigvalsh(0.5 * (g + g.T))
    axes[1, 1].plot(np.sort(eigvals)[::-1], "o-", markersize=3)
    axes[1, 1].set_title("eigen spectrum")
    axes[1, 1].set_yscale("symlog")
    fig.suptitle(title)
    return _finish(fig, save_path)


def plot_polynomial_coefficients(
    coeffs: np.ndarray,
    title: str = "GPF Coefficients A_pq",
    save_path: Optional[str] = None,
):
    """Annotated heatmap of the [P+1, Q+1] coefficient matrix."""
    plt = _plt()
    c = np.asarray(coeffs)
    fig, ax = plt.subplots(figsize=(5, 4))
    im = ax.imshow(c, cmap="YlOrRd")
    for (i, j), val in np.ndenumerate(c):
        ax.text(j, i, f"{val:.3f}", ha="center", va="center", fontsize=9)
    ax.set_xlabel("q (positive-view power)")
    ax.set_ylabel("p (anchor-view power)")
    ax.set_title(title)
    fig.colorbar(im, ax=ax)
    return _finish(fig, save_path)


def plot_feature_embeddings(
    features: np.ndarray,
    labels: np.ndarray,
    method: str = "tsne",
    title: str = "Feature Embeddings",
    save_path: Optional[str] = None,
    max_samples: int = 1000,
):
    """2-D t-SNE / PCA scatter colored by class."""
    plt = _plt()
    feats = np.asarray(features)
    labels = np.asarray(labels)
    if feats.shape[0] > max_samples:
        idx = np.random.default_rng(0).choice(
            feats.shape[0], max_samples, replace=False
        )
        feats, labels = feats[idx], labels[idx]

    if method not in ("tsne", "pca"):
        raise ValueError(
            f"Unknown embedding method '{method}' (choose 'tsne' or 'pca')"
        )
    if method == "tsne":
        try:
            from sklearn.manifold import TSNE

            emb = TSNE(
                n_components=2,
                init="pca",
                perplexity=min(30, max(2, feats.shape[0] // 4)),
                random_state=0,
            ).fit_transform(feats)
        except Exception:
            method = "pca"
    if method == "pca":
        centered = feats - feats.mean(0)
        _, _, vt = np.linalg.svd(centered, full_matrices=False)
        emb = centered @ vt[:2].T

    fig, ax = plt.subplots(figsize=(7, 6))
    sc = ax.scatter(emb[:, 0], emb[:, 1], c=labels, cmap="tab20", s=12, alpha=0.8)
    ax.set_title(f"{title} ({method})")
    fig.colorbar(sc, ax=ax, label="class")
    return _finish(fig, save_path)


def plot_training_curves(
    history: Dict[str, Sequence[float]],
    save_path: Optional[str] = None,
):
    """Loss/accuracy curves."""
    plt = _plt()
    fig, axes = plt.subplots(1, 2, figsize=(12, 4.5))
    if history.get("train_loss"):
        axes[0].plot(history["train_loss"], label="train")
    if history.get("val_loss"):
        axes[0].plot(history["val_loss"], label="val")
    axes[0].set_title("loss")
    axes[0].set_xlabel("epoch")
    axes[0].legend()
    if history.get("train_acc"):
        axes[1].plot(history["train_acc"], label="train")
    if history.get("val_acc"):
        axes[1].plot(history["val_acc"], label="val")
    axes[1].set_title("accuracy")
    axes[1].set_xlabel("epoch")
    axes[1].legend()
    return _finish(fig, save_path)


def plot_confusion_matrix(
    labels: np.ndarray,
    predictions: np.ndarray,
    class_names: Optional[Sequence[str]] = None,
    normalize: bool = True,
    save_path: Optional[str] = None,
):
    """Confusion-matrix heatmap."""
    plt = _plt()
    labels = np.asarray(labels)
    predictions = np.asarray(predictions)
    n = (
        len(class_names)
        if class_names is not None
        else int(max(labels.max(), predictions.max())) + 1
    )
    cm = np.zeros((n, n), np.float64)
    np.add.at(cm, (labels, predictions), 1.0)
    if normalize:
        cm = cm / np.maximum(cm.sum(1, keepdims=True), 1)
    fig, ax = plt.subplots(figsize=(8, 7))
    im = ax.imshow(cm, cmap="Blues")
    ax.set_xlabel("predicted")
    ax.set_ylabel("true")
    ax.set_title("Confusion Matrix" + (" (row-normalized)" if normalize else ""))
    fig.colorbar(im, ax=ax)
    if class_names is not None and n <= 30:
        ax.set_xticks(range(n))
        ax.set_xticklabels(class_names, rotation=90, fontsize=6)
        ax.set_yticks(range(n))
        ax.set_yticklabels(class_names, fontsize=6)
    return _finish(fig, save_path)


def visualize_moment_features(
    moment_features: np.ndarray,
    labels: Optional[np.ndarray] = None,
    save_path: Optional[str] = None,
):
    """Distribution + norms + 2-D embedding of moment features."""
    plt = _plt()
    feats = np.asarray(moment_features)
    fig, axes = plt.subplots(1, 3, figsize=(15, 4.5))
    axes[0].hist(feats.ravel(), bins=60)
    axes[0].set_title("value distribution")
    norms = np.linalg.norm(feats, axis=1)
    axes[1].hist(norms, bins=30)
    axes[1].set_title("per-sample L2 norms")
    centered = feats - feats.mean(0)
    _, _, vt = np.linalg.svd(centered, full_matrices=False)
    emb = centered @ vt[:2].T
    c = labels if labels is not None else "steelblue"
    axes[2].scatter(emb[:, 0], emb[:, 1], c=c, cmap="tab20", s=10)
    axes[2].set_title("PCA embedding")
    return _finish(fig, save_path)
