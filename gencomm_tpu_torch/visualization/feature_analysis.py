"""The feature gap between modalities: t-SNE plots, the RBF MMD and BEV
feature dumps.

Counterpart of ``gencomm_tpu/visualization/feature_analysis.py``.
``mmd_rbf`` is numpy; ``tsne_embed`` imports scikit-learn and the plots
matplotlib when they run, so importing this module needs neither.
"""

from __future__ import annotations

import os
from typing import Dict, Sequence

import numpy as np


def mmd_rbf(x, y, gamma: float | None = None) -> float:
    """The RBF maximum mean discrepancy between feature sets (N, D) and
    (M, D), in fp64; ``gamma`` defaults to 1 / the median squared
    distance."""
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)

    def sq_dists(a, b):
        return ((a ** 2).sum(1)[:, None] + (b ** 2).sum(1)[None]
                - 2 * a @ b.T).clip(0)

    dxx, dyy, dxy = sq_dists(x, x), sq_dists(y, y), sq_dists(x, y)
    if gamma is None:
        med = np.median(np.concatenate([dxx.ravel(), dyy.ravel(),
                                        dxy.ravel()]))
        gamma = 1.0 / max(med, 1e-9)
    kxx = np.exp(-gamma * dxx).mean()
    kyy = np.exp(-gamma * dyy).mean()
    kxy = np.exp(-gamma * dxy).mean()
    return float(kxx + kyy - 2 * kxy)


def sample_domains(features: Dict[str, np.ndarray], max_per_domain: int = 500,
                   seed: int = 0):
    """[(name, (n_i, D) rows)]: each domain's features flattened to rows,
    at most ``max_per_domain`` drawn without replacement (the rows t-SNE
    embeds)."""
    rng = np.random.default_rng(seed)
    out = []
    for name, f in features.items():
        f = np.asarray(f).reshape(-1, np.asarray(f).shape[-1])
        if len(f) > max_per_domain:
            f = f[rng.choice(len(f), max_per_domain, replace=False)]
        out.append((name, f))
    return out


def tsne_embed(features: Dict[str, np.ndarray], max_per_domain: int = 500,
               seed: int = 0) -> Dict[str, np.ndarray]:
    """{domain: (n_i, 2)}: a 2D t-SNE embedding of the domains' rows."""
    from sklearn.manifold import TSNE

    chunks = sample_domains(features, max_per_domain, seed)
    allf = np.concatenate([f for _, f in chunks], axis=0)
    emb = TSNE(n_components=2, random_state=seed,
               perplexity=min(30, max(2, len(allf) // 4))).fit_transform(allf)
    out, i = {}, 0
    for name, f in chunks:
        out[name] = emb[i:i + len(f)]
        i += len(f)
    return out


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_tsne(features: Dict[str, np.ndarray], save_path: str,
              title: str = "modality feature gap") -> str:
    """The t-SNE embedding by domain, the first two domains' MMD in the
    title."""
    plt = _plt()
    emb = tsne_embed(features)
    fig, ax = plt.subplots(figsize=(6, 5))
    for name, pts in emb.items():
        ax.scatter(pts[:, 0], pts[:, 1], s=4, alpha=0.6, label=name)
    keys = list(features)
    if len(keys) >= 2:
        a, b = (np.asarray(features[k]) for k in keys[:2])
        m = mmd_rbf(a.reshape(-1, a.shape[-1]), b.reshape(-1, b.shape[-1]))
        title = f"{title} (MMD {keys[0]}|{keys[1]} = {m:.4f})"
    ax.set_title(title)
    ax.legend(markerscale=3)
    os.makedirs(os.path.dirname(save_path) or ".", exist_ok=True)
    fig.savefig(save_path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return save_path


def bev_feature_image(feature, channels: Sequence[int] | None = None,
                      reduce: str = "mean") -> np.ndarray:
    """(H, W, C) (or (1, H, W, C)) -> the (H, W) image ``save_bev_feature``
    draws: the mean of ``channels``, else the channels' max or mean."""
    f = np.asarray(feature)
    if f.ndim == 4:
        f = f[0]
    if channels is not None:
        return f[..., list(channels)].mean(-1)
    return f.max(-1) if reduce == "max" else f.mean(-1)


def save_bev_feature(feature, save_path: str,
                     channels: Sequence[int] | None = None,
                     reduce: str = "mean") -> str:
    """A BEV feature map as a PNG heat image."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(8, 4))
    ax.imshow(bev_feature_image(feature, channels, reduce), cmap="magma",
              origin="lower")
    ax.axis("off")
    os.makedirs(os.path.dirname(save_path) or ".", exist_ok=True)
    fig.savefig(save_path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return save_path
