"""Patch-statistics analysis (own copy of
mobilesuperresolution_tpu/analysis/patch_stats.py, the reference's
run/test.py).

Reads the 4xN arrays that cli/test_vsr_by_patch.py saves ([spatial TV,
temporal TV, PSNR, bilinear PSNR] per patch-frame): the PSNR gain over the
bilinear base against spatial and temporal variation, as scatter plots and
quantile-binned means. Plotting imports matplotlib (headless Agg) only when
called.
"""

import numpy as np


def load_patch_stats(path):
    """The named rows of a saved 4xN array, and the gain PSNR - bilinear."""
    arr = np.load(path)
    if arr.ndim != 2 or arr.shape[0] != 4:
        raise ValueError(f"{path}: expected a (4, N) patch-statistics array, got {arr.shape}")
    return {"space_var": arr[0], "time_var": arr[1], "psnr": arr[2], "bilinear_psnr": arr[3],
            "gain": arr[2] - arr[3]}


def summarize_patch_stats(stats, bins=10):
    """Mean PSNR gain per quantile bin of spatial and of temporal variation
    (NaN for an empty bin), and the overall means."""
    out = {}
    for key in ("space_var", "time_var"):
        v = stats[key]
        edges = np.quantile(v, np.linspace(0, 1, bins + 1))
        idx = np.clip(np.searchsorted(edges, v, side="right") - 1, 0, bins - 1)
        gains = np.asarray([stats["gain"][idx == b].mean() if (idx == b).any() else np.nan for b in range(bins)])
        out[key] = {"bin_edges": edges, "mean_gain": gains}
    out["mean_psnr"] = float(stats["psnr"].mean())
    out["mean_bilinear_psnr"] = float(stats["bilinear_psnr"].mean())
    out["mean_gain"] = float(stats["gain"].mean())
    return out


def plot_patch_stats(stats, out_path):
    """Gain against spatial and temporal variation, and the gain histogram,
    as one figure saved to ``out_path``."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(1, 3, figsize=(15, 4))
    axes[0].scatter(stats["space_var"], stats["gain"], s=2, alpha=0.3)
    axes[0].set_xlabel("spatial total variation")
    axes[0].set_ylabel("PSNR gain vs bilinear (dB)")
    axes[1].scatter(stats["time_var"], stats["gain"], s=2, alpha=0.3)
    axes[1].set_xlabel("temporal variation")
    axes[2].hist(stats["gain"], bins=50)
    axes[2].set_xlabel("PSNR gain (dB)")
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path
