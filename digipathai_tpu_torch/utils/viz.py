"""Debug visualization helpers.

Parity targets: the reference's ``imshow``/``imsave`` debug utilities
(``reference DigiPathAI/helpers/utils.py:102-163``) used throughout its
loaders for ad-hoc inspection — n-image side-by-side display/saving.
"""

from __future__ import annotations

import numpy as np


def imshow(*images, titles=None, save_path=None):
    """Show (or save) any number of images side by side."""
    import matplotlib

    if save_path:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    n = len(images)
    fig, axes = plt.subplots(1, n, figsize=(4 * n, 4), squeeze=False)
    for i, img in enumerate(images):
        arr = np.asarray(img)
        axes[0][i].imshow(arr, cmap="gray" if arr.ndim == 2 else None)
        axes[0][i].axis("off")
        if titles and i < len(titles):
            axes[0][i].set_title(str(titles[i]))
    fig.tight_layout()
    if save_path:
        fig.savefig(save_path, dpi=120)
        plt.close(fig)
        return save_path
    plt.show()
    return None


def imsave(path, *images, titles=None):
    """Save images side by side to ``path`` (reference ``imsave``)."""
    return imshow(*images, titles=titles, save_path=path)


def overlay_mask(image, mask, alpha: float = 0.5, color=(255, 0, 0)):
    """Blend a binary/probability mask over an RGB image for inspection."""
    img = np.asarray(image, np.float32)
    if img.ndim == 2:
        img = np.stack([img] * 3, -1)
    m = np.asarray(mask, np.float32)
    if m.max() > 1:
        m = m / 255.0
    tint = np.zeros_like(img)
    tint[..., 0], tint[..., 1], tint[..., 2] = color
    out = img * (1 - alpha * m[..., None]) + tint * (alpha * m[..., None])
    return np.clip(out, 0, 255).astype(np.uint8)
