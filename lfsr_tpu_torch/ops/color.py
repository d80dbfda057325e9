"""BT.601 YCbCr -> RGB for the submission views (numpy, float64).

Port of lfsr_tpu/ops/color.py::ycbcr2rgb and test.py::views_to_rgb_uint8,
with the same constants and the same order of operations, so the bytes
written are the JAX package's. (Importing ``lfsr_tpu.ops.color`` would run
``lfsr_tpu/ops/__init__.py``, which imports jax.)
"""

from __future__ import annotations

import numpy as np

_FWD = np.array(
    [
        [65.481, 128.553, 24.966],
        [-37.797, -74.203, 112.0],
        [112.0, -93.786, -18.214],
    ],
    dtype=np.float64,
)
_OFFSET = np.array([16.0, 128.0, 128.0], dtype=np.float64)
_INV = np.linalg.inv(_FWD) * 255.0
_INV_OFFSET = np.linalg.inv(_FWD) @ _OFFSET


def ycbcr2rgb(ycbcr: np.ndarray) -> np.ndarray:
    """[..., 3] YCbCr in [0,1] -> [..., 3] RGB in [0,1] (BT.601 inverse),
    as elementwise products (not a matmul)."""
    y, cb, cr = ycbcr[..., 0], ycbcr[..., 1], ycbcr[..., 2]
    return np.stack([
        float(_INV[i][0]) * y + float(_INV[i][1]) * cb + float(_INV[i][2]) * cr
        - float(_INV_OFFSET[i])
        for i in range(3)
    ], axis=-1)


def views_to_rgb_uint8(sr_views: np.ndarray, sr_cbcr: np.ndarray, ang: int) -> np.ndarray:
    """Recompose RGB per view: sr_views [U, V, h, w] Y, sr_cbcr the SAI
    chroma [A*h, A*w, 2] -> [U, V, h, w, 3] uint8. Truncates (not rounds),
    as the reference does."""
    h, w = sr_views.shape[2:]
    cb = sr_cbcr.reshape(ang, h, ang, w, 2).transpose(0, 2, 1, 3, 4)
    ycc = np.concatenate([np.asarray(sr_views)[..., None], cb], axis=-1)
    rgb = np.clip(ycbcr2rgb(ycc.astype(np.float64)), 0, 1)
    return (rgb * 255).astype(np.uint8)
