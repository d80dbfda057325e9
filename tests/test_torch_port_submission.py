"""Port vs JAX: the submission writer.

``views_to_rgb_uint8`` must be byte-identical to ``test.py``'s, and
``infer_submission`` (whole-scene and tiled) must write the BMP bytes the
JAX pipeline writes (``test.py``'s recomposition, then
``save_scene_views``) at both NTIRE test geometries. A nearest-neighbour
stand-in model makes the expected SR views exact. The port's own BMP codec
and submission validator (``lfsr_tpu_torch.tools``) must give the JAX
package's bytes and reports on the same views and trees.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from lfsr_tpu.config import Config
from lfsr_tpu.tools import bmp as jbmp
from lfsr_tpu.tools import submission
from lfsr_tpu_torch.tools import bmp as tbmp
from lfsr_tpu_torch.tools import submission as tsubmission
from lfsr_tpu_torch.data.datasets import TestScene
from lfsr_tpu_torch.inference import infer_submission
from lfsr_tpu_torch.ops.color import views_to_rgb_uint8

from _torch_port import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
ANG, S = 5, 4
NTIRE = {"Synth": (125, 125), "Real": (108, 156)}  # LR view (h0, w0)


def _fields(seed, h0, w0, name):
    """TestScene fields of a seeded random 5x5 scene, chroma in [0.25, 0.75]."""
    rng = np.random.default_rng(seed)
    return dict(name=name, dataset="NTIRE",
                lr_y=rng.random((ANG * h0, ANG * w0), dtype=np.float32),
                hr_y=rng.random((ANG * h0 * S, ANG * w0 * S), dtype=np.float32),
                sr_cbcr=0.25 + 0.5 * rng.random((ANG * h0 * S, ANG * w0 * S, 2),
                                                dtype=np.float32))


def _load_test_cli():
    spec = importlib.util.spec_from_file_location("lfsr_test_cli", ROOT / "test.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_views_to_rgb_uint8_is_byte_identical():
    rng = np.random.default_rng(4)
    views = rng.random((ANG, ANG, 12, 20), dtype=np.float32) * 1.2 - 0.1  # clipping too
    cbcr = rng.random((ANG * 12, ANG * 20, 2), dtype=np.float32)
    want = _load_test_cli().views_to_rgb_uint8(views, cbcr, ANG)
    got = views_to_rgb_uint8(views, cbcr, ANG)
    assert got.dtype == want.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


class _Nearest(torch.nn.Module):
    """Stand-in SR model: nearest-neighbour 4x upsampling, [B,H,W,1] in and out."""

    def __init__(self):
        super().__init__()
        self.anchor = torch.nn.Parameter(torch.zeros(1))
        self.calls = []

    def forward(self, x):
        self.calls.append(tuple(x.shape))
        y = torch.nn.functional.interpolate(x.permute(0, 3, 1, 2), scale_factor=S,
                                            mode="nearest")
        return y.permute(0, 2, 3, 1)


@pytest.mark.parametrize("whole", [True, False], ids=["whole", "tiled"])
def test_infer_submission_writes_the_jax_pipelines_bytes(tmp_path, whole):
    cfg = Config(whole_scene_for_test=None if whole else False)
    scenes = {sub: [_fields(20 + 2 * i + (sub == "Real"), *NTIRE[sub], name=f"{sub}_{i}")
                    for i in range(2)] for sub in NTIRE}
    model = _Nearest()
    rep = infer_submission(model, {k: [TestScene(**f) for f in v] for k, v in scenes.items()},
                           cfg, tmp_path / "sub", log=lambda m: None)
    assert sorted(rep.errors) == ["Real: 2 scenes, expected 16", "Synth: 2 scenes, expected 16"]
    assert (tmp_path / "sub.zip").exists()
    if whole:  # one call per geometry, on the padded mosaics
        assert model.calls == [(2, 720, 720, 1), (2, 640, 880, 1)]
    rgb_fn = _load_test_cli().views_to_rgb_uint8
    for sub, fields in scenes.items():
        for f in fields:
            lr = f["lr_y"].reshape(ANG, NTIRE[sub][0], ANG, NTIRE[sub][1]).transpose(0, 2, 1, 3)
            views = lr.repeat(S, axis=2).repeat(S, axis=3)
            submission.save_scene_views(tmp_path / "want" / sub / f["name"],
                                        rgb_fn(views, f["sr_cbcr"], ANG))
            for bmp in sorted((tmp_path / "want" / sub / f["name"]).glob("*.bmp")):
                got = tmp_path / "sub" / sub / f["name"] / bmp.name
                assert got.read_bytes() == bmp.read_bytes(), got


@pytest.mark.parametrize("hw", [(5, 7), (13, 4), (32, 30), (1, 1)])
def test_port_bmp_codec_writes_the_jax_packages_bytes(hw):
    rgb = np.random.default_rng(hw[0] * 100 + hw[1]).integers(0, 256, (*hw, 3), dtype=np.uint8)
    data = tbmp.encode_bmp(rgb)
    assert data == jbmp.encode_bmp(rgb)
    assert tbmp.parse_header(data) == jbmp.parse_header(data)
    np.testing.assert_array_equal(tbmp.decode_bmp(data), rgb)


def _tree(root, save, scenes, dims, dark=None):
    """A {Real, Synth} tree written with ``save``: ``scenes[subset]`` scenes
    of random views at ``dims[subset]`` (W, H); ``dark`` = (subset, scene
    index) gets near-black views."""
    rng = np.random.default_rng(11)
    for sub, n in scenes.items():
        w, h = dims[sub]
        for i in range(n):
            views = rng.integers(30, 220, (ANG, ANG, h, w, 3), dtype=np.uint8)
            if dark == (sub, i):
                views //= 20
            save(root / sub / f"scene{i}", views)


def test_port_validator_reports_what_the_jax_validator_reports(tmp_path):
    scenes, dims = {"Real": 2, "Synth": 3}, {"Real": (12, 8), "Synth": (10, 10)}
    for pkg, tag in ((tsubmission, "port"), (submission, "jax")):
        _tree(tmp_path / tag, pkg.save_scene_views, scenes, dims, dark=("Synth", 1))
    # the two packages wrote the same bytes
    for f in sorted((tmp_path / "jax").rglob("*.bmp")):
        assert (tmp_path / "port" / f.relative_to(tmp_path / "jax")).read_bytes() == f.read_bytes()
    (tmp_path / "port" / "Real" / "scene1" / "View_0_0.bmp").write_bytes(b"BM junk")
    (tmp_path / "jax" / "Real" / "scene1" / "View_0_0.bmp").write_bytes(b"BM junk")
    for expected_dims in ({"Real": (624, 432), "Synth": (500, 500)}, dims):
        reports = []
        for pkg, tag in ((tsubmission, "port"), (submission, "jax")):
            prev = pkg.EXPECTED_DIMS
            pkg.EXPECTED_DIMS = expected_dims
            try:
                target = pkg.pack_submission(tmp_path / tag, tmp_path / f"{tag}.zip")
                reports.append([(r.errors, r.warnings, r.checks, r.ok)
                                for r in (pkg.validate_submission(tmp_path / tag),
                                          pkg.validate_submission(target))])
            finally:
                pkg.EXPECTED_DIMS = prev
        assert reports[0] == reports[1]
        assert not reports[0][0][3] and reports[0][0][0]  # errors found, the same ones
