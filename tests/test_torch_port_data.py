"""Port vs JAX: the data loaders, through the ``.npz`` export.

``.h5`` files are written in ``generate.py``'s transposed (MATLAB
column-major) layout, as tests/test_e2e.py writes them: training items of
two datasets and test scenes of three (one without chroma), with stems
whose sort order depends on the ``.h5`` suffix. ``scripts/export_npz.py``
exports them; the port's loaders must return the JAX loaders' arrays bit
for bit (no tolerance), with the same datasets, scene names and order, the
same chroma fallback, ``data_name`` filter, RE tag and
``FileNotFoundError`` on an empty training tree; the training export
reads one item at a time.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest

from lfsr_tpu.data import datasets as jdata
from lfsr_tpu.data.generate import _write_h5
from lfsr_tpu_torch.data import datasets as tdata

from _torch_port import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
ANG, S = 5, 4
# stems whose order as .h5 names ("b.h5" < "b.k.h5") differs from their
# order as .npz names ("b.k.npz" < "b.npz")
STEMS = ["000002", "000010", "b", "b.k", "a_1"]


def _exporter():
    spec = importlib.util.spec_from_file_location("export_npz", ROOT / "scripts" / "export_npz.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _export(kind, src, dst, *flags):
    assert _exporter().main([kind, str(src), str(dst), *flags]) == 0


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """(h5 root, npz root) of a training and a test tree, SR and RE."""
    rng = np.random.default_rng(5)
    base = tmp_path_factory.mktemp("data")
    h5, npz = base / "h5", base / "npz"
    for tag, h in (("SR_5x5_4x", 8), ("RE_2x2_5x5", 6)):
        for ds in ("SetB", "SetA"):
            for stem in STEMS:
                lr = rng.random((ANG * h, ANG * h), dtype=np.float32)
                hr = rng.random((ANG * h * S, ANG * h * S), dtype=np.float32)
                _write_h5(h5 / "train" / tag / ds / f"{stem}.h5", Lr_SAI_y=lr, Hr_SAI_y=hr)
        for ds, (hh, ww) in (("Synth", (8, 8)), ("Real", (6, 10)), ("EPFL", (7, 5))):
            for stem in STEMS[:3]:
                arrays = dict(Lr_SAI_y=rng.random((ANG * hh, ANG * ww), dtype=np.float32),
                              Hr_SAI_y=rng.random((ANG * hh * S, ANG * ww * S), dtype=np.float32))
                if ds != "EPFL":  # EPFL's scenes have no chroma: the zeros fallback
                    arrays["Sr_SAI_cbcr"] = rng.random((ANG * hh * S, ANG * ww * S, 2),
                                                       dtype=np.float32)
                _write_h5(h5 / "test" / tag / ds / f"{stem}.h5", **arrays)
    (h5 / "train" / "SR_5x5_4x" / "SetA" / "notes.txt").write_text("not an item")
    for kind in ("train", "test"):
        _export(kind, h5 / kind, npz / kind)
        _export(kind, h5 / kind, npz / kind, "--task", "RE", "--angRes", "2", "--angRes_out", "5")
    return h5, npz


CASES = [((ANG, S, "ALL", None)), ((ANG, S, "SetB", None)), ((2, S, "ALL", "RE_2x2_5x5"))]
IDS = ["SR-all", "SR-one-set", "RE-tag"]


@pytest.mark.parametrize("args", CASES, ids=IDS)
def test_train_set_equals_the_jax_loaders(trees, args):
    h5, npz = trees
    want = jdata.load_train_set(str(h5 / "train"), *args[:3], tag=args[3])
    got = tdata.load_train_set(str(npz / "train"), *args[:3], tag=args[3])
    for a, b in ((got.lr, want.lr), (got.hr, want.hr)):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    jfiles = jdata.list_train_files(str(h5 / "train"), *args[:3], tag=args[3])
    tfiles = tdata.list_train_files(str(npz / "train"), *args[:3], tag=args[3])
    assert [f.relative_to(npz / "train").with_suffix("") for f in tfiles] == [
        f.relative_to(h5 / "train").with_suffix("") for f in jfiles]
    assert len(got) == len(tfiles) > 0


def test_train_export_holds_one_item_at_a_time(trees, tmp_path, monkeypatch):
    h5, _ = trees
    real, sizes = jdata.load_train_set, []

    def counted(*args, **kwargs):
        out = real(*args, **kwargs)
        sizes.append(len(out))
        return out

    monkeypatch.setattr(jdata, "load_train_set", counted)
    _export("train", h5 / "train", tmp_path)
    assert sizes == [1] * len(jdata.list_train_files(str(h5 / "train"), ANG, S))
    want, got = real(str(h5 / "train"), ANG, S), tdata.load_train_set(str(tmp_path), ANG, S)
    np.testing.assert_array_equal(got.lr, want.lr)
    np.testing.assert_array_equal(got.hr, want.hr)
    assert [p.name for p in tmp_path.iterdir()] == ["SR_5x5_4x"]  # no scratch tree left


@pytest.mark.parametrize("args", [(ANG, S, "ALL", None), (ANG, S, "EPFL", None),
                                  (2, S, "ALL", "RE_2x2_5x5")], ids=IDS)
def test_test_scenes_equal_the_jax_loaders(trees, args):
    h5, npz = trees
    want = jdata.load_test_scenes(str(h5 / "test"), *args[:3], tag=args[3])
    got = tdata.load_test_scenes(str(npz / "test"), *args[:3], tag=args[3])
    assert list(got) == list(want)
    for ds in want:
        assert [sc.name for sc in got[ds]] == [sc.name for sc in want[ds]]
        for a, b in zip(got[ds], want[ds]):
            assert a.dataset == b.dataset == ds
            for field in ("lr_y", "hr_y", "sr_cbcr"):
                x, y = getattr(a, field), getattr(b, field)
                assert x.dtype == y.dtype == np.float32, field
                np.testing.assert_array_equal(x, y, err_msg=f"{ds}/{a.name} {field}")
    if "EPFL" in want:
        assert not got["EPFL"][0].sr_cbcr.any()  # the zeros fallback


def test_empty_training_tree_raises_and_missing_sets_are_skipped(tmp_path):
    (tmp_path / "SR_5x5_4x" / "Empty").mkdir(parents=True)
    for mod in (tdata, jdata):
        with pytest.raises(FileNotFoundError):
            mod.load_train_set(str(tmp_path), ANG, S)
        assert mod.load_test_scenes(str(tmp_path), ANG, S) == {}
        assert mod.load_test_scenes(str(tmp_path), ANG, S, data_name="Missing") == {}
