"""Labeled datasets and downloads of the port against the JAX package's,
on the CPU, on fixtures the tests write: the same seeded splits, samples,
labels and images (within one uint8 level: the JAX loader resizes through
its native C++ pipeline where it is built, the port through PIL, and the
two round apart), the same PlantVillage reorganisation, and the download path
(``file://`` URLs and local archives only: fetch, verify, unpack,
reorganise, and the errors)."""

import csv
import hashlib
import io
import zipfile
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from stylex_tpu.data import download as jdownload
from stylex_tpu.data import labeled as jlabeled
from stylex_tpu_torch.data import download
from stylex_tpu_torch.data import labeled


def _png(path: Path, rng, size=(40, 48)):
    path.parent.mkdir(parents=True, exist_ok=True)
    Image.fromarray(rng.randint(0, 255, (*size, 3), dtype=np.uint8)).save(path)


def _assert_views_equal(got, want):
    assert len(got) == len(want)
    np.testing.assert_array_equal(got.indices, want.indices)
    np.testing.assert_array_equal(got.labels, want.labels)
    for i in range(len(want)):
        (gi, gl), (wi, wl) = got[i], want[i]
        assert gl == wl and gi.shape == wi.shape
        np.testing.assert_allclose(gi, wi, rtol=0, atol=1 / 255 + 1e-6)


@pytest.mark.parametrize("n", [0, 1, 7, 100, 1001])
def test_seeded_split_matches_jax(n):
    for fractions in ([0.7, 0.15, 0.15], [0.7, 0.2, 0.1], [0.8, 0.1, 0.1]):
        for seed in (0, 42):
            got = labeled.seeded_split(n, fractions, seed)
            want = jlabeled.seeded_split(n, fractions, seed)
            assert [g.tolist() for g in got] == [w.tolist() for w in want]


def test_plant_village_folder_and_splits_match_jax(tmp_path):
    rng = np.random.RandomState(0)
    for cls, count in (("healthy", 5), ("sick", 6)):
        for i in range(count):
            _png(tmp_path / "pv" / cls / f"{i}.png", rng)
    (tmp_path / "pv" / "sick" / "notes.txt").write_text("not an image")
    got = labeled.ImageFolderDataset(str(tmp_path / "pv"), 32)
    want = jlabeled.ImageFolderDataset(str(tmp_path / "pv"), 32)
    assert got.classes == want.classes == ["healthy", "sick"]
    assert [(str(p), c) for p, c in got.samples] == [(str(p), c) for p, c in want.samples]
    for g, w in zip(labeled.plant_village_splits(str(tmp_path / "pv"), 32, 42),
                    jlabeled.plant_village_splits(str(tmp_path / "pv"), 32, 42)):
        _assert_views_equal(g, w)


def test_ffhq_and_celeba_match_jax(tmp_path):
    rng = np.random.RandomState(1)
    ffhq = tmp_path / "ffhq"
    resized = ffhq / "flickrfaceshq-dataset-nvidia-resized-256px" / "resized"
    for i in range(7):
        _png(resized / f"{i:05d}.jpg", rng, (48, 48))
    with open(ffhq / "ffhq_aging_labels.csv", "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["image_number", "gender"])
        for i in range(7):
            w.writerow([i, "male" if i % 3 else "female"])
    for g, w in zip(labeled.FFHQGender(str(ffhq), 32).splits(seed=3),
                    jlabeled.FFHQGender(str(ffhq), 32).splits(seed=3)):
        _assert_views_equal(g, w)

    celeba = tmp_path / "celeba"
    for i in range(6):
        _png(celeba / "img_align_celeba" / "img_align_celeba" / f"{i:06d}.jpg", rng, (44, 36))
    with open(celeba / "list_attr_celeba.csv", "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["image_id", "Male", "Smiling"])
        for i in range(6):
            w.writerow([f"{i:06d}.jpg", 1 if i % 2 else -1, 1 if i < 3 else -1])
    for attr in ("Male", "Smiling"):
        got = labeled.CelebAAttribute(str(celeba), 32, attribute=attr)
        want = jlabeled.CelebAAttribute(str(celeba), 32, attribute=attr)
        for g, w in zip(got.splits(seed=0), want.splits(seed=0)):
            _assert_views_equal(g, w)


def _plant_archive(root: Path):
    rng = np.random.RandomState(2)
    inner = root / "Plant_leave_diseases_dataset_without_augmentation"
    for d in ("Apple___healthy", "Apple___scab", "Tomato___healthy"):
        for i in range(2):
            _png(inner / d / f"im{i}.png", rng, (8, 8))
    return root


def test_prepare_plant_village_matches_jax(tmp_path):
    archive = _plant_archive(tmp_path / "archive")
    got = Path(labeled.prepare_plant_village(str(archive), str(tmp_path / "mine")))
    want = Path(jlabeled.prepare_plant_village(str(archive), str(tmp_path / "theirs")))
    listing = lambda root: sorted(str(p.relative_to(root)) for p in root.rglob("*"))
    assert listing(got) == listing(want) and len(list((got / "healthy").iterdir())) == 4
    for p in got.rglob("*.png"):
        assert p.read_bytes() == (want / p.relative_to(got)).read_bytes()


def _zip_of(archive: Path, path: Path) -> Path:
    with zipfile.ZipFile(path, "w") as z:
        for p in sorted(archive.rglob("*")):
            if p.is_file():
                z.write(p, p.relative_to(archive))
    return path


@pytest.mark.parametrize("package", [download, jdownload])
def test_download_plant_village_from_a_file_url(tmp_path, monkeypatch, package):
    mirror = _zip_of(_plant_archive(tmp_path / "archive"), tmp_path / "mirror.zip")
    art = package.ARTIFACTS["plant_village"]
    monkeypatch.setitem(package.ARTIFACTS, "plant_village", package.Artifact(
        name=art.name, url=mirror.as_uri(), filename=art.filename,
        sha256=hashlib.sha256(mirror.read_bytes()).hexdigest(), unpack=True, post=art.post))
    out = package.download("plant_village", str(tmp_path / "data"), log=lambda s: None)
    assert sorted(p.name for p in out.iterdir()) == ["healthy", "sick"]
    assert len(list((out / "healthy").iterdir())) == 4 and len(list((out / "sick").iterdir())) == 2


def test_download_matches_jax_registry_and_errors(tmp_path, monkeypatch, capsys):
    assert {n: (a.url, a.filename, a.unpack, a.post) for n, a in download.ARTIFACTS.items()} == {
        n: (a.url, a.filename, a.unpack, a.post) for n, a in jdownload.ARTIFACTS.items()}
    src = tmp_path / "src.bin"
    src.write_bytes(b"stylex bytes")
    assert download.fetch_url(src.as_uri(), tmp_path / "o" / "got.bin").read_bytes() == \
        b"stylex bytes"
    with pytest.raises(download.DownloadUnavailable, match="place it at"):
        download.fetch_url((tmp_path / "missing.zip").as_uri(), tmp_path / "x.zip")
    with pytest.raises(KeyError):
        download.download("nope", str(tmp_path))
    mirror = _zip_of(_plant_archive(tmp_path / "archive"), tmp_path / "mirror.zip")
    art = download.ARTIFACTS["plant_village"]
    monkeypatch.setitem(download.ARTIFACTS, "plant_village", download.Artifact(
        name=art.name, url=mirror.as_uri(), filename=art.filename, sha256="0" * 64,
        unpack=True))
    with pytest.raises(RuntimeError, match="sha256 mismatch"):
        download.download("plant_village", str(tmp_path / "d"), log=lambda s: None)
    # an injected fetcher, as an offline mirror would be
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w") as z:
        z.writestr("saved_model.pb", b"stub")
    seen = {}

    def fetch(url, dest):
        seen["url"] = url
        dest.parent.mkdir(parents=True, exist_ok=True)
        dest.write_bytes(buf.getvalue())
        return dest

    out = download.download("google_stylex_ffhq", str(tmp_path / "g"), fetcher=fetch,
                            log=lambda s: None)
    assert seen["url"] == jdownload.ARTIFACTS["google_stylex_ffhq"].url
    assert (out / "saved_model.pb").exists()
    download.main(["--list"])
    assert "plant_village" in capsys.readouterr().out
