"""Dataset and artifact downloads: the counterpart of
``stylex_tpu.data.download``, with the same registry, fetcher and command.

The reference fetches its inputs from three places: the PlantVillage zip
from Mendeley (reorganised into binary ``healthy/``/``sick/`` folders by
:func:`stylex_tpu_torch.data.labeled.prepare_plant_village`), the FFHQ
256px resize and CelebA from Kaggle, and released checkpoints from Google
Drive and Google Cloud Storage. This module keeps one registry of them, a
standard-library streaming fetcher with resume and SHA-256 verification,
and the unpacking and reorganisation after a download. Kaggle sets need the
``kaggle`` command and its credentials. A machine without network access
gets an error that says where to put the file by hand; the fetcher is
injectable (``fetcher=``), so the unpack, verify and reorganise path runs
on ``file://`` URLs and local archives.

    python -m stylex_tpu_torch.data.download plant_village --out ./data
    python -m stylex_tpu_torch.data.download --list
"""

from __future__ import annotations

import argparse
import hashlib
import shutil
import sys
import urllib.error
import urllib.request
import zipfile
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, Optional, Sequence

__all__ = ["ARTIFACTS", "Artifact", "download", "fetch_url", "main"]


@dataclass(frozen=True)
class Artifact:
    """One downloadable input of the reference workflow."""

    name: str
    url: str                      # http(s)/file URL, or kaggle:<dataset-slug>
    filename: str                 # local name under the destination dir
    sha256: Optional[str] = None  # verified when known (None: size-only log)
    unpack: bool = False          # zip -> extract next to the file
    # post-extraction hook name (wired in download()); e.g. the PlantVillage
    # healthy/sick reorganisation of `plant_village/util.py:13-74`
    post: Optional[str] = None
    notes: str = ""
    aliases: Sequence[str] = field(default_factory=tuple)


# The registry mirrors the notebooks' cells one-to-one. Hashes are left
# None where the reference pins none either (Drive/Kaggle artifacts are
# re-packed per download); the fetcher still logs size + sha256 so a user
# can pin them after the first verified download.
ARTIFACTS: Dict[str, Artifact] = {
    a.name: a
    for a in [
        Artifact(
            name="plant_village",
            url=(
                "https://prod-dcd-datasets-cache-zipfiles.s3.eu-west-1."
                "amazonaws.com/tywbtsjrjv-1.zip"
            ),
            filename="plant_village.zip",
            unpack=True,
            post="prepare_plant_village",
            notes=(
                "Mendeley PlantVillage (no augmentation); reorganised into "
                "binary healthy/sick after extraction "
                "(`plant_village/util.py:13-74`)"
            ),
        ),
        Artifact(
            name="ffhq_256",
            url="kaggle:potatohd404/ffhq-256-for-stylegan",
            filename="ffhq-256-for-stylegan.zip",
            unpack=True,
            notes=(
                "Kaggle 256px FFHQ resize -- pair with ffhq_aging_labels.csv "
                "(`data/Kaggle_FFHQ_Resized_256px/download_dataset.ipynb`)"
            ),
        ),
        Artifact(
            name="celeba",
            url="kaggle:jessicali9530/celeba-dataset",
            filename="celeba-dataset.zip",
            unpack=True,
            notes="img_align_celeba + list_attr_celeba.csv (CelebA notebook)",
        ),
        Artifact(
            name="reference_checkpoints",
            url=(
                "https://drive.google.com/uc?export=download&id="
                "1lTTISGjVpLzwmEjsxgHKfHHpXPHDUm7r"
            ),
            filename="trained_models.zip",
            unpack=True,
            notes=(
                "the released .pt StylEx models "
                "(`drive_download_model_files.ipynb` cell 1) -- needed for "
                "checkpoint-level parity vs BASELINE's plant sindices"
            ),
        ),
        Artifact(
            name="google_stylex_ffhq",
            url=(
                "https://storage.googleapis.com/explaining-in-style/"
                "checkpoints/ffhq_age.zip"
            ),
            filename="google_stylex_ffhq_age.zip",
            unpack=True,
            notes=(
                "Google's published StylEx FFHQ-age SavedModels "
                "(`FID_TensorFlow.ipynb` cell 5) -- feeds "
                "the JAX package's stylex_tpu.ingest_tf.convert_google_generator"
            ),
        ),
    ]
}


class DownloadUnavailable(RuntimeError):
    """Raised when the artifact cannot be fetched from this machine."""


def fetch_url(url: str, dest: Path, chunk: int = 1 << 20) -> Path:
    """Stream ``url`` to ``dest`` (stdlib only), resuming a partial file via
    HTTP Range when the server cooperates. Returns ``dest``."""
    dest.parent.mkdir(parents=True, exist_ok=True)
    tmp = dest.with_suffix(dest.suffix + ".part")
    start = tmp.stat().st_size if tmp.exists() else 0
    req = urllib.request.Request(url)
    if start:
        req.add_header("Range", f"bytes={start}-")
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            mode = "ab" if start and r.status == 206 else "wb"
            with open(tmp, mode) as f:
                while True:
                    buf = r.read(chunk)
                    if not buf:
                        break
                    f.write(buf)
    except (urllib.error.URLError, OSError, TimeoutError) as e:
        raise DownloadUnavailable(
            f"cannot reach {url!r} from this machine ({e}). If this "
            "machine has no network access, download the file elsewhere "
            f"and place it at {dest} — every consumer accepts the local "
            "path directly."
        ) from e
    tmp.replace(dest)
    return dest


def _fetch_kaggle(slug: str, dest: Path) -> Path:
    """Kaggle datasets need authenticated API access (the notebooks used
    ``opendatasets`` which prompts for kaggle.json); shell out to the
    official CLI when installed."""
    kaggle = shutil.which("kaggle")
    if kaggle is None:
        raise DownloadUnavailable(
            f"Kaggle dataset {slug!r} needs the `kaggle` CLI + API token "
            "(~/.kaggle/kaggle.json). Install/authenticate it, or download "
            f"the zip manually and place it at {dest}."
        )
    import subprocess

    dest.parent.mkdir(parents=True, exist_ok=True)
    r = subprocess.run(
        [kaggle, "datasets", "download", "-d", slug, "-p", str(dest.parent)],
        capture_output=True,
        text=True,
    )
    if r.returncode != 0:
        raise DownloadUnavailable(
            f"kaggle CLI failed for {slug!r}: {r.stderr.strip()[-400:]}"
        )
    got = dest.parent / f"{slug.split('/')[-1]}.zip"
    if got != dest and got.exists():
        got.replace(dest)
    return dest


def _sha256(path: Path, chunk: int = 1 << 20) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            buf = f.read(chunk)
            if not buf:
                break
            h.update(buf)
    return h.hexdigest()


def download(
    name: str,
    out_dir: str = "./data",
    fetcher: Optional[Callable[[str, Path], Path]] = None,
    force: bool = False,
    log: Callable[[str], None] = print,
) -> Path:
    """Fetch, verify, unpack and post-process one named artifact.

    Returns the directory/file ready for the downstream consumer (the
    reorganised ``healthy/``/``sick/`` root for PlantVillage, the extraction
    dir for zips, the file itself otherwise). ``fetcher(url, dest)`` is
    injectable for tests and offline mirrors.
    """
    if name not in ARTIFACTS:
        raise KeyError(
            f"unknown artifact {name!r}; available: {sorted(ARTIFACTS)}"
        )
    art = ARTIFACTS[name]
    out = Path(out_dir)
    dest = out / art.filename

    if force or not dest.exists():
        if fetcher is not None:
            fetcher(art.url, dest)
        elif art.url.startswith("kaggle:"):
            _fetch_kaggle(art.url[len("kaggle:"):], dest)
        else:
            fetch_url(art.url, dest)
    digest = _sha256(dest)
    size_mb = dest.stat().st_size / 1e6
    log(f"{art.name}: {dest} ({size_mb:.1f} MB, sha256={digest[:16]}…)")
    if art.sha256 is not None and digest != art.sha256:
        raise RuntimeError(
            f"{art.name}: sha256 mismatch — expected {art.sha256}, got "
            f"{digest}. Delete {dest} and retry."
        )

    result: Path = dest
    if art.unpack and dest.suffix == ".zip":
        extract_dir = out / dest.stem
        if force or not extract_dir.exists():
            with zipfile.ZipFile(dest) as z:
                z.extractall(extract_dir)
        log(f"{art.name}: extracted -> {extract_dir}")
        result = extract_dir

    if art.post == "prepare_plant_village":
        from stylex_tpu_torch.data.labeled import prepare_plant_village

        result = Path(
            prepare_plant_village(str(result), str(out / "plant-village"))
        )
        log(f"{art.name}: reorganised -> {result} (healthy/ + sick/)")
    return result


def main(argv=None) -> None:
    p = argparse.ArgumentParser(
        description="Download the reference workflow's datasets/artifacts"
    )
    p.add_argument("name", nargs="?", help="artifact name (see --list)")
    p.add_argument("--out", default="./data")
    p.add_argument("--force", action="store_true")
    p.add_argument("--list", action="store_true", help="list artifacts")
    args = p.parse_args(argv)
    if args.list or not args.name:
        for a in ARTIFACTS.values():
            print(f"{a.name:24s} {a.url}\n{'':24s} {a.notes}")
        return
    try:
        path = download(args.name, args.out, force=args.force)
    except DownloadUnavailable as e:
        print(f"DOWNLOAD UNAVAILABLE: {e}", file=sys.stderr)
        sys.exit(2)
    print(path)


if __name__ == "__main__":
    main()
