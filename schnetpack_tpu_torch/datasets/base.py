"""Shared machinery for benchmark dataset modules (a copy of
``schnetpack_tpu/datasets/base.py``).

The reference's dataset modules (``src/schnetpack/datasets/*``) are
AtomsDataModule subclasses that download raw archives on first use and
convert them into an ASE DB.  The port never downloads: where the raw file
is in ``raw_dir`` it is converted; otherwise an error says what to
download and where to place it.
"""
from __future__ import annotations

import os
from typing import Optional

from ..data.datamodule import AtomsDataModule


class DownloadableDataModule(AtomsDataModule):
    """AtomsDataModule that builds its DB from raw files on first setup."""

    #: human-readable download instructions (per dataset)
    download_url: Optional[str] = None

    def __init__(self, *args, raw_dir: Optional[str] = None, **kwargs):
        super().__init__(*args, **kwargs)
        self.raw_dir = raw_dir or os.path.dirname(os.path.abspath(self.datapath))

    def prepare_data(self) -> None:
        if os.path.exists(self.datapath):
            return
        os.makedirs(os.path.dirname(os.path.abspath(self.datapath)), exist_ok=True)
        self._build_database()

    def setup(self, stage: Optional[str] = None):
        self.prepare_data()
        super().setup(stage)

    # -- helpers ---------------------------------------------------------
    def _fetch(self, url: str, filename: str) -> str:
        """The local path of ``filename`` in ``raw_dir``.  The port does not
        download: a missing file raises, naming the URL to fetch it from
        (the JAX package tries the download first)."""
        local = os.path.join(self.raw_dir, filename)
        if os.path.exists(local):
            return local
        raise RuntimeError(
            f"Raw data file {filename!r} not found in {self.raw_dir}; "
            f"download it from {url} and place it there (the port does "
            "not download)")

    def _build_database(self) -> None:
        raise NotImplementedError
