"""AtomsDataModule: dataset + splits + transforms + loaders.

A copy of ``schnetpack_tpu/data/datamodule.py`` (parity:
``src/schnetpack/data/datamodule.py``): split creation persisted to
``split.npz`` under an inter-process lock, per-split transform wiring,
cached statistics, train/val/test loaders.  Lightning is replaced by plain
``setup()`` + loader factories; the loaders produce fixed-shape padded
batches via a dataset-derived static ``PaddingSpec``.
"""
from __future__ import annotations

import os
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from ..utils.locking import file_lock
from .atoms import ASEAtomsData
from .loader import AtomsLoader, PaddingSpec, static_padding_for_dataset
from .splitting import RandomSplit, SplittingStrategy


class AtomsDataModule:
    def __init__(
        self,
        datapath: str,
        batch_size: int,
        num_train: Optional[float] = None,
        num_val: Optional[float] = None,
        num_test: Optional[float] = None,
        split_file: Optional[str] = "split.npz",
        transforms: Sequence = (),
        train_transforms: Optional[Sequence] = None,
        val_transforms: Optional[Sequence] = None,
        test_transforms: Optional[Sequence] = None,
        splitting: Optional[SplittingStrategy] = None,
        load_properties: Optional[Sequence[str]] = None,
        val_batch_size: Optional[int] = None,
        test_batch_size: Optional[int] = None,
        distance_unit: Optional[str] = None,
        property_units: Optional[Dict[str, str]] = None,
        data_workdir: Optional[str] = None,
        padding: Optional[PaddingSpec] = None,
        dense_layout: bool = False,
        seed: int = 0,
        train_sampler_cls: Optional[str] = None,
        train_sampler_args: Optional[Dict] = None,
    ):
        self.datapath = datapath
        self.batch_size = batch_size
        self.val_batch_size = val_batch_size or batch_size
        self.test_batch_size = test_batch_size or self.val_batch_size
        self.num_train = num_train
        self.num_val = num_val
        self.num_test = num_test
        self.split_file = split_file
        self.splitting = splitting or RandomSplit(seed=seed)
        self.load_properties = load_properties
        self.distance_unit = distance_unit
        self.property_units = property_units
        self.padding = padding
        self.dense_layout = dense_layout
        self.seed = seed
        self.data_workdir = data_workdir
        self.train_sampler_cls = train_sampler_cls
        self.train_sampler_args = dict(train_sampler_args or {})

        self._transforms = list(transforms)
        self._train_transforms = list(train_transforms) if train_transforms is not None else None
        self._val_transforms = list(val_transforms) if val_transforms is not None else None
        self._test_transforms = list(test_transforms) if test_transforms is not None else None

        self.dataset: Optional[ASEAtomsData] = None
        self.train_dataset = None
        self.val_dataset = None
        self.test_dataset = None
        self.train_idx = self.val_idx = self.test_idx = None
        self._stats_cache: Dict = {}
        self._setup_done = False

    # ------------------------------------------------------------------
    @property
    def train_transforms(self):
        return self._train_transforms if self._train_transforms is not None else self._transforms

    @property
    def val_transforms(self):
        return self._val_transforms if self._val_transforms is not None else self._transforms

    @property
    def test_transforms(self):
        return self._test_transforms if self._test_transforms is not None else self._transforms

    # ------------------------------------------------------------------
    def _copy_to_workdir(self) -> str:
        """Copy the dataset to a fast local workdir under a lock
        (parity: datamodule.py:202-236)."""
        import shutil

        name = os.path.basename(self.datapath)
        target = os.path.join(self.data_workdir, name)
        with file_lock(target + ".lock"):
            if not os.path.exists(target) or (
                os.path.getmtime(target) < os.path.getmtime(self.datapath)
            ):
                os.makedirs(self.data_workdir, exist_ok=True)
                shutil.copy2(self.datapath, target)
        return target

    def setup(self, stage: Optional[str] = None):
        if self._setup_done:
            return
        if self.data_workdir:
            self.datapath = self._copy_to_workdir()
        self.dataset = ASEAtomsData(
            self.datapath,
            load_properties=self.load_properties,
            distance_unit=self.distance_unit,
            property_units=self.property_units,
        )
        self._load_or_create_splits()
        self.train_dataset = self.dataset.subset(self.train_idx)
        self.train_dataset.transforms = list(self.train_transforms)
        self.val_dataset = self.dataset.subset(self.val_idx)
        self.val_dataset.transforms = list(self.val_transforms)
        self.test_dataset = self.dataset.subset(self.test_idx)
        self.test_dataset.transforms = list(self.test_transforms)

        # give every transform access to dataset statistics
        for t in set(
            list(self.train_transforms) + list(self.val_transforms) + list(self.test_transforms)
        ):
            if hasattr(t, "datamodule"):
                t.datamodule(self)

        if self.padding is None:
            probe = self.dataset.subset(self.train_idx[: min(len(self.train_idx), 256)])
            probe.transforms = list(self.train_transforms)
            self.padding = static_padding_for_dataset(
                probe,
                max(self.batch_size, self.val_batch_size, self.test_batch_size),
                dense_layout=self.dense_layout,
            )
        self._setup_done = True

    def _load_or_create_splits(self):
        split_path = self.split_file
        if split_path and os.path.dirname(split_path) == "":
            split_path = os.path.join(os.path.dirname(self.datapath) or ".", split_path)
        if split_path and os.path.exists(split_path):
            with np.load(split_path) as f:
                self.train_idx = f["train_idx"].tolist()
                self.val_idx = f["val_idx"].tolist()
                self.test_idx = f["test_idx"].tolist()
            return
        lock_path = (split_path or "split") + ".lock"
        with file_lock(lock_path):
            if split_path and os.path.exists(split_path):
                return self._load_or_create_splits()
            train, val, test = self.splitting.split(
                self.dataset, self.num_train, self.num_val, self.num_test
            )
            self.train_idx, self.val_idx, self.test_idx = (
                train.tolist(), val.tolist(), test.tolist(),
            )
            if split_path:
                np.savez(
                    split_path,
                    train_idx=np.asarray(train),
                    val_idx=np.asarray(val),
                    test_idx=np.asarray(test),
                )

    # ------------------------------------------------------------------
    def get_stats(
        self, property_name: str, divide_by_atoms: bool, remove_atomref: bool
    ) -> Tuple[float, float]:
        key = (property_name, divide_by_atoms, remove_atomref)
        if key in self._stats_cache:
            return self._stats_cache[key]
        from .stats import calculate_stats

        atomref = None
        if remove_atomref:
            atomref = {property_name: self.dataset.atomrefs.get(property_name)}
        stats = calculate_stats(
            self.train_dataset, {property_name: divide_by_atoms}, atomref
        )[property_name]
        self._stats_cache[key] = stats
        return stats

    def get_atomrefs(self, property_name: str):
        return self.dataset.atomrefs.get(property_name)

    # ------------------------------------------------------------------
    def _build_train_sampler(self):
        """Instantiate the configured sampler (e.g. StratifiedSampler;
        parity: reference data/datamodule.py train_sampler_cls and
        configs/data/sampler/stratified_property.yaml)."""
        if not self.train_sampler_cls:
            return None
        from ..config.compose import instantiate
        from ..utils import str2class

        cls = (self.train_sampler_cls
               if not isinstance(self.train_sampler_cls, str)
               else str2class(self.train_sampler_cls))
        args = {k: instantiate(v) if isinstance(v, dict) else v
                for k, v in self.train_sampler_args.items()}
        return cls(self.train_dataset, **args)

    def train_dataloader(self) -> AtomsLoader:
        sampler = self._build_train_sampler()
        return AtomsLoader(
            self.train_dataset, self.batch_size, shuffle=sampler is None,
            padding=self.padding, seed=self.seed, sampler=sampler,
        )

    def val_dataloader(self) -> AtomsLoader:
        return AtomsLoader(
            self.val_dataset, self.val_batch_size, shuffle=False, padding=self.padding
        )

    def test_dataloader(self) -> AtomsLoader:
        return AtomsLoader(
            self.test_dataset, self.test_batch_size, shuffle=False, padding=self.padding
        )
