"""Mode and geodataset enums with the dataset factory: the port's copy of
``ddr_tpu/validation/enums.py``."""

from __future__ import annotations

from enum import Enum

__all__ = ["GeoDataset", "Mode"]


class Mode(str, Enum):
    training = "training"
    testing = "testing"
    routing = "routing"


class GeoDataset(str, Enum):
    merit = "merit"
    lynker_hydrofabric = "lynker_hydrofabric"
    synthetic = "synthetic"  # in-memory fixture dataset, no external data needed

    def get_dataset_class(self, cfg, device=None):
        """The dataset ``cfg`` names, on ``device`` (default ``cfg.device``).
        Only the synthetic twin is ported; the store-backed datasets raise."""
        if self is not GeoDataset.synthetic:
            raise NotImplementedError(
                f"geodataset {self.value!r} reads the real-data stores, which the port does not "
                "have yet (ROADMAP A.8); use geodataset=synthetic"
            )
        from ddr_tpu_torch.geodatazoo.synthetic import Synthetic

        return Synthetic(cfg, device=device)
