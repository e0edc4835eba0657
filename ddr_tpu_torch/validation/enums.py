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
        """The dataset ``cfg`` names; the synthetic twin routes its
        observations on ``device`` (default ``cfg.device``), the store-backed
        datasets hand out host arrays only."""
        if self is GeoDataset.merit:
            from ddr_tpu_torch.geodatazoo.merit import Merit

            return Merit(cfg, device=device)
        if self is GeoDataset.lynker_hydrofabric:
            from ddr_tpu_torch.geodatazoo.lynker import LynkerHydrofabric

            return LynkerHydrofabric(cfg, device=device)
        from ddr_tpu_torch.geodatazoo.synthetic import Synthetic

        return Synthetic(cfg, device=device)
