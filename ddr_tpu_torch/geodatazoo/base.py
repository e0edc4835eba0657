"""The store-backed geodatasets' shared machinery: the port's copy of
``ddr_tpu/geodatazoo/base.py``.

In training mode a dataset iterates gauge ids, and ``collate_fn`` draws a
fresh ``rho``-day window and builds the union of the batch's gauge subsets,
compressed to the reaches it touches. In the inference modes it iterates
days and hands out one prebuilt full-window :class:`RoutingData` with the
batch's window: upstream of the target catchments, over the gauges, or over
every segment, in that order of priority. The concrete datasets supply only
their id conventions and flowpath arrays. Everything is host numpy.
"""

from __future__ import annotations

import dataclasses
import logging
from abc import ABC, abstractmethod
from pathlib import Path
from typing import Any

import numpy as np
from scipy import sparse

from ddr_tpu_torch.geodatazoo.dataclasses import Dates, RoutingData
from ddr_tpu_torch.io import zarrlite
from ddr_tpu_torch.io.builders import (
    construct_network_matrix,
    create_hydrofabric_observations,
    upstream_closure,
)
from ddr_tpu_torch.io.readers import (
    USGSObservationReader,
    build_flow_scale_tensor,
    fill_nans,
    filter_gages_by_area_threshold,
    filter_gages_by_da_valid,
    filter_headwater_gages,
    naninfmean,
    read_zarr,
)
from ddr_tpu_torch.io.statistics import set_statistics
from ddr_tpu_torch.io.stores import AttributeStore, open_attribute_store
from ddr_tpu_torch.validation.enums import Mode

log = logging.getLogger(__name__)

__all__ = ["BaseGeoDataset"]


class BaseGeoDataset(ABC):
    """The dataset protocol of the store-backed geodatasets (see the module
    docstring). ``device`` is accepted for the factory's sake: a dataset
    hands out host arrays only."""

    #: names of the flowpath arrays of the conus adjacency store, by
    #: RoutingData field; None means the dataset does not store the field.
    flowpath_vars: dict[str, str | None] = {
        "length": "length_m",
        "slope": "slope",
        "top_width": None,
        "side_slope": None,
        "x": None,
    }
    #: the constant Muskingum x when the store has none
    default_x: float = 0.3
    #: honour the gauge CSV's DA_VALID column
    use_da_valid: bool = True

    @abstractmethod
    def _attribute_key(self, divide_id: Any) -> Any:
        """A divide id's key in the attribute store."""

    @abstractmethod
    def _make_divide_ids(self, order_ids: np.ndarray) -> np.ndarray:
        """The dataset's divide ids for a compressed slice of ``order``."""

    def _validate_outflow(
        self,
        coo: sparse.coo_matrix,
        gage_idx: list,
        gage_catchment: list,
        outflow_idx: list[np.ndarray],
        active_indices: np.ndarray,
    ) -> None:
        """A dataset's own consistency check of a gauge union (none by default)."""

    # -- construction -----------------------------------------------------------

    def __init__(self, cfg: Any, device: Any = None) -> None:
        self.cfg = cfg
        self.dates = Dates(
            start_time=cfg.experiment.start_time,
            end_time=cfg.experiment.end_time,
            rho=cfg.experiment.rho,
        )
        self.gage_ids: np.ndarray | None = None
        self.routing_data: RoutingData | None = None
        self.observations: Any = None
        self.gages_adjacency: zarrlite.ZarrGroup | None = None
        self.obs_reader: USGSObservationReader | None = None
        self.target_catchments: list[str] | None = None
        self._rng = np.random.default_rng(cfg.np_seed)

        # attributes and their normalization statistics
        self.attr_store: AttributeStore = self._load_attributes()
        self.attr_stats = set_statistics(cfg, self.attr_store.as_mapping())
        self.attributes_list = list(cfg.kan.input_var_names)
        self.attr_matrix = self.attr_store.matrix(self.attributes_list)  # (A, n_store)
        self.means = np.asarray(
            [self.attr_stats[name]["mean"] for name in self.attributes_list], dtype=np.float32
        )[:, None]
        self.stds = np.asarray(
            [self.attr_stats[name]["std"] for name in self.attributes_list], dtype=np.float32
        )[:, None]

        # the conus adjacency and its flowpath property arrays
        self.conus_adjacency = read_zarr(Path(cfg.data_sources.conus_adjacency))
        self.order_ids = np.asarray(self.conus_adjacency["order"].read())
        self.flowpath_arrays: dict[str, np.ndarray | None] = {}
        self.phys_means: dict[str, float] = {}
        for field, var in self.flowpath_vars.items():
            if var is None:
                self.flowpath_arrays[field] = None
            else:
                arr = np.asarray(self.conus_adjacency[var].read())
                self.flowpath_arrays[field] = arr
                if np.issubdtype(arr.dtype, np.number):
                    self.phys_means[field] = float(naninfmean(arr.astype(np.float64)))

        if cfg.mode == Mode.training:
            self._init_training()
        else:
            self._init_inference()

    def _load_attributes(self) -> AttributeStore:
        return open_attribute_store(self.cfg.data_sources.attributes)

    # -- batching contract ------------------------------------------------------

    def __len__(self) -> int:
        if self.cfg.mode == Mode.training:
            assert self.gage_ids is not None, "No gage IDs found, cannot batch"
            return len(self.gage_ids)
        return len(self.dates.daily_time_range)

    def __getitem__(self, idx: int) -> str | int:
        if self.cfg.mode == Mode.training:
            assert self.gage_ids is not None, "No gage IDs found, cannot batch"
            return str(self.gage_ids[idx])
        return idx

    def collate_fn(self, batch: list) -> RoutingData:
        """One batch, carrying a SNAPSHOT of its window (``Dates.snapshot``),
        never the dataset's shared Dates: collating batch k+1 must not move
        batch k's window while it is prepared or trained on."""
        if self.cfg.mode == Mode.training:
            self.dates.calculate_time_period(self._rng)
            rd = self._collate_gages(np.asarray(batch))
            return dataclasses.replace(rd, dates=self.dates.snapshot())
        assert self.routing_data is not None, "No RoutingData, cannot batch"
        indices = list(batch)
        if 0 not in indices:
            indices.insert(0, indices[0] - 1)  # the previous day keeps chunks continuous
        self.dates.set_date_range(np.asarray(indices))
        return dataclasses.replace(self.routing_data, dates=self.dates.snapshot())

    # -- mode initialization ----------------------------------------------------

    def _filtered_gage_ids(self) -> np.ndarray:
        """The observation reader and the gauge filters: DA_VALID when the
        CSV has it, else the area threshold, then the headwater gauges out."""
        cfg = self.cfg
        if cfg.data_sources.gages is None or cfg.data_sources.gages_adjacency is None:
            raise ValueError("Training requires gages and gages_adjacency to be defined")
        self.obs_reader = USGSObservationReader(cfg=cfg)
        self.observations = self.obs_reader.read_data(dates=self.dates)
        gage_dict = self.obs_reader.gage_dict
        gage_ids = np.array([str(_id).zfill(8) for _id in gage_dict["STAID"]])
        if self.use_da_valid and "DA_VALID" in gage_dict:
            gage_ids, n_removed = filter_gages_by_da_valid(gage_ids, gage_dict)
            log.info(f"Filtered {n_removed}/{len(gage_dict['STAID'])} gages with DA_VALID=False")
        elif cfg.experiment.max_area_diff_sqkm is not None:
            if self.use_da_valid:
                log.warning("DA_VALID not found in gage CSV, falling back to max_area_diff_sqkm")
            gage_ids, n_removed = filter_gages_by_area_threshold(
                gage_ids, gage_dict, cfg.experiment.max_area_diff_sqkm
            )
            log.info(
                f"Filtered {n_removed}/{len(gage_dict['STAID'])} gages exceeding area diff "
                f"threshold of {cfg.experiment.max_area_diff_sqkm} km²"
            )
        self.gages_adjacency = read_zarr(Path(cfg.data_sources.gages_adjacency))
        gage_ids, n_headwater = filter_headwater_gages(gage_ids, self.gages_adjacency)
        log.info(f"Filtered {n_headwater} headwater gages with no upstream connectivity")
        return gage_ids

    def _init_training(self) -> None:
        self.gage_ids = self._filtered_gage_ids()
        log.info(f"Training mode: routing for {len(self.gage_ids)} gauged locations")

    def _init_inference(self) -> None:
        """Target catchments, else gauges, else all segments."""
        cfg = self.cfg
        if cfg.data_sources.target_catchments is not None:
            self.target_catchments = cfg.data_sources.target_catchments
            log.info(f"Target catchments mode: routing upstream of {self.target_catchments}")
            self.routing_data = self._build_routing_data_target_catchments()
        elif cfg.data_sources.gages is not None and cfg.data_sources.gages_adjacency is not None:
            self.gage_ids = self._filtered_gage_ids()
            log.info(f"Gages mode: {len(self.gage_ids)} gauged locations")
            self.routing_data = self._build_routing_data_gages()
        else:
            log.info("All segments mode")
            self.routing_data = self._build_routing_data_all_catchments()

    # -- shared assembly --------------------------------------------------------

    def _compress(
        self, coo: sparse.coo_matrix, gage_idx: list, compute_outflow: bool = True
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, list[np.ndarray], list[int]]:
        """Compress a conus-indexed COO union to a dense index space:
        ``(active_indices, rows_c, cols_c, remap, outflow_idx,
        gage_compressed)``, reindexed through one ``(n_conus,)`` lookup array."""
        n_conus = len(self.order_ids)
        edge_indices = (
            np.unique(np.concatenate([coo.row, coo.col]))
            if coo.nnz > 0
            else np.array([], dtype=np.int64)
        )
        gage_indices = np.asarray(gage_idx, dtype=np.int64)
        active = np.unique(np.concatenate([edge_indices, gage_indices])).astype(np.int64)
        remap = np.full(n_conus, -1, dtype=np.int64)
        remap[active] = np.arange(len(active))

        rows_c = remap[coo.row] if coo.nnz > 0 else np.array([], dtype=np.int64)
        cols_c = remap[coo.col] if coo.nnz > 0 else np.array([], dtype=np.int64)

        outflow_idx: list[np.ndarray] = []
        if compute_outflow:
            for _idx in gage_idx:
                cols = (
                    coo.col[np.isin(coo.row, _idx)] if coo.nnz > 0 else np.array([], dtype=int)
                )
                if len(cols) > 0:
                    outflow_idx.append(remap[cols])
                else:
                    # a headwater gauge: its own inflow is the prediction
                    outflow_idx.append(np.array([remap[int(_idx)]]))
        gage_compressed = [int(remap[int(i)]) for i in gage_idx] if compute_outflow else []
        return active, rows_c, cols_c, remap, outflow_idx, gage_compressed

    def _get_attributes(self, catchment_ids: np.ndarray) -> np.ndarray:
        """Raw attributes ``(A, N)``; ids the store lacks get the store means."""
        valid_rows, mask_pos = [], []
        for i, divide_id in enumerate(catchment_ids):
            row = self.attr_store.id_to_index.get(self._attribute_key(divide_id))
            if row is not None:
                valid_rows.append(row)
                mask_pos.append(i)
            else:
                log.debug(f"{divide_id} missing from the loaded attributes")
        assert valid_rows, "No valid divide IDs found in this batch"
        out = np.full((len(self.attributes_list), len(catchment_ids)), np.nan, dtype=np.float32)
        out[:, mask_pos] = self.attr_matrix[:, valid_rows]
        return fill_nans(out, row_means=self.means).astype(np.float32)

    def _build_common_arrays(
        self, catchment_ids: np.ndarray, active_indices: np.ndarray
    ) -> tuple[np.ndarray, np.ndarray, dict[str, np.ndarray | None]]:
        """Attributes, raw and z-scored (transposed), and the flowpath slices."""
        spatial = self._get_attributes(catchment_ids)
        row_means = np.nanmean(spatial, axis=1, keepdims=True)
        spatial = np.where(np.isnan(spatial), row_means, spatial).astype(np.float32)
        normalized = ((spatial - self.means) / self.stds).T.astype(np.float32)

        flow: dict[str, np.ndarray | None] = {}
        for field, arr in self.flowpath_arrays.items():
            if field == "x" and arr is None:
                flow["x"] = np.full(len(active_indices), self.default_x, dtype=np.float32)
            elif arr is None:
                flow[field] = None
            elif not np.issubdtype(arr.dtype, np.number):
                flow[field] = arr[active_indices]  # e.g. toid strings, carried raw
            else:
                flow[field] = fill_nans(
                    arr[active_indices].astype(np.float32),
                    row_means=np.float32(self.phys_means[field]),
                ).astype(np.float32)
        return spatial, normalized, flow

    def _assemble(
        self,
        rows_c: np.ndarray,
        cols_c: np.ndarray,
        n: int,
        active_indices: np.ndarray,
        outflow_idx: list[np.ndarray] | None,
        gage_catchment: list | None,
        observations: Any,
        flow_scale: np.ndarray | None,
    ) -> RoutingData:
        divide_ids = self._make_divide_ids(self.order_ids[active_indices])
        spatial, normalized, flow = self._build_common_arrays(divide_ids, active_indices)
        log.info(f"Created adjacency matrix of shape: ({n}, {n})")
        return RoutingData(
            n_segments=n,
            adjacency_rows=rows_c,
            adjacency_cols=cols_c,
            spatial_attributes=spatial,
            normalized_spatial_attributes=normalized,
            length=flow["length"],
            slope=flow["slope"],
            top_width=flow.get("top_width"),
            side_slope=flow.get("side_slope"),
            x=flow["x"],
            dates=self.dates,
            observations=observations,
            divide_ids=divide_ids,
            outflow_idx=outflow_idx,
            gage_catchment=gage_catchment,
            flow_scale=flow_scale,
        )

    def _build_gage_union(self, batch: list) -> RoutingData:
        """The union of ``batch``'s gauge subgraphs as one compressed
        RoutingData (training batches and gauges-mode inference)."""
        assert self.gages_adjacency is not None and self.obs_reader is not None
        coo, gage_idx, gage_catchment = construct_network_matrix(batch, self.gages_adjacency)
        active, rows_c, cols_c, _, outflow_idx, gage_compressed = self._compress(coo, gage_idx)
        self._validate_outflow(coo, gage_idx, gage_catchment, outflow_idx, active)
        flow_scale = build_flow_scale_tensor(
            batch=batch,
            gage_dict=self.obs_reader.gage_dict,
            gage_compressed_indices=gage_compressed,
            num_segments=len(active),
        )
        observations = create_hydrofabric_observations(
            dates=self.dates, gage_ids=np.asarray(batch), observations=self.observations
        )
        return self._assemble(
            rows_c, cols_c, len(active), active, outflow_idx, gage_catchment, observations,
            flow_scale,
        )

    def _collate_gages(self, batch: np.ndarray) -> RoutingData:
        assert self.gages_adjacency is not None
        valid = np.isin(batch, [k for k in self.gages_adjacency.keys()])
        return self._build_gage_union(batch[valid].tolist())

    def _build_routing_data_gages(self) -> RoutingData:
        assert self.gage_ids is not None and self.gages_adjacency is not None
        valid = np.isin(self.gage_ids, [k for k in self.gages_adjacency.keys()])
        return self._build_gage_union(self.gage_ids[valid].tolist())

    def _build_routing_data_target_catchments(self) -> RoutingData:
        """The upstream closure of the target catchments, every reach an output."""
        assert self.target_catchments is not None
        rows = np.asarray(self.conus_adjacency["indices_0"].read())
        cols = np.asarray(self.conus_adjacency["indices_1"].read())
        n_conus = len(self.order_ids)

        id_pos = {self._target_key(v): i for i, v in enumerate(self.order_ids)}
        targets = []
        for target in self.target_catchments:
            key = self._target_key(target)
            assert key in id_pos, f"{target} not found in graph"
            targets.append(id_pos[key])
        closure = upstream_closure(rows, cols, n_conus, np.asarray(targets))
        in_closure = np.zeros(n_conus, dtype=bool)
        in_closure[closure] = True
        mask = in_closure[rows] & in_closure[cols]
        coo = sparse.coo_matrix(
            (np.ones(int(mask.sum())), (rows[mask], cols[mask])), shape=(n_conus, n_conus)
        )
        active, rows_c, cols_c, _, _, _ = self._compress(
            coo, list(closure), compute_outflow=False
        )
        outflow_idx = [np.array([i]) for i in range(len(active))]
        return self._assemble(
            rows_c, cols_c, len(active), active, outflow_idx, None, None, None
        )

    def _target_key(self, value: Any) -> Any:
        """A target-catchment id or an ``order`` entry as a comparable key."""
        s = str(value)
        return int(float(s.split("-")[1])) if "-" in s else int(float(s))

    def _build_routing_data_all_catchments(self) -> RoutingData:
        """The full-domain network."""
        rows = np.asarray(self.conus_adjacency["indices_0"].read())
        cols = np.asarray(self.conus_adjacency["indices_1"].read())
        if rows.size == 0:
            raise ValueError("No coordinate-pairs found. Cannot construct a matrix")
        all_indices = np.arange(len(self.order_ids))
        return self._assemble(rows, cols, len(all_indices), all_indices, None, None, None, None)
