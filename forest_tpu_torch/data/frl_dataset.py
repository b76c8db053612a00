"""ForestDatasetV2: patch dataset over the hierarchical cube.

Behavioral contracts from original:frl/data/loaders/dataset/
forest_dataset_v2.py (SURVEY.md §2.3):

- patch list of ``patch_size``^2 SpatialWindows filtered by >= ``min_aoi``
  AOI coverage (:206-257);
- deterministic checkerboard train/val/test split over blocks of patches
  (:259-305, exact arithmetic in forest_tpu_torch.data.checkerboard);
- epoch modes full / frac / number with per-epoch reshuffle (:311-326);
- per-channel load with single-year extraction, temporal reduction, NaN
  padding to the config time window, fill_value -> NaN, ok_if thresholding,
  formula channels (temporal position t/(T-1)), zero-padded ragged boundary
  patches (:357-369, :520-728);
- optional debug_window restriction (SURVEY.md §5 fixtures).

Returns channel-LAST group arrays: [H, W, C] / [T, H, W, C] (the TPU layout;
the reference's [C, H, W] maps by transpose).
"""
from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

from forest_tpu_torch.data import checkerboard, zarrlite as zl
from forest_tpu_torch.data.bindings import (BindingsConfig, ChannelConfig,
                                      DatasetGroupConfig)
from forest_tpu_torch.data.windows import SpatialWindow, TemporalWindow


class ForestDatasetV2:
    def __init__(self, bindings: BindingsConfig,
                 split: Optional[str] = "train",
                 patch_size: int = 256,
                 split_block_size: Tuple[int, int] = (4, 4),
                 min_aoi: float = 0.3,
                 epoch_mode: str = "full",
                 sample_frac: float = 1.0,
                 sample_number: int = 0,
                 debug_window: Optional[SpatialWindow] = None,
                 seed: int = 0):
        self.bindings = bindings
        self.root = zl.open_zarr(bindings.zarr_path)
        self.patch_size = patch_size
        self.split = split
        self.split_block_size = tuple(split_block_size)
        self.epoch_mode = epoch_mode
        self.sample_frac = sample_frac
        self.sample_number = sample_number
        self.min_aoi = min_aoi
        self.rng = np.random.default_rng(seed)
        self._channel_major = False     # set_wire_layout

        years = self.root.attrs.get("time_coords", [])
        self.years = np.asarray(years, np.int64)
        tw = bindings.time_window
        self.temporal_window = TemporalWindow(tw.start, tw.end)
        # indices of cube years inside the configured window
        self._t_lo, self._t_hi = self.temporal_window.clip_years(self.years)

        self._validate_sources()

        aoi = np.asarray(self.root["aoi"][:, :]) > 0
        self.height, self.width = aoi.shape
        self.patches = self._build_patches(aoi, debug_window)
        if split is not None:
            self.patches = self._filter_by_split(self.patches, split)
        self._current_indices = list(range(len(self.patches)))

    # ------------------------------------------------------------------

    def _validate_sources(self) -> None:
        missing = []
        for g in self.bindings.dataset.values():
            for ch in g.channels:
                if ch.source is None:
                    continue
                try:
                    self.root[ch.source]
                except KeyError:
                    missing.append(f"{g.name}.{ch.name} -> {ch.source}")
        if missing:
            raise FileNotFoundError(
                "bindings reference missing zarr paths: " + ", ".join(missing))

    def _build_patches(self, aoi: np.ndarray,
                       debug_window: Optional[SpatialWindow]
                       ) -> List[SpatialWindow]:
        p = self.patch_size
        out = []
        for r in range(0, self.height, p):
            for c in range(0, self.width, p):
                win = SpatialWindow(r, min(r + p, self.height),
                                    c, min(c + p, self.width))
                if debug_window is not None and \
                        debug_window.intersection(win) is None:
                    continue
                cov = aoi[win.row_slice, win.col_slice].mean()
                if cov >= self.min_aoi:
                    out.append(win)
        return out

    def _filter_by_split(self, patches: List[SpatialWindow],
                         split: str) -> List[SpatialWindow]:
        target = checkerboard.SPLIT_CODES[split]
        return [w for w in patches
                if checkerboard.split_code(w.row_start, w.col_start,
                                           self.patch_size,
                                           self.split_block_size) == target]

    # ------------------------------------------------------------------

    def __len__(self) -> int:
        return len(self._current_indices)

    def on_epoch_start(self) -> None:
        n = len(self.patches)
        if self.epoch_mode == "full":
            idx = np.arange(n)
            self.rng.shuffle(idx)
        elif self.epoch_mode == "frac":
            idx = self.rng.choice(n, max(int(self.sample_frac * n), 1),
                                  replace=False)
        elif self.epoch_mode == "number":
            idx = self.rng.choice(n, min(self.sample_number, n),
                                  replace=False)
        else:
            raise ValueError(f"unknown epoch_mode {self.epoch_mode!r}")
        self._current_indices = idx.tolist()

    # ------------------------------------------------------------------

    @property
    def num_timesteps(self) -> int:
        return self.temporal_window.num_years

    def _load_source_channel(self, ch: ChannelConfig, temporal: bool,
                             win: SpatialWindow) -> np.ndarray:
        """-> [H, W] (static target) or [T, H, W] (temporal target)."""
        t_cfg = self.num_timesteps
        h, w = win.height, win.width

        # temporal-position formula: the reference accepts the literal
        # expression string ("t / (T - 1)" -- what frl_binding_v1.yaml:103
        # ships) via substring match (forest_dataset_v2.py:669-693); the
        # symbolic name is this repo's alias.
        if ch.formula and (ch.formula == "temporal_position"
                           or "t / (T - 1)" in ch.formula
                           or "t/(T-1)" in ch.formula.replace(" ", "")):
            tpos = (np.arange(t_cfg, dtype=np.float32)
                    / max(t_cfg - 1, 1))[:, None, None]
            return np.broadcast_to(tpos, (t_cfg, h, w)).copy()
        if ch.formula:
            raise ValueError(f"unknown formula {ch.formula!r}")

        arr = self.root[ch.source]
        is_annual = arr.ndim == 3
        if is_annual:
            if ch.year is not None:
                matches = np.nonzero(self.years == ch.year)[0]
                if matches.size == 0:
                    raise ValueError(
                        f"channel {ch.name!r}: year {ch.year} not in cube "
                        f"years {self.years.tolist()}")
                ti = int(matches[0])
                data = np.asarray(arr[ti:ti + 1, win.row_slice,
                                      win.col_slice], np.float32)[0]
                is_annual = False
            else:
                data = np.asarray(arr[self._t_lo:self._t_hi,
                                      win.row_slice, win.col_slice],
                                  np.float32)
        else:
            data = np.asarray(arr[win.row_slice, win.col_slice], np.float32)

        if ch.fill_value is not None:
            data = np.where(data == ch.fill_value, np.nan, data)
        if ch.ok_if is not None:
            data = np.where(np.isfinite(data), ch.ok_if.apply(data), 0.0)

        if is_annual:
            # NaN-pad into the config time window, placing EACH loaded
            # year at its own index (cube years may be non-contiguous).
            full = np.full((t_cfg, h, w), np.nan, np.float32)
            loaded_years = self.years[self._t_lo:self._t_hi]
            idxs = np.asarray([self.temporal_window.year_to_index(int(y))
                               for y in loaded_years])
            full[idxs] = data
            data = full
            if ch.reducer:
                red = {"mean": np.nanmean, "max": np.nanmax,
                       "min": np.nanmin, "sum": np.nansum}[ch.reducer]
                import warnings
                with warnings.catch_warnings():
                    warnings.simplefilter("ignore")
                    data = red(data, axis=0)
                is_annual = False

        if temporal and not is_annual and data.ndim == 2:
            data = np.broadcast_to(data[None], (t_cfg, h, w)).copy()
        return data

    def _load_group(self, g: DatasetGroupConfig,
                    win: SpatialWindow) -> np.ndarray:
        chans = [self._load_source_channel(c, g.temporal, win)
                 for c in g.channels]
        x = np.stack(chans, axis=-1)  # [H,W,C] or [T,H,W,C]
        return x

    def get_patch(self, idx: int) -> Dict[str, np.ndarray]:
        win = self.patches[self._current_indices[idx]]
        out: Dict[str, np.ndarray] = {}
        p = self.patch_size
        for name, g in self.bindings.dataset.items():
            x = self._load_group(g, win)
            # zero-pad ragged boundary patches to patch_size^2
            if win.height < p or win.width < p:
                if x.ndim == 3:
                    full = np.zeros((p, p, x.shape[-1]), x.dtype)
                    full[:win.height, :win.width] = x
                else:
                    full = np.zeros((x.shape[0], p, p, x.shape[-1]), x.dtype)
                    full[:, :win.height, :win.width] = x
                x = full
            out[name] = x
        out["__window__"] = np.asarray([win.row_start, win.col_start],
                                       np.int64)
        return out

    __getitem__ = get_patch

    def set_wire_layout(self, enabled: bool) -> None:
        """Switch :meth:`load_batch` to channel-major assembly for the
        compact wire (``data.wire``): each group is then emitted as
        [B, C, (T,) H, W] under ``<name>__cm``, every source channel written
        into the batch buffer with one contiguous copy, where the
        channel-last ``np.stack`` writes 4-byte elements C apart.
        ``decode_wire_batch`` restores channel-last on the device.
        :meth:`get_patch` and the default collate keep channel-last."""
        self._channel_major = bool(enabled)

    def load_batch(self, indices) -> Dict[str, np.ndarray]:
        """Stack patches [B, ...] per group (the collate contract); with the
        wire layout on, assemble channel-major (:meth:`set_wire_layout`)."""
        idx = [int(i) for i in np.atleast_1d(indices)]
        if not self._channel_major:
            items = [self.get_patch(i) for i in idx]
            return {k: np.stack([it[k] for it in items]) for k in items[0]}
        p = self.patch_size
        wins = [self.patches[self._current_indices[i]] for i in idx]
        out: Dict[str, np.ndarray] = {}
        for name, g in self.bindings.dataset.items():
            c = len(g.channels)
            shape = ((len(idx), c, self.num_timesteps, p, p) if g.temporal
                     else (len(idx), c, p, p))
            # zeros: the boundary-pad contract of ragged edge patches
            buf = np.zeros(shape, np.float32)
            for bi, win in enumerate(wins):
                for ci, ch in enumerate(g.channels):
                    buf[bi, ci, ..., :win.height, :win.width] = \
                        self._load_source_channel(ch, g.temporal, win)
            out[name + "__cm"] = buf
        out["__window__"] = np.asarray(
            [[w.row_start, w.col_start] for w in wins], np.int64)
        return out


__all__ = ["ForestDatasetV2"]
