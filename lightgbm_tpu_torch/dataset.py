"""Binned dataset (PyTorch port of ``lightgbm_tpu/dataset.py``).

Host numpy throughout: construction, EFB bundling and the ``save_binned``
/ ``load_binned`` npz format are the reference package's, so a file the
JAX package wrote loads here unchanged (that is how bin mappers cross
over, see convert.py). Device copies of the matrix are made by the
serving code (boosting.GBDT._valid_bins) on the booster's torch device.
Dense single-feature numerical groups of a uint8 matrix bin through the
native threaded applier (``native/binning.cpp`` via ``io_native``, the JAX
package's route); bundled, categorical, sparse and uint16 groups take
numpy's ``searchsorted``. Both write the same bytes.

Equivalent of the reference ``Dataset`` + ``DatasetLoader`` +
``Metadata`` (reference: include/LightGBM/dataset.h:41,282,
src/io/dataset.cpp:318 Construct, src/io/dataset_loader.cpp). Differences by
design:

- The binned matrix is a single dense ``(rows, features)`` uint8/uint16 array
  destined for HBM (row-sharded over the device mesh), instead of per-group
  column bins (dense_bin.hpp / sparse_bin.hpp). All features share one padded
  bin axis; per-feature bin counts mask the tail during the split scan.
- EFB (reference dataset.cpp:239 FastFeatureBundling) folds mutually-exclusive
  sparse features into shared columns before the matrix is materialized.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np

from .config import Config
from .ops.binning import (
    BIN_CATEGORICAL,
    BIN_NUMERICAL,
    MISSING_NAN,
    MISSING_NONE,
    MISSING_ZERO,
    BinMapper,
    find_bin,
)
from .utils.log import Log


class Metadata:
    """Labels, weights, query boundaries, init scores
    (reference: include/LightGBM/dataset.h:41, src/io/metadata.cpp)."""

    def __init__(
        self,
        num_data: int,
        label: Optional[np.ndarray] = None,
        weight: Optional[np.ndarray] = None,
        group: Optional[np.ndarray] = None,
        init_score: Optional[np.ndarray] = None,
    ) -> None:
        self.num_data = num_data
        self.label = None if label is None else np.ascontiguousarray(label, dtype=np.float32).ravel()
        self.weight = None if weight is None else np.ascontiguousarray(weight, dtype=np.float32).ravel()
        self.init_score = None if init_score is None else np.ascontiguousarray(init_score, dtype=np.float64)
        self.query_boundaries: Optional[np.ndarray] = None
        self.query_id: Optional[np.ndarray] = None
        if group is not None:
            group = np.asarray(group).ravel().astype(np.int64)
            # LightGBM semantics: `group` is per-query sizes summing to
            # num_data (reference src/io/metadata.cpp SetQuery). A per-row
            # query-id vector is also accepted (sklearn-API convenience) but
            # only when it cannot be a sizes vector and ids are contiguous.
            if group.sum() == num_data:
                sizes = group
                if np.any(sizes <= 0):
                    Log.fatal("group sizes must be positive")
                self.query_boundaries = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
            elif len(group) == num_data:
                qid = group
                change = np.flatnonzero(np.diff(qid)) + 1
                boundaries = np.concatenate([[0], change, [num_data]]).astype(np.int64)
                # reject non-contiguous ids (same id reappearing later)
                first_vals = qid[boundaries[:-1]]
                if len(np.unique(first_vals)) != len(first_vals):
                    Log.fatal("per-row query ids must be contiguous (sorted by query)")
                self.query_boundaries = boundaries
            else:
                Log.fatal("sum of group sizes (%d) != num_data (%d)", group.sum(), num_data)
            qb = self.query_boundaries
            qid = np.zeros(num_data, dtype=np.int32)
            for i in range(len(qb) - 1):
                qid[qb[i]:qb[i + 1]] = i
            self.query_id = qid

    @property
    def num_queries(self) -> int:
        return 0 if self.query_boundaries is None else len(self.query_boundaries) - 1


@dataclass
class FeatureGroupInfo:
    """One bundled column of the binned matrix (EFB bundle or single feature).

    Reference analog: FeatureGroup (include/LightGBM/feature_group.h:25) —
    features in a bundle are mutually exclusive; each sub-feature occupies a
    contiguous bin range [bin_offset, bin_offset + num_bins) in the column.
    """
    feature_indices: List[int]      # inner (used-feature) indices in this bundle
    bin_offsets: List[int]          # per sub-feature offset within the column
    num_bins: int                   # total bins in this column


class BinnedDataset:
    """The constructed training matrix (reference Dataset, dataset.h:282)."""

    def __init__(self) -> None:
        self.num_data: int = 0
        self.num_total_features: int = 0      # original input feature count
        self.used_feature_indices: List[int] = []   # original index per used feature
        self.bin_mappers: List[BinMapper] = []      # per used feature
        self.binned: Optional[np.ndarray] = None    # (num_data, num_groups) uint8/16
        self.groups: List[FeatureGroupInfo] = []
        self.feature_to_group: np.ndarray = np.array([], dtype=np.int32)   # used-feature -> group
        self.feature_group_offset: np.ndarray = np.array([], dtype=np.int32)  # bin offset in group
        self.metadata: Metadata = Metadata(0)
        self.max_bins_per_feature: int = 0
        self.feature_names: List[str] = []
        self.monotone_constraints: Optional[np.ndarray] = None
        self.feature_penalty: Optional[np.ndarray] = None
        # raw numerical feature values, kept only for linear_tree
        # (reference: Dataset::raw_data_, dataset.h numeric_feature_map_)
        self.raw_numeric: Optional[np.ndarray] = None   # (N, F) f32, NaN kept
        # distributed loading: (rank, world, global_rows) when this object
        # holds only one host's row shard (io.load_dataset_sharded)
        self.shard_info: Optional[tuple] = None

    # -- accessors used by the learners --
    @property
    def num_features(self) -> int:
        return len(self.bin_mappers)

    def feature_num_bins(self) -> np.ndarray:
        return np.array([m.num_bins for m in self.bin_mappers], dtype=np.int32)

    def real_feature_index(self, inner: int) -> int:
        return self.used_feature_indices[inner]

    def inner_feature_index(self, real: int) -> int:
        try:
            return self.used_feature_indices.index(real)
        except ValueError:
            return -1

    @property
    def num_groups(self) -> int:
        return len(self.groups)

    @property
    def has_bundles(self) -> bool:
        return any(len(g.feature_indices) > 1 for g in self.groups)

    def group_num_bins(self) -> np.ndarray:
        return np.array([g.num_bins for g in self.groups], dtype=np.int32)

    def bundle_maps(self) -> Dict[str, np.ndarray]:
        """Static index maps between feature-bin space and bundle-bin space,
        used by the learner to reconstruct per-feature histogram views from
        bundled columns and to translate routing tables (reference analog:
        FeatureGroup bin offsets + Dataset::FixHistogram, dataset.h:503).

        - proj (F, B): flat index into (num_groups * Bm) for each feature bin
          (meaningless where ``valid`` is False)
        - valid (F, B): feature bin has its own bundle slot (False for the
          shared default bin of multi-bundles and past num_bins)
        - has_rest (F,): feature lives in a multi-feature bundle — its
          default bin must be recovered as parent_total - sum(own slots)
        - dpos (F,): the feature's default bin index
        - map_fb (F, Bm): bundle bin -> this feature's bin (its default bin
          for bundle bins belonging to other sub-features / shared zero)
        - group (F,), offset (F,), nbm1 (F,): routing arithmetic inputs
        """
        F = self.num_features
        B = int(self.feature_num_bins().max()) if F else 1
        Bm = int(self.group_num_bins().max()) if self.groups else 1
        proj = np.zeros((F, B), np.int32)
        valid = np.zeros((F, B), bool)
        has_rest = np.zeros(F, bool)
        dpos = np.zeros(F, np.int32)
        map_fb = np.zeros((F, Bm), np.int32)
        nbm1 = np.zeros(F, np.int32)
        for gid, grp in enumerate(self.groups):
            multi = len(grp.feature_indices) > 1
            for j, off in zip(grp.feature_indices, grp.bin_offsets):
                m = self.bin_mappers[j]
                nb = m.num_bins
                d = m.default_bin if multi else -1
                dpos[j] = m.default_bin
                has_rest[j] = multi
                nbm1[j] = nb - 1
                bb_ids = np.arange(nb)
                if multi:
                    adj = bb_ids - (bb_ids > d)
                    slots = np.where(bb_ids == d, 0, off + adj)
                    proj[j, :nb] = gid * Bm + slots
                    valid[j, :nb] = bb_ids != d
                    map_fb[j, :] = m.default_bin
                    own = np.arange(nb)[bb_ids != d]
                    map_fb[j, off:off + nb - 1] = own
                else:
                    proj[j, :nb] = gid * Bm + bb_ids
                    valid[j, :nb] = True
                    map_fb[j, :min(nb, Bm)] = np.arange(min(nb, Bm))
                    map_fb[j, nb:] = nb - 1
        return dict(proj=proj, valid=valid, has_rest=has_rest, dpos=dpos,
                    map_fb=map_fb, group=self.feature_to_group.astype(np.int32),
                    offset=self.feature_group_offset.astype(np.int32),
                    nbm1=nbm1)


def _resolve_categorical(
    categorical_feature: Union[str, Sequence[Union[int, str]], None],
    num_features: int,
    feature_names: List[str],
) -> List[int]:
    if categorical_feature is None or categorical_feature == "" or categorical_feature == "auto":
        return []
    if isinstance(categorical_feature, str):
        items: List[Any] = [s for s in categorical_feature.split(",") if s]
    else:
        items = list(categorical_feature)
    out: List[int] = []
    for it in items:
        if isinstance(it, str) and not it.lstrip("-").isdigit():
            if it.startswith("name:"):
                it = it[5:]
            if it in feature_names:
                out.append(feature_names.index(it))
            else:
                Log.warning("Unknown categorical feature name: %s", it)
        else:
            out.append(int(it))
    return sorted(set(i for i in out if 0 <= i < num_features))


def construct_dataset(
    X: np.ndarray,
    config: Config,
    *,
    label: Optional[np.ndarray] = None,
    weight: Optional[np.ndarray] = None,
    group: Optional[np.ndarray] = None,
    init_score: Optional[np.ndarray] = None,
    feature_names: Optional[List[str]] = None,
    categorical_feature: Union[str, Sequence[Union[int, str]], None] = None,
    reference: Optional[BinnedDataset] = None,
    native: bool = True,
) -> BinnedDataset:
    """Build a BinnedDataset from a raw feature matrix.

    Reference analog: DatasetLoader::LoadFromFile + Dataset::Construct
    (src/io/dataset_loader.cpp:182, src/io/dataset.cpp:318): sample rows for
    bin finding, fit BinMappers, drop trivial features, bundle (EFB), then
    extract (bin) all rows. When ``reference`` is given, reuse its bin mappers
    (validation sets must share the training set's binning —
    reference: LoadFromFileAlignWithOtherDataset, dataset_loader.cpp:261).
    """
    sparse = _is_sparse(X)
    if not sparse:
        X = np.asarray(X)
    if X.ndim != 2:
        raise ValueError("X must be 2-dimensional, got shape %s" % (X.shape,))
    num_data, num_total = X.shape
    ds = BinnedDataset()
    ds.num_data = num_data
    ds.num_total_features = num_total
    ds.feature_names = feature_names or ["Column_%d" % i for i in range(num_total)]

    if reference is not None:
        ds.used_feature_indices = list(reference.used_feature_indices)
        ds.bin_mappers = reference.bin_mappers
        ds.groups = reference.groups
        ds.feature_to_group = reference.feature_to_group
        ds.feature_group_offset = reference.feature_group_offset
        ds.max_bins_per_feature = reference.max_bins_per_feature
        ds.feature_names = reference.feature_names
        ds.monotone_constraints = reference.monotone_constraints
        ds.feature_penalty = reference.feature_penalty
        ds.binned = _extract_binned(
            X, ds, nthreads=int(config.num_threads), native=native)
        ds.metadata = Metadata(num_data, label, weight, group, init_score)
        if config.linear_tree:
            ds.raw_numeric = _raw_numeric(X, ds)
        return ds

    cat_idx = set(_resolve_categorical(categorical_feature if categorical_feature is not None
                                       else config.categorical_feature,
                                       num_total, ds.feature_names))

    # ---- sampling for bin finding (reference: bin_construct_sample_cnt,
    # dataset_loader.cpp:903 SampleTextDataFromFile) ----
    sample_cnt = min(num_data, int(config.bin_construct_sample_cnt))
    rng = np.random.RandomState(config.data_random_seed)
    if sample_cnt < num_data:
        sample_idx = rng.choice(num_data, size=sample_cnt, replace=False)
        sample_idx.sort()
    else:
        sample_idx = np.arange(num_data)
    if sparse:
        import scipy.sparse as sp
        Xs_csc = sp.csc_matrix(sp.csr_matrix(X)[sample_idx])

        def sample_col(f: int) -> np.ndarray:
            # nonzeros only; find_bin counts the rest as implicit zeros
            return np.asarray(
                Xs_csc.data[Xs_csc.indptr[f]:Xs_csc.indptr[f + 1]], np.float64)

        def sample_nz_mask(f: int) -> np.ndarray:
            mask = np.zeros(sample_cnt, dtype=bool)
            mask[Xs_csc.indices[Xs_csc.indptr[f]:Xs_csc.indptr[f + 1]]] = True
            return mask
    else:
        X_sample = np.asarray(X[sample_idx], dtype=np.float64)

        def sample_col(f: int) -> np.ndarray:
            return X_sample[:, f]

        def sample_nz_mask(f: int) -> np.ndarray:
            col = X_sample[:, f]
            return np.abs(np.nan_to_num(col, nan=1.0)) > 1e-35

    # per-feature max_bin override (reference: max_bin_by_feature, config.h)
    max_bin_by_feature = config.max_bin_by_feature
    min_split_data = 0
    if config.feature_pre_filter:
        # features that cannot split given min_data_in_leaf are trivial
        min_split_data = int(config.min_data_in_leaf * sample_cnt / max(1, num_data))

    forced_bounds = _load_forced_bins(config.forcedbins_filename, num_total)

    mappers: List[BinMapper] = []
    used: List[int] = []
    for f in range(num_total):
        mb = (max_bin_by_feature[f] if f < len(max_bin_by_feature) else config.max_bin)
        m = find_bin(
            sample_col(f),
            sample_cnt,
            mb,
            config.min_data_in_bin,
            bin_type=BIN_CATEGORICAL if f in cat_idx else BIN_NUMERICAL,
            use_missing=config.use_missing,
            zero_as_missing=config.zero_as_missing,
            min_split_data=min_split_data,
            forced_bounds=forced_bounds.get(f),
        )
        if m.is_trivial:
            continue
        mappers.append(m)
        used.append(f)
    if not mappers:
        Log.warning("All features are trivial; training will produce constant predictions")
    ds.bin_mappers = mappers
    ds.used_feature_indices = used

    # ---- EFB bundling decision (reference: dataset.cpp:239 FastFeatureBundling) ----
    ds.groups, ds.feature_to_group, ds.feature_group_offset = _make_groups(
        sample_nz_mask, sample_cnt, used, mappers,
        # bundles are capped at 256 bins so the matrix stays uint8; with
        # max_bin > 256 single features already need uint16 — skip bundling
        enable_bundle=config.enable_bundle and config.max_bin <= 256,
        max_conflict_rate=float(getattr(config, "max_conflict_rate", 0.0)),
    )
    ds.max_bins_per_feature = max((g.num_bins for g in ds.groups), default=1)

    # monotone constraints / feature penalties mapped to used features
    if config.monotone_constraints:
        mc = np.zeros(len(used), dtype=np.int8)
        for i, f in enumerate(used):
            if f < len(config.monotone_constraints):
                mc[i] = np.sign(config.monotone_constraints[f])
        if np.any(mc != 0):
            ds.monotone_constraints = mc
    if config.feature_contri:
        fp = np.ones(len(used), dtype=np.float32)
        for i, f in enumerate(used):
            if f < len(config.feature_contri):
                fp[i] = config.feature_contri[f]
        ds.feature_penalty = fp

    ds.binned = _extract_binned(X, ds, nthreads=int(config.num_threads),
                                native=native)
    ds.metadata = Metadata(num_data, label, weight, group, init_score)
    if config.linear_tree:
        ds.raw_numeric = _raw_numeric(X, ds)
    return ds


def _make_groups(
    sample_nz_mask,
    sample_cnt: int,
    used: List[int],
    mappers: List[BinMapper],
    *,
    enable_bundle: bool,
    max_conflict_rate: float = 0.0,
) -> tuple:
    """Greedy exclusive-feature bundling (reference: Dataset::FindGroups,
    src/io/dataset.cpp:100 — greedy graph coloring by conflict count).

    Only sufficiently sparse features are bundling candidates; dense features
    get their own group. Conflicts are counted on the sample: two features
    conflict on a row if both are away from their most-frequent (default) bin.
    A bundle's total bin count is capped at 256 so the training matrix stays
    uint8 (the partitioned learner's packed-row layout).
    """
    n = len(used)
    sparse_ok = [enable_bundle and m.sparse_rate >= 0.8 and m.bin_type == BIN_NUMERICAL
                 for m in mappers]
    if not any(sparse_ok):
        # dense data: every feature is its own group, skip the conflict scan
        groups = [FeatureGroupInfo([i], [0], mappers[i].num_bins) for i in range(n)]
        return (groups, np.arange(n, dtype=np.int32), np.zeros(n, dtype=np.int32))
    groups: List[FeatureGroupInfo] = []
    feature_to_group = np.zeros(n, dtype=np.int32)
    feature_offset = np.zeros(n, dtype=np.int32)

    # nonzero masks on the sample for bundling candidates
    bundles: List[List[int]] = []
    bundle_masks: List[np.ndarray] = []
    bundle_bins: List[int] = []
    max_conflicts = int(max_conflict_rate * sample_cnt)
    for i in range(n):
        if not sparse_ok[i]:
            continue
        nz = sample_nz_mask(used[i])
        nb = mappers[i].num_bins - 1    # bins it adds to a bundle
        placed = False
        for b, mask in enumerate(bundle_masks):
            if len(bundles[b]) >= 255 or bundle_bins[b] + nb > 256:
                continue
            conflicts = int(np.count_nonzero(mask & nz))
            if conflicts <= max_conflicts:
                bundles[b].append(i)
                bundle_masks[b] = mask | nz
                bundle_bins[b] += nb
                placed = True
                break
        if not placed:
            bundles.append([i])
            bundle_masks.append(nz)
            bundle_bins.append(1 + nb)

    # only multi-feature bundles count as bundles
    multi = [b for b in bundles if len(b) > 1]
    in_multi = set(i for b in multi for i in b)

    gid = 0
    for b in multi:
        offsets: List[int] = []
        # bin 0 of the bundle = "all defaults"; each sub-feature's non-default
        # bins occupy [off, off + (num_bins-1))
        off = 1
        for i in b:
            offsets.append(off)
            off += mappers[i].num_bins - 1
        groups.append(FeatureGroupInfo([int(i) for i in b], offsets, off))
        for i, o in zip(b, offsets):
            feature_to_group[i] = gid
            feature_offset[i] = o
        gid += 1
    for i in range(n):
        if i in in_multi:
            continue
        groups.append(FeatureGroupInfo([i], [0], mappers[i].num_bins))
        feature_to_group[i] = gid
        feature_offset[i] = 0
        gid += 1
    return groups, feature_to_group, feature_offset


def _bundle_bin(m: BinMapper, bins: np.ndarray, offset: int) -> np.ndarray:
    """Map a sub-feature's bins into its bundle range.

    Non-default bins keep their order in [offset, offset + num_bins - 1);
    the default (most-frequent/zero) bin maps to the bundle's shared bin 0
    (reference: FeatureGroup bin offsets, include/LightGBM/feature_group.h:25).
    """
    d = m.default_bin
    adj = bins - (bins > d).astype(bins.dtype)  # remove the default slot
    return np.where(bins == d, 0, offset + adj)


def _extract_binned(X, ds: BinnedDataset, nthreads: int = 0,
                    native: bool = True) -> np.ndarray:
    """Bin every row into the (num_data, num_groups) bundled matrix.

    EFB (reference: Dataset::Construct + FeatureGroup::PushData,
    src/io/dataset.cpp:318): each group is one column; multi-feature
    bundles share the column with per-sub-feature bin offsets, so histogram
    and partition cost scale with the BUNDLED column count. Accepts dense
    numpy or scipy sparse input; sparse stays O(nnz). Dense single-feature
    numerical groups of a uint8 matrix bin natively on ``nthreads`` threads
    (0: ``os.cpu_count()``) unless ``native`` is False.
    """
    num_data = X.shape[0]
    max_bins = max((g.num_bins for g in ds.groups), default=1)
    dtype = np.uint8 if max_bins <= 256 else np.uint16
    out = np.zeros((num_data, len(ds.groups)), dtype=dtype)
    sparse = _is_sparse(X)
    if sparse:
        import scipy.sparse as sp
        Xc = sp.csc_matrix(X)
    else:
        Xv = np.asarray(X, dtype=np.float64)

    def fill_group(gid: int) -> None:
        grp = ds.groups[gid]
        multi = len(grp.feature_indices) > 1
        for j, off in zip(grp.feature_indices, grp.bin_offsets):
            m = ds.bin_mappers[j]
            real = ds.used_feature_indices[j]
            if sparse:
                col = Xc.getcol(real)
                rows = col.indices
                vals = np.asarray(col.data, dtype=np.float64)
                zero_bin = int(m.value_to_bin(np.zeros(1))[0])
                b_nz = m.value_to_bin(vals)
                if multi:
                    bb = _bundle_bin(m, b_nz, off)
                    base = int(_bundle_bin(m, np.asarray([zero_bin]), off)[0])
                    if base != 0:
                        out[:, gid] = base
                    nz = bb != base
                    out[rows[nz], gid] = bb[nz].astype(dtype)
                else:
                    out[:, gid] = zero_bin
                    out[rows, gid] = b_nz.astype(dtype)
            else:
                b = m.value_to_bin(Xv[:, real])
                if multi:
                    bb = _bundle_bin(m, b, off)
                    nz = bb != 0
                    out[nz, gid] = bb[nz].astype(dtype)
                else:
                    out[:, gid] = b.astype(dtype)

    # Dense single-feature numerical groups bin through the native threaded
    # applier (the reference's OpenMP PushData analog, src/io/dataset.cpp:318);
    # numpy's searchsorted holds the GIL, ~7 s alone at 2M x 28.
    done = set()
    if native and not sparse and dtype == np.uint8:
        from .io_native import apply_bins_native
        specs = []
        for gid, grp in enumerate(ds.groups):
            if len(grp.feature_indices) != 1:
                continue
            j = grp.feature_indices[0]
            m = ds.bin_mappers[j]
            if m.bin_type != BIN_NUMERICAL:
                continue
            specs.append((ds.used_feature_indices[j], m.upper_bounds,
                          m.missing_type, m.missing_bin, gid))
        apply_bins_native(Xv, specs, out, nthreads=nthreads)
        done = {s[4] for s in specs}
    for gid in range(len(ds.groups)):
        if gid not in done:
            fill_group(gid)
    return out


def _load_forced_bins(filename: str, num_features: int) -> Dict[int, list]:
    """Forced bin upper bounds per feature (reference:
    dataset_loader.cpp DatasetLoader::GetForcedBins; JSON list of
    {"feature": i, "bin_upper_bound": [...]})."""
    if not filename:
        return {}
    import json as _json
    import os as _os
    if not _os.path.exists(filename):
        Log.warning("forcedbins file %s not found", filename)
        return {}
    with open(filename) as f:
        spec = _json.load(f)
    out: Dict[int, list] = {}
    for item in spec:
        fi = int(item.get("feature", -1))
        if 0 <= fi < num_features:
            out[fi] = [float(v) for v in item.get("bin_upper_bound", [])]
    return out


def _raw_numeric(X, ds: BinnedDataset) -> np.ndarray:
    """Raw values of the used features for linear-leaf fitting (reference:
    dataset.cpp raw_data_ kept when linear_tree). Indexed by REAL feature."""
    n = X.shape[0]
    total = ds.num_total_features
    out = np.zeros((n, total), dtype=np.float32)
    if _is_sparse(X):
        import scipy.sparse as sp
        Xc = sp.csc_matrix(X)
        for f in ds.used_feature_indices:
            col = Xc.getcol(f)
            out[col.indices, f] = col.data
    else:
        Xv = np.asarray(X, dtype=np.float32)
        for f in ds.used_feature_indices:
            out[:, f] = Xv[:, f]
    return out


def _is_sparse(X) -> bool:
    return hasattr(X, "tocsc") and hasattr(X, "indptr") or \
        type(X).__module__.startswith("scipy.sparse")


# ---------------------------------------------------------------------------
# Binary dataset cache (reference: Dataset::SaveBinaryFile, dataset.h:441 +
# DatasetLoader::LoadFromBinFile, dataset_loader.cpp:314): the binned matrix,
# bin mappers, bundling structure and metadata round-trip through one npz so
# repeated runs skip text parsing and bin finding entirely.
# ---------------------------------------------------------------------------

def save_binned(ds: BinnedDataset, filename: str) -> None:
    import json as _json

    mappers = [dict(
        num_bins=m.num_bins, bin_type=m.bin_type, missing_type=m.missing_type,
        is_trivial=m.is_trivial, upper_bounds=list(map(float, m.upper_bounds)),
        categories=list(map(int, m.categories)), default_bin=m.default_bin,
        most_freq_bin=m.most_freq_bin, missing_bin=m.missing_bin,
        sparse_rate=m.sparse_rate, min_value=m.min_value, max_value=m.max_value,
    ) for m in ds.bin_mappers]
    groups = [dict(feature_indices=g.feature_indices,
                   bin_offsets=g.bin_offsets, num_bins=g.num_bins)
              for g in ds.groups]
    meta = dict(
        num_data=ds.num_data, num_total_features=ds.num_total_features,
        used_feature_indices=list(ds.used_feature_indices),
        feature_names=list(ds.feature_names), mappers=mappers, groups=groups,
    )
    md = ds.metadata
    empty = np.array([])
    np.savez_compressed(
        filename,
        header=np.frombuffer(_json.dumps(meta).encode(), dtype=np.uint8),
        binned=ds.binned,
        feature_to_group=ds.feature_to_group,
        feature_group_offset=ds.feature_group_offset,
        label=md.label if md.label is not None else empty,
        weight=md.weight if md.weight is not None else empty,
        init_score=md.init_score if md.init_score is not None else empty,
        query_boundaries=md.query_boundaries
        if md.query_boundaries is not None else empty,
        monotone=ds.monotone_constraints
        if ds.monotone_constraints is not None else empty,
        penalty=ds.feature_penalty if ds.feature_penalty is not None else empty,
    )


def load_binned(filename: str) -> BinnedDataset:
    import json as _json

    z = np.load(filename, allow_pickle=False)
    meta = _json.loads(bytes(z["header"]).decode())
    ds = BinnedDataset()
    ds.num_data = int(meta["num_data"])
    ds.num_total_features = int(meta["num_total_features"])
    ds.used_feature_indices = [int(i) for i in meta["used_feature_indices"]]
    ds.feature_names = list(meta["feature_names"])
    for md in meta["mappers"]:
        m = BinMapper()
        m.num_bins = int(md["num_bins"])
        m.bin_type = int(md["bin_type"])
        m.missing_type = int(md["missing_type"])
        m.is_trivial = bool(md["is_trivial"])
        m.upper_bounds = np.asarray(md["upper_bounds"], np.float64)
        m.categories = np.asarray(md["categories"], np.int64)
        m.default_bin = int(md["default_bin"])
        m.most_freq_bin = int(md["most_freq_bin"])
        m.missing_bin = int(md["missing_bin"])
        m.sparse_rate = float(md["sparse_rate"])
        m.min_value = float(md["min_value"])
        m.max_value = float(md["max_value"])
        ds.bin_mappers.append(m)
    ds.groups = [FeatureGroupInfo([int(i) for i in g["feature_indices"]],
                                  [int(o) for o in g["bin_offsets"]],
                                  int(g["num_bins"]))
                 for g in meta["groups"]]
    ds.binned = z["binned"]
    ds.feature_to_group = z["feature_to_group"]
    ds.feature_group_offset = z["feature_group_offset"]
    ds.max_bins_per_feature = max((g.num_bins for g in ds.groups), default=1)

    def opt(key):
        a = z[key]
        return a if a.size else None

    ds.metadata = Metadata(ds.num_data)
    ds.metadata.label = opt("label")
    ds.metadata.weight = opt("weight")
    ds.metadata.init_score = opt("init_score")
    qb = opt("query_boundaries")
    if qb is not None:
        ds.metadata.query_boundaries = qb.astype(np.int64)
        qid = np.zeros(ds.num_data, dtype=np.int32)
        for i in range(len(qb) - 1):
            qid[qb[i]:qb[i + 1]] = i
        ds.metadata.query_id = qid
    ds.monotone_constraints = opt("monotone")
    ds.feature_penalty = opt("penalty")
    return ds
