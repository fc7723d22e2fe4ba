"""Text dataset loading: CSV / TSV / LibSVM with auto-detection (PyTorch
port of ``lightgbm_tpu/io.py``; host numpy and the native parser, no
torch).

Equivalent of the reference's Parser + DatasetLoader text path (reference:
src/io/parser.cpp Parser::CreateParser format auto-detect,
src/io/dataset_loader.cpp:182 LoadFromFile) including label/weight/group
column designation, ignore columns, header handling, and the sidecar
``.query``/``.weight`` files the reference CLI reads
(src/io/metadata.cpp LoadQueryBoundaries/LoadWeights).

Files without a header parse natively (``native/parser.cpp`` through
``io_native.parse_file``); a header, or a detected format other than the
expected one, takes numpy's parser, as in the JAX package. The two-round
loader streams the file through ``io_native.parse_dense_range`` (the JAX
package streams it through pandas). :func:`load_dataset_sharded` streams
each rank's rows the same way, for the distributed learners.
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from .config import Config
from .utils.log import Log


def detect_format(first_lines: List[str]) -> str:
    """'csv' | 'tsv' | 'libsvm' (reference: parser.cpp DetermineDataType)."""
    for line in first_lines:
        line = line.strip()
        if not line:
            continue
        tokens = line.replace("\t", " ").split()
        if any(":" in t for t in tokens[1:]):
            return "libsvm"
        if "\t" in line:
            return "tsv"
        if "," in line:
            return "csv"
    return "tsv"


def _parse_column_spec(spec: str, header_names: Optional[List[str]]) -> int:
    """Column spec: int index or 'name:<col>' (reference: config docs
    label_column)."""
    if spec is None or spec == "":
        return -1
    if isinstance(spec, int):
        return spec
    s = str(spec)
    if s.startswith("name:"):
        name = s[5:]
        if header_names and name in header_names:
            return header_names.index(name)
        Log.fatal("Column name '%s' not found in header", name)
    return int(s)


def _read_head(filename: str, config: Config):
    """(format, header names, lines to skip, the first three lines)."""
    if not os.path.exists(filename):
        Log.fatal("Data file %s does not exist", filename)
    with open(filename) as f:
        head = [f.readline() for _ in range(3)]
    has_header = bool(config.header)
    fmt = detect_format(head[1 if has_header else 0:])
    header_names: Optional[List[str]] = None
    skip = 0
    if has_header:
        sep = {"csv": ",", "tsv": "\t"}.get(fmt)
        header_names = [c.strip() for c in head[0].strip().split(sep)] \
            if sep else None
        skip = 1
    return fmt, header_names, skip, head


def _column_roles(config: Config, header_names: Optional[List[str]],
                  ncol: int):
    """(label, weight, group column, used feature columns) of a dense file."""
    label_idx = _parse_column_spec(config.label_column or "0", header_names)
    weight_idx = _parse_column_spec(config.weight_column, header_names)
    group_idx = _parse_column_spec(config.group_column, header_names)
    ignore: set = set()
    if config.ignore_column:
        for tok in str(config.ignore_column).split(","):
            if tok:
                ignore.add(_parse_column_spec(tok, header_names))
    special = {label_idx} | ignore
    if weight_idx >= 0:
        special.add(weight_idx)
    if group_idx >= 0:
        special.add(group_idx)
    used_cols = [c for c in range(ncol) if c not in special]
    return label_idx, weight_idx, group_idx, used_cols


def _group_sizes(group_col: np.ndarray) -> np.ndarray:
    """Run lengths of a query-id column in order of appearance: query ids
    need not be sorted, only contiguous (reference: metadata.cpp SetQuery)."""
    gc = group_col.astype(np.int64)
    change = np.flatnonzero(np.diff(gc)) + 1
    return np.diff(np.concatenate([[0], change, [len(gc)]]))


def load_text_file(
    filename: str,
    config: Config,
) -> Tuple[np.ndarray, Optional[np.ndarray], Optional[np.ndarray],
           Optional[np.ndarray], Optional[List[str]]]:
    """Returns (X, label, weight, group_sizes, feature_names)."""
    from .io_native import parse_file

    fmt, header_names, skip, _ = _read_head(filename, config)
    if fmt == "libsvm":
        parsed = None if skip else parse_file(filename, expect_fmt="libsvm")
        if parsed is not None:
            M = parsed[0]
            label, X = M[:, 0], M[:, 1:]
        else:
            X, label = _load_libsvm(filename, skip)
        weight = None
        feature_names = None
        group = None
    else:
        sep = "," if fmt == "csv" else "\t"
        parsed = None if skip else parse_file(filename, expect_fmt=fmt)
        if parsed is not None:
            raw = parsed[0]
        else:
            raw = np.genfromtxt(filename, delimiter=sep, skip_header=skip,
                                dtype=np.float64)
        if raw.ndim == 1:
            raw = raw.reshape(-1, 1)
        ncol = raw.shape[1]
        label_idx, weight_idx, group_idx, used_cols = _column_roles(
            config, header_names, ncol)
        X = raw[:, used_cols]
        label = raw[:, label_idx] if 0 <= label_idx < ncol else None
        weight = raw[:, weight_idx] if weight_idx >= 0 else None
        feature_names = [header_names[c] for c in used_cols] \
            if header_names else None
        group = _group_sizes(raw[:, group_idx]) if group_idx >= 0 else None

    # sidecar files (reference: metadata.cpp — "<data>.query"/".weight")
    qfile = filename + ".query"
    if group is None and os.path.exists(qfile):
        group = np.loadtxt(qfile, dtype=np.int64).ravel()
    wfile = filename + ".weight"
    if weight is None and os.path.exists(wfile):
        weight = np.loadtxt(wfile, dtype=np.float64).ravel()
    return X, label, weight, group, feature_names


def _load_libsvm(filename: str, skip: int) -> Tuple[np.ndarray, np.ndarray]:
    labels: List[float] = []
    rows: List[Dict[int, float]] = []
    max_idx = -1
    with open(filename) as f:
        for i, line in enumerate(f):
            if i < skip:
                continue
            line = line.strip()
            if not line:
                continue
            toks = line.split()
            labels.append(float(toks[0]))
            row: Dict[int, float] = {}
            for t in toks[1:]:
                if ":" not in t:
                    continue
                k, v = t.split(":", 1)
                idx = int(k)
                row[idx] = float(v)
                max_idx = max(max_idx, idx)
            rows.append(row)
    X = np.zeros((len(rows), max_idx + 1), dtype=np.float64)
    for r, row in enumerate(rows):
        for k, v in row.items():
            X[r, k] = v
    return X, np.asarray(labels)


def load_config_file(path: str) -> Dict[str, str]:
    """Parse a LightGBM-style config file: ``key = value`` lines, ``#``
    comments (reference: application.cpp:52 LoadParameters)."""
    out: Dict[str, str] = {}
    with open(path) as f:
        for line in f:
            line = line.split("#", 1)[0].strip()
            if not line or "=" not in line:
                continue
            k, v = line.split("=", 1)
            out[k.strip()] = v.strip()
    return out


# ---------------------------------------------------------------------------
# Two-round (low-memory) loading
# ---------------------------------------------------------------------------

def dense_chunks(filename: str, skip: int, sep: str, n_cols: int,
                 chunk_rows: int):
    """Stream a dense text file as parsed (<= chunk_rows, n_cols) float64
    chunks, never the whole matrix: the native parser reads a byte window
    sized for the rows still missing and parses its whole lines
    (``parse_dense_range``); a line longer than the window doubles it."""
    from .io_native import parse_dense_range

    size = os.path.getsize(filename)
    with open(filename, "rb") as f:
        for _ in range(skip):
            f.readline()
        offset = f.tell()
        line_bytes = max(len(f.readline()), 16)
    window = 0
    buf, filled = np.empty((chunk_rows, n_cols)), 0
    while offset < size:
        window = max(window, 1 << 16,
                     int(1.25 * line_bytes * (chunk_rows - filled)))
        end = min(size, offset + window)
        rows, nxt = parse_dense_range(filename, sep, offset, end,
                                      buf[filled:])
        if nxt == offset:
            if end == size:
                break
            window *= 2
            continue
        filled += rows
        offset = nxt
        window = 0
        if filled == chunk_rows:
            yield buf
            buf, filled = np.empty((chunk_rows, n_cols)), 0
    if filled:
        yield buf[:filled]


def load_dataset_two_round(filename: str, config: Config,
                           chunk_rows: int = 200_000):
    """Two-pass low-memory dataset construction (reference:
    DatasetLoader two-round path, src/io/dataset_loader.cpp — sample on the
    first pass, bin row blocks on the second; the raw double matrix is
    never materialized).

    Pass 1 streams the file once: counts rows, collects label/weight/group
    columns and a uniform reservoir sample of feature rows. The sample
    drives bin finding / EFB / trivial-feature pruning exactly like the
    in-memory path (which also samples, bin_construct_sample_cnt). Pass 2
    streams again, binning each block straight into the final uint8 matrix.
    Returns None for a LibSVM file (the caller loads it whole).
    """
    from .dataset import Metadata, _extract_binned, construct_dataset

    if not os.path.exists(filename):
        Log.fatal("Data file %s does not exist", filename)
    if config.linear_tree:
        Log.fatal("two_round does not keep raw values; disable linear_tree "
                  "or two_round")
    fmt, header_names, skip, head = _read_head(filename, config)
    if fmt == "libsvm":
        Log.warning("two_round supports dense text; using the standard "
                    "libsvm loader")
        return None
    sep = "," if fmt == "csv" else "\t"
    data_line = next((ln for ln in head[skip:] if ln and ln.strip()), None)
    if data_line is None:
        Log.fatal("Data file %s has no data rows", filename)
    ncol = data_line.rstrip("\r\n").count(sep) + 1
    label_idx, weight_idx, group_idx, used_cols = _column_roles(
        config, header_names, ncol)
    feature_names = [header_names[c] for c in used_cols] if header_names \
        else None

    # ---- pass 1: count + metadata columns + reservoir sample ----
    target = max(2, int(config.bin_construct_sample_cnt))
    rng = np.random.RandomState(config.data_random_seed)
    sample = np.empty((target, len(used_cols)), np.float64)
    n_seen = 0
    labels, weights, gcols = [], [], []
    for chunk in dense_chunks(filename, skip, sep, ncol, chunk_rows):
        if 0 <= label_idx < ncol:
            labels.append(chunk[:, label_idx].copy())
        if weight_idx >= 0:
            weights.append(chunk[:, weight_idx].copy())
        if group_idx >= 0:
            gcols.append(chunk[:, group_idx].copy())
        Xc = chunk[:, used_cols]
        m = len(Xc)
        # vectorized reservoir update: row (n_seen + i) replaces a random
        # slot with probability target / (n_seen + i + 1)
        fill = min(max(target - n_seen, 0), m)
        if fill:
            sample[n_seen:n_seen + fill] = Xc[:fill]
        if m > fill:
            idx = np.arange(n_seen + fill, n_seen + m)
            r = (rng.random_sample(m - fill) * (idx + 1)).astype(np.int64)
            keep = r < target
            sample[r[keep]] = Xc[fill:][keep]
        n_seen += m
    if n_seen == 0:
        Log.fatal("Data file %s is empty", filename)
    X_sample = sample[:min(target, n_seen)]

    label = np.concatenate(labels) if labels else None
    weight = np.concatenate(weights) if weights else None
    group = _group_sizes(np.concatenate(gcols)) if gcols else None
    qfile = filename + ".query"
    if group is None and os.path.exists(qfile):
        group = np.loadtxt(qfile, dtype=np.int64).ravel()
    wfile = filename + ".weight"
    if weight is None and os.path.exists(wfile):
        weight = np.loadtxt(wfile, dtype=np.float64).ravel()

    # structure (bin mappers, EFB, pruning) from the sample
    ds = construct_dataset(X_sample, config, feature_names=feature_names,
                           categorical_feature=None)
    # ---- pass 2: bin row blocks into the final matrix ----
    ds.num_data = n_seen
    ds.metadata = Metadata(n_seen, label=label, weight=weight, group=group)
    out = np.zeros((n_seen, ds.num_groups), dtype=ds.binned.dtype)
    r0 = 0
    for chunk in dense_chunks(filename, skip, sep, ncol, chunk_rows):
        Xc = chunk[:, used_cols]
        out[r0:r0 + len(Xc)] = _extract_binned(
            Xc, ds, nthreads=int(config.num_threads))
        r0 += len(Xc)
    ds.binned = out
    ds.raw_numeric = None
    return ds


def _group_allgather(x):
    """Every rank's ``x`` (a numpy array) in rank order, over the
    distributed learners' group (``dist.all_gather_object``)."""
    import torch.distributed as dist

    from .parallel.distributed import current_group

    group = current_group()
    parts = [None] * dist.get_world_size(group)
    dist.all_gather_object(parts, np.asarray(x), group=group)
    return np.stack(parts)


def load_dataset_sharded(filename: str, config: Config,
                         rank: Optional[int] = None,
                         world: Optional[int] = None, sample_gather=None,
                         count_gather=None):
    """Per-rank sharded dataset loading (the JAX package's
    ``load_dataset_sharded``; reference: the distributed loader,
    src/io/dataset_loader.cpp:182,951: each rank reads its row partition,
    bin mappers are found from a globally gathered sample so every rank
    holds the same binning, and no rank holds the whole matrix).

    - ``rank`` / ``world`` default to the process group's
      (``parallel.distributed.current_group``; 0 and 1 without one).
    - Each rank streams the file (``io_native.parse_dense_range``, one
      chunk at a time) and keeps only rows ``[rank * N / world, (rank + 1)
      * N / world)``, or every row with ``pre_partition`` (the file is the
      rank's partition).
    - Bin finding: every rank reservoir-samples its slice at
      ``data_random_seed + rank`` into a slot of ``bin_construct_sample_cnt
      // world`` rows; the samples are gathered (``sample_gather``, by
      default ``dist.all_gather_object`` over the group) and every rank
      derives the same BinMappers from the same global sample. The per-rank
      (rows, samples held) counts (``count_gather``, the same default)
      drop each slot's padding and, with ``pre_partition``, weight each
      rank's slot by its row share.
    - Returns a BinnedDataset of the local rows only, with ``shard_info =
      (rank, world, n_total)``; the distributed learners pad each rank's
      rows to ``round_up(n_total, D) / world``.
    """
    import torch.distributed as dist

    from .dataset import Metadata, _extract_binned, construct_dataset
    from .parallel.distributed import current_group

    group = current_group()
    if rank is None:
        rank = dist.get_rank(group) if group is not None else 0
    if world is None:
        world = dist.get_world_size(group) if group is not None else 1
    fmt, header_names, skip, head = _read_head(filename, config)
    if fmt == "libsvm":
        Log.fatal("sharded loading supports dense text formats")
    sep = "," if fmt == "csv" else "\t"
    data_line = next((ln for ln in head[skip:] if ln and ln.strip()), None)
    if data_line is None:
        Log.fatal("Data file %s has no data rows", filename)
    ncol = data_line.rstrip("\r\n").count(sep) + 1
    label_idx, weight_idx, group_idx, used_cols = _column_roles(
        config, header_names, ncol)
    feature_names = [header_names[c] for c in used_cols] if header_names \
        else None

    if config.pre_partition:
        # the file IS this rank's partition (reference: config.h
        # pre_partition): keep every row, no counting pass
        n_total = -1
        r0, r1 = 0, np.iinfo(np.int64).max
    else:
        # pass 1: count data rows (stream, no parsing)
        n_total = 0
        with open(filename) as f:
            for _ in range(skip):
                f.readline()
            for line in f:
                if line.strip():
                    n_total += 1
        r0 = rank * n_total // world
        r1 = (rank + 1) * n_total // world

    # pass 2: stream; keep only [r0, r1); reservoir-sample the local slice
    # into a uniform budget // world slot (equal gather shapes on every
    # rank; the slot's padding is dropped after the gather)
    target = max(2, int(config.bin_construct_sample_cnt) // world)
    rng = np.random.RandomState(config.data_random_seed + rank)
    sample = np.empty((target, len(used_cols)), np.float64)
    n_samp = 0
    locals_X, locals_y, locals_w, locals_g = [], [], [], []
    seen = 0
    for chunk in dense_chunks(filename, skip, sep, ncol, 100_000):
        c0, c1 = seen, seen + len(chunk)
        seen = c1
        lo, hi = max(r0, c0), min(r1, c1)
        if lo < hi:
            part = chunk[lo - c0:hi - c0]
            locals_X.append(part[:, used_cols])
            if 0 <= label_idx < ncol:
                locals_y.append(part[:, label_idx].copy())
            if weight_idx >= 0:
                locals_w.append(part[:, weight_idx].copy())
            if group_idx >= 0:
                locals_g.append(part[:, group_idx].copy())
            Xc = part[:, used_cols]
            m = len(Xc)
            fill = min(max(target - n_samp, 0), m)
            if fill:
                sample[n_samp:n_samp + fill] = Xc[:fill]
            if m > fill:
                idx = np.arange(n_samp + fill, n_samp + m)
                r = (rng.random_sample(m - fill) * (idx + 1)).astype(np.int64)
                keep = r < target
                sample[r[keep]] = Xc[fill:][keep]
            n_samp += m
    X_local = np.concatenate(locals_X) if locals_X else \
        np.zeros((0, len(used_cols)))
    if config.pre_partition:
        n_total = seen  # pass 2 counted the local file; world > 1 gathers
    local_sample = sample[:min(target, n_samp)]
    valid_rows = None
    shard_rows = None
    in_group = group is not None and dist.get_world_size(group) == world
    can_gather_stats = count_gather is not None or in_group
    if world > 1 and config.pre_partition and not can_gather_stats:
        Log.fatal("pre_partition sharded loading needs per-rank stats: run "
                  "in a process group of %d ranks or supply count_gather",
                  world)
    if world > 1 and len(local_sample) == 0:
        Log.fatal("rank %d: no data rows in %s", rank, filename)
    default_gather = sample_gather is None
    if world > 1 and can_gather_stats:
        if count_gather is None:
            count_gather = _group_allgather
        # per-rank (rows, samples held): the proportional sample weighting
        # and (pre_partition) the shard capacity
        stats = np.asarray(count_gather(np.asarray(
            [float(seen if config.pre_partition else len(X_local)),
             float(len(local_sample))]))).reshape(world, 2)
        shard_rows = stats[:, 0]
        held = stats[:, 1].astype(np.int64)
        if config.pre_partition:
            # unequal shards: each rank's slot weighted by its row share;
            # ranks clipped at their held sample hand their unused share
            # to the others (water-fill)
            share = shard_rows / max(shard_rows.sum(), 1.0)
            budget = target * world
            alloc = np.minimum(held, np.maximum(2, np.round(budget * share)))
            for _ in range(3):
                leftover = budget - alloc.sum()
                room = held - alloc
                open_share = share * (room > 0)
                if leftover <= 0 or open_share.sum() <= 0:
                    break
                alloc = np.minimum(held, alloc + np.round(
                    leftover * open_share / open_share.sum()))
            valid_rows = alloc.astype(np.int64)
        else:
            valid_rows = held
    if world > 1 and len(local_sample) < target:
        # equal gather shapes: pad the slot by cycling local rows; the
        # default gather slices the pad rows off with the stats
        if not default_gather:
            Log.warning(
                "rank %d pads its quantile sample %d -> %d rows; the "
                "custom sample_gather sees duplicated rows (trim with the "
                "per-rank counts from count_gather)", rank,
                len(local_sample), target)
        reps = -(-target // len(local_sample))
        local_sample = np.tile(local_sample, (reps, 1))[:target]

    if sample_gather is None:
        if world > 1:
            def sample_gather(x):
                return _group_allgather(x).reshape(-1, x.shape[1])
        else:
            def sample_gather(x):
                return x
    global_sample = np.asarray(sample_gather(local_sample))
    if valid_rows is not None and default_gather:
        # drop each rank's slot padding (every rank slices the same
        # gathered stats alike); only the default gather guarantees the
        # (world, target) slot layout
        if global_sample.shape[0] != world * target:
            Log.fatal("the sample gather returned %d rows, expected %d",
                      global_sample.shape[0], world * target)
        blocks = global_sample.reshape(world, target, -1)
        global_sample = np.concatenate(
            [blocks[r, :valid_rows[r]] for r in range(world)])

    # the same structure on every rank from the same global sample
    ds = construct_dataset(global_sample, config,
                           feature_names=feature_names,
                           categorical_feature=None)
    group_sizes = None
    if locals_g:
        # per-row query ids: the local slice must start and end on query
        # edges for correct ranking
        group_sizes = _group_sizes(np.concatenate(locals_g))
    elif os.path.exists(filename + ".query"):
        # pre-partitioned files own complete query sets, so their sidecars
        # apply verbatim; the rank row-split cannot honour sidecars
        if world > 1 and not config.pre_partition:
            Log.fatal("sharded loading with a .query sidecar is not "
                      "supported (query sizes cannot be split per rank); "
                      "use a group_column instead")
        group_sizes = np.loadtxt(filename + ".query", dtype=np.int64).ravel()
    wfile = filename + ".weight"
    if not locals_w and os.path.exists(wfile):
        if world > 1 and not config.pre_partition:
            Log.fatal("sharded loading with a .weight sidecar is not "
                      "supported; use a weight_column instead")
        locals_w = [np.loadtxt(wfile, dtype=np.float64).ravel()]
    ds.num_data = len(X_local)
    ds.metadata = Metadata(
        len(X_local),
        label=np.concatenate(locals_y) if locals_y else None,
        weight=np.concatenate(locals_w) if locals_w else None,
        group=group_sizes)
    ds.binned = _extract_binned(X_local, ds,
                                nthreads=int(config.num_threads))
    ds.raw_numeric = None
    if config.pre_partition and world > 1:
        # unequal pre-partitioned files publish a capacity of world *
        # max(local rows); the learners pad every rank's block to it (pad
        # rows carry zero gradients, hessians and counts)
        n_total = int(shard_rows.max()) * world
    ds.shard_info = (int(rank), int(world), int(n_total))
    return ds
