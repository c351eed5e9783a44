"""On-disk readers for the real datasets (used when data is mounted).

The build environment has no network egress, so these readers parse the
standard already-downloaded layouts; configs fall back to the synthetic
generators otherwise. Location: ``$DATASET_LOC`` (same env key as the
reference, ``experiments/utils.py:20-27``; defaults to ~/datasets).

Formats:
- OGB node-prop (ogbn-arxiv / ogbn-mag): ``<root>/<name>/raw/*.csv.gz``
  (edge, node-feat, node-label) + ``split/<split_type>/*.csv.gz``.
- OGB graph-prop (ogbg-molhiv / ogbg-code2): ``raw/`` csv.gz with
  num-node-list / num-edge-list / edge / node-feat (+ code2 extras:
  node_is_attributed, node_dfs_order, node_depth) and scaffold/project
  splits.
- ZINC (PyG raw): ``{train,val,test}.pickle`` (torch-pickled dicts) +
  subset index files.

code2 preprocessing reproduces the reference pipeline
(``experiments/code/utils.py``): top-5000 vocab from train targets (+UNK,
+EOS), AST edge augmentation (inverse-AST + next-token + inverse-next-token;
models consume only connectivity, SURVEY §2.1), 5-token target encoding.
"""

from __future__ import annotations

import gzip
import os
import pickle
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from egc_tpu.graph.transforms import to_undirected_np


def data_location() -> Path:
    return Path(os.environ.get("DATASET_LOC", str(Path.home() / "datasets")))


def _parse_csv_bytes(data: bytes, dtype) -> np.ndarray:
    """Decompressed CSV text -> [rows, cols] array. Fast paths: the native
    multithreaded parser (egc_tpu.native.fastcsv), then pandas; numpy
    loadtxt as the last resort. np.loadtxt was the round-2 bottleneck
    (minutes at ogbn-arxiv scale, hours at ogbn-mag scale — VERDICT r2)."""
    head = data.split(b"\n", 1)[0].strip()
    cols = head.count(b",") + 1 if head else 1
    # per-ROW structure check (native, multithreaded): every non-empty row
    # must have exactly `cols` fields, with the parser's separator set —
    # offsetting malformed rows (cols+1 here, cols-1 there) and embedded
    # spaces inside a field both fail here and fall through to pandas,
    # which raises, instead of silently misaligning the reshape
    # (r3/r4 review findings).
    from egc_tpu.native import csv_rows_consistent, parse_csv_bytes
    rows = csv_rows_consistent(data, cols)
    if rows is not None and rows > 0:
        flat = parse_csv_bytes(data, dtype)
        if flat is not None and flat.size == rows * cols:
            return flat.reshape(rows, cols)

    import io
    try:
        import pandas as pd
        df = pd.read_csv(io.BytesIO(data), header=None, dtype=dtype)
        return np.ascontiguousarray(df.to_numpy())
    except ImportError:
        return np.loadtxt(io.StringIO(data.decode()), delimiter=",",
                          dtype=dtype, ndmin=2)


def _import_torch(what: str):
    """torch, which only the real-dataset readers of torch-format files
    need (the main path and the synthetic datasets do not)."""
    try:
        import torch
    except ImportError as e:
        raise ImportError(f"reading {what} needs torch, which is not "
                          f"installed; the synthetic datasets (the "
                          f"default, --synthetic) do not") from e
    return torch


def _read_csv_gz(path: Path, dtype=np.int64) -> np.ndarray:
    """Read a (gzipped) numeric CSV with an ``.npy`` sidecar cache: the
    first parse writes ``<file>.npy`` next to the source (best-effort) and
    later loads are instant (the OGB-processed-cache role,
    reference mag/configs.py:77-88 via ogb's processed/ dir)."""
    path = Path(path)
    cache = Path(str(path) + ".npy")
    if cache.exists() and cache.stat().st_mtime >= path.stat().st_mtime:
        arr = np.load(cache, allow_pickle=False)
        if arr.dtype == np.dtype(dtype):
            return arr
    if path.suffix == ".gz":
        with gzip.open(path, "rb") as f:
            data = f.read()
    else:
        data = path.read_bytes()
    arr = _parse_csv_bytes(data, dtype)
    del data
    try:
        # atomic: concurrent readers (parallel-search workers, shared
        # mounts) must never np.load a half-written cache. The tmp name
        # ends in .npy so np.save does not append another suffix.
        tmp = cache.with_name(f"{cache.name}.tmp{os.getpid()}.npy")
        np.save(tmp, arr)
        os.replace(tmp, cache)
    except OSError:
        pass  # read-only dataset mounts
    return arr


def have_dataset(subdir: str) -> bool:
    return (data_location() / subdir).exists()


# ---------------------------------------------------------------------------
# OGB node property prediction (arxiv / mag homogeneous)
# ---------------------------------------------------------------------------

def load_ogbn_arxiv(root: Optional[Path] = None) -> Dict:
    root = (root or data_location()) / "ogbn_arxiv"
    raw = root / "raw"
    edges = _read_csv_gz(raw / "edge.csv.gz")            # [E, 2] directed
    x = _read_csv_gz(raw / "node-feat.csv.gz", np.float32)
    y = _read_csv_gz(raw / "node-label.csv.gz").reshape(-1).astype(np.int32)
    n = x.shape[0]
    # reference applies to_undirected (arxiv/configs.py:100)
    s, r = to_undirected_np(edges[:, 0].astype(np.int32),
                            edges[:, 1].astype(np.int32), n)
    split_dir = root / "split" / "time"
    splits = {k: _read_csv_gz(split_dir / f"{v}.csv.gz").reshape(-1)
              for k, v in (("train", "train"), ("val", "valid"),
                           ("test", "test"))}
    return {"x": x, "y": y, "senders": s, "receivers": r,
            "train_idx": splits["train"], "val_idx": splits["val"],
            "test_idx": splits["test"], "num_classes": int(y.max()) + 1}


def load_ogbn_mag_homogeneous(root: Optional[Path] = None) -> Dict:
    """paper-cites-paper subgraph, symmetrized (reference
    mag/configs.py:77-88)."""
    root = (root or data_location()) / "ogbn_mag"
    raw = root / "raw"
    x = _read_csv_gz(raw / "node-feat" / "paper" / "node-feat.csv.gz",
                     np.float32)
    y = _read_csv_gz(raw / "node-label" / "paper" / "node-label.csv.gz"
                     ).reshape(-1).astype(np.int32)
    edges = _read_csv_gz(
        raw / "relations" / "paper___cites___paper" / "edge.csv.gz")
    n = x.shape[0]
    s, r = to_undirected_np(edges[:, 0].astype(np.int32),
                            edges[:, 1].astype(np.int32), n)
    split_dir = root / "split" / "time" / "paper"
    splits = {k: _read_csv_gz(split_dir / f"{v}.csv.gz").reshape(-1)
              for k, v in (("train", "train"), ("val", "valid"),
                           ("test", "test"))}
    return {"x": x, "y": y, "senders": s, "receivers": r,
            "train_idx": splits["train"], "val_idx": splits["val"],
            "test_idx": splits["test"], "num_classes": int(y.max()) + 1}


# ---------------------------------------------------------------------------
# OGB graph property prediction (molhiv / code2)
# ---------------------------------------------------------------------------

def _load_ogbg_raw(root: Path):
    raw = root / "raw"
    num_nodes = _read_csv_gz(raw / "num-node-list.csv.gz").reshape(-1)
    num_edges = _read_csv_gz(raw / "num-edge-list.csv.gz").reshape(-1)
    edges = _read_csv_gz(raw / "edge.csv.gz")
    node_feat = _read_csv_gz(raw / "node-feat.csv.gz")
    node_off = np.concatenate([[0], np.cumsum(num_nodes)])
    edge_off = np.concatenate([[0], np.cumsum(num_edges)])
    return raw, num_nodes, num_edges, edges, node_feat, node_off, edge_off


def _load_split(root: Path, split_type: str) -> Dict[str, np.ndarray]:
    split_dir = root / "split" / split_type
    return {k: _read_csv_gz(split_dir / f"{v}.csv.gz").reshape(-1)
            for k, v in (("train", "train"), ("val", "valid"),
                         ("test", "test"))}


def load_ogbg_molhiv(root: Optional[Path] = None) -> Dict[str, List[dict]]:
    root = (root or data_location()) / "ogbg_molhiv"
    raw, num_nodes, num_edges, edges, node_feat, node_off, edge_off = \
        _load_ogbg_raw(root)
    labels = _read_csv_gz(raw / "graph-label.csv.gz").reshape(-1)
    graphs = []
    for i in range(len(num_nodes)):
        ns, ne = node_off[i], node_off[i + 1]
        es, ee = edge_off[i], edge_off[i + 1]
        graphs.append({
            "nodes": node_feat[ns:ne].astype(np.int32),
            "senders": edges[es:ee, 0].astype(np.int32),
            "receivers": edges[es:ee, 1].astype(np.int32),
            "y": np.array([labels[i]], np.int32),
        })
    split = _load_split(root, "scaffold")
    return {k: [graphs[i] for i in idx] for k, idx in
            (("train", split["train"]), ("val", split["val"]),
             ("test", split["test"]))}


def augment_ast_edges_np(senders, receivers, is_attributed):
    """Reference ``augment_edge`` (code/utils.py:74-145), connectivity only:
    AST + inverse-AST + next-token + inverse-next-token edges (nodes are in
    DFS order)."""
    att = np.where(is_attributed.reshape(-1) == 1)[0].astype(np.int32)
    nt_s, nt_r = att[:-1], att[1:]
    s = np.concatenate([senders, receivers, nt_s, nt_r])
    r = np.concatenate([receivers, senders, nt_r, nt_s])
    return s.astype(np.int32), r.astype(np.int32)


def build_vocab(train_seqs: List[List[str]], num_vocab: int = 5000):
    """Reference ``get_vocab_mapping`` (code/utils.py:31-71): top-N by count
    with first-appearance stable order, + __UNK__, + __EOS__."""
    vocab_cnt: Dict[str, int] = {}
    vocab_list: List[str] = []
    for seq in train_seqs:
        for w in seq:
            if w in vocab_cnt:
                vocab_cnt[w] += 1
            else:
                vocab_cnt[w] = 1
                vocab_list.append(w)
    cnt = np.array([vocab_cnt[w] for w in vocab_list])
    top = np.argsort(-cnt, kind="stable")[:num_vocab]
    idx2vocab = [vocab_list[i] for i in top] + ["__UNK__", "__EOS__"]
    vocab2idx = {w: i for i, w in enumerate(idx2vocab)}
    return vocab2idx, idx2vocab


def encode_seq(seq: List[str], vocab2idx, seq_len: int = 5) -> np.ndarray:
    unk, eos = vocab2idx["__UNK__"], vocab2idx["__EOS__"]
    out = seq[:seq_len] + ["__EOS__"] * max(0, seq_len - len(seq))
    return np.array([vocab2idx.get(w, unk) for w in out], np.int32)


def decode_arr(arr, idx2vocab) -> List[str]:
    """Reference ``decode_arr_to_seq``: cut at the first __EOS__."""
    eos = len(idx2vocab) - 1
    out = []
    for t in arr:
        if int(t) == eos:
            break
        out.append(idx2vocab[int(t)])
    return out


def load_ogbg_code2(root: Optional[Path] = None, num_vocab: int = 5000,
                    seq_len: int = 5) -> Dict:
    root = (root or data_location()) / "ogbg_code2"
    raw, num_nodes, num_edges, edges, node_feat, node_off, edge_off = \
        _load_ogbg_raw(root)
    is_att = _read_csv_gz(raw / "node_is_attributed.csv.gz").reshape(-1)
    depth = _read_csv_gz(raw / "node_depth.csv.gz").reshape(-1)
    # target sequences: one method name per graph, '|'-joined subtokens
    with gzip.open(raw / "graph-label.csv.gz", "rt") as f:
        seqs = [line.strip().split(",") for line in f]
    split = _load_split(root, "project")
    vocab2idx, idx2vocab = build_vocab(
        [seqs[i] for i in split["train"]], num_vocab)

    graphs = []
    for i in range(len(num_nodes)):
        ns, ne = node_off[i], node_off[i + 1]
        es, ee = edge_off[i], edge_off[i + 1]
        s, r = augment_ast_edges_np(
            edges[es:ee, 0].astype(np.int32) ,
            edges[es:ee, 1].astype(np.int32), is_att[ns:ne])
        nodes = np.stack([
            node_feat[ns:ne, 0], node_feat[ns:ne, 1],
            np.minimum(depth[ns:ne], 20)], axis=1).astype(np.int32)
        graphs.append({
            "nodes": nodes, "senders": s, "receivers": r,
            "y": encode_seq(seqs[i], vocab2idx, seq_len),
            "y_raw": seqs[i],
        })
    return {
        "splits": {k: [graphs[i] for i in idx] for k, idx in
                   (("train", split["train"]), ("val", split["val"]),
                    ("test", split["test"]))},
        "vocab2idx": vocab2idx, "idx2vocab": idx2vocab,
    }


# ---------------------------------------------------------------------------
# CIFAR10 superpixels (GNNBenchmarkDataset raw layout)
# ---------------------------------------------------------------------------

def load_cifar10_superpixels(root: Optional[Path] = None
                             ) -> Dict[str, List[dict]]:
    """CIFAR10 superpixel graphs (reference ``experiments/cifar/configs.py:
    37-45``: ``GNNBenchmarkDataset(root, "CIFAR10", split=...)`` with a
    transform concatenating ``pos`` onto ``x`` -> 5 input features).

    Layout: ``<root>/CIFAR10/raw/CIFAR10_{train,val,test}.pt`` — torch
    files, each a list of per-graph dicts/Data-likes with ``x`` [N,3]
    mean-color, ``pos`` [N,2], ``edge_index`` [2,E], ``y`` scalar class.
    """
    torch = _import_torch("CIFAR10 superpixel .pt files")

    root = (root or data_location()) / "CIFAR10"
    raw = root / "raw"
    out: Dict[str, List[dict]] = {}
    for split, fname in (("train", "CIFAR10_train.pt"),
                         ("val", "CIFAR10_val.pt"),
                         ("test", "CIFAR10_test.pt")):
        items = torch.load(raw / fname, map_location="cpu",
                           weights_only=False)
        graphs = []
        for it in items:
            get = it.get if isinstance(it, dict) else \
                (lambda k, _it=it: getattr(_it, k, None))
            x = np.asarray(get("x"), np.float32)
            pos = np.asarray(get("pos"), np.float32)
            ei = np.asarray(get("edge_index"), np.int64)
            y = np.asarray(get("y")).reshape(-1)[:1].astype(np.int32)
            graphs.append({
                # cat([x, pos], -1): reference cifar/configs.py:37-39
                "nodes": np.concatenate([x, pos], axis=1),
                "senders": ei[0].astype(np.int32),
                "receivers": ei[1].astype(np.int32),
                "y": y,
            })
        out[split] = graphs
    return out


# ---------------------------------------------------------------------------
# ZINC (PyG raw pickles)
# ---------------------------------------------------------------------------

def load_zinc(root: Optional[Path] = None, subset: bool = True
              ) -> Dict[str, List[dict]]:
    # registers the tensor classes the pickles reference
    _import_torch("ZINC raw pickles")

    root = (root or data_location()) / "ZINC"
    raw = root / "raw"
    out = {}
    for split, fname in (("train", "train.pickle"), ("val", "val.pickle"),
                         ("test", "test.pickle")):
        with open(raw / fname, "rb") as f:
            mols = pickle.load(f)
        if subset:
            idx = [int(line) for line in
                   (raw / f"{split}.index").read_text().split(",")]
            mols = [mols[i] for i in idx]
        graphs = []
        for mol in mols:
            types = np.asarray(mol["atom_type"], np.int32).reshape(-1, 1)
            adj = np.asarray(mol["bond_type"])
            s, r = np.nonzero(adj)
            graphs.append({
                "nodes": types,
                "senders": s.astype(np.int32),
                "receivers": r.astype(np.int32),
                "y": np.array([float(mol["logP_SA_cycle_normalized"])],
                              np.float32),
            })
        out[split] = graphs
    return out


def load_ogbn_mag_hetero(root: Optional[Path] = None) -> Dict:
    """Full heterogeneous ogbn-mag (reference ``experiments/rmag/configs.py``):
    paper features + 3 featureless node types, the 4 raw relations plus
    reverse edges (same-type relations symmetrized — reverse merges into
    the same relation key like the reference's rmag prep)."""
    from egc_tpu.graph.hetero import rel_key

    root = (root or data_location()) / "ogbn_mag"
    raw = root / "raw"
    x_paper = _read_csv_gz(raw / "node-feat" / "paper" / "node-feat.csv.gz",
                           np.float32)
    y_paper = _read_csv_gz(raw / "node-label" / "paper" / "node-label.csv.gz"
                           ).reshape(-1).astype(np.int32)
    counts = {}
    import json as _json
    nodes_file = raw / "num-node-dict.json"
    if nodes_file.exists():
        counts = {k: int(v) for k, v in
                  _json.loads(nodes_file.read_text()).items()}
    rels = {
        ("author", "affiliated_with", "institution"):
            "author___affiliated_with___institution",
        ("author", "writes", "paper"): "author___writes___paper",
        ("paper", "cites", "paper"): "paper___cites___paper",
        ("paper", "has_topic", "field_of_study"):
            "paper___has_topic___field_of_study",
    }
    edges = {}
    max_id: Dict[str, int] = {}
    for (src, rel, dst), dirname in rels.items():
        e = _read_csv_gz(raw / "relations" / dirname / "edge.csv.gz")
        s, r = e[:, 0].astype(np.int32), e[:, 1].astype(np.int32)
        max_id[src] = max(max_id.get(src, 0), int(s.max()) + 1)
        max_id[dst] = max(max_id.get(dst, 0), int(r.max()) + 1)
        if src == dst:
            # symmetrize same-type relations (reference rmag prep)
            edges[rel_key(src, rel, dst)] = (
                np.concatenate([s, r]), np.concatenate([r, s]))
        else:
            edges[rel_key(src, rel, dst)] = (s, r)
            edges[rel_key(dst, "to", src)] = (r, s)

    n_of = {t: counts.get(t, max_id.get(t, 1)) for t in
            ("paper", "author", "institution", "field_of_study")}
    n_of["paper"] = max(n_of["paper"], x_paper.shape[0])
    nodes = {"paper": x_paper}
    for t in ("author", "institution", "field_of_study"):
        nodes[t] = np.zeros((n_of[t], 0), np.float32)

    split_dir = root / "split" / "time" / "paper"
    splits = {k: _read_csv_gz(split_dir / f"{v}.csv.gz").reshape(-1)
              for k, v in (("train", "train"), ("val", "valid"),
                           ("test", "test"))}
    return {"nodes": nodes, "edges": edges, "y": y_paper,
            "train_idx": splits["train"], "val_idx": splits["val"],
            "test_idx": splits["test"],
            "num_classes": int(y_paper.max()) + 1}
