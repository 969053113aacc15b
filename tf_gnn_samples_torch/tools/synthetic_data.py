"""Synthetic PPI, Planetoid and VarMisuse data in the on-disk formats the
task loaders read (tasks/ppi.py, tasks/citation.py, tasks/varmisuse.py),
made from a seed.

The real datasets are not in the repository. These files have the
published sizes and random content, so they exercise the loaders, the
packing and the kernels at real shapes, but the F1 and accuracy they give
are smoke values only (the labels are random).

* PPI (Zitnik & Leskovec 2017, the DGL split the reference trains on): 24
  graphs of 1,700-3,099 nodes, 28 forward edges a node drawn uniformly
  within the graph, 50 features, 121 labels each set with probability 0.4,
  folds of 20 / 2 / 2 graphs; written as {fold}_graph.json ({"links":
  [{"source", "target"}]}) and {fold}_{feats,labels,graph_id}.npy.
* Planetoid, at Pubmed's published size (Sen et al. 2008; the split of
  Yang et al. 2016): 19,717 nodes, 44,338 undirected citations (each
  listed once, under one of its ends, in the graph dict), 500 sparse
  row-positive features (a tenth of the entries set), 3 classes, the
  first 60 nodes the train fold, the next 500 the valid fold and the last
  1,000 the test fold (their index file in a random order); written as
  ind.{name}.{x,y,tx,ty,allx,ally,graph,test.index}.
* VarMisuse (Allamanis et al. 2018, ICLR; the raw program-graph schema
  the loader parses): graphs of 1,600-2,599 nodes, 45 % of them camelCase
  identifiers (two words and a digit), 25 % single words, the rest syntax
  tokens; the ten named edge types at the densities below a node (Child a
  tree over the nodes; the loader adds the backward types, UsesSubtoken
  and the self loops); a slot and five candidates, the first one correct,
  all drawn at random (so the accuracy is a smoke value); folds of 150 /
  20 / 20 graphs in graphs-{train,valid,test}/, chunks of 50 samples as
  .jsonl.gz, so that the streaming loader runs. The same seed writes the
  samples bench.py's make_synthetic_varmisuse writes.

Usage:
    python -m tf_gnn_samples_torch.tools.synthetic_data ppi DIR [--seed S]
        [--graphs TRAIN VALID TEST] [--min-nodes N] [--max-nodes N]
    python -m tf_gnn_samples_torch.tools.synthetic_data planetoid DIR
        [--seed S] [--dataset pubmed] [--nodes N] [--edges E]
        [--features F] [--classes C] [--train N] [--test N]
    python -m tf_gnn_samples_torch.tools.synthetic_data varmisuse DIR
        [--seed S] [--graphs TRAIN VALID TEST] [--min-nodes N]
        [--max-nodes N]
"""

import argparse
import gzip
import json
import os
import pickle
from typing import Dict, Optional

import numpy as np

PPI_FOLDS = {"train": 20, "valid": 2, "test": 2}


def _write_links(path: str, src: np.ndarray, tgt: np.ndarray) -> None:
    """{"links": [{"source": s, "target": t}, ...]} without building one
    dict a link."""
    with open(path, "w") as f:
        f.write('{"links": [')
        f.write(", ".join('{"source": %d, "target": %d}' % st
                          for st in zip(src.tolist(), tgt.tolist())))
        f.write("]}")


def make_synthetic_ppi(data_dir: str, seed: int = 0,
                       folds: Optional[Dict[str, int]] = None,
                       min_nodes: int = 1700, max_nodes: int = 3100,
                       fwd_edges_per_node: int = 28) -> str:
    """Write PPI-format folds (default 20 / 2 / 2 graphs of PPI's size)
    into `data_dir`; returns it."""
    rng = np.random.RandomState(seed)
    os.makedirs(data_dir, exist_ok=True)
    for fold, num_graphs in (folds or PPI_FOLDS).items():
        feats, labels, gids, srcs, tgts = [], [], [], [], []
        offset = 0
        for g in range(num_graphs):
            n = int(rng.randint(min_nodes, max_nodes))
            e = n * fwd_edges_per_node
            srcs.append(rng.randint(0, n, size=e) + offset)
            tgts.append(rng.randint(0, n, size=e) + offset)
            feats.append(rng.randn(n, 50).astype(np.float32))
            labels.append((rng.rand(n, 121) < 0.4).astype(np.float32))
            gids.append(np.full(n, g, dtype=np.int64))
            offset += n
        np.save(os.path.join(data_dir, "%s_feats.npy" % fold),
                np.concatenate(feats))
        np.save(os.path.join(data_dir, "%s_labels.npy" % fold),
                np.concatenate(labels))
        np.save(os.path.join(data_dir, "%s_graph_id.npy" % fold),
                np.concatenate(gids))
        _write_links(os.path.join(data_dir, "%s_graph.json" % fold),
                     np.concatenate(srcs), np.concatenate(tgts))
    return data_dir


def make_synthetic_planetoid(data_dir: str, seed: int = 0,
                             dataset: str = "pubmed", num_nodes: int = 19717,
                             num_edges: int = 44338, num_features: int = 500,
                             num_classes: int = 3, num_train: int = 60,
                             num_test: int = 1000) -> str:
    """Write Planetoid pickles of the given size (default Pubmed's) as
    `ind.{dataset}.*` into `data_dir`; returns it. The train fold is the
    first `num_train` nodes, the valid fold the next 500 (the loader's
    fixed split), the test fold the last `num_test`."""
    import scipy.sparse as sp

    if num_train + 500 + num_test > num_nodes:
        raise ValueError("%d nodes cannot hold %d train, 500 valid and %d "
                         "test nodes" % (num_nodes, num_train, num_test))
    rng = np.random.RandomState(seed)
    os.makedirs(data_dir, exist_ok=True)
    n = num_nodes
    x_all = sp.random(n, num_features, density=0.1, format="csr",
                      random_state=rng, dtype=np.float32)
    y_all = np.eye(num_classes)[rng.randint(0, num_classes, n)]
    # Distinct undirected pairs, no self citations.
    pairs = set()
    while len(pairs) < num_edges:
        a = rng.randint(0, n, num_edges)
        b = rng.randint(0, n, num_edges)
        for u, v in zip(a.tolist(), b.tolist()):
            if u != v and len(pairs) < num_edges:
                pairs.add((min(u, v), max(u, v)))
    graph = {v: [] for v in range(n)}
    for u, v in sorted(pairs):
        if rng.rand() < 0.5:
            u, v = v, u
        graph[u].append(v)
    test_start = n - num_test
    objs = {
        "x": x_all[:num_train], "y": y_all[:num_train],
        "tx": x_all[test_start:], "ty": y_all[test_start:],
        "allx": x_all[:test_start], "ally": y_all[:test_start],
        "graph": graph,
    }
    for name, obj in objs.items():
        with open(os.path.join(data_dir, "ind.%s.%s" % (dataset, name)),
                  "wb") as f:
            pickle.dump(obj, f, pickle.HIGHEST_PROTOCOL)
    with open(os.path.join(data_dir, "ind.%s.test.index" % dataset),
              "w") as f:
        f.write("\n".join(str(i) for i in
                          rng.permutation(np.arange(test_start, n))))
    return data_dir


VARMISUSE_FOLDS = {"train": 150, "valid": 20, "test": 20}
VARMISUSE_WORDS = ["foo", "bar", "count", "index", "value", "item", "node",
                   "temp", "result", "buffer", "state", "data", "ptr", "size"]
# Edges a node of each named type (Child: one a node, a tree).
VARMISUSE_DENSITIES = {
    "Child": 1.0, "NextToken": 0.6, "LastUse": 0.25, "LastWrite": 0.2,
    "LastLexicalUse": 0.15, "ComputedFrom": 0.1, "GuardedByNegation": 0.05,
    "GuardedBy": 0.05, "FormalArgName": 0.05, "ReturnsTo": 0.03,
}


def _varmisuse_sample(rng, min_nodes: int, max_nodes: int):
    n = int(rng.randint(min_nodes, max_nodes))
    labels = {}
    for i in range(n):
        r = rng.rand()
        if r < 0.45:  # an identifier: two camelCase words and a digit
            a, b = rng.choice(VARMISUSE_WORDS, 2)
            labels[str(i)] = a + b.capitalize() + str(rng.randint(10))
        elif r < 0.7:
            labels[str(i)] = rng.choice(VARMISUSE_WORDS)
        else:  # a syntax token
            labels[str(i)] = rng.choice(["(", ")", "{", "}", "=", ";"])
    edges = {}
    for name, dens in VARMISUSE_DENSITIES.items():
        e = max(int(n * dens), 1)
        if name == "Child":  # a tree: each node's parent precedes it
            dst = np.arange(1, n)
            src = (rng.rand(n - 1) * np.arange(1, n)).astype(np.int64)
            pairs = np.stack([src, dst], axis=1)
        else:
            pairs = rng.randint(0, n, size=(e, 2))
        edges[name] = [[int(a), int(b)] for a, b in pairs]
    slot = int(rng.randint(0, n))
    cand_ids = rng.choice(n, size=5, replace=False)
    cands = [{"SymbolDummyNode": int(c), "IsCorrect": i == 0}
             for i, c in enumerate(cand_ids)]
    return {
        "ContextGraph": {"NodeLabels": labels, "Edges": edges},
        "SlotDummyNode": slot,
        "SymbolCandidates": cands,
    }


def make_synthetic_varmisuse(data_dir: str, seed: int = 0,
                             folds: Optional[Dict[str, int]] = None,
                             min_nodes: int = 1600, max_nodes: int = 2600,
                             per_chunk: int = 50) -> str:
    """Write VarMisuse raw shards (default 150 / 20 / 20 graphs of
    1,600-2,599 nodes) as graphs-{fold}/chunk_NNNN.jsonl.gz into
    `data_dir`; returns it."""
    rng = np.random.RandomState(seed)
    for fold, count in (folds or VARMISUSE_FOLDS).items():
        fold_dir = os.path.join(data_dir, "graphs-%s" % fold)
        os.makedirs(fold_dir, exist_ok=True)
        for c in range(0, count, per_chunk):
            path = os.path.join(fold_dir, "chunk_%04d.jsonl.gz" % c)
            with gzip.open(path, "wt", encoding="utf-8") as f:
                for _ in range(min(per_chunk, count - c)):
                    f.write(json.dumps(_varmisuse_sample(
                        rng, min_nodes, max_nodes)) + "\n")
    return data_dir


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("KIND", choices=("ppi", "planetoid", "varmisuse"))
    parser.add_argument("DIR")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--graphs", type=int, nargs=3,
                        metavar=("TRAIN", "VALID", "TEST"), default=None,
                        help="graphs a fold (PPI 20 2 2, VarMisuse 150 20 "
                             "20)")
    parser.add_argument("--min-nodes", type=int, default=None,
                        help="PPI 1700, VarMisuse 1600")
    parser.add_argument("--max-nodes", type=int, default=None,
                        help="exclusive bound of a graph's node count (PPI "
                             "3100, VarMisuse 2600)")
    parser.add_argument("--dataset", default="pubmed")
    parser.add_argument("--nodes", type=int, default=19717)
    parser.add_argument("--edges", type=int, default=44338)
    parser.add_argument("--features", type=int, default=500)
    parser.add_argument("--classes", type=int, default=3)
    parser.add_argument("--train", type=int, default=60)
    parser.add_argument("--test", type=int, default=1000)
    args = parser.parse_args(argv)
    folds = (dict(zip(("train", "valid", "test"), args.graphs))
             if args.graphs else None)
    if args.KIND == "ppi":
        make_synthetic_ppi(args.DIR, args.seed, folds,
                           args.min_nodes or 1700, args.max_nodes or 3100)
    elif args.KIND == "varmisuse":
        make_synthetic_varmisuse(args.DIR, args.seed, folds,
                                 args.min_nodes or 1600,
                                 args.max_nodes or 2600)
    else:
        make_synthetic_planetoid(args.DIR, args.seed, args.dataset,
                                 args.nodes, args.edges, args.features,
                                 args.classes, args.train, args.test)
    print("wrote %s data to %s" % (args.KIND, args.DIR))


if __name__ == "__main__":
    main()
