"""Synthetic PPI and Planetoid data in the on-disk formats the task
loaders read (tasks/ppi.py, tasks/citation.py), made from a seed.

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

Usage:
    python -m tf_gnn_samples_torch.tools.synthetic_data ppi DIR [--seed S]
        [--graphs TRAIN VALID TEST] [--min-nodes N] [--max-nodes N]
    python -m tf_gnn_samples_torch.tools.synthetic_data planetoid DIR
        [--seed S] [--dataset pubmed] [--nodes N] [--edges E]
        [--features F] [--classes C] [--train N] [--test N]
"""

import argparse
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


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("KIND", choices=("ppi", "planetoid"))
    parser.add_argument("DIR")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--graphs", type=int, nargs=3,
                        metavar=("TRAIN", "VALID", "TEST"),
                        default=[PPI_FOLDS[k] for k in ("train", "valid",
                                                        "test")])
    parser.add_argument("--min-nodes", type=int, default=1700)
    parser.add_argument("--max-nodes", type=int, default=3100,
                        help="exclusive bound of a PPI graph's node count")
    parser.add_argument("--dataset", default="pubmed")
    parser.add_argument("--nodes", type=int, default=19717)
    parser.add_argument("--edges", type=int, default=44338)
    parser.add_argument("--features", type=int, default=500)
    parser.add_argument("--classes", type=int, default=3)
    parser.add_argument("--train", type=int, default=60)
    parser.add_argument("--test", type=int, default=1000)
    args = parser.parse_args(argv)
    if args.KIND == "ppi":
        make_synthetic_ppi(args.DIR, args.seed,
                           dict(zip(("train", "valid", "test"), args.graphs)),
                           args.min_nodes, args.max_nodes)
    else:
        make_synthetic_planetoid(args.DIR, args.seed, args.dataset,
                                 args.nodes, args.edges, args.features,
                                 args.classes, args.train, args.test)
    print("wrote %s data to %s" % (args.KIND, args.DIR))


if __name__ == "__main__":
    main()
