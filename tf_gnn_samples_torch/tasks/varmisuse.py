"""VarMisuse: variable-misuse detection on C# program graphs (ICLR'18)
(counterpart of tf_gnn_samples_tpu/tasks/varmisuse.py).

Capability-parity with the reference's `VarMisuse_Task`
(tasks/varmisuse_task.py:1-547):

* 11 named program-graph edge types x fwd/bkwd = 22 (+ optional SelfLoop
  as the 23rd) (varmisuse_task.py:22-28, 244-247).
* Preprocessing adds subtoken vocabulary nodes connected by `UsesSubtoken`
  edges for identifiers split on camel/snake case, skipping C# keywords
  (·:41-66); node labels become char tensors (68-char alphabet + PAD/UNK,
  at most 19 chars) deduplicated per graph by np.unique (·:77-84); the
  correct candidate is put first and the candidates padded to
  `max_variable_candidates` with a mask (·:114-127).
* Input model: a 2-layer char CNN over the unique labels (Conv1D 16@k5 ->
  MaxPool k5 s1 -> Conv1D D@k11), gathered per node (·:296-367). Its
  first convolution over one-hot characters is K shifted gathers of a
  per-offset table, as in the JAX package (no one-hot tensor is built).
* Output model: slot and candidate states, their inner product and a
  linear layer over [cand, slot, ip], padding masked with -BIG_NUMBER,
  softmax cross-entropy against index 0 (max-likelihood) or max-margin,
  accuracy and num_correct_predictions over real graphs (·:389-448).
* Shard files parsed in parallel by spawned worker processes (·:139-212),
  or, with `streaming_train_data`, the train fold read from disk every
  epoch through a windowed shuffle (ShardedSampleStream).

The host code (parsing, packing) is the JAX package's numpy, so both
packages build the same samples and batches. One difference: the
in-memory loader's pool returns the shards in file order (the JAX
package's in completion order), so a fold's sample order, and with it
every shuffle, depends on the seed alone.

Reference quirk kept (SURVEY.md "quirks"): the reference's training-time
output dropout is broken (varmisuse_task.py:489-490), so the published
numbers were obtained without it; `apply_out_layer_dropout` defaults to
False. When set, it draws from the runtime's explicit torch.Generator.
"""

import gzip
import json
import math
import multiprocessing
import os
import re
from multiprocessing import cpu_count
from typing import Any, Dict, Iterable, Iterator, List, NamedTuple, Optional, Set

import numpy as np
import torch

from .. import BIG_NUMBER
from ..nn.initializers import glorot_uniform, zeros
from ..ops.graph import bucket_size
from .base import (
    DataFold,
    SparseGraphTask,
    TaskBatch,
    compute_batch_specs,
    graph_sample_to_padded,
)

ALPHABET = "abcdefghijklmnopqrstuvwxyz0123456789,;.!?:'\"/\\|_@#$%^&*~`+-=<>()[]{}"
ALPHABET_DICT = {char: idx + 2 for (idx, char) in enumerate(ALPHABET)}  # 0=PAD, 1=UNK
ALPHABET_DICT["PAD"] = 0
ALPHABET_DICT["UNK"] = 1
USES_SUBTOKEN_EDGE_NAME = "UsesSubtoken"
SELF_LOOP_EDGE_NAME = "SelfLoop"
BACKWARD_EDGE_TYPE_NAME_SUFFIX = "_Bkwd"
_PROGRAM_GRAPH_EDGES_TYPES = [
    "Child", "NextToken", "LastUse", "LastWrite", "LastLexicalUse",
    "ComputedFrom", "GuardedByNegation", "GuardedBy", "FormalArgName",
    "ReturnsTo", USES_SUBTOKEN_EDGE_NAME,
]
_WITH_BKWD = _PROGRAM_GRAPH_EDGES_TYPES + [
    t + BACKWARD_EDGE_TYPE_NAME_SUFFIX for t in _PROGRAM_GRAPH_EDGES_TYPES
]
PROGRAM_GRAPH_EDGES_TYPES_VOCAB = {t: i for i, t in enumerate(_WITH_BKWD)}

# C# reserved keywords (the reference takes them from dpu_utils.codeutils
# get_language_keywords, varmisuse_task.py:9,288): public language
# specification data.
CSHARP_KEYWORDS = frozenset("""
abstract as base bool break byte case catch char checked class const continue
decimal default delegate do double else enum event explicit extern false
finally fixed float for foreach goto if implicit in int interface internal is
lock long namespace new null object operator out override params private
protected public readonly ref return sbyte sealed short sizeof stackalloc
static string struct switch this throw true try typeof uint ulong unchecked
unsafe ushort using virtual void volatile while
""".split())

# Byte value -> alphabet code (PAD=0, UNK=1, chars at idx+2); non-ASCII and
# unknown bytes map to UNK.
_BYTE_LUT = np.ones(256, dtype=np.uint8)
for _ch, _code in ALPHABET_DICT.items():
    if len(_ch) == 1:
        _BYTE_LUT[ord(_ch)] = _code

_IDENTIFIER_PART_RE = re.compile(
    r"[A-Z]+(?=[A-Z][a-z])|[A-Z]?[a-z0-9]+|[A-Z]+|[0-9]+"
)

# The char CNN's first convolution width (varmisuse_task.py:343-363).
_CONV1_WIDTH = 5
_CONV1_FILTERS = 16


def split_identifier_into_parts(identifier: str) -> List[str]:
    """Split snake_case / camelCase / PascalCase identifiers into lowercase
    subtokens (the reference uses dpu_utils.codeutils'
    split_identifier_into_parts)."""
    parts = _IDENTIFIER_PART_RE.findall(identifier)
    return [p.lower() for p in parts] if parts else [identifier.lower()]


class GraphSample(NamedTuple):
    adjacency_lists: List[np.ndarray]
    type_to_node_to_num_incoming_edges: np.ndarray
    unique_labels_as_characters: np.ndarray
    node_labels_to_unique_labels: np.ndarray
    slot_node_id: int
    variable_candidate_nodes: np.ndarray
    variable_candidate_nodes_mask: np.ndarray


def _add_per_subtoken_nodes(unsplittable_node_names: Set[str],
                            graph_dict: Dict[str, Any]) -> None:
    """Add one vocabulary node per subtoken with UsesSubtoken edges from
    every identifier node using it (varmisuse_task.py:41-66)."""
    graph_node_labels = graph_dict["NodeLabels"]
    subtoken_to_using_nodes: Dict[str, Set[int]] = {}
    max_used_node_id = 0
    for node_id_str, node_label in graph_node_labels.items():
        node_id = int(node_id_str)
        max_used_node_id = max(node_id, max_used_node_id)
        if node_label in unsplittable_node_names:
            continue
        for subtoken in split_identifier_into_parts(node_label):
            if re.search("[a-zA-Z0-9]", subtoken):
                subtoken_to_using_nodes.setdefault(subtoken, set()).add(node_id)

    subtoken_node_id = max_used_node_id
    new_edges = []
    for subtoken, using_nodes in subtoken_to_using_nodes.items():
        subtoken_node_id += 1
        graph_node_labels[str(subtoken_node_id)] = subtoken
        new_edges.extend((u, subtoken_node_id) for u in using_nodes)
    graph_dict["Edges"][USES_SUBTOKEN_EDGE_NAME] = new_edges


def _load_single_sample(raw_sample, unsplittable_node_names,
                        graph_node_label_max_num_chars,
                        max_variable_candidates=5,
                        add_self_loop_edges=False) -> GraphSample:
    """Parse one raw JSON sample (varmisuse_task.py:69-136). The self-loop
    type, when enabled, is index len(PROGRAM_GRAPH_EDGES_TYPES_VOCAB),
    computed here, so that spawned workers agree with the parent without
    any change to the module's vocabulary."""
    _add_per_subtoken_nodes(unsplittable_node_names, raw_sample["ContextGraph"])
    num_nodes = len(raw_sample["ContextGraph"]["NodeLabels"])

    # Char encoding by one byte-LUT pass a label (the host's hot path).
    C = graph_node_label_max_num_chars
    node_label_chars = np.zeros((num_nodes, C), dtype=np.uint8)
    for node, label in raw_sample["ContextGraph"]["NodeLabels"].items():
        low = label[:C].lower()
        if low.isascii():
            lb = low.encode("ascii")
            node_label_chars[int(node), : len(lb)] = _BYTE_LUT[
                np.frombuffer(lb, dtype=np.uint8)
            ]
        else:  # a rare non-ASCII label: per character (UNK each).
            # .lower() can lengthen some unicode strings: re-clamp to C.
            for char_idx, ch in enumerate(low[:C]):
                node_label_chars[int(node), char_idx] = ALPHABET_DICT.get(ch, 1)
    uniq_chars, uniq_indices = np.unique(node_label_chars, axis=0,
                                         return_inverse=True)

    num_edge_types = len(PROGRAM_GRAPH_EDGES_TYPES_VOCAB) + (
        1 if add_self_loop_edges else 0
    )
    adjacency_lists = [np.zeros((0, 2), dtype=np.int32)
                       for _ in range(num_edge_types)]
    num_incoming = np.zeros((num_edge_types, num_nodes), dtype=np.uint16)
    for e_type, e_type_edges in raw_sample["ContextGraph"]["Edges"].items():
        if len(e_type_edges) > 0:
            fwd_idx = PROGRAM_GRAPH_EDGES_TYPES_VOCAB[e_type]
            bkwd_idx = PROGRAM_GRAPH_EDGES_TYPES_VOCAB[
                e_type + BACKWARD_EDGE_TYPE_NAME_SUFFIX
            ]
            fwd = np.array(e_type_edges, dtype=np.int32)
            adjacency_lists[fwd_idx] = fwd
            adjacency_lists[bkwd_idx] = np.flip(fwd, axis=1)
            num_incoming[fwd_idx, :] = np.bincount(fwd[:, 1],
                                                   minlength=num_nodes)
            num_incoming[bkwd_idx, :] = np.bincount(fwd[:, 0],
                                                    minlength=num_nodes)

    if add_self_loop_edges:
        sl_idx = len(PROGRAM_GRAPH_EDGES_TYPES_VOCAB)
        rng_nodes = np.arange(num_nodes, dtype=np.int32)
        adjacency_lists[sl_idx] = np.stack([rng_nodes, rng_nodes], axis=1)
        num_incoming[sl_idx, :] = 1

    # The correct candidate first (·:114-127):
    correct_candidate_id = None
    distractors = []
    for candidate in raw_sample["SymbolCandidates"]:
        if candidate["IsCorrect"]:
            correct_candidate_id = candidate["SymbolDummyNode"]
        else:
            distractors.append(candidate["SymbolDummyNode"])
    assert correct_candidate_id is not None
    candidate_ids = ([correct_candidate_id]
                     + distractors[: max_variable_candidates - 1])
    pad = max_variable_candidates - len(candidate_ids)
    mask = [True] * len(candidate_ids) + [False] * pad
    candidate_ids = candidate_ids + [0] * pad

    return GraphSample(
        adjacency_lists=adjacency_lists,
        type_to_node_to_num_incoming_edges=num_incoming,
        unique_labels_as_characters=uniq_chars,
        node_labels_to_unique_labels=uniq_indices.astype(np.int32),
        slot_node_id=raw_sample["SlotDummyNode"],
        variable_candidate_nodes=np.array(candidate_ids, dtype=np.int32),
        variable_candidate_nodes_mask=np.array(mask, dtype=np.float32),
    )


def _read_shard(path: str) -> List[Any]:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt", encoding="utf-8") as f:
        if ".jsonl" in path:
            return [json.loads(line) for line in f if line.strip()]
        return json.load(f)


def _parse_shard(args) -> List[GraphSample]:
    """A worker's job: one shard's samples, parsed (numpy only: spawned
    workers return no tensors and touch no device)."""
    (path, max_chars, max_cands, self_loops) = args
    return [
        _load_single_sample(raw, CSHARP_KEYWORDS, max_chars, max_cands,
                            self_loops)
        for raw in _read_shard(path)
    ]


def _load_data(paths: List[str], graph_node_label_max_num_chars: int,
               max_variable_candidates: int, add_self_loop_edges: bool,
               no_parallel: bool = False) -> Iterator[GraphSample]:
    """Parse the shards, one spawned worker each (up to the core count),
    in file order (the reference's worker / queue pool,
    varmisuse_task.py:163-212). Spawn, not fork: the parent holds torch
    and its threads, and forking a multithreaded process can deadlock
    the workers. The pool is closed when the generator ends or is
    abandoned."""
    work = [
        (p, graph_node_label_max_num_chars, max_variable_candidates,
         add_self_loop_edges)
        for p in paths
    ]
    if no_parallel or len(paths) <= 1:
        for w in work:
            yield from _parse_shard(w)
        return
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(min(cpu_count(), len(paths))) as pool:
        for samples in pool.imap(_parse_shard, work):
            yield from samples


def _scan_shard(args) -> List[List[int]]:
    """The stats pass's job: parse one shard and keep only each sample's
    [num_nodes, per-type edge counts..., num_unique_labels]."""
    samples = _parse_shard(args)
    return [
        [len(s.node_labels_to_unique_labels)]
        + [int(a.shape[0]) for a in s.adjacency_lists]
        + [int(s.unique_labels_as_characters.shape[0])]
        for s in samples
    ]


class ShardedSampleStream:
    """A disk-resident TRAIN fold for dataset-scale VarMisuse runs.

    The reference (varmisuse_task.py:163-212) holds the whole fold in
    memory (~15 GB at the full dataset's scale). This stream keeps only
    the shard paths and each sample's size statistics: every epoch it
    parses the shards lazily in shuffled order and yields samples through
    a bounded windowed shuffle (the splitter's shard-window design,
    utils/varmisuse_data_splitter.py), so host memory stays O(window + one
    shard).

    The one-time stats pass (for the fold-constant BatchSpec) is parallel,
    keeps no samples and is cached beside the shards in
    `.torch_stream_stats.json` (keyed by the shards' names and sizes and
    the parse parameters; the JAX package keeps its own file). With
    `parse_workers` > 1 the shards are parsed by a spawned pool made at
    the first epoch and reused by later ones; close() (also called by
    __del__) terminates it.
    """

    is_streaming = True

    def __init__(self, paths: List[str], max_chars: int, max_cands: int,
                 self_loops: bool, window_graphs: int = 2000,
                 parse_workers: int = 0):
        self.paths = list(paths)
        self._parse_args = (max_chars, max_cands, self_loops)
        self.window_graphs = max(int(window_graphs), 1)
        self.parse_workers = int(parse_workers)
        self.max_buffered = 0  # high-water mark of the shuffle window
        self._pool = None
        self._stats = self._load_or_scan_stats()

    def _get_pool(self):
        if self._pool is None:
            ctx = multiprocessing.get_context("spawn")
            self._pool = ctx.Pool(min(self.parse_workers, len(self.paths)))
        return self._pool

    def close(self):
        if self._pool is not None:
            self._pool.terminate()
            self._pool.join()
            self._pool = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    # ---- stats ----------------------------------------------------------

    def _stats_key(self) -> List:
        files = [[os.path.basename(p), int(os.path.getsize(p))]
                 for p in self.paths]
        return [files, list(self._parse_args)]

    def _cache_path(self) -> str:
        return os.path.join(os.path.dirname(self.paths[0]),
                            ".torch_stream_stats.json")

    def _load_or_scan_stats(self) -> List[List[int]]:
        cache = self._cache_path()
        key = self._stats_key()
        try:
            with open(cache, "r") as f:
                saved = json.load(f)
            if saved.get("key") == key:
                return saved["sizes"]
        except (OSError, ValueError, KeyError):
            pass
        work = [(p,) + self._parse_args for p in self.paths]
        sizes: List[List[int]] = []
        if len(work) <= 1:
            for w in work:
                sizes.extend(_scan_shard(w))
        else:
            ctx = multiprocessing.get_context("spawn")
            with ctx.Pool(min(cpu_count(), len(work))) as pool:
                for part in pool.map(_scan_shard, work):
                    sizes.extend(part)
        try:
            with open(cache, "w") as f:
                json.dump({"key": key, "sizes": sizes}, f)
        except OSError:
            pass  # a read-only data directory: scan again next run
        return sizes

    def __len__(self) -> int:
        return len(self._stats)

    def spec_stats(self):
        """(sizes [(n, e_counts)], uniq_density, max_uniq) for the
        BatchSpec: the statistics the in-memory path takes from its
        loaded samples."""
        sizes = [(row[0], row[1:-1]) for row in self._stats]
        uniq_density = 0.0
        max_uniq = 1
        for row in self._stats:
            n = max(row[0], 1)
            u = row[-1]
            uniq_density = max(uniq_density, u / n)
            max_uniq = max(max_uniq, u)
        return sizes, uniq_density, max_uniq

    # ---- epoch iteration ------------------------------------------------

    def iter_samples(self, shuffle: bool) -> Iterator[GraphSample]:
        """The windowed-shuffle sample stream: shards in (shuffled) order,
        parsed lazily, samples leaving through a bounded reservoir. Draws
        from np.random, so that a resumed run reproduces the stream. With
        parse_workers > 1 at most workers + 1 shards are in flight and
        their results are taken in submission order: the same sequence
        (and np.random draws) as the serial path."""
        from ..utils.iterators import ThreadedIterator

        order = np.arange(len(self.paths))
        if shuffle:
            np.random.shuffle(order)

        if self.parse_workers > 1 and len(self.paths) > 1:
            def parsed():
                from collections import deque

                pool = self._get_pool()
                pending = deque()
                idx = 0
                while idx < len(order) or pending:
                    while (idx < len(order)
                           and len(pending) < self.parse_workers + 1):
                        args = (self.paths[order[idx]],) + self._parse_args
                        pending.append(pool.apply_async(_parse_shard,
                                                        (args,)))
                        idx += 1
                    yield pending.popleft().get()
        else:
            def parsed():
                for si in order:
                    yield _parse_shard((self.paths[si],) + self._parse_args)

        shard_iter = ThreadedIterator(parsed(), max_queue_size=1)
        buf: List[GraphSample] = []
        try:
            for shard_samples in shard_iter:
                for s in shard_samples:
                    buf.append(s)
                    if len(buf) > self.max_buffered:
                        self.max_buffered = len(buf)
                    if len(buf) >= self.window_graphs:
                        j = np.random.randint(len(buf)) if shuffle else 0
                        buf[j], buf[-1] = buf[-1], buf[j]
                        yield buf.pop()
        finally:
            shard_iter.close()
        if shuffle:
            np.random.shuffle(buf)
        for s in buf:
            yield s


def _leaky_relu(x):
    """jax.nn.leaky_relu at its default slope 0.01 (the JAX package's char
    CNN), with its derivative 1 at exactly 0."""
    return torch.where(x >= 0, x, 0.01 * x)


class VarMisuse_Task(SparseGraphTask):
    @classmethod
    def default_params(cls):
        params = super().default_params()
        params.update({
            "max_variable_candidates": 5,
            "graph_node_label_max_num_chars": 19,
            "graph_node_label_representation_size": 64,
            "slot_score_via_linear_layer": True,
            "loss_function": "max-likelihood",  # or max-margin
            "max-margin_loss_margin": 0.2,
            "out_layer_dropout_rate": 0.2,
            "apply_out_layer_dropout": False,  # see the module docstring
            "add_self_loop_edges": False,
            # Keep the TRAIN fold on disk and stream it through a windowed
            # shuffle every epoch (ShardedSampleStream).
            "streaming_train_data": False,
            "streaming_window_graphs": 2000,
            # The streamed fold's parse: 0 / 1 = inline (one prefetch
            # thread); N > 1 = a reused spawned pool of N workers.
            "streaming_parse_workers": 0,
        })
        return params

    @staticmethod
    def name() -> str:
        return "VarMisuse"

    @staticmethod
    def default_data_path() -> str:
        return "data/varmisuse"

    @property
    def num_edge_types(self) -> int:
        # 22 named fwd/bkwd types, and SelfLoop as the last one when
        # enabled (varmisuse_task.py:244-247).
        return len(PROGRAM_GRAPH_EDGES_TYPES_VOCAB) + (
            1 if self.params.get("add_self_loop_edges") else 0
        )

    @property
    def initial_node_feature_size(self) -> int:
        return self.params["graph_node_label_representation_size"]

    # -------------------- Data loading --------------------

    def load_data(self, path: Optional[str]) -> None:
        path = path or self.default_data_path()
        if self.params.get("streaming_train_data"):
            train_dir = os.path.join(path, "graphs-train")
            files = self._shard_files(train_dir)
            print(" Streaming VarMisuse TRAIN data from %s [%i data files]."
                  % (train_dir, len(files)))
            self._loaded_data[DataFold.TRAIN] = ShardedSampleStream(
                files,
                self.params["graph_node_label_max_num_chars"],
                self.params["max_variable_candidates"],
                self.params["add_self_loop_edges"],
                window_graphs=self.params.get("streaming_window_graphs",
                                              2000),
                parse_workers=self.params.get("streaming_parse_workers", 0),
            )
        else:
            self._loaded_data[DataFold.TRAIN] = list(
                self.__load_data(os.path.join(path, "graphs-train"))
            )
        self._loaded_data[DataFold.VALIDATION] = list(
            self.__load_data(os.path.join(path, "graphs-valid"))
        )

    def load_eval_data_from_path(self, path: str) -> Iterable[Any]:
        """The default data path means its graphs-test fold; any other path
        is a fold directory itself (graphs-test, or graphs-testonly, the
        unseen projects' fold, reorg_varmisuse_data.sh:10)."""
        if path == self.default_data_path():
            path = os.path.join(path, "graphs-test")
        return list(self.__load_data(path))

    def _shard_files(self, data_dir: str) -> List[str]:
        all_files = sorted(
            os.path.join(data_dir, f)
            for f in os.listdir(data_dir)
            if f.endswith(".gz")
        )
        if not all_files:
            raise FileNotFoundError(
                "No *.gz shard files found in %s: VarMisuse data paths must "
                "point at a graphs-{train,valid,test,testonly} directory "
                "holding the shard files." % data_dir
            )
        max_num_files = self.params.get("max_num_data_files")
        if max_num_files is not None:
            all_files = all_files[:max_num_files]
        return all_files

    def __load_data(self, data_dir: str) -> Iterator[GraphSample]:
        all_files = self._shard_files(data_dir)
        print(" Loading VarMisuse data from %s [%i data files]."
              % (data_dir, len(all_files)))
        return _load_data(
            all_files,
            self.params["graph_node_label_max_num_chars"],
            self.params["max_variable_candidates"],
            self.params["add_self_loop_edges"],
        )

    # -------------------- Input model (char CNN) --------------------

    def input_init(self, gen: torch.Generator):
        """The char CNN's weights (varmisuse_task.py:343-363):
        Conv1D(16, k=5, leaky_relu) -> MaxPool(k=5, s=1) -> Conv1D(D,
        k=C-8, leaky_relu), Keras-style zero biases. conv1 is kept as K1
        per-offset [A, 16] tables; both kernels are Glorot-uniform over the
        convolution's fans (k * in, k * out), as TF's and the JAX package's
        initialisers count them."""
        C = self.params["graph_node_label_max_num_chars"]
        D = self.params["graph_node_label_representation_size"]
        A = len(ALPHABET)
        K1, F1 = _CONV1_WIDTH, _CONV1_FILTERS
        K2 = C - 2 * (K1 - 1)
        limit = math.sqrt(6.0 / (K1 * A + K1 * F1))
        conv1 = (2.0 * torch.rand((K1, A, F1), generator=gen) - 1.0) * limit
        return {
            "conv1_kernel": conv1,
            "conv1_bias": zeros((F1,)),
            "conv2_kernel": glorot_uniform(gen, (K2 * F1, D)).reshape(K2, F1, D),
            "conv2_bias": zeros((D,)),
        }

    def input_apply(self, params, batch: TaskBatch, gen=None):
        uniq_chars = batch.aux["unique_labels_as_characters"]  # [U_pad, C]
        node_to_uniq = batch.aux["node_labels_to_unique_labels"]  # [N_pad]
        C = self.params["graph_node_label_max_num_chars"]
        K1 = _CONV1_WIDTH
        T1 = C - (K1 - 1)  # conv1's output length
        T2 = T1 - (K1 - 1)  # the pool's output length (k=5, stride 1)
        kernel = params["conv1_kernel"]
        u = uniq_chars.shape[0]

        # conv1 over one-hot chars is a sum of shifted table gathers. The
        # one-hot depth is len(ALPHABET), so char ids A and A+1 (the
        # alphabet's last two chars, shifted by PAD / UNK) embed to zero in
        # the reference: two zero rows.
        table = torch.cat([kernel, kernel.new_zeros((K1, 2, kernel.shape[-1]))],
                          dim=1)  # [K1, A+2, 16]
        acc = torch.zeros((u, T1, kernel.shape[-1]), device=kernel.device)
        for k in range(K1):
            idx = uniq_chars[:, k:k + T1].reshape(-1)
            acc = acc + table[k].index_select(0, idx).reshape(u, T1, -1)
        h = _leaky_relu(acc + params["conv1_bias"])  # [U, T1, 16]

        # MaxPool1D(pool=5, stride=1):
        pooled = torch.stack([h[:, k:k + T2, :] for k in range(K1)]).amax(0)

        # conv2's kernel length is T2: one output position, one
        # contraction over (position, channel).
        w2 = params["conv2_kernel"]
        out = torch.matmul(pooled.reshape(u, -1), w2.reshape(-1, w2.shape[-1]))
        uniq_repr = _leaky_relu(out + params["conv2_bias"])  # [U_pad, D]
        return uniq_repr.index_select(0, node_to_uniq.clamp(0, u - 1))

    # -------------------- Output model --------------------

    def output_init(self, gen: torch.Generator, hidden_size: int):
        params = {}
        if self.params["slot_score_via_linear_layer"]:
            params["slot_score_linear"] = glorot_uniform(
                gen, (2 * hidden_size + 1, 1))
        return params

    def output_apply(self, params, batch: TaskBatch, final_h, initial_feats,
                     gen=None):
        g = batch.graph
        slots = batch.aux["slot_node_ids"]  # [G_pad]
        cand_ids = batch.aux["candidate_node_ids"]  # [G_pad, Cands]
        cand_mask = batch.aux["candidate_node_ids_mask"]  # [G_pad, Cands]
        g_pad, n_cands = cand_ids.shape
        n = final_h.shape[0]

        if gen is not None and self.params.get("apply_out_layer_dropout"):
            keep = 1.0 - self.params["out_layer_dropout_rate"]
            m = torch.bernoulli(torch.full_like(final_h, keep), generator=gen)
            final_h = torch.where(m > 0, final_h / keep, 0.0)

        # The JAX package's gathers clip (jnp.take mode="clip"):
        slot_repr = final_h.index_select(0, slots.clamp(0, n - 1))  # [G, D]
        cand_repr = final_h.index_select(
            0, cand_ids.reshape(-1).clamp(0, n - 1)).reshape(g_pad, n_cands, -1)

        inner = torch.einsum("sd,scd->sc", slot_repr, cand_repr)  # [G, Cands]
        if self.params["slot_score_via_linear_layer"]:
            rep_slots = slot_repr[:, None, :].expand_as(cand_repr)
            comb = torch.cat([cand_repr, rep_slots, inner[..., None]], dim=2)
            logits = torch.matmul(comb, params["slot_score_linear"])[..., 0]
        else:
            logits = inner
        logits = logits + (1.0 - cand_mask) * -BIG_NUMBER

        loss_function = self.params["loss_function"]
        log_probs = torch.log_softmax(logits, dim=-1)
        if loss_function == "max-likelihood":
            # The correct candidate is index 0 by construction.
            per_graph_loss = -log_probs[:, 0]
        elif loss_function == "max-margin":
            # The reference crashes here on a missing params key
            # (varmisuse_task.py:429-434); 'max-margin_loss_margin' is used.
            margin = self.params["max-margin_loss_margin"]
            max_wrong_lp = torch.amax(log_probs[:, 1:], dim=1)
            per_graph_loss = torch.relu(max_wrong_lp - log_probs[:, 0]
                                        + margin)
        else:
            raise Exception('Invalid loss function option: "%s"'
                            % loss_function)

        per_graph_loss = per_graph_loss * g.graph_mask
        num_graphs = float(max(g.num_graphs, 1))
        correct = (torch.argmax(logits, dim=1) == 0).to(torch.float32) * (
            g.graph_mask)
        num_correct = torch.sum(correct)
        total_loss = torch.sum(per_graph_loss)
        loss = total_loss / num_graphs
        return loss, {
            "loss": loss,
            "total_loss": total_loss,
            "accuracy": num_correct / num_graphs,
            "num_correct_predictions": num_correct,
        }

    # -------------------- Minibatching --------------------

    def make_minibatch_iterator(
        self, data, data_fold: DataFold, max_nodes_per_batch: int
    ) -> Iterator[TaskBatch]:
        L = self.num_edge_types
        n_cands = self.params["max_variable_candidates"]
        C = self.params["graph_node_label_max_num_chars"]
        shuffle = data_fold == DataFold.TRAIN
        num_buckets = int(self.params.get("batch_spec_buckets", 3))

        def _levels(sizes, uniq_density, max_uniq):
            """The spec levels, and a unique-label pad a level (the char
            CNN's [u_pad, C] input scales with the level)."""
            specs = compute_batch_specs(
                sizes, max_nodes_per_batch, L, num_buckets=num_buckets
            )
            u_pads = [
                bucket_size(
                    max(int(np.ceil(uniq_density * s.n_pad)), max_uniq)
                )
                for s in specs
            ]
            return specs, u_pads

        if getattr(data, "is_streaming", False):
            # The stream's disk-cached stats give the specs; the samples
            # arrive through its windowed shuffle.
            specs, u_pads = self.cached_spec(
                data, max_nodes_per_batch,
                lambda: _levels(*data.spec_stats()),
            )
            sample_iter = data.iter_samples(shuffle=shuffle)
        else:
            if not isinstance(data, list):
                data = list(data)

            def _compute():
                sizes = []
                uniq_density = 0.0
                max_uniq = 1
                for s in data:
                    n = max(len(s.node_labels_to_unique_labels), 1)
                    sizes.append(
                        (n, [a.shape[0] for a in s.adjacency_lists])
                    )
                    u = s.unique_labels_as_characters.shape[0]
                    uniq_density = max(uniq_density, u / n)
                    max_uniq = max(max_uniq, u)
                return _levels(sizes, uniq_density, max_uniq)

            specs, u_pads = self.cached_spec(
                data, max_nodes_per_batch, _compute
            )
            order = np.arange(len(data))
            if shuffle:
                np.random.shuffle(order)
            sample_iter = (data[i] for i in order)
        spec, u_pad = specs[-1], u_pads[-1]  # the packing budgets

        # Pack under the node, unique-label, per-type edge and graph-count
        # budgets, one sample at a time (the list and the stream alike):
        def batches():
            cur: List[GraphSample] = []
            cur_nodes = cur_uniq = 0
            cur_edges = np.zeros(L, dtype=np.int64)
            e_pads = np.asarray(spec.e_pads)
            for s in sample_iter:
                n = len(s.node_labels_to_unique_labels)
                u = s.unique_labels_as_characters.shape[0]
                e_counts = np.array(
                    [a.shape[0] for a in s.adjacency_lists], dtype=np.int64
                )
                fits = (
                    cur_nodes + n < max_nodes_per_batch
                    and cur_uniq + u <= u_pad
                    and len(cur) < spec.g_pad
                    and bool(np.all(cur_edges + e_counts <= e_pads))
                )
                if cur and not fits:
                    yield cur
                    cur, cur_nodes, cur_uniq = [], 0, 0
                    cur_edges = np.zeros_like(cur_edges)
                cur.append(s)
                cur_nodes += n
                cur_uniq += u
                cur_edges += e_counts
            if cur:
                yield cur

        for pack in batches():
            # The level of each pack: the smallest spec whose node, unique,
            # edge and graph budgets all cover it (the packing spec always
            # does).
            req_n = sum(len(s.node_labels_to_unique_labels) for s in pack)
            req_u = sum(s.unique_labels_as_characters.shape[0] for s in pack)
            req_e = np.sum(
                [[a.shape[0] for a in s.adjacency_lists] for s in pack],
                axis=0,
            )
            sel_spec, sel_u_pad = specs[-1], u_pads[-1]
            for k in range(len(specs) - 1):
                if (req_n <= specs[k].n_pad and req_u <= u_pads[k]
                        and len(pack) <= specs[k].g_pad
                        and bool(np.all(req_e <= np.asarray(
                            specs[k].e_pads)))):
                    sel_spec, sel_u_pad = specs[k], u_pads[k]
                    break
            adj = [[] for _ in range(L)]
            counts, uniq_chars, node_to_uniq, gids = [], [], [], []
            slot_ids = np.zeros(sel_spec.g_pad, np.int32)
            cand_ids = np.zeros((sel_spec.g_pad, n_cands), np.int32)
            cand_mask = np.zeros((sel_spec.g_pad, n_cands), np.float32)
            node_offset = uniq_offset = 0
            num_edges = 0
            for gi, s in enumerate(pack):
                n = len(s.node_labels_to_unique_labels)
                for l in range(L):
                    adj[l].append(s.adjacency_lists[l] + node_offset)
                    num_edges += s.adjacency_lists[l].shape[0]
                counts.append(
                    s.type_to_node_to_num_incoming_edges.astype(np.float32)
                )
                uniq_chars.append(s.unique_labels_as_characters)
                node_to_uniq.append(s.node_labels_to_unique_labels
                                    + uniq_offset)
                gids.append(np.full(n, gi, dtype=np.int32))
                slot_ids[gi] = s.slot_node_id + node_offset
                # Padded candidate slots point at the batch's node 0 and are
                # masked (the reference's raw 0):
                cand_ids[gi] = np.where(
                    s.variable_candidate_nodes_mask > 0,
                    s.variable_candidate_nodes + node_offset, 0
                )
                cand_mask[gi] = s.variable_candidate_nodes_mask
                uniq_offset += s.unique_labels_as_characters.shape[0]
                node_offset += n

            graph = graph_sample_to_padded(
                # The char CNN makes the node features; the batch keeps a
                # one-column placeholder.
                np.zeros((node_offset, 1), np.float32),
                [np.concatenate(a) if a else np.zeros((0, 2), np.int32)
                 for a in adj],
                np.concatenate(gids),
                len(pack),
                sel_spec,
                typed_incoming_counts=np.concatenate(counts, axis=1),
            )
            uc = np.zeros((sel_u_pad, C), np.int32)
            cat_uc = np.concatenate(uniq_chars, axis=0)
            uc[: cat_uc.shape[0]] = cat_uc
            ntu = np.zeros(sel_spec.n_pad, np.int32)
            ntu[:node_offset] = np.concatenate(node_to_uniq)
            t = torch.from_numpy
            yield TaskBatch(
                graph=graph,
                aux={
                    "unique_labels_as_characters": t(uc),
                    "node_labels_to_unique_labels": t(ntu),
                    "slot_node_ids": t(slot_ids),
                    "candidate_node_ids": t(cand_ids),
                    "candidate_node_ids_mask": t(cand_mask),
                },
                num_graphs=len(pack),
                num_nodes=node_offset,
                num_edges=num_edges,
            )

    # -------------------- Epoch metrics --------------------

    def early_stopping_metric(self, task_metric_results,
                              num_graphs: int) -> float:
        # Negated accuracy (varmisuse_task.py:540-543).
        acc = sum(
            float(m["num_correct_predictions"]) for m in task_metric_results
        ) / float(num_graphs)
        return -acc

    def pretty_print_epoch_task_metrics(self, task_metric_results,
                                        num_graphs: int) -> str:
        acc = sum(
            float(m["num_correct_predictions"]) for m in task_metric_results
        ) / float(num_graphs)
        return "Accuracy: %.3f" % (acc,)
