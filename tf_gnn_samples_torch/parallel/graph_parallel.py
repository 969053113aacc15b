"""Graph parallelism: one batch's packed mega-graph partitioned across the
ranks of a torch.distributed process group (counterpart of
tf_gnn_samples_tpu/parallel/graph_parallel.py).

* Nodes are partitioned contiguously: rank p owns global nodes
  [p * Nl, (p + 1) * Nl) and their states h_local [Nl, D].
* Edges live on their RECEIVER's rank, so aggregation is local.
* Each message-passing layer all-gathers the typed node transforms
  [L, Nl, D] of every rank into the type-stacked table [L * N, D] that
  the global sender indices address (row type * N + global node), then
  gathers sources from it and segment-sums into local receivers.
* The collective is an autograd Function: the forward is an
  all_gather_into_tensor, the backward a reduce_scatter_tensor (SUM) of
  the cotangent, the transpose JAX inserts for its all_gather. The task
  steps (make_gp_task_steps) then average every gradient over the ranks
  in one all_reduce, as the JAX step's pmean does.
* Every shard also carries its edges split by source ownership
  (flat_local / flat_remote): a layer starts the all-gather
  asynchronously, gathers and aggregates the local-source edges from the
  rank's own table meanwhile, and only then waits for the remote rows.
* The halo exchange (GP_HALO_LAYERS over a GPHaloShard, model parameter
  graph_parallel_halo) moves only boundary rows: a layer sends each rank
  the rows of its own that that rank's edges read, one all_to_all_single
  of [P * halo_pad, D] a timestep (its backward the same exchange of the
  cotangent), in place of the all-gather of the [L, N, D] typed table.
  The same source-ownership split overlaps it with the local stream.

The JAX package stacks the P pieces along a leading device axis for
shard_map over a mesh; here each rank keeps only its own piece (no leading
axis, no mesh). The gathers and the aggregation are the port's plain ones
(index_select, index_add), as the JAX package's gp layers run XLA's: no
hand-written kernel is on this path. Ranks that share a GPU run over
gloo, which moves CUDA tensors through host memory itself; ranks that
each own one run over NCCL.
"""

from typing import Any, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..nn.activations import get_activation
from ..nn.cells import cell_apply
from ..nn.layers import _rgdcn_type_contraction, typed_transform
from ..nn.mlp import dropout, mlp_apply
from ..nn.normalization import layer_norm
from ..ops.edge_ops import (_take_clip, aggregate_flat, aggregate_flat_sum,
                            gather_flat_src, gather_flat_tgt,
                            segment_softmax_flat)
from ..ops.graph import bucket_size
from ..ops.segment import segment_max, segment_sum
from ..runtime.optimizers import clip_grads_per_tensor
from .data_parallel import _metric_parts, world

SMALL = 1e-7  # the JAX partitioner's 1/c guard


class GPFlatEdges(NamedTuple):
    """One rank's flat edge stream: receivers LOCAL [0, Nl], senders in the
    type-offset index space of the table the stream reads (the gathered
    [L * N, D] one, or the rank's own [L * Nl, D] one for flat_local).
    Receiver-sorted, with by-src and by-tgt permutations, as
    ops/graph.py FlatEdges."""

    src_flat: Any  # [E] int32: type * table_rows + sender
    receivers: Any  # [E] int32 LOCAL, sorted; padding -> Nl
    tgt_flat: Any  # [E] int32: type * table_rows + receiver
    mask: Any  # [E] float32
    norm_scale: Any  # [E] float32
    perm_by_src: Any  # [E] int32
    perm_by_tgt: Any  # [E] int32


class GPShard(NamedTuple):
    """One rank's piece of the partitioned graph. flat_local and
    flat_remote split the edges of `flat` by source ownership: flat_local's
    senders (and targets) index the rank's OWN typed table (type * Nl +
    local node), so its messages and aggregation have no data path from
    the all-gather; flat_remote holds the remote-source edges in the
    global index space."""

    node_features: Any  # [Nl, F]
    node_mask: Any  # [Nl]
    flat: GPFlatEdges
    flat_local: Optional[GPFlatEdges] = None
    flat_remote: Optional[GPFlatEdges] = None


# ---------------------------------------------------------------------------
# The host partitioner (numpy; deterministic, so every rank builds the same
# shapes from the same batch)
# ---------------------------------------------------------------------------


def _partition_prologue(node_features, adjacency_lists, num_partitions,
                        typed_incoming_counts):
    """Contiguous node ranges, the incoming counts, each edge on its
    receiver's partition, and each partition's features and mask."""
    n = node_features.shape[0]
    L = len(adjacency_lists)
    n_local = bucket_size(-(-n // num_partitions), min_size=8)
    n_global = n_local * num_partitions
    if typed_incoming_counts is None:
        typed_incoming_counts = np.zeros((L, n), dtype=np.float32)
        for l, adj in enumerate(adjacency_lists):
            if adj.shape[0]:
                np.add.at(typed_incoming_counts[l], adj[:, 1], 1.0)
    per_part = [[] for _ in range(num_partitions)]
    for l, adj in enumerate(adjacency_lists):
        if adj.shape[0] == 0:
            continue
        part = adj[:, 1] // n_local
        for p in range(num_partitions):
            sel = adj[part == p]
            if sel.shape[0]:
                per_part[p].append((l, sel))
    feats, masks = [], []
    for p in range(num_partitions):
        lo = p * n_local
        f = np.zeros((n_local, node_features.shape[1]), np.float32)
        m = np.zeros((n_local,), np.float32)
        hi = min(lo + n_local, n)
        if hi > lo:
            f[: hi - lo] = node_features[lo:hi]
            m[: hi - lo] = 1.0
        feats.append(f)
        masks.append(m)
    return n_local, n_global, typed_incoming_counts, per_part, feats, masks


def _pack_stream(pieces, e_pad: int, pad_src: int, pad_tgt: int,
                 n_local: int) -> GPFlatEdges:
    """A receiver-sorted GPFlatEdges of `e_pad` slots from `pieces`, one
    (type-offset senders, type-offset targets, local receivers, norms)
    tuple of arrays a type, in order. Padding: senders pad_src, targets
    pad_tgt, receiver n_local."""
    src = np.full((e_pad,), pad_src, np.int32)
    tgt = np.full((e_pad,), pad_tgt, np.int32)
    rcv = np.full((e_pad,), n_local, np.int32)
    msk = np.zeros((e_pad,), np.float32)
    nrm = np.zeros((e_pad,), np.float32)
    off = 0
    for senders, targets, receivers, norms in pieces:
        k = len(senders)
        src[off:off + k] = senders
        tgt[off:off + k] = targets
        rcv[off:off + k] = receivers
        msk[off:off + k] = 1.0
        nrm[off:off + k] = norms
        off += k
    order = np.argsort(rcv, kind="stable")
    src, tgt, rcv, msk, nrm = (src[order], tgt[order], rcv[order],
                               msk[order], nrm[order])
    return GPFlatEdges(
        src_flat=src, receivers=rcv, tgt_flat=tgt, mask=msk, norm_scale=nrm,
        perm_by_src=np.argsort(src, kind="stable").astype(np.int32),
        perm_by_tgt=np.argsort(tgt, kind="stable").astype(np.int32))


def _build_flat(edge_tuples, L, lo, src_offset, table_rows, n_local, e_pad,
                typed_incoming_counts) -> GPFlatEdges:
    """_pack_stream over (type, [k, 2] adjacency) tuples: senders and
    targets index type * table_rows + (node - src_offset) (src_offset lo:
    the rank's own table, 0: the global one), padded with L * table_rows."""
    return _pack_stream(
        [(l * table_rows + (adj[:, 0] - src_offset),
          l * table_rows + (adj[:, 1] - src_offset), adj[:, 1] - lo,
          1.0 / (typed_incoming_counts[l][adj[:, 1]] + SMALL))
         for l, adj in edge_tuples],
        e_pad, L * table_rows, L * table_rows, n_local)


def partition_graph(node_features: np.ndarray,
                    adjacency_lists: List[np.ndarray], num_partitions: int,
                    typed_incoming_counts: np.ndarray = None,
                    e_pad: Optional[int] = None,
                    parts: Optional[List[int]] = None
                    ) -> Tuple[List[GPShard], int, int]:
    """Host partitioner: contiguous node ranges, receiver-owned edges.
    Returns ([GPShard of numpy arrays] for each partition in `parts`
    (default: all), n_local, n_global). Every stream has `e_pad` slots
    (default: the largest partition's edge count, bucketed), the same on
    every partition."""
    L = len(adjacency_lists)
    (n_local, n_global, counts, per_part, feats,
     masks) = _partition_prologue(node_features, adjacency_lists,
                                  num_partitions, typed_incoming_counts)
    if e_pad is None:
        e_pad = bucket_size(max(max(sum(a.shape[0] for _, a in d)
                                    for d in per_part), 1), min_size=64)
    shards = []
    for p in range(num_partitions) if parts is None else parts:
        lo = p * n_local
        flat = _build_flat(per_part[p], L, lo, 0, n_global, n_local, e_pad,
                           counts)
        loc, rem = [], []
        for l, adj in per_part[p]:
            own = (adj[:, 0] >= lo) & (adj[:, 0] < lo + n_local)
            if own.any():
                loc.append((l, adj[own]))
            if (~own).any():
                rem.append((l, adj[~own]))
        shards.append(GPShard(
            node_features=feats[p], node_mask=masks[p], flat=flat,
            flat_local=_build_flat(loc, L, lo, lo, n_local, n_local, e_pad,
                                   counts),
            flat_remote=_build_flat(rem, L, lo, 0, n_global, n_local, e_pad,
                                    counts)))
    return shards, n_local, n_global


def batch_adjacency(batch) -> List[np.ndarray]:
    """The real edges of a TaskBatch's graph as one [e_l, 2] (sender,
    receiver) array a type, each in its EdgeBlock's order (receiver-sorted,
    stable): the flat stream is the stable receiver sort of the
    concatenated blocks, so its type-l edges keep their block's order."""
    flat = batch.graph.flat
    n_pad = batch.graph.n_pad
    etype = flat.edge_type.cpu().numpy()
    real = flat.mask.cpu().numpy() > 0
    src = flat.src_flat.cpu().numpy().astype(np.int64)
    rcv = flat.receivers.cpu().numpy().astype(np.int64)
    adj = []
    for l in range(batch.graph.num_edge_types):
        sel = real & (etype == l)
        adj.append(np.stack([src[sel] - l * n_pad, rcv[sel]], axis=1))
    return adj


def partition_task_batch(batch, num_partitions: int, n_pad_target: int,
                         e_pad_total: int, parts: Optional[List[int]] = None
                         ) -> Tuple[List[GPShard], int, int]:
    """Partition one padded TaskBatch's mega-graph with FOLD-STATIC shapes:
    n_local from the fold's n_pad, and every partition's streams
    e_pad_total slots long (the batch's whole padded edge budget: all
    receivers on one partition at worst). Returns partition_graph's
    result for `parts` (default: all)."""
    g = batch.graph
    n = int(batch.num_nodes)
    feats = g.node_features.cpu().numpy()[:n]
    feats_padded = np.zeros((n_pad_target, feats.shape[1]), np.float32)
    feats_padded[:n] = feats
    counts = g.typed_incoming_counts.cpu().numpy()[:, :n_pad_target]
    return partition_graph(feats_padded, batch_adjacency(batch),
                           num_partitions, typed_incoming_counts=counts,
                           e_pad=e_pad_total, parts=parts)


def batch_edge_budget(batch) -> int:
    """The fold-static edge pad of a batch (the JAX runtime's e_pad_total:
    its padded edge slots of every type, bucketed)."""
    return bucket_size(int(batch.graph.flat.src_flat.shape[0]), min_size=64)


class GPHaloShard(NamedTuple):
    """One rank's piece for the halo exchange. A layer moves only boundary
    rows: rank q sends rows send_idx[d] to each rank d and receives the
    buffer [P * halo_pad, D], chunk p the rows rank p sent it. The merged
    stream's senders index the EXTENDED table [n_local + P * halo_pad]
    (own rows, then the receive buffer); flat_local's senders and targets
    the rank's own table (type * n_local + local node), flat_remote's
    senders the receive buffer (type * (P * halo_pad) + p * halo_pad +
    slot) and its targets the own table."""

    node_features: Any  # [Nl, F]
    node_mask: Any  # [Nl]
    send_idx: Any  # [P, halo_pad] int32 local rows to send each rank
    src_ext: Any  # [E] int32: type * n_ext + extended sender
    receivers: Any  # [E] int32 LOCAL, sorted; padding -> Nl
    mask: Any  # [E] float32
    norm_scale: Any  # [E] float32
    perm_by_src: Any  # [E] int32
    perm_by_tgt: Any  # [E] int32
    tgt_flat: Any  # [E] int32: type * n_ext + local receiver
    flat_local: Optional[GPFlatEdges] = None
    flat_remote: Optional[GPFlatEdges] = None


def _halo_needs(per_part, n_local: int, num_partitions: int):
    """need[q][p]: the sorted distinct senders owned by partition p that
    partition q's edges read (empty for p == q), for EVERY pair: rank q
    sends need[d][q] to rank d, and halo_pad is the largest of them all,
    so a rank that builds only its own part still needs the whole
    matrix."""
    empty = np.zeros(0, np.int64)
    need = [[empty] * num_partitions for _ in range(num_partitions)]
    for q in range(num_partitions):
        if not per_part[q]:
            continue
        snds = np.concatenate([a[:, 0] for _, a in per_part[q]])
        owner = snds // n_local
        for p in range(num_partitions):
            if p != q:
                need[q][p] = np.unique(snds[owner == p])
    return need


def partition_graph_halo(node_features: np.ndarray,
                         adjacency_lists: List[np.ndarray],
                         num_partitions: int,
                         typed_incoming_counts: np.ndarray = None,
                         e_pad: Optional[int] = None,
                         halo_pad: Optional[int] = None,
                         parts: Optional[List[int]] = None
                         ) -> Tuple[List[GPHaloShard], int, int, int]:
    """Host partitioner for the halo exchange (the JAX package's
    partition_graph_halo): contiguous node ranges, receiver-owned edges,
    per-pair boundary lists. halo_pad (default: the largest boundary list
    over every (receiver, owner) pair, bucketed) and e_pad (default:
    the largest partition's edge count, bucketed) are the same on every
    partition. Returns ([GPHaloShard of numpy arrays] for each partition in
    `parts` (default: all), n_local, n_global, halo_pad)."""
    L = len(adjacency_lists)
    P = num_partitions
    (n_local, n_global, counts, per_part, feats,
     masks) = _partition_prologue(node_features, adjacency_lists, P,
                                  typed_incoming_counts)
    need = _halo_needs(per_part, n_local, P)
    widest = max(len(need[q][p]) for q in range(P) for p in range(P))
    if halo_pad is None:
        halo_pad = bucket_size(max(widest, 1), min_size=8)
    if widest > halo_pad:
        raise ValueError("halo_pad %d is below the widest boundary list, %d "
                         "rows" % (halo_pad, widest))
    if e_pad is None:
        e_pad = bucket_size(max(max(sum(a.shape[0] for _, a in d)
                                    for d in per_part), 1), min_size=64)
    n_halo = P * halo_pad
    n_ext = n_local + n_halo
    shards = []
    for q in range(P) if parts is None else parts:
        lo = q * n_local
        # What this partition sends each other one d: need[d][q]. Padded
        # slots hold row 0; no edge reads them.
        send_idx = np.zeros((P, halo_pad), np.int32)
        for d in range(P):
            if d != q:
                send_idx[d, :len(need[d][q])] = need[d][q] - lo
        # Per type: the merged stream over the extended table, the
        # own-source edges over the own table, the remote-source ones over
        # the receive buffer.
        merged, loc, rem = [], [], []
        for l, adj in per_part[q]:
            owner = adj[:, 0] // n_local
            own = owner == q
            # A remote sender's slot is its place in need[q][owner].
            ext = (adj[:, 0] - lo).astype(np.int64)
            for p in range(P):
                sel = owner == p
                if p != q and sel.any():
                    ext[sel] = (n_local + p * halo_pad
                                + np.searchsorted(need[q][p], adj[sel, 0]))
            rcv = adj[:, 1] - lo
            norms = 1.0 / (counts[l][adj[:, 1]] + SMALL)
            merged.append((l * n_ext + ext, l * n_ext + rcv, rcv, norms))
            loc.append((l * n_local + ext[own], l * n_local + rcv[own],
                        rcv[own], norms[own]))
            rem.append((l * n_halo + ext[~own] - n_local,
                        l * n_local + rcv[~own], rcv[~own], norms[~own]))
        m = _pack_stream(merged, e_pad, L * n_ext, L * n_ext, n_local)
        shards.append(GPHaloShard(
            node_features=feats[q], node_mask=masks[q], send_idx=send_idx,
            src_ext=m.src_flat, receivers=m.receivers, mask=m.mask,
            norm_scale=m.norm_scale, perm_by_src=m.perm_by_src,
            perm_by_tgt=m.perm_by_tgt, tgt_flat=m.tgt_flat,
            flat_local=_pack_stream(loc, e_pad, L * n_local, L * n_local,
                                    n_local),
            flat_remote=_pack_stream(rem, e_pad, L * n_halo, L * n_local,
                                     n_local)))
    return shards, n_local, n_global, halo_pad


def partition_task_batch_halo(batch, num_partitions: int, n_pad_target: int,
                              e_pad_total: int,
                              halo_pad_target: Optional[int] = None,
                              parts: Optional[List[int]] = None
                              ) -> Tuple[List[GPHaloShard], int, int, int]:
    """partition_task_batch's halo twin: one padded TaskBatch's mega-graph
    in GPHaloShards, every stream e_pad_total slots long; halo_pad is
    measured on the batch and bucketed unless `halo_pad_target` pins it.
    Returns partition_graph_halo's result for `parts` (default: all)."""
    g = batch.graph
    n = int(batch.num_nodes)
    feats_padded = np.zeros((n_pad_target, g.node_features.shape[1]),
                            np.float32)
    feats_padded[:n] = g.node_features.cpu().numpy()[:n]
    counts = g.typed_incoming_counts.cpu().numpy()[:, :n_pad_target]
    return partition_graph_halo(feats_padded, batch_adjacency(batch),
                                num_partitions, typed_incoming_counts=counts,
                                e_pad=e_pad_total, halo_pad=halo_pad_target,
                                parts=parts)


def shard_edge_slots(shard) -> int:
    """The edge slots of a shard's streams (either shard type)."""
    if isinstance(shard, GPHaloShard):
        return int(shard.src_ext.shape[0])
    return int(shard.flat.src_flat.shape[0])


def shard_to_device(shard, device):
    """A shard (GPShard or GPHaloShard) of numpy arrays as tensors on
    `device`."""
    def move(x):
        if x is None:
            return None
        if isinstance(x, GPFlatEdges):
            return GPFlatEdges(*map(move, x))
        return torch.as_tensor(x).to(device)

    return type(shard)(*map(move, shard))


# ---------------------------------------------------------------------------
# The collective
# ---------------------------------------------------------------------------


# Bytes and calls of this process's collectives since the last reset
# (each all-gather's gathered output, each reduce-scatter's input, each
# halo all-to-all's receive buffer, forward and backward): what a step
# moves, read by chip_smoke.py's gp and halo phases.
TRAFFIC = {"all_gather_bytes": 0, "all_gather_calls": 0,
           "reduce_scatter_bytes": 0, "reduce_scatter_calls": 0,
           "all_to_all_bytes": 0, "all_to_all_calls": 0,
           "all_to_all_bwd_bytes": 0, "all_to_all_bwd_calls": 0}


def reset_traffic() -> None:
    for k in TRAFFIC:
        TRAFFIC[k] = 0


class _AllGatherStack(torch.autograd.Function):
    """[S0, *S] on each of P ranks -> [P * S0, *S], the ranks' pieces in
    rank order, started asynchronously: the output is valid only after
    `pending.work.wait()`. The backward reduce-scatters the cotangent
    (SUM): rank p gets the sum over ranks of their cotangents of its
    piece, the transpose of the all-gather."""

    @staticmethod
    def forward(ctx, x, pending):
        ctx.group = pending.group
        size = world(pending.group)[1]
        x = x.contiguous()
        out = x.new_empty((size * x.shape[0],) + tuple(x.shape[1:]))
        pending.work = dist.all_gather_into_tensor(
            out, x, group=pending.group, async_op=True)
        TRAFFIC["all_gather_bytes"] += out.numel() * out.element_size()
        TRAFFIC["all_gather_calls"] += 1
        return out

    @staticmethod
    def backward(ctx, g):
        out = g.new_empty((g.shape[0] // world(ctx.group)[1],)
                          + tuple(g.shape[1:]))
        dist.reduce_scatter_tensor(out, g.contiguous(),
                                   op=dist.ReduceOp.SUM, group=ctx.group)
        TRAFFIC["reduce_scatter_bytes"] += g.numel() * g.element_size()
        TRAFFIC["reduce_scatter_calls"] += 1
        return out, None


class PendingGather:
    """Every rank's `x` gathered along `dim`, started at construction and
    in flight until wait(), which returns it tiled along `dim`: [..., P *
    n, ...] with rank p's rows at [p * n, (p + 1) * n), the JAX package's
    all_gather(axis=dim, tiled=True)."""

    def __init__(self, x, dim: int, group=None):
        self.group, self.dim, self.work = group, dim, None
        self.shape = tuple(x.shape)
        self._stacked = _AllGatherStack.apply(x, self)

    def wait(self):
        self.work.wait()
        # [P * n0, ...] -> [P, *shape] -> [..., P, n, ...] -> [..., P * n, ...]
        out = self._stacked.view((-1,) + self.shape).movedim(0, self.dim)
        shape = list(out.shape)
        shape[self.dim:self.dim + 2] = [shape[self.dim] * shape[self.dim + 1]]
        return out.reshape(shape)


def all_gather(x, dim: int, group=None):
    """Every rank's `x`, tiled along `dim` (differentiable: the backward
    is a reduce-scatter of the cotangent)."""
    return PendingGather(x, dim, group).wait()


class _AllToAllHalo(torch.autograd.Function):
    """[P * halo_pad, D] on each of P ranks: chunk d of rank q's input goes
    to rank d, and chunk p of the output is what rank p sent this rank
    (the JAX package's all_to_all(split_axis=0, concat_axis=0,
    tiled=False)), started asynchronously: the output is valid only after
    `pending.work.wait()`. The backward is the same exchange of the
    cotangent, the roles transposed: the cotangent of the rows this rank
    received from rank p goes back to rank p, into its chunk for this
    rank."""

    @staticmethod
    def forward(ctx, send, pending):
        ctx.group = pending.group
        send = send.contiguous()
        out = torch.empty_like(send)
        pending.work = dist.all_to_all_single(out, send, group=pending.group,
                                              async_op=True)
        TRAFFIC["all_to_all_bytes"] += out.numel() * out.element_size()
        TRAFFIC["all_to_all_calls"] += 1
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        out = torch.empty_like(g)
        dist.all_to_all_single(out, g, group=ctx.group)
        TRAFFIC["all_to_all_bwd_bytes"] += out.numel() * out.element_size()
        TRAFFIC["all_to_all_bwd_calls"] += 1
        return out, None


class PendingHalo:
    """The boundary rows every peer sends this rank, started at
    construction (the rows send_idx[d] of h_local to each rank d) and in
    flight until wait(), which returns the receive buffer [P * halo_pad,
    D] grouped by source rank: the space flat_remote's senders index."""

    def __init__(self, h_local, send_idx, group=None):
        self.group, self.work = group, None
        send = h_local.index_select(0, send_idx.reshape(-1))
        self._recv = _AllToAllHalo.apply(send, self)

    def wait(self):
        self.work.wait()
        return self._recv


# ---------------------------------------------------------------------------
# The seven families' layers over a shard
# ---------------------------------------------------------------------------


def _flat(t):
    return t.reshape(t.shape[0] * t.shape[1], *t.shape[2:])


def _overlap_split_ok(shard: GPShard) -> bool:
    return (getattr(shard, "flat_local", None) is not None
            and getattr(shard, "flat_remote", None) is not None)


def _aggregate_part(msgs, flat_s, n_local: int, aggregation: str):
    """One stream's part of a receiver aggregation (_combine joins the
    parts; the JAX package's _aggregate_split in two halves, so that the
    local stream's part is formed before the all-gather's wait): its sums
    (and edge counts for mean / sqrt_n), or its maxima."""
    if aggregation in ("sum", "unsorted_segment_sum"):
        return (aggregate_flat_sum(msgs, flat_s, n_local),)
    if aggregation in ("mean", "unsorted_segment_mean",
                       "sqrt_n", "unsorted_segment_sqrt_n"):
        count = segment_sum(flat_s.mask, flat_s.receivers,
                            n_local + 1)[:n_local]
        return aggregate_flat_sum(msgs, flat_s, n_local), count
    return (aggregate_flat(msgs, flat_s, n_local, aggregation),)


def _combine(parts, aggregation: str):
    """The aggregation over the streams whose _aggregate_part's are
    `parts` (each stream a disjoint subset of the receivers' edges): the
    JAX package's _aggregate_split (sum: local + remote in that order;
    mean / sqrt_n over the summed counts; max: the larger, empty parts at
    the dtype's minimum on both sides)."""
    if aggregation in ("max", "unsorted_segment_max"):
        out = parts[0][0]
        for p in parts[1:]:
            out = torch.maximum(out, p[0])
        return out
    total = parts[0][0]
    for p in parts[1:]:
        total = total + p[0]
    if len(parts[0]) == 1:
        return total
    count = parts[0][1]
    for p in parts[1:]:
        count = count + p[1]
    count = count.clamp(min=1.0)
    if aggregation.endswith("sqrt_n"):
        count = torch.sqrt(count)
    return total / count.reshape(count.shape + (1,) * (total.dim() - 1))


def _local_tgt_view(flat_s: GPFlatEdges, n_local: int, table_rows: int,
                    L: int) -> GPFlatEdges:
    """A stream with its tgt indices in the LOCAL table space (targets are
    always local rows; only the index space differs). The by-tgt order is
    the same in both spaces."""
    et = torch.clamp(flat_s.src_flat // table_rows, max=L)
    return flat_s._replace(
        tgt_flat=et * n_local + torch.clamp(flat_s.receivers, max=n_local))


def gp_rgcn_layer(W, shard: GPShard, h_local, group, activation_fn,
                  normalize: bool = True):
    """One RGCN layer over the merged stream (make_gp_forward's form):
    transform locally, all-gather the typed transforms, gather + segment
    sum locally. h_local [Nl, D], W [L, D, D]."""
    n_local = h_local.shape[0]
    t_full = all_gather(typed_transform(h_local, W), 1, group)
    msgs = gather_flat_src(_flat(t_full), shard.flat)
    if normalize:
        msgs = msgs * shard.flat.norm_scale[:, None]
    return activation_fn(aggregate_flat(msgs, shard.flat, n_local, "sum"))


def gp_film_layer(W, W_film, ln_params, shard: GPShard, h_local, group,
                  activation_fn):
    """One GNN-FiLM layer over the merged stream (make_gp_forward's
    form)."""
    n_local, d = h_local.shape
    t_full = all_gather(typed_transform(h_local, W), 1, group)
    film_full = all_gather(typed_transform(h_local, W_film), 1, group)
    m = gather_flat_src(_flat(t_full), shard.flat)
    gb = gather_flat_tgt(_flat(film_full), shard.flat)
    msgs = activation_fn(gb[:, :d] * m + gb[:, d:])
    return layer_norm(ln_params, aggregate_flat(msgs, shard.flat, n_local,
                                                "sum"))


def gp_ggnn_layer(gnn_params, shard: GPShard, h_local, group, *,
                  num_timesteps=1, gated_unit_type="gru",
                  activation_function="tanh",
                  message_aggregation_function="sum", **_):
    """GGNN over the partition: messages from the all-gathered typed
    transform table; the cell update is per node and local."""
    n_local = h_local.shape[0]
    agg_fn = message_aggregation_function
    c = None
    for _ in range(num_timesteps):
        t_local = typed_transform(h_local, gnn_params["W"])
        pending = PendingGather(t_local, 1, group)
        if _overlap_split_ok(shard):
            fl, fr = shard.flat_local, shard.flat_remote
            loc = _aggregate_part(gather_flat_src(_flat(t_local), fl), fl,
                                  n_local, agg_fn)
            t_full = pending.wait()
            rem = _aggregate_part(gather_flat_src(_flat(t_full), fr), fr,
                                  n_local, agg_fn)
            agg = _combine([loc, rem], agg_fn)
        else:
            msgs = gather_flat_src(_flat(pending.wait()), shard.flat)
            agg = aggregate_flat(msgs, shard.flat, n_local, agg_fn)
        h_local, c = cell_apply(gnn_params["cell"], gated_unit_type, agg,
                                h_local, activation_function, c)
    return h_local


def gp_rgcn_layer_kw(gnn_params, shard: GPShard, h_local, group, *,
                     num_timesteps=1, activation_function="tanh",
                     message_aggregation_function="sum",
                     normalize_by_num_incoming=True,
                     use_both_source_and_target=False, **_):
    """RGCN over the partition with the layer's full keyword surface.
    With the source-ownership split, the local-source messages are
    gathered from the rank's own table and aggregated while the
    all-gather is in flight; only the remote-source edges wait."""
    act = get_activation(activation_function)
    agg_fn = message_aggregation_function
    n_local, d = h_local.shape
    W = gnn_params["W"]
    for _ in range(num_timesteps):
        if use_both_source_and_target:
            src_full = all_gather(typed_transform(h_local, W[:, :d, :]), 1,
                                  group)
            tgt_full = all_gather(typed_transform(h_local, W[:, d:, :]), 1,
                                  group)
            msgs = (gather_flat_src(_flat(src_full), shard.flat)
                    + gather_flat_tgt(_flat(tgt_full), shard.flat))
            if normalize_by_num_incoming:
                msgs = msgs * shard.flat.norm_scale[:, None]
            h_local = act(aggregate_flat(msgs, shard.flat, n_local, agg_fn))
            continue
        t_local = typed_transform(h_local, W)
        pending = PendingGather(t_local, 1, group)

        def messages(table, flat_s):
            m = gather_flat_src(table, flat_s)
            if normalize_by_num_incoming:
                m = m * flat_s.norm_scale[:, None]
            return m

        if _overlap_split_ok(shard):
            fl, fr = shard.flat_local, shard.flat_remote
            loc = _aggregate_part(messages(_flat(t_local), fl), fl, n_local,
                                  agg_fn)
            rem = _aggregate_part(messages(_flat(pending.wait()), fr), fr,
                                  n_local, agg_fn)
            h_local = act(_combine([loc, rem], agg_fn))
            continue
        msgs = messages(_flat(pending.wait()), shard.flat)
        h_local = act(aggregate_flat(msgs, shard.flat, n_local, agg_fn))
    return h_local


def gp_rgat_layer(gnn_params, shard: GPShard, h_local, group, *,
                  num_timesteps=1, num_heads=4, activation_function="tanh",
                  **_):
    """RGAT over the partition: attention logits from node-side halves of
    the all-gathered table; the per-(receiver, head) softmax is local,
    since edges live on their receiver's rank."""
    act = get_activation(activation_function)
    n_local, state_dim = h_local.shape
    head_dim = state_dim // num_heads
    att = gnn_params["att"].reshape(-1, num_heads, 2 * head_dim)
    att_src, att_tgt = att[..., :head_dim], att[..., head_dim:]
    flat = shard.flat
    for _ in range(num_timesteps):
        t_full = all_gather(typed_transform(h_local, gnn_params["W"]), 1,
                            group)
        L, n_global, _ = t_full.shape
        t_heads = t_full.reshape(L, n_global, num_heads, head_dim)
        logit_src = torch.einsum("lnkd,lkd->lnk", t_heads, att_src)
        logit_tgt = torch.einsum("lnkd,lkd->lnk", t_heads, att_tgt)
        logits = get_activation("leaky_relu")(
            _take_clip(_flat(logit_src), flat.src_flat)
            + _take_clip(_flat(logit_tgt), flat.tgt_flat))
        msgs = gather_flat_src(_flat(t_full), flat).reshape(
            -1, num_heads, head_dim)
        attn = segment_softmax_flat(logits, flat, n_local)
        agg = aggregate_flat_sum(msgs * attn[..., None], flat, n_local)
        h_local = act(agg.reshape(n_local, state_dim))
    return h_local


def gp_film_layer_kw(gnn_params, shard: GPShard, h_local, group, *,
                     num_timesteps=1, activation_function="relu",
                     message_aggregation_function="sum",
                     normalize_by_num_incoming=False, **_):
    """GNN-FiLM over the partition with the full keyword surface. With the
    source-ownership split only the message transform is gathered: gamma
    and beta come from the local FiLM table (the target is always local),
    and the local-source half of the layer runs while the all-gather is
    in flight."""
    act = get_activation(activation_function)
    agg_fn = message_aggregation_function
    n_local, d = h_local.shape
    for _ in range(num_timesteps):
        t_local = typed_transform(h_local, gnn_params["W"])
        f_local = typed_transform(h_local, gnn_params["W_film"])
        L = t_local.shape[0]
        pending = PendingGather(t_local, 1, group)

        def modulated(table, flat_s, film_table, film_flat):
            m = gather_flat_src(table, flat_s)
            if normalize_by_num_incoming:
                m = m * flat_s.norm_scale[:, None]
            gb = gather_flat_tgt(film_table, film_flat)
            return act(gb[:, :d] * m + gb[:, d:])

        if _overlap_split_ok(shard):
            fl, fr = shard.flat_local, shard.flat_remote
            f_table = _flat(f_local)
            loc = _aggregate_part(modulated(_flat(t_local), fl, f_table, fl),
                                  fl, n_local, agg_fn)
            t_full = pending.wait()
            fr_local_tgt = _local_tgt_view(fr, n_local, t_full.shape[1], L)
            rem = _aggregate_part(
                modulated(_flat(t_full), fr, f_table, fr_local_tgt), fr,
                n_local, agg_fn)
            h_local = layer_norm(gnn_params["ln"], _combine([loc, rem],
                                                            agg_fn))
            continue
        f_full = all_gather(f_local, 1, group)
        msgs = modulated(_flat(pending.wait()), shard.flat, _flat(f_full),
                         shard.flat)
        h_local = layer_norm(gnn_params["ln"], aggregate_flat(
            msgs, shard.flat, n_local, agg_fn))
    return h_local


def _typed_mlp_tail(m, et, weights, inner_act, L: int):
    """The per-edge typed MLP stages after the first (linear, node-side)
    one, as type-masked matmuls (padded edges decode to type L: every mask
    false, a zero message into the dump row)."""
    for W in weights[1:]:
        z = inner_act(m)
        out = None
        for l in range(L):
            part = torch.matmul(z, W[l]) * (et == l).to(z.dtype)[:, None]
            out = part if out is None else out + part
        m = out
    return m


def _gp_typed_mlp_messages(weights, shard: GPShard, h_local, group,
                           concat_target: bool, inner_act, reduce_stream):
    """Per-edge typed-MLP messages over the partition, each stream's
    reduced by `reduce_stream(messages, stream)` as soon as it is formed:
    the first (linear) MLP layer node-side on the gathered typed tables
    (concat(source, target) split into source and target halves), the
    later ones per edge (_typed_mlp_tail). With the source-ownership split
    the local stream (own tables; target tables are always local) is
    formed and reduced while the all-gather is in flight. Returns
    (local part, remote part), or (merged part, None) without the
    split."""
    W0 = weights[0]
    n_local, d = h_local.shape
    split = _overlap_split_ok(shard)
    if concat_target:
        ts_l = typed_transform(h_local, W0[:, :d, :])
        tt_l = typed_transform(h_local, W0[:, d:, :])
    else:
        ts_l = typed_transform(h_local, W0)
    L = ts_l.shape[0]
    pending = PendingGather(ts_l, 1, group)

    def tail(m, flat_s, table_rows):
        et = torch.clamp(flat_s.src_flat // table_rows, max=L)
        return reduce_stream(_typed_mlp_tail(m, et, weights, inner_act, L),
                             flat_s)

    if split:
        fl, fr = shard.flat_local, shard.flat_remote
        m_loc = gather_flat_src(_flat(ts_l), fl)
        if concat_target:
            m_loc = m_loc + gather_flat_tgt(_flat(tt_l), fl)
        loc = tail(m_loc, fl, n_local)
        ts = pending.wait()
        n_global = ts.shape[1]
        m_rem = gather_flat_src(_flat(ts), fr)
        if concat_target:
            m_rem = m_rem + gather_flat_tgt(
                _flat(tt_l), _local_tgt_view(fr, n_local, n_global, L))
        return loc, tail(m_rem, fr, n_global)
    ts = pending.wait()
    m = gather_flat_src(_flat(ts), shard.flat)
    if concat_target:
        tt = all_gather(tt_l, 1, group)
        m = m + gather_flat_tgt(_flat(tt), shard.flat)
    return tail(m, shard.flat, ts.shape[1]), None


def gp_rgin_layer(gnn_params, shard: GPShard, h_local, group, *,
                  num_timesteps=1, activation_function="relu",
                  message_aggregation_function="sum",
                  use_target_state_as_input=False,
                  num_edge_MLP_hidden_layers=1,
                  num_aggr_MLP_hidden_layers=None, **_):
    """RGIN over the partition: per-type edge MLPs, the activation on the
    messages, the optional aggregation MLP, then activation and LayerNorm
    (reference gnns/rgin.py:77-139)."""
    act = get_activation(activation_function)
    agg_fn = message_aggregation_function
    n_local = h_local.shape[0]
    for _ in range(num_timesteps):
        if num_edge_MLP_hidden_layers is not None:
            loc, rem = _gp_typed_mlp_messages(
                gnn_params["edge_mlp"], shard, h_local, group,
                use_target_state_as_input, act,
                lambda m, f: _aggregate_part(act(m), f, n_local, agg_fn))
        else:
            # Raw source states as messages: one all-gather of h; the
            # message does not depend on the type, so the type-offset
            # index reduces modulo the table's rows.
            pending = PendingGather(h_local, 0, group)

            def raw(table, flat_s):
                m = _take_clip(table, flat_s.src_flat % table.shape[0])
                return _aggregate_part(m * flat_s.mask[:, None], flat_s,
                                       n_local, agg_fn)

            if _overlap_split_ok(shard):
                loc = raw(h_local, shard.flat_local)
                rem = raw(pending.wait(), shard.flat_remote)
            else:
                loc, rem = raw(pending.wait(), shard.flat), None
        agg = _combine([loc] if rem is None else [loc, rem], agg_fn)
        if num_aggr_MLP_hidden_layers is not None:
            agg = mlp_apply(gnn_params["aggr_mlp"], agg, act)
        h_local = layer_norm(gnn_params["ln"], act(agg))
    return h_local


def gp_gnn_edge_mlp_layer(gnn_params, shard: GPShard, h_local, group, *,
                          num_timesteps=1, activation_function="relu",
                          message_aggregation_function="sum",
                          normalize_by_num_incoming=False,
                          use_target_state_as_input=True,
                          num_edge_hidden_layers=1, **_):
    """GNN-Edge-MLP over the partition: the fixed elu inner activation,
    the optional 1/c scaling of the MLP output, the activation on the
    messages, LayerNorm after aggregation (reference
    gnns/gnn_edge_mlp.py:73-119)."""
    act = get_activation(activation_function)
    elu = get_activation("elu")
    agg_fn = message_aggregation_function
    n_local = h_local.shape[0]

    def reduce_stream(m, flat_s):
        if normalize_by_num_incoming:
            m = m * flat_s.norm_scale[:, None]
        return _aggregate_part(act(m), flat_s, n_local, agg_fn)

    for _ in range(num_timesteps):
        loc, rem = _gp_typed_mlp_messages(
            gnn_params["edge_mlp"], shard, h_local, group,
            use_target_state_as_input, elu, reduce_stream)
        h_local = layer_norm(gnn_params["ln"], _combine(
            [loc] if rem is None else [loc, rem], agg_fn))
    return h_local


def gp_rgdcn_layer(gnn_params, shard: GPShard, h_local, group, *,
                   num_timesteps=1, num_channels=8, channel_dim=None,
                   use_full_state_for_channel_weights=False,
                   tie_channel_weights=False, activation_function="relu",
                   message_aggregation_function="sum",
                   normalize_by_num_incoming=True, **_):
    """RGDCN over the partition in the aggregate-first form: one
    all-gather of the raw states a timestep, per-(type, local receiver)
    neighbour sums, and node-local dynamic-kernel contractions (the
    kernels depend on the target state, which the rank owns)."""
    _rgdcn_check_sum(message_aggregation_function)
    W_wc = gnn_params["W_wc"]
    n_local, L = h_local.shape[0], W_wc.shape[0]
    for _ in range(num_timesteps):
        pending = PendingGather(h_local, 0, group)
        if _overlap_split_ok(shard):
            S = _rgdcn_typed_sums(h_local, shard.flat_local, n_local, L,
                                  normalize_by_num_incoming)
            S = S + _rgdcn_typed_sums(pending.wait(), shard.flat_remote,
                                      n_local, L, normalize_by_num_incoming)
        else:
            S = _rgdcn_typed_sums(pending.wait(), shard.flat, n_local, L,
                                  normalize_by_num_incoming)
        h_local = _rgdcn_contract(
            W_wc, h_local, S, num_channels, channel_dim,
            use_full_state_for_channel_weights, tie_channel_weights,
            get_activation(activation_function))
    return h_local


def _rgdcn_check_sum(message_aggregation_function) -> None:
    if message_aggregation_function not in ("sum", "unsorted_segment_sum"):
        raise ValueError("graph-parallel RGDCN supports sum aggregation, "
                         "got %r" % message_aggregation_function)


def _rgdcn_typed_sums(table, flat_s, n_local: int, L: int, normalize: bool):
    """Per-(type, local receiver) sums [L, Nl, D] of the raw sender rows of
    one stream (the type-offset index reduces modulo the table's rows),
    scaled by 1/c or masked."""
    rows = table.shape[0]
    m = _take_clip(table, flat_s.src_flat % rows)
    m = m * (flat_s.norm_scale if normalize else flat_s.mask)[:, None]
    et = torch.clamp(flat_s.src_flat // rows, max=L)
    seg = et * (n_local + 1) + torch.clamp(flat_s.receivers, max=n_local)
    S = segment_sum(m, seg, (L + 1) * (n_local + 1))
    return S.reshape(L + 1, n_local + 1, -1)[:L, :n_local]


def _rgdcn_contract(W_wc, h_local, S, num_channels, channel_dim,
                    use_full_state_for_channel_weights, tie_channel_weights,
                    act):
    """The node-local dynamic-kernel contractions of the neighbour sums S
    [L, Nl, D], summed over the types, then the activation."""
    n_local, L = h_local.shape[0], W_wc.shape[0]
    if channel_dim is None:
        channel_dim = h_local.shape[-1] // num_channels
    h_chunked = h_local.reshape(n_local, num_channels, channel_dim)
    S_chunk = S.reshape(L, n_local, num_channels, channel_dim)
    out = None
    for l in range(L):
        part = _rgdcn_type_contraction(
            h_local, h_chunked, S_chunk[l], W_wc[l], act, channel_dim,
            use_full_state_for_channel_weights, tie_channel_weights)
        out = part if out is None else out + part
    return act(out).reshape(n_local, num_channels * channel_dim)


GP_LAYERS = {
    "rgcn": gp_rgcn_layer_kw,
    "gnn_film": gp_film_layer_kw,
    "ggnn": gp_ggnn_layer,
    "rgat": gp_rgat_layer,
    "rgin": gp_rgin_layer,
    "gnn_edge_mlp": gp_gnn_edge_mlp_layer,
    "rgdcn": gp_rgdcn_layer,
}


# ---------------------------------------------------------------------------
# The halo exchange: boundary rows only, one all-to-all a timestep
# ---------------------------------------------------------------------------


def _halo_flat(shard: GPHaloShard) -> GPFlatEdges:
    """The merged stream of a GPHaloShard as a GPFlatEdges (senders in the
    extended table's space; the JAX package's _HaloFlat)."""
    return GPFlatEdges(shard.src_ext, shard.receivers, shard.tgt_flat,
                       shard.mask, shard.norm_scale, shard.perm_by_src,
                       shard.perm_by_tgt)


def _halo_exchange(shard: GPHaloShard, h_local, group):
    """The extended table [n_local + P * halo_pad, D]: own rows, then the
    boundary rows of every peer."""
    return torch.cat([h_local,
                      PendingHalo(h_local, shard.send_idx, group).wait()])


def gp_halo_rgcn_layer(W, shard: GPHaloShard, h_local, group, activation_fn,
                       normalize: bool = True):
    """One RGCN layer over the halo partition's merged stream: exchange
    the boundary rows (P * halo_pad * D), transform the extended table
    locally, gather and segment-sum into local receivers."""
    n_local = h_local.shape[0]
    flat = _halo_flat(shard)
    t = typed_transform(_halo_exchange(shard, h_local, group), W)
    msgs = gather_flat_src(_flat(t), flat)
    if normalize:
        msgs = msgs * flat.norm_scale[:, None]
    return activation_fn(aggregate_flat(msgs, flat, n_local, "sum"))


def gp_film_halo_layer(gnn_params, shard: GPHaloShard, h_local, group, *,
                       num_timesteps=1, activation_function="relu",
                       message_aggregation_function="sum",
                       normalize_by_num_incoming=False, **_):
    """GNN-FiLM over the halo partition's merged stream: exchange the
    boundary rows a timestep, then transform and modulate on the extended
    table."""
    act = get_activation(activation_function)
    n_local, d = h_local.shape
    flat = _halo_flat(shard)
    for _ in range(num_timesteps):
        ext = _halo_exchange(shard, h_local, group)
        m = gather_flat_src(_flat(typed_transform(ext, gnn_params["W"])),
                            flat)
        if normalize_by_num_incoming:
            m = m * flat.norm_scale[:, None]
        gb = gather_flat_tgt(_flat(typed_transform(ext,
                                                   gnn_params["W_film"])),
                             flat)
        msgs = act(gb[:, :d] * m + gb[:, d:])
        h_local = layer_norm(gnn_params["ln"], aggregate_flat(
            msgs, flat, n_local, message_aggregation_function))
    return h_local


def _take_rcv(table, flat_s):
    """Per-edge row of a receiver-indexed [n_local (+1), ...] table; padded
    edges (receiver n_local) read its last row."""
    return _take_clip(table, flat_s.receivers)


def _segment_softmax_split(logits_loc, fl, logits_rem, fr, n_local: int):
    """The receiver softmax jointly over both streams (a receiver's
    attention normalizes over all its incoming edges, whichever stream
    carries them), as segment_softmax_flat over one."""
    neg = torch.finfo(logits_loc.dtype).min
    masked_loc = torch.where(fl.mask[:, None] > 0, logits_loc, neg)
    masked_rem = torch.where(fr.mask[:, None] > 0, logits_rem, neg)
    gmax = torch.maximum(
        segment_max(masked_loc, fl.receivers, n_local + 1),
        segment_max(masked_rem, fr.receivers, n_local + 1))
    ex_loc = torch.exp(masked_loc - _take_rcv(gmax, fl)) * fl.mask[:, None]
    ex_rem = torch.exp(masked_rem - _take_rcv(gmax, fr)) * fr.mask[:, None]
    denom = (segment_sum(ex_loc, fl.receivers, n_local + 1)
             + segment_sum(ex_rem, fr.receivers, n_local + 1))
    return (ex_loc / (_take_rcv(denom, fl) + SMALL),
            ex_rem / (_take_rcv(denom, fr) + SMALL))


# Every family layer below runs one timestep in PyTorch's form of the
# overlap: start the exchange, form (and where the aggregation allows,
# reduce) the flat_local stream from h_local alone, wait(), then the
# flat_remote stream from the receive buffer, and combine the two as the
# JAX package's _aggregate_split does.


def gp_halo_rgcn_layer_kw(gnn_params, shard: GPHaloShard, h_local, group, *,
                          num_timesteps=1, activation_function="tanh",
                          message_aggregation_function="sum",
                          normalize_by_num_incoming=True,
                          use_both_source_and_target=False, **_):
    """RGCN over the halo partition; the target half of
    use_both_source_and_target comes from the own table (targets are
    local)."""
    act = get_activation(activation_function)
    agg_fn = message_aggregation_function
    n_local, d = h_local.shape
    W = gnn_params["W"]
    W_src = W[:, :d, :] if use_both_source_and_target else W
    fl, fr = shard.flat_local, shard.flat_remote
    for _ in range(num_timesteps):
        pending = PendingHalo(h_local, shard.send_idx, group)
        tgt_table = (_flat(typed_transform(h_local, W[:, d:, :]))
                     if use_both_source_and_target else None)

        def messages(rows, flat_s):
            m = gather_flat_src(_flat(typed_transform(rows, W_src)), flat_s)
            if tgt_table is not None:
                m = m + gather_flat_tgt(tgt_table, flat_s)
            if normalize_by_num_incoming:
                m = m * flat_s.norm_scale[:, None]
            return _aggregate_part(m, flat_s, n_local, agg_fn)

        loc = messages(h_local, fl)
        rem = messages(pending.wait(), fr)
        h_local = act(_combine([loc, rem], agg_fn))
    return h_local


def gp_halo_ggnn_layer(gnn_params, shard: GPHaloShard, h_local, group, *,
                       num_timesteps=1, gated_unit_type="gru",
                       activation_function="tanh",
                       message_aggregation_function="sum", **_):
    """GGNN over the halo partition: the messages are the cell's input;
    the cell update is per node and local."""
    agg_fn = message_aggregation_function
    n_local = h_local.shape[0]
    fl, fr = shard.flat_local, shard.flat_remote
    c = None
    for _ in range(num_timesteps):
        pending = PendingHalo(h_local, shard.send_idx, group)

        def part(rows, flat_s):
            m = gather_flat_src(_flat(typed_transform(rows,
                                                      gnn_params["W"])),
                                flat_s)
            return _aggregate_part(m, flat_s, n_local, agg_fn)

        loc = part(h_local, fl)
        agg = _combine([loc, part(pending.wait(), fr)], agg_fn)
        h_local, c = cell_apply(gnn_params["cell"], gated_unit_type, agg,
                                h_local, activation_function, c)
    return h_local


def gp_halo_rgat_layer(gnn_params, shard: GPHaloShard, h_local, group, *,
                       num_timesteps=1, num_heads=4,
                       activation_function="tanh", **_):
    """RGAT over the halo partition: the logits' source half from the own
    or the halo typed table, the target half from the own one; the
    per-(receiver, head) softmax over both streams jointly, so only the
    local stream's messages and logits are formed before the wait."""
    act = get_activation(activation_function)
    leaky = get_activation("leaky_relu")
    n_local, state_dim = h_local.shape
    head_dim = state_dim // num_heads
    att = gnn_params["att"].reshape(-1, num_heads, 2 * head_dim)
    att_src, att_tgt = att[..., :head_dim], att[..., head_dim:]
    fl, fr = shard.flat_local, shard.flat_remote
    for _ in range(num_timesteps):
        pending = PendingHalo(h_local, shard.send_idx, group)
        t_loc = typed_transform(h_local, gnn_params["W"])
        L = t_loc.shape[0]
        lt_table = _flat(torch.einsum("lnkd,lkd->lnk", t_loc.reshape(
            L, n_local, num_heads, head_dim), att_tgt))

        def stream(t, flat_s):
            heads = t.reshape(L, -1, num_heads, head_dim)
            ls = _flat(torch.einsum("lnkd,lkd->lnk", heads, att_src))
            logits = leaky(_take_clip(ls, flat_s.src_flat)
                           + _take_clip(lt_table, flat_s.tgt_flat))
            return logits, gather_flat_src(_flat(t), flat_s)

        logits_loc, m_loc = stream(t_loc, fl)
        logits_rem, m_rem = stream(typed_transform(pending.wait(),
                                                   gnn_params["W"]), fr)
        attn_loc, attn_rem = _segment_softmax_split(logits_loc, fl,
                                                    logits_rem, fr, n_local)

        def weighted(m, attn, flat_s):
            w = (m.reshape(-1, num_heads, head_dim)
                 * attn[..., None]).reshape(-1, state_dim)
            return _aggregate_part(w, flat_s, n_local, "sum")

        h_local = act(_combine([weighted(m_loc, attn_loc, fl),
                                weighted(m_rem, attn_rem, fr)], "sum"))
    return h_local


def gp_halo_film_layer_kw(gnn_params, shard: GPHaloShard, h_local, group, *,
                          num_timesteps=1, activation_function="relu",
                          message_aggregation_function="sum",
                          normalize_by_num_incoming=False, **_):
    """GNN-FiLM over the halo partition: gamma and beta from the own FiLM
    table (targets are local), so only the message transform touches
    halo rows."""
    act = get_activation(activation_function)
    agg_fn = message_aggregation_function
    n_local, d = h_local.shape
    fl, fr = shard.flat_local, shard.flat_remote
    for _ in range(num_timesteps):
        pending = PendingHalo(h_local, shard.send_idx, group)
        f_table = _flat(typed_transform(h_local, gnn_params["W_film"]))

        def modulated(rows, flat_s):
            m = gather_flat_src(_flat(typed_transform(rows,
                                                      gnn_params["W"])),
                                flat_s)
            if normalize_by_num_incoming:
                m = m * flat_s.norm_scale[:, None]
            gb = gather_flat_tgt(f_table, flat_s)
            return _aggregate_part(act(gb[:, :d] * m + gb[:, d:]), flat_s,
                                   n_local, agg_fn)

        loc = modulated(h_local, fl)
        rem = modulated(pending.wait(), fr)
        h_local = layer_norm(gnn_params["ln"], _combine([loc, rem], agg_fn))
    return h_local


def _halo_typed_mlp_messages(weights, shard: GPHaloShard, h_local, pending,
                             concat_target: bool, inner_act, reduce_stream):
    """_gp_typed_mlp_messages' halo twin: the first (linear) MLP layer
    node-side on the own and the halo typed tables (target halves always
    from the own one), the later ones per edge; each stream reduced by
    `reduce_stream(messages, stream)` as soon as it is formed, the local
    one before `pending` (the exchange) is waited for. Returns (local
    part, remote part)."""
    W0 = weights[0]
    n_local, d = h_local.shape
    L = W0.shape[0]
    W_src = W0[:, :d, :] if concat_target else W0
    tt_table = (_flat(typed_transform(h_local, W0[:, d:, :]))
                if concat_target else None)

    def stream(rows, flat_s):
        m = gather_flat_src(_flat(typed_transform(rows, W_src)), flat_s)
        if tt_table is not None:
            m = m + gather_flat_tgt(tt_table, flat_s)
        et = torch.clamp(flat_s.src_flat // rows.shape[0], max=L)
        return reduce_stream(_typed_mlp_tail(m, et, weights, inner_act, L),
                             flat_s)

    loc = stream(h_local, shard.flat_local)
    return loc, stream(pending.wait(), shard.flat_remote)


def gp_halo_rgin_layer(gnn_params, shard: GPHaloShard, h_local, group, *,
                       num_timesteps=1, activation_function="relu",
                       message_aggregation_function="sum",
                       use_target_state_as_input=False,
                       num_edge_MLP_hidden_layers=1,
                       num_aggr_MLP_hidden_layers=None, **_):
    """RGIN over the halo partition (gp_rgin_layer's schedule)."""
    act = get_activation(activation_function)
    agg_fn = message_aggregation_function
    n_local = h_local.shape[0]
    fl, fr = shard.flat_local, shard.flat_remote
    for _ in range(num_timesteps):
        pending = PendingHalo(h_local, shard.send_idx, group)
        if num_edge_MLP_hidden_layers is not None:
            loc, rem = _halo_typed_mlp_messages(
                gnn_params["edge_mlp"], shard, h_local, pending,
                use_target_state_as_input, act,
                lambda m, f: _aggregate_part(act(m), f, n_local, agg_fn))
        else:
            # Raw source states as messages.
            def raw(table, flat_s):
                m = _take_clip(table, flat_s.src_flat % table.shape[0])
                return _aggregate_part(m * flat_s.mask[:, None], flat_s,
                                       n_local, agg_fn)

            loc = raw(h_local, fl)
            rem = raw(pending.wait(), fr)
        agg = _combine([loc, rem], agg_fn)
        if num_aggr_MLP_hidden_layers is not None:
            agg = mlp_apply(gnn_params["aggr_mlp"], agg, act)
        h_local = layer_norm(gnn_params["ln"], act(agg))
    return h_local


def gp_halo_gnn_edge_mlp_layer(gnn_params, shard: GPHaloShard, h_local,
                               group, *, num_timesteps=1,
                               activation_function="relu",
                               message_aggregation_function="sum",
                               normalize_by_num_incoming=False,
                               use_target_state_as_input=True,
                               num_edge_hidden_layers=1, **_):
    """GNN-Edge-MLP over the halo partition (gp_gnn_edge_mlp_layer's
    schedule)."""
    act = get_activation(activation_function)
    elu = get_activation("elu")
    agg_fn = message_aggregation_function
    n_local = h_local.shape[0]

    def reduce_stream(m, flat_s):
        if normalize_by_num_incoming:
            m = m * flat_s.norm_scale[:, None]
        return _aggregate_part(act(m), flat_s, n_local, agg_fn)

    for _ in range(num_timesteps):
        pending = PendingHalo(h_local, shard.send_idx, group)
        loc, rem = _halo_typed_mlp_messages(
            gnn_params["edge_mlp"], shard, h_local, pending,
            use_target_state_as_input, elu, reduce_stream)
        h_local = layer_norm(gnn_params["ln"], _combine([loc, rem], agg_fn))
    return h_local


def gp_halo_rgdcn_layer(gnn_params, shard: GPHaloShard, h_local, group, *,
                        num_timesteps=1, num_channels=8, channel_dim=None,
                        use_full_state_for_channel_weights=False,
                        tie_channel_weights=False,
                        activation_function="relu",
                        message_aggregation_function="sum",
                        normalize_by_num_incoming=True, **_):
    """RGDCN over the halo partition, aggregate-first (gp_rgdcn_layer's
    form): neighbour sums of the raw own and halo rows, then node-local
    contractions."""
    _rgdcn_check_sum(message_aggregation_function)
    W_wc = gnn_params["W_wc"]
    n_local, L = h_local.shape[0], W_wc.shape[0]
    for _ in range(num_timesteps):
        pending = PendingHalo(h_local, shard.send_idx, group)
        S = _rgdcn_typed_sums(h_local, shard.flat_local, n_local, L,
                              normalize_by_num_incoming)
        S = S + _rgdcn_typed_sums(pending.wait(), shard.flat_remote, n_local,
                                  L, normalize_by_num_incoming)
        h_local = _rgdcn_contract(
            W_wc, h_local, S, num_channels, channel_dim,
            use_full_state_for_channel_weights, tie_channel_weights,
            get_activation(activation_function))
    return h_local


GP_HALO_LAYERS = {
    "rgcn": gp_halo_rgcn_layer_kw,
    "gnn_film": gp_halo_film_layer_kw,
    "ggnn": gp_halo_ggnn_layer,
    "rgat": gp_halo_rgat_layer,
    "rgin": gp_halo_rgin_layer,
    "gnn_edge_mlp": gp_halo_gnn_edge_mlp_layer,
    "rgdcn": gp_halo_rgdcn_layer,
}


# ---------------------------------------------------------------------------
# The stack and the steps
# ---------------------------------------------------------------------------


def gp_propagation_apply(prop_params, model_params, shard: GPShard, h_local,
                         group, layer_name: str, layer_kwargs,
                         gen: Optional[torch.Generator] = None):
    """nn/propagation.py propagation_apply over a shard: the same per-node
    schedule (projection, input dropout, averaging residuals, inter-layer
    LayerNorm and Dense, all local) with the layer from GP_LAYERS, on the
    same parameter tree; a GPHaloShard takes the layer from GP_HALO_LAYERS.
    `gen` draws this rank's dropout masks (None: no dropout)."""
    registry = (GP_HALO_LAYERS if isinstance(shard, GPHaloShard)
                else GP_LAYERS)
    if layer_name not in registry:
        raise ValueError("graph_parallel supports %s; got %r"
                         % (sorted(registry), layer_name))
    gp_layer = registry[layer_name]
    act = get_activation(model_params["graph_model_activation_function"])
    keep_prob = model_params["graph_layer_input_dropout_keep_prob"]
    residual_every = model_params["graph_residual_connection_every_num_layers"]
    dense_every = model_params["graph_dense_between_every_num_gnn_layers"]
    timesteps = model_params["graph_num_timesteps_per_layer"]

    h = h_local
    if "proj" in prop_params:
        h = act(torch.matmul(h, prop_params["proj"]))
    last_residual = torch.zeros_like(h)
    for i, layer_params in enumerate(prop_params["layers"]):
        h = dropout(h, keep_prob, gen)
        if i % residual_every == 0:
            t = h
            if i > 0:
                h = (h + last_residual) / 2.0
            last_residual = t
        h = gp_layer(layer_params["gnn"], shard, h, group,
                     num_timesteps=timesteps, **layer_kwargs)
        if "ln" in layer_params:
            h = layer_norm(layer_params["ln"], h)
        if i % dense_every == 0:
            h = act(torch.matmul(h, layer_params["dense"]))
    return h


def make_gp_forward(layer_name: str, num_layers: int, group=None,
                    residual_every: int = 10000,
                    inter_layer_norm: bool = False):
    """forward(layer_params_list, shard, h_local) -> the final local node
    states of a bare rgcn / gnn_film stack (relu), with the propagation
    stack's averaging residuals and inter-layer LayerNorm (both per node,
    so local)."""
    if layer_name not in ("rgcn", "gnn_film"):
        raise ValueError("graph parallelism supports rgcn/gnn_film, got %s"
                         % layer_name)

    def forward(layer_params_list, shard, h_local):
        last_residual = torch.zeros_like(h_local)
        for i, lp in enumerate(layer_params_list):
            if i % residual_every == 0:
                t = h_local
                if i > 0:
                    h_local = (h_local + last_residual) / 2.0
                last_residual = t
            if layer_name == "rgcn":
                h_local = gp_rgcn_layer(lp["W"], shard, h_local, group,
                                        torch.relu)
            else:
                h_local = gp_film_layer(lp["W"], lp["W_film"], lp["ln"],
                                        shard, h_local, group, torch.relu)
            if inter_layer_norm and "inter_ln" in lp:
                h_local = layer_norm(lp["inter_ln"], h_local)
        return h_local

    return forward


def _leaves(tree) -> List[torch.Tensor]:
    from ..runtime.model import flatten_params

    return list(flatten_params(tree).values())


def _reduce_grads(grads, group=None, mean: bool = True
                  ) -> List[torch.Tensor]:
    """Every rank's gradients summed over the ranks in ONE all_reduce of
    one flat buffer, and with `mean` divided by their number (the JAX
    steps' pmean)."""
    size = world(group)[1] if mean else 1
    buf = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(buf, group=group)
    buf = buf / size
    return [g.view_as(ref) for g, ref in zip(
        buf.split([g.numel() for g in grads]), grads)]


def _first_rank_metrics(metrics, group=None):
    """The metrics of `group`'s first rank on every rank of it, in one
    broadcast of one flat buffer (the JAX steps' replicated out spec, which
    takes one device's copy). The heads run replicated, but on the card
    their segment sums add in the atomics' order, so the ranks' own copies
    may differ in the last bits: a rank that read its own could decide an
    early stop or a best model apart from its peers."""
    if world(group)[1] == 1:
        return metrics
    names = sorted(metrics)
    buf = torch.cat(_metric_parts(metrics))
    dist.broadcast(buf, group_src=0, group=group)
    return {k: part.view_as(metrics[k]).to(metrics[k].dtype)
            for k, part in zip(names, buf.split(
                [metrics[k].numel() for k in names]))}


def make_gp_train_step(layer_name: str, num_layers: int, num_labels: int,
                       optimizer, clip_norm: float, group=None,
                       residual_every: int = 10000,
                       inter_layer_norm: bool = False):
    """A graph-parallel train step with a node-level sigmoid cross-entropy
    head (PPI-style): node states and edges partitioned over the ranks,
    parameters replicated. step(params, opt_state, shard, labels, lr) ->
    (params, opt_state, loss), `labels` this rank's [Nl, num_labels] and
    `params` {"proj", "layers", "out"} (leaves updated in place). The loss
    is the mean over every rank's real nodes; each rank differentiates the
    part of it its nodes make (the all-gathers carry the other ranks'
    contributions back), and the ranks' gradients are summed."""
    forward = make_gp_forward(layer_name, num_layers, group,
                              residual_every=residual_every,
                              inter_layer_norm=inter_layer_norm)

    def step(params, opt_state, shard: GPShard, labels, lr):
        leaves = _leaves(params)
        h = torch.matmul(shard.node_features, params["proj"])
        h = forward(params["layers"], shard, h)
        logits = torch.matmul(h, params["out"])
        per_elem = (torch.clamp(logits, min=0) - logits * labels
                    + torch.log1p(torch.exp(-torch.abs(logits))))
        local = torch.sum(per_elem * shard.node_mask[:, None])
        sums = torch.stack([local.detach(), shard.node_mask.sum()])
        dist.all_reduce(sums, group=group)
        n = torch.clamp(sums[1], min=1.0)
        grads = torch.autograd.grad(local / n, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for g, p in zip(grads, leaves)]
        grads = clip_grads_per_tensor(_reduce_grads(grads, group, False),
                                      clip_norm)
        opt_state = optimizer.update(grads, opt_state, leaves, lr)
        return params, opt_state, sums[0] / n

    return step


class GPSteps(NamedTuple):
    """make_gp_task_steps' result: train(batch, shard, grads_out=None) and
    eval(batch, shard), each returning the step's metrics (device
    tensors); a train step appends its gradients, averaged over the ranks
    and not yet clipped, to the list `grads_out` where one is given.
    grads(batch, shard) -> (those gradients, the metrics), the train
    step's first half (parallel/multihost.py's hybrid step reduces them
    further)."""

    train: Any
    eval: Any
    grads: Any


def make_gp_task_steps(model, group=None) -> GPSteps:
    """Task-generic graph-parallel train and eval steps for a
    SparseGraphModel on this rank (JAX: make_gp_task_steps). The
    propagation runs partitioned (node states 1/P a rank); the task's
    input and output models run REPLICATED on the padded batch, which every
    rank holds: the final local states are all-gathered once a step, so
    every task head works unchanged and every rank computes the loss.
    Gradients of the partitioned part flow back through the collectives
    (a reduce-scatter a gather), one all_reduce averages them over the
    ranks (pmean), then clip_grads_per_tensor and the update at
    _effective_lr(num_graphs), as the single-process step.

    Dropout: the replicated models draw from model._dropout_gen, which
    every rank seeds alike, so their masks agree across ranks; the
    propagation draws this rank's own masks from model._gp_prop_gen. Both
    steps return the first rank's metrics on every rank
    (_first_rank_metrics)."""
    clip_norm = model.params["clamp_gradient_norm"]

    def forward(params, batch, shard, gen_shared, gen_prop):
        rank, size = world(group)
        feats = model.task.input_apply(params.get("input", {}), batch,
                                       gen_shared)
        n_local = shard.node_features.shape[0]
        h0 = torch.nn.functional.pad(
            feats, (0, 0, 0, n_local * size - feats.shape[0]))
        h_local = h0[rank * n_local:(rank + 1) * n_local]
        h_local = gp_propagation_apply(
            params["prop"], model.params, shard, h_local, group,
            model.layer_name, model.layer_kwargs(), gen=gen_prop)
        h_full = all_gather(h_local, 0, group)[:batch.graph.n_pad]
        return model.task.output_apply(params["output"], batch, h_full,
                                       feats, gen_shared)

    def grads(batch, shard):
        leaves = model._leaves()
        loss, metrics = forward(model.model_params_tree, batch, shard,
                                model._dropout_gen, model._gp_prop_gen)
        g = torch.autograd.grad(loss, leaves, allow_unused=True)
        g = _reduce_grads([torch.zeros_like(p) if x is None else x
                           for x, p in zip(g, leaves)], group)
        return g, _first_rank_metrics(
            {k: v.detach() for k, v in metrics.items()}, group)

    def train(batch, shard, grads_out=None):
        g, metrics = grads(batch, shard)
        if grads_out is not None:
            grads_out.append(g)
        model.opt_state = model._optimizer.update(
            clip_grads_per_tensor(g, clip_norm), model.opt_state,
            model._leaves(), model._effective_lr(batch.num_graphs))
        return metrics

    @torch.no_grad()
    def evaluate(batch, shard):
        return _first_rank_metrics(forward(
            model.model_params_tree, batch, shard, None, None)[1], group)

    return GPSteps(train, evaluate, grads)
