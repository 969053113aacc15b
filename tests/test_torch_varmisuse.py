"""The port's VarMisuse task against the JAX package's, on the CPU, on
tests/fixtures.py's shards: identifier splitting, each parsed sample
array for array (with and without self loops, a keyword, a non-ASCII and
an over-long label included), the padded batches pack for pack for a
seed (in memory and streamed, aux arrays included), the char CNN and the
candidate head on the same weights, every family's loss and gradients at
hidden 16 and 2 layers over the 22 / 23 edge types, one Adam step with
the learning rate scaled by num_graphs / 30, a JAX checkpoint restored in
the port, the streaming loader's parallel parse, the data splitter, the
CLIs (read with run_varmisuse_benchs.py's regexes) and the port's
synthetic data maker against bench.py's."""

import copy
import gzip
import json
import multiprocessing
import os
import re
import shutil
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import bench
import run_varmisuse_benchs
from fixtures import make_planted_varmisuse_dir, make_varmisuse_dir
from test_torch_graph import assert_graphs_equal
from tf_gnn_samples_tpu.runtime import model as j_model
from tf_gnn_samples_tpu.tasks import base as j_base
from tf_gnn_samples_tpu.tasks import varmisuse as j_vm
from tf_gnn_samples_tpu.utils import registry as j_registry
from tf_gnn_samples_tpu.utils import varmisuse_data_splitter as j_split
from tf_gnn_samples_torch.runtime import model as t_model
from tf_gnn_samples_torch.tasks import base as t_base
from tf_gnn_samples_torch.tasks import varmisuse as t_vm
from tf_gnn_samples_torch.tools.synthetic_data import make_synthetic_varmisuse
from tf_gnn_samples_torch.utils import registry as t_registry
from tf_gnn_samples_torch.utils import varmisuse_data_splitter as t_split

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
FAMILIES = ["GGNN", "GNN-Edge-MLP0", "GNN-Edge-MLP1", "GNN-FiLM", "RGAT",
            "RGCN", "RGIN"]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """These tests run small tensors: with one intra-op thread a worker of
    the parallel test run does not oversubscribe the CPU's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def vm_dir(tmp_path_factory):
    """Two shards a fold: the loaders' spawned parse pools run."""
    return make_varmisuse_dir(str(tmp_path_factory.mktemp("vm")))


@pytest.fixture(scope="module")
def vm_one(tmp_path_factory):
    """One shard a fold (parsed in the process: no pool to spawn)."""
    return make_varmisuse_dir(str(tmp_path_factory.mktemp("vm1")),
                              num_shards=1, samples_per_shard=12)


def shard(root, fold="train", i=0):
    return os.path.join(root, "graphs-%s" % fold, "chunk_%d.jsonl.gz" % i)


def serial_samples(root, fold, self_loops):
    """The port's samples of a fold, parsed in file order in this process."""
    d = os.path.join(root, "graphs-%s" % fold)
    paths = sorted(os.path.join(d, f) for f in os.listdir(d)
                   if f.endswith(".gz"))
    return list(t_vm._load_data(paths, 19, 5, self_loops, no_parallel=True))


def assert_samples_equal(got, want):
    assert len(got) == len(want)
    for t, j in zip(got, want):
        assert len(t.adjacency_lists) == len(j.adjacency_lists)
        for a, b in zip(t.adjacency_lists, j.adjacency_lists):
            assert a.dtype == b.dtype and np.array_equal(a, b)
        for field in t._fields:
            if field == "adjacency_lists":
                continue
            a, b = np.asarray(getattr(t, field)), np.asarray(getattr(j, field))
            assert a.dtype == b.dtype and np.array_equal(a, b), field


def test_split_identifier_into_parts():
    table = ["fooBar", "baz_qux", "HTTPResponse2", "x", "getHTTPResponseCode",
             "__init__", "a1b2C3", "ALLCAPS", "already_lower", "", "_",
             "snake_Case_Mixed99", "IOStream", "ünïcödeName", "x86_64"]
    for ident in table:
        assert t_vm.split_identifier_into_parts(ident) == (
            j_vm.split_identifier_into_parts(ident)), ident
    assert t_vm.split_identifier_into_parts("HTTPResponse2") == [
        "http", "response2"]
    assert t_vm.CSHARP_KEYWORDS == j_vm.CSHARP_KEYWORDS
    assert t_vm.ALPHABET_DICT == j_vm.ALPHABET_DICT
    assert t_vm.PROGRAM_GRAPH_EDGES_TYPES_VOCAB == (
        j_vm.PROGRAM_GRAPH_EDGES_TYPES_VOCAB)
    assert np.array_equal(t_vm._BYTE_LUT, j_vm._BYTE_LUT)


@pytest.mark.parametrize("self_loops", [False, True])
def test_load_single_sample_equals_jax(vm_dir, self_loops):
    """Every array of every parsed sample, bit for bit, on the fixture's
    raw samples and on one with a keyword, a non-ASCII, an over-long and
    an alphabet-edge label and a correct candidate listed last."""
    raws = t_vm._read_shard(shard(vm_dir))
    extra = copy.deepcopy(raws[0])
    labels = extra["ContextGraph"]["NodeLabels"]
    labels.update({"0": "while", "1": "größe", "2": "aVeryLongIdentifierName"
                   "ThatGoesOn", "3": "{}[]", "4": "İstanbul"})
    cands = extra["SymbolCandidates"]
    for c in cands:
        c["IsCorrect"] = False
    cands[-1]["IsCorrect"] = True
    got, want = [], []
    for raw in raws + [extra]:
        got.append(t_vm._load_single_sample(
            copy.deepcopy(raw), t_vm.CSHARP_KEYWORDS, 19, 5, self_loops))
        want.append(j_vm._load_single_sample(
            copy.deepcopy(raw), j_vm.CSHARP_KEYWORDS, 19, 5, self_loops))
    assert_samples_equal(got, want)
    assert len(got[0].adjacency_lists) == 22 + self_loops
    assert got[-1].variable_candidate_nodes[0] == cands[-1]["SymbolDummyNode"]


def batches_of(task, base, data, fold, max_nodes, seed=11):
    np.random.seed(seed)  # TRAIN shuffles with the global numpy RNG
    return list(task.make_minibatch_iterator(data, base.DataFold[fold],
                                             max_nodes))


def assert_batches_equal(tbs, jbs):
    assert len(tbs) == len(jbs) > 1
    for tb, jb in zip(tbs, jbs):
        assert_graphs_equal(tb.graph, jb.graph)
        assert (tb.num_graphs, tb.num_nodes, tb.num_edges) == (
            jb.num_graphs, jb.num_nodes, jb.num_edges)
        assert tb.aux.keys() == jb.aux.keys()
        for k, v in tb.aux.items():
            want = np.asarray(jb.aux[k])
            assert v.numpy().dtype == want.dtype and np.array_equal(
                v.numpy(), want), k


def task_pair(**params):
    return (t_vm.VarMisuse_Task(dict(t_vm.VarMisuse_Task.default_params(),
                                     **params)),
            j_vm.VarMisuse_Task(dict(j_vm.VarMisuse_Task.default_params(),
                                     **params)))


@pytest.mark.parametrize("self_loops, buckets, max_nodes, fold", [
    (False, 3, 150, "TRAIN"), (True, 3, 150, "TRAIN"),
    (True, 1, 120, "VALIDATION")])
def test_batches_equal_jax(vm_dir, self_loops, buckets, max_nodes, fold):
    """The same samples through both packages' packing: the same packs,
    levels and padded arrays for a numpy seed."""
    tt, jt = task_pair(add_self_loop_edges=self_loops,
                       batch_spec_buckets=buckets)
    name = "train" if fold == "TRAIN" else "valid"
    data = serial_samples(vm_dir, name, self_loops)
    assert tt.num_edge_types == jt.num_edge_types == 22 + self_loops
    assert_batches_equal(batches_of(tt, t_base, data, fold, max_nodes),
                         batches_of(jt, j_base, data, fold, max_nodes))


def test_streamed_batches_equal_jax(vm_dir, vm_one, tmp_path):
    """streaming_train_data: both packages' streams over the same two
    shards give the same batches for a seed, each keeping its own stats
    cache file beside the shards; an epoch covers every sample once."""
    root = tmp_path / "mixed"
    shutil.copytree(os.path.join(vm_dir, "graphs-train"),
                    root / "graphs-train")
    shutil.copytree(os.path.join(vm_one, "graphs-valid"),
                    root / "graphs-valid")
    params = dict(streaming_train_data=True, streaming_window_graphs=5)
    tt, jt = task_pair(**params)
    tt.load_data(str(root))
    jt.load_data(str(root))
    ts, js = (tt._loaded_data[t_base.DataFold.TRAIN],
              jt._loaded_data[j_base.DataFold.TRAIN])
    assert ts.is_streaming and len(ts) == len(js) == 12
    tbs = batches_of(tt, t_base, ts, "TRAIN", 150)
    assert_batches_equal(tbs, batches_of(jt, j_base, js, "TRAIN", 150))
    assert sum(b.num_graphs for b in tbs) == 12 and ts.max_buffered <= 5
    cache = str(root / "graphs-train" / ".torch_stream_stats.json")
    assert os.path.exists(cache) and cache != js._cache_path()
    assert os.path.exists(js._cache_path())
    with open(cache) as f:
        assert json.load(f)["sizes"] == js._stats
    assert_samples_equal(tt._loaded_data[t_base.DataFold.VALIDATION],
                         jt._loaded_data[j_base.DataFold.VALIDATION])


def test_streaming_parallel_parse_equals_serial(vm_dir):
    """Two spawned parse workers give the serial stream's samples in its
    order for the same seed, over two epochs on one reused pool; close()
    ends the workers."""
    paths = [shard(vm_dir, "train", i) for i in range(2)]

    def epochs(workers):
        s = t_vm.ShardedSampleStream(paths, 19, 5, True, window_graphs=4,
                                     parse_workers=workers)
        np.random.seed(3)
        out = [list(s.iter_samples(shuffle=True)) for _ in range(2)]
        pool = s._pool
        s.close()
        return out, pool

    (serial, _), (parallel, pool) = epochs(0), epochs(2)
    assert pool is not None
    for a, b in zip(parallel, serial):
        assert_samples_equal(a, b)
    assert not any(p.is_alive() for p in pool._pool)


def char_cnn_weights(seed=0, d=64):
    jt = j_vm.VarMisuse_Task(dict(j_vm.VarMisuse_Task.default_params(),
                                  graph_node_label_representation_size=d))
    w = jax.tree_util.tree_map(np.asarray, jt.input_init(jax.random.key(seed)))
    # The zero-initialised biases given values, so that they count.
    rng = np.random.RandomState(seed)
    for k in ("conv1_bias", "conv2_bias"):
        w[k] = (0.1 * rng.randn(*w[k].shape)).astype(np.float32)
    return w


def test_char_cnn_matches_jax(vm_dir):
    """The char CNN on a batch's unique labels, through the same weights:
    rtol 1e-5 (the same f32 sums in other orders). Its initialisers have
    the JAX package's bounds."""
    tt, jt = task_pair()
    data = serial_samples(vm_dir, "valid", False)
    (tb, *_), (jb, *_) = (batches_of(tt, t_base, data, "VALIDATION", 150),
                          batches_of(jt, j_base, data, "VALIDATION", 150))
    w = char_cnn_weights()
    want = np.asarray(jt.input_apply({k: jnp.asarray(v) for k, v in w.items()},
                                     jb))
    got = tt.input_apply({k: torch.tensor(v) for k, v in w.items()}, tb)
    assert got.shape == want.shape == (tb.graph.n_pad, 64)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    init = tt.input_init(torch.Generator().manual_seed(0))
    for k, v in init.items():
        assert tuple(v.shape) == w[k].shape, k
    for k in ("conv1_kernel", "conv2_kernel"):
        bound = float(np.abs(w[k]).max())
        assert 0.9 * bound < float(init[k].abs().max()) < 1.1 * bound, k


@pytest.mark.parametrize("params", [
    {}, {"loss_function": "max-margin"},
    {"slot_score_via_linear_layer": False}])
def test_head_matches_jax(vm_dir, params):
    """The candidate head from the same final states and weights: loss,
    total_loss, accuracy and num_correct_predictions (rtol 1e-5), with
    padded graphs carrying nothing."""
    tt, jt = task_pair(**params)
    data = serial_samples(vm_dir, "train", False)
    tbs = batches_of(tt, t_base, data, "VALIDATION", 150)
    jbs = batches_of(jt, j_base, data, "VALIDATION", 150)
    rng = np.random.RandomState(1)
    for tb, jb in zip(tbs, jbs):
        h = rng.randn(tb.graph.n_pad, 32).astype(np.float32)
        head = {"slot_score_linear": (0.3 * rng.randn(65, 1)).astype(
            np.float32)}
        jloss, jm = jt.output_apply({k: jnp.asarray(v) for k, v in
                                     head.items()}, jb, jnp.asarray(h), None)
        tloss, tm = tt.output_apply({k: torch.from_numpy(v) for k, v in
                                     head.items()}, tb, torch.from_numpy(h),
                                    None)
        assert tm.keys() == jm.keys()
        for k in tm:
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5,
                                       err_msg=k)
        assert float(tm["num_correct_predictions"]) <= tb.num_graphs
        moved = h.copy()
        moved[tb.num_nodes:] = 50.0  # padded nodes: no graph reads them
        _, tm2 = tt.output_apply({k: torch.from_numpy(v) for k, v in
                                  head.items()}, tb, torch.from_numpy(moved),
                                 None)
        for k in tm:
            assert float(tm2[k]) == float(tm[k]), k


def test_hypers_are_copies():
    names = sorted(n for n in os.listdir(os.path.join(
        ROOT, "tf_gnn_samples_tpu", "default_hypers"))
        if n.startswith("VarMisuse_"))
    assert len(names) == 7
    for name in names:
        with open(os.path.join(ROOT, "tf_gnn_samples_tpu", "default_hypers",
                               name)) as f, open(os.path.join(
                ROOT, "tf_gnn_samples_torch", "default_hypers", name)) as g:
            assert json.load(f) == json.load(g), name


def small_params(model, hidden=16, **extra):
    """The tuned VarMisuse_<model>.json hypers cut to `hidden` and 2
    layers (RGAT: 4 heads), dropout off; the families whose kernel branch needs the JAX
    Pallas kernels take their f32 branches in both packages: "segment"
    for GNN-FiLM, RGAT, RGCN and GGNN, the per-type scan for RGIN and
    GNN-Edge-MLP."""
    cls, extra_cls = j_registry.name_to_model_class(model)
    with open(os.path.join(ROOT, "tf_gnn_samples_torch", "default_hypers",
                           "VarMisuse_%s.json" % model)) as f:
        hypers = json.load(f)
    params = cls.default_params()
    params.update(extra_cls)
    params.update(hypers["model_params"])
    params.update({"hidden_size": hidden, "graph_num_layers": 2,
                   "graph_layer_input_dropout_keep_prob": 1.0,
                   "max_nodes_in_batch": 150,
                   "aggregation_strategy": "segment",
                   "typed_edge_scan": "scan"})
    if model == "RGAT":
        params["num_heads"] = 4
    params.update(extra)
    return params, hypers["task_params"]


def model_pair(model, vm_dir, tmp_path, **extra):
    params, task_params = small_params(model, **extra)
    tt, jt = task_pair(**task_params)
    jcls, _ = j_registry.name_to_model_class(model)
    tcls, _ = t_registry.name_to_model_class(model)
    jm = jcls(dict(params), jt, "j", str(tmp_path))
    tm = tcls(dict(params), tt, "t", str(tmp_path), device="cpu")
    tm.load_weights(j_model.flatten_params(jm.model_params_tree))
    data = serial_samples(vm_dir, "train", task_params["add_self_loop_edges"])
    (tb, *_), (jb, *_) = (batches_of(tt, t_base, data, "VALIDATION", 150),
                          batches_of(jt, j_base, data, "VALIDATION", 150))
    return jm, tm, jb, tb, params


@pytest.mark.parametrize("model", FAMILIES)
def test_model_loss_and_grads_match_jax(vm_dir, tmp_path, model):
    """Loss and every parameter gradient (char CNN and head included) of
    each family at its tuned VarMisuse config cut to hidden 16 and 2
    layers, over the 22 (23 with self loops) edge types, weights carried
    by params_from_jax: f32 branches in both packages, at
    test_torch_model.py's tolerances (loss rtol 1e-5; a gradient entry
    rtol 1e-4 with atol 3e-4 of its tensor's largest entry). The four
    configs with lr_for_num_graphs_per_batch 30 then take one Adam step:
    the learning rate is 1.5e-4 * num_graphs / 30 in both packages, and
    the port reaches the JAX package's next weights (rtol 1e-5, atol a
    tenth of the learning rate: Adam's first step moves an entry by about
    the learning rate, by less where its gradient is near 0) and slots
    (the gradients' tolerance)."""
    jm, tm, jb, tb, params = model_pair(model, vm_dir, tmp_path)
    assert tb.graph.num_edge_types == tm.task.num_edge_types
    # Jitted: eager JAX dispatches each of the 22 types' ops one by one.
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: jm._forward(p, b, None), has_aux=True))(
            jm.model_params_tree, jm._device_batch(jb))
    tloss, _ = tm._forward(tm.model_params_tree,
                           t_model.batch_to_device(tb, CPU), None)
    tgrads = torch.autograd.grad(tloss, tm._leaves())
    np.testing.assert_allclose(float(tloss.detach()), float(jloss), rtol=1e-5)
    jflat = j_model.flatten_params(jgrads)
    names = list(t_model.flatten_params(tm.model_params_tree))
    assert sorted(names) == sorted(jflat)
    assert any(n.startswith("input/") for n in names)
    for name, g in zip(names, tgrads):
        want = np.asarray(jflat[name])
        np.testing.assert_allclose(g.numpy(), want, rtol=1e-4,
                                   atol=3e-4 * float(np.abs(want).max()),
                                   err_msg=name)
    if params["lr_for_num_graphs_per_batch"] is not None:
        assert_adam_step_matches_jax(jm, tm, jb, tb, params)


def assert_adam_step_matches_jax(jm, tm, jb, tb, params):
    assert params["lr_for_num_graphs_per_batch"] == 30
    assert params["optimizer"] == "Adam"
    lr = tm._effective_lr(tb.num_graphs)
    assert lr == pytest.approx(1.5e-4 * tb.num_graphs / 30)
    before = j_model.flatten_params(
        jax.tree_util.tree_map(np.array, jm.model_params_tree))
    jp, jo, _ = jm._make_train_step()(jm.model_params_tree, jm.opt_state,
                                      jax.random.PRNGKey(0),
                                      jm._device_batch(jb))
    tm._train_step(t_model.batch_to_device(tb, CPU))
    got = t_model.params_to_jax(tm.model_params_tree)
    got_opt = t_model.opt_state_to_jax(tm.opt_state, tm.model_params_tree)
    want = j_model.flatten_params(jp)
    want_slots = j_model.flatten_params(jo.slots)
    assert got_opt["step"] == int(jo.step) == 1
    moved = 0
    for name in want:
        np.testing.assert_allclose(got[name], np.asarray(want[name]),
                                   rtol=1e-5, atol=0.1 * lr, err_msg=name)
        moved += np.abs(np.asarray(want[name]) - before[name]).max() > 0
    assert moved == len(want)
    for name in want_slots:
        w = np.asarray(want_slots[name])
        np.testing.assert_allclose(got_opt["slots"][name], w, rtol=1e-4,
                                   atol=3e-4 * float(np.abs(w).max()),
                                   err_msg=name)


def eval_metrics(model, base, data):
    loss, metrics, graphs, _, _, _ = model._run_epoch(
        "Test", data, base.DataFold.TEST, quiet=True)
    return loss, model.task.pretty_print_epoch_task_metrics(metrics, graphs)


def test_jax_checkpoint_restores_in_the_port(vm_one, tmp_path):
    """A VarMisuse pickle the JAX package wrote restores in the port from
    its task metadata (23 edge types with self loops) and gives the same
    test loss and accuracy line; the port's own pickle round-trips."""
    params, task_params = small_params("GNN-FiLM")
    jt = j_vm.VarMisuse_Task(dict(j_vm.VarMisuse_Task.default_params(),
                                  **task_params))
    jm = j_model.GNN_FiLM_Model(dict(params), jt, "j", str(tmp_path))
    jm.save_model(str(tmp_path / "jax.pickle"))
    tm = t_registry.restore(str(tmp_path / "jax.pickle"), str(tmp_path),
                            device="cpu")
    assert tm.task.num_edge_types == 23
    test_dir = os.path.join(vm_one, "graphs-test")
    jres = eval_metrics(jm, j_base, jm.task.load_eval_data_from_path(test_dir))
    tres = eval_metrics(tm, t_base, tm.task.load_eval_data_from_path(test_dir))
    np.testing.assert_allclose(tres[0], jres[0], rtol=1e-5)
    assert tres[1] == jres[1]
    tm.save_model(str(tmp_path / "port.pickle"))
    tm2 = t_registry.restore(str(tmp_path / "port.pickle"), str(tmp_path),
                             device="cpu")
    assert eval_metrics(tm2, t_base, tm2.task.load_eval_data_from_path(
        test_dir)) == tres


def test_splitter_equals_jax(vm_dir, tmp_path):
    """The port's splitter (two workers) writes the chunks the JAX one
    (one worker, so its completion order is the file order) writes for the
    same input and numpy seed: the same files, the same samples in the
    same order (compared decompressed: gzip headers carry times)."""
    raw = tmp_path / "raw"
    raw.mkdir()
    for fold in ("train", "valid"):
        for i in range(2):
            shutil.copy(shard(vm_dir, fold, i),
                        raw / ("%s_%d.jsonl.gz" % (fold, i)))
    outs = {}
    for name, mod, workers in (("jax", j_split, 1), ("port", t_split, 2)):
        np.random.seed(5)
        out = tmp_path / name
        mod.run(types.SimpleNamespace(RAW_DATA_DIR=str(raw), OUT_DIR=str(out),
                                      chunk_size=4, num_workers=workers,
                                      window_size=10))
        outs[name] = {f: gzip.open(out / f, "rb").read()
                      for f in sorted(os.listdir(out))}
    assert outs["port"].keys() == outs["jax"].keys()
    assert len(outs["port"]) == 7  # windows of 10, 10, 4; chunks of 4
    for f in outs["port"]:
        assert outs["port"][f] == outs["jax"][f], f
    assert not multiprocessing.active_children()


def test_train_and_test_clis(vm_one, tmp_path):
    """`python -m tf_gnn_samples_torch.train GGNN VarMisuse --device cpu`
    trains until patience stops it (learning rate 0, so the second epoch
    does not improve) and prints the lines run_varmisuse_benchs.py reads;
    the test CLI restores the checkpoint from its metadata and evaluates a
    graphs-testonly directory."""
    overrides = json.dumps({"max_epochs": 3, "patience": 1,
                            "learning_rate": 0.0, "hidden_size": 16,
                            "graph_num_layers": 2,
                            "max_nodes_in_batch": 300})
    out = subprocess.run(
        [sys.executable, "-m", "tf_gnn_samples_torch.train", "GGNN",
         "VarMisuse", "--device", "cpu", "--data-path", vm_one,
         "--result-dir", str(tmp_path), "--quiet",
         "--model-param-overrides", overrides],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    line = (r" %s: loss: \d+\.\d{5} \|\| Accuracy: \d\.\d{3} \|\| "
            r"graphs/sec: \d+\.\d{2} \| nodes/sec: \d+ \| edges/sec: \d+$")
    assert any(re.match(line % "Train", l) for l in lines), out.stdout
    assert any(run_varmisuse_benchs.SCRAPE_TRAIN["valid_acc"].search(l)
               for l in lines), out.stdout
    (pickle,) = tmp_path.glob("VarMisuse_GGNN_*_best_model.pickle")
    testonly = tmp_path / "graphs-testonly"
    shutil.copytree(os.path.join(vm_one, "graphs-test"), testonly)
    out = subprocess.run(
        [sys.executable, "-m", "tf_gnn_samples_torch.test", "--device", "cpu",
         "--result-dir", str(tmp_path), "--quiet", str(pickle),
         str(testonly)], cwd=ROOT, capture_output=True, text=True,
        timeout=300)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert re.search(r"^Loss \d+\.\d{5} on 12 graphs$", out.stdout, re.M)
    assert any(run_varmisuse_benchs.SCRAPE_EVAL["testonly_acc"].match(l)
               for l in lines), out.stdout
    assert any(run_varmisuse_benchs.SCRAPE_TRAIN["pickle"].match(l)
               for l in lines), out.stdout


def test_synthetic_varmisuse_is_bench_data(tmp_path):
    """make_synthetic_varmisuse writes, for a seed, the samples bench.py's
    make_synthetic_varmisuse writes (compared decompressed), and both
    loaders parse them alike: graphs of 1,600-2,599 nodes plus their
    subtoken nodes, 22 edge types with UsesSubtoken."""
    a = make_synthetic_varmisuse(str(tmp_path / "a"), seed=4,
                                 folds={"train": 3, "valid": 1, "test": 1},
                                 per_chunk=2)
    b = str(tmp_path / "b")
    bench.make_synthetic_varmisuse(b, seed=4, n_train=3, n_valid=1)
    for fold in ("train", "valid", "test"):
        names = sorted(os.listdir(os.path.join(b, "graphs-%s" % fold)))
        got = b"".join(gzip.open(os.path.join(a, "graphs-%s" % fold, n),
                                 "rb").read()
                       for n in sorted(os.listdir(
                           os.path.join(a, "graphs-%s" % fold))))
        want = b"".join(gzip.open(os.path.join(b, "graphs-%s" % fold, n),
                                  "rb").read() for n in names)
        assert got == want, fold
    tt, jt = task_pair()
    tt.load_data(a)
    jt.load_data(b)
    assert_samples_equal(tt._loaded_data[t_base.DataFold.TRAIN],
                         jt._loaded_data[j_base.DataFold.TRAIN])
    st = t_vm.PROGRAM_GRAPH_EDGES_TYPES_VOCAB["UsesSubtoken"]
    for s in tt._loaded_data[t_base.DataFold.TRAIN]:
        assert len(s.node_labels_to_unique_labels) > 1600
        assert s.adjacency_lists[st].shape[0] > 0
        assert s.adjacency_lists[0].shape[0] < 2600  # Child: a tree


@pytest.mark.slow
def test_planted_fixture_reaches_accuracy(tmp_path):
    """The port's char CNN, head and accuracy learn the planted fixture
    (the correct candidate's label is always 'winnerVar') to train-fold
    accuracy >= 0.98, as tests/test_learnability.py holds the JAX package
    (RGCN, Adam 0.002, 80 epochs, hidden 64, 2 layers). `slow` as that
    test is."""
    root = make_planted_varmisuse_dir(str(tmp_path / "vm"))
    task = t_vm.VarMisuse_Task(t_vm.VarMisuse_Task.default_params())
    task.load_data(root)
    cls, _ = t_registry.name_to_model_class("RGCN")
    params = cls.default_params()
    params.update({"hidden_size": 64, "graph_num_layers": 2,
                   "optimizer": "Adam", "learning_rate": 0.002,
                   "max_epochs": 80, "patience": 10000,
                   "graph_layer_input_dropout_keep_prob": 1.0,
                   "max_nodes_in_batch": 2000, "random_seed": 0})
    model = cls(params, task, "learn", str(tmp_path), device="cpu")
    model.train(quiet=True)
    _, metrics, graphs, _, _, _ = model._run_epoch(
        "final", task._loaded_data[t_base.DataFold.TRAIN],
        t_base.DataFold.VALIDATION, quiet=True)
    acc = sum(float(m["num_correct_predictions"]) for m in metrics) / graphs
    assert acc >= 0.98, acc
