"""The port's copies of the JAX package's pure-Python utils
(tf_gnn_samples_torch/utils/tb_writer.py, metrics_writer.py, paths.py)
against the originals: the same event-file bytes and JSONL records for
the same scalars (the clock and the host name fixed), and localize_path
as tests/test_paths.py holds it, with a fake blob client; and
utils/profiling.py's trace on torch.profiler."""

import glob
import json
import os
import socket
import time

import pytest
import torch

from tf_gnn_samples_tpu.utils import metrics_writer as j_mw
from tf_gnn_samples_tpu.utils import paths as j_paths
from tf_gnn_samples_tpu.utils import tb_writer as j_tbw
from tf_gnn_samples_torch.utils import metrics_writer as t_mw
from tf_gnn_samples_torch.utils import paths as t_paths
from tf_gnn_samples_torch.utils import profiling as t_prof
from tf_gnn_samples_torch.utils import tb_writer as t_tbw

RECORDS = [("train", 9000, {"loss": 0.75, "epoch": 1, "graphs_per_sec": 18445.3}),
           ("valid", 9000, {"loss": 0.5, "epoch": 1,
                            "early_stopping_metric": 0.4999}),
           ("train", 18000, {"loss": 1e-7, "epoch": 2, "graphs_per_sec": 1}),
           ("valid", 18000, {"loss": float("inf"), "epoch": 2,
                             "early_stopping_metric": -3})]


def fix_clock(monkeypatch):
    """time.time from a fixed start in 0.5 s steps; a fixed host name."""
    clock = iter(1792269980.25 + 0.5 * i for i in range(1000))
    monkeypatch.setattr(time, "time", lambda: next(clock))
    monkeypatch.setattr(socket, "gethostname", lambda: "host")


def read_tree(root):
    return {os.path.relpath(p, root): open(p, "rb").read()
            for p in sorted(glob.glob(os.path.join(root, "**", "*"),
                                      recursive=True)) if os.path.isfile(p)}


def test_tb_writer_writes_the_jax_modules_bytes(tmp_path, monkeypatch):
    trees = {}
    for name, mod in (("jax", j_tbw), ("torch", t_tbw)):
        fix_clock(monkeypatch)
        writer = mod.FoldedTensorBoardWriter(str(tmp_path / name), "run7")
        for fold, step, scalars in RECORDS:
            writer.write(fold, step, scalars)
        single = mod.TensorBoardWriter(str(tmp_path / name / "single"), "x")
        single.add_scalars(3, {"a": 1.5})
        trees[name] = read_tree(str(tmp_path / name))
    assert trees["torch"] == trees["jax"]
    assert len(trees["jax"]) == 3
    assert t_tbw._crc32c(b"\x00" * 32) == 0x8A9136AA


def test_metrics_writer_writes_the_jax_modules_records(tmp_path, monkeypatch):
    out = {}
    for name, mod in (("jax", j_mw), ("torch", t_mw)):
        fix_clock(monkeypatch)
        writer = mod.MetricsWriter(str(tmp_path / name))
        for fold, step, scalars in RECORDS:
            writer.write(fold, step, scalars)
        out[name] = open(tmp_path / name / "metrics.jsonl").read()
    assert out["torch"] == out["jax"]
    assert [json.loads(line)["step"] for line in out["torch"].splitlines()] \
        == [r[1] for r in RECORDS]


class _FakeBlob:
    def __init__(self, name, data):
        self.name = name
        self.size = len(data)
        self.data = data


class _FakeDownload:
    def __init__(self, data):
        self._data = data

    def readall(self):
        return self._data


class _FakeContainerClient:
    def __init__(self, blobs):
        self._blobs = blobs
        self.download_calls = 0

    def list_blobs(self, name_starts_with=""):
        return [b for b in self._blobs if b.name.startswith(name_starts_with)]

    def download_blob(self, name):
        self.download_calls += 1
        for b in self._blobs:
            if b.name == name:
                return _FakeDownload(b.data)
        raise KeyError(name)


@pytest.mark.parametrize("paths", [j_paths, t_paths], ids=["jax", "torch"])
def test_localize_path_as_tests_test_paths(tmp_path, paths):
    assert not paths.is_azure_path("/local/dir")
    assert paths.parse_azure_path("azure://acct/cont/some/prefix") == (
        "acct", "cont", "some/prefix")
    assert paths.parse_azure_path("azure://acct/cont") == ("acct", "cont", "")
    with pytest.raises(ValueError):
        paths.parse_azure_path("azure://only-account")
    local_dir = str(tmp_path / "data")
    assert paths.localize_path(local_dir, None) == local_dir

    auth_file = tmp_path / "azure_auth.json"
    auth_file.write_text(json.dumps({
        "acct": {"sas_token": "tok", "cache_location": str(tmp_path / "c")}}))
    client = _FakeContainerClient([
        _FakeBlob("qm9/train.jsonl.gz", b"train-bytes"),
        _FakeBlob("qm9/valid.jsonl.gz", b"valid-bytes-longer"),
        _FakeBlob("other/skip.bin", b"x")])

    def factory(account, container, auth):
        assert (account, container, auth["sas_token"]) == ("acct", "cont",
                                                           "tok")
        return client

    for _ in range(2):  # the second call finds the cache: no download
        local = paths.localize_path("azure://acct/cont/qm9", str(auth_file),
                                    container_client_factory=factory)
        assert client.download_calls == 2
    assert open(os.path.join(local, "train.jsonl.gz"), "rb").read() == (
        b"train-bytes")
    assert not os.path.exists(os.path.join(local, "skip.bin"))
    with pytest.raises(FileNotFoundError):
        paths.localize_path("azure://acct/cont/x", str(tmp_path / "no.json"),
                            container_client_factory=lambda *a: None)
    with pytest.raises(KeyError):
        paths.localize_path("azure://other/cont/x", str(auth_file),
                            container_client_factory=lambda *a: None)


def test_profiling_traces_only_when_given_a_directory(tmp_path):
    with t_prof.trace_if(None):
        pass
    assert not os.listdir(tmp_path)
    with t_prof.trace_if(str(tmp_path / "trace")):
        with t_prof.annotate("epoch"):
            torch.ones(4).sum()
    (trace,) = glob.glob(str(tmp_path / "trace" / "*.pt.trace.json"))
    events = json.load(open(trace))["traceEvents"]
    assert any(e.get("name") == "epoch" for e in events)
