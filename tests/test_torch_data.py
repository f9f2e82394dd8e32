"""The port's data layer against the JAX package's, on the same inputs, bit
for bit: ``SyntheticUFGDataset`` samples, the parquet reader,
``BatchLoader`` batches (two epochs, thread and process workers, a short
tail, per-process strides), ``HostDecodedCache`` (thread, fork and spawn
pools) and ``DeviceDatasetCache`` on the CPU (the wrap-padded tail, a split
smaller than the batch).  Also: a forked pool child never initializes CUDA,
``DevicePrefetcher`` on the CPU passes batches through in order, and a mesh
raises.
"""

import io

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax

from ego_moment_cle_vit_tpu import data as jdata
from ego_moment_cle_vit_tpu import parallel as jparallel
from ego_moment_cle_vit_tpu_torch import data as tdata
from ego_moment_cle_vit_tpu_torch.data import pipeline as tpipeline

# the test workers share the cores: one intra-op thread per worker
torch.set_num_threads(1)


def _datasets(**kw):
    return jdata.SyntheticUFGDataset(**kw), tdata.SyntheticUFGDataset(**kw)


def _same_batches(jax_batches, port_batches):
    jax_batches, port_batches = list(jax_batches), list(port_batches)
    assert len(jax_batches) == len(port_batches) > 0
    for (ji, jl), (ti, tl) in zip(jax_batches, port_batches):
        ti, tl = (x.numpy() if torch.is_tensor(x) else x for x in (ti, tl))
        ji, jl = np.asarray(ji), np.asarray(jl)
        assert ti.dtype == ji.dtype == np.uint8 and ti.shape == ji.shape
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_array_equal(tl.astype(np.int64), jl.astype(np.int64))


@pytest.mark.parametrize("learnable", [False, True])
@pytest.mark.parametrize("split", ["train", "val"])
def test_synthetic_dataset_matches_jax(learnable, split):
    jds, tds = _datasets(num_classes=6, samples_per_class=3, image_size=24, split=split,
                         seed=5, learnable=learnable)
    assert len(jds) == len(tds) == 18
    assert tds.classes == jds.classes and tds.class_to_idx == jds.class_to_idx
    assert tds.num_classes == jds.num_classes and tds.image_size == jds.image_size
    assert tds.get_dataset_info() == jds.get_dataset_info()
    for i in range(len(jds)):
        (ji, jl), (ti, tl) = jds[i], tds[i]
        assert ti.dtype == np.uint8 and tl == jl
        np.testing.assert_array_equal(ti, ji)


@pytest.mark.parametrize("worker_type,drop_last,process_index,process_count,prefetch", [
    ("thread", True, 0, 1, 2),
    ("thread", False, 0, 1, 0),   # a short tail batch, no background thread
    ("thread", False, 1, 2, 2),   # the second of two processes' strides
    ("process", False, 0, 3, 2),  # fork pool, a stride and a tail
])
def test_batch_loader_matches_jax(worker_type, drop_last, process_index, process_count,
                                  prefetch):
    jds, tds = _datasets(num_classes=5, samples_per_class=7, image_size=16, seed=2)
    kw = dict(batch_size=4, shuffle=True, seed=9, drop_last=drop_last, num_workers=2,
              prefetch=prefetch, worker_type=worker_type, process_index=process_index,
              process_count=process_count)
    jl, tl = jdata.BatchLoader(jds, **kw), tdata.BatchLoader(tds, **kw)
    assert len(tl) == len(jl)
    for epoch in (0, 1):
        jl.set_epoch(epoch)
        tl.set_epoch(epoch)
        _same_batches(jl, tl)
    if not drop_last:
        assert sum(len(b[1]) for b in tl) == len(tl._order())


def test_batch_loader_raises_producer_errors_and_bad_arguments():
    class Broken(tdata.SyntheticUFGDataset):
        def __getitem__(self, idx):
            if idx == 3:
                raise KeyError("sample 3")
            return super().__getitem__(idx)

    loader = tdata.BatchLoader(Broken(num_classes=2, samples_per_class=4, image_size=8),
                               batch_size=2, shuffle=False, num_workers=1)
    with pytest.raises(KeyError, match="sample 3"):
        list(loader)
    with pytest.raises(ValueError, match="worker_type"):
        tdata.BatchLoader(loader.dataset, 2, worker_type="fiber")
    with pytest.raises(ValueError, match="process_index"):
        tdata.BatchLoader(loader.dataset, 2, process_index=2, process_count=2)


@pytest.mark.parametrize("worker_type,start", [("thread", None), ("process", "fork"),
                                               ("process", "spawn")])
def test_host_decoded_cache_matches_jax(worker_type, start, monkeypatch):
    if start is not None:
        monkeypatch.setenv("EMCT_POOL_START", start)
    # 80 samples: past the 64-sample threshold where a process pool is used
    jds, tds = _datasets(num_classes=8, samples_per_class=10, image_size=12, seed=4)
    jc = jdata.HostDecodedCache(jds, num_workers=2, worker_type=worker_type)
    tc = tdata.HostDecodedCache(tds, num_workers=2, worker_type=worker_type)
    np.testing.assert_array_equal(tc.images, jc.images)
    np.testing.assert_array_equal(tc.labels, jc.labels)
    assert tc.nbytes == jc.nbytes and len(tc) == len(jc) == 80
    assert (tc.classes, tc.num_classes, tc.image_size) == (jc.classes, jc.num_classes,
                                                            jc.image_size)
    assert tc.get_dataset_info() == jc.get_dataset_info()
    kw = dict(batch_size=16, seed=1, num_workers=2)
    _same_batches(jdata.BatchLoader(jc, **kw), tdata.BatchLoader(tc, **kw))
    assert tdata.host_cache_fits(80, 12, 80 * 12 * 12 * 3)
    assert not tdata.host_cache_fits(80, 12, 80 * 12 * 12 * 3 - 1)


class _CudaWitness:
    """A dataset whose samples say whether the process serving them has
    initialized CUDA."""

    def __len__(self):
        return 8

    def __getitem__(self, idx):
        return np.full((2, 2, 3), idx, np.uint8), int(torch.cuda.is_initialized())


def test_fork_pool_children_never_initialize_cuda(monkeypatch):
    def refuse():
        raise RuntimeError("CUDA initialized in a pool child")

    # a child inherits the patched initializer: any CUDA call in it raises
    monkeypatch.setattr(torch.cuda, "_lazy_init", refuse)
    monkeypatch.setenv("EMCT_POOL_START", "fork")
    loader = tdata.BatchLoader(_CudaWitness(), batch_size=4, shuffle=False, num_workers=2,
                               worker_type="process")
    batches = list(loader)
    assert len(batches) == 2
    for images, initialized in batches:
        assert not initialized.any()
    assert tpipeline._WORKER_DATASET is None  # the parent's global is cleared after the fork


@pytest.mark.parametrize("n,batch,drop_last", [(35, 8, True), (35, 8, False), (5, 8, False)])
def test_device_dataset_cache_matches_jax_on_cpu(n, batch, drop_last):
    jds, tds = _datasets(num_classes=n, samples_per_class=1, image_size=10, seed=6)
    kw = dict(batch_size=batch, shuffle=True, seed=3, drop_last=drop_last, num_workers=2)
    jc = jdata.DeviceDatasetCache(jds, **kw)
    tc = tdata.DeviceDatasetCache(tds, **kw, device="cpu")
    assert len(tc) == len(jc) and tc.nbytes == jc.nbytes
    for epoch in (0, 1):
        jc.set_epoch(epoch)
        tc.set_epoch(epoch)
        port = list(tc)
        assert all(i.device.type == "cpu" and i.shape[0] == batch for i, _ in port)
        _same_batches(jc, port)
    assert tdata.device_cache_fits(n, 10, n * 300) and not tdata.device_cache_fits(n, 10, 1)
    # the mesh form: the batch rounded up to the data axis (wrap-padded as the
    # JAX cache's), each data rank gathering its rows of every batch
    for data in (2, 3):
        jmesh = jparallel.create_mesh(data, 1, jax.devices()[:data])
        jm = jdata.DeviceDatasetCache(jds, **kw, mesh=jmesh)
        jm.set_epoch(1)
        whole = [(np.asarray(i), np.asarray(l)) for i, l in jm]
        rows = []
        for d in range(data):
            mesh = SimpleNamespace(data=data, data_index=d, device=torch.device("cpu"))
            tm = tdata.DeviceDatasetCache(tds, **kw, mesh=mesh)
            assert tm.batch_size == jm.batch_size == -(-batch // data) * data
            tm.set_epoch(1)
            rows.append(list(tm))
        assert len(whole) == len(rows[0]) == len(jm)
        for k, (images, labels) in enumerate(whole):
            np.testing.assert_array_equal(torch.cat([r[k][0] for r in rows]).numpy(), images)
            np.testing.assert_array_equal(torch.cat([r[k][1] for r in rows]).numpy(), labels)


def test_device_prefetcher_on_cpu_passes_batches_through():
    tds = tdata.SyntheticUFGDataset(num_classes=3, samples_per_class=5, image_size=8)
    loader = tdata.BatchLoader(tds, batch_size=4, seed=2, num_workers=1)
    host = list(loader)
    moved = list(tdata.DevicePrefetcher(loader, device="cpu", depth=2))
    _same_batches(host, moved)
    assert all(torch.is_tensor(x) for b in moved for x in b)
    # the mesh forms: each data rank gets rows [d B / D, (d + 1) B / D) of the
    # global batch, as the JAX shard_batch places them; its loader can load
    # just those rows (BatchLoader's data_shard)
    jmesh = jparallel.create_mesh(2, 1, jax.devices()[:2])
    jrows = jdata.shard_batch(host[0], jmesh)
    for d in range(2):
        mesh = SimpleNamespace(data=2, data_index=d, device=torch.device("cpu"))
        want = [np.asarray(x.addressable_shards[d].data) for x in jrows]
        got = tdata.shard_batch(host[0], mesh)
        assert all(torch.is_tensor(x) for x in got)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), w)
        staged = list(tdata.DevicePrefetcher(loader, device="cpu", mesh=mesh))
        shard = tdata.BatchLoader(tds, batch_size=4, seed=2, num_workers=1, data_shard=(d, 2))
        assert len(staged) == len(shard) == len(host)
        for s_batch, l_batch, h_batch in zip(staged, shard, host):
            for s_x, l_x, h_x in zip(s_batch, l_batch, h_batch):
                np.testing.assert_array_equal(s_x.numpy(), h_x[2 * d:2 * d + 2])
                np.testing.assert_array_equal(l_x, h_x[2 * d:2 * d + 2])
    with pytest.raises(ValueError, match="divide"):
        tdata.shard_batch(host[0], SimpleNamespace(data=3, data_index=0, device="cpu"))


# -- the parquet reader --------------------------------------------------------

CLASS_NAMES = ["zeta", "alpha", "mid"]  # sorted: alpha(0), mid(1), zeta(2)
RAW_LABELS = {"zeta": 0, "alpha": 1, "mid": 2}  # raw ids disagree with sorted
SPLITS = {"train": 9, "val": 3}


@pytest.fixture(scope="module")
def parquet_root(tmp_path_factory):
    pa = pytest.importorskip("pyarrow")
    import pyarrow.parquet as pq
    from PIL import Image

    root = tmp_path_factory.mktemp("ufg_parquet_torch")
    rng = np.random.default_rng(7)
    rows = {"image": [], "label": [], "class_name": [], "split": []}
    for split, count in SPLITS.items():
        for i in range(count):
            cls = CLASS_NAMES[i % len(CLASS_NAMES)]
            arr = rng.integers(0, 256, (40, 40, 3), dtype=np.uint8)
            buf = io.BytesIO()
            Image.fromarray(arr).save(buf, format="JPEG")
            rows["image"].append(buf.getvalue())
            rows["label"].append(RAW_LABELS[cls])
            rows["class_name"].append(cls)
            rows["split"].append(split)
    table = pa.table({"image": pa.array(rows["image"], pa.binary()),
                      "label": pa.array(rows["label"], pa.int64()),
                      "class_name": pa.array(rows["class_name"]),
                      "split": pa.array(rows["split"])})
    pq.write_table(table, root / "cotton80_dataset.parquet")
    return root


@pytest.mark.parametrize("split,resize", [("train", 24), ("val", None)])
def test_parquet_reader_matches_jax(parquet_root, split, resize):
    kw = dict(dataset_name="cotton80", root=str(parquet_root), split=split, resize_size=resize,
              download=False)
    jds, tds = jdata.UFGVCDataset(**kw), tdata.UFGVCDataset(**kw)
    assert len(tds) == len(jds) == SPLITS[split]
    assert tds.classes == jds.classes == sorted(CLASS_NAMES)
    assert tds.get_dataset_info() == jds.get_dataset_info()
    for i in range(len(jds)):
        (ji, jl), (ti, tl) = jds[i], tds[i]
        np.testing.assert_array_equal(ti, ji)
        assert tl == jl == tds.class_to_idx[tds.get_class_name(i)]
        assert tds.get_sample_info(i) == jds.get_sample_info(i)
    assert (tdata.UFGVCDataset.get_dataset_splits("cotton80", str(parquet_root))
            == ["train", "val"])
    with pytest.raises(ValueError, match="split"):
        tdata.UFGVCDataset("cotton80", root=str(parquet_root), split="test", download=False)
    with pytest.raises(ValueError, match="not found"):
        tdata.UFGVCDataset("cotton81", root=str(parquet_root), download=False)
    assert tdata.UFGVCDataset.list_available_datasets() == (
        jdata.UFGVCDataset.list_available_datasets())
