"""The port's data pipeline (``valle_tpu_torch/data``) against the JAX
package's modules on one synthetic corpus (``tests/torch_corpus.py``):
shards written by either package read back bit-equal by the other, the
manifest round-trips, the sampler's (bucket, indices) lists, every array
of every loader batch (accumulation 2, prefix-mode-4 prompts, SpecAugment
on log-mels), mid-epoch resume, the C++ loader against the numpy path, and
the prefetch thread.  Everything is host numpy: equality is exact."""

import numpy as np
import pytest

import valle_tpu.data as jd
import valle_tpu_torch.data as pd
from tests.torch_corpus import write_corpus
from valle_tpu.data import transforms as jax_transforms
from valle_tpu.data import vshard as jax_vshard
from valle_tpu_torch.data import native_loader
from valle_tpu_torch.data import vshard as port_vshard


def _corpus(root, pkg, **kw):
    return write_corpus(root, writer_cls=pkg.CodeShardWriter, manifest_cls=pkg.Manifest,
                        table_cls=pkg.SymbolTable, **kw)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """30 utterances of 0.6-4 s, 3 speakers, written by the port."""
    return _corpus(tmp_path_factory.mktemp("corpus"), pd, splits=(("train", 30),),
                   dur=(0.6, 4.0))


@pytest.fixture(scope="module")
def mel_corpus(tmp_path_factory):
    return _corpus(tmp_path_factory.mktemp("mels"), pd, splits=(("train", 12),), fmt="vsf",
                   frame_rate=93.75, dim=100, dur=(1.0, 3.0))


def _loaders(root, transforms=(None, None), **kw):
    """(JAX loader, port loader) on ``root``'s training manifest;
    ``transforms``: one feature transform for each, or None."""
    tokens = str(root / "unique_text_tokens.k2symbols")
    return [pkg.TtsDataLoader(pkg.Manifest.load(root / "manifest_train.jsonl.gz"),
                              pkg.get_text_token_collater(tokens),
                              feature_transforms=[tf] if tf else None, **kw)
            for pkg, tf in zip((jd, pd), transforms)]


def _assert_batches_equal(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            if k in ("utt_id", "text"):
                assert g[k] == w[k], k
            else:
                assert g[k].dtype == w[k].dtype and np.array_equal(g[k], w[k]), k


@pytest.mark.parametrize("fmt,dtype", [("vsh", np.int16), ("vsf", np.float16)])
def test_shards_read_back_bit_equal_across_packages(tmp_path, fmt, dtype):
    rng = np.random.RandomState(0)
    arrays = [(rng.randint(-300, 1024, (t, 8)) if fmt == "vsh" else rng.randn(t, 8)).astype(dtype)
              for t in (17, 1, 40)]
    for writer, reader in ((jax_vshard, port_vshard), (port_vshard, jax_vshard)):
        path = tmp_path / f"{writer.__name__.split('.')[0]}.{fmt}"
        writer.write_shard(path, arrays, 8, dtype=dtype)
        r = reader.VShardReader(path)
        assert len(r) == 3 and r.dtype == dtype
        for i, a in enumerate(arrays):
            assert np.array_equal(r[i], a.astype(r[i].dtype)), i
    names = sorted(p.name for p in tmp_path.iterdir())
    assert (tmp_path / names[0]).read_bytes() == (tmp_path / names[1]).read_bytes()


def test_manifest_round_trips_across_packages(corpus, tmp_path):
    port = pd.Manifest.load(corpus / "manifest_train.jsonl.gz")
    jax = jd.Manifest.load(corpus / "manifest_train.jsonl.gz")
    assert port.records == jax.records and port.describe() == jax.describe()
    assert port.uses_vshards() and not port.uses_float_features()
    assert port.shard_names() == jax.shard_names()
    for i in range(len(port)):
        assert np.array_equal(port.codes(i), jax.codes(i))
    pd.Manifest.save(iter(port.records), tmp_path / "m.jsonl.gz")
    assert jd.Manifest.load(tmp_path / "m.jsonl.gz").records == port.records
    assert np.array_equal(port.durations(), jax.durations())


def test_h5_shards_load_through_the_manifest(tmp_path):
    pytest.importorskip("h5py")
    root = _corpus(tmp_path, pd, splits=(("train", 4),), fmt="h5")
    m, j = (pkg.Manifest.load(root / "manifest_train.jsonl.gz") for pkg in (pd, jd))
    assert not m.uses_vshards()
    for i in range(4):
        assert np.array_equal(m.codes(i), j.codes(i))


@pytest.mark.parametrize("seed", [0, 5])
def test_sampler_lists_equal_jax(corpus, seed):
    recs = pd.Manifest.load(corpus / "manifest_train.jsonl.gz").records
    args = ([r["duration"] for r in recs], [len(r["tokens"]) + 2 for r in recs],
            [int(round(r["duration"] * 75)) for r in recs])
    for world, quant in ((1, 1), (2, 8)):
        kw = dict(max_duration=6.0, num_buckets=3, seed=seed, world_size=world,
                  batch_quant=quant)
        port, jax = pd.DynamicBucketingSampler(*args, **kw), jd.DynamicBucketingSampler(*args, **kw)
        assert port.bucket_specs == [pd.BucketSpec(s.max_text_len, s.max_audio_len)
                                     for s in jax.bucket_specs]
        for epoch in (0, 1):
            port.set_epoch(epoch)
            jax.set_epoch(epoch)
            for rank in range(world):
                assert port.batches_for_rank(rank) == jax.batches_for_rank(rank)
            got = [(s.max_audio_len, i) for s, i in port]
            assert got == [(s.max_audio_len, i) for s, i in jax] and len(port) == len(jax)


def test_single_cut_sampler_equals_jax():
    kw = dict(max_cuts=3, seed=2, rank=1, world_size=2)
    port = pd.SingleCutSampler(11, [5] * 11, [40] * 11, **kw)
    jax = jd.SingleCutSampler(11, [5] * 11, [40] * 11, **kw)
    port.set_epoch(3)
    jax.set_epoch(3)
    assert [i for _, i in port] == [i for _, i in jax]


@pytest.mark.parametrize("dataset", ["", "libritts"], ids=["plain", "mode4_prompts"])
def test_loader_batches_equal_jax(corpus, dataset):
    jax, port = _loaders(corpus, max_duration=5.0, num_buckets=2, accum_steps=2, seed=3,
                         dataset_name=dataset or None)
    for epoch in (1, 2):
        jax.set_epoch(epoch)
        port.set_epoch(epoch)
        got, want = list(port), list(jax)
        _assert_batches_equal(got, want)
        assert all(b["text_tokens"].shape[0] == 2 for b in got)
        assert ("prompt_codes" in got[0]) == bool(dataset)


def test_loader_batches_with_spec_augment_equal_jax(mel_corpus):
    jax, port = _loaders(mel_corpus, max_duration=6.0, num_buckets=1, seed=0,
                         transforms=(jax_transforms.SpecAugment(seed=4),
                                     pd.SpecAugment(seed=4)))
    assert port.frame_rate == jax.frame_rate == 93.75
    assert port.dataset.loader_path == "numpy"  # log-mels take the numpy path
    jax.set_epoch(0)
    port.set_epoch(0)
    got, want = list(port), list(jax)
    _assert_batches_equal(got, want)
    assert got[0]["audio_features"].dtype == np.float32
    plain = _loaders(mel_corpus, max_duration=6.0, num_buckets=1, seed=0)[1]
    plain.set_epoch(0)
    assert not np.array_equal(next(iter(plain))["audio_features"], got[0]["audio_features"])


def test_multihost_group_count_equals_jax(corpus):
    for rank in (0, 1):
        jax, port = _loaders(corpus, max_duration=4.0, num_buckets=3, accum_steps=2, seed=1,
                             rank=rank, world_size=2)
        jax.set_epoch(0)
        port.set_epoch(0)
        _assert_batches_equal(list(port), list(jax))


def test_state_dict_resumes_at_the_same_batch(corpus):
    _, port = _loaders(corpus, max_duration=4.0, num_buckets=2, accum_steps=2, seed=9)
    port.set_epoch(1)
    whole = list(port)
    assert len(whole) >= 3
    it = iter(port)
    next(it)
    next(it)
    state = port.state_dict()
    assert state == {"epoch": 1, "groups_consumed": 2}
    _, fresh = _loaders(corpus, max_duration=4.0, num_buckets=2, accum_steps=2, seed=9)
    fresh.load_state_dict(state)
    assert fresh.pending_skip() == 2
    _assert_batches_equal(list(fresh), whole[2:])
    assert fresh.pending_skip() == 0


def test_state_dict_resumes_spec_augment_draws(mel_corpus):
    """A loader restored from the state after 1 of 3+ groups, in a fresh
    process's place (a new SpecAugment from the seed), yields the
    uninterrupted loader's masked batches from group 1 on, in this epoch and
    the next; the state saved at the epoch's end carries the draws over."""
    def loader():
        return _loaders(mel_corpus, max_duration=2.5, num_buckets=1, seed=0, batch_quant=1,
                        transforms=(None, pd.SpecAugment(seed=4)))[1]

    whole = loader()
    whole.set_epoch(1)
    it = iter(pd.Prefetcher(iter(whole)))
    first = [next(it)]
    state = whole.state_dict(1)  # the prefetch thread has built ahead
    first += list(it)
    end_state = whole.state_dict(len(first))
    whole.set_epoch(2)
    second = list(whole)
    assert len(first) >= 3 and state["transforms"] != end_state["transforms"]

    mid = loader()
    mid.load_state_dict(state)
    mid.set_epoch(1)
    _assert_batches_equal(list(mid), first[1:])
    mid.set_epoch(2)
    _assert_batches_equal(list(mid), second)
    fresh = loader()
    fresh.load_state_dict(end_state)
    fresh.set_epoch(2)
    _assert_batches_equal(list(fresh), second)
    unrestored = loader()
    unrestored.set_epoch(2)
    assert not np.array_equal(next(iter(unrestored))["audio_features"],
                              second[0]["audio_features"])


def test_native_path_equals_numpy_path(corpus, monkeypatch):
    assert native_loader.available(), "g++ builds the loader here"
    lib = native_loader._LIB_PATH
    assert lib.parent.parts[-3:] == ("valle_tpu_torch", "data", "_native") and lib.exists()
    collater = pd.get_text_token_collater(str(corpus / "unique_text_tokens.k2symbols"))
    native = pd.SpeechSynthesisDataset(pd.Manifest.load(corpus / "manifest_train.jsonl.gz"),
                                       collater)
    assert native.loader_path == "native"
    monkeypatch.setattr(native_loader, "available", lambda: False)
    numpy_ds = pd.SpeechSynthesisDataset(pd.Manifest.load(corpus / "manifest_train.jsonl.gz"),
                                         collater)
    assert numpy_ds.loader_path == "numpy"
    spec = pd.BucketSpec(max_text_len=32, max_audio_len=160)
    idx = [0, 3, -1, 7, 11, 29]
    _assert_batches_equal([native.batch(spec, idx)], [numpy_ds.batch(spec, idx)])
    jid = native._native.submit([0, 0], [3, 7], 160, 8)  # the loader's worker pool
    codes, lens = native._native.wait(jid)
    want = numpy_ds.batch(spec, [3, 7])
    assert np.array_equal(lens, want["audio_features_lens"])
    assert np.array_equal(codes, want["audio_features"])


def test_prefetcher_yields_in_order_and_reraises(corpus):
    assert list(pd.Prefetcher(iter(range(7)), depth=2)) == list(range(7))

    def broken():
        yield 1
        raise ValueError("producer failed")

    it = iter(pd.Prefetcher(broken()))
    assert next(it) == 1
    with pytest.raises(ValueError, match="producer failed"):
        next(it)
