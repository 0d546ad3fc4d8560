"""The port's on-disk and synthetic datasets against dmel_tpu's, on the
CPU: every array equal (``np.array_equal``), as both are numpy code.

The trees come from ``tests/fixtures.py``, which writes the real
datasets' on-disk layouts.  ``audio_mnist`` is read once from a full
60-speaker, 30000-wav tree (lengths 1500-7500, the tree the
``results/audio_mnist`` sweep was trained on), built once for the module.
Also here: ``translated_gaussian_window`` (1e-6), the background
``PrefetchIterator`` and the pinned, prefetched feed of ``fit``.
"""

import os
import sys
import threading
import wave

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmel_tpu.data import audio as jaudio
from dmel_tpu.data import loader as jloader
from dmel_tpu.data import registry as jregistry
from dmel_tpu.data import synthetic as jsynthetic
from dmel_tpu.ops import window as jwindow
from dmel_tpu_torch.data import (PrefetchIterator, audio, device_batches,
                                 get_dataset_by_config, splits, synthetic)
from dmel_tpu_torch.ops.window import translated_gaussian_window
from tests import fixtures

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _equal(got, want):
    assert len(got) == len(want)
    np.testing.assert_array_equal(got.xs, want.xs)
    np.testing.assert_array_equal(got.ys, want.ys)
    assert got.xs.dtype == want.xs.dtype and got.ys.dtype == want.ys.dtype


def _write(path, frames: bytes, width: int, channels: int, sr: int):
    with wave.open(str(path), "wb") as f:
        f.setnchannels(channels)
        f.setsampwidth(width)
        f.setframerate(sr)
        f.writeframes(frames)


# --- wav reading and resampling ------------------------------------------

@pytest.mark.parametrize("width,channels", [(1, 1), (2, 1), (4, 1),
                                            (2, 2)])
def test_load_wav_matches_jax(tmp_path, width, channels):
    """PCM8, PCM16, PCM32 and a stereo file mixed to mono: the same
    samples and rate."""
    rng = np.random.default_rng(width * 10 + channels)
    n = 1000 * channels
    kind = {1: np.uint8, 2: "<i2", 4: "<i4"}[width]
    info = np.iinfo(np.dtype(kind))
    raw = rng.integers(info.min, info.max, n, dtype=np.int64).astype(kind)
    path = tmp_path / "x.wav"
    _write(path, raw.tobytes(), width, channels, 22050)
    got, want = audio.load_wav(str(path)), jaudio.load_wav(str(path))
    np.testing.assert_array_equal(got[0], want[0])
    assert got[0].dtype == np.float32 and got[1] == want[1] == 22050
    assert len(got[0]) == n // channels


def test_load_wav_refuses_24_bit(tmp_path):
    path = tmp_path / "x.wav"
    _write(path, bytes(300), 3, 1, 8000)
    with pytest.raises(ValueError, match="sample width 3"):
        audio.load_wav(str(path))


@pytest.mark.parametrize("quality", ["kaiser_fast", "polyphase"])
@pytest.mark.parametrize("sr,target", [(44100, 8000), (22050, 8000),
                                       (8000, 16000), (8000, 8000)])
def test_resample_matches_jax(quality, sr, target):
    x = fixtures.speechish(np.random.default_rng(sr), sr // 4, sr, 330.0)
    got = audio.resample(x, sr, target, quality)
    want = jaudio.resample(x, sr, target, quality)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="unknown resample quality"):
        audio.resample(x, sr, target + 1, "sinc")


def test_resample_without_scipy_raises(monkeypatch):
    """Without scipy the resampler raises; there is no fallback."""
    monkeypatch.setitem(sys.modules, "scipy.signal", None)
    audio._kaiser_fast_fir.cache_clear()
    try:
        with pytest.raises(ImportError):
            audio.resample(np.zeros(441, np.float32), 44100, 8000)
    finally:
        audio._kaiser_fast_fir.cache_clear()


# --- AudioMNIST -----------------------------------------------------------

def test_audio_mnist_big_matches_jax(tmp_path):
    """One speaker's 50 clips per digit (lengths 1500-7500): padded to
    8000 samples, labelled by the file name's digit."""
    root = tmp_path / "am"
    rng = np.random.default_rng(0)
    for digit in range(10):
        for rep in range(3):
            n = int(rng.integers(1500, 7500))
            fixtures.write_wav(str(root / "data" / "07"
                                   / f"{digit}_07_{rep}.wav"),
                               fixtures.speechish(rng, n, 8000, 200.0),
                               8000)
    paths = sorted(str(p) for p in (root / "data" / "07").iterdir())
    got, want = audio.audio_mnist_big(paths), jaudio.audio_mnist_big(paths)
    _equal(got, want)
    assert got.xs.shape == (30, 8000) and got.sample_rate == 8000


def test_audio_mnist_legacy_matches_jax(tmp_path):
    """``recordings/``: clips of 1500-5500 samples kept and padded at the
    end to 5500, the rest dropped."""
    rng = np.random.default_rng(1)
    for digit in range(10):
        for rep, n in enumerate((1200, 1500, 3000, 5500, 6000)):
            fixtures.write_wav(str(tmp_path / "recordings"
                                   / f"{digit}_jackson_{rep}.wav"),
                               fixtures.speechish(rng, n, 8000, 150.0),
                               8000)
    got = audio.audio_mnist_legacy(str(tmp_path))
    want = jaudio.audio_mnist_legacy(str(tmp_path))
    _equal(got, want)
    assert got.xs.shape == (30, 5500)


def test_speaker_partition_matches_jax():
    from dmel_tpu.data import splits as jsplits
    for name in ("TRAIN", "VALID", "TEST"):
        key = f"AUDIO_MNIST_{name}_SPEAKERS"
        assert getattr(splits, key) == getattr(jsplits, key)
    splits.check_speaker_partition()


@pytest.fixture(scope="module")
def audio_mnist_tree(tmp_path_factory):
    """The full 30000-wav AudioMNIST fixture tree."""
    root = tmp_path_factory.mktemp("audio_mnist")
    return fixtures.make_audio_mnist_tree(str(root), min_len=1500,
                                          max_len=7500)


def test_audio_mnist_matches_jax(audio_mnist_tree, capsys):
    """The speaker split of the full tree: 18000/6000/6000 clips, every
    array equal to dmel_tpu's on the same tree.  Whether the test
    labels also equal the stored ``results/audio_mnist`` labels (the
    same tree, listed in this machine's file order) is printed."""
    config = {"dataset_name": "audio_mnist"}
    got = get_dataset_by_config(config, audio_mnist_tree)
    want = jregistry.get_dataset_by_config(config, audio_mnist_tree)
    assert [len(s) for s in got] == [18000, 6000, 6000]
    for g, w in zip(got, want):
        _equal(g, w)
    stored = np.load(os.path.join(ROOT, "results", "audio_mnist",
                                  "audio_mnist_labelss.npy"))
    with capsys.disabled():
        print(f"\naudio_mnist test labels equal the stored labels: "
              f"{bool(np.array_equal(got[2].ys, stored[0]))}")


# --- ESC-50 ---------------------------------------------------------------

@pytest.fixture(scope="module")
def esc50_tree(tmp_path_factory):
    """A 5-class ESC-50 tree: 8 clips of 0.5 s a class at 44.1 kHz."""
    root = tmp_path_factory.mktemp("esc50")
    return fixtures.make_esc50_tree(str(root), n_classes=5, per_class=8)


def test_parse_esc50_csv_matches_jax(esc50_tree):
    path = os.path.join(esc50_tree, "meta", "esc50.csv")
    assert audio.parse_esc50_csv(path) == jaudio.parse_esc50_csv(path)


def test_esc50_matches_jax_fresh_and_cached(esc50_tree, tmp_path):
    """Resampled fresh (the port writes the cache), then read back from
    the cache by both packages: the same arrays each time."""
    import shutil
    ours = tmp_path / "ours"
    shutil.copytree(esc50_tree, ours)
    got = audio.esc50(str(ours), resample_rate=8000)
    want = jaudio.esc50(esc50_tree, resample_rate=8000)
    _equal(got, want)
    assert got.xs.shape == (40, 4000)
    assert sorted(p for p in os.listdir(ours) if p.endswith(".npy")) == [
        "8000_xs.npy", "8000_ys.npy"]
    _equal(audio.esc50(str(ours), 8000), want)
    _equal(jaudio.esc50(str(ours), 8000), want)


def test_esc50_splits_match_jax(esc50_tree):
    config = {"dataset_name": "esc50", "resample_rate": 8000}
    got = get_dataset_by_config(config, esc50_tree)
    want = jregistry.get_dataset_by_config(config, esc50_tree)
    assert [len(s) for s in got] == [28, 4, 8]
    for g, w in zip(got, want):
        _equal(g, w)


def test_fsd_and_unknown_datasets_raise():
    """fsd without its files raises FileNotFoundError, as dmel_tpu's
    loader does; an unknown dataset raises ValueError."""
    with pytest.raises(FileNotFoundError):
        get_dataset_by_config({"dataset_name": "fsd"}, "/nonexistent")
    with pytest.raises(ValueError, match="dataset not defined"):
        get_dataset_by_config({"dataset_name": "imagenet"})


# --- the synthetic time_frequency task ------------------------------------

@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("offsets,demo", [((0.0, 0.0), False),
                                          ((0.1, 25.6), False),
                                          ((0.0, 0.0), True)])
def test_gauss_pulse_dataset_matches_jax(seed, offsets, demo):
    kw = dict(sigma=6.38, n_points=128, noise_std=0.5, n_samples=300,
              f_center_max_offset=offsets[0], t_center_max_offset=offsets[1],
              demo=demo, seed=seed)
    got = synthetic.make_gauss_pulse_dataset(**kw)
    want = jsynthetic.make_gauss_pulse_dataset(**kw)
    _equal(got, want)
    np.testing.assert_array_equal(got.locs, want.locs)
    assert got.xs.shape == (300, 128) and set(got.ys) == {0, 1, 2}


def test_gauss_pulse_dataset_unseeded_draws_fresh():
    a = synthetic.make_gauss_pulse_dataset(6.38, 128, 0.5, n_samples=20)
    b = synthetic.make_gauss_pulse_dataset(6.38, 128, 0.5, n_samples=20)
    assert not np.array_equal(a.xs, b.xs)


@pytest.mark.parametrize("center_offset", [False, True])
def test_time_frequency_splits_match_jax(center_offset):
    """The space's dataset (seeded) in its 0.7/0.1/0.2 split."""
    config = dict(dataset_name="time_frequency", sigma_ref=6.38,
                  n_points=128, noise_std=0.5, n_samples=500, data_seed=3,
                  center_offset=center_offset)
    got = get_dataset_by_config(config)
    want = jregistry.get_dataset_by_config(config, "unused")
    assert [len(s) for s in got] == [350, 50, 100]
    for g, w in zip(got, want):
        _equal(g, w)


@pytest.mark.parametrize("norm", ["amplitude", "energy"])
@pytest.mark.parametrize("sigma,tc", [(6.38, 64.0), (30.0, 10.5),
                                      (1.0, 127.0)])
def test_translated_gaussian_window_matches_jax(norm, sigma, tc):
    got = translated_gaussian_window(sigma, tc, 128, norm=norm).numpy()
    want = np.asarray(jwindow.translated_gaussian_window(
        sigma, tc, 128, norm=norm, dtype=jnp.float32))
    assert float(np.abs(got - want).max()) <= 1e-6 * float(np.abs(want).max())
    with pytest.raises(ValueError, match="unknown norm"):
        translated_gaussian_window(sigma, tc, 128, norm="peak")


# --- the prefetching feed ---------------------------------------------------

class _Boom(Exception):
    pass


def _source(n, fail_at=None):
    for i in range(n):
        if i == fail_at:
            raise _Boom(i)
        yield i


@pytest.mark.parametrize("depth", [1, 2, 5])
def test_prefetch_keeps_order_like_jax(depth):
    got = list(PrefetchIterator(_source(20), lambda i: i * i, depth=depth))
    want = list(jloader.PrefetchIterator(_source(20), lambda i: i * i,
                                         depth=depth))
    assert got == want == [i * i for i in range(20)]


@pytest.mark.parametrize("where", ["source", "transform"])
def test_prefetch_raises_at_the_failing_item(where):
    """An error of the source or of the transform reaches the consumer
    after the items before it, and the iterator then stays ended."""
    def transform(i):
        if where == "transform" and i == 3:
            raise _Boom(i)
        return i

    it = PrefetchIterator(_source(10, 3 if where == "source" else None),
                          transform, depth=2)
    assert [next(it) for _ in range(3)] == [0, 1, 2]
    with pytest.raises(_Boom):
        next(it)
    with pytest.raises(StopIteration):
        next(it)


def test_prefetch_close_mid_stream_releases_the_worker():
    """``close`` after two of 1000 items: the worker stops (blocked on
    the full queue before) and nothing stays queued."""
    made = []
    it = PrefetchIterator(_source(1000), lambda i: made.append(i) or i,
                          depth=2)
    assert [next(it), next(it)] == [0, 1]
    it.close()
    it._thread.join(timeout=5.0)
    assert not it._thread.is_alive()
    assert it._q.empty()
    assert len(made) <= 6
    it.close()                                  # a second close is fine


def test_prefetch_worker_runs_off_the_consumer_thread():
    threads = []
    it = PrefetchIterator(_source(3), lambda i: threads.append(
        threading.get_ident()) or i)
    assert list(it) == [0, 1, 2]
    assert set(threads) == {it._thread.ident} != {threading.get_ident()}


@pytest.mark.parametrize("prefetch", [0, 2])
def test_device_batches_on_the_cpu(prefetch):
    """Tensors on the device, equal to the numpy batches, in order."""
    from dmel_tpu_torch.data import BatchLoader
    data = synthetic.make_gauss_pulse_dataset(6.38, 128, 0.5, n_samples=50,
                                              seed=1)
    loader = BatchLoader(data, 16, shuffle=True, seed=2)
    want = list(BatchLoader(data, 16, shuffle=True, seed=2))
    got = list(device_batches(loader, torch.device("cpu"), prefetch))
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            assert a.device.type == "cpu"
            np.testing.assert_array_equal(a.numpy(), b)
