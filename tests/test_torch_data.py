"""The port's data slice against dmel_tpu, on the CPU: ``BatchLoader``,
the seeded splits and ``get_dataset_by_config``, all bit-identical."""

import numpy as np
import pytest

from dmel_tpu.data import loader as jloader
from dmel_tpu.data import registry as jregistry
from dmel_tpu.data import splits as jsplits
from dmel_tpu_torch.data import BatchLoader, get_dataset_by_config, splits


class _Arrays:
    def __init__(self, n, seed=0):
        rng = np.random.default_rng(seed)
        self.xs = rng.standard_normal((n, 7)).astype(np.float32)
        self.ys = rng.integers(0, 10, n).astype(np.int32)

    def __len__(self):
        return len(self.xs)

    def __getitem__(self, i):
        return self.xs[i], self.ys[i]


@pytest.mark.parametrize("kwargs", [
    dict(shuffle=True, seed=3), dict(shuffle=False),
    dict(shuffle=True, seed=5, drop_last=True),
    dict(shuffle=True, seed=7, pad_last=False)],
    ids=["shuffle", "ordered", "drop_last", "ragged"])
def test_batch_loader_matches_jax_for_two_epochs(kwargs):
    data = _Arrays(23)
    got = BatchLoader(data, 5, **kwargs)
    want = jloader.BatchLoader(data, 5, **kwargs)
    assert len(got) == len(want)
    for _ in range(2):
        batches = list(got)
        ref = list(want)
        assert len(batches) == len(ref)
        for (xs, ys, mask), (wxs, wys, wmask) in zip(batches, ref):
            np.testing.assert_array_equal(xs, wxs)
            np.testing.assert_array_equal(ys, wys)
            np.testing.assert_array_equal(mask, wmask)
            assert xs.dtype == np.float32 and mask.dtype == bool


@pytest.mark.parametrize("n", [1, 7, 10, 23, 480, 2000])
def test_random_split_matches_jax(n):
    fractions = (0.7, 0.1, 0.2)
    assert (splits.random_split_lengths(n, fractions)
            == jsplits.random_split_lengths(n, fractions))
    np.testing.assert_array_equal(splits.torch_seeded_permutation(n, 4),
                                  jsplits.torch_seeded_permutation(n, 4))
    data = _Arrays(n)
    for got, want in zip(splits.random_split(data, fractions, seed=2),
                         jsplits.random_split(data, fractions, seed=2)):
        np.testing.assert_array_equal(got.indices, want.indices)
        np.testing.assert_array_equal(got.xs, want.xs)
        np.testing.assert_array_equal(got.ys, want.ys)
        assert len(got) == len(want)
        if len(got):
            np.testing.assert_array_equal(got[0][0], want[0][0])


def test_esc50_synth_splits_match_jax():
    config = dict(dataset_name="esc50_synth", n_points=4096, n_samples=30,
                  data_seed=2, sigma_ref=8000 * 0.035 / 6, noise_std=0.05)
    got = get_dataset_by_config(config, split_seed=1)
    want = jregistry.get_dataset_by_config(config, "unused", split_seed=1)
    assert [len(s) for s in got] == [21, 3, 6]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.xs, w.xs)
        np.testing.assert_array_equal(g.ys, w.ys)


@pytest.mark.parametrize("name,error", [
    ("fsd", FileNotFoundError), ("imagenet", ValueError)])
def test_other_datasets_are_refused(name, error):
    """An unknown dataset raises; fsd without its files on disk raises
    as dmel_tpu's loader does."""
    with pytest.raises(error):
        get_dataset_by_config(dict(dataset_name=name), "/nonexistent")
    if name == "fsd":
        with pytest.raises(error):
            jregistry.get_dataset_by_config(dict(dataset_name=name),
                                            "/nonexistent")
