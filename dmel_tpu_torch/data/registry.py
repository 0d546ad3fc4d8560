"""Config dict to ``(trainset, validset, testset)`` (counterpart of
``dmel_tpu/data/registry.py``).

- ``audio_mnist``: the wavs of ``<data_dir>/data/<speaker>/`` in the
  fixed speaker partition (30000 clips in all);
- ``esc50``: ``<data_dir>/meta/esc50.csv`` and ``audio/``, resampled to
  ``resample_rate`` and cached, in the seeded 0.7 / 0.1 / 0.2 split;
- ``fsd``: FSD50K's official layout under ``data_dir``, in its own
  train / val / eval split, resampled, cut to ``n_points`` and cached
  (:mod:`dmel_tpu_torch.data.fsd`);
- ``time_frequency`` and ``esc50_synth``: synthetic, in the seeded split.
"""

from __future__ import annotations

import glob
import os

from dmel_tpu_torch.data import audio, fsd, splits, synthetic


def _audio_mnist_splits(data_dir: str):
    splits.check_speaker_partition()

    def paths(speaker_ids):
        # the unsorted glob of the JAX package: the same file order on
        # one machine
        out = []
        for sid in speaker_ids:
            out += glob.glob(os.path.join(data_dir, "data",
                                          f"{sid:02d}", "*.wav"))
        return out

    trainset = audio.audio_mnist_big(paths(splits.AUDIO_MNIST_TRAIN_SPEAKERS))
    validset = audio.audio_mnist_big(paths(splits.AUDIO_MNIST_VALID_SPEAKERS))
    testset = audio.audio_mnist_big(paths(splits.AUDIO_MNIST_TEST_SPEAKERS))
    assert len(trainset) + len(validset) + len(testset) == 30000
    return trainset, validset, testset


def get_dataset_by_config(config: dict, data_dir: str | None = None,
                          split_seed: int = 0):
    """``(trainset, validset, testset)`` of the dataset ``config`` names;
    ``data_dir`` is the root of an on-disk dataset (unused by the
    synthetic ones)."""
    name = config["dataset_name"]
    if name == "audio_mnist":
        return _audio_mnist_splits(data_dir)
    if name == "fsd":
        return fsd.fsd50k(data_dir,
                          resample_rate=config.get("resample_rate", 8000),
                          n_points=config.get("n_points", 40000))

    if name == "esc50":
        dataset = audio.esc50(data_dir, resample_rate=config["resample_rate"])
    elif name == "esc50_synth":
        dataset = synthetic.make_esc50_synth_dataset(
            sigma=float(config.get("sigma_ref", 8000 * 0.035 / 6)),
            n_points=config.get("n_points", 40000),
            noise_std=float(config.get("noise_std", 0.05)),
            n_samples=config.get("n_samples", 2000),
            seed=config.get("data_seed", 0),
            hard=bool(config.get("synth_hard", False)))
    elif name == "time_frequency":
        if config.get("center_offset"):
            f_off, t_off = 0.1, config["n_points"] / 5
        else:
            f_off, t_off = 0.0, 0.0
        dataset = synthetic.make_gauss_pulse_dataset(
            sigma=float(config["sigma_ref"]),
            n_points=config["n_points"],
            noise_std=float(config["noise_std"]),
            n_samples=config["n_samples"],
            f_center_max_offset=f_off,
            t_center_max_offset=t_off,
            seed=config.get("data_seed"))
    else:
        raise ValueError(f"dataset not defined: {name}")
    return splits.random_split(dataset, (0.7, 0.1, 0.2), seed=split_seed)
