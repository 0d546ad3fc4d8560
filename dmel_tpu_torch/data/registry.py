"""Config dict to ``(trainset, validset, testset)`` (counterpart of
``dmel_tpu/data/registry.py``).  Only the ``esc50_synth`` dataset is
ported; it needs no files on disk.
"""

from __future__ import annotations

from dmel_tpu_torch.data import splits, synthetic

_NOT_PORTED = ("audio_mnist", "fsd", "esc50", "time_frequency")


def get_dataset_by_config(config: dict, data_dir: str | None = None,
                          split_seed: int = 0):
    """The seeded 0.7 / 0.1 / 0.2 split of the dataset ``config``
    names.  ``data_dir`` is where the JAX package reads datasets from
    disk; no ported dataset reads one."""
    name = config["dataset_name"]
    if name in _NOT_PORTED:
        raise NotImplementedError(f"dataset {name!r} is not ported yet")
    if name != "esc50_synth":
        raise ValueError(f"dataset not defined: {name}")
    dataset = synthetic.make_esc50_synth_dataset(
        sigma=float(config.get("sigma_ref", 8000 * 0.035 / 6)),
        n_points=config.get("n_points", 40000),
        noise_std=float(config.get("noise_std", 0.05)),
        n_samples=config.get("n_samples", 2000),
        seed=config.get("data_seed", 0),
        hard=bool(config.get("synth_hard", False)))
    return splits.random_split(dataset, (0.7, 0.1, 0.2), seed=split_seed)
