"""Experiment runner: resumable trial sweeps with a CSV round trip
(counterpart of ``dmel_tpu/experiments/runner.py``).  A sweep is a
directory of the same layout as the JAX package's:

    <output_dir>/<name>/
        manifest.json              trial -> status (resumable)
        trial_00000/
            config.json            flat config (round-trippable)
            progress.csv           per-epoch metric records
            result.json            history summary + the last record
            checkpoint_000000/
                best_model         best-on-valid-loss checkpoint
                best_model.meta.json   its geometry sidecar
                live_state         only while a trial is unfinished
        results.csv                one row per finished trial with
                                   config/* columns + final metrics

The ``config/*`` column convention is Ray's dataframe export, so the
eval layer can rebuild any trial's model from a results row.
``resume=True`` skips the trials the manifest marks done, and a trial
killed mid-run resumes from its live state.

The one difference: the JAX package reads and writes ``results.csv``
with pandas and returns data frames; the port uses the ``csv`` module,
and :func:`collect_results` and :func:`load_results` return a list of
row dicts.  :func:`load_results` gives each cell back as a bool, int,
float or string (an empty cell as None), as pandas infers its columns.
"""

from __future__ import annotations

import csv
import json
import os
from typing import Optional

import torch

from dmel_tpu_torch.data.registry import get_dataset_by_config
from dmel_tpu_torch.experiments.configs import expand_grid, get_search_space
from dmel_tpu_torch.training.train import fit


def trial_dirname(i: int) -> str:
    return f"trial_{i:05d}"


def _write_csv(path: str, rows: list[dict]) -> None:
    """``rows`` as CSV, the columns in order of first appearance; None
    and a missing key are written as an empty cell."""
    columns = list(dict.fromkeys(k for row in rows for k in row))
    with open(path, "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=columns, restval="")
        writer.writeheader()
        for row in rows:
            writer.writerow({k: "" if v is None else v
                             for k, v in row.items()})


def _write_progress_csv(path: str, records, config: dict) -> None:
    if not records:
        return
    cfg_cols = {f"config/{k}": v for k, v in config.items()}
    _write_csv(path, [{**r, **cfg_cols} for r in records])


def run_trial(config: dict, data_dir: str, trial_dir: str,
              seed: int = 0, verbose: int = 0, fresh: bool = False,
              device=None):
    """Train one trial on ``device`` (default ``cuda``) and write its
    ``config.json``, ``progress.csv``, ``result.json`` and checkpoints.

    A trial killed mid-run leaves a live state under its checkpoint
    directory; running the trial again resumes at its next epoch.
    ``fresh=True`` discards that state first (``--no_resume``)."""
    os.makedirs(trial_dir, exist_ok=True)
    ckpt_dir = os.path.join(trial_dir, "checkpoint_000000")
    if fresh:
        live = os.path.join(ckpt_dir, "live_state")
        if os.path.exists(live):
            os.remove(live)
    with open(os.path.join(trial_dir, "config.json"), "w") as f:
        json.dump(config, f, indent=2, default=str)

    trainset, validset, _ = get_dataset_by_config(config, data_dir)

    pretrained_sd = None
    if config.get("pretrained") and config.get("checkpoint_path"):
        path = config["checkpoint_path"]
        if os.path.exists(path):
            pretrained_sd = torch.load(path, map_location="cpu",
                                       weights_only=True)["model"]
        elif verbose:
            print(f"pretrained checkpoint not found: {path} "
                  "(training from a random init)")

    state, history = fit(config, trainset, validset,
                         checkpoint_dir=ckpt_dir, seed=seed,
                         verbose=verbose, device=device,
                         pretrained_state_dict=pretrained_sd)

    _write_progress_csv(os.path.join(trial_dir, "progress.csv"),
                        history["records"], config)
    summary = {k: v for k, v in history.items() if k != "records"}
    if history["records"]:
        summary.update(history["records"][-1])
    with open(os.path.join(trial_dir, "result.json"), "w") as f:
        json.dump(summary, f, indent=2, default=float)
    return state, history


def run_sweep_packed(name: str, num_samples: int, max_epochs: int,
                     output_dir: str, data_dir: str, **kwargs):
    """The JAX package's packed sweep (every trial in one vmapped
    program, ``dmel_tpu/parallel/trials.py:fit_trials``) is not ported
    yet; raises ``NotImplementedError``."""
    raise NotImplementedError(
        "packed sweeps (fit_trials of the JAX package's parallel/trials.py)"
        " are not ported yet; run the trials one after another with "
        "run_sweep")


def run_sweep(name: str, num_samples: int, max_epochs: int,
              output_dir: str, data_dir: str, *,
              resume: bool = True, verbose: int = 0,
              space: Optional[dict] = None, device=None):
    """Expand the search space and run every trial, one after another,
    on ``device`` (default ``cuda``).  Trial ``i`` is seeded with ``i``.

    Returns the sweep directory.  Safe to re-invoke after an
    interruption: finished trials are skipped via ``manifest.json``.
    """
    space = space if space is not None else get_search_space(name,
                                                            max_epochs)
    grid = expand_grid(space)
    trials = [dict(cfg, trial_repeat=rep)
              for rep in range(num_samples) for cfg in grid]

    sweep_dir = os.path.join(output_dir, name)
    os.makedirs(sweep_dir, exist_ok=True)
    manifest_path = os.path.join(sweep_dir, "manifest.json")
    manifest = {}
    if resume and os.path.exists(manifest_path):
        with open(manifest_path) as f:
            manifest = json.load(f)

    for i, config in enumerate(trials):
        tname = trial_dirname(i)
        if manifest.get(tname) == "done":
            if verbose:
                print(f"skip finished {tname}")
            continue
        if verbose:
            print(f"=== {tname}: init_lambd={config.get('init_lambd')}, "
                  f"trainable={config.get('trainable')} ===")
        manifest[tname] = "running"
        with open(manifest_path, "w") as f:
            json.dump(manifest, f, indent=2)
        run_trial(config, data_dir, os.path.join(sweep_dir, tname),
                  seed=i, verbose=verbose, fresh=not resume, device=device)
        manifest[tname] = "done"
        with open(manifest_path, "w") as f:
            json.dump(manifest, f, indent=2)

    collect_results(sweep_dir)
    return sweep_dir


def collect_results(sweep_dir: str) -> list[dict]:
    """One row per finished trial (its ``result.json``, its config as
    ``config/*`` columns and its ``logdir``), written to
    ``results.csv`` and returned as a list of dicts."""
    rows = []
    for entry in sorted(os.listdir(sweep_dir)):
        tdir = os.path.join(sweep_dir, entry)
        result_path = os.path.join(tdir, "result.json")
        config_path = os.path.join(tdir, "config.json")
        if not (os.path.isfile(result_path) and os.path.isfile(config_path)):
            continue
        with open(result_path) as f:
            row = json.load(f)
        with open(config_path) as f:
            config = json.load(f)
        row.update({f"config/{k}": v for k, v in config.items()})
        row["logdir"] = tdir
        rows.append(row)
    if rows:
        _write_csv(os.path.join(sweep_dir, "results.csv"), rows)
    return rows


def _cell(text: str):
    """A CSV cell as the value pandas would infer for it."""
    if text == "":
        return None
    if text in ("True", "False"):
        return text == "True"
    for kind in (int, float):
        try:
            return kind(text)
        except ValueError:
            pass
    return text


def read_rows(path: str) -> list[dict]:
    """The rows of the CSV file ``path``, each cell parsed by
    :func:`_cell`."""
    with open(path, newline="") as f:
        return [{k: _cell(v) for k, v in row.items()}
                for row in csv.DictReader(f)]


def load_results(sweep_dir: str) -> list[dict]:
    """The sweep's rows from ``results.csv`` (rebuilt from the trials
    when it is missing), each cell parsed by :func:`_cell`."""
    path = os.path.join(sweep_dir, "results.csv")
    if not os.path.exists(path):
        return collect_results(sweep_dir)
    return read_rows(path)


def get_config_by_row(row: dict) -> dict:
    """The flat config of a results row (its ``config/*`` cells)."""
    config = {}
    for k, v in row.items():
        if isinstance(k, str) and k.startswith("config/"):
            config[k.split("/", 1)[1]] = v
    return config
