"""Inference and test-set prediction over a finished sweep (counterpart
of ``dmel_tpu/eval/predict.py``).

:func:`predict` runs a model over arrays of clips.  :func:`predict_test`
does, for every trial row of a sweep, what the JAX package's does:
rebuild the model from the row's config, restore its ``best_model``
checkpoint at the geometry of its sidecar, predict the test split, and
write ``{dataset}.csv`` with a ``test_accuracy`` column (and
``test_mAP`` for multi-label datasets) beside
``{dataset}_predictionss.npy`` and ``{dataset}_labelss.npy``.  Every
model of the registry is served: MelPANNsNet, the mel probes and the
DSPEC probes.  Batches are placed on the device ahead of the model on a
background thread, ``prefetch`` deep (the row config's ``prefetch``
key, default 2, as in ``fit``).
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from dmel_tpu_torch.data.loader import BatchLoader, device_batches
from dmel_tpu_torch.data.registry import get_dataset_by_config
from dmel_tpu_torch.device import resolve_device
from dmel_tpu_torch.eval.metrics import mean_average_precision, top1_precision
from dmel_tpu_torch.experiments.runner import (_write_csv, get_config_by_row,
                                               load_results)
from dmel_tpu_torch.models.registry import (dispatch_hint_for,
                                            get_model_by_config)
from dmel_tpu_torch.ops.spectrogram import bucketed_window_length
from dmel_tpu_torch.precision import precision_scope
from dmel_tpu_torch.training.checkpoint import load_checkpoint


@precision_scope()
def predict(model: torch.nn.Module, xs: np.ndarray, batch_size: int = 32,
            device=None, prefetch: int = 2) -> tuple[np.ndarray, np.ndarray]:
    """Eval-mode forward passes of ``model`` over ``xs`` (n, T) in
    batches; returns ``(argmax, scores)``, scores ``(n, n_classes)``.

    Runs on ``device`` (default ``cuda``), where the model must lie,
    inside :func:`~dmel_tpu_torch.precision.precision_scope`; the
    batches are placed ``prefetch`` ahead on a background thread
    (:func:`~dmel_tpu_torch.data.loader.device_batches`).
    """
    dev = resolve_device(device)
    for p in model.parameters():
        if p.device != dev:
            raise ValueError(f"model lies on {p.device}, not on {dev}")
    model.eval()
    batches = device_batches(
        ((np.asarray(xs[i:i + batch_size], dtype=np.float32),)
         for i in range(0, len(xs), batch_size)), dev, prefetch)
    scores = []
    try:
        with torch.no_grad():
            for (xb,) in batches:
                scores.append(model(xb)[0])
    finally:
        batches.close()
    scores = torch.cat(scores).cpu().numpy()
    return np.argmax(scores, axis=-1), scores


def _coerce(config: dict) -> dict:
    """A config read back from ``results.csv``, its values given the
    types ``fit`` expects (strings of booleans to bools, counts to int,
    rates and lengths to float)."""
    out = dict(config)
    for k in ("trainable", "optimized", "normalize_window",
              "energy_normalize", "augment", "pretrained",
              "center_offset"):
        if k in out and isinstance(out[k], str):
            out[k] = out[k] == "True"
    for k in ("n_points", "hop_length", "batch_size", "max_epochs",
              "patience", "n_mels", "resample_rate", "n_samples",
              "prefetch"):
        if k in out and out[k] is not None and not isinstance(out[k], bool):
            try:
                out[k] = int(float(out[k]))
            except (TypeError, ValueError):
                pass
    for k in ("init_lambd", "lr_model", "lr_tf", "noise_std", "sigma_ref"):
        if k in out and out[k] is not None:
            try:
                out[k] = float(out[k])
            except (TypeError, ValueError):
                pass
    return out


def _best_model_path(row: dict) -> str:
    return os.path.join(str(row["logdir"]), "checkpoint_000000",
                        "best_model")


def predictions_by_row(row: dict, testloader, device=None) -> tuple:
    """Rebuild the model of one results row, restore its best
    checkpoint and predict the clips of ``testloader`` (a
    :class:`~dmel_tpu_torch.data.BatchLoader`, in its batch size) on
    ``device`` (default ``cuda``).

    The model is built at the geometry of the checkpoint's sidecar (the
    window length and hint it validated at); a checkpoint without one
    takes both from its lambda.  Single-label datasets return
    ``(labels, argmax_preds)``, multi-label ones (2-D ``ys``)
    ``(multi_hot_labels, scores)``."""
    config = _coerce(get_config_by_row(row))
    path = _best_model_path(row)
    weights = load_checkpoint(path)["model"]
    meta_path = path + ".meta.json"
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
        wl, hint = meta.get("window_length"), meta.get("lambd_hint")
    else:
        lam = float(weights["spectrogram_layer.lambd"].mean())
        wl = (bucketed_window_length(lam, int(config["n_points"]))
              if config.get("optimized", False) else None)
        hint = dispatch_hint_for(config, wl, lam)
    model = get_model_by_config(config, window_length=wl, lambd_hint=hint,
                                device=device)
    model.load_state_dict(weights)
    preds, scores = predict(model, testloader.xs, testloader.batch_size,
                            device=device,
                            prefetch=int(config.get("prefetch", 2)))
    labels = testloader.ys
    if labels.ndim == 2:
        return labels, scores
    return labels, preds


def predict_test(sweep_dir: str, data_dir: str, batch_size: int = 32,
                 verbose: int = 1, device=None) -> list[dict]:
    """Test predictions of every trial of ``sweep_dir`` on ``device``
    (default ``cuda``); writes ``{dataset}.csv`` and the prediction and
    label stacks, and returns the rows with their test metrics.  A trial
    without a checkpoint (one that diverged before its first improvement)
    gets NaN metrics and an empty prediction."""
    rows = load_results(sweep_dir)
    if not rows:
        raise ValueError(f"no finished trials in {sweep_dir}")
    dataset_name = str(rows[0]["config/dataset_name"])
    _, _, testset = get_dataset_by_config(
        _coerce(get_config_by_row(rows[0])), data_dir)
    testloader = BatchLoader(testset, batch_size, shuffle=False)

    out, predss, labelss = [], [], []
    multilabel = False
    for row in rows:
        row = dict(row)
        name = os.path.basename(str(row["logdir"]))
        if not os.path.exists(_best_model_path(row)):
            row.update(test_accuracy=float("nan"), test_mAP=float("nan"))
            predss.append(np.array([]))
            labelss.append(np.array([]))
            out.append(row)
            if verbose:
                print(f"{name}: no checkpoint (diverged trial) - skipped")
            continue
        labels, preds = predictions_by_row(row, testloader, device)
        if labels.ndim == 2:
            multilabel = True
            row["test_accuracy"] = top1_precision(labels, preds)
            row["test_mAP"] = mean_average_precision(labels, preds)
        else:
            row["test_accuracy"] = float(np.mean(labels == preds))
            row["test_mAP"] = float("nan")
        predss.append(preds)
        labelss.append(labels)
        out.append(row)
        if verbose:
            extra = (f" test_mAP={row['test_mAP']:.4f}" if multilabel
                     else "")
            print(f"{name}: test_accuracy={row['test_accuracy']:.4f}{extra}")

    if not multilabel:
        for row in out:
            del row["test_mAP"]
    _write_csv(os.path.join(sweep_dir, f"{dataset_name}.csv"), out)
    _save_stack(os.path.join(sweep_dir, f"{dataset_name}_predictionss.npy"),
                predss)
    _save_stack(os.path.join(sweep_dir, f"{dataset_name}_labelss.npy"),
                labelss)
    return out


def _save_stack(path: str, arrs: list):
    """Save per-trial arrays: a dense array where they stack, else (a
    diverged trial's empty array makes the list ragged) an object array
    to read with ``np.load(..., allow_pickle=True)``."""
    try:
        np.save(path, np.asarray(arrs))
    except ValueError:
        obj = np.empty(len(arrs), dtype=object)
        for i, a in enumerate(arrs):
            obj[i] = a
        np.save(path, obj, allow_pickle=True)


def main(argv=None):
    import argparse
    parser = argparse.ArgumentParser(description="Test predictions.")
    parser.add_argument("--sweep_dir", required=True, type=str)
    parser.add_argument("--data_dir", required=True, type=str)
    parser.add_argument("--batch_size", type=int, default=32)
    parser.add_argument("--device", type=str, default=None,
                        help="Device of the predictions (default cuda).")
    args = parser.parse_args(argv)
    predict_test(args.sweep_dir, args.data_dir, args.batch_size,
                 device=args.device)


if __name__ == "__main__":
    main()
